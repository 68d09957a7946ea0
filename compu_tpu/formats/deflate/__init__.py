"""DEFLATE (RFC1951) with zlib (RFC1950) / gzip (RFC1952) / raw framings.

The reference reaches this format through three interchangeable backends
(libz / zlib-ng / zlib-rs — src/encoder/zlib*.rs, src/decoder/zlib*.rs);
here there is one device-first implementation: data-parallel LZ77 match
finding, package-merge Huffman construction, prefix-sum bit packing, and a
table-driven decoder, orchestrated by the streaming block pipeline."""
