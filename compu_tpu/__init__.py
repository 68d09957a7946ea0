"""compu_tpu — an accelerator-native lossless compression codec suite.

A brand-new implementation of the capabilities of the reference library
"compu" (a streaming facade over DEFLATE/zlib, zstd, and brotli), designed
device-first: the codec internals (LZ match finding, Huffman / FSE entropy
coding, bit-exact bitstream packing) run as JAX device pipelines over
fixed-shape blocks, while compu's Encoder/Decoder streaming state machine
(NeedInput/NeedOutput/Finished, Process/Flush/Finish, reset) survives as the
host-side driver contract.

Flat re-exports mirror the reference crate facade (src/lib.rs:107-112).
"""

from . import decoder, encoder
from .buffer import Buffer
from .detection import Detection
from .decoder import Decoder
from .encoder import Encoder
from .status import (
    Decode,
    DecodeError,
    DecodeStatus,
    Encode,
    EncodeOp,
    EncodeStatus,
)
from .vec import ByteVec, ChunkedSink

__version__ = "0.1.0"

__all__ = [
    "Buffer",
    "ByteVec",
    "ChunkedSink",
    "Decode",
    "DecodeError",
    "DecodeStatus",
    "Decoder",
    "Detection",
    "Encode",
    "EncodeOp",
    "EncodeStatus",
    "Encoder",
    "decoder",
    "encoder",
]
