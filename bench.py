"""Benchmark: block-parallel gzip encode on the device compute path.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "extra": {...}}

The reference publishes no performance numbers (BASELINE.md);
``vs_baseline`` is the ratio against a fixed 1.0 GB/s reference rate.
Runs only on a GPU: any other platform is an error, and every device
phase fails loudly (host-only extras report their errors).

Measured paths:
* end-to-end (primary): BlockParallelEncoder -> batched v3 DEFLATE kernel
  (dynamic Huffman / stored blocks) with pipelined group H2D, host framing,
  output validated by stock zlib.
* kernel_only: chained-dependency timing — K batched dispatches where
  batch k+1's input depends on batch k's metadata, so device work cannot
  overlap; fixed per-call costs cancel in the (K-1) delta.
* decode_device: segment-parallel indexed inflate (dynamic tables);
  decode_native: the C++ host inflate on the same stream.
"""

from __future__ import annotations

import json
import sys
import time
import zlib

import numpy as np

from compu_tpu.utils.corpus import build_corpus

BLOCK = 1 << 18  # 256 KiB device blocks
TARGET_GBPS = 1.0
LEVEL = 6


def kernel_only_gbps(corpus: bytes, batch: int = 16, chain: int = 6) -> float:
    """On-chip sustained rate via chained dispatches: batch k+1 xors in a
    bit of batch k's metadata, forcing serial execution on device; ONE tiny
    value fetch at the end. Rate = (K-1) batches / (t_K - t_1)."""
    import jax
    import jax.numpy as jnp

    from compu_tpu.kernels.block_codec import _encode_blocks_batched

    cap = BLOCK + BLOCK // 4 + 64
    blocks = np.frombuffer(corpus[: batch * BLOCK], dtype=np.uint8).reshape(
        batch, BLOCK
    )
    lens = jnp.full(batch, BLOCK, jnp.int32)
    dev = jax.device_put(blocks)

    def run(k):
        b = dev
        metas = None
        for i in range(k):
            if metas is not None:
                # serialize: next batch depends on previous metadata
                b = dev ^ (metas[0, 1] & 1).astype(jnp.uint8)
            _, metas, _ = _encode_blocks_batched(
                b, lens, depth=16, cap=cap, with_index=True, check="crc",
                kernel="v3", wcap=16, lex_keys=2, stride=1,
            )
        return np.asarray(metas)  # one value fetch

    run(1)  # compile both variants
    run(2)
    t0 = time.perf_counter(); run(1); t1 = time.perf_counter()
    run(chain)
    t2 = time.perf_counter(); run(chain); t3 = time.perf_counter()
    per_batch = ((t3 - t2) - (t1 - t0)) / (chain - 1)
    return batch * BLOCK / per_batch / 1e9


def decode_kernel_mbps(stream: bytes, index, batch: int = 16,
                       chain: int = 5) -> float:
    """On-chip indexed-inflate rate via chained dispatches: batch k+1's
    comps xor one PAD byte (beyond the compressed length — decode-inert)
    with batch k's first output byte, forcing serial device execution."""
    import jax
    import jax.numpy as jnp

    from compu_tpu.kernels.inflate_jax_dyn import parse_block_tables
    from compu_tpu.kernels.inflate_jax_lut import decode_blocks_indexed_lut

    bs = BLOCK
    cap = bs + bs // 4 + 64 + 16
    comps = np.zeros((batch, cap), dtype=np.uint8)
    segs = np.zeros((batch, bs // 128), dtype=np.int32)
    ns = np.zeros(batch, dtype=np.int32)
    lit_lens = np.zeros((batch, 288), dtype=np.int32)
    dist_lens = np.zeros((batch, 30), dtype=np.int32)
    j = 0
    for b in range(len(index.raw_lengths)):
        if j == batch:
            break
        off = index.compressed_offsets[b]
        clen = index.compressed_lengths[b]
        blob = stream[off : off + clen]
        kind, lit, dist, _ = parse_block_tables(blob[:4096])
        if kind == 0 or int(np.asarray(index.segment_bits[b])[0]) < 0:
            continue  # stored block: no entropy decode to measure
        comps[j, :clen] = np.frombuffer(blob, dtype=np.uint8)
        segs[j] = np.asarray(index.segment_bits[b], dtype=np.int32)
        ns[j] = index.raw_lengths[b]
        lit_lens[j] = lit
        dist_lens[j] = dist
        j += 1
    if j < batch:
        return 0.0
    dev = jax.device_put(comps)
    segs_d = jnp.asarray(segs)
    ns_d = jnp.asarray(ns)
    ll_d = jnp.asarray(lit_lens)
    dl_d = jnp.asarray(dist_lens)

    def run(k):
        c = dev
        out = None
        for _ in range(k):
            if out is not None:
                c = dev.at[0, cap - 1].set(out[0] & 1)
            out, ok = decode_blocks_indexed_lut(
                c, segs_d, ns_d, ll_d, dl_d, n_out=bs)
        return np.asarray(out[:1]), np.asarray(ok)

    run(1); run(2)
    t0 = time.perf_counter(); run(1); t1 = time.perf_counter()
    t2 = time.perf_counter(); run(chain); t3 = time.perf_counter()
    per = ((t3 - t2) - (t1 - t0)) / (chain - 1)
    return batch * bs / per / 1e6


def zstd_device_stage_mbps(corpus: bytes, chain: int = 4) -> float:
    """On-chip chained rate of the composed zstd device stages: device LZ
    tokenization -> 4-stream Huffman literal pack -> FSE sequence
    bitstream, dispatched back-to-back per 1 MiB span with a data
    dependency between chain steps (VERDICT r4 item 2's on-chip number).
    Tables are built once host-side and reused (the per-block table build
    is host work in the hybrid architecture; this measures the device
    stages themselves)."""
    import jax
    import jax.numpy as jnp

    from compu_tpu.formats.zstd.huff import HufEncoder
    from compu_tpu.kernels.deflate_jax_v2 import device_tokens
    from compu_tpu.kernels.zstd_literals_jax import _encode_streams

    n = 1 << 20
    data = np.frombuffer(corpus[:n], dtype=np.uint8)
    freqs = np.bincount(data, minlength=256)
    enc = HufEncoder(freqs + 1)
    code = np.zeros(256, np.uint32)
    nbits = np.zeros(256, np.int32)
    code[: enc.max_symbol + 1] = enc.code
    nbits[: enc.max_symbol + 1] = enc.nbits
    code_d = jnp.asarray(code)
    nbits_d = jnp.asarray(nbits)
    dev = jax.device_put(jnp.asarray(data))
    per = n // 4
    scap = per + per // 2 + 64

    @jax.jit
    def step(d):
        toks = device_tokens(d, jnp.int32(n), depth=8)
        # literal matrix: the 4 stream quarters of the raw bytes (the
        # hybrid's literal payload upper bound)
        mat = d.reshape(4, per)
        out, nb = _encode_streams(mat, jnp.full(4, per, jnp.int32),
                                  code_d, nbits_d, cap=scap)
        return toks, out, nb

    def run(k):
        d = dev
        toks = out = nb = None
        for _ in range(k):
            if nb is not None:
                d = dev ^ (nb[0] & 1).astype(jnp.uint8)
            toks, out, nb = step(d)
        return np.asarray(nb)

    run(1); run(2)
    t0 = time.perf_counter(); run(1); t1 = time.perf_counter()
    t2 = time.perf_counter(); run(chain); t3 = time.perf_counter()
    perb = ((t3 - t2) - (t1 - t0)) / (chain - 1)
    return n / perb / 1e6


def _native_decode(make_dec, blob: bytes, size: int) -> bytes:
    """Decode with an in-repo native decoder (the zstd/brotli oracle)."""
    from compu_tpu import ByteVec

    vec = ByteVec()
    vec.reserve_exact(size + 4096)
    res = make_dec().decode_vec_full(blob, vec)
    assert not res.is_error, res
    return vec.data()


def native_encode_numbers(corpus: bytes, smoke: bool) -> dict:
    """Standalone C++ encoder throughput (the second implementations:
    Interface.zstd_native / Interface.brotli_native), validated by the
    native decoders. Host-only: errors are reported, not raised."""
    from compu_tpu import ByteVec, decoder, encoder
    from compu_tpu.formats.brotli.options import BrotliOptions
    from compu_tpu.formats.zstd.options import ZstdOptions
    from compu_tpu.status import EncodeOp

    sl = corpus[: (1 << 20) if smoke else (8 << 20)]
    out = {}
    for name, iface, dec in (
        ("zstd_native_enc",
         encoder.Interface.zstd_native(ZstdOptions(level=3, window_log=23)),
         lambda b: _native_decode(decoder.Interface.zstd_native, b, len(sl))),
        ("brotli_native_enc",
         encoder.Interface.brotli_native(BrotliOptions(quality=5)),
         lambda b: _native_decode(decoder.Interface.brotli_native, b,
                                  len(sl))),
    ):
        try:
            vec = ByteVec()
            t0 = time.time()
            iface.encode_vec_full(sl, vec, EncodeOp.Finish)
            dt = time.time() - t0
            blob = vec.data()
            assert dec(blob) == sl, f"{name} roundtrip"
            out[f"{name}_MBps"] = round(len(sl) / dt / 1e6, 1)
            out[f"{name}_ratio"] = round(len(sl) / len(blob), 2)
        except Exception as exc:  # pragma: no cover
            out[f"{name}_error"] = type(exc).__name__
    return out


def format_decode_numbers(corpus: bytes, smoke: bool) -> dict:
    """Native host decode throughput for zstd / brotli (VERDICT r3 item 5:
    unmeasured = unmanaged). Streams come from the foreign reference
    encoders (zstandard / libbrotli) where installed, so the numbers are
    comparable to the reference adapters decoding foreign streams.
    Host-only: errors are reported, not raised."""
    from compu_tpu import decoder

    sl = corpus[: (1 << 20) if smoke else (8 << 20)]
    out = {}
    jobs = []
    try:
        import zstandard as zstd_mod

        jobs.append(("zstd", zstd_mod.ZstdCompressor(level=3).compress(sl),
                     decoder.Interface.zstd_native()))
    except Exception as exc:
        out["zstd_decode_error"] = type(exc).__name__
    try:
        sys.path.insert(0, "tests")
        import brotli_oracle

        jobs.append(("brotli", brotli_oracle.compress(sl, quality=5),
                     decoder.Interface.brotli_native()))
    except Exception as exc:
        out["brotli_decode_error"] = type(exc).__name__
    for name, blob, dec in jobs:
        try:
            buf = bytearray(len(sl) + 4096)
            dec.decode(blob, memoryview(buf))  # warm
            dec.reset()
            t0 = time.time()
            res = dec.decode(blob, memoryview(buf))
            dt = time.time() - t0
            produced = len(buf) - res.output_remain
            assert bytes(buf[:produced]) == sl, f"{name} decode mismatch"
            out[f"{name}_decode_native_MBps"] = round(len(sl) / dt / 1e6, 1)
        except Exception as exc:  # pragma: no cover - report, don't fail
            out[f"{name}_decode_error"] = type(exc).__name__
    return out


def hybrid_format_numbers(corpus: bytes, smoke: bool) -> dict:
    """zstd / brotli device-LZ hybrid encode rates + ratios on a corpus
    slice (their entropy stages are host-side; the slice keeps the bench
    bounded). Decode-back validates via the native decoders. A device
    phase: failures raise."""
    from compu_tpu import decoder, encoder
    from compu_tpu.formats.zstd.options import ZstdOptions
    from compu_tpu.formats.brotli.options import BrotliOptions
    from compu_tpu.status import EncodeOp

    sl = corpus[: (1 << 20) if smoke else (4 << 20)]
    out = {}
    for name, iface, make_dec in (
        ("zstd", encoder.Interface.zstd(ZstdOptions(level=3, device_lz=True)),
         decoder.Interface.zstd_native),
        ("brotli", encoder.Interface.brotli(
            BrotliOptions(quality=5, device_lz=True)),
         decoder.Interface.brotli_native),
    ):
        buf = bytearray(len(sl) + (len(sl) >> 1) + 4096)
        # Warm pass: compiles the device-LZ graphs (first-call compile
        # otherwise dominates and reports ~0 MB/s), then reset + time.
        iface.encode(sl, memoryview(buf), EncodeOp.Finish)
        iface.reset()
        t0 = time.time()
        res = iface.encode(sl, memoryview(buf), EncodeOp.Finish)
        dt = time.time() - t0
        produced = len(buf) - res.output_remain
        blob = bytes(buf[:produced])
        assert _native_decode(make_dec, blob, len(sl)) == sl, \
            f"{name} hybrid roundtrip"
        out[f"{name}_hybrid_MBps"] = round(len(sl) / dt / 1e6, 1)
        out[f"{name}_ratio"] = round(len(sl) / len(blob), 2)
    return out


def main() -> None:
    import jax

    from compu_tpu.utils.compile_cache import setup_compile_cache

    platform = jax.devices()[0].platform
    if platform != "gpu":
        sys.exit(f"bench.py: needs a GPU, JAX platform is {platform!r}")
    setup_compile_cache()

    from compu_tpu.formats.deflate.options import ZlibMode
    from compu_tpu.kernels.block_codec import make_block_encode_fn
    from compu_tpu.parallel.scheduler import (
        BlockParallelDecoder,
        BlockParallelEncoder,
    )

    # --smoke: tiny corpus, one pass, no chained kernel timing —
    # validates the full pipeline end-to-end and FAILS on any crash or
    # roundtrip mismatch.
    smoke = "--smoke" in sys.argv
    corpus = build_corpus(4 << 20 if smoke else 16 << 20)
    n = len(corpus)

    fn = make_block_encode_fn(
        ZlibMode.Gzip, level=LEVEL, segment_index=True, pipeline_groups=4
    )
    enc = BlockParallelEncoder(fn, block_size=BLOCK, mode=ZlibMode.Gzip,
                               host_fallback=False)

    # Warm: compile every graph at the exact benchmark shapes, plus first
    # transfers.
    enc.encode(bytes(n))

    best = float("inf")
    stream = index = None
    breakdown = {}
    for _ in range(1 if smoke else 3):
        t0 = time.time()
        stream, index = enc.encode(corpus)
        took = time.time() - t0
        if took < best:
            best = took
            # per-stage budget of the best run (VERDICT r4 item 4: a
            # committed e2e number needs its transfer breakdown)
            breakdown = dict(getattr(fn, "last_timings", {}))
    dt = best

    # Validate: the emitted stream is a standard gzip member.
    decoded = zlib.decompress(stream, wbits=31)
    assert decoded == corpus, "roundtrip mismatch"

    # Secondary: segment-parallel device inflate of our own stream.
    dec = BlockParallelDecoder(device=True, block_size=BLOCK,
                               host_fallback=False)
    got = dec.decode(stream, index)  # compile + warm
    assert got == corpus, "device decode mismatch"
    t1 = time.time()
    got = dec.decode(stream, index)
    dt_dec = time.time() - t1
    assert got == corpus

    # Host native (C++) decode of the same standard gzip stream.
    from compu_tpu import ByteVec, decoder

    try:
        dnat = decoder.Interface.zlib_native(ZlibMode.Gzip)
        vec = ByteVec()
        vec.reserve_exact(n + 1024)
        t2 = time.time()
        dnat.decode_vec_full(stream, vec)
        dt_nat = time.time() - t2
        assert vec.data() == corpus
    except Exception:
        dt_nat = float("inf")

    # Threaded HOST encode through the scheduler (one GIL-releasing C++
    # deflate call per block, pooled).
    try:
        from compu_tpu.parallel.scheduler import make_host_block_encode_fn

        hfn = make_host_block_encode_fn(ZlibMode.Gzip, level=LEVEL)
        henc = BlockParallelEncoder(hfn, block_size=BLOCK, mode=ZlibMode.Gzip)
        hs, _ = henc.encode(corpus)  # warm
        t5 = time.time()
        hs, _ = henc.encode(corpus)
        dt_henc = time.time() - t5
        assert zlib.decompress(hs, wbits=31) == corpus
    except Exception:
        dt_henc = float("inf")

    # Threaded host decode of the same standard stream through the
    # scheduler (independent blocks across a pool; GIL released in the
    # C++ decoder).
    try:
        dpar = BlockParallelDecoder(device=False, block_size=BLOCK)
        dpar.decode(stream, index)  # warm
        t4 = time.time()
        got = dpar.decode(stream, index)
        dt_par = time.time() - t4
        assert got == corpus
    except Exception:
        dt_par = float("inf")

    kern = 0.0 if smoke else kernel_only_gbps(corpus)
    dec_kern = 0.0 if smoke else decode_kernel_mbps(stream, index)
    fmt = hybrid_format_numbers(corpus, smoke)
    fmt.update(format_decode_numbers(corpus, smoke))
    fmt.update(native_encode_numbers(corpus, smoke))
    if not smoke:
        fmt["zstd_device_stage_MBps"] = round(zstd_device_stage_mbps(corpus), 1)

    gbps = n / dt / 1e9
    ratio = n / len(stream)
    result = {
        "metric": "silesia_like_gzip_encode_throughput",
        "value": round(gbps, 3),
        "unit": "GB/s/chip",
        "vs_baseline": round(gbps / TARGET_GBPS, 3),
        "extra": {
            "kernel_only_GBps": round(kern, 3),
            "ratio": round(ratio, 2),
            "decode_device_MBps": round(n / dt_dec / 1e6, 1),
            "decode_kernel_MBps": round(dec_kern, 1),
            "decode_native_host_MBps": round(n / dt_nat / 1e6, 1),
            "decode_host_parallel_MBps": round(n / dt_par / 1e6, 1),
            "encode_host_parallel_MBps": round(n / dt_henc / 1e6, 1),
            "level": LEVEL,
            "e2e_breakdown_ms": breakdown,
            **fmt,
        },
    }
    print(json.dumps(result))
    print(
        f"# {n/1e6:.0f} MB corpus, encode {dt*1000:.0f} ms ({gbps*1000:.1f} MB/s e2e, "
        f"{kern:.2f} GB/s kernel-only), device decode {dt_dec*1000:.0f} ms "
        f"({n/dt_dec/1e6:.1f} MB/s), native host decode {n/dt_nat/1e6:.1f} MB/s, "
        f"ratio {ratio:.2f}x at level {LEVEL}, {len(index.raw_lengths)} blocks, "
        f"device={jax.devices()[0].platform}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
