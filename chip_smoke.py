"""Smoke run of every device path of compu_tpu on an NVIDIA GPU.

    python chip_smoke.py                 # phases 1-7 on one card
    python chip_smoke.py --multichip     # only the sharded mesh path, on
                                         # every visible card (4 expected)
    python chip_smoke.py --trace DIR     # also trace one steady-state
                                         # phase-1 call into DIR

Each phase drives the public entry points at a real data size and checks
every output byte against an oracle that is independent of the code under
test: stdlib ``zlib`` for gzip/zlib, the in-repo native decoders for zstd
and brotli, the CPU backend for byte identity, and the GPU test leg.

The timings printed are smoke timings of one run, not benchmark numbers.
The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU the script exits non-zero before any phase. No phase's
exception is caught: any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time
import zlib

REPO = pathlib.Path(__file__).resolve().parent
BLOCK = 1 << 18          # 256 KiB device blocks
PER_CALL = 16            # blocks per device encode call
PHASE1_BYTES = 200 << 20  # Silesia-sized (~212 MB)


def _keep_cpu_backend() -> None:
    """Phase 6 compares against the CPU backend in this process: keep it
    available behind the GPU (which stays the default device)."""
    plat = os.environ.get("JAX_PLATFORMS")
    if plat and "cpu" not in plat.split(","):
        os.environ["JAX_PLATFORMS"] = plat + ",cpu"


class _Timer:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        if exc[0] is None:
            print(f"smoke timing [{self.name}]: {self.seconds:.3f} s", flush=True)


def phase_block_encode(data: bytes):
    """1. Block-parallel gzip encode, level 6, 16 blocks per device call."""
    from compu_tpu.formats.deflate.options import ZlibMode
    from compu_tpu.kernels.block_codec import make_block_encode_fn
    from compu_tpu.parallel.scheduler import BlockParallelEncoder, BlockState

    nblocks = len(data) // BLOCK
    assert nblocks % PER_CALL == 0 and len(data) == nblocks * BLOCK

    def encoder(groups):
        fn = make_block_encode_fn(ZlibMode.Gzip, level=6, segment_index=True,
                                  pipeline_groups=groups)
        return BlockParallelEncoder(fn, block_size=BLOCK, mode=ZlibMode.Gzip,
                                    host_fallback=False)

    one_call = encoder(1)
    with _Timer(f"1 encode: compile + first {PER_CALL}-block call"):
        one_call.encode(data[: PER_CALL * BLOCK])
    enc = encoder(nblocks // PER_CALL)
    with _Timer(f"1 encode: {len(data)} B, {nblocks} blocks") as t:
        stream, index = enc.encode(data)
    bad = [s for s in enc.block_statuses if s.state != BlockState.Ok]
    assert not bad, f"block statuses not Ok: {bad[:3]}"
    assert zlib.decompress(stream, wbits=31) == data, "gzip stream mismatch"
    print(f"phase 1: {nblocks} blocks Ok, ratio {len(data) / len(stream):.4f}, "
          f"smoke rate {len(data) / t.seconds / 1e6:.1f} MB/s", flush=True)
    print(f"phase 1 host stages (ms): {enc.metrics.summary()['stages_ms']}; "
          f"device step (ms): {enc.block_fn.last_timings}", flush=True)
    return stream, index, one_call


def phase_block_decode(data: bytes, stream: bytes, index) -> None:
    """2. Device decode of phase 1's stream through the scheduler."""
    from compu_tpu.parallel.scheduler import (BlockIndex, BlockParallelDecoder,
                                              BlockState)

    dec = BlockParallelDecoder(device=True, block_size=BLOCK,
                               host_fallback=False)
    head = BlockIndex(index.raw_lengths[:PER_CALL],
                      index.compressed_offsets[:PER_CALL],
                      index.compressed_lengths[:PER_CALL],
                      index.segment_bits[:PER_CALL])
    with _Timer(f"2 decode: compile + first {PER_CALL}-block call"):
        assert dec.decode(stream, head) == data[: PER_CALL * BLOCK]
    with _Timer(f"2 decode: {len(data)} B") as t:
        out = dec.decode(stream, index)
    assert out == data, "device decode mismatch"
    bad = [s for s in dec.block_statuses if s.state != BlockState.Ok]
    assert not bad, f"block statuses not Ok: {bad[:3]}"
    n = len(index.raw_lengths)
    print(f"phase 2: {dec.device_blocks} of {n} blocks decoded on the device "
          f"(the rest are stored blocks, copied on the host), smoke rate "
          f"{len(data) / t.seconds / 1e6:.1f} MB/s", flush=True)
    assert dec.device_blocks > 0, "no block took the device path"


def phase_stream_encode(data: bytes) -> None:
    """3. encoder.Interface.zlib_device() through the streaming state
    machine, output drained in Buffer chunks."""
    from compu_tpu import Buffer, EncodeOp, EncodeStatus, encoder

    enc = encoder.Interface.zlib_device()
    buf = Buffer(1 << 16)
    out = bytearray()
    remaining = memoryview(data)
    with _Timer(f"3 zlib_device stream encode: {len(data)} B"):
        while True:
            consumed, res = buf.encode(enc, remaining, EncodeOp.Finish)
            remaining = remaining[consumed:]
            out.extend(buf.data())
            buf.consume()
            assert res.status is not EncodeStatus.Error, res
            if res.status is EncodeStatus.Finished:
                break
    assert zlib.decompress(bytes(out)) == data, "zlib_device stream mismatch"
    print(f"phase 3: {len(data)} B -> {len(out)} B, stdlib zlib agrees",
          flush=True)


def phase_foreign_decode(data: bytes) -> None:
    """4. decoder.Interface.zlib_device() on foreign streams."""
    from compu_tpu import ByteVec, decoder

    alice = (REPO / "tests" / "data" / "alice29.txt").read_bytes()
    cases = [
        ("alice29.txt.gz", (REPO / "tests" / "data" / "alice29.txt.gz").read_bytes(), alice),
        ("alice29.txt.zz", (REPO / "tests" / "data" / "alice29.txt.zz").read_bytes(), alice),
        (f"zlib level 6, {len(data)} B", zlib.compress(data, 6), data),
    ]
    for name, blob, want in cases:
        dec = decoder.Interface.zlib_device()
        vec = ByteVec()
        vec.reserve_exact(len(want) + 4096)
        with _Timer(f"4 zlib_device decode: {name}"):
            res = dec.decode_vec_full(blob, vec)
        assert not res.is_error, (name, res)
        assert vec.data() == want, f"zlib_device decode mismatch: {name}"
    print("phase 4: foreign gzip/zlib streams decoded on the device",
          flush=True)


def phase_zstd_brotli(data: bytes) -> None:
    """5. zstd and brotli with their device options, decoded by the
    in-repo native decoders."""
    from compu_tpu import ByteVec, EncodeOp, EncodeStatus, decoder, encoder
    from compu_tpu.formats.brotli.options import BrotliOptions
    from compu_tpu.formats.zstd.options import ZstdDecodeOptions, ZstdOptions

    cases = [
        ("zstd level 3, device lz/literals/sequences",
         encoder.Interface.zstd(ZstdOptions(
             level=3, device_lz=True, device_literals=True,
             device_sequences=True)),
         decoder.Interface.zstd_native),
        ("brotli quality 5, device lz",
         encoder.Interface.brotli(BrotliOptions(quality=5, device_lz=True)),
         decoder.Interface.brotli_native),
    ]
    for name, enc, make_dec in cases:
        vec = ByteVec()
        with _Timer(f"5 encode {name}: {len(data)} B"):
            res = enc.encode_vec_full(data, vec, EncodeOp.Finish)
        assert res.status is EncodeStatus.Finished, (name, res)
        out = ByteVec()
        out.reserve_exact(len(data) + 4096)
        res = make_dec().decode_vec_full(vec.data(), out)
        assert not res.is_error and out.data() == data, f"{name} mismatch"
        print(f"phase 5: {name}: {len(data)} B -> {len(vec.data())} B, "
              f"native decoder agrees", flush=True)

    alice = (REPO / "tests" / "data" / "alice29.txt").read_bytes()
    dec = decoder.Interface.zstd(ZstdDecodeOptions(device_literals=True))
    out = ByteVec()
    out.reserve_exact(len(alice) + 4096)
    with _Timer("5 zstd decode alice29.txt.zst, device literals"):
        res = dec.decode_vec_full(
            (REPO / "tests" / "data" / "alice29.txt.zst").read_bytes(), out)
    assert not res.is_error and out.data() == alice, "zstd device decode"
    sections = dec._backend._frame.device_literal_sections
    assert sections > 0, "no literal section decoded on the device"
    print(f"phase 5: alice29.txt.zst decoded, {sections} literal sections "
          f"on the device", flush=True)


def phase_cpu_identity(data: bytes, gpu, cpu) -> None:
    """6. The encode and the LUT decode give identical bytes on the card
    and on the CPU backend (integer arithmetic and one-hot matmuls with
    exact integer sums: tolerance 0)."""
    import jax
    import numpy as np

    from compu_tpu.kernels.deflate_jax_v3 import encode_blocks_dyn
    from compu_tpu.kernels.inflate_jax_dyn import parse_block_tables
    from compu_tpu.kernels.inflate_jax_lut import decode_blocks_indexed_lut

    B = 2
    blocks = np.frombuffer(data[: B * BLOCK], np.uint8).reshape(B, BLOCK)
    lens = np.full(B, BLOCK, np.int32)
    cap = BLOCK + BLOCK // 4 + 64
    # the level-6 settings make_block_encode_fn uses
    kw = dict(depth=16, cap=cap, with_index=True, check="crc", wcap=16,
              lex_keys=2, stride=1)

    def run(dev, fn, *args, **kwargs):
        put = [jax.device_put(a, dev) for a in args]
        return [np.asarray(x) for x in fn(*put, **kwargs)]

    with _Timer("6 encode 2 blocks on gpu and cpu"):
        g = run(gpu, encode_blocks_dyn, blocks, lens, **kw)
        c = run(cpu, encode_blocks_dyn, blocks, lens, **kw)
    for name, a, b in zip(("outs", "metas", "segment index"), g, c):
        assert np.array_equal(a, b), f"encode {name} differ between gpu and cpu"

    outs, metas, segs = g
    dcap = BLOCK + BLOCK // 4 + 64 + 16
    comps = np.zeros((B, dcap), np.uint8)
    lit_lens = np.zeros((B, 288), np.int32)
    dist_lens = np.zeros((B, 30), np.int32)
    for j in range(B):
        clen = int(metas[j, 0])
        comps[j, :clen] = outs[j, :clen]
        kind, lit, dist, _ = parse_block_tables(outs[j, :4096].tobytes())
        assert kind != 0 and segs[j, 0] >= 0, "expected entropy-coded blocks"
        lit_lens[j] = lit
        dist_lens[j] = dist
    args = (comps, segs.astype(np.int32), lens, lit_lens, dist_lens)
    with _Timer("6 LUT decode 2 blocks on gpu and cpu"):
        g = run(gpu, decode_blocks_indexed_lut, *args, n_out=BLOCK)
        c = run(cpu, decode_blocks_indexed_lut, *args, n_out=BLOCK)
    assert all(np.array_equal(a, b) for a, b in zip(g, c)), \
        "LUT decode differs between gpu and cpu"
    assert int(g[1][0]) == 1 and g[0].reshape(B, BLOCK).tobytes() == \
        data[: B * BLOCK], "LUT decode mismatch"
    print("phase 6: encode outputs, metas, segment index and LUT decode are "
          "byte-identical on gpu and cpu", flush=True)


def phase_gpu_leg() -> None:
    """7. The GPU test leg, in this process (one JAX process per card)."""
    import pytest

    class Tally:
        passed = failed = skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.failed:
                self.failed += 1
            elif report.skipped:
                self.skipped += 1
            elif report.when == "call":
                self.passed += 1

    tally = Tally()
    os.environ["COMPU_GPU_TESTS"] = "1"
    with _Timer("7 gpu test leg"):
        rc = pytest.main([str(REPO / "tests" / "test_gpu_leg.py"), "-m", "gpu",
                          "-q", "-p", "no:cacheprovider"], plugins=[tally])
    print(f"phase 7: gpu leg passed {tally.passed}, failed {tally.failed}, "
          f"skipped {tally.skipped}", flush=True)
    assert rc == 0 and tally.failed == 0 and tally.skipped == 0 \
        and tally.passed > 0, "gpu test leg failed"


def trace_phase1(one_call, data: bytes, out_dir: str) -> None:
    """Profiler trace of steady-state 16-block encode calls (already
    compiled), plus the compiled HLO so kernels map to stages."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from compu_tpu.kernels.block_codec import _encode_blocks_batched
    from compu_tpu.utils.trace_stages import stage_times

    calls = 4
    with jax.profiler.trace(out_dir):
        for k in range(calls):
            one_call.encode(data[k * PER_CALL * BLOCK:(k + 1) * PER_CALL * BLOCK])
    blocks = np.frombuffer(data[: PER_CALL * BLOCK], np.uint8).reshape(
        PER_CALL, BLOCK)
    hlo = _encode_blocks_batched.lower(
        jnp.asarray(blocks), jnp.full(PER_CALL, BLOCK, jnp.int32), depth=16,
        cap=BLOCK + BLOCK // 4 + 64, with_index=True, check="crc",
        kernel="v3", wcap=16, lex_keys=2, stride=1).compile().as_text()
    pathlib.Path(out_dir, "encode_blocks_batched.hlo.txt").write_text(hlo)
    table = stage_times(out_dir, hlo)
    print(f"trace: {calls} steady-state calls of {PER_CALL} blocks, device "
          f"time per stage (ms, all calls):", flush=True)
    for stage, ms in table.items():
        print(f"  {stage:<20} {ms:10.3f}", flush=True)


def run_multichip(devices, blocks_per_device: int = 4) -> None:
    """The sharded mesh path across ``devices``: dp-sharded block encode,
    stream-sharded zstd literals and the lane-sharded crc, each checked
    against its one-card reference or the stdlib."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from compu_tpu.formats.zstd.huff import HufEncoder
    from compu_tpu.kernels.deflate_jax_v3 import encode_block_dyn
    from compu_tpu.ops import checksum
    from compu_tpu.parallel.mesh import (make_lane_sharded_crc,
                                         make_sharded_encode_step,
                                         make_stream_sharded_literal_step)
    from compu_tpu.utils.corpus import build_corpus

    n = len(devices)
    B = n * blocks_per_device
    data = build_corpus(B * BLOCK, seed=7)
    blocks = np.frombuffer(data, np.uint8).reshape(B, BLOCK)
    lens = np.full(B, BLOCK, np.int32)
    mesh = Mesh(np.asarray(devices), ("dp",))
    blocks_d = jax.device_put(blocks, NamedSharding(mesh, P("dp", None)))
    lens_d = jax.device_put(lens, NamedSharding(mesh, P("dp")))
    held = {s.device: s.data.shape[0] for s in blocks_d.addressable_shards}
    assert set(held) == set(devices) and set(held.values()) == \
        {blocks_per_device}, f"blocks not spread over the mesh: {held}"

    step = make_sharded_encode_step(mesh, depth=8)
    with _Timer(f"multichip encode: {B} blocks on {n} devices"):
        out, out_lens, adlers, total = step(blocks_d, lens_d)
        out.block_until_ready()
    on = {s.device for s in out.addressable_shards}
    assert on == set(devices), f"outputs not spread over the mesh: {on}"
    out, out_lens, adlers = (np.asarray(x) for x in (out, out_lens, adlers))
    assert int(total) == int(out_lens.sum())
    with _Timer(f"multichip reference: {B} blocks on one device"):
        for i in range(B):
            ref, meta = encode_block_dyn(jax.device_put(blocks[i], devices[0]),
                                         jnp.int32(BLOCK), depth=8)
            ref, meta = np.asarray(ref), np.asarray(meta)
            assert int(meta[0]) == int(out_lens[i]), f"block {i} length"
            assert np.array_equal(ref[: meta[0]], out[i, : out_lens[i]]), \
                f"block {i} bytes differ from the one-card encode"
            assert int(meta[1]) == int(adlers[i]), f"block {i} adler"
    stream = bytearray(b"\x78\x9c")
    combined = 1
    for i in range(B):
        stream.extend(out[i, : out_lens[i]].tobytes())
        combined = checksum.adler32_combine(combined,
                                            int(adlers[i]) & 0xFFFFFFFF, BLOCK)
    stream.extend(b"\x01\x00\x00\xff\xff")
    stream.extend(combined.to_bytes(4, "big"))
    assert zlib.decompress(bytes(stream)) == data, "sharded stream mismatch"
    print(f"multichip: {B} blocks ({blocks_per_device} per device) identical "
          f"to the one-card encode; assembled zlib stream decoded by stdlib",
          flush=True)

    # stream-sharded zstd literals: 4 streams per block, L = 4 * n lanes
    lit = data[: 4 * (1 << 16) * n]
    L = 4 * n
    per = len(lit) // L
    freqs = np.bincount(np.frombuffer(lit, np.uint8), minlength=256)
    huf = HufEncoder(freqs + 1)
    code = np.zeros(256, np.uint32)
    nbits = np.zeros(256, np.int32)
    code[: huf.max_symbol + 1] = huf.code
    nbits[: huf.max_symbol + 1] = huf.nbits
    mat = np.frombuffer(lit, np.uint8).reshape(L, per)
    lit_step = make_stream_sharded_literal_step(mesh, cap=per + per // 2 + 64)
    with _Timer(f"multichip literal streams: {L} lanes"):
        streams, nb = lit_step(
            jax.device_put(mat, NamedSharding(mesh, P("dp", None))),
            jnp.full(L, per, jnp.int32), jnp.asarray(code), jnp.asarray(nbits))
        streams, nb = np.asarray(streams), np.asarray(nb)
    for i in range(L):
        want = huf.encode_stream(mat[i].tobytes())
        assert streams[i, : nb[i]].tobytes() == want, f"literal stream {i}"
    print(f"multichip: {L} literal streams identical to the host writer",
          flush=True)

    # lane-sharded crc on a (dp, lane) mesh
    mesh2 = Mesh(np.asarray(devices).reshape(n // 2, 2), ("dp", "lane"))
    lanes_per_dev = 256
    crc_step = make_lane_sharded_crc(mesh2, lanes_per_device=lanes_per_dev)
    regs = np.asarray(crc_step(jnp.asarray(blocks[:1])))[0]
    # raw (init 0) lane registers fold into the stream register
    reg = checksum.fold_lane_registers(regs, BLOCK // (lanes_per_dev * 2))
    assert reg ^ 0xFFFFFFFF == zlib.crc32(data[:BLOCK]), \
        "lane-sharded crc mismatch"
    print("multichip: lane-sharded crc equals zlib.crc32", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the sharded mesh path on every card")
    ap.add_argument("--trace", metavar="DIR",
                    help="trace steady-state phase-1 calls into DIR")
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args()

    _keep_cpu_backend()
    import jax

    from compu_tpu.runtime import native
    from compu_tpu.utils.compile_cache import setup_compile_cache

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU found (JAX platform "
                 f"{devices[0].platform!r}); nothing was run")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print("nvidia-smi name, power.limit:")
    for line in smi.strip().splitlines():
        print(line)
    gpu = devices[0]
    print(f"device_kind: {gpu.device_kind}; devices: {len(devices)}")
    print(f"compile cache: {setup_compile_cache()}")
    print(f"native host runtime: {native.load_status()}", flush=True)

    if args.multichip:
        assert len(devices) >= 2 and len(devices) % 2 == 0, \
            "--multichip needs an even number of cards"
        run_multichip(devices)
    else:
        from compu_tpu.utils.corpus import build_corpus

        with _Timer(f"corpus: {PHASE1_BYTES} B from seed {args.seed}"):
            data = build_corpus(PHASE1_BYTES, seed=args.seed)
        stream, index, one_call = phase_block_encode(data)
        phase_block_decode(data, stream, index)
        phase_stream_encode(data[: 8 << 20])
        phase_foreign_decode(data[: 16 << 20])
        phase_zstd_brotli(data[: 4 << 20])
        phase_cpu_identity(data, gpu, jax.devices("cpu")[0])
        phase_gpu_leg()
        if args.trace:
            trace_phase1(one_call, data, args.trace)
    peak = gpu.memory_stats().get("peak_bytes_in_use")
    print(f"peak_bytes_in_use (device 0): {peak}")
    print(json.dumps({"ok": True, "device": {
        "platform": gpu.platform, "kind": gpu.device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
