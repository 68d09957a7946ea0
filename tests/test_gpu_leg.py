"""Hardware test leg: kernel roundtrips + a scheduler e2e executed on a
real GPU, so device numerics and layouts are validated by tests rather
than only by benchmark side-effects.

Run on a machine with an NVIDIA GPU:

    COMPU_GPU_TESTS=1 python -m pytest tests/test_gpu_leg.py -m gpu -q

``chip_smoke.py`` runs this leg in its own process (one JAX process per
card). Every test here is marked ``gpu`` and skips without a GPU. Oracles
are stdlib ``zlib`` and the in-repo native decoders, so the leg needs no
foreign codec packages. The corpus is kept small (one 256 KiB block
batch) so the leg completes in a few minutes including compiles.
"""

import pathlib
import sys
import zlib

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

pytestmark = pytest.mark.gpu

BLOCK = 1 << 18
DATA = pathlib.Path(__file__).parent / "data"


def _corpus(n: int) -> bytes:
    alice = (DATA / "alice29.txt").read_bytes()
    rng = np.random.default_rng(11)
    parts = []
    total = 0
    while total < n:
        parts.append(alice)
        junk = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
        parts.append(junk)
        total += len(alice) + len(junk)
    return b"".join(parts)[:n]


def test_v3_encode_roundtrip_on_device(gpu_device):
    from compu_tpu.kernels.deflate_jax_v3 import encode_block_dyn

    data = _corpus(BLOCK)
    arr = np.frombuffer(data, dtype=np.uint8)
    import jax.numpy as jnp

    out, meta = encode_block_dyn(
        jnp.asarray(arr), jnp.int32(len(arr)), depth=8, wcap=8)
    clen = int(np.asarray(meta)[0])
    blob = bytes(np.asarray(out)[:clen].tobytes())
    d = zlib.decompressobj(wbits=-15)
    got = d.decompress(blob + b"\x01\x00\x00\xff\xff")
    assert got == data


def test_v2_fixed_encode_roundtrip_on_device(gpu_device):
    from compu_tpu.kernels.deflate_jax_v2 import encode_block_fixed_v2

    data = _corpus(BLOCK)
    arr = np.frombuffer(data, dtype=np.uint8)
    import jax.numpy as jnp

    out, meta = encode_block_fixed_v2(jnp.asarray(arr), jnp.int32(len(arr)),
                                      depth=8)
    clen = int(np.asarray(meta)[0])
    blob = bytes(np.asarray(out)[:clen].tobytes())
    got = zlib.decompressobj(wbits=-15).decompress(blob + b"\x01\x00\x00\xff\xff")
    assert got == data


def test_indexed_lut_decode_roundtrip_on_device(gpu_device):
    """Encode with the indexed v3 path, decode with the LUT device inflate:
    the full device-only loop, bit-exact."""
    import jax.numpy as jnp

    from compu_tpu.formats.deflate.options import ZlibMode
    from compu_tpu.kernels.block_codec import make_block_encode_fn
    from compu_tpu.kernels.inflate_jax_dyn import parse_block_tables
    from compu_tpu.kernels.inflate_jax_lut import decode_blocks_indexed_lut
    from compu_tpu.parallel.scheduler import BlockParallelEncoder

    batch = 4
    corpus = _corpus(batch * BLOCK)
    fn = make_block_encode_fn(ZlibMode.Gzip, level=6, segment_index=True,
                              pipeline_groups=2)
    enc = BlockParallelEncoder(fn, block_size=BLOCK, mode=ZlibMode.Gzip,
                               host_fallback=False)
    stream, index = enc.encode(corpus)
    assert zlib.decompress(stream, wbits=31) == corpus

    cap = BLOCK + BLOCK // 4 + 64 + 16
    comps = np.zeros((batch, cap), dtype=np.uint8)
    segs = np.zeros((batch, BLOCK // 128), dtype=np.int32)
    ns = np.zeros(batch, dtype=np.int32)
    lit_lens = np.zeros((batch, 288), dtype=np.int32)
    dist_lens = np.zeros((batch, 30), dtype=np.int32)
    for j in range(batch):
        off = index.compressed_offsets[j]
        clen = index.compressed_lengths[j]
        blob = stream[off: off + clen]
        kind, lit, dist, _ = parse_block_tables(blob[:4096])
        assert kind != 0 and int(np.asarray(index.segment_bits[j])[0]) >= 0
        comps[j, :clen] = np.frombuffer(blob, dtype=np.uint8)
        segs[j] = np.asarray(index.segment_bits[j], dtype=np.int32)
        ns[j] = index.raw_lengths[j]
        lit_lens[j] = lit
        dist_lens[j] = dist
    out, ok = decode_blocks_indexed_lut(
        jnp.asarray(comps), jnp.asarray(segs), jnp.asarray(ns),
        jnp.asarray(lit_lens), jnp.asarray(dist_lens), n_out=BLOCK)
    assert int(np.asarray(ok)[0]) == 1
    got = np.asarray(out).reshape(batch, BLOCK)
    for j in range(batch):
        n = int(ns[j])
        assert got[j, :n].tobytes() == corpus[j * BLOCK: j * BLOCK + n]


def test_zstd_device_stages_on_device(gpu_device):
    """Device LZ + device literals + device sequences produce a frame the
    native zstd decoder accepts."""
    from compu_tpu import ByteVec, EncodeOp, EncodeStatus, decoder, encoder
    from compu_tpu.formats.zstd.options import ZstdOptions

    data = _corpus(256 * 1024)
    enc = encoder.Interface.zstd(ZstdOptions(
        level=3, checksum=True, device_lz=True, device_literals=True,
        device_sequences=True))
    vec = ByteVec()
    res = enc.encode_vec_full(data, vec, EncodeOp.Finish)
    assert res.status is EncodeStatus.Finished
    out = ByteVec()
    out.reserve_exact(len(data) + 4096)
    assert not decoder.Interface.zstd_native().decode_vec_full(
        vec.data(), out).is_error
    assert out.data() == data


def test_v3_lex_level6_roundtrip_on_device(gpu_device):
    """The production level-6 config (lex keys2 d16) on the chip."""
    import jax.numpy as jnp

    from compu_tpu.kernels.deflate_jax_v3 import encode_block_dyn

    data = _corpus(BLOCK)
    out, meta = encode_block_dyn(
        jnp.asarray(np.frombuffer(data, dtype=np.uint8)),
        jnp.int32(len(data)), depth=16, wcap=16, lex_keys=2)
    blob = bytes(np.asarray(out)[: int(np.asarray(meta)[0])].tobytes())
    got = zlib.decompressobj(wbits=-15).decompress(blob + b"\x01\x00\x00\xff\xff")
    assert got == data


def test_v3_stride2_roundtrip_on_device(gpu_device):
    """Fast-level stride-2 anchor sampling stays bit-valid on the chip."""
    import jax.numpy as jnp

    from compu_tpu.kernels.deflate_jax_v3 import encode_block_dyn

    data = _corpus(BLOCK)
    out, meta = encode_block_dyn(
        jnp.asarray(np.frombuffer(data, dtype=np.uint8)),
        jnp.int32(len(data)), depth=8, wcap=8, lex_keys=1, stride=2)
    blob = bytes(np.asarray(out)[: int(np.asarray(meta)[0])].tobytes())
    got = zlib.decompressobj(wbits=-15).decompress(blob + b"\x01\x00\x00\xff\xff")
    assert got == data


def test_zstd_device_literal_decode_on_device(gpu_device):
    """Device 4-stream literal decode is byte-identical to the host on a
    FOREIGN (libzstd-produced) frame — VERDICT r4 item 8, on the chip."""
    from compu_tpu import ByteVec, decoder
    from compu_tpu.formats.zstd.options import ZstdDecodeOptions

    data = (DATA / "alice29.txt").read_bytes()
    blob = (DATA / "alice29.txt.zst").read_bytes()
    d = decoder.Interface.zstd(ZstdDecodeOptions(device_literals=True))
    vec = ByteVec()
    vec.reserve_exact(len(data) + 4096)
    res = d.decode_vec_full(blob, vec)
    assert not res.is_error
    assert vec.data() == data
    assert d._backend._frame.device_literal_sections > 0


def test_zstd_literal_decode_kernel_parity_on_device(gpu_device):
    """The literal-decode kernel itself, against HufTable.decode_stream."""
    from compu_tpu.formats.zstd.huff import HufEncoder, HufTable
    from compu_tpu.kernels.zstd_lit_decode_jax import decode_4stream_device

    data = _corpus(200_000)
    freqs = np.bincount(np.frombuffer(data, np.uint8), minlength=256)
    enc = HufEncoder(freqs)
    per = (len(data) + 3) // 4
    chunks = [data[i * per:(i + 1) * per] for i in range(3)]
    chunks.append(data[3 * per:])
    bodies = [enc.encode_stream(c) for c in chunks]
    table = HufTable(enc.weights)
    got = decode_4stream_device(
        bodies, [len(c) for c in chunks], table.symbol, table.nbits,
        table.max_bits)
    assert got == data


def test_brotli_hybrid_e2e_on_device(gpu_device):
    """Device-LZ brotli hybrid produces a stream the native brotli decoder
    accepts."""
    from compu_tpu import ByteVec, EncodeOp, EncodeStatus, decoder, encoder
    from compu_tpu.formats.brotli.options import BrotliOptions

    data = _corpus(256 * 1024)
    enc = encoder.Interface.brotli(BrotliOptions(quality=5, device_lz=True))
    vec = ByteVec()
    res = enc.encode_vec_full(data, vec, EncodeOp.Finish)
    assert res.status is EncodeStatus.Finished
    out = ByteVec()
    out.reserve_exact(len(data) + 4096)
    assert not decoder.Interface.brotli_native().decode_vec_full(
        vec.data(), out).is_error
    assert out.data() == data


def test_scheduler_e2e_on_device(gpu_device):
    """Block-parallel encode on the chip -> standard gzip stream -> device
    indexed decode through the scheduler."""
    from compu_tpu.formats.deflate.options import ZlibMode
    from compu_tpu.kernels.block_codec import make_block_encode_fn
    from compu_tpu.parallel.scheduler import (
        BlockParallelDecoder,
        BlockParallelEncoder,
        BlockState,
    )

    corpus = _corpus(4 * BLOCK)
    fn = make_block_encode_fn(ZlibMode.Gzip, level=6, segment_index=True,
                              pipeline_groups=2)
    enc = BlockParallelEncoder(fn, block_size=BLOCK, mode=ZlibMode.Gzip,
                               host_fallback=False)
    stream, index = enc.encode(corpus)
    assert zlib.decompress(stream, wbits=31) == corpus
    assert all(st.state == BlockState.Ok for st in enc.block_statuses)
    dec = BlockParallelDecoder(device=True, block_size=BLOCK,
                               host_fallback=False)
    assert dec.decode(stream, index) == corpus
    assert dec.device_blocks > 0
