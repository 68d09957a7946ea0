"""Foreign-stream device inflate (decoder.Interface.zlib_device).

The speculative-resync path must decode ARBITRARY streams bit-exactly:
golden fixtures from stock gzip (the reference's decode oracle,
reference tests/decoder.rs:8-19), python-zlib streams with dynamic
blocks, multi-block streams with window history crossing block
boundaries, stored blocks, and the reference's four decode driver styles
(one-shot / partial-output restart / Buffer-chunked / decode_vec_full).
"""

import pathlib
import sys
import zlib

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from compu_tpu import Buffer, ByteVec, DecodeStatus, decoder
from compu_tpu.formats.deflate.options import ZlibMode

DATA = pathlib.Path(__file__).parent / "data"
TINY = b"X" * 10 + b"Y" * 10


def _one_shot(dec, blob, expect):
    out = bytearray(len(expect) + 16)
    res = dec.decode(blob, out)
    assert not res.is_error, res
    assert res.status is DecodeStatus.Finished
    produced = len(out) - res.output_remain
    assert bytes(out[:produced]) == expect
    return res


def test_golden_gzip_fixtures():
    for name in ("10x10y", "alice29.txt"):
        raw = (DATA / name).read_bytes()
        blob = (DATA / f"{name}.gz").read_bytes()
        dec = decoder.Interface.zlib_device(ZlibMode.Gzip)
        _one_shot(dec, blob, raw)
        assert dec.reset()
        # Auto mode sniffs the gzip magic
        _one_shot(decoder.Interface.zlib_device(ZlibMode.Auto), blob, raw)


def test_golden_zlib_fixture():
    raw = (DATA / "10x10y").read_bytes()
    blob = (DATA / "10x10y.zz").read_bytes()
    _one_shot(decoder.Interface.zlib_device(ZlibMode.Zlib), blob, raw)


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_foreign_zlib_levels(level):
    raw = (DATA / "alice29.txt").read_bytes()[:65536]
    blob = zlib.compress(raw, level)
    _one_shot(decoder.Interface.zlib_device(ZlibMode.Zlib), blob, raw)


def test_multi_block_window_history():
    # Z_FULL_FLUSH forces block boundaries WITHOUT window reset, so
    # back-references in later blocks reach into earlier blocks' output —
    # exercises the stream-global resolution.
    raw = (DATA / "alice29.txt").read_bytes()[:40000]
    co = zlib.compressobj(6)
    blob = b"".join([
        co.compress(raw[:10000]), co.flush(zlib.Z_FULL_FLUSH),
        co.compress(raw[10000:20000]), co.flush(zlib.Z_FULL_FLUSH),
        co.compress(raw[20000:]), co.flush(zlib.Z_FINISH),
    ])
    _one_shot(decoder.Interface.zlib_device(ZlibMode.Zlib), blob, raw)


def test_partial_output_restart():
    raw = (DATA / "10x10y").read_bytes()
    blob = (DATA / "10x10y.gz").read_bytes()
    dec = decoder.Interface.zlib_device(ZlibMode.Gzip)
    half = bytearray(len(raw) // 2)
    res = dec.decode(blob, half)
    assert res.status is DecodeStatus.NeedOutput
    rest = bytearray(len(raw))
    res2 = dec.decode(blob[len(blob) - res.input_remain :], rest)
    assert res2.status is DecodeStatus.Finished
    produced = len(rest) - res2.output_remain
    assert bytes(half) + bytes(rest[:produced]) == raw


def test_buffer_chunked_and_vec_full():
    raw = (DATA / "alice29.txt").read_bytes()[:30000]
    blob = zlib.compress(raw, 6)
    dec = decoder.Interface.zlib_device(ZlibMode.Zlib)
    buf = Buffer(4096)
    got = bytearray()
    inp = memoryview(blob)
    while True:
        consumed, res = buf.decode(dec, inp)
        assert not res.is_error
        got.extend(buf.data())
        buf.consume()
        inp = inp[consumed:]
        if res.status is DecodeStatus.Finished:
            break
        assert len(inp) or res.status is DecodeStatus.NeedOutput
    assert bytes(got) == raw

    dec2 = decoder.Interface.zlib_device(ZlibMode.Zlib)
    vec = ByteVec()
    res = dec2.decode_vec_full(blob, vec)
    assert res.status is DecodeStatus.Finished
    assert vec.data() == raw


def test_chunked_input_needinput():
    raw = TINY * 50
    blob = zlib.compress(raw, 6)
    dec = decoder.Interface.zlib_device(ZlibMode.Zlib)
    out = bytearray(len(raw) + 16)
    pos = 0
    step = max(1, len(blob) // 4)
    written = 0
    for i in range(0, len(blob), step):
        chunk = blob[i : i + step]
        res = dec.decode(chunk, memoryview(out)[written:])
        assert not res.is_error
        written += len(out) - written - res.output_remain
        if i + step < len(blob):
            assert res.status is DecodeStatus.NeedInput
    assert res.status is DecodeStatus.Finished
    assert bytes(out[:written]) == raw


def test_corrupt_stream_fails():
    raw = (DATA / "alice29.txt").read_bytes()[:30000]
    blob = bytearray(zlib.compress(raw, 6))
    blob[len(blob) // 2] ^= 0xFF
    dec = decoder.Interface.zlib_device(ZlibMode.Zlib)
    out = bytearray(len(raw) + 16)
    res = dec.decode(bytes(blob), out)
    # corruption surfaces as a typed error (invalid code / checksum
    # mismatch) or, when the flip mimics truncation, as NeedInput — it
    # must never report Finished with wrong bytes
    assert res.status is not DecodeStatus.Finished


def test_fixed_block_high_byte_literals():
    """Regression: fixed-Huffman 9-bit literal codes (bytes >= 144).

    parse_block_tables once truncated the fixed tree to 286 symbols; the
    two phantom 8-bit codes (286, 287) shift the canonical numbering of
    every 9-bit code, so all high-byte literals decoded +4. Text corpora
    never hit 9-bit codes — this pins the high-byte path."""
    import numpy as np
    import jax.numpy as jnp
    import zlib as _zlib

    from compu_tpu.formats.deflate.options import ZlibMode
    from compu_tpu.kernels.block_codec import make_block_encode_fn
    from compu_tpu.kernels.inflate_jax_dyn import (
        decode_blocks_indexed_dyn,
        parse_block_tables,
    )
    from compu_tpu.kernels.inflate_jax_lut import decode_blocks_indexed_lut
    from compu_tpu.parallel.scheduler import BlockParallelEncoder

    bs = 1 << 18
    rng = np.random.default_rng(11)
    alice = (DATA / "alice29.txt").read_bytes()
    corpus = (alice + rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
              + alice)[:bs]
    fn = make_block_encode_fn(ZlibMode.Gzip, level=6, segment_index=True)
    enc = BlockParallelEncoder(fn, block_size=bs, mode=ZlibMode.Gzip)
    stream, index = enc.encode(corpus)
    assert _zlib.decompress(stream, wbits=31) == corpus
    off = index.compressed_offsets[0]
    clen = index.compressed_lengths[0]
    blob = stream[off: off + clen]
    kind, lit, dist, _ = parse_block_tables(blob[:4096])
    assert kind != 0
    cap = bs + bs // 4 + 64 + 16
    comps = np.zeros((1, cap), dtype=np.uint8)
    comps[0, :clen] = np.frombuffer(blob, dtype=np.uint8)
    segs = np.asarray(index.segment_bits[0], dtype=np.int32)[None, :]
    ns = np.asarray([index.raw_lengths[0]], dtype=np.int32)
    for fn2 in (decode_blocks_indexed_lut, decode_blocks_indexed_dyn):
        out, ok = fn2(jnp.asarray(comps), jnp.asarray(segs), jnp.asarray(ns),
                      jnp.asarray(lit[None, :]), jnp.asarray(dist[None, :]),
                      n_out=bs)
        assert int(np.asarray(ok)[0]) == 1
        assert np.asarray(out)[: len(corpus)].tobytes() == corpus
