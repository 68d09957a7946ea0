"""Hybrid pipeline test: the shared device LZ stage feeding host entropy
coders (small shapes keep CPU-XLA compiles fast; the same graph runs on
device)."""

import pathlib
import sys
import zlib

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from compu_tpu.formats.device_lz import DeviceTokenizer
from compu_tpu.formats.zstd.encode import compress_block

DATA = pathlib.Path(__file__).parent / "data"
BS = 1 << 14


def test_device_tokens_cover():
    """Device tokens form a valid contiguous cover with sane matches."""
    raw = (DATA / "alice29.txt").read_bytes()[:BS]
    tok = DeviceTokenizer(BS, BS)
    tok_pos, tok_len, tok_dist = tok(raw)
    pos = 0
    for p, l, d in zip(tok_pos, tok_len, tok_dist):
        assert p == pos
        if l:
            assert 3 <= l <= 258
            assert 1 <= d <= p
            assert raw[p : p + l] == raw[p - d : p - d + l]
            pos += l
        else:
            pos += 1
    assert pos == len(raw)


def test_device_tokens_feed_zstd_entropy():
    """Device cover through the zstd host entropy stage roundtrips."""
    import zstandard

    raw = (DATA / "alice29.txt").read_bytes()[:BS]
    tok = DeviceTokenizer(BS, BS)
    blob = compress_block(raw, 6, tokenizer=tok)
    # compress_block returns a full block (header included); wrap manually.
    import struct

    frame = struct.pack("<IBB", 0xFD2FB528, 0, (14 - 10) << 3) + bytes(
        [blob[0] | 1]
    ) + blob[1:]
    got = zstandard.ZstdDecompressor().decompress(frame, max_output_size=BS + 16)
    assert got == raw


def test_device_tokens_large_distance_pack():
    """Distances beyond DEFLATE's 2^15 (brotli windows reach 2^20 here)
    must survive the packed i32 D2H format (regression: an 18-bit dist
    field truncated them and corrupted brotli hybrid streams)."""
    BS2 = 1 << 19
    rng = np.random.default_rng(3)
    noise = rng.integers(0, 256, BS2, dtype=np.uint8)
    pat = bytes(rng.integers(0, 256, 256, dtype=np.uint8))
    data = bytearray(noise.tobytes())
    data[0:256] = pat
    far = BS2 - 4096  # repeat at distance ~ BS2 - 4096 > 2^18
    data[far : far + 256] = pat
    tok = DeviceTokenizer(BS2, BS2)
    tok_pos, tok_len, tok_dist = tok(bytes(data))
    big = tok_dist[(tok_len >= 3) & (tok_pos >= far) & (tok_pos < far + 256)]
    assert len(big) and big.max() == far, big.max()
    # and the cover still reconstructs
    pos = 0
    for p, l, d in zip(tok_pos, tok_len, tok_dist):
        assert p == pos
        if l:
            assert data[p : p + l] == data[p - d : p - d + l]
            pos += l
        else:
            pos += 1
    assert pos == len(data)
