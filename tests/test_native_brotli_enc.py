"""Second brotli ENCODER implementation (csrc/compu_brotli_enc2.cpp) —
the reference's dual-encoder pattern on the encode side
(reference src/encoder/brotli_c.rs:42-50 vs encoder/brotli.rs:22-29):
two complete, interchangeable implementations behind one Interface.

Oracles: libbrotli decode (foreign tool), this repo's pure-Python decoder
and native C++ decoder (independent implementations), plus the state
machine / determinism invariants the reference's encoder tests pin
(tests/encoder.rs:10-78, :115-173).
"""

import sys

import numpy as np
import pytest

sys.path.insert(0, "tests")

from compu_tpu import Buffer, ByteVec, decoder, encoder
from compu_tpu.formats.brotli.native_enc2 import available
from compu_tpu.formats.brotli.options import BrotliOptions
from compu_tpu.status import DecodeStatus, EncodeOp, EncodeStatus

pytestmark = pytest.mark.skipif(not available(),
                                reason="native runtime unavailable")

ALICE = open("tests/data/alice29.txt", "rb").read()


def _oracle_decompress(blob, n):
    import brotli_oracle

    return brotli_oracle.decompress(blob, n + 64)


def _encode_full(enc, data):
    vec = ByteVec()
    res = enc.encode_vec_full(data, vec, EncodeOp.Finish)
    assert res.status is EncodeStatus.Finished
    return vec.data()


@pytest.mark.parametrize("quality", [1, 5, 9, 11])
def test_oracle_roundtrip(quality):
    enc = encoder.Interface.brotli_native(BrotliOptions(quality=quality))
    blob = _encode_full(enc, ALICE)
    assert _oracle_decompress(blob, len(ALICE)) == ALICE


@pytest.mark.parametrize("impl", ["python", "native"])
def test_cross_impl_decoders(impl):
    """Both in-repo decoder implementations accept the native encoder's
    streams (cross-implementation oracle, reference tests/decoder.rs)."""
    enc = encoder.Interface.brotli_native(BrotliOptions(quality=5))
    blob = _encode_full(enc, ALICE)
    dec = (decoder.Interface.brotli() if impl == "python"
           else decoder.Interface.brotli_native())
    vec = ByteVec()
    res = dec.decode_vec_full(blob, vec)
    assert res.status is DecodeStatus.Finished
    assert vec.data() == ALICE


def test_chunked_equals_oneshot():
    """Determinism invariant (reference tests/encoder.rs:56-57): Buffer
    chunked encode produces the byte-identical stream."""
    opts = BrotliOptions(quality=5)
    one = _encode_full(encoder.Interface.brotli_native(opts), ALICE)

    enc = encoder.Interface.brotli_native(opts)
    buf = Buffer(4096)
    chunked = bytearray()
    rem = memoryview(ALICE)
    while True:
        consumed, st = buf.encode(enc, rem, EncodeOp.Finish)
        rem = rem[consumed:]
        chunked.extend(buf.data())
        buf.consume()
        assert st.status is not EncodeStatus.Error
        if st.status is EncodeStatus.Finished and not buf.data():
            break
    assert bytes(chunked) == one


def test_three_op_protocol():
    """Process -> Flush -> Finish-with-empty (reference
    tests/encoder.rs:115-173)."""
    enc = encoder.Interface.brotli_native(BrotliOptions(quality=5))
    out = bytearray(len(ALICE) + 65536)
    r1 = enc.encode(ALICE, memoryview(out), EncodeOp.Process)
    assert r1.input_remain == 0
    written = len(out) - r1.output_remain
    r2 = enc.encode(b"", memoryview(out)[written:], EncodeOp.Flush)
    assert r2.status in (EncodeStatus.Continue, EncodeStatus.NeedOutput)
    written += (len(out) - written) - r2.output_remain
    r3 = enc.encode(b"", memoryview(out)[written:], EncodeOp.Finish)
    assert r3.status is EncodeStatus.Finished
    written += (len(out) - written) - r3.output_remain
    assert _oracle_decompress(bytes(out[:written]), len(ALICE)) == ALICE


def test_reset_reuse():
    enc = encoder.Interface.brotli_native(BrotliOptions(quality=7))
    b1 = _encode_full(enc, ALICE)
    assert enc.reset()
    b2 = _encode_full(enc, ALICE)
    assert b1 == b2  # options survive reset (opts re-applied)


def test_window_carry_across_chunks():
    """Matches may reference earlier pipeline chunks (the C++ window
    history); streams stay valid across many meta-blocks."""
    data = ALICE * 6  # ~912 KB > 1 pipeline block? block=1MiB; force small
    opts = BrotliOptions(quality=5, window_bits=18)
    enc = encoder.Interface.brotli_native(opts)
    blob = _encode_full(enc, data)
    assert _oracle_decompress(blob, len(data)) == data
    # repeated content must compress far better than 1x alice alone would
    assert len(blob) < len(ALICE)


@pytest.mark.parametrize("kind", ["random", "lowent", "runs"])
def test_hard_corpora(kind):
    rng = np.random.default_rng(3)
    if kind == "random":
        data = rng.integers(0, 256, 300000, dtype=np.uint8).tobytes()
    elif kind == "lowent":
        data = rng.integers(0, 4, 300000, dtype=np.uint8).tobytes()
    else:
        data = b"\x00" * 200000 + b"ab" * 50000
    enc = encoder.Interface.brotli_native(BrotliOptions(quality=5))
    blob = _encode_full(enc, data)
    assert _oracle_decompress(blob, len(data)) == data


def test_empty_and_tiny():
    for data in (b"", b"x", b"10x10y"):
        enc = encoder.Interface.brotli_native(BrotliOptions(quality=5))
        blob = _encode_full(enc, data)
        assert _oracle_decompress(blob, len(data)) == data


def test_quality_ladder_monotone_cost():
    """Higher qualities never catastrophically regress size (sanity)."""
    sizes = {}
    for q in (1, 5, 9):
        enc = encoder.Interface.brotli_native(BrotliOptions(quality=q))
        sizes[q] = len(_encode_full(enc, ALICE))
    assert sizes[9] <= sizes[1] * 1.02
