"""Lane-parallel checksums: adler32 (RFC1950), crc32 (RFC1952/gzip).

The reference delegates checksums to the native codec libraries (libz
computes adler32/crc32 inside deflate/inflate). Here they are first-class
data-parallel primitives, structured for vector hardware:

* the stream is split into L contiguous *lanes* (equal-size chunks);
* all lanes' partial checksums advance simultaneously with vectorized ops
  (slice-by-8 table steps — on device the table gather becomes a
  GF(2) bit-matrix matmul, see kernels/checksum_jax.py);
* lane partials merge with O(L) combine algebra:
  - adler32 is a pair of modular sums with a closed-form chunk merge;
  - crc32 is GF(2)-linear: a register is shifted past a lane of zero bytes
    by one cached 32x32 bit-matrix (the zlib ``crc32_combine`` algebra), so
    merging L lanes is a fold of matrix-apply + XOR.

Host implementations are numpy; they are the same algorithm the device
kernels run and serve as the correctness oracle for them.
"""

from __future__ import annotations

import numpy as np

ADLER_MOD = 65521
CRC32_POLY = 0xEDB88320  # reflected polynomial

_BIT_IDX = np.arange(32, dtype=np.uint64)


# --------------------------------------------------------------------------
# adler32
# --------------------------------------------------------------------------
def adler32(data, value: int = 1) -> int:
    """adler32 of ``data`` continuing from ``value`` (zlib.adler32 equivalent).

    Prefers the native host runtime; the numpy lane-parallel path below is
    the fallback and the device-algorithm oracle."""
    from ..runtime import native

    r = native.adler32(data, value)
    if r is not None:
        return r
    return adler32_lanes(data, value)


def adler32_lanes(data, value: int = 1) -> int:
    """Data-parallel adler32: vector sum + weighted vector sum per bounded
    chunk (bounds keep accumulators exact)."""
    a = value & 0xFFFF
    b = (value >> 16) & 0xFFFF
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    # Per-chunk sums stay exactly representable in float64
    # (weighted sum <= step * 255 * step = 1.1e12 < 2^53), so the heavy ops
    # are one BLAS matvec + one row-sum over the (chunks, step) grid.
    step = 1 << 16
    m = (len(arr) // step) * step
    if m:
        grid = arr[:m].reshape(-1, step).astype(np.float64)
        weights = np.arange(step, 0, -1, dtype=np.float64)
        s = grid.sum(axis=1).astype(np.int64)  # per-chunk byte sums
        w = (grid @ weights).astype(np.int64)  # per-chunk weighted sums
        # a before chunk k; reduce mod first so the b-accumulation below
        # stays within int64 even for multi-GB inputs.
        a_prefix = (a + np.concatenate([[0], np.cumsum(s)[:-1]])) % ADLER_MOD
        b = int((b + np.sum(step * a_prefix + w)) % ADLER_MOD)
        a = int((a + s.sum()) % ADLER_MOD)
    tail = arr[m:]
    if len(tail):
        n = len(tail)
        chunk = tail.astype(np.float64)
        s_t = int(chunk.sum())
        w_t = int(np.dot(chunk, np.arange(n, 0, -1, dtype=np.float64)))
        b = (b + n * a + w_t) % ADLER_MOD
        a = (a + s_t) % ADLER_MOD
    return ((b << 16) | a) & 0xFFFFFFFF


def adler32_combine(adler1: int, adler2: int, len2: int) -> int:
    """adler32 of A||B from adler32(A), adler32(B), len(B)
    (zlib adler32_combine semantics). Used by the block-parallel scheduler
    to merge per-block checksums computed on different devices."""
    rem = len2 % ADLER_MOD
    a1 = adler1 & 0xFFFF
    b1 = (adler1 >> 16) & 0xFFFF
    a2 = adler2 & 0xFFFF
    b2 = (adler2 >> 16) & 0xFFFF
    a = (a1 + a2 + ADLER_MOD - 1) % ADLER_MOD
    b = (b1 + rem * a1 + b2 + ADLER_MOD - rem) % ADLER_MOD
    return ((b << 16) | a) & 0xFFFFFFFF


# --------------------------------------------------------------------------
# crc32
# --------------------------------------------------------------------------
def _make_crc_tables(n: int = 8) -> np.ndarray:
    """Slice-by-N tables: T[0] is the classic byte table; T[k] advances a
    byte seen k positions earlier past k zero bytes."""
    tables = np.zeros((n, 256), dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (CRC32_POLY if c & 1 else 0)
        tables[0, i] = c
    for k in range(1, n):
        prev = tables[k - 1]
        tables[k] = tables[0][prev & 0xFF] ^ (prev >> 8)
    return tables


CRC_TABLES = _make_crc_tables()
CRC_TABLE = CRC_TABLES[0]


def _gf2_apply(mat: np.ndarray, vec: int) -> int:
    """Multiply a 32x32 GF(2) matrix (rows as uint64 bitmasks) by a vector."""
    bits = ((np.uint64(vec) >> _BIT_IDX) & np.uint64(1)).astype(bool)
    sel = np.where(bits, mat, np.uint64(0))
    return int(np.bitwise_xor.reduce(sel))


def _gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """rows of result: a applied to each row of b... (apply a after b)."""
    return np.array([_gf2_apply(a, int(r)) for r in b], dtype=np.uint64)


_SHIFT_CACHE: dict[int, np.ndarray] = {}


def zero_shift_operator(nbytes: int) -> np.ndarray:
    """GF(2) operator advancing a (reflected, LSB-first) CRC register past
    ``nbytes`` zero bytes. Cached per length."""
    op = _SHIFT_CACHE.get(nbytes)
    if op is not None:
        return op
    # One zero bit: shift-right with polynomial feedback from bit 0.
    one_bit = np.zeros(32, dtype=np.uint64)
    one_bit[0] = CRC32_POLY
    for i in range(1, 32):
        one_bit[i] = np.uint64(1) << np.uint64(i - 1)
    identity = np.array([1 << i for i in range(32)], dtype=np.uint64)
    result = identity
    base = one_bit
    n = nbytes * 8
    while n:
        if n & 1:
            result = _gf2_matmul(base, result)
        n >>= 1
        if n:
            base = _gf2_matmul(base, base)
    _SHIFT_CACHE[nbytes] = result
    return result


def crc_shift(crc: int, nbytes: int) -> int:
    """Shift a raw CRC register past ``nbytes`` zero bytes."""
    if nbytes == 0:
        return crc
    return _gf2_apply(zero_shift_operator(nbytes), crc)


def _crc_serial(reg: int, data: np.ndarray) -> int:
    """Raw register update over a short byte array (scalar path)."""
    crcs = np.array([reg], dtype=np.uint32)
    for byte in data:
        crcs = CRC_TABLE[(crcs ^ byte) & 0xFF] ^ (crcs >> 8)
    return int(crcs[0])


def _crc_lanes_slice8(grid: np.ndarray) -> np.ndarray:
    """Raw CRC register (init 0) of each row of a (L, c) uint8 array,
    c a multiple of 8, all rows advancing in lockstep (slice-by-8)."""
    L, c = grid.shape
    crcs = np.zeros(L, dtype=np.uint32)
    g = grid.astype(np.uint32)
    t0, t1, t2, t3, t4, t5, t6, t7 = (CRC_TABLES[k] for k in range(8))
    for j in range(0, c, 8):
        low = g[:, j] | (g[:, j + 1] << 8) | (g[:, j + 2] << 16) | (g[:, j + 3] << 24)
        x = crcs ^ low
        crcs = (
            t7[x & 0xFF]
            ^ t6[(x >> 8) & 0xFF]
            ^ t5[(x >> 16) & 0xFF]
            ^ t4[(x >> 24) & 0xFF]
            ^ t3[g[:, j + 4]]
            ^ t2[g[:, j + 5]]
            ^ t1[g[:, j + 6]]
            ^ t0[g[:, j + 7]]
        )
    return crcs


def _gf2_apply_vec(mat: np.ndarray, vec: np.ndarray) -> np.ndarray:
    """Apply one 32x32 GF(2) operator to many registers at once."""
    bits = ((vec[:, None].astype(np.uint64) >> _BIT_IDX[None, :]) & np.uint64(1)).astype(
        np.uint64
    )
    return np.bitwise_xor.reduce(bits * mat[None, :], axis=1).astype(np.uint32)


def crc32(data, value: int = 0) -> int:
    """crc32 with gzip conventions, continuing from ``value`` — drop-in
    equivalent of ``zlib.crc32``. Prefers the native host runtime; the
    lane-parallel path below is the fallback and the device oracle."""
    from ..runtime import native

    r = native.crc32(data, value)
    if r is not None:
        return r
    return crc32_lanes(data, value)


def crc32_lanes(data, value: int = 0) -> int:
    """Lane-parallel crc32: L contiguous lanes advance together
    (slice-by-8); lane registers merge with a log2(L)-level GF(2) tree
    reduction (each level shifts the left half past the right half's
    zero-length and XORs)."""
    data = np.frombuffer(bytes(data), dtype=np.uint8)
    n = len(data)
    reg = (value ^ 0xFFFFFFFF) & 0xFFFFFFFF
    if n == 0:
        return value & 0xFFFFFFFF
    if n < 1 << 14:
        return (_crc_serial(reg, data) ^ 0xFFFFFFFF) & 0xFFFFFFFF
    # Pick a power-of-two lane count so per-lane serial steps stay ~1k.
    lanes = 1 << max(6, min(13, (n // 8192).bit_length()))
    c = (n // lanes) & ~7  # per-lane bytes, multiple of 8
    body = lanes * c
    grid = data[:body].reshape(lanes, c)
    vals = _crc_lanes_slice8(grid)  # raw registers, init 0
    # Tree reduction: at level k adjacent pairs are c*2^k bytes apart.
    op = zero_shift_operator(c)
    while len(vals) > 1:
        left = _gf2_apply_vec(op, vals[0::2])
        vals = left ^ vals[1::2]
        op = _gf2_matmul(op, op)
    r = crc_shift(reg, body) ^ int(vals[0])
    if body < n:
        r = _crc_serial(r, data[body:])
    return (r ^ 0xFFFFFFFF) & 0xFFFFFFFF


def _gf2_inverse(mat: np.ndarray) -> np.ndarray:
    """Invert a 32x32 GF(2) matrix (rows as uint64 bitmasks) by Gaussian
    elimination. Shift operators are bijections, so this always succeeds."""
    a = mat.astype(np.uint64).copy()
    inv = np.array([1 << i for i in range(32)], dtype=np.uint64)
    for col in range(32):
        bit = np.uint64(1) << np.uint64(col)
        pivot = None
        for row in range(col, 32):
            if a[row] & bit:
                pivot = row
                break
        if pivot is None:  # pragma: no cover - operators are invertible
            raise ValueError("singular GF(2) matrix")
        a[[col, pivot]] = a[[pivot, col]]
        inv[[col, pivot]] = inv[[pivot, col]]
        for row in range(32):
            if row != col and (a[row] & bit):
                a[row] ^= a[col]
                inv[row] ^= inv[col]
    return inv


_UNSHIFT_CACHE: dict[int, np.ndarray] = {}


def crc_unshift(crc: int, nbytes: int) -> int:
    """Undo ``crc_shift``: recover the register as it was before ``nbytes``
    trailing ZERO bytes were appended. Lets device kernels run on padded
    fixed-shape blocks and the host strip the pad algebraically."""
    if nbytes == 0:
        return crc
    # The GF(2) apply uses column-major semantics (mat[i] is the image of
    # basis vector i), so invert the operator matrix transposed-consistently
    # by inverting in the same representation.
    op = _UNSHIFT_CACHE.get(nbytes)
    if op is None:
        op = _gf2_inverse(zero_shift_operator(nbytes))
        _UNSHIFT_CACHE[nbytes] = op
    return _gf2_apply(op, crc)


def fold_lane_registers(lane_regs: np.ndarray, lane_bytes: int, init_reg: int = 0xFFFFFFFF) -> int:
    """Merge per-lane raw CRC registers (init 0, contiguous equal lanes)
    into the stream register, folding in ``init_reg`` at the front.
    This is the host half of the device lane-parallel crc32 kernel."""
    vals = lane_regs.astype(np.uint32).copy()
    op = zero_shift_operator(lane_bytes)
    while len(vals) > 1:
        if len(vals) % 2:  # pragma: no cover - lane counts are powers of two
            raise ValueError("lane count must be a power of two")
        vals = _gf2_apply_vec(op, vals[0::2]) ^ vals[1::2]
        op = _gf2_matmul(op, op)
    total = lane_bytes * len(lane_regs)
    return int(crc_shift(init_reg, total) ^ int(vals[0]))


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """zlib ``crc32_combine``: crc32 of A||B from the two finished crcs.

    With finished (post-xor) crcs the pre/post conditioning terms cancel to
    ``shift(crc1, len2) ^ crc2`` — the classic zlib algebra.
    """
    return (crc_shift(crc1 & 0xFFFFFFFF, len2) ^ crc2) & 0xFFFFFFFF
