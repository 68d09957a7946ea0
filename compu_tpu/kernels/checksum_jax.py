"""Device checksum kernels (JAX/XLA path).

crc32 — the matmul formulation: a CRC register is a GF(2)-linear function of
the input bits, so the raw register of every lane is one dense matmul:

    bits(lanes, 8c) @ A(8c, 32)  mod 2

where column k of ``A`` is the register contribution of input bit j (the
CRC of a buffer with only that bit set — precomputed on host, cached per
lane size). 0/1 values are exact in bf16/f32 and the f32 accumulator is
exact below 2^24 terms, so the parity is exact. This replaces a
256-entry-table gather loop with pure
systolic-array work — the idiomatic mapping.

Lane merging + pad stripping stay on host via the GF(2) algebra
(ops/checksum.py fold_lane_registers / crc_unshift).

adler32 — two modular sums with an int32-safe two-level reduction.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.checksum import ADLER_MOD, CRC_TABLE


@functools.lru_cache(maxsize=8)
def _crc_bit_matrix(c: int) -> np.ndarray:
    """A[8c, 32] float32: A[8p+b, k] = bit k of the raw CRC register of a
    c-byte buffer whose only set bit is bit b of byte p.

    Built with one vectorized sweep: 8c unit buffers advance through the
    byte-table update simultaneously (numpy lanes = unit vectors).
    """
    nbits = 8 * c
    # regs[j] = raw register of unit buffer j after all c bytes.
    regs = np.zeros(nbits, dtype=np.uint32)
    for p in range(c):
        # Unit buffers with their set byte at position p get byte 1<<b now;
        # all other buffers see a zero byte at this position.
        byte = np.zeros(nbits, dtype=np.uint32)
        j = 8 * p + np.arange(8)
        byte[j] = 1 << np.arange(8)
        regs = CRC_TABLE[(regs ^ byte) & 0xFF] ^ (regs >> 8)
    bits = ((regs[:, None] >> np.arange(32)[None, :]) & 1).astype(np.float32)
    return bits


@functools.partial(jax.jit, static_argnames=("lanes",))
def crc32_lane_registers(block: jnp.ndarray, *, lanes: int = 1024) -> jnp.ndarray:
    """Raw CRC registers (init 0) of ``lanes`` contiguous equal slices of a
    fixed-size block, via one matmul. Block size divisible by lanes."""
    n = block.shape[0]
    c = n // lanes
    a = jnp.asarray(_crc_bit_matrix(c))  # (8c, 32)
    grid = block.reshape(lanes, c).astype(jnp.uint8)
    # Unpack bytes to bits, LSB-first: (lanes, c, 8) -> (lanes, 8c).
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = ((grid[:, :, None] >> shifts[None, None, :]) & 1).astype(jnp.float32)
    bits = bits.reshape(lanes, 8 * c)
    acc = jnp.dot(bits, a, preferred_element_type=jnp.float32)  # exact counts
    parity = acc.astype(jnp.int32) & 1  # (lanes, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, :]
    return jnp.sum(parity.astype(jnp.uint32) * weights, axis=1).astype(jnp.uint32)


@jax.jit
def adler32_block(data: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """adler32 of the first ``n`` bytes of a padded block (uint32)."""
    N = data.shape[0]
    pos = jnp.arange(N, dtype=jnp.int32)
    db = jnp.where(pos < n, data.astype(jnp.int32), 0)
    s = jnp.sum(db)
    wmod = (jnp.maximum(n - pos, 0) % ADLER_MOD).astype(jnp.int32)
    group = jnp.sum((db * wmod).reshape(-1, 64), axis=1) % ADLER_MOD
    w = jnp.sum(group) % ADLER_MOD
    a = (1 + s) % ADLER_MOD
    b = (n % ADLER_MOD + w) % ADLER_MOD
    return (b.astype(jnp.uint32) << 16) | a.astype(jnp.uint32)
