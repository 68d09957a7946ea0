"""LUT-based multi-token indexed device inflate.

Supersedes the canonical-arithmetic one-token-per-step scan
(inflate_jax_dyn.py) on the throughput path. Two structural changes, both
aimed at the measured cost model (the scan is gather-launch-bound: every
while-step issues ~6 HBM gathers per lane and a token costs one step):

1. *Per-block direct decode LUTs* (2^12 entries): the v3 encoder caps
   code lengths at CAPBITS=12 (deflate_jax_v3.py:54) and fixed-tree
   blocks are <= 9 bits, so a 12-bit window addresses a direct
   (kind, code_len, extra_bits, base) record — ONE gather per symbol
   instead of a 15-wide range-compare plus a symlist gather. The LUTs
   (~1 MB i32 per 64-block batch) are built on device from the
   host-parsed code lengths by the same canonical arithmetic, evaluated
   densely over all 4096 entries.
2. *Multi-token steps*: each while-step fetches one 384-bit window (a
   12-word overlapping row view, ONE row gather) and decodes up to K=6
   tokens from it with dense funnel shifts. Worst-case tokens are 48
   bits, so >= 5 tokens always fit — the sequential step count drops
   from <=128 to <=26 and the per-step gather count is amortized over K
   tokens.

Records and the expansion/resolution phases are shared with the fixed
scan (inflate_jax._expand_and_resolve).

Reference parity: dynamic-block decode of inflate
(reference src/decoder/zlib.rs:97) on the indexed device path.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..formats.deflate import consts
from .deflate_jax_v2 import SEG
from .inflate_jax import _expand_and_resolve
from .inflate_jax_dyn import _canon_tables

LUT_BITS = 12
LUT = 1 << LUT_BITS
K = 6        # token slots per step
RSTEPS = 26  # >= ceil(128 / 5): >= 5 worst-case 48-bit tokens fit a step
R = K * RSTEPS  # record rows per lane

_LBASE = jnp.asarray(np.asarray(consts.LENGTH_BASE, dtype=np.int32))
_LXB = jnp.asarray(np.asarray(consts.LENGTH_EXTRA, dtype=np.int32))
_DBASE = jnp.asarray(np.asarray(consts.DIST_BASE, dtype=np.int32))
_DXB = jnp.asarray(np.asarray(consts.DIST_EXTRA, dtype=np.int32))


def _rev_bits_arr(v, nbits):
    r = jnp.zeros_like(v)
    for i in range(nbits):
        r = r | (((v >> i) & 1) << (nbits - 1 - i))
    return r


def _lut_decode_all(lengths, A, nbits=LUT_BITS):
    """Decode EVERY nbits-bit raw (LSB-first) window against one code:
    returns (sym, clen, ok) arrays of shape (2^nbits,). Codes longer than
    nbits mark ok=False (nbits=12 covers every CAPBITS-12 self-produced
    stream; the foreign path uses nbits=15, the RFC maximum)."""
    count, first, base, symlist = _canon_tables(lengths, A)
    v = jnp.arange(1 << nbits, dtype=jnp.int32)
    rv = _rev_bits_arr(v, nbits)
    ls = jnp.arange(1, nbits + 1)
    cand = rv[:, None] >> (nbits - ls)[None, :]             # (2^nbits, nbits)
    okl = (cand >= first[None, :nbits]) \
        & (cand < (first + count)[None, :nbits])
    l_idx = jnp.argmax(okl, axis=1)
    any_ok = jnp.any(okl, axis=1)
    rows = jnp.arange(1 << nbits)
    off = base[l_idx] + cand[rows, l_idx] - first[l_idx]
    sym = symlist[jnp.clip(off, 0, A - 1)]
    return sym, (l_idx + 1).astype(jnp.int32), any_ok


def _lit_lut_block(lit_lens, nbits=LUT_BITS):
    """(2^nbits,) packed lit/len records: kind(2) | clen(4) | lxb(3) |
    arg(8). kind 0 = literal (arg = byte), 1 = match (arg = len_base - 3),
    2 = EOB, 3 = invalid."""
    sym, clen, ok = _lut_decode_all(lit_lens, 288, nbits)
    is_lit = ok & (sym < 256)
    is_eob = ok & (sym == 256)
    is_match = ok & (sym > 256) & (sym < 286)
    code = jnp.clip(sym - 257, 0, 28)
    kind = jnp.where(is_lit, 0, jnp.where(is_match, 1,
                                          jnp.where(is_eob, 2, 3)))
    arg = jnp.where(is_lit, sym, _LBASE[code] - 3)
    lxb = jnp.where(is_match, _LXB[code], 0)
    return (kind | (jnp.clip(clen, 1, 15) << 2) | (lxb << 6)
            | (jnp.clip(arg, 0, 255) << 9))


def _dist_lut_block(dist_lens, nbits=LUT_BITS):
    """(2^nbits,) packed dist records: valid(1) | dlen(4) | dxb(4) |
    dbase-1 (15)."""
    sym, clen, ok = _lut_decode_all(dist_lens, 30, nbits)
    valid = ok & (sym < 30)
    s = jnp.clip(sym, 0, 29)
    return (valid.astype(jnp.int32) | (jnp.clip(clen, 1, 15) << 1)
            | (_DXB[s] << 5) | ((_DBASE[s] - 1) << 9))


def _mux12(w, q):
    """Per-lane dynamic column select from a (L, 12) row window: a 3-level
    where-tree (dense, no gather). q in [0, 11]."""
    b0 = (q & 1) > 0
    m = [jnp.where(b0, w[:, 2 * i + 1], w[:, 2 * i]) for i in range(6)]
    b1 = (q & 2) > 0
    m = [jnp.where(b1, m[2 * i + 1], m[2 * i]) for i in range(3)]
    return jnp.where(q >= 8, m[2], jnp.where(q >= 4, m[1], m[0]))


@functools.partial(jax.jit, static_argnames=("n_out",))
def decode_blocks_indexed_lut(comps: jnp.ndarray, seg_bits: jnp.ndarray,
                              ns: jnp.ndarray, lit_lens: jnp.ndarray,
                              dist_lens: jnp.ndarray, *, n_out: int):
    """Decode a batch of indexed deflate blocks (CAPBITS <= 12 code
    lengths — every self-produced stream; foreign indexed streams with
    13..15-bit codes fall back to decode_blocks_indexed_dyn).

    Args/returns as decode_blocks_indexed_dyn."""
    B, CAP = comps.shape
    assert CAP % 16 == 0
    N = n_out
    S = N // SEG
    L = B * S

    lit_lut = jax.vmap(_lit_lut_block)(lit_lens).reshape(-1)
    dist_lut = jax.vmap(_dist_lut_block)(dist_lens).reshape(-1)

    c4 = comps.reshape(B * CAP // 4, 4).astype(jnp.uint32)
    comp32 = c4[:, 0] | (c4[:, 1] << 8) | (c4[:, 2] << 16) | (c4[:, 3] << 24)
    # overlapping 12-word row view: row r covers words 4r .. 4r+11, so a
    # bit offset anywhere in row r's first 128 bits has >= 256 lookahead
    # bits — one row gather per step serves up to K tokens.
    A = comp32.reshape(-1, 4)
    A1 = jnp.concatenate([A[1:], jnp.zeros((1, 4), jnp.uint32)])
    A2 = jnp.concatenate([A[2:], jnp.zeros((2, 4), jnp.uint32)])
    comp12 = jnp.concatenate([A, A1, A2], axis=1)  # (B*CAP/16, 12)

    lane = jnp.arange(L, dtype=jnp.int32)
    blk = lane // S
    seg = lane % S
    seg_flat = seg_bits.reshape(L).astype(jnp.int32)
    ov = (seg_flat >> 24) & 0xFF
    bit0 = seg_flat & 0xFFFFFF
    ov_next = jnp.where(
        seg + 1 < S,
        (jnp.concatenate([seg_flat[1:], jnp.zeros(1, jnp.int32)]) >> 24) & 0xFF,
        0,
    )
    target = jnp.clip(
        jnp.minimum((seg + 1) * SEG + ov_next, ns[blk]) - seg * SEG,
        0, SEG + 255,
    )
    word_base = blk * (CAP // 4)
    lut_base = blk * LUT

    def step(carry):
        t, bit, outp, t_rec, bad = carry
        gword = word_base + (bit >> 5)
        row = gword >> 2
        w = jnp.take(comp12, row, axis=0)                 # (L, 12)
        ph = ((bit & 31) + ((gword & 3) << 5)).astype(jnp.int32)  # 0..127
        active = outp < target
        recs = []
        for _ in range(K):
            # ph <= 319 keeps the whole 48-bit worst-case token inside the
            # 384-bit row window AND the mux range (q+2 <= 11); >= 5
            # worst-case tokens fit per step from any start phase <= 127.
            fits = ph <= 319
            live = active & fits
            q = ph >> 5
            sh = (ph & 31).astype(jnp.uint32)
            w0 = _mux12(w, q)
            w1 = _mux12(w, q + 1)
            w2 = _mux12(w, q + 2)
            nz = sh > 0
            inv = (jnp.uint32(32) - sh) & jnp.uint32(31)
            lo = (w0 >> sh) | jnp.where(nz, w1 << inv, jnp.uint32(0))
            hi = (w1 >> sh) | jnp.where(nz, w2 << inv, jnp.uint32(0))

            a = lit_lut[lut_base + (lo & (LUT - 1)).astype(jnp.int32)]
            kind = a & 3
            clen = (a >> 2) & 15
            lxb = (a >> 6) & 7
            arg = (a >> 9) & 0xFF
            is_lit = live & (kind == 0)
            is_m = live & (kind == 1)
            bad = bad | (live & (kind >= 2))   # EOB here is a framing error
            lextra = ((lo >> clen.astype(jnp.uint32)).astype(jnp.int32)
                      & ((1 << lxb) - 1))
            mlen = 3 + arg + lextra
            dsh = (clen + lxb).astype(jnp.uint32)          # <= 17
            wB = (lo >> dsh) | jnp.where(
                dsh > 0, hi << ((jnp.uint32(32) - dsh) & jnp.uint32(31)),
                jnp.uint32(0))
            d = dist_lut[lut_base + (wB & (LUT - 1)).astype(jnp.int32)]
            dvalid = d & 1
            dlen = (d >> 1) & 15
            dxb = (d >> 5) & 15
            dist = 1 + ((d >> 9) & 0x7FFF) + (
                (wB >> dlen.astype(jnp.uint32)).astype(jnp.int32)
                & ((1 << dxb) - 1))
            bad = bad | (is_m & (dvalid == 0))

            adv = jnp.where(is_lit, clen,
                            jnp.where(is_m, clen + lxb + dlen + dxb, 0))
            outlen = jnp.where(is_lit, 1, jnp.where(is_m, mlen, 0))
            emit = is_lit | is_m
            payload = jnp.where(is_lit, arg, dist - 1)
            recs.append(
                jnp.where(emit, outp, 511).astype(jnp.uint32)
                | (is_lit.astype(jnp.uint32) << 9)
                | (payload.astype(jnp.uint32) << 10)
            )
            ph = ph + adv
            bit = bit + adv
            outp = outp + outlen
            active = active & (outp < target)
        t_rec = jax.lax.dynamic_update_slice(
            t_rec, jnp.stack(recs), (t * K, 0))
        return (t + 1, bit, outp, t_rec, bad)

    def not_done(carry):
        t, bit, outp, t_rec, bad = carry
        return (t < RSTEPS) & jnp.any(outp < target)

    init = (
        jnp.int32(0),
        bit0,
        jnp.minimum(ov, target),
        jnp.full((R, L), 511, jnp.uint32),
        jnp.zeros(L, dtype=bool),
    )
    _, bit, outp, t_rec, bad = jax.lax.while_loop(not_done, step, init)
    t_rec = t_rec.T
    ok = jnp.all(outp == target) & jnp.logical_not(jnp.any(bad))
    return _expand_and_resolve(t_rec, lane, ns, ok, B=B, N=N, S=S, R=R)
