"""Indexed-parallel device inflate for DYNAMIC-Huffman blocks.

Extends kernels/inflate_jax.py (fixed-tree scan) to blocks with arbitrary
per-block code tables — the v3 encoder's output, or any indexed deflate
block whose header the host has parsed. Token lookups use canonical-decode
arithmetic instead of a fixed LUT:

* the host (or the encoder) supplies per-block lit/dist CODE LENGTHS — a
  tiny (B, 316) u8 side table, ~20 KB for a 64-block batch;
* a vmapped device prep turns lengths into canonical (count, first, base,
  symlist) tables (RFC1951 §3.2.2) — dense ops over 286/30 entries;
* the scan decodes one token per lane per step: reverse the 15-bit window,
  find the unique length class whose range contains the prefix (15 dense
  compares), gather the symbol from the sorted symbol list, then fetch a
  second window for the distance code (a dynamic lit+dist token can be up
  to 15+5+15+13 = 48 bits, so one 32-bit window no longer covers both).

Phases 2-3 (expansion + pointer-doubling resolution) are shared with the
fixed scan (_expand_and_resolve).

Reference parity: the dynamic-block decode capability of inflate
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

MAXB = 15  # RFC1951 max code length


def _rev15(x: jnp.ndarray) -> jnp.ndarray:
    r = jnp.zeros_like(x)
    for i in range(MAXB):
        r = r | (((x >> i) & 1) << (MAXB - 1 - i))
    return r


def _canon_tables(lengths: jnp.ndarray, A: int):
    """Canonical decode tables from code lengths (single block; vmapped).
    Returns (count[15], first[15], base[15], symlist[A])."""
    l1h = (lengths[:, None] == jnp.arange(1, MAXB + 1)[None, :])
    count = jnp.sum(l1h.astype(jnp.int32), axis=0)

    def scan_fn(carry, cnt):
        code = (carry + cnt) << 1
        return code, code

    _, first = jax.lax.scan(
        scan_fn, jnp.int32(0),
        jnp.concatenate([jnp.zeros(1, jnp.int32), count[:-1]]),
    )
    base = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(count)[:-1]])
    key = jnp.where(lengths > 0, lengths, 99) * (2 * A) + jnp.arange(A)
    symlist = jnp.argsort(key).astype(jnp.int32)
    return count, first, base, symlist


# Length/dist symbol attribute constants (RFC1951 §3.2.5).
_LBASE = jnp.asarray(np.concatenate([consts.LENGTH_BASE, [0, 0]]).astype(np.int32))
_LXB = jnp.asarray(np.concatenate([consts.LENGTH_EXTRA, [0, 0]]).astype(np.int32))
_DBASE = jnp.asarray(np.concatenate([consts.DIST_BASE, [1, 1]]).astype(np.int32))
_DXB = jnp.asarray(np.concatenate([consts.DIST_EXTRA, [0, 0]]).astype(np.int32))


def _decode_sym(w, blk, count, first, base, symlist, A):
    """Canonical decode of one symbol per lane from 32-bit windows ``w``.
    count/first/base: (B, 15); symlist: (B, A). Returns (sym, len)."""
    v15 = _rev15((w & jnp.uint32(0x7FFF)).astype(jnp.int32))
    # candidate code value per length l: the top l bits of v15
    ls = jnp.arange(1, MAXB + 1)
    cand = v15[:, None] >> (MAXB - ls)[None, :]            # (L, 15)
    cnt = count[blk]                                        # (L, 15)
    fst = first[blk]
    ok = (cand >= fst) & (cand < fst + cnt)
    # canonical prefix property: exactly one length matches a valid stream
    l_idx = jnp.argmax(ok, axis=1)                          # first True
    any_ok = jnp.any(ok, axis=1)
    rows = jnp.arange(cand.shape[0])
    off = base[blk][rows, l_idx] + cand[rows, l_idx] - fst[rows, l_idx]
    sym = symlist[blk, jnp.clip(off, 0, A - 1)]
    clen = (l_idx + 1).astype(jnp.int32)
    return jnp.where(any_ok, sym, -1), jnp.where(any_ok, clen, 1)


@functools.partial(jax.jit, static_argnames=("n_out",))
def decode_blocks_indexed_dyn(comps: jnp.ndarray, seg_bits: jnp.ndarray,
                              ns: jnp.ndarray, lit_lens: jnp.ndarray,
                              dist_lens: jnp.ndarray, *, n_out: int):
    """Decode a batch of indexed deflate blocks with per-block code tables.

    Args:
      comps: uint8[B, CAP] compressed bytes per block (>= 12 zero pad).
      seg_bits: int32[B, S] per-segment bit offsets (from the block start).
      ns: int32[B] decoded length per block.
      lit_lens: int32[B, 288] lit/len code lengths (fixed-tree lengths for
        btype=01 blocks — the canonical machinery is uniform).
      dist_lens: int32[B, 30] distance code lengths.
      n_out: padded block size (static).

    Returns (out u8[B*n_out], ok i32[1]).
    """
    B, CAP = comps.shape
    assert CAP % 4 == 0
    N = n_out
    S = N // SEG
    L = B * S

    lc, lf, lb, lsyms = jax.vmap(lambda l: _canon_tables(l, 288))(lit_lens)
    dc, df, db_, dsyms = jax.vmap(lambda l: _canon_tables(l, 30))(dist_lens)

    c4 = comps.reshape(B * CAP // 4, 4).astype(jnp.uint32)
    comp32 = c4[:, 0] | (c4[:, 1] << 8) | (c4[:, 2] << 16) | (c4[:, 3] << 24)
    lane = jnp.arange(L, dtype=jnp.int32)
    blk = lane // S
    seg = lane % S
    # seg_bits packs the first-token bit offset (bits 0..23) and the
    # previous segment's merged-match output overflow (bits 24..31).
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
    bit_base = blk * (CAP * 8)

    def window(bit):
        gbit = bit_base + bit
        q = gbit >> 5
        sh = (gbit & 31).astype(jnp.uint32)
        lo = comp32[q]
        hi = comp32[q + 1]
        return (lo >> sh) | jnp.where(
            sh == 0, jnp.uint32(0),
            hi << ((jnp.uint32(32) - sh) & jnp.uint32(31)),
        )

    def step(carry):
        t, bit, outp, t_rec, bad = carry
        active = outp < target
        w = window(bit)
        sym, clen = _decode_sym(w, blk, lc, lf, lb, lsyms, 288)
        is_lit = active & (sym >= 0) & (sym < 256)
        is_eob = active & (sym == 256)
        is_match = active & (sym > 256) & (sym < 286)
        bad = bad | (active & (sym >= 286))
        bad = bad | (active & (sym < 0)) | is_eob
        code = jnp.clip(sym - 257, 0, 30)
        lxb = _LXB[code]
        # second window for the distance code (token may exceed 32 bits)
        bit_d = bit + clen + lxb
        wd = window(jnp.where(is_match, bit_d, bit))
        dsym, dlen = _decode_sym(wd, blk, dc, df, db_, dsyms, 30)
        bad = bad | (is_match & ((dsym < 0) | (dsym >= 30)))
        dsym = jnp.clip(dsym, 0, 29)
        dxb = _DXB[dsym]
        dist = _DBASE[dsym] + (((wd >> dlen.astype(jnp.uint32)).astype(jnp.int32))
                               & ((1 << dxb) - 1))
        # match length (needed only for output position accounting)
        lextra = ((w >> clen.astype(jnp.uint32)).astype(jnp.int32)) & ((1 << lxb) - 1)
        mlen = _LBASE[code] + lextra

        advance = jnp.where(is_lit, clen,
                            jnp.where(is_match, clen + lxb + dlen + dxb, 0))
        outlen = jnp.where(is_lit, 1, jnp.where(is_match, mlen, 0))
        # record: start (9b, 511 = inactive) | is_lit (1b) | payload (15b)
        payload = jnp.where(is_lit, jnp.clip(sym, 0, 255),
                            jnp.maximum(dist, 1) - 1)
        rec = (
            jnp.where(active, outp, 511).astype(jnp.uint32)
            | (is_lit.astype(jnp.uint32) << 9)
            | (payload.astype(jnp.uint32) << 10)
        )
        t_rec = jax.lax.dynamic_update_slice(t_rec, rec[None, :], (t, 0))
        return (t + 1, bit + advance, outp + outlen, t_rec, bad)

    def not_done(carry):
        t, bit, outp, t_rec, bad = carry
        return (t < SEG) & jnp.any(outp < target)

    init = (
        jnp.int32(0),
        bit0,
        # inert lanes (stored blocks flagged -1, padding) unpack garbage
        # ov; clamping to target keeps them inert AND keeps the exact
        # outp==target integrity check true for them.
        jnp.minimum(ov, target),
        jnp.full((SEG, L), 511, jnp.uint32),
        jnp.zeros(L, dtype=bool),
    )
    _, bit, outp, t_rec, bad = jax.lax.while_loop(not_done, step, init)
    t_rec = t_rec.T
    ok = jnp.all(outp == target) & jnp.logical_not(jnp.any(bad))
    return _expand_and_resolve(t_rec, lane, ns, ok, B=B, N=N, S=S)


# ---------------------------------------------------------------------------
# Host-side header parsing (per block, tiny)
# ---------------------------------------------------------------------------

def parse_block_tables(blob: bytes):
    """Parse ONE deflate block header from the start of ``blob``.

    Returns (kind, lit_lens[288], dist_lens[30], header_bits):
    288 includes the two phantom fixed-tree symbols (286, 287): they are
    never emitted, but their 8-bit lengths shift the canonical numbering
    of every 9-bit code — truncating them decoded all 9-bit literals +4
    (found on high-byte-value corpora).
    kind 0 = stored (tables empty), 1 = fixed, 2 = dynamic. Mirrors the
    host inflate's header parse (formats/deflate/inflate.py:196-274) but
    stateless, for the indexed device-decode driver."""
    from ..ops.bitio import BitReader
    from ..ops.huffman import build_decode_table

    r = BitReader(bytearray(blob), 0)
    r.read(1)  # bfinal (blocks in a parallel stream are never final)
    btype = r.read(2)
    lit = np.zeros(288, dtype=np.int32)
    dist = np.zeros(30, dtype=np.int32)
    if btype == 0:
        return 0, lit, dist, 0
    if btype == 1:
        lit[:288] = np.asarray(
            [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8, dtype=np.int32
        )
        dist[:] = 5
        return 1, lit, dist, 3
    hlit = r.read(5) + 257
    hdist = r.read(5) + 1
    hclen = r.read(4) + 4
    clen_lengths = np.zeros(19, dtype=np.int64)
    for i in range(hclen):
        clen_lengths[consts.CLEN_ORDER[i]] = r.read(3)
    cl_syms, cl_lens = build_decode_table(clen_lengths, 7)
    lengths = np.zeros(hlit + hdist, dtype=np.int64)
    i = 0
    while i < hlit + hdist:
        idx = r.peek(7)
        l = int(cl_lens[idx])
        sym = int(cl_syms[idx])
        r.skip(l)
        if sym < 16:
            lengths[i] = sym
            i += 1
        elif sym == 16:
            rep = 3 + r.read(2)
            lengths[i : i + rep] = lengths[i - 1]
            i += rep
        elif sym == 17:
            i += 3 + r.read(3)
        else:
            i += 11 + r.read(7)
    lit[:hlit] = lengths[:hlit]
    dist[: max(hdist, 0)] = lengths[hlit : hlit + hdist]
    return 2, lit, dist, r.bitpos
