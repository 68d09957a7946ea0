"""Indexed-parallel device inflate for self-produced streams.

The v2 encoder's parse restarts at every SEG-byte output segment, so each
segment's first token begins at a known bit offset (exported via
``with_index``). Decode then runs one vector lane per segment in lockstep:

* phase 1 — token scan: every active lane decodes one token per step
  (a 32-bit funnel-shift window from two u32 gathers serves both the
  lit/len and dist lookups — a full match token is exactly <= 32 bits;
  symbol attributes come from 512/32-entry tables), recording
  (start, kind, byte, len, dist) token rows; the loop exits as soon as
  every lane finished its segment;
* expansion — per-position token ids by boundary scatter + row cumsum;
  each position's copy source becomes a single absolute position
  ``src = match_start - dist + (rel mod dist)`` (the mod folds overlapping
  RLE copies, so chains shrink by at least one token per hop);
* phase 2 — back-reference resolution by pointer doubling over the flat
  block (log2(N) gathers reach any chain depth);
* final byte gather from literal roots.

This decodes OUR block-parallel streams (RFC-compliant fixed-Huffman
deflate with the side index); foreign streams use the host compatibility
decoder (formats/deflate/inflate.py).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..formats.deflate import consts
from ..ops.huffman import build_decode_table
from .deflate_jax_v2 import SEG


def _lit_attr_table() -> np.ndarray:
    """(512, 5) f32: [kind, byte, code_len, len_base, len_extra_bits] per
    9-bit LSB window. kind: 0 literal, 1 match, 2 EOB/invalid."""
    syms, lens = build_decode_table(consts.FIXED_LITLEN_LENGTHS, 9)
    table = np.zeros((512, 5), dtype=np.float32)
    for i in range(512):
        sym = int(syms[i])
        clen = int(lens[i])
        if clen == 0 or sym >= 286:
            table[i] = [2, 0, 1, 0, 0]
        elif sym < 256:
            table[i] = [0, sym, clen, 0, 0]
        elif sym == 256:
            table[i] = [2, 0, clen, 0, 0]
        else:
            code = sym - 257
            table[i] = [
                1, 0, clen,
                float(consts.LENGTH_BASE[code]),
                float(consts.LENGTH_EXTRA[code]),
            ]
    return table


def _dist_attr_table() -> np.ndarray:
    """(32, 3) f32: [dist_base, dist_extra_bits, valid]."""
    syms, lens = build_decode_table(consts.FIXED_DIST_LENGTHS, 5)
    table = np.zeros((32, 3), dtype=np.float32)
    for i in range(32):
        sym = int(syms[i])
        if int(lens[i]) == 0 or sym >= 30:
            table[i] = [1, 0, 0]
        else:
            table[i] = [float(consts.DIST_BASE[sym]), float(consts.DIST_EXTRA[sym]), 1]
    return table


_LIT_ATTRS = _lit_attr_table()
_DIST_ATTRS = _dist_attr_table()


def _onehot_lookup(idx: jnp.ndarray, table: jnp.ndarray) -> jnp.ndarray:
    """(S,) indices -> (S, A) attribute rows. At lane counts (~2k) a plain
    gather beats one-hot construction cost; swap to the one-hot matmul form
    if lane counts grow to where gathers dominate."""
    return table[idx]


@functools.partial(jax.jit, static_argnames=("n_out",))
def decode_blocks_indexed(comps: jnp.ndarray, seg_bits: jnp.ndarray, ns: jnp.ndarray,
                          *, n_out: int):
    """Decode a BATCH of v2 blocks in one kernel (amortizes per-op dispatch
    overhead across B*S lanes).

    Args:
      comps: uint8[B, CAP] compressed bytes per block (>= 8 zero pad each).
      seg_bits: int32[B, S] per-segment bit offsets.
      ns: int32[B] decoded length per block (<= n_out).
      n_out: padded block size (static).

    Returns (out u8[B*n_out], ok i32[1]).
    """
    B, CAP = comps.shape
    assert CAP % 4 == 0, "compressed capacity must be u32-aligned"
    N = n_out
    S = N // SEG
    L = B * S
    lit_t = jnp.asarray(_LIT_ATTRS)
    dist_t = jnp.asarray(_DIST_ATTRS)
    # u32 view of the bitstream (LSB-first bits, little-endian bytes), so a
    # token window is ONE funnel shift from two word gathers. A full match
    # token is at most 9+5+5+13 = 32 bits, so one 32-bit window serves both
    # the lit/len and the dist lookups of a step.
    c4 = comps.reshape(B * CAP // 4, 4).astype(jnp.uint32)
    comp32 = c4[:, 0] | (c4[:, 1] << 8) | (c4[:, 2] << 16) | (c4[:, 3] << 24)
    lane = jnp.arange(L, dtype=jnp.int32)
    blk = lane // S
    seg = lane % S
    # seg_bits packs the segment's first-token bit offset (bits 0..23) and
    # the output overflow of the previous segment's merged cross-boundary
    # match (bits 24..31) — see deflate_jax_v2.cover_overflow.
    seg_flat = seg_bits.reshape(L).astype(jnp.int32)
    ov = (seg_flat >> 24) & 0xFF
    bit0 = seg_flat & 0xFFFFFF
    ov_next = jnp.where(
        seg + 1 < S,
        (jnp.concatenate([seg_flat[1:], jnp.zeros(1, jnp.int32)]) >> 24) & 0xFF,
        0,
    )
    # lane output: [seg*SEG + ov, min((seg+1)*SEG + ov_next, ns)), tracked
    # relative to seg*SEG (so outp and token starts fit 9 bits: <= 383;
    # a fully-overflowed segment has ov >= target and its lane is inert).
    target = jnp.clip(
        jnp.minimum((seg + 1) * SEG + ov_next, ns[blk]) - seg * SEG,
        0, SEG + 255,
    )
    bit_base = blk * (CAP * 8)

    def step(carry):
        t, bit, outp, t_rec, bad = carry
        active = outp < target
        gbit = bit_base + bit
        q = gbit >> 5
        sh = (gbit & 31).astype(jnp.uint32)
        lo = comp32[q]
        hi = comp32[q + 1]
        w = (lo >> sh) | jnp.where(sh == 0, jnp.uint32(0),
                                   hi << ((jnp.uint32(32) - sh) & jnp.uint32(31)))
        idx9 = (w & 511).astype(jnp.int32)
        a = _onehot_lookup(idx9, lit_t)
        kind = a[:, 0].astype(jnp.int32)
        byte = a[:, 1].astype(jnp.int32)
        clen = a[:, 2].astype(jnp.int32)
        lbase = a[:, 3].astype(jnp.int32)
        lxb = a[:, 4].astype(jnp.int32)
        lextra = ((w >> clen.astype(jnp.uint32)).astype(jnp.int32)) & ((1 << lxb) - 1)
        mlen = lbase + lextra
        used = clen + lxb
        wd = w >> used.astype(jnp.uint32)
        idx5 = (wd & 31).astype(jnp.int32)
        d = _onehot_lookup(idx5, dist_t)
        dbase = d[:, 0].astype(jnp.int32)
        dxb = d[:, 1].astype(jnp.int32)
        dvalid = d[:, 2].astype(jnp.int32)
        dist = dbase + (((wd >> 5).astype(jnp.int32)) & ((1 << dxb) - 1))
        dbits = 5 + dxb

        is_lit = active & (kind == 0)
        is_match = active & (kind == 1)
        bad = bad | (active & (kind == 2)) | (is_match & (dvalid == 0))
        advance = jnp.where(is_lit, clen, jnp.where(is_match, used + dbits, 0))
        outlen = jnp.where(is_lit, 1, jnp.where(is_match, mlen, 0))

        # ONE packed u32 record per token — start (9b, 511 = inactive) |
        # is_lit (1b) | payload (lit byte / dist-1, 15b) — so expansion
        # needs a single gather. Records live as (SEG, L): writing step t
        # is one contiguous ROW update (minor-axis column updates force
        # strided copies).
        payload = jnp.where(is_lit, byte, jnp.maximum(dist, 1) - 1)
        rec = (
            jnp.where(active, outp, 511).astype(jnp.uint32)
            | (is_lit.astype(jnp.uint32) << 9)
            | (payload.astype(jnp.uint32) << 10)
        )
        t_rec = jax.lax.dynamic_update_slice(t_rec, rec[None, :], (t, 0))
        return (t + 1, bit + advance, outp + outlen, t_rec, bad)

    def not_done(carry):
        t, bit, outp, t_rec, bad = carry
        # Stop as soon as every lane has produced its segment (token counts
        # per segment are data-dependent; all-literal segments need SEG
        # steps, compressible ones far fewer).
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
    t_rec = t_rec.T  # lane-major for the expansion phase
    ok = jnp.all(outp == target) & jnp.logical_not(jnp.any(bad))
    return _expand_and_resolve(t_rec, lane, ns, ok, B=B, N=N, S=S)


def rel_mod(rel: jnp.ndarray, dist: jnp.ndarray) -> jnp.ndarray:
    """Offset of output position ``rel`` (from its token's start) inside
    the token's repeating source window of period ``dist`` (>= 1): integer
    floor-mod, so the result lies in [0, dist) for any sign of ``rel``."""
    return jnp.remainder(rel, dist)


def _expand_and_resolve(t_rec, lane, ns, ok, *, B, N, S, R=SEG):
    """Shared phases 2+3 of indexed decode: token-id expansion (slot
    scatter + running max), then pointer-doubling back-reference
    resolution. ``t_rec`` is (L, R) packed token records from a scan
    phase (R record slots per lane): start-in-lane-frame (9b, 511 =
    inactive) | is_lit (1b) | payload (lit byte / dist-1, 15b). Merged
    matches cross segment boundaries, so a position's governing token may
    live in an earlier lane — the slot ids are globally monotone in flat
    start position (stream order), making cummax the expansion."""
    # --- expansion: per-position token id ------------------------------
    L = B * S
    NT = B * N
    t_start = (t_rec & jnp.uint32(0x1FF)).astype(jnp.int32)  # (L, R)
    lane_out_base = lane * SEG  # == flat output offset of the lane's segment
    flat_start = (lane_out_base[:, None] + t_start).reshape(-1)
    valid_tok = t_start.reshape(-1) < 511
    slot = jnp.arange(L * R, dtype=jnp.int32) + 1  # row-major (lane, t)
    # Valid token starts are unique output positions; INACTIVE slots are
    # the bulk of the record array (R is sized for the worst case) — give
    # them out-of-range addresses so the scatter drops them instead of
    # serializing millions of updates onto one guard cell, and the rest
    # can use the unique-indices lowering.
    addr = jnp.where(valid_tok, flat_start, NT + SEG + 512)
    slot_at = jnp.zeros(NT + SEG + 512, jnp.int32).at[addr].max(
        slot, mode="drop", unique_indices=True)[:NT]
    tokid_flat = jnp.clip(jax.lax.cummax(slot_at) - 1, 0, L * R - 1)

    rec_of = t_rec.reshape(-1)[tokid_flat]  # the ONE expansion gather
    is_lit_pos = ((rec_of >> 9) & jnp.uint32(1)) > 0
    payload_of = ((rec_of >> 10) & jnp.uint32(0x7FFF)).astype(jnp.int32)
    pack_of = jnp.where(is_lit_pos, payload_of + 1, 0)  # byte+1, 0 = match
    dist_of = payload_of + 1

    gp = jnp.arange(NT, dtype=jnp.int32)
    # A token's global start = its lane's base + the recorded lane-frame
    # start (tokens CAN cross segment boundaries after merging; the lane
    # comes from the slot id, not from the position).
    start_of = ((tokid_flat // R) * SEG
                + (rec_of & jnp.uint32(0x1FF)).astype(jnp.int32))
    relmod = rel_mod(gp - start_of, dist_of)
    # Signed roots: resolved positions carry -(byte+1); unresolved carry a
    # source position. Doubling then needs exactly one gather per round and
    # the final bytes fall out with no extra gather.
    src = start_of - dist_of + relmod
    root = jnp.where(is_lit_pos, -pack_of, jnp.clip(src, 0, NT - 1))

    # --- phase 2: pointer doubling to literal roots --------------------
    # Literals are fixpoints (negative), so composing the source map with
    # itself reaches every chain's root; exits as soon as all valid
    # positions are resolved (typical depth is small).
    valid = (gp % N) < ns[gp // N]
    max_iters = max(1, int(np.ceil(np.log2(max(NT, 2)))))

    KSUB = max(SEG, NT // 8)

    def not_done(carry):
        root, unresolved, it = carry
        return (unresolved > KSUB) & (it < max_iters)

    def advance(carry):
        root, _, it = carry
        # Two hops per round, and the continue-count is computed here so the
        # loop condition is a scalar read, not another 4M-element pass.
        hop = root[jnp.maximum(root, 0)]
        root = jnp.where(root >= 0, hop, root)
        hop = root[jnp.maximum(root, 0)]
        root = jnp.where(root >= 0, hop, root)
        return root, jnp.sum(((root >= 0) & valid).astype(jnp.int32)), it + 1

    # Full-map doubling only until the unresolved set fits the compaction
    # budget (typically immediately: most matches point straight into a
    # literal run), then doubling continues on the compacted subset —
    # gathers/scatters of NT/8 instead of NT per round.
    unres0 = jnp.sum(((root >= 0) & valid).astype(jnp.int32))
    root, _, _ = jax.lax.while_loop(
        not_done, advance, (root, unres0, jnp.int32(0))
    )
    # Compact the unresolved set (the loop above guaranteed the count fits
    # KSUB). nonzero(size=) lowers to cumsum + scatter — a 4M-element
    # argsort here would sort the whole map.
    # Padding slots repeat index 0, so they must be inert: mask them to -1
    # in `sub` and scatter with mode="drop" via an out-of-range index.
    unres_mask = (root >= 0) & valid
    count = jnp.sum(unres_mask.astype(jnp.int32))
    (cand0,) = jnp.nonzero(unres_mask, size=KSUB, fill_value=0)
    slot_live = jnp.arange(KSUB, dtype=jnp.int32) < count
    cand = jnp.where(slot_live, cand0, NT)  # NT = out of range -> dropped
    sub = jnp.where(slot_live, root[cand0], -1)

    def sub_not_done(carry):
        sub, root, unresolved, it = carry
        return unresolved & (it < max_iters)

    def sub_advance(carry):
        sub, root, _, it = carry
        hop = root[jnp.maximum(sub, 0)]
        sub = jnp.where(sub >= 0, hop, sub)
        root = root.at[cand].set(sub, mode="drop")
        return sub, root, jnp.any(sub >= 0), it + 1

    sub, root, _, _ = jax.lax.while_loop(
        sub_not_done, sub_advance, (sub, root, jnp.any(sub >= 0), jnp.int32(0))
    )

    out = (jnp.where(root < 0, -root, 1) - 1).astype(jnp.uint8)
    ok = ok & jnp.all(jnp.where(valid, root < 0, True))
    return out, jnp.where(ok, 1, 0).astype(jnp.int32).reshape(1)


@functools.partial(jax.jit, static_argnames=("n_out",))
def decode_block_indexed(comp: jnp.ndarray, seg_bits: jnp.ndarray, n: jnp.ndarray,
                         *, n_out: int):
    """Single-block wrapper over :func:`decode_blocks_indexed`."""
    return decode_blocks_indexed(
        comp[None, :], seg_bits[None, :], n.reshape(1), n_out=n_out
    )
