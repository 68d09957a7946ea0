"""Jittable DEFLATE block encoder, v2 — the gather-minimal formulation.

v1 (deflate_jax.py) is algorithmically faithful to the host pipeline but
gather-bound: the chain walk, match measurement and pointer doubling issue
hundreds of random-index gathers per position. v2 restructures every hot
stage into dense, gather-free forms:

1. *Sort-carried windows*: `lax.sort` with payload operands carries each
   position's WCAP-byte window THROUGH the sort network, so candidate
   generation needs no gathers at all — sorted-order neighbors (depth d =
   rolled arrays) are the hash-chain candidates, and match lengths are
   dense u32 XOR/ctz compares, capped at WCAP bytes.
2. *Run extension*: distance-1 runs (the long-match case that matters)
   are recovered with log-doubling on dense ops, capped at 255.
3. *Sort-back*: results return to position order by a second payload sort
   (cheaper than scatter).
4. *Matmul segment parse*: greedy-cover pointer doubling becomes batched
   0/1 matrix squaring over 128-byte segments (one-hot jump matrices are
   function matrices — exact in bf16; reach vectors accumulate in f32 and
   clamp). Matches clip at segment ends.
5. Fixed-Huffman field mapping in closed form; bit packing is
   scatter-free: fields drop into segment-local byte rows via a one-hot
   einsum (bit-disjoint contributions keep float sums exact), rows shift
   to their global bit phase and land with sequential interior writes —
   only segment-boundary bytes + header + EOB use one tiny scatter-add.

Output format is identical to v1: an RFC1951 raw-deflate byte run ending
with an empty stored block (sync flush), byte-aligned, window ≤ block.
"""

from __future__ import annotations

import functools
import os

import numpy as np

import jax
import jax.numpy as jnp

from ..formats.deflate import consts
from .deflate_jax import (
    _FIXED_LIT_LEN,
    _FIXED_LIT_REV,
    ADLER_MOD,
)
from .lcp_match import lcp_candidates_xla

SEG = 128          # segment granularity for indexed (segment-parallel) blocks
WCAP = 32          # default bytes measured per hash-chain candidate


def _u32_words(data: jnp.ndarray, k: int) -> jnp.ndarray:
    """w[i] = little-endian 4 bytes at i+4k (dense rolls, no gathers)."""
    u = data.astype(jnp.uint32)
    return (
        jnp.roll(u, -(4 * k))
        | (jnp.roll(u, -(4 * k + 1)) << 8)
        | (jnp.roll(u, -(4 * k + 2)) << 16)
        | (jnp.roll(u, -(4 * k + 3)) << 24)
    )


def _ctz_bytes(x: jnp.ndarray) -> jnp.ndarray:
    """Matching byte count from a u32 XOR (0..4)."""
    low = x & (jnp.uint32(0) - x)
    cnt = (jax.lax.population_count(low - jnp.uint32(1)) >> 3).astype(jnp.int32)
    return jnp.where(x == 0, jnp.int32(4), cnt)


def _rev9(x: jnp.ndarray) -> jnp.ndarray:
    """Reverse the low 9 bits of an i32 array (dense butterfly)."""
    x = x.astype(jnp.int32)
    r = jnp.zeros_like(x)
    for i in range(9):
        r = r | (((x >> i) & 1) << (8 - i))
    return r


def _rev(x: jnp.ndarray, bits: jnp.ndarray) -> jnp.ndarray:
    """Reverse ``x`` within ``bits`` (<=9) bits: rev9 then drop the pad."""
    return _rev9(x) >> (9 - bits)


def _fixed_fields(data, mlen, dclip, is_match_tok, is_lit):
    """Fixed-Huffman token fields in closed form — zero table gathers.

    DEFLATE's length/dist code tables are log2-structured (RFC1951 §3.2.5)
    and the fixed literal/length tree is four contiguous code ranges
    (§3.2.6), so symbol, code, base, and extra-bit arithmetic are a handful
    of dense compares/shifts instead of table gathers."""
    # --- length side: m = mlen-3; e = max(0, floor(log2 m) - 2) ----------
    m = mlen - consts.MIN_MATCH
    e_l = ((m >= 8).astype(jnp.int32) + (m >= 16) + (m >= 32)
           + (m >= 64) + (m >= 128))
    lsym = 257 + (e_l << 2) + (m >> e_l)
    lextra_val = (m & ((1 << e_l) - 1)).astype(jnp.uint32)
    # length 258 has its own zero-extra symbol 285
    is258 = mlen == consts.MAX_MATCH
    lsym = jnp.where(is258, 285, lsym)
    e_l = jnp.where(is258, 0, e_l)
    lextra_val = jnp.where(is258, jnp.uint32(0), lextra_val)
    # fixed tree: syms 256-279 -> 7-bit code sym-256; 280-287 -> 8-bit 0xC0+
    lcode_bits = jnp.where(lsym >= 280, 8, 7)
    lcode = jnp.where(lsym >= 280, 0xC0 + (lsym - 280), lsym - 256)
    lrev = _rev(lcode, lcode_bits)

    # --- dist side: ds = d-1; e = max(0, floor(log2 ds) - 1) -------------
    ds = dclip - 1
    e_d = (ds >= 4).astype(jnp.int32)
    for k in range(3, 15):
        e_d = e_d + (ds >= (1 << k))
    dsym = jnp.where(ds < 2, ds, 2 * (e_d + 1) + ((ds >> e_d) & 1))
    dextra_val = (ds & ((1 << e_d) - 1)).astype(jnp.uint32)
    drev = _rev(dsym, jnp.int32(5))  # all fixed dist codes are 5 bits

    # --- literal side: two ranges of the fixed tree -----------------------
    v = data.astype(jnp.int32)
    lit_bits = jnp.where(v >= 144, 9, 8)
    lit_code = jnp.where(v >= 144, 0x190 + (v - 144), 0x30 + v)
    lit_rev = _rev(lit_code, lit_bits)

    f0_val = jnp.where(
        is_match_tok,
        lrev.astype(jnp.uint32) | (lextra_val << lcode_bits.astype(jnp.uint32)),
        lit_rev.astype(jnp.uint32),
    )
    f0_bits = jnp.where(is_match_tok, lcode_bits + e_l,
                        jnp.where(is_lit, lit_bits, 0))
    f1_val = drev.astype(jnp.uint32) | (dextra_val << jnp.uint32(5))
    f1_bits = jnp.where(is_match_tok, 5 + e_d, 0)
    return f0_val, f0_bits, f1_val, f1_bits


def parse_cover_mxu(step_arr: jnp.ndarray, seg: int = SEG) -> jnp.ndarray:
    """Exact greedy token cover (segment-local) by one-hot matrix
    squaring. ``step_arr[i]`` is the greedy parser's advance at position
    i (match length or 1), already clipped so no step crosses a SEG
    boundary; the cover is the orbit of each segment start under
    f(i) = i + step[i] — the transitive closure of a one-hot jump matrix,
    7 batched 128^3 squarings per segment.

    Binary-lifting pointer doubling with native gathers computes the same
    cover (deflate_jax.py); which is faster on a given device is an open
    measurement. Records/spans covers (cummax + forward-fill) are cheaper
    but lose ~0.2x ratio: end-truncating an overlapped match turns the
    overlap into literal runs. Exact greedy re-anchors at the cover end,
    which is what the ratio needs (2.66x vs <=2.46x on the bench corpus
    at level 6).
    """
    N = step_arr.shape[0]
    pos = jnp.arange(N, dtype=jnp.int32)
    S = N // seg
    local = pos & (seg - 1)
    nxt_local = jnp.minimum(local + jnp.maximum(step_arr, 1), seg)
    nl = nxt_local.reshape(S, seg)
    cols = jnp.arange(seg, dtype=jnp.int32)
    jmat = (nl[:, :, None] == cols[None, None, :]).astype(jnp.bfloat16)
    reach = jnp.zeros((S, 1, seg), dtype=jnp.float32).at[:, 0, 0].set(1.0)
    iters = int(np.ceil(np.log2(seg)))
    for it in range(iters):
        hop = jnp.einsum(
            "sij,sjk->sik", reach.astype(jnp.bfloat16), jmat,
            preferred_element_type=jnp.float32,
        )
        reach = jnp.minimum(reach + hop, 1.0)
        if it + 1 < iters:  # the last squaring would be unused
            jmat = jnp.einsum(
                "sij,sjk->sik", jmat, jmat,
                preferred_element_type=jnp.bfloat16,
            )
    return (reach[:, 0, :] > 0.5).reshape(N)


def _sort_stage(data, n, *, wcap):
    """Per-block stage 1: 3-byte hash + sort-carried windows (vmappable).
    Returns the sort-order tuple (hs, ps, *windows)."""
    N = data.shape[0]
    pos_all = jnp.arange(N, dtype=jnp.int32)
    d0 = data.astype(jnp.uint32)
    v3 = d0 | (jnp.roll(d0, -1) << 8) | (jnp.roll(d0, -2) << 16)
    h = (v3 * jnp.uint32(2654435761)) >> jnp.uint32(16)
    h = jnp.where(pos_all < n - 2, h,
                  jnp.uint32(0x10000) + pos_all.astype(jnp.uint32))
    words = [_u32_words(data, k) for k in range(wcap // 4)]
    return jax.lax.sort((h, pos_all, *words), num_keys=1, is_stable=True)


def _candidates_xla(hs, ps, sw, *, depth, max_dist, wcap):
    """Roll/xor/ctz candidate loop over hash-sorted neighbours (the
    ``matcher="hash"`` path)."""
    N = hs.shape[0]
    pos_all = jnp.arange(N, dtype=jnp.int32)
    best_len_s = jnp.zeros(N, dtype=jnp.int32)
    best_dist_s = jnp.zeros(N, dtype=jnp.int32)
    for d in range(1, depth + 1):
        same = hs == jnp.roll(hs, d)
        same = same & (pos_all >= d)
        dist = ps - jnp.roll(ps, d)
        ok = same & (dist > 0) & (dist <= max_dist)
        l = _ctz_bytes(sw[0] ^ jnp.roll(sw[0], d))
        for k in range(1, wcap // 4):
            lk = _ctz_bytes(sw[k] ^ jnp.roll(sw[k], d))
            l = l + jnp.where(l == 4 * k, lk, 0)
        l = jnp.where(ok, l, 0)
        better = l > best_len_s
        best_len_s = jnp.where(better, l, best_len_s)
        best_dist_s = jnp.where(better, dist, best_dist_s)
    return best_len_s, best_dist_s


def _post_match(data, n, ps, best_len_s, best_dist_s, *, max_len, wcap,
                seg: int = SEG, stride: int = 1):
    """Per-block: sort-back + chain/run extension + heuristics
    (vmappable). Returns (step_arr, best_len, best_dist, in_range)."""
    N = data.shape[0]
    pos_all = jnp.arange(N, dtype=jnp.int32)
    in_range = pos_all < n

    # --- sort back to position order ------------------------------------
    # (len, dist) pack into one payload word (len <= wcap <= 32 -> 6 bits,
    # dist <= 32768 -> 16 bits): sort cost scales steeply with operand
    # count, so key+1 beats key+2. Keys are a permutation —
    # no stability needed.
    packed = best_len_s | (best_dist_s << 6)
    _, packed = jax.lax.sort((ps, packed), num_keys=1, is_stable=False)
    best_len = packed & 63
    best_dist = packed >> 6
    if stride == 2:
        # expand the even-anchor results to full resolution (odd
        # positions: no match candidate; dense interleave, no scatter)
        z = jnp.zeros_like(best_len)
        best_len = jnp.stack([best_len, z], axis=-1).reshape(N)
        best_dist = jnp.stack([best_dist, z], axis=-1).reshape(N)

    # --- chain extension: contiguous same-distance full-window matches
    # merge by log-doubling on dense rolls (a match that exhausted its
    # wcap-byte measurement window continues through the next position's
    # match when the distances agree).
    k = wcap
    while k < max_len:
        cond = ((best_len == k) & (jnp.roll(best_dist, -k) == best_dist)
                & (jnp.roll(best_len, -k) > 0) & (pos_all + k < N))
        best_len = jnp.where(
            cond, jnp.minimum(k + jnp.roll(best_len, -k), max_len), best_len)
        k *= 2

    # --- run extension: distance-1 matches via log-doubling ------------
    # (COMPU_RUN_EXT=0 disables for the decode-chain-depth experiments:
    # dist-1 runs are the deepest resolution chains of all)
    if os.environ.get("COMPU_RUN_EXT") != "0":
        e = (data == jnp.roll(data, -1)) & (pos_all < n - 1)
        run = e.astype(jnp.int32)
        step = 1
        while step < max_len:
            run = run + jnp.where(run == step, jnp.roll(run, -step), 0)
            step *= 2
        run = jnp.minimum(run, max_len)
        # match at i with dist 1 has length run[i-1]; express via roll.
        run_len = jnp.roll(run, 1).at[0].set(0)
        use_run = run_len > best_len
        best_len = jnp.where(use_run, run_len, best_len)
        best_dist = jnp.where(use_run, 1, best_dist)

    # --- heuristics ----------------------------------------------------
    limit = jnp.minimum(n - pos_all, jnp.int32(max_len))
    best_len = jnp.minimum(best_len, limit)
    # pre-seg-clip TRUE length (XOR/ctz-verified, never overstated) — the
    # boundary merge uses it to absorb the next segment's first token
    # even when that token's matcher chose a different distance.
    uncl_len = best_len
    # clip to segment end (the greedy cover is segment-local)
    seg_rem = seg - (pos_all & (seg - 1))
    best_len = jnp.minimum(best_len, seg_rem)
    best_len = jnp.where(in_range, best_len, 0)
    drop = (best_len == consts.MIN_MATCH) & (best_dist > 4096)
    best_len = jnp.where(drop, 0, best_len)
    nxt_len = jnp.concatenate([best_len[1:], jnp.zeros(1, jnp.int32)])
    best_len = jnp.where(nxt_len > best_len, 0, best_len)  # lazy demote
    take = best_len >= consts.MIN_MATCH
    step_arr = jnp.where(take, best_len, 1)
    return step_arr, best_len, best_dist, in_range, uncl_len


def _merge_seg_boundaries(is_tok, best_len, best_dist, n, uncl_len=None,
                          max_len: int = consts.MAX_MATCH, seg: int = SEG):
    """Post-cover merge of same-distance matches across SEG boundaries.

    The exact greedy cover clips every match at its segment end (a match
    that would cross gets length == seg_rem, i.e. it ends EXACTLY on the
    boundary), so long repeats degrade to 128-byte pieces — the largest
    itemized chunk of the ratio gap vs gzip -6 (VERDICT r2). This pass
    stitches a boundary-ending match to the next segment's first token
    when the distances agree and the sum fits the format cap:

    * boundary b is LINKED when segment b-1's last token ends exactly at
      b*SEG as a match, segment b's first token is a match with the same
      distance, and the combined length <= 258 (RFC1951 cap);
    * chains of linked boundaries (a long run covering whole segments)
      pair up greedily from the chain head — merge only boundaries at odd
      run positions, so 128+128 pieces become 256s without conflicting
      simultaneous updates;
    * the absorbing token's length grows; the absorbed token's start is
      cleared from the cover. Downstream consumers see output-coverage
      overflow into the next segment, exported to the indexed decoder as
      a per-segment ``ov`` (see cover_overflow).

    All dense (S,)-shaped ops — vmappable, single block. Returns updated
    (is_tok, best_len)."""
    N = is_tok.shape[0]
    S = N // seg
    pos = jnp.arange(N, dtype=jnp.int32)
    seg_rem = seg - (pos & (seg - 1))
    tl = jnp.where(is_tok, best_len, 0).reshape(S, seg)
    td = jnp.where(is_tok, best_dist, 0).reshape(S, seg)
    # segment b-1's boundary-ending match (unique per row: coverage is
    # disjoint and only the final token can end on the boundary)
    ends = (tl >= consts.MIN_MATCH) & (tl == seg_rem.reshape(S, seg))
    len_end = jnp.sum(jnp.where(ends, tl, 0), axis=1)
    dist_end = jnp.sum(jnp.where(ends, td, 0), axis=1)
    has_end = jnp.any(ends, axis=1)
    # segment b's first token (coverage 1 for a literal)
    first_tok = is_tok.reshape(S, seg)[:, 0]
    first_len = tl[:, 0]
    first_dist = td[:, 0]
    first_match = first_tok & (first_len >= consts.MIN_MATCH)
    first_cover = jnp.where(first_match, first_len,
                            jnp.where(first_tok, 1, 0))
    # two independent proofs the merge is byte-valid:
    # (a) q is a match at the SAME distance — its own verification extends
    #     p's;
    # (b) p's pre-clip length covers q's whole token — q's distance choice
    #     is then irrelevant (the absorb case; q is often a literal or a
    #     different-distance match when the matcher tie-broke elsewhere).
    same_dist = (first_match[1:] & (dist_end[:-1] == first_dist[1:])
                 & (len_end[:-1] + first_len[1:] <= max_len))
    if uncl_len is not None:
        un = jnp.where(is_tok, uncl_len, 0).reshape(S, seg)
        uncl_end = jnp.sum(jnp.where(ends, un, 0), axis=1)
        absorb = (first_tok[1:] & (first_cover[1:] > 0)
                  & (uncl_end[:-1] >= len_end[:-1] + first_cover[1:])
                  & (len_end[:-1] + first_cover[1:] <= max_len))
    else:
        absorb = jnp.zeros(S - 1, bool)
    linked = jnp.concatenate([
        jnp.zeros(1, bool),
        (has_end[:-1] & (same_dist | absorb)
         & (jnp.arange(1, S) * seg < n)),
    ])
    # run position within each chain of consecutive linked boundaries
    # (log-doubling run length ending at b); merge odd positions only so
    # pairs are disjoint: (t0,t1), (t2,t3), ...
    run = linked.astype(jnp.int32)
    step = 1
    while step < S:
        prev = jnp.concatenate([jnp.zeros(step, jnp.int32), run[:-step]])
        run = run + jnp.where(run == step, prev, 0)
        step *= 2
    merge = linked & ((run & 1) == 1)
    # apply: extend the absorbing token (row b-1), clear the absorbed one
    add = jnp.concatenate([jnp.where(merge[1:], first_cover[1:], 0),
                           jnp.zeros(1, jnp.int32)])  # per row b-1
    new_tl = jnp.where(ends & (add[:, None] > 0), tl + add[:, None], tl)
    best_len = jnp.where(is_tok, new_tl.reshape(N), best_len)
    drop_first = jnp.zeros((S, seg), bool).at[:, 0].set(merge)
    is_tok = is_tok & ~drop_first.reshape(N)
    return is_tok, best_len


def cover_overflow(is_tok, best_len):
    """Per-segment output-coverage overflow ``ov[s]`` (i32[S], 0..255):
    how far the last token starting before s*SEG runs into segment s
    (a merged match can overflow up to 255 bytes: a 258-byte match
    starting 3 bytes before the boundary — a segment can even be covered
    entirely, making its lane inert). 0 everywhere when no merged
    (cross-boundary) tokens exist. The indexed decoder starts lane s at
    output offset ov[s] and targets SEG + ov[s+1] - ov[s] bytes."""
    N = is_tok.shape[0]
    pos = jnp.arange(N, dtype=jnp.int32)
    end = jnp.where(is_tok, pos + jnp.maximum(best_len, 1), 0)
    reach = jax.lax.cummax(end)
    S = N // SEG
    # overflow into segment s = coverage reach just before s*SEG, minus s*SEG
    prev_reach = reach.reshape(S, SEG)[:, SEG - 1]  # reach at each seg end
    ov = jnp.concatenate([jnp.zeros(1, jnp.int32),
                          prev_reach[:-1] - jnp.arange(1, S) * SEG])
    return jnp.clip(ov, 0, 255)


def match_and_parse(data: jnp.ndarray, n: jnp.ndarray, *, depth: int = 8,
                    max_dist: int = consts.WINDOW_SIZE, max_len: int = consts.MAX_MATCH,
                    clip_seg: bool = True, wcap: int = WCAP,
                    matcher: str = "lex", cover_seg: int = SEG,
                    stride: int = 1, lex_keys: int = 2):
    """Shared device LZ stage (single block): sort-carried matching +
    chain/run extension + exact greedy cover. Returns (is_tok bool[N],
    best_len i32[N], best_dist i32[N]) — the token cover all three formats
    consume (DEFLATE directly on device; zstd/brotli through their host
    entropy stages). Batched callers use match_and_parse_batch.

    The exact greedy cover clips matches at SEG boundaries (it is
    segment-local — see parse_cover_mxu for why the alternatives lose),
    then _merge_seg_boundaries stitches same-distance matches back
    together across boundaries up to the 258 format cap, so the delivered
    cover is unclipped wherever the matcher found the continuation.
    Segment starts are token boundaries EXCEPT where a merged token
    overflows; the indexed decode path consumes the per-segment overflow
    (cover_overflow) alongside the bit offsets. ``clip_seg`` is accepted
    for call-site documentation; both values produce the merged cover."""
    N = data.shape[0]
    if matcher == "lex":
        from .lcp_match import sort_stage_lex

        sorted_ops = sort_stage_lex(data, n, wcap=wcap, stride=stride,
                                    keys=lex_keys)
        ps = sorted_ops[-1]
        with jax.named_scope("lcp_candidates"):
            best_len_s, best_dist_s = lcp_candidates_xla(
                sorted_ops, depth=depth, max_dist=max_dist,
                block_elems=N // stride)
    else:
        stride = 1
        sorted_ops = _sort_stage(data, n, wcap=wcap)
        hs, ps = sorted_ops[0], sorted_ops[1]
        sw = sorted_ops[2:]
        best_len_s, best_dist_s = _candidates_xla(
            hs, ps, sw, depth=depth, max_dist=max_dist, wcap=wcap
        )
    with jax.named_scope("post_match"):
        step_arr, best_len, best_dist, in_range, uncl = _post_match(
            data, n, ps, best_len_s, best_dist_s, max_len=max_len, wcap=wcap,
            seg=cover_seg, stride=stride,
        )
    with jax.named_scope("cover"):
        is_tok = parse_cover_mxu(step_arr, cover_seg) & in_range
        is_tok, best_len = _merge_seg_boundaries(
            is_tok, best_len, best_dist, n, uncl, max_len=max_len,
            seg=cover_seg)
    return is_tok, best_len, best_dist


def match_and_parse_batch(datas: jnp.ndarray, ns: jnp.ndarray, *,
                          depth: int = 8,
                          max_dist: int = consts.WINDOW_SIZE,
                          max_len: int = consts.MAX_MATCH,
                          clip_seg: bool = True, wcap: int = WCAP,
                          matcher: str = "lex", cover_seg: int = SEG,
                          stride: int = 1, lex_keys: int = 2):
    """match_and_parse over a (B, N) block matrix. The sort and the
    per-position stages vmap; the LCP candidates and the cover run once
    over the flattened batch (both mask at the static block size, so
    blocks never see each other)."""
    B, N = datas.shape
    if matcher == "lex":
        from .lcp_match import sort_stage_lex

        sort_fn = functools.partial(sort_stage_lex, wcap=wcap, stride=stride,
                                    keys=lex_keys)
        with jax.named_scope("sort"):
            sorted_ops = jax.vmap(sort_fn)(datas, ns)
        ps = sorted_ops[-1]
        with jax.named_scope("lcp_candidates"):
            bl_f, bd_f = lcp_candidates_xla(
                tuple(w.reshape(-1) for w in sorted_ops),
                depth=depth, max_dist=max_dist, block_elems=N // stride)
        best_len_s = bl_f.reshape(B, N // stride)
        best_dist_s = bd_f.reshape(B, N // stride)
    else:
        stride = 1
        sort_fn = functools.partial(_sort_stage, wcap=wcap)
        sorted_ops = jax.vmap(sort_fn)(datas, ns)
        hs, ps = sorted_ops[0], sorted_ops[1]
        sw = sorted_ops[2:]
        cand_fn = functools.partial(
            _candidates_xla, depth=depth, max_dist=max_dist, wcap=wcap)
        best_len_s, best_dist_s = jax.vmap(cand_fn)(hs, ps, sw)
    post_fn = functools.partial(_post_match, max_len=max_len, wcap=wcap,
                                seg=cover_seg, stride=stride)
    with jax.named_scope("post_match"):
        step_arr, best_len, best_dist, in_range, uncl = jax.vmap(post_fn)(
            datas, ns, ps, best_len_s, best_dist_s
        )
    merge_fn = functools.partial(_merge_seg_boundaries, max_len=max_len,
                                 seg=cover_seg)
    with jax.named_scope("cover"):
        is_tok = (parse_cover_mxu(step_arr.reshape(-1), cover_seg)
                  .reshape(B, N) & in_range)
        is_tok, best_len = jax.vmap(merge_fn)(is_tok, best_len, best_dist,
                                              ns, uncl)
    return is_tok, best_len, best_dist


@functools.lru_cache(maxsize=8)
def _crc_fold_mats(lane_bytes: int, levels: int) -> np.ndarray:
    """(levels, 32, 32) f32 GF(2) operators: level k shifts a register past
    lane_bytes*2^k zero bytes. M[i, j] = bit j of the image of basis i."""
    from ..ops.checksum import _gf2_matmul, zero_shift_operator

    op = zero_shift_operator(lane_bytes)
    mats = np.zeros((levels, 32, 32), dtype=np.float32)
    for k in range(levels):
        for i in range(32):
            mats[k, i] = (int(op[i]) >> np.arange(32)) & 1
        op = _gf2_matmul(op, op)
    return mats


def _device_crc_register(data: jnp.ndarray) -> jnp.ndarray:
    """Raw CRC register (init 0) of a full padded block, entirely on device:
    per-lane registers via the bit-matrix matmul (checksum_jax), then a GF(2)
    tree fold where each level is one tiny (L,32)@(32,32) parity matmul.
    The host strips padding algebraically (crc_unshift) — no per-lane
    host work remains."""
    from .checksum_jax import crc32_lane_registers

    N = data.shape[0]
    lanes = 1024
    while lanes > 1 and N % lanes:
        lanes //= 2
    regs = crc32_lane_registers(data, lanes=lanes)
    levels = int(np.log2(lanes))
    mats = _crc_fold_mats(N // lanes, levels)
    bits = ((regs[:, None] >> jnp.arange(32, dtype=jnp.uint32)[None, :])
            & jnp.uint32(1)).astype(jnp.float32)
    for k in range(levels):
        even, odd = bits[0::2], bits[1::2]
        shifted = jnp.dot(even, jnp.asarray(mats[k]),
                          preferred_element_type=jnp.float32)
        bits = ((shifted + odd).astype(jnp.int32) & 1).astype(jnp.float32)
    w = jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(bits[0].astype(jnp.uint32) * w).astype(jnp.uint32)


@functools.partial(jax.jit, static_argnames=("depth", "max_dist"))
def device_tokens(data: jnp.ndarray, n: jnp.ndarray, *, depth: int = 8,
                  max_dist: int = consts.WINDOW_SIZE):
    """Jitted export of the shared LZ stage for the zstd/brotli hybrid
    pipelines (device match+parse, host entropy coding). The cover is
    segment-merged (matches cross SEG boundaries up to 258 bytes wherever
    the matcher found the continuation) — the consumers impose no segment
    structure of their own.

    Returns ONE packed i32[N] array — bit 0: is_tok, bits 1..9: match
    length (0 for literal tokens, else 3..258), bits 10..30: distance
    (21 bits: brotli's hybrid tokenizer passes max_dist up to 2^20 —
    an 18-bit field truncated those and corrupted brotli streams;
    1+9+21 = 31 bits still fits i32). The (is_tok, len, dist) triple is
    packed on device: one D2H transfer at 1/3 the bytes of the
    three-array form (DeviceTokenizer unpacks)."""
    # Static arg, so the guard is free: distances are packed into a 21-bit
    # field below — a wider window would truncate silently (ADVICE r3).
    assert max_dist < (1 << 21), f"max_dist {max_dist} overflows 21-bit field"
    is_tok, best_len, best_dist = match_and_parse(
        data, n, depth=depth, max_dist=max_dist, clip_seg=False)
    take = best_len >= consts.MIN_MATCH
    mlen = jnp.where(take, best_len, 0)
    return jnp.where(
        is_tok,
        1 | (mlen << 1) | jnp.where(take, best_dist, 0) << 10,
        0,
    ).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("depth", "max_dist", "cap"))
def device_match_tokens(data: jnp.ndarray, n: jnp.ndarray, *, depth: int = 8,
                        max_dist: int = consts.WINDOW_SIZE, cap: int = 0):
    """Matches-only compact variant of :func:`device_tokens`: D2H carries
    8 bytes PER MATCH ((pos | len << 20) i32 + dist i32) instead of 4
    bytes per POSITION — ~4x fewer D2H bytes on typical covers; literal tokens are reconstructed on the host from the
    uncovered gaps (the cover partitions [0, n), so every position outside
    a match span is a literal token).

    Returns (packed i32[cap, 2], match_count). ``match_count > cap``
    signals overflow (degenerate all-3-byte-match covers) — the caller
    falls back to the dense path. Default cap = N // 6 (matches average
    >= 6 bytes on anything compressible)."""
    assert max_dist < (1 << 21)
    N = data.shape[0]
    assert N <= (1 << 20), "pos field is 20 bits"
    cap = cap or (N // 6 + 64)
    is_tok, best_len, best_dist = match_and_parse(
        data, n, depth=depth, max_dist=max_dist, clip_seg=False)
    is_match = is_tok & (best_len >= consts.MIN_MATCH)
    count = jnp.sum(is_match.astype(jnp.int32))
    (idx,) = jnp.nonzero(is_match, size=cap, fill_value=N)
    live = jnp.arange(cap) < count
    pos = jnp.where(live, idx, 0).astype(jnp.int32)
    ml = best_len[jnp.clip(idx, 0, N - 1)].astype(jnp.int32)
    md = best_dist[jnp.clip(idx, 0, N - 1)].astype(jnp.int32)
    a = jnp.where(live, pos | (ml << 20), -1)
    b = jnp.where(live, md, -1)
    return jnp.stack([a, b], axis=1), count


@functools.partial(jax.jit, static_argnames=("depth", "cap",
                                              "with_index", "check"))
def encode_block_fixed_v2(data: jnp.ndarray, n: jnp.ndarray, *, depth: int = 8,
                          cap: int = 0,
                          with_index: bool = False, check: str = "adler"):
    """v2 block encode. Returns (out_u8[cap], meta_i32[2]=[len, check]) and,
    with ``with_index``, the per-segment bit offsets (every SEG-byte output
    segment starts at a token boundary — the parse restarts per segment —
    so the offsets make self-produced blocks segment-parallel to decode).
    ``check`` selects the meta checksum: "adler" (zlib) or "crc" (gzip; the
    raw init-0 register of the full padded block — host strips the pad with
    crc_unshift)."""
    N = data.shape[0]
    if cap == 0:
        cap = N + N // 4 + 64
    pos_all = jnp.arange(N, dtype=jnp.int32)
    in_range = pos_all < n
    is_tok, best_len, best_dist = match_and_parse(data, n, depth=depth)
    take = best_len >= consts.MIN_MATCH

    # --- 5. fixed-Huffman fields (closed-form, gather-free) --------------
    is_match_tok = is_tok & take
    mlen = jnp.clip(best_len, consts.MIN_MATCH, consts.MAX_MATCH)
    dclip = jnp.clip(best_dist, 1, consts.WINDOW_SIZE)
    f0_val, f0_bits, f1_val, f1_bits = _fixed_fields(
        data, mlen, dclip, is_match_tok, is_tok & ~take
    )

    # --- assemble + matmul pack -----------------------------------------
    # Bit packing is scatter-free: fields map to SEGMENT-LOCAL byte rows by
    # a one-hot einsum (bit-disjoint contributions make float sums exact),
    # rows shift to their global bit phase, interiors land via sequential
    # dynamic_update_slice (ascending starts heal the overhang), and only
    # the segment-boundary bytes + stream header + EOB go through one tiny
    # scatter-add. (The 4-pass full scatter this replaces was ~1/3 of the
    # kernel's runtime.)
    per_pos = f0_bits + f1_bits
    base = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(per_pos)])
    off_f0 = 3 + base[:N]
    off_f1 = off_f0 + f0_bits
    off_eob = 3 + base[N]
    total_bits = off_eob + int(_FIXED_LIT_LEN[256])
    total_bytes = (total_bits + 3 + 7) // 8

    S = N // SEG
    W = 256  # row bytes per segment (worst case 149; 256 tiles cleanly)
    seg_bit0 = off_f0.reshape(S, SEG)[:, 0]
    loc_f0 = off_f0.reshape(S, SEG) - seg_bit0[:, None]
    loc_f1 = off_f1.reshape(S, SEG) - seg_bit0[:, None]
    floc = jnp.concatenate([loc_f0, loc_f1], axis=1)  # (S, 2*SEG)
    fvals = jnp.concatenate(
        [f0_val.reshape(S, SEG), f1_val.reshape(S, SEG)], axis=1
    ).astype(jnp.uint32)
    fbits = jnp.concatenate([f0_bits.reshape(S, SEG), f1_bits.reshape(S, SEG)], axis=1)
    shifted = jnp.where(fbits > 0, fvals << (floc & 7).astype(jnp.uint32), 0)
    bytep = floc >> 3  # (S, 2*SEG), in [0, W-4)

    oh = (
        bytep[:, :, None]
        == jax.lax.broadcasted_iota(jnp.int32, (S, 2 * SEG, W), 2)
    ).astype(jnp.bfloat16)
    vals4 = jnp.stack(
        [((shifted >> jnp.uint32(8 * k)) & jnp.uint32(0xFF)).astype(jnp.bfloat16)
         for k in range(4)],
        axis=-1,
    )  # byte values <= 255: exact in bf16; sums per byte <= 255 (disjoint bits)
    out4 = jnp.einsum(
        "sfb,sfk->sbk", oh, vals4, preferred_element_type=jnp.float32
    ).astype(jnp.int32)  # (S, W, 4)
    row = out4[:, :, 0]
    for k in range(1, 4):
        row = row + jnp.pad(out4[:, : W - k, k], ((0, 0), (k, 0)))

    # Shift each row to its global bit phase.
    r = (seg_bit0 & 7)[:, None]
    prev = jnp.pad(row[:, :-1], ((0, 0), (1, 0)))
    row_sh = ((row << r) | (prev >> (8 - r))) & 0xFF
    gbyte = seg_bit0 >> 3

    # Interior writes (bytes after each row's first), ascending.
    def write_row(s, buf):
        return jax.lax.dynamic_update_slice(buf, row_sh[s, 1:], (gbyte[s] + 1,))

    out = jax.lax.fori_loop(0, S, write_row, jnp.zeros(cap + W, dtype=jnp.int32))
    # Boundary bytes (bit-disjoint with neighbors), stream header, EOB.
    eob_code = jnp.uint32(int(_FIXED_LIT_REV[256]))
    eob_shift = (off_eob & 7).astype(jnp.uint32)
    eob_v = eob_code << eob_shift
    add_idx = jnp.concatenate([
        gbyte,
        jnp.zeros(1, jnp.int32),
        (off_eob >> 3).reshape(1),
        (off_eob >> 3).reshape(1) + 1,
    ])
    add_val = jnp.concatenate([
        row_sh[:, 0],
        jnp.asarray([2], jnp.int32),  # bfinal=0, btype=01 at bits 0-2
        (eob_v & 0xFF).astype(jnp.int32).reshape(1),
        ((eob_v >> 8) & 0xFF).astype(jnp.int32).reshape(1),
    ])
    out = out.at[jnp.clip(add_idx, 0, cap + W - 1)].add(add_val)
    out = out.at[total_bytes].set(0)
    out = out.at[total_bytes + 1].set(0)
    out = out.at[total_bytes + 2].set(0xFF)
    out = out.at[total_bytes + 3].set(0xFF)
    out_len = total_bytes + 4
    out_u8 = (out[:cap] & 0xFF).astype(jnp.uint8)

    # --- block checksum ---------------------------------------------------
    if check == "crc":
        chk = _device_crc_register(data)
    else:
        # adler32 (int32-safe two-level reduction)
        db = jnp.where(in_range, data.astype(jnp.int32), 0)
        s = jnp.sum(db)
        wmod = (jnp.maximum(n - pos_all, 0) % ADLER_MOD).astype(jnp.int32)
        group = jnp.sum((db * wmod).reshape(-1, 64), axis=1) % ADLER_MOD
        w = jnp.sum(group) % ADLER_MOD
        a = (1 + s) % ADLER_MOD
        b = (n % ADLER_MOD + w) % ADLER_MOD
        chk = (b.astype(jnp.uint32) << 16) | a.astype(jnp.uint32)
    meta = jnp.stack([out_len.astype(jnp.int32), chk.astype(jnp.int32)])
    if with_index:
        # bit offset of each segment's first token, with the output
        # overflow of the previous segment's merged match in bits 24..31
        seg_bits = (off_f0.reshape(-1, SEG)[:, 0]
                    | (cover_overflow(is_tok, best_len) << 24))
        return out_u8, meta, seg_bits
    return out_u8, meta
