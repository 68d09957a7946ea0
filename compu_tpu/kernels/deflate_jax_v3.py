"""Jittable DEFLATE block encoder, v3 — per-block dynamic Huffman trees,
fixed-tree fallback, and stored blocks for incompressible data, entirely on
device (no host round trip for table building).

v2 (deflate_jax_v2.py) emits fixed-Huffman only, forfeiting ~0.5x ratio on
mixed corpora (VERDICT r1 item: bench ratio 2.13x vs stock 2.8x). v3 keeps
v2's LZ stage (sort-carried matching + matmul segment parse) and matmul bit
packing, and adds:

1. *Device histogramming*: per-block lit/len (286) and dist (30) symbol
   frequencies as one-hot matmuls (``_hist_mxu``).
2. *Device canonical Huffman builder* (``build_lengths``): code lengths =
   clamp(ceil(-log2 p), 1, cap), which satisfies Kraft <= 1 by
   construction; a bounded argmax loop lengthens codes if the cap clamp
   overflowed Kraft; a bounded "exact-fill" loop shortens the most
   frequent fitting codes until the Kraft sum is exactly 2^cap (zlib's
   inflate rejects incomplete dynamic trees); a flat complete tree is the
   guaranteed-valid fallback if the loops fail to converge. Lengths are
   capped at 12 bits so every packed field (code + extra bits + bit phase)
   fits the 4-byte matmul pack rows.
3. *Dynamic header emission on device*: HLIT=29/HDIST=29 fixed, code
   lengths emitted as literal CL symbols (no 16/17/18 run coding — costs
   ~0.1% of a 256 KiB block), CL tree built with the same builder (cap 7).
4. *Block-type selection by computed cost*: dynamic vs fixed tree by
   per-symbol bit cost (a dense select on the code tables — no control
   flow), stored-block override when 8*n + overhead is cheaper (random
   data), chosen per device block.

Output stays a standard RFC1951 raw-deflate run ending with an empty
stored block (sync flush), byte-aligned — identical contract to v2, so the
block-parallel scheduler (parallel/scheduler.py) consumes either kernel.

Reference parity: this implements deflate's dynamic-block emission
(RFC1951 §3.2.7) that the reference reaches through libz's deflate
(reference src/encoder/zlib.rs:90-92); block-type choice mirrors
zlib's compress_block cost comparison.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..formats.deflate import consts
from .deflate_jax import ADLER_MOD
from .deflate_jax_v2 import (SEG, _device_crc_register, match_and_parse,
                             match_and_parse_batch)

CAPBITS = 12   # max lit/len/dist code length (<= RFC's 15; keeps pack rows 4B)
CLCAP = 7      # max code-length-code length (RFC limit)
NLIT = 286
NDIST = 30
W_SLACK = 256  # output-buffer slack past cap (scatter clip zone + trailer)
CL_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32,
)

# Fixed-tree lengths (RFC1951 §3.2.6) as dense arrays for the cost compare
# and the fixed-tree emit path.
_FIXED_LIT_LEN_NP = np.zeros(NLIT, dtype=np.int32)
_FIXED_LIT_LEN_NP[:144] = 8
_FIXED_LIT_LEN_NP[144:256] = 9
_FIXED_LIT_LEN_NP[256:280] = 7
_FIXED_LIT_LEN_NP[280:286] = 8
_FIXED_DIST_LEN_NP = np.full(NDIST, 5, dtype=np.int32)


def _rev_bits(x: jnp.ndarray, bits: jnp.ndarray, maxbits: int = 15) -> jnp.ndarray:
    """Reverse ``x`` within ``bits`` (dense butterfly over maxbits)."""
    x = x.astype(jnp.int32)
    r = jnp.zeros_like(x)
    for i in range(maxbits):
        r = r | (((x >> i) & 1) << (maxbits - 1 - i))
    return r >> (maxbits - bits)


# ---------------------------------------------------------------------------
# Device canonical-Huffman construction
# ---------------------------------------------------------------------------

def build_lengths(freq: jnp.ndarray, cap: int,
                  fill_iters: int = 64, fix_iters: int = 16) -> jnp.ndarray:
    """Code lengths (i32[A], 0 for unused) forming a COMPLETE prefix code
    (Kraft sum exactly 1) with all lengths <= cap. Single block; vmap over
    blocks. Requires >= 2 used symbols (callers guarantee by seeding
    frequencies). Near-optimal: ceil(-log2 p) start + greedy exact-fill;
    flat complete tree as the correctness fallback."""
    A = freq.shape[0]
    used = freq > 0
    nused = jnp.sum(used.astype(jnp.int32))
    total = jnp.sum(freq).astype(jnp.float32)
    p = freq.astype(jnp.float32) / jnp.maximum(total, 1.0)
    l0 = jnp.ceil(-jnp.log2(jnp.maximum(p, 2.0 ** -30)))
    l = jnp.clip(l0, 1, cap).astype(jnp.int32)
    l = jnp.where(used, l, 0)
    budget = jnp.int32(1 << cap)

    def units(l):
        return jnp.where(used & (l > 0), (1 << cap) >> jnp.minimum(l, cap), 0)

    # -- overflow fix: the cap clamp can push Kraft above 1. Lengthen the
    # largest-unit (shortest) codes; each step halves one unit, clearing
    # the (small, < A) excess geometrically.
    def fix_body(_, l):
        over = jnp.sum(units(l)) - budget
        cand = used & (l < cap) & (l > 0)
        score = jnp.where(cand, units(l), -1)
        j = jnp.argmax(score)
        do = over > 0
        return l.at[j].add(jnp.where(do, 1, 0))

    l = jax.lax.fori_loop(0, fix_iters, fix_body, l)

    # -- exact fill: shorten the code with the highest BITS SAVED PER
    # BUDGET UNIT (freq / unit-cost) whose doubling fits the remaining
    # slack. Scoring by raw frequency instead loses badly on near-uniform
    # distributions (measured 7.7% vs optimal on 16-symbol blocks: it
    # spends the whole slack shortening already-short frequent codes
    # while p-just-under-2^-k symbols stay a bit too long). Progress is
    # guaranteed while slack > 0 (the longest code's unit always divides
    # the slack), so slack hits 0 unless the iteration budget runs out.
    def fill_body(_, l):
        slack = budget - jnp.sum(units(l))
        u = units(l)
        fits = used & (l > 1) & (u <= slack) & (u > 0)
        score = jnp.where(fits, freq.astype(jnp.float32)
                          / jnp.maximum(u, 1).astype(jnp.float32), -1.0)
        j = jnp.argmax(score)
        do = (slack > 0) & (score[j] > 0)
        return l.at[j].add(jnp.where(do, -1, 0))

    l = jax.lax.fori_loop(0, fill_iters, fill_body, l)

    # -- fallback: flat complete tree over the used symbols (top 2^k - n
    # by frequency get length k-1, the rest k). Only selected if the fill
    # loop failed to converge (pathological distributions).
    ok = jnp.sum(units(l)) == budget
    k = jnp.ceil(jnp.log2(jnp.maximum(nused.astype(jnp.float32), 2.0))).astype(jnp.int32)
    n_short = (1 << k) - nused  # symbols that get length k-1
    # rank of each used symbol by frequency (descending, stable by index)
    order = jnp.argsort(jnp.where(used, -freq, 1).astype(jnp.float32) * A
                        + jnp.arange(A))
    rank = jnp.zeros(A, jnp.int32).at[order].set(jnp.arange(A, dtype=jnp.int32))
    flat = jnp.where(rank < n_short, k - 1, k)
    flat = jnp.maximum(flat, 1)
    flat = jnp.where(used, flat, 0)
    return jnp.where(ok, l, flat)


def canonical_codes(lengths: jnp.ndarray, maxbits: int = 15) -> jnp.ndarray:
    """Bit-REVERSED canonical codes (u32[A]) from lengths (RFC1951 §3.2.2),
    dense: per-length counts -> first codes; per-symbol rank within its
    length class via exclusive cumsum over symbol order."""
    A = lengths.shape[0]
    lens1h = (lengths[:, None] == jnp.arange(1, maxbits + 1)[None, :])
    bl_count = jnp.sum(lens1h.astype(jnp.int32), axis=0)  # [maxbits]
    # next_code[l] = (next_code[l-1] + bl_count[l-1]) << 1, scan over maxbits
    # (RFC1951 §3.2.2 pseudocode: update with the PREVIOUS length's count,
    # then emit).
    def scan_fn(carry, cnt):
        code = (carry + cnt) << 1
        return code, code
    _, first = jax.lax.scan(scan_fn, jnp.int32(0),
                            jnp.concatenate([jnp.zeros(1, jnp.int32), bl_count[:-1]]))
    # rank within class (exclusive cumsum down symbol order)
    rank = jnp.cumsum(lens1h.astype(jnp.int32), axis=0) - lens1h.astype(jnp.int32)
    codes = jnp.sum(lens1h * (first[None, :] + rank), axis=1)
    return _rev_bits(codes, jnp.maximum(lengths, 1), maxbits).astype(jnp.uint32)


# ---------------------------------------------------------------------------
# Token stage: symbols + histograms
# ---------------------------------------------------------------------------

def _token_syms(data, mlen, dclip):
    """Length/dist symbol decomposition (closed-form, RFC1951 §3.2.5)."""
    m = mlen - consts.MIN_MATCH
    e_l = ((m >= 8).astype(jnp.int32) + (m >= 16) + (m >= 32)
           + (m >= 64) + (m >= 128))
    lsym = 257 + (e_l << 2) + (m >> e_l)
    lextra = (m & ((1 << e_l) - 1)).astype(jnp.uint32)
    is258 = mlen == consts.MAX_MATCH
    lsym = jnp.where(is258, 285, lsym)
    e_l = jnp.where(is258, 0, e_l)
    lextra = jnp.where(is258, jnp.uint32(0), lextra)

    ds = dclip - 1
    e_d = (ds >= 4).astype(jnp.int32)
    for k in range(3, 15):
        e_d = e_d + (ds >= (1 << k))
    dsym = jnp.where(ds < 2, ds, 2 * (e_d + 1) + ((ds >> e_d) & 1))
    dextra = (ds & ((1 << e_d) - 1)).astype(jnp.uint32)
    return lsym, e_l, lextra, dsym, e_d, dextra


def _stored_block(data: jnp.ndarray, n: jnp.ndarray, cap: int) -> tuple:
    """Stored-block emission: ceil(n/65535) chunks, each 5-byte header +
    raw bytes, byte-aligned from the block start. Returns (buf, nbytes).

    Chunk starts are STATIC (only the last chunk is partial, and it sits
    at the same static offset), so the buffer is a static concat of
    [5-byte header, data slice] pieces with a dense j < total mask — no
    element gather."""
    N = data.shape[0]
    CH = 65535
    pieces = []
    for c in range((N + CH - 1) // CH):
        take_c = jnp.clip(n - c * CH, 0, CH)
        nlen_c = take_c ^ 0xFFFF
        hdr = jnp.stack([
            jnp.int32(0), take_c & 0xFF, (take_c >> 8) & 0xFF,
            nlen_c & 0xFF, (nlen_c >> 8) & 0xFF,
        ])
        pieces.append(hdr)
        pieces.append(data[c * CH : (c + 1) * CH].astype(jnp.int32))
    buf = jnp.concatenate(pieces)
    buf = jnp.pad(buf, (0, cap - buf.shape[0]))
    nchunks = (n + CH - 1) // CH
    total = n + 5 * nchunks
    j = jnp.arange(cap, dtype=jnp.int32)
    buf = jnp.where(j < total, buf, 0)
    return buf, total


# ---------------------------------------------------------------------------
# Main kernel
# ---------------------------------------------------------------------------

def _hist_mxu(sym: jnp.ndarray, mask: jnp.ndarray, nbins: int) -> jnp.ndarray:
    """Masked histogram as ONE matmul: split the bin index into
    (q, r) = (sym >> 4, sym & 15) and contract two one-hot factors over
    the position axis — hist2d[q, r] = sum_i mask_i [q_i==q][r_i==r].
    Counts accumulate exactly in f32 (<= 2^24). A scatter-add computes the
    same histogram; which is faster per device is an open measurement."""
    Q = (nbins + 15) // 16
    q = sym >> 4
    r = sym & 15
    a = ((q[:, None] == jnp.arange(Q, dtype=jnp.int32)[None, :])
         & mask[:, None]).astype(jnp.bfloat16)
    b = (r[:, None] == jnp.arange(16, dtype=jnp.int32)[None, :]).astype(jnp.bfloat16)
    h2 = jax.lax.dot_general(
        a, b, (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32
    )
    return h2.reshape(-1)[:nbins].astype(jnp.int32)


def _tokens_and_hist(data, n, *, depth, clip_seg=False, wcap=32,
                     matcher="lex", cover_seg=SEG, stride=1, lex_keys=2):
    """Stage 1: LZ tokens + per-block symbol histograms (device)."""
    is_tok, best_len, best_dist = match_and_parse(
        data, n, depth=depth, clip_seg=clip_seg, wcap=wcap, matcher=matcher,
        cover_seg=cover_seg, stride=stride, lex_keys=lex_keys,
    )
    return _tok_hist_from_match(data, n, is_tok, best_len, best_dist)


def _tok_hist_from_match(data, n, is_tok, best_len, best_dist):
    """Token symbol decomposition + histograms from a computed cover
    (vmappable; the batch path computes the cover once for all blocks)."""
    take = best_len >= consts.MIN_MATCH
    is_match_tok = is_tok & take
    is_lit = is_tok & ~take
    mlen = jnp.clip(best_len, consts.MIN_MATCH, consts.MAX_MATCH)
    dclip = jnp.clip(best_dist, 1, consts.WINDOW_SIZE)
    lsym, e_l, lextra, dsym, e_d, dextra = _token_syms(data, mlen, dclip)

    sym = jnp.where(is_match_tok, lsym, data.astype(jnp.int32))
    lit_freq = _hist_mxu(sym, is_tok, NLIT)
    lit_freq = lit_freq.at[256].add(1)  # EOB
    dist_freq = _hist_mxu(dsym, is_match_tok, NDIST)
    extra_l_bits = jnp.sum(jnp.where(is_match_tok, e_l, 0))
    extra_d_bits = jnp.sum(jnp.where(is_match_tok, e_d, 0))
    from .deflate_jax_v2 import cover_overflow

    tok = dict(is_tok=is_tok, is_match=is_match_tok, is_lit=is_lit, sym=sym,
               e_l=e_l, lextra=lextra, dsym=dsym, e_d=e_d, dextra=dextra,
               ov=cover_overflow(is_tok, best_len))
    return tok, lit_freq, dist_freq, extra_l_bits, extra_d_bits


def _build_tables(lit_freq, dist_freq, extra_l_bits, extra_d_bits, n):
    """Stage 2: trees + header fields + block-type costs (device, vmapped
    over blocks). Returns the code tables, header (vals/bits arrays), and
    selection scalars."""
    # Guarantee >= 2 used symbols per tree (complete-tree requirement):
    # lit always has EOB; seed symbol 0. dist may be empty; seed codes 0,1.
    lit_freq = lit_freq.at[0].add(jnp.where(jnp.sum((lit_freq > 0)) < 2, 1, 0))
    need = jnp.sum((dist_freq > 0)) < 2
    dist_freq = dist_freq.at[0].add(jnp.where(need & (dist_freq[0] == 0), 1, 0))
    dist_freq = dist_freq.at[1].add(jnp.where(jnp.sum((dist_freq > 0)) < 2, 1, 0))

    lit_len = build_lengths(lit_freq, CAPBITS)
    dist_len = build_lengths(dist_freq, CAPBITS)

    # Dynamic-vs-fixed cost on the real histograms.
    fixed_lit = jnp.asarray(_FIXED_LIT_LEN_NP)
    fixed_dist = jnp.asarray(_FIXED_DIST_LEN_NP)
    dyn_body = (jnp.sum(lit_freq * lit_len) + jnp.sum(dist_freq * dist_len)
                + extra_l_bits + extra_d_bits)
    fix_body = (jnp.sum(lit_freq * fixed_lit) + jnp.sum(dist_freq * fixed_dist)
                + extra_l_bits + extra_d_bits)

    # Header: CL tree over the 316 lengths (literal CL symbols, no RLE).
    all_lens = jnp.concatenate([lit_len, dist_len])  # [316]
    cl_freq = jnp.zeros(19, jnp.int32).at[all_lens].add(1)
    cl_freq = cl_freq.at[1].add(jnp.where(jnp.sum(cl_freq > 0) < 2, 1, 0))
    cl_len = build_lengths(cl_freq, CLCAP)
    cl_code = canonical_codes(cl_len, CLCAP)
    header_bits = (14 + 19 * 3
                   + jnp.sum(cl_len[all_lens]))
    dyn_cost = dyn_body + header_bits
    use_dyn = dyn_cost < fix_body
    huff_cost = jnp.minimum(dyn_cost, fix_body)
    # Stored: n bytes + 5 per 65535-chunk, byte-aligned (3 header bits
    # round into the first chunk's header byte).
    nchunks = (n + 65534) // 65535
    stored_cost = 8 * (n + 5 * nchunks)
    use_stored = stored_cost < huff_cost

    lit_len_sel = jnp.where(use_dyn, lit_len, fixed_lit)
    dist_len_sel = jnp.where(use_dyn, dist_len, fixed_dist)
    # Fixed-tree codes must be built over the full 288-symbol alphabet —
    # codes 286/287 exist in the fixed tree's code space (RFC1951 §3.2.6)
    # and shift the 9-bit first code. Dynamic trees are self-defined over
    # the 286 lengths the header sends, so 286-wide construction matches
    # what decoders rebuild.
    fixed_lit288 = jnp.concatenate([fixed_lit, jnp.array([8, 8], jnp.int32)])
    fixed_lit_code = canonical_codes(fixed_lit288, 15)[:NLIT]
    lit_code = jnp.where(use_dyn, canonical_codes(lit_len, 15), fixed_lit_code)
    lit_code = jnp.where(lit_len_sel > 0, lit_code, 0)
    dist_code = jnp.where(use_dyn, canonical_codes(dist_len, 15),
                          canonical_codes(fixed_dist, 15))

    # Header field arrays (static count: 1 + 19 + 316), values + bit widths.
    hdr_first = (jnp.int32(4)            # bfinal=0 btype=10 (LSB-first)
                 | (29 << 3) | (29 << 8) | (15 << 13))  # HLIT HDIST HCLEN
    cl_in_order = cl_len[jnp.asarray(CL_ORDER)]
    hv_cl = cl_in_order.astype(jnp.uint32)
    hb_cl = jnp.full(19, 3, jnp.int32)
    hv_lens = cl_code[all_lens]
    hb_lens = cl_len[all_lens]
    hdr_vals = jnp.concatenate([
        jnp.array([hdr_first], jnp.int32).astype(jnp.uint32), hv_cl, hv_lens
    ])
    hdr_bits = jnp.concatenate([
        jnp.array([17], jnp.int32), hb_cl, hb_lens
    ])
    # Fixed-tree blocks have a 3-bit header only (bfinal=0 btype=01 -> 2).
    hdr_vals = jnp.where(use_dyn, hdr_vals,
                         jnp.zeros_like(hdr_vals).at[0].set(2))
    hdr_bits = jnp.where(use_dyn, hdr_bits,
                         jnp.zeros_like(hdr_bits).at[0].set(3))
    header_total = jnp.sum(hdr_bits)
    return dict(
        lit_len=lit_len_sel, lit_code=lit_code,
        dist_len=dist_len_sel, dist_code=dist_code,
        hdr_vals=hdr_vals, hdr_bits=hdr_bits, header_total=header_total,
        use_stored=use_stored,
    )


def _lookup2_mxu(sym: jnp.ndarray, t0: jnp.ndarray, t1: jnp.ndarray,
                 nbins: int):
    """Paired table lookup (t0[sym], t1[sym]) as one small matmul plus
    a masked sum: bin = 16q + r factors the one-hot, so the gather becomes
    A(N, Q) @ T(Q, 32) followed by an r-select. Table values < 2^24 are
    exact in f32 at HIGHEST precision."""
    q_bins = (nbins + 15) // 16
    pad = q_bins * 16
    tt = jnp.stack([
        jnp.pad(t0.astype(jnp.float32), (0, pad - nbins)),
        jnp.pad(t1.astype(jnp.float32), (0, pad - nbins)),
    ], axis=-1).reshape(q_bins, 32)
    q = sym >> 4
    r = sym & 15
    a = (q[:, None] == jnp.arange(q_bins, dtype=jnp.int32)[None, :]
         ).astype(jnp.float32)
    # HIGHEST: default-precision f32 matmuls may round their operands
    # (bf16 passes, or TF32 on GPU tensor cores), which is not exact for
    # 15-bit integer table values; the one-hot contraction must reproduce
    # them bit-exactly.
    m = jnp.dot(a, tt, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST).reshape(-1, 16, 2)
    b = r[:, None] == jnp.arange(16, dtype=jnp.int32)[None, :]
    v = jnp.sum(m * b[:, :, None], axis=1)
    return v[:, 0], v[:, 1]


W2 = 512  # emit row width in bytes (segment content + fine byte offset)


def emit_pack_xla(bytep: jnp.ndarray, shifted: jnp.ndarray) -> jnp.ndarray:
    """(S, 256) segment-local byte positions + shifted field values ->
    (S, 32, 32) packed tiles: entry (q, r') holds the sum of byte
    contributions to byte p = 16q + r'. The 4 byte lanes of each field
    fold into the r factor as r' = (p & 15) + lane < 19 < 32, so one
    (S, 256, 32) factor carries them all (see rows_from_tiles)."""
    S = bytep.shape[0]
    q = bytep >> 4
    r = bytep & 15
    qcols = jnp.arange(32, dtype=jnp.int32)
    a = (q[:, :, None] == qcols[None, None, :]).astype(jnp.bfloat16)
    b = jnp.zeros((S, bytep.shape[1], 32), jnp.bfloat16)
    su = shifted.astype(jnp.uint32)
    for k in range(4):
        byte_k = ((su >> jnp.uint32(8 * k)) & jnp.uint32(0xFF)).astype(
            jnp.bfloat16)
        rk = r + k
        b = b + (rk[:, :, None] == qcols[None, None, :]).astype(jnp.bfloat16) \
            * byte_k[:, :, None]
    out = jnp.einsum("sfq,sfr->sqr", a, b,
                     preferred_element_type=jnp.float32)
    return out.astype(jnp.int32)


def rows_from_tiles(tiles: jnp.ndarray) -> jnp.ndarray:
    """(S, 32, 32) packed tiles -> (S, W2) byte rows: p = 16q + r', the
    upper r' half lands 16 bytes later."""
    S = tiles.shape[0]
    lo = tiles[:, :, :16].reshape(S, W2)
    hi = tiles[:, :, 16:].reshape(S, W2)
    return lo + jnp.pad(hi[:, : W2 - 16], ((0, 0), (16, 0)))


def _emit(data, n, tok, tables, *, cap, with_index):
    """Stage 3: map tokens through the code tables, pack bits via a
    segment-local one-hot einsum, shift rows to their global bit
    phase, lay them down with ascending dynamic_update_slice writes, and
    add boundary bytes / header / EOB with one tiny scatter-add;
    stored-block override by dense select.

    The pack's one-hot is SPLIT: a segment-local byte position p < 256
    factors as (q, r) = (p >> 4, p & 15), and the packed rows come from
    one einsum contracting two narrow one-hots — 16-wide q one-hot and a
    (16x4)-wide r-one-hot x byte-lane-value factor — instead of a 256-wide
    one-hot (~4x less memory traffic) or full-buffer scatter-adds.
    Adjacent fields share bytes but never bits, so the f32 sums are exact
    (<= 255 per byte)."""
    N = data.shape[0]
    lit_len, lit_code = tables["lit_len"], tables["lit_code"]
    dist_len, dist_code = tables["dist_len"], tables["dist_code"]

    is_match = tok["is_match"]
    is_lit = tok["is_lit"]
    sym = tok["sym"]

    code_l_f, len_l_f = _lookup2_mxu(sym, lit_code, lit_len, NLIT)
    code_l = code_l_f.astype(jnp.uint32)
    len_l = len_l_f.astype(jnp.int32)
    f0_val = jnp.where(
        is_match,
        code_l | (tok["lextra"] << len_l.astype(jnp.uint32)),
        code_l,
    )
    f0_bits = jnp.where(is_match, len_l + tok["e_l"],
                        jnp.where(is_lit, len_l, 0))
    code_d_f, len_d_f = _lookup2_mxu(tok["dsym"], dist_code, dist_len, NDIST)
    code_d = code_d_f.astype(jnp.uint32)
    len_d = len_d_f.astype(jnp.int32)
    f1_val = code_d | (tok["dextra"] << len_d.astype(jnp.uint32))
    f1_bits = jnp.where(is_match, len_d + tok["e_d"], 0)

    # --- global bit offsets ------------------------------------------------
    header_total = tables["header_total"]
    per_pos = f0_bits + f1_bits
    base = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(per_pos)])
    off_f0 = header_total + base[:N]
    off_f1 = off_f0 + f0_bits
    off_eob = header_total + base[N]
    eob_len = lit_len[256]
    total_bits = off_eob + eob_len
    total_bytes = (total_bits + 3 + 7) // 8  # +3: empty stored-block header

    S = N // SEG
    W = 256   # max row content bytes per segment (worst case 223)

    # --- field positions: segment-local bits + fine byte offset -------------
    # Each segment's fields land in a W2-wide row at byte
    # (local_bits >> 3) + (segment's global byte & (W-1)) < W2; the row is
    # then ADDED into the output at the segment's coarse 256-byte slot.
    # Every overlap (boundary bytes between consecutive rows, rows sharing
    # a slot) is bit-disjoint, so sums compose exactly — no sequential
    # laydown, no boundary special case.
    seg_bit0 = off_f0.reshape(S, SEG)[:, 0]
    gbyte = seg_bit0 >> 3
    fine = gbyte & (W - 1)
    qrow = gbyte >> 8
    loc_f0 = off_f0.reshape(S, SEG) - seg_bit0[:, None]
    loc_f1 = off_f1.reshape(S, SEG) - seg_bit0[:, None]
    floc = jnp.concatenate([loc_f0, loc_f1], axis=1)          # (S, 2*SEG)
    fvals = jnp.concatenate(
        [f0_val.reshape(S, SEG), f1_val.reshape(S, SEG)], axis=1
    ).astype(jnp.uint32)
    fbits = jnp.concatenate(
        [f0_bits.reshape(S, SEG), f1_bits.reshape(S, SEG)], axis=1
    )
    shifted = jnp.where(fbits > 0, fvals << (floc & 7).astype(jnp.uint32), 0)
    bytep = jnp.clip((floc >> 3) + fine[:, None], 0, W2 - 1)   # (S, 2*SEG)

    # --- q/r-split one-hot pack ---------------------------------------------
    # A byte position p < 512 factors as (q, r') = (p >> 4, (p & 15) + lane);
    # the packed tiles come from ONE contraction of two narrow one-hots
    # (emit_pack_xla). Byte values <= 255 are exact in bf16; per-byte sums
    # <= 255 (bit-disjoint) are exact in f32. Note: wrapping
    # encode_blocks_dyn in another jit DCEs the emit when only metas are
    # consumed — time it through the unwrapped jit only.
    row = rows_from_tiles(emit_pack_xla(bytep, shifted))

    # --- shift rows to their global bit phase --------------------------------
    rphase = (seg_bit0 & 7)[:, None]
    prev = jnp.pad(row[:, :-1], ((0, 0), (1, 0)))
    row_sh = ((row << rphase) | (prev >> (8 - rphase))) & 0xFF

    # --- coarse placement: one-hot slot matmul + overlap-add ----------------
    QN = (cap + W_SLACK) // W + 2
    oh = (qrow[:, None]
          == jax.lax.broadcasted_iota(jnp.int32, (S, QN), 1)
          ).astype(jnp.bfloat16)                               # (S, QN)
    slots = jnp.einsum(
        "sj,sq->qj", row_sh.astype(jnp.bfloat16), oh,
        preferred_element_type=jnp.float32,
    ).astype(jnp.int32)                                        # (QN, W2)
    flat_lo = slots[:, :W].reshape(-1)                         # (QN*W,)
    flat_hi = slots[:, W:].reshape(-1)
    out = (jnp.pad(flat_lo, (0, W))
           + jnp.pad(flat_hi, (W, 0)))[: cap + W_SLACK]

    # --- header + EOB (same scatter-add; bit-disjoint with tokens) ----------
    hdr_vals, hdr_bits = tables["hdr_vals"], tables["hdr_bits"]
    H = hdr_vals.shape[0]
    hoff = jnp.concatenate([jnp.zeros(1, jnp.int32),
                            jnp.cumsum(hdr_bits)])[:H]
    hshift = jnp.where(hdr_bits > 0,
                       hdr_vals << (hoff & 7).astype(jnp.uint32),
                       jnp.uint32(0))
    hbyte = hoff >> 3
    # header fields are <= 17 bits + 7 phase -> 3 bytes
    hidx = jnp.concatenate([hbyte, hbyte + 1, hbyte + 2])
    hval = jnp.concatenate([
        (hshift & 0xFF).astype(jnp.int32),
        ((hshift >> 8) & 0xFF).astype(jnp.int32),
        ((hshift >> 16) & 0xFF).astype(jnp.int32),
    ])

    eob_code = tables["lit_code"][256]
    eob_shift = (off_eob & 7).astype(jnp.uint32)
    eob_v = eob_code.astype(jnp.uint32) << eob_shift
    add_idx = jnp.concatenate([
        hidx,
        (off_eob >> 3).reshape(1),
        (off_eob >> 3).reshape(1) + 1,
        (off_eob >> 3).reshape(1) + 2,
    ])
    add_val = jnp.concatenate([
        hval,
        (eob_v & 0xFF).astype(jnp.int32).reshape(1),
        ((eob_v >> 8) & 0xFF).astype(jnp.int32).reshape(1),
        ((eob_v >> 16) & 0xFF).astype(jnp.int32).reshape(1),
    ])
    out = out.at[jnp.clip(add_idx, 0, cap + W_SLACK - 1)].add(add_val)
    # sync flush: empty stored block (LEN=0 NLEN=FFFF), byte-aligned
    out = out.at[total_bytes].set(0)
    out = out.at[total_bytes + 1].set(0)
    out = out.at[total_bytes + 2].set(0xFF)
    out = out.at[total_bytes + 3].set(0xFF)
    huff_len = total_bytes + 4

    # --- stored override -----------------------------------------------------
    use_stored = tables["use_stored"]
    stored_buf, stored_n = _stored_block(data, n, cap + W_SLACK)
    # Sync flush after a stored block is byte-aligned, so the empty stored
    # block's 3-bit header + 5 pad bits form their own 0x00 byte before
    # LEN=0/NLEN=FFFF (the Huffman path folds those 3 bits into the EOB
    # byte rounding instead).
    stored_buf = stored_buf.at[stored_n].set(0)
    stored_buf = stored_buf.at[stored_n + 1].set(0)
    stored_buf = stored_buf.at[stored_n + 2].set(0)
    stored_buf = stored_buf.at[stored_n + 3].set(0xFF)
    stored_buf = stored_buf.at[stored_n + 4].set(0xFF)
    stored_len = stored_n + 5

    out = jnp.where(use_stored, stored_buf, out)
    out_len = jnp.where(use_stored, stored_len, huff_len)
    out_u8 = (out[:cap] & 0xFF).astype(jnp.uint8)
    if with_index:
        # Segment bit offsets (dynamic blocks put segment 0 after the
        # header; stored blocks flag with -1 so the decoder takes the
        # stored path). Bits 24..31 carry the previous segment's merged-
        # match output overflow (cover_overflow) for the decoder's lane
        # start offsets.
        seg_bits = jnp.where(
            use_stored, -1,
            off_f0.reshape(S, SEG)[:, 0] | (tok["ov"] << 24))
        return out_u8, out_len, seg_bits
    return out_u8, out_len


def _block_checksum(data, n, check):
    N = data.shape[0]
    pos_all = jnp.arange(N, dtype=jnp.int32)
    in_range = pos_all < n
    if check == "crc":
        return _device_crc_register(data)
    db = jnp.where(in_range, data.astype(jnp.int32), 0)
    s = jnp.sum(db)
    wmod = (jnp.maximum(n - pos_all, 0) % ADLER_MOD).astype(jnp.int32)
    group = jnp.sum((db * wmod).reshape(-1, 64), axis=1) % ADLER_MOD
    w = jnp.sum(group) % ADLER_MOD
    a = (1 + s) % ADLER_MOD
    b = (n % ADLER_MOD + w) % ADLER_MOD
    return (b.astype(jnp.uint32) << 16) | a.astype(jnp.uint32)


@functools.partial(jax.jit, static_argnames=("depth", "cap", "with_index",
                                              "check", "wcap", "matcher",
                                              "cover_seg", "stride",
                                              "lex_keys"))
def encode_blocks_dyn(blocks: jnp.ndarray, lens: jnp.ndarray, *, depth: int = 8,
                      cap: int = 0, with_index: bool = False,
                      check: str = "adler", wcap: int = 32,
                      matcher: str = "lex", cover_seg: int = SEG,
                      stride: int = 1, lex_keys: int = 2):
    """Batched v3 encode over a (B, N) block matrix — the throughput path.

    The bit-pack lax.maps over blocks (big per-block arrays), but the tree
    builder VMAPs over the block axis — its bounded Kraft-fill loops are
    ~80 sequential steps of tiny (286-wide) ops, which under lax.map would
    serialize per block but under vmap run once as (B, 286) steps."""
    B, N = blocks.shape
    if cap == 0:
        cap = N + N // 4 + 64

    # Match+cover run at the batch level (match_and_parse_batch); the
    # elementwise token/histogram stage vmaps.
    is_tok_b, bl_b, bd_b = match_and_parse_batch(
        blocks, lens, depth=depth, clip_seg=with_index, wcap=wcap,
        matcher=matcher, cover_seg=cover_seg, stride=stride,
        lex_keys=lex_keys,
    )

    def stage1(data, n, is_tok, best_len, best_dist):
        tok, lf, df, xl, xd = _tok_hist_from_match(
            data, n, is_tok, best_len, best_dist
        )
        chk = _block_checksum(data, n, check)
        return tok, lf, df, xl, xd, chk

    with jax.named_scope("tok_hist_checksum"):
        tok, lf, df, xl, xd, chks = jax.vmap(stage1)(
            blocks, lens, is_tok_b, bl_b, bd_b)
    with jax.named_scope("tree_build"):
        tables = jax.vmap(_build_tables)(lf, df, xl, xd, lens)

    def stage3(args):
        data, n, tok_b, tables_b = args
        return _emit(data, n, tok_b, tables_b, cap=cap, with_index=with_index)

    with jax.named_scope("emit"):
        res = jax.lax.map(stage3, (blocks, lens, tok, tables))
    if with_index:
        outs, out_lens, seg_bits = res
        metas = jnp.stack([out_lens.astype(jnp.int32),
                           chks.astype(jnp.int32)], axis=1)
        return outs, metas, seg_bits
    outs, out_lens = res
    metas = jnp.stack([out_lens.astype(jnp.int32), chks.astype(jnp.int32)], axis=1)
    return outs, metas


@functools.partial(jax.jit, static_argnames=("depth", "cap", "with_index",
                                              "check", "wcap", "matcher",
                                              "cover_seg", "stride",
                                              "lex_keys"))
def encode_block_dyn(data: jnp.ndarray, n: jnp.ndarray, *, depth: int = 8,
                     cap: int = 0, with_index: bool = False,
                     check: str = "adler", wcap: int = 32,
                     matcher: str = "lex", cover_seg: int = SEG,
                     stride: int = 1, lex_keys: int = 2):
    """v3 block encode (single block). Returns (out_u8[cap], meta_i32[2])
    (+ seg_bits with ``with_index``), same contract as v2's
    encode_block_fixed_v2."""
    N = data.shape[0]
    if cap == 0:
        cap = N + N // 4 + 64
    tok, lit_freq, dist_freq, xl, xd = _tokens_and_hist(
        data, n, depth=depth, clip_seg=with_index, wcap=wcap, matcher=matcher,
        cover_seg=cover_seg, stride=stride, lex_keys=lex_keys,
    )
    tables = _build_tables(lit_freq, dist_freq, xl, xd, n)
    res = _emit(data, n, tok, tables, cap=cap, with_index=with_index)
    chk = _block_checksum(data, n, check)
    if with_index:
        out_u8, out_len, seg_bits = res
        meta = jnp.stack([out_len.astype(jnp.int32), chk.astype(jnp.int32)])
        return out_u8, meta, seg_bits
    out_u8, out_len = res
    meta = jnp.stack([out_len.astype(jnp.int32), chk.astype(jnp.int32)])
    return out_u8, meta
