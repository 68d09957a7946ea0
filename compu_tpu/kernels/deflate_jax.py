"""Jittable DEFLATE block encoder (v1, the chain-walk formulation).

One call = one fixed-shape device block (padded to ``block_cap`` bytes,
actual length a scalar). The whole pipeline stays inside a single jit:

    hash3 → chain build (stable sort) → chain walk with 4-byte XOR match
    measurement → lazy demote → pointer-doubling greedy cover → fixed-Huffman
    code mapping → prefix-sum bit offsets → scatter-add bit packing →
    sync-flush byte alignment, plus adler32/crc32 lane partials.

Output is an RFC1951-compliant raw-deflate byte sequence for the block,
terminated by an empty non-final stored block (Z_SYNC_FLUSH) so every block
is byte-aligned and independently decodable — the property the
block-parallel scheduler (parallel/scheduler.py) builds on, exactly like
pigz-style parallel gzip.

Fixed-Huffman is used on-device because the code tables are constants,
keeping the step end-to-end jittable (the dynamic-Huffman quality path runs
through the host pipeline in formats/deflate). Matches are searched within
the block only (window resets per block) — RFC-legal, and what makes
self-produced streams embarrassingly parallel to decode.

Scatter-add is scatter-OR here: bit packing partitions output bits, so
contributions to a shared byte never carry.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..formats.deflate import consts
from ..ops.bitio import reverse_bits
from ..ops.huffman import canonical_codes

# -- constant tables (device-resident) --------------------------------------
_FIXED_LIT_LEN = np.asarray(consts.FIXED_LITLEN_LENGTHS, dtype=np.int32)
_FIXED_LIT_REV = reverse_bits(
    canonical_codes(consts.FIXED_LITLEN_LENGTHS),
    consts.FIXED_LITLEN_LENGTHS.astype(np.uint32),
).astype(np.uint32)
_FIXED_DIST_LEN = np.asarray(consts.FIXED_DIST_LENGTHS, dtype=np.int32)
_FIXED_DIST_REV = reverse_bits(
    canonical_codes(consts.FIXED_DIST_LENGTHS),
    consts.FIXED_DIST_LENGTHS.astype(np.uint32),
).astype(np.uint32)

_LENGTH_CODE = consts.LENGTH_CODE.astype(np.int32)
_LENGTH_BASE = consts.LENGTH_BASE.astype(np.int32)
_LENGTH_EXTRA = consts.LENGTH_EXTRA.astype(np.int32)
_DIST_CODE = consts.DIST_CODE.astype(np.int32)
_DIST_BASE = consts.DIST_BASE.astype(np.int32)
_DIST_EXTRA = consts.DIST_EXTRA.astype(np.int32)

ADLER_MOD = 65521


def _u32_view(data: jnp.ndarray, pad: int) -> jnp.ndarray:
    """u32[i] = little-endian 4 bytes at i, zero-padded past the end."""
    padded = jnp.concatenate([data, jnp.zeros(pad, dtype=jnp.uint8)])
    u = padded.astype(jnp.uint32)
    return (
        u[: len(u) - 3]
        | (u[1 : len(u) - 2] << 8)
        | (u[2 : len(u) - 1] << 16)
        | (u[3:] << 24)
    )


def _match_lengths_dense(u32, pos, cand, limit, active0):
    """Common-prefix lengths via 4-byte XOR steps, dense masks (no
    compaction — the dense formulation), early exit by while_loop."""
    n = pos.shape[0]

    def cond(state):
        lens, active = state
        return jnp.any(active)

    def body(state):
        lens, active = state
        ai = jnp.clip(pos + lens, 0, u32.shape[0] - 1)
        bi = jnp.clip(cand + lens, 0, u32.shape[0] - 1)
        x = u32[ai] ^ u32[bi]
        low = x & (jnp.uint32(0) - x)
        cnt = (jax.lax.population_count(low - jnp.uint32(1)) >> 3).astype(jnp.int32)
        cnt = jnp.where(x == 0, jnp.int32(4), cnt)
        lens = lens + jnp.where(active, cnt, 0)
        active = active & (cnt == 4) & (lens < limit)
        return lens, active

    # Derive the zero init from a varying operand so the carry's manual-axes
    # type matches under shard_map (a plain jnp.zeros is unvarying and the
    # while_loop carry would type-mismatch).
    lens0 = jnp.where(active0, jnp.int32(0), jnp.int32(0))
    lens, _ = jax.lax.while_loop(cond, body, (lens0, active0))
    return jnp.minimum(lens, limit)


@functools.partial(jax.jit, static_argnames=("depth", "nice", "lazy", "cap"))
def encode_block_fixed(data: jnp.ndarray, n: jnp.ndarray, *, depth: int = 8,
                       nice: int = 128, lazy: bool = True, cap: int = 0):
    """Encode one padded block as fixed-Huffman deflate.

    Args:
      data: uint8[N] padded block (bytes past ``n`` are ignored).
      n: int32 scalar, actual byte length (> 0).
      depth/nice/lazy: match-finder effort (from the level ladder).
      cap: output capacity in bytes (static); 0 → N + N//2 + 64.

    Returns (out_bytes uint8[cap], meta int32[2] = [out_len, adler]).
    Metadata rides in one small array rather than scalars: scalar outputs
    force pathological per-buffer host syncs on high-latency runtimes.
    """
    N = data.shape[0]
    if cap == 0:
        cap = N + N // 2 + 64
    pos_all = jnp.arange(N, dtype=jnp.int32)
    in_range = pos_all < n

    # --- hash chains -----------------------------------------------------
    d0 = data.astype(jnp.uint32)
    v = d0 | (jnp.roll(d0, -1) << 8) | (jnp.roll(d0, -2) << 16)
    h = (v * jnp.uint32(2654435761)) >> jnp.uint32(16)
    # Positions past n-2 must not form matches: give them unique hashes.
    h = jnp.where(pos_all < n - 2, h, jnp.uint32(0x10000) + pos_all.astype(jnp.uint32))
    order = jnp.argsort(h, stable=True).astype(jnp.int32)
    h_sorted = h[order]
    same = jnp.concatenate(
        [jnp.zeros(1, dtype=bool), h_sorted[1:] == h_sorted[:-1]]
    )
    prev_sorted = jnp.where(same, jnp.roll(order, 1), jnp.int32(-1))
    prev = jnp.zeros(N, dtype=jnp.int32).at[order].set(prev_sorted)

    # --- chain walk with match measurement -------------------------------
    u32 = _u32_view(data, consts.MAX_MATCH + 8)
    # Measuring beyond ``nice`` wastes gather rounds: matches are accepted
    # at nice length anyway, so cap the measured length (trades a little
    # ratio on long runs for a bounded match loop).
    max_measure = min(consts.MAX_MATCH, max(nice, 16))
    limit = jnp.minimum(jnp.int32(max_measure), n - pos_all)
    best_len = jnp.zeros(N, dtype=jnp.int32)
    best_dist = jnp.zeros(N, dtype=jnp.int32)
    cand = prev
    for _ in range(depth):
        valid = (cand >= 0) & (pos_all - cand <= consts.WINDOW_SIZE) & in_range
        active = valid & (best_len < nice)
        l = _match_lengths_dense(u32, pos_all, jnp.maximum(cand, 0), limit, active)
        better = active & (l > best_len)
        best_len = jnp.where(better, l, best_len)
        best_dist = jnp.where(better, pos_all - cand, best_dist)
        cand = jnp.where(cand >= 0, prev[jnp.maximum(cand, 0)], jnp.int32(-1))

    # --- heuristics (zlib-compatible) ------------------------------------
    drop = (best_len == consts.MIN_MATCH) & (best_dist > 4096)
    best_len = jnp.where(drop, 0, best_len)
    if lazy:
        nxt_len = jnp.concatenate([best_len[1:], jnp.zeros(1, jnp.int32)])
        best_len = jnp.where(nxt_len > best_len, 0, best_len)
    take = best_len >= consts.MIN_MATCH

    # --- greedy cover via pointer doubling -------------------------------
    step = jnp.where(take, best_len, 1)
    jump = jnp.minimum(pos_all + step, N)  # token at i jumps to next token
    jump = jnp.concatenate([jump, jnp.asarray([N], jnp.int32)])
    on_path = jnp.zeros(N + 1, dtype=bool).at[0].set(True)
    iters = max(1, int(np.ceil(np.log2(max(N, 2)))) + 1)
    for _ in range(iters):
        targets = jump[: N + 1]
        on_path = on_path.at[jnp.where(on_path, targets, N)].max(on_path)
        jump = jump[jump]
    is_tok = on_path[:N] & in_range

    # --- fixed-Huffman field mapping -------------------------------------
    lit_len_t = jnp.asarray(_FIXED_LIT_LEN)
    lit_rev_t = jnp.asarray(_FIXED_LIT_REV)
    dist_len_t = jnp.asarray(_FIXED_DIST_LEN)
    dist_rev_t = jnp.asarray(_FIXED_DIST_REV)

    is_match_tok = is_tok & take
    is_lit_tok = is_tok & ~take

    mlen = jnp.clip(best_len, consts.MIN_MATCH, consts.MAX_MATCH)
    lsym = jnp.asarray(_LENGTH_CODE)[mlen]
    lsym_idx = lsym - 257
    lcode_bits = lit_len_t[lsym]
    lextra_bits = jnp.asarray(_LENGTH_EXTRA)[lsym_idx]
    lextra_val = (mlen - jnp.asarray(_LENGTH_BASE)[lsym_idx]).astype(jnp.uint32)

    dclip = jnp.clip(best_dist, 1, consts.WINDOW_SIZE)
    dsym = jnp.asarray(_DIST_CODE)[dclip]
    dcode_bits = dist_len_t[dsym]
    dextra_bits = jnp.asarray(_DIST_EXTRA)[dsym]
    dextra_val = (dclip - jnp.asarray(_DIST_BASE)[dsym]).astype(jnp.uint32)

    lit_field_val = lit_rev_t[data.astype(jnp.int32)]
    lit_field_bits = lit_len_t[data.astype(jnp.int32)]

    # Field 0 per position: literal code or length(code|extra).
    f0_val = jnp.where(
        is_match_tok,
        lit_rev_t[lsym] | (lextra_val << lcode_bits.astype(jnp.uint32)),
        lit_field_val,
    )
    f0_bits = jnp.where(
        is_match_tok, lcode_bits + lextra_bits, jnp.where(is_lit_tok, lit_field_bits, 0)
    )
    f0_bits = jnp.where(is_tok, f0_bits, 0)
    # Field 1 per position: distance(code|extra) for matches.
    f1_val = dist_rev_t[dsym] | (dextra_val << dcode_bits.astype(jnp.uint32))
    f1_bits = jnp.where(is_match_tok, dcode_bits + dextra_bits, 0)

    # --- assemble the bit stream -----------------------------------------
    # Layout: [bfinal=0, btype=01] + fields + EOB + align pad + sync flush.
    hdr_val = jnp.asarray([0 | (1 << 1)], dtype=jnp.uint32)  # 3 bits: 0,01
    hdr_bits = jnp.asarray([3], dtype=jnp.int32)
    eob_val = jnp.asarray([_FIXED_LIT_REV[256]], dtype=jnp.uint32)
    eob_bits = jnp.asarray([int(_FIXED_LIT_LEN[256])], dtype=jnp.int32)

    vals = jnp.concatenate([hdr_val, f0_val.astype(jnp.uint32), f1_val.astype(jnp.uint32), eob_val])
    bits = jnp.concatenate([hdr_bits, f0_bits, f1_bits, eob_bits])
    # Interleave: field order must be position-major (f0 then f1 per pos).
    # Build order indices: header, then for each pos its f0 then f1, then EOB.
    # Equivalent formulation: offsets computed from a position-major cumsum.
    f0b = f0_bits
    f1b = f1_bits
    per_pos = f0b + f1b
    base = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(per_pos)])  # N+1
    off_hdr = jnp.zeros(1, jnp.int32)
    off_f0 = 3 + base[:N]
    off_f1 = off_f0 + f0b
    off_eob = 3 + base[N]
    offsets = jnp.concatenate([off_hdr, off_f0, off_f1, off_eob[None]])

    total_bits = off_eob + eob_bits[0]
    # Align to byte, then append sync flush: 00 00 FF FF preceded by the
    # 3-bit empty-stored header (bfinal=0, btype=00) and its own align.
    # Empty stored block: 3 bits of zeros + pad to byte + LEN=0 NLEN=FFFF.
    total_bytes = (total_bits + 3 + 7) // 8  # token stream + stored header
    out = jnp.zeros(cap, dtype=jnp.int32)
    shifted = vals.astype(jnp.uint32) << (offsets % 8).astype(jnp.uint32)
    bytepos = offsets // 8
    valid_field = bits > 0
    for k in range(5):
        contrib = ((shifted >> jnp.uint32(8 * k)) & jnp.uint32(0xFF)).astype(jnp.int32)
        idx = jnp.where(valid_field, bytepos + k, cap - 1)
        contrib = jnp.where(valid_field, contrib, 0)
        out = out.at[jnp.clip(idx, 0, cap - 1)].add(contrib)
    # Stored-block LEN/NLEN at the aligned position.
    out = out.at[total_bytes].set(0)
    out = out.at[total_bytes + 1].set(0)
    out = out.at[total_bytes + 2].set(0xFF)
    out = out.at[total_bytes + 3].set(0xFF)
    out_len = total_bytes + 4
    out_u8 = (out & 0xFF).astype(jnp.uint8)

    # --- adler32 of the block (data-parallel, int32-safe) ----------------
    # Weighted sum stays in int32 by two-level modular reduction: products
    # are summed in groups of 64 (<= 64*255*65520 < 2^31), reduced mod M,
    # then the group sums (<= (N/64)*65520) are summed and reduced again.
    db = jnp.where(in_range, data.astype(jnp.int32), 0)
    s = jnp.sum(db)
    wmod = (jnp.maximum(n - pos_all, 0) % ADLER_MOD).astype(jnp.int32)
    prod = db * wmod
    group = jnp.sum(prod.reshape(-1, 64), axis=1) % ADLER_MOD
    w = jnp.sum(group) % ADLER_MOD
    a = (1 + s) % ADLER_MOD
    b = (n % ADLER_MOD + w) % ADLER_MOD
    adler = (b.astype(jnp.uint32) << 16) | a.astype(jnp.uint32)

    meta = jnp.stack([out_len.astype(jnp.int32), adler.astype(jnp.int32)])
    return out_u8, meta
