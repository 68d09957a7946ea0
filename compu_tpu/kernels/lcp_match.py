"""Lexicographic-sort LCP matcher (v4 LZ candidate stage).

The hash matcher (deflate_jax_v2._candidates_xla) sorts positions by a
16-bit trigram hash and scans d sorted neighbors, XOR/ctz-comparing the
full wcap-byte window at EVERY depth.

This stage replaces the hash with a CONTENT sort and the per-depth window
compare with an adjacent-LCP min-composition:

* positions sort lexicographically by their wcap-byte window (big-endian
  word keys in ``lax.sort``);
* ``adj[i]`` = matched bytes between sorted neighbors i-1, i — ONE window
  compare per position instead of one per (position, depth);
* the match length to ANY sorted neighbor composes by a running min:
  ``lcp(i, i-d) = min(adj[i-d+1..i])``. The inequality
  ``lcp(a, c) >= min(lcp(a, b), lcp(b, c))`` holds for arbitrary strings,
  so the composition never overstates a length (bytes are still verified
  by construction); the lexicographic order makes it exact. Deeper
  neighbors can therefore never beat a nearer one on LENGTH — the scan
  depth only improves the DISTANCE of equal-length matches (and covers
  window-validity misses), so small depths match hash-scan quality at a
  fraction of the work: ~8 dense ops per depth vs ~34 with 4 XOR/ctz
  window words.
* both sort-order directions are scanned (a position's nearest earlier
  occurrence can sort on either side).

Reference parity: this is the match-finding stage of DEFLATE/zstd/brotli
encoders that the reference reaches through libz's hash chains
(reference src/encoder/zlib.rs:90-92); the sorted-neighbor+LCP
formulation is the data-parallel equivalent (sorting networks + dense
min/compare instead of pointer-chasing hash chains).

Layout: flattened (B*N,) sorted arrays, per-block masking via ``adj = 0``
at block starts (a min-chain crossing a block boundary passes that 0 and
dies).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _lzb(x: jnp.ndarray) -> jnp.ndarray:
    """Leading zero BYTES of a u32 (0..4) via unsigned range compares."""
    return ((x <= jnp.uint32(0xFFFFFF)).astype(jnp.int32)
            + (x <= jnp.uint32(0xFFFF))
            + (x <= jnp.uint32(0xFF))
            + (x == jnp.uint32(0)))


def _adj_from_words(cur, prev):
    """Matched-byte count between two window tuples (BE words, MSB-first
    byte order): leading-zero-byte chain across words."""
    l = _lzb(cur[0] ^ prev[0])
    for k in range(1, len(cur)):
        lk = _lzb(cur[k] ^ prev[k])
        l = l + jnp.where(l == 4 * k, lk, 0)
    return l


def swap32(w: jnp.ndarray) -> jnp.ndarray:
    """Byte-swap u32 so unsigned compare == lexicographic byte order."""
    w = w.astype(jnp.uint32)
    return ((w & jnp.uint32(0xFF)) << 24) | ((w & jnp.uint32(0xFF00)) << 8) \
        | ((w >> 8) & jnp.uint32(0xFF00)) | (w >> 24)


def sort_stage_lex(data: jnp.ndarray, n: jnp.ndarray, *, wcap: int,
                   keys: int = 2, stride: int = 1):
    """Per-block lexicographic sort: returns (wbe..., ps) sort-order
    arrays. The first ``keys`` BE window words are sort keys (exact
    lexicographic order over 4*keys bytes); remaining words ride as
    payload so adj still measures up to wcap bytes. Sort cost grows
    steeply with key count (the comparator is a key-count-deep select
    chain), while order beyond the keyed prefix only tightens the
    already-conservative min-composition — 2 keys is the measured
    sweet spot. Payload is the position."""
    import os

    from .deflate_jax_v2 import _u32_words

    N = data.shape[0]
    del n  # tail positions carry pad-garbage windows; consumers clip
    pos_all = jnp.arange(N, dtype=jnp.int32)
    words = [swap32(_u32_words(data, k)) for k in range(wcap // 4)]
    if stride == 2:
        # anchor sampling: match STARTS restricted to even positions —
        # halves the sort/candidate/sort-back element count; the dist-1
        # run extension and lazy demotion still act at full resolution
        # downstream (zlib's fast-level tradeoff, re-expressed for sort
        # networks instead of hash probes)
        pos_all = pos_all[::2]
        words = [w[::2] for w in words]
    keys = int(os.environ.get("COMPU_LEX_KEYS", str(keys)))  # A/B override
    keys = min(keys, len(words))
    sorted_ops = jax.lax.sort((*words, pos_all), num_keys=keys,
                              is_stable=True)
    return sorted_ops  # (w0be..wkbe, ps)


def lcp_candidates_xla(sorted_ops, *, depth: int, max_dist: int,
                       block_elems: int):
    """Best (len_bytes, dist) per sorted lane by adjacent-LCP composition
    over both sort-order directions (dense rolls)."""
    import os

    *wbe, ps = sorted_ops
    N = ps.shape[0]
    ps = ps.astype(jnp.int32)
    gpos = jnp.arange(N, dtype=jnp.int32)
    lpos = gpos & (block_elems - 1)
    prev = tuple(jnp.roll(w, 1) for w in wbe)
    adj = _adj_from_words(tuple(wbe), prev)
    adj = jnp.where(lpos == 0, 0, adj)  # block boundary kills chains

    best_len = jnp.zeros(N, jnp.int32)
    best_dist = jnp.zeros(N, jnp.int32)

    prefer_far = os.environ.get("COMPU_LCP_TIE") == "far"

    def upd(best_len, best_dist, l, dist):
        valid = (dist > 0) & (dist <= max_dist) & (l > 0)
        if prefer_far:
            # decode-friendly: equal-length ties pick the FARTHEST source,
            # so match chains collapse toward the earliest occurrence
            # (shallow pointer-resolution graphs for the device decoder)
            tie = (l == best_len) & (dist > best_dist)
        else:
            tie = (l == best_len) & (dist < best_dist)
        better = valid & ((l > best_len) | tie)
        return (jnp.where(better, l, best_len),
                jnp.where(better, dist, best_dist))

    mb = adj
    mf = jnp.roll(adj, -1)
    mf = jnp.where(lpos == block_elems - 1, 0, mf)  # adj[N] read as next blk
    for d in range(1, depth + 1):
        dist_b = ps - jnp.roll(ps, d)
        best_len, best_dist = upd(best_len, best_dist, mb, dist_b)
        dist_f = ps - jnp.roll(ps, -d)
        best_len, best_dist = upd(best_len, best_dist, mf, dist_f)
        if d < depth:
            mb = jnp.minimum(mb, jnp.roll(adj, d))
            nxt = jnp.roll(adj, -(d + 1))
            nxt = jnp.where(lpos >= block_elems - (d + 1), 0, nxt)
            mf = jnp.minimum(mf, nxt)
    return best_len, best_dist
