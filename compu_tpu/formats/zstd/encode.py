"""Zstandard encoder (RFC 8878).

v1 strategy per 128 KiB block: LZ tokens from the shared data-parallel
matcher (formats/deflate/deflate_encode.tokenize — same hash-chain +
pointer-jump machinery, zstd just consumes (ll, offset, ml) triples),
Huffman-compressed literals (1- or 4-stream, raw fallback), sequences
FSE-coded with custom normalized tables (predefined fallback), RLE/raw
block fallbacks, optional xxhash64 content checksum.

Streams validated two ways in tests: decode-back by this package's own
decoder AND by the foreign `zstandard` (libzstd) oracle.
"""

from __future__ import annotations

import struct

import numpy as np

from ...ops.xxhash import xxh64
from ..base import CodecFailure
from ..deflate.deflate_encode import tokenize
from ..deflate.options import ZlibStrategy
from .fse import ForwardBitWriter, FseEncodeTable, write_norm_counts
from .huff import HufEncoder, normalize_counts
from . import tables as T

ZSTD_MAGIC = 0xFD2FB528
MAX_BLOCK = 128 * 1024


def _sequences_from_tokens(data, tok_pos, tok_len, tok_dist):
    """Collapse a token cover into zstd sequences (ll, offset, ml) plus the
    literal byte stream. Adjacent same-distance matches merge into one long
    sequence (the shared matcher caps matches at DEFLATE's 258; zstd match
    lengths are unbounded, so merging recovers long runs)."""
    from . import native_enc

    if len(tok_pos) > 512 and native_enc.available():
        r = native_enc.seq_from_tokens(bytes(data), tok_pos, tok_len, tok_dist)
        if r is not None:
            lits, (ll, off, ml) = r
            # (n, 3) array: downstream stages consume rows (ll, off, ml);
            # staying in numpy avoids O(n) list<->array round-trips.
            return lits, np.stack(
                [ll.astype(np.int64), off.astype(np.int64),
                 ml.astype(np.int64)], axis=1)
    lits = bytearray()
    seqs = []
    pending_lit = 0
    run_start = 0
    for p, l, d in zip(tok_pos, tok_len, tok_dist):
        if l == 0:
            if pending_lit == 0:
                run_start = p
            pending_lit += 1
        else:
            if (
                seqs
                and pending_lit == 0
                and seqs[-1][1] == int(d)
                and seqs[-1][2] + int(l) <= 131074  # ML code 52 ceiling
            ):
                seqs[-1] = (seqs[-1][0], seqs[-1][1], seqs[-1][2] + int(l))
            else:
                lits.extend(data[run_start : run_start + pending_lit])
                seqs.append((pending_lit, int(d), int(l)))
                pending_lit = 0
            run_start = p + l
    if pending_lit:
        lits.extend(data[run_start : run_start + pending_lit])
    return bytes(lits), seqs


# --- zstd-native optimal parse (btopt-style squeeze) -----------------------
# Match lengths 3..258 -> ML code / extra bits (the shared matcher caps at
# DEFLATE's 258; longer runs are recovered by the same-distance merge above).
_ML_CODE_LEN = np.zeros(259, dtype=np.int64)
for _l in range(3, 259):
    _ML_CODE_LEN[_l] = T.ml_code(_l)
_ML_XBITS_LEN = T.ML_BITS[_ML_CODE_LEN]
# Candidate sublengths: every length <= 67 (cost[i+l] varies within a code
# bucket even when the code cost doesn't), then the code-base boundaries.
_ML_SUBLENS = sorted(set(list(range(3, 68)) + [int(b) for b in T.ML_BASE if b <= 258]))


def _parse_effort(level: int):
    """Effort ladder for the high strategies: deeper chain walks + more
    pareto slots (the btopt/btultra analogue; depth is the dominant ratio
    lever)."""
    if level >= 22:
        return 5, 2048
    if level >= 19:
        return 5, 512
    if level >= 15:
        return 5, 128
    if level >= 12:
        return 3, 64
    return 1, 0


def _zstd_optimal_tokens(full: np.ndarray, hist_len: int, level: int,
                         max_dist: int, data_len: int | None = None,
                         matches=None, rep_in=None):
    """Iterated cost-model parse with zstd-native prices: literal cost from
    an 11-bit-capped Huffman estimate, match cost = ML code FSE cost + extra
    bits + OF code cost + offset bits + amortized LL channel cost. Two
    Zopfli-style rounds (stats from the previous parse). ``full`` includes
    ``hist_len`` window bytes from previous blocks; tokens are returned for
    the region past the history (distances may reach into it — RFC 8878
    windows span block boundaries). ``data_len`` bounds the parsed region
    (sub-block splitting); ``matches`` injects precomputed pareto
    candidates over ``full`` so split blocks share ONE chain walk."""
    from ...ops.huffman import length_limited_lengths
    from ..deflate.deflate_encode import _greedy_tokens, find_matches_k

    K, depth = _parse_effort(level)
    if matches is None:
        matches = find_matches_k(
            full, min(level, 9), max_dist, K=K, depth=depth,
            deflate_heuristics=False,
        )
    lens_fk, dists_fk = matches
    end = len(full) if data_len is None else hist_len + data_len
    data = full[hist_len:end]
    full = full[:end]
    n = len(data)
    lens_k = np.asarray(lens_fk[hist_len:end], dtype=np.int64)
    dists_k = np.asarray(dists_fk[hist_len:end], dtype=np.int64)
    # Matches must not run past the block end (zstd sequences reproduce
    # exactly one block) — clamp, and drop below the 3-byte minimum.
    room = n - np.arange(n)
    lens_k = np.minimum(lens_k, room[:, None])
    lens_k[lens_k < 3] = 0
    # Longest candidate (slot of max length) seeds the greedy parse.
    top = np.argmax(lens_k, axis=1)
    rows = np.arange(len(lens_k))
    lens = lens_k[rows, top]
    dists = dists_k[rows, top]
    tok = _greedy_tokens(data, lens, dists)
    if n <= 16:
        return tok
    # Extremely repetitive blocks (mean token span > 64 bytes): the greedy
    # cover is already nearly all max-length matches and the per-position
    # sublength DP would grind O(n * |sublens| * rounds) for <0.1% gain.
    if len(tok[0]) * 64 < n:
        return tok
    from . import native_enc

    use_native = native_enc.available()
    # Offset codes per candidate (value = offset+3; repeat slots are priced
    # by the channel stats, not per-position). bit_length via searchsorted
    # over powers of two.
    occ_k = np.searchsorted(_POW2, np.maximum(dists_k, 1) + 3, side="right") - 1

    def chan_cost(codes, nsym):
        f = np.bincount(codes, minlength=nsym).astype(np.float64)
        tot = max(f.sum(), 1.0)
        return np.minimum(np.where(f > 0, -np.log2(np.maximum(f, 1) / tot), 15.0), 15.0)

    rounds = 4 if level >= 22 else (3 if level >= 15 else 2)
    for _ in range(rounds):
        lits, seqs = _sequences_from_tokens(data, *tok)
        if len(seqs) == 0:
            break
        seqs = _promote_rep_offsets(full, hist_len, seqs, rep_in)
        lf = np.bincount(np.frombuffer(lits, np.uint8), minlength=256)
        if len(lits) >= 32:
            ll_ = length_limited_lengths(lf, 11).astype(np.float64)
            ll_[ll_ == 0] = 12.0
        else:
            ll_ = np.full(256, 8.0)
        sa = np.asarray(seqs, dtype=np.int64)
        rov = native_enc.resolve_offsets(sa[:, 0], sa[:, 1], rep_in) \
            if use_native else None
        if rov is not None:
            of_vals = rov[0]
        else:
            of_vals = np.int64(_resolve_offset_values(seqs, rep_in)[0])
        of_codes = np.searchsorted(_POW2, of_vals, side="right") - 1
        ml_a, ll_a = sa[:, 2], sa[:, 0]
        ml_codes = np.where(
            ml_a < 35, ml_a - 3, np.searchsorted(T.ML_BASE, ml_a, side="right") - 1)
        ll_codes = np.where(
            ll_a < 16, ll_a, np.searchsorted(T.LL_BASE, ll_a, side="right") - 1)
        ofc = chan_cost(of_codes, 32)
        mlc = chan_cost(ml_codes, 53)
        llc = chan_cost(ll_codes, 36)
        # LL channel split: each sequence pays the ll=0 code (the common
        # back-to-back-match case); the surplus (nonzero-run codes + extra
        # bits) is amortized over the literals that create those runs.
        # Charging the channel MEAN per match instead overprices matches
        # and was worth ~1% on text.
        llc0 = float(llc[0])
        ll_tot = float(np.sum(llc[ll_codes] + T.LL_BITS[ll_codes]))
        lit_extra = max(0.0, (ll_tot - len(seqs) * llc0) / max(len(lits), 1))
        ll_avg = llc0
        mlcost_arr = mlc[_ML_CODE_LEN[3:]] + _ML_XBITS_LEN[3:]  # [l-3]
        dc_arr = ofc[np.clip(occ_k, 0, 31)] + occ_k + ll_avg  # (n, K)
        # Repeat-offset match price: OF value 1 -> code 0, zero extra bits.
        rep_dc = float(ofc[0]) + ll_avg
        if use_native:
            # Native DP (csrc/compu_zstd_enc.cpp), identical relax loop.
            r = native_enc.optimal_parse(
                full.tobytes(), hist_len, n, lens_k, dists_k,
                ll_ + lit_extra, mlcost_arr, dc_arr, rep_dc,
                _ML_SUBLENS, rep_in[0] if rep_in else 1)
            if r is not None:
                tok = r
                continue
        litcost = (ll_ + lit_extra).tolist()
        mlcost_len = mlcost_arr.tolist()
        dc_k = dc_arr.tolist()
        full_l = full.tolist()
        lens_kl = lens_k.tolist()
        dists_kl = dists_k.tolist()
        data_l = data.tolist()
        INF = 1e18
        # Forward DP with arrival rep0 state (btultra-style): a position's
        # best path carries the rep0 its predecessor match established, and
        # a same-distance (rep0) match is offered as an extra candidate
        # priced at the ~1-bit repeat code — this is what makes short
        # matches profitable and is where libzstd's parse wins on text.
        cost = [INF] * (n + 1)
        cost[0] = 0.0
        rep0 = [rep_in[0] if rep_in else 1] * (n + 1)
        plen = [0] * (n + 1)
        pdist = [0] * (n + 1)

        def relax(j, c, r, l, d):
            if c < cost[j]:
                cost[j] = c
                rep0[j] = r
                plen[j] = l
                pdist[j] = d

        rep_memo_r = -1
        rep_memo_l = 0
        rep_memo_i = -10
        for i in range(n):
            ci = cost[i]
            r0 = rep0[i]
            # literal step
            relax(i + 1, ci + litcost[data_l[i]], r0, 0, 0)
            # rep0 match measured on the fly (may reach into the history).
            # Carry memo keeps this O(n) on run-heavy data: with the same
            # rep distance, matchlen(i+1) == matchlen(i) - 1 exactly —
            # unless the previous scan hit the cap, where it re-extends
            # from cap-1 (a constant number of compares per position).
            src = hist_len + i - r0
            if src >= 0:
                dst = hist_len + i
                lmax = min(258, n - i)
                if r0 == rep_memo_r and rep_memo_i == i - 1 and rep_memo_l > 0:
                    l = rep_memo_l - 1
                    if rep_memo_l >= 258:
                        while l < lmax and full_l[src + l] == full_l[dst + l]:
                            l += 1
                    l = min(l, lmax)
                else:
                    l = 0
                    while l < lmax and full_l[src + l] == full_l[dst + l]:
                        l += 1
                rep_memo_r, rep_memo_l, rep_memo_i = r0, l, i
                if l >= 3:
                    dc = rep_dc
                    relax(i + l, ci + mlcost_len[l - 3] + dc, r0, l, r0)
                    for lb in _ML_SUBLENS:
                        if lb >= l:
                            break
                        relax(i + lb, ci + mlcost_len[lb - 3] + dc, r0, lb, r0)
            # finder candidates (pareto slots, nearest-first)
            row_l = lens_kl[i]
            row_d = dists_kl[i]
            row_c = dc_k[i]
            prev_l = 2  # shorter sublengths are covered by closer slots
            for k in range(K):
                L = row_l[k]
                if L < 3 or L <= prev_l:
                    continue
                D = row_d[k]
                dc = row_c[k]
                relax(i + L, ci + mlcost_len[L - 3] + dc, D, L, D)
                for lb in _ML_SUBLENS:
                    if lb >= L:
                        break
                    if lb <= prev_l:
                        continue
                    relax(i + lb, ci + mlcost_len[lb - 3] + dc, D, lb, D)
                prev_l = L
        # Backtrack the chosen cover.
        pos_r, tl_r, td_r = [], [], []
        j = n
        while j > 0:
            l = plen[j]
            if l:
                pos_r.append(j - l)
                tl_r.append(l)
                td_r.append(pdist[j])
                j -= l
            else:
                pos_r.append(j - 1)
                tl_r.append(0)
                td_r.append(0)
                j -= 1
        tok = (
            np.asarray(pos_r[::-1], dtype=np.int64),
            np.asarray(tl_r[::-1], dtype=np.int64),
            np.asarray(td_r[::-1], dtype=np.int64),
        )
    return tok


def _promote_rep_offsets(full: np.ndarray, hist_len: int, seqs, rep=None):
    """Swap a match's offset for a repeat-history distance when the same
    bytes exist there (elementwise compare on the true data is exact even
    for overlapping copies): an OF code drops from ~oc+4 bits to ~1-3.
    Tracks the 3-slot history exactly as the decoder does, including the
    ll==0 slot rotation (decode.py::_execute_sequences); ``rep`` is the
    incoming frame-persistent ring."""
    from . import native_enc

    if len(seqs) > 64 and native_enc.available():
        r = native_enc.promote_rep(full.tobytes(), hist_len, seqs, rep)
        if r is not None:
            return r
    rep = list(rep) if rep is not None else [1, 4, 8]
    pos = hist_len
    out = []
    nfull = len(full)
    for ll, off, ml in seqs:
        pos += ll
        new_off = off
        cands = (rep[0], rep[1], rep[2]) if ll != 0 else (rep[1], rep[2], rep[0] - 1)
        for rd in cands:
            if rd == off:
                break  # already coded as a (cheaper or equal) repeat
            if rd <= 0 or pos - rd < 0 or pos + ml > nfull:
                continue
            if np.array_equal(full[pos - rd : pos - rd + ml], full[pos : pos + ml]):
                new_off = rd
                break
        out.append((ll, new_off, ml))
        # History update, identical to _resolve_offset_values/decoder.
        if ll != 0:
            if new_off == rep[0]:
                val = 1
            elif new_off == rep[1]:
                val = 2
            elif new_off == rep[2]:
                val = 3
            else:
                val = new_off + 3
        else:
            if new_off == rep[1]:
                val = 1
            elif new_off == rep[2]:
                val = 2
            elif new_off == rep[0] - 1 and new_off > 0:
                val = 3
            else:
                val = new_off + 3
        if val > 3:
            rep = [new_off, rep[0], rep[1]]
        else:
            idx = val - 1 + (1 if ll == 0 else 0)
            if idx == 1:
                rep = [new_off, rep[0], rep[2]]
            elif idx >= 2:
                rep = [new_off, rep[0], rep[1]]
        pos += ml
    return out


def _tokens_with_history(full: np.ndarray, hist_len: int, level: int,
                         max_dist: int):
    """Token cover of ``full[hist_len:]`` with matches allowed to reach into
    the history prefix (cross-block window, RFC 8878 §3.1.1.2.2)."""
    if level >= 9:
        return _zstd_optimal_tokens(full, hist_len, level, max_dist)
    from ..deflate.deflate_encode import _greedy_tokens, find_matches

    lens_f, dists_f = find_matches(full, level, ZlibStrategy.Default, max_dist)
    data = full[hist_len:]
    return _greedy_tokens(data, lens_f[hist_len:], dists_f[hist_len:])


def _literals_section(lits: bytes, reuse: dict | None = None,
                      device: bool = False) -> bytes:
    """Literals section: huffman when profitable, else raw. With ``reuse``
    (stream-state dict), a previous block's tree may be reused treeless
    (Literals_Block_Type 3 — no table description) when it covers the
    current bytes and beats a fresh tree + description."""
    n = len(lits)
    if n >= 32:
        try:
            freqs = np.bincount(np.frombuffer(lits, np.uint8), minlength=256)
            enc = HufEncoder(freqs)
            desc = enc.describe()
            lit_type = 2
            prev = reuse.get("huf") if reuse else None
            if prev is not None:
                covered = all(
                    s <= prev.max_symbol and prev.nbits[s] > 0
                    for s in np.nonzero(freqs)[0]
                )
                if covered:
                    prev_bits = int(np.sum(freqs[: prev.max_symbol + 1]
                                           * prev.nbits))
                    new_bits = len(desc) * 8 + int(np.sum(
                        freqs * np.where(
                            np.arange(256) <= enc.max_symbol,
                            np.concatenate([
                                enc.nbits,
                                np.zeros(256 - enc.max_symbol - 1, np.int32),
                            ]),
                            0,
                        )
                    ))
                    if prev_bits <= new_bits:
                        enc = prev
                        desc = b""
                        lit_type = 3
            def commit():
                if reuse is not None and lit_type == 2:
                    reuse["huf"] = enc

            if n <= 1023:
                stream = enc.encode_stream(lits)
                payload = desc + stream
                comp = len(payload)
                if comp < n and comp <= 1023:
                    # size_format 00: single stream, 10+10 bits
                    commit()
                    b0 = lit_type | (0 << 2) | ((n & 0xF) << 4)
                    b1 = (n >> 4) | ((comp & 3) << 6)
                    b2 = comp >> 2
                    return bytes([b0, b1, b2]) + payload
            else:
                per = (n + 3) // 4
                counts = [per, per, per, n - 3 * per]
                chunks = []
                off = 0
                for c in counts:
                    chunks.append(lits[off : off + c])
                    off += c
                if device:
                    # Device 4-stream Huffman pack (byte-identical to the
                    # host writer; kernels/zstd_literals_jax.py).
                    from ...kernels.zstd_literals_jax import encode_streams_device

                    streams = encode_streams_device(chunks, enc.code, enc.nbits)
                else:
                    streams = [enc.encode_stream(c) for c in chunks]
                jump = struct.pack(
                    "<HHH", len(streams[0]), len(streams[1]), len(streams[2])
                )
                payload = desc + jump + b"".join(streams)
                comp = len(payload)
                if comp < n:
                    commit()
                    if n <= 16383 and comp <= 16383:
                        # size_format 10: 14+14 bits
                        b0 = lit_type | (2 << 2) | ((n & 0xF) << 4)
                        b1 = (n >> 4) & 0xFF
                        b2 = ((n >> 12) & 3) | ((comp & 0x3F) << 2)
                        b3 = (comp >> 6) & 0xFF
                        return bytes([b0, b1, b2, b3]) + payload
                    # size_format 11: 18+18 bits
                    b0 = lit_type | (3 << 2) | ((n & 0xF) << 4)
                    b1 = (n >> 4) & 0xFF
                    b2 = ((n >> 12) & 0x3F) | ((comp & 3) << 6)
                    b3 = (comp >> 2) & 0xFF
                    b4 = (comp >> 10) & 0xFF
                    return bytes([b0, b1, b2, b3, b4]) + payload
        except CodecFailure:
            pass
    # Raw literals.
    if n < 32:
        if n <= 31:
            return bytes([0 | (0 << 2) | (n << 3)]) + lits
    if n <= 4095:
        b0 = 0 | (1 << 2) | ((n & 0xF) << 4)
        return bytes([b0, n >> 4]) + lits
    b0 = 0 | (3 << 2) | ((n & 0xF) << 4)
    return bytes([b0, (n >> 4) & 0xFF, (n >> 12) & 0xFF]) + lits


def _offset_code(offset_value: int) -> int:
    return int(offset_value).bit_length() - 1


def _fse_bits(freqs, norm, log) -> float:
    """Estimated FSE bits for ``freqs`` occurrences under a normalized
    table (−1 entries are the RFC 'less than 1' probability ≈ 2^-log)."""
    narr = np.asarray(norm, dtype=np.float64)
    p = np.where(narr == -1, 1.0, narr)
    nb = log - np.log2(np.maximum(p, 1.0))
    f = np.asarray(freqs[: len(narr)], dtype=np.float64)
    if np.any((f > 0) & (p <= 0)):
        return float("inf")
    return float(np.sum(f * nb))


class _SeqTable:
    """One sequence channel's chosen coding: RLE / predefined / custom /
    repeat (mode 3 reuses the previous block's table — zero header). The
    choice minimizes estimated bits (header + payload); ``reuse`` carries
    the cross-block stream state keyed by channel name."""

    def __init__(self, codes, default_dist, default_log, max_symbol, max_log,
                 reuse: dict | None = None, chan: str | None = None):
        self.codes = codes
        codes_a = np.asarray(codes, dtype=np.int64)
        freqs = np.bincount(codes_a, minlength=max_symbol + 1)
        uniq = np.nonzero(freqs)[0]
        cands = []  # (bits, mode, header, enc, new_state)
        if len(uniq) == 1:
            cands.append((8.0, 1, bytes([int(codes_a[0])]), None, None))
        norm, log = normalize_counts(freqs, len(codes_a), max_log)
        if norm is not None:
            try:
                enc = FseEncodeTable(norm, log)
                header = write_norm_counts(norm, log)
                cands.append((
                    len(header) * 8 + _fse_bits(freqs, norm, log),
                    2, header, enc, (enc, norm, log),
                ))
            except CodecFailure:
                pass
        dd = np.asarray(default_dist, dtype=np.int64)
        if uniq[-1] < len(dd) and np.all(dd[uniq] != 0):
            denc = FseEncodeTable(default_dist, default_log)
            cands.append((
                _fse_bits(freqs, default_dist, default_log),
                0, b"", denc, (denc, default_dist, default_log),
            ))
        prev = reuse.get(chan) if reuse else None
        if prev is not None:
            penc, pnorm, plog = prev
            pn = np.asarray(pnorm, dtype=np.int64)
            if uniq[-1] < len(pn) and np.all(pn[uniq] != 0):
                cands.append((_fse_bits(freqs, pnorm, plog), 3, b"", penc, prev))
        if not cands:
            raise CodecFailure(299, "cannot code sequence channel")
        bits, self.mode, self.header, self.enc, new_state = min(
            cands, key=lambda t: t[0]
        )
        if reuse is not None:
            reuse[chan] = new_state  # RLE clears it (repeat-after-RLE unsupported)


def _resolve_offset_values(seqs, rep=None):
    """Repeat-offset resolution: mirror the decoder's 3-slot history
    (decode.py::_execute_sequences) so recent distances cost ~1 bit.
    ``rep`` is the incoming ring — it PERSISTS across blocks within a
    frame (decoder state), so multi-block encoders must thread it.
    Returns (OF values (1..3 = repeat slots, else offset+3), final ring)."""
    of_values = []
    rep = list(rep) if rep is not None else [1, 4, 8]
    for ll, off, _ in seqs:
        if ll != 0:
            if off == rep[0]:
                val = 1
            elif off == rep[1]:
                val = 2
            elif off == rep[2]:
                val = 3
            else:
                val = off + 3
        else:
            if off == rep[1]:
                val = 1
            elif off == rep[2]:
                val = 2
            elif off == rep[0] - 1 and off > 0:
                val = 3
            else:
                val = off + 3
        of_values.append(val)
        # History update (identical to the decoder).
        if val > 3:
            rep = [off, rep[0], rep[1]]
        else:
            idx = val - 1 + (1 if ll == 0 else 0)
            if idx == 1:
                rep = [off, rep[0], rep[2]]
            elif idx >= 2:
                rep = [off, rep[0], rep[1]]
            # idx == 0: unchanged
    return of_values, rep


_POW2 = np.left_shift(np.int64(1), np.arange(63, dtype=np.int64))


def _sequences_section(seqs, reuse: dict | None = None,
                       device: bool = False) -> bytes:
    from . import native_enc

    n = len(seqs)
    out = bytearray()
    if n < 128:
        out.append(n)
    elif n < 0x7F00:
        out.append((n >> 8) + 128)
        out.append(n & 0xFF)
    else:
        out.append(255)
        out.append((n - 0x7F00) & 0xFF)
        out.append((n - 0x7F00) >> 8)
    if n == 0:
        return bytes(out)

    rep_in = reuse.get("rep") if reuse else None
    use_native = n > 64 and native_enc.available()
    if use_native:
        # Vectorized channel codes + native repeat-offset resolution (the
        # pure-Python twins below stay the reference implementation).
        sa = np.asarray(seqs, dtype=np.int64)
        ll_a, off_a, ml_a = sa[:, 0], sa[:, 1], sa[:, 2]
        ll_codes_a = np.where(
            ll_a < 16, ll_a, np.searchsorted(T.LL_BASE, ll_a, side="right") - 1)
        ml_codes_a = np.where(
            ml_a < 35, ml_a - 3, np.searchsorted(T.ML_BASE, ml_a, side="right") - 1)
        of_values_a, rep_out = native_enc.resolve_offsets(ll_a, off_a, rep_in)
        of_codes_a = np.searchsorted(_POW2, of_values_a, side="right") - 1
        ll_codes, ml_codes = ll_codes_a, ml_codes_a
        of_codes, of_values = of_codes_a, of_values_a
    else:
        ll_codes = [T.ll_code(ll) for ll, _, _ in seqs]
        of_values, rep_out = _resolve_offset_values(seqs, rep_in)
        of_codes = [_offset_code(v) for v in of_values]
        ml_codes = [T.ml_code(ml) for _, _, ml in seqs]
    if reuse is not None:
        reuse["rep"] = rep_out

    ll_t = _SeqTable(ll_codes, T.LL_DEFAULT_DIST, T.LL_DEFAULT_LOG,
                     T.MAX_LL_SYMBOL, T.MAX_LL_LOG, reuse, "ll")
    of_t = _SeqTable(of_codes, T.OF_DEFAULT_DIST, T.OF_DEFAULT_LOG,
                     T.MAX_OF_SYMBOL, T.MAX_OF_LOG, reuse, "of")
    ml_t = _SeqTable(ml_codes, T.ML_DEFAULT_DIST, T.ML_DEFAULT_LOG,
                     T.MAX_ML_SYMBOL, T.MAX_ML_LOG, reuse, "ml")
    out.append((ll_t.mode << 6) | (of_t.mode << 4) | (ml_t.mode << 2))
    out.extend(ll_t.header)
    out.extend(of_t.header)
    out.extend(ml_t.header)

    if device:
        # Device twin of the push loop below: interleaved FSE state scan +
        # bit pack on device, byte-identical (kernels/zstd_seq_jax.py).
        blob = _sequences_bitstream_device(
            seqs, ll_codes, ml_codes, of_codes, of_values, ll_t, ml_t, of_t)
        if blob is not None:
            out.extend(blob)
            return bytes(out)

    if use_native:
        # Native twin of the push loop below (csrc/compu_zstd_enc.cpp),
        # byte-identical.
        ll_x = ll_a - T.LL_BASE[ll_codes_a]
        ll_xb = T.LL_BITS[ll_codes_a]
        ml_x = ml_a - T.ML_BASE[ml_codes_a]
        ml_xb = T.ML_BITS[ml_codes_a]
        of_x = of_values_a - _POW2[of_codes_a]
        blob = native_enc.seq_bitstream(
            ll_codes_a, ml_codes_a, of_codes_a, ll_x, ll_xb, ml_x, ml_xb,
            of_x, of_codes_a, ll_t.enc, ml_t.enc, of_t.enc)
        if blob is not None:
            out.extend(blob)
            return bytes(out)

    # Bitstream: ForwardBitWriter; push order is the exact reverse of the
    # decoder's read order (see decode.py::_execute_sequences).
    w = ForwardBitWriter()
    last = n - 1
    ll_state = ll_t.enc.init_state(ll_codes[last]) if ll_t.enc else None
    ml_state = ml_t.enc.init_state(ml_codes[last]) if ml_t.enc else None
    of_state = of_t.enc.init_state(of_codes[last]) if of_t.enc else None

    def push_extras(i):
        ll, off, ml = seqs[i]
        oc = of_codes[i]
        # reverse of read order (of_x, ml_x, ll_x) -> push ll, ml, of
        w.push(ll - int(T.LL_BASE[ll_codes[i]]), int(T.LL_BITS[ll_codes[i]]))
        w.push(ml - int(T.ML_BASE[ml_codes[i]]), int(T.ML_BITS[ml_codes[i]]))
        w.push(of_values[i] - (1 << oc), oc)

    push_extras(last)
    for i in range(last - 1, -1, -1):
        # Updates are read llu, mlu, ofu after seq i's extras; push reversed:
        # of, ml, ll updates first, then the extras of seq i.
        if of_t.enc:
            of_state = of_t.enc.encode(of_state, of_codes[i], w)
        if ml_t.enc:
            ml_state = ml_t.enc.encode(ml_state, ml_codes[i], w)
        if ll_t.enc:
            ll_state = ll_t.enc.encode(ll_state, ll_codes[i], w)
        push_extras(i)
    # Init-state flushes: decoder reads ll, of, ml first -> push ml, of, ll.
    if ml_t.enc:
        ml_t.enc.flush(ml_state, w)
    if of_t.enc:
        of_t.enc.flush(of_state, w)
    if ll_t.enc:
        ll_t.enc.flush(ll_state, w)
    out.extend(w.finish())
    return bytes(out)


def _sequences_bitstream_device(seqs, ll_codes, ml_codes, of_codes,
                                of_values, ll_t, ml_t, of_t):
    """Prepare the per-sequence arrays and run the device FSE scan + pack.
    Returns None (host path) when an offset's extra field exceeds the
    pack's 4-byte lanes (window_log > ~24)."""
    of_xb = [_offset_code(v) for v in of_values]
    if of_xb and max(of_xb) > 24:
        return None
    ll_x = [ll - int(T.LL_BASE[c]) for (ll, _, _), c in zip(seqs, ll_codes)]
    ll_xbits = [int(T.LL_BITS[c]) for c in ll_codes]
    ml_x = [ml - int(T.ML_BASE[c]) for (_, _, ml), c in zip(seqs, ml_codes)]
    ml_xbits = [int(T.ML_BITS[c]) for c in ml_codes]
    of_x = [v - (1 << oc) for v, oc in zip(of_values, of_xb)]
    from ...kernels.zstd_seq_jax import encode_sequences_device

    return encode_sequences_device(
        ll_codes, ml_codes, of_codes, ll_x, ml_x, of_x,
        ll_xbits, ml_xbits, of_xb, ll_t.enc, ml_t.enc, of_t.enc)


def compress_block(data: bytes, level: int, max_dist: int = MAX_BLOCK,
                   tokenizer=None, history: bytes = b"",
                   reuse: dict | None = None, matches=None,
                   device_literals: bool = False,
                   device_sequences: bool = False) -> bytes:
    """One zstd block body (compressed type), or raw/RLE when better.
    Returns the full block including its 3-byte header. ``history`` is the
    window tail of previous blocks: matches may reference it (the decoder's
    window spans block boundaries)."""
    n = len(data)
    assert 0 < n <= MAX_BLOCK

    def header(btype, size, last=0):
        h = last | (btype << 1) | (size << 3)
        return struct.pack("<I", h)[:3]

    if data.count(data[0]) == n:  # RLE
        return header(1, n) + data[:1]

    arr = np.frombuffer(data, dtype=np.uint8)
    if tokenizer is not None:
        tok_pos, tok_len, tok_dist = tokenizer(data)
    elif history and level < 9:
        full = np.frombuffer(history + data, dtype=np.uint8)
        tok_pos, tok_len, tok_dist = _tokens_with_history(
            full, len(history), level, max_dist
        )
    elif history or level >= 9 or matches is not None:
        full = np.frombuffer(history + data, dtype=np.uint8) if history else arr
        tok_pos, tok_len, tok_dist = _zstd_optimal_tokens(
            full, len(history), level, max_dist, matches=matches,
            rep_in=reuse.get("rep") if reuse else None,
        )
    else:
        strategy = ZlibStrategy.Default
        tok_pos, tok_len, tok_dist = tokenize(arr, min(level, 9), strategy, max_dist)
    lits, seqs = _sequences_from_tokens(arr, tok_pos, tok_len, tok_dist)
    local = dict(reuse) if reuse is not None else None
    if len(seqs) and level >= 5 and tokenizer is None:
        fullarr = np.frombuffer(history + data, dtype=np.uint8) if history else arr
        seqs = _promote_rep_offsets(fullarr, len(history), seqs,
                                    local.get("rep") if local else None)
    try:
        body = (_literals_section(lits, local, device=device_literals)
                + _sequences_section(seqs, local,
                                     device=device_sequences))
    except CodecFailure:
        body = None
    if body is None or len(body) >= n:
        # Raw block: decoder entropy state is untouched, so drop the
        # tentative reuse updates.
        return header(0, n) + data
    if reuse is not None:
        reuse.clear()
        reuse.update(local)
    return header(2, len(body)) + body


def _slice_token_cover(tok_pos, tok_len, tok_dist, off: int, end: int):
    """Block-local view [off, end) of a chunk-level token cover, positions
    rebased to the block. Matches crossing either boundary are split: the
    in-block fragment keeps its distance (still valid — the distance was
    legal at the match's earlier start, and the decoder's window spans
    frame blocks); fragments under MIN_MATCH become literal tokens."""
    tok_pos = np.asarray(tok_pos, dtype=np.int64)
    tok_len = np.asarray(tok_len, dtype=np.int64)
    tok_dist = np.asarray(tok_dist, dtype=np.int64)
    sel = (tok_pos < end) & (tok_pos + np.maximum(tok_len, 1) > off)
    p = tok_pos[sel]
    l = tok_len[sel]
    d = tok_dist[sel]
    is_m = l > 0
    new_p = np.maximum(p, off)
    new_l = np.where(is_m, np.minimum(p + l, end) - new_p, 0)
    keep_m = new_l >= 3
    small = is_m & ~keep_m  # 1-2 byte boundary fragments -> literals
    lit1 = new_p[~is_m]
    sp, sl = new_p[small], new_l[small]
    if len(sp):
        tot = int(sl.sum())
        lit2 = np.repeat(sp, sl) + (np.arange(tot)
                                    - np.repeat(np.cumsum(sl) - sl, sl))
    else:
        lit2 = np.zeros(0, np.int64)
    mp, ml, md = new_p[keep_m], new_l[keep_m], d[keep_m]
    nlit = len(lit1) + len(lit2)
    pos = np.concatenate([lit1, lit2, mp])
    ln = np.concatenate([np.zeros(nlit, np.int64), ml])
    dist = np.concatenate([np.zeros(nlit, np.int64), md])
    order = np.argsort(pos, kind="stable")
    return pos[order] - off, ln[order], dist[order]


class ZstdStreamEncoder:
    """Frame-level streaming encoder (hooks for the pipeline backend)."""

    #: Strategy -> effective parse level (libzstd ZSTD_c_strategy override
    #: semantics, reference src/encoder/zstd.rs:121): the strategy picks the
    #: match-finder/parse ladder rung regardless of level.
    _STRATEGY_PARSE_LEVEL = {
        "Fast": 1, "DFast": 3, "Greedy": 4, "Lazy": 6, "Lazy2": 8,
        "BtLazy2": 10, "BtOpt": 15, "BtUltra": 19, "BtUltra2": 22,
    }

    def __init__(self, level: int = 3, checksum: bool = True,
                 window_log: int = 17, device_lz: bool = False,
                 strategy=None, device_literals: bool = False,
                 device_sequences: bool = False) -> None:
        self.device_literals = device_literals
        self.device_sequences = device_sequences
        self.level = level
        # Effective parse level: strategy overrides; level 0 is the default
        # ladder rung (3); negative levels all take the fastest greedy rung.
        if strategy is not None and strategy.name != "Default":
            self.parse_level = self._STRATEGY_PARSE_LEVEL[strategy.name]
        elif level == 0:
            self.parse_level = 3
        elif level < 0:
            self.parse_level = 1
        else:
            self.parse_level = level
        self.checksum = checksum
        self.window_log = window_log
        self.tokenizer = None
        if device_lz:
            from ..device_lz import DeviceTokenizer

            # Tokenize 8 frame blocks per device call (one dispatch and
            # one transfer round trip per MiB instead of per 128 KiB);
            # compress_chunk slices the token cover per frame block.
            # Matches stay within the window cap, so cross-frame-block
            # distances remain legal zstd (the decoder's window spans
            # blocks).
            self.tokenizer_span = 8 * MAX_BLOCK
            self.tokenizer = DeviceTokenizer(
                self.tokenizer_span, min((1 << window_log) - 1, MAX_BLOCK)
            )
        self.reset()

    def reset(self) -> None:
        self._hash_buf = bytearray()
        self._blocks: list[bytes] = []
        self._window = b""
        self._reuse: dict = {}

    def header(self) -> bytes:
        fhd = 0
        if self.checksum:
            fhd |= 0x04
        # No content size (streaming), window descriptor present.
        exponent = self.window_log - 10
        wd = exponent << 3
        return struct.pack("<IBB", ZSTD_MAGIC, fhd, wd)

    def compress_chunk(self, data: bytes, final: bool) -> bytes:
        """Compress up to MAX_BLOCK input bytes as one or more frame blocks.

        High levels split into ~32 KiB blocks: per-block entropy tables
        adapt locally (the window still spans blocks, and repeat-mode
        tables / treeless literals reuse state when a block's statistics
        don't change) — worth ~1% on text vs monolithic 128 KiB blocks."""
        out = bytearray()
        if self.checksum:
            self._hash_buf.extend(data)
        if not data:
            # Empty final block (raw, size 0).
            out.extend(struct.pack("<I", 1 | (0 << 1) | 0)[:3])
            return bytes(out)
        if self.tokenizer is not None and len(data) > MAX_BLOCK:
            # One device tokenizer call over the whole staged chunk, then
            # one frame block per MAX_BLOCK slice of the token cover.
            tok_pos, tok_len, tok_dist = self.tokenizer(data)
            for off in range(0, len(data), MAX_BLOCK):
                end = min(off + MAX_BLOCK, len(data))
                sub = _slice_token_cover(tok_pos, tok_len, tok_dist, off, end)
                blob = compress_block(
                    data[off:end], self.parse_level,
                    max_dist=min((1 << self.window_log) - 1, MAX_BLOCK),
                    tokenizer=lambda d, s=sub: s,
                    reuse=self._reuse,
                    device_literals=self.device_literals,
                    device_sequences=self.device_sequences,
                )
                if final and end >= len(data):
                    blob = bytes([blob[0] | 1]) + blob[1:]
                out.extend(blob)
            return bytes(out)
        if self.tokenizer is None and self.parse_level >= 12 and len(data) > 49152:
            from ..deflate.deflate_encode import find_matches_k

            bs = 32768 if self.parse_level >= 15 else 65536
            # ONE chain walk over (window + whole chunk); every sub-block
            # parses against slices of it (the DP clamps lengths to its
            # own block end), instead of re-hashing the history per block.
            window0 = self._window if self.parse_level >= 5 else b""
            gfull = np.frombuffer(window0 + data, dtype=np.uint8)
            K, depth = _parse_effort(self.parse_level)
            gmatches = find_matches_k(
                gfull, 9, min((1 << self.window_log) - 1, len(gfull)),
                K=K, depth=depth, deflate_heuristics=False,
            )
            for off in range(0, len(data), bs):
                sub = data[off : off + bs]
                hist = window0 + data[:off]
                blob = compress_block(
                    sub, self.parse_level,
                    max_dist=min((1 << self.window_log) - 1, len(hist) + len(sub)),
                    history=hist, reuse=self._reuse, matches=gmatches,
                    device_literals=self.device_literals,
                    device_sequences=self.device_sequences,
                )
                self._window = (self._window + sub)[
                    -min((1 << self.window_log) - 1, MAX_BLOCK):]
                if final and off + bs >= len(data):
                    blob = bytes([blob[0] | 1]) + blob[1:]
                out.extend(blob)
            return bytes(out)
        return bytes(self._compress_one(data, final))

    def _compress_one(self, data: bytes, final: bool) -> bytes:
        out = bytearray()
        # Cross-block history: matches may reach back through the window
        # (capped at one MAX_BLOCK of history to bound re-hash cost; the
        # device tokenizer path stays block-local). Levels <= 4 stay
        # block-local for speed, like zstd's fast strategies.
        window_cap = min((1 << self.window_log) - 1, MAX_BLOCK)
        history = self._window if (self.parse_level >= 5 and self.tokenizer is None) else b""
        blob = compress_block(
            data, self.parse_level,
            max_dist=min((1 << self.window_log) - 1, len(history) + len(data)),
            tokenizer=self.tokenizer,
            history=history,
            reuse=self._reuse,
            device_literals=self.device_literals,
            device_sequences=self.device_sequences,
        )
        self._window = (self._window + data)[-window_cap:]
        if final:
            blob = bytes([blob[0] | 1]) + blob[1:]
        out.extend(blob)
        return bytes(out)

    def trailer(self) -> bytes:
        if self.checksum:
            return struct.pack("<I", xxh64(bytes(self._hash_buf)) & 0xFFFFFFFF)
        return b""
