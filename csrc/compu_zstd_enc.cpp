// Native hot loops for the zstd ENCODER's entropy stages.
//
// Role: the reference's zstd encode hot loop lives in libzstd
// (reference src/encoder/zstd.rs:167-169 -> ZSTD_compressStream2);
// here the block planning (table selection, normalization, section
// headers) stays in Python (formats/zstd/encode.py) and only the
// per-symbol loops move to C++:
//
//   - compu_zstd_seq_from_tokens: token cover -> (ll, offset, ml)
//     sequences + literal byte stream (same-distance merge);
//   - compu_zstd_resolve_offsets: repeat-offset history resolution
//     (mirrors the decoder's 3-slot ring);
//   - compu_zstd_seq_bitstream: the interleaved FSE state machine +
//     forward bit packing for the sequences section;
//   - compu_huf_encode_stream: Huffman literal stream packing
//     (backward-reader bit order);
//   - compu_fse_pair_stream: two-state FSE stream (Huffman weight
//     descriptions).
//
// Each mirrors a pure-Python twin that remains the reference
// implementation (fse.py / huff.py / encode.py); results are
// byte-identical (asserted by tests).

#include <cstdint>
#include <cstring>

namespace {

// LSB-first bit appender (ForwardBitWriter semantics: pushes are read back
// in REVERSE push order by the backward reader).
struct FwdWriter {
    uint8_t* out;
    size_t cap;
    size_t nbytes = 0;
    uint64_t acc = 0;
    int accbits = 0;
    bool overflow = false;

    inline void push(uint64_t v, int n) {
        if (n == 0) return;
        acc |= (v & ((n >= 64 ? ~0ULL : ((1ULL << n) - 1)))) << accbits;
        accbits += n;
        while (accbits >= 8) {
            if (nbytes >= cap) { overflow = true; return; }
            out[nbytes++] = (uint8_t)acc;
            acc >>= 8;
            accbits -= 8;
        }
    }
    // sentinel bit + pad to byte (matches ForwardBitWriter.finish /
    // BackwardBitWriter.finish byte layout)
    inline size_t finish() {
        push(1, 1);
        if (accbits) {
            if (nbytes >= cap) { overflow = true; return 0; }
            out[nbytes++] = (uint8_t)acc;
            acc = 0;
            accbits = 0;
        }
        return nbytes;
    }
};

struct FseEnc {
    const int64_t* state_table;
    const int64_t* delta_nbits;
    const int64_t* delta_find;
    int table_log;

    inline int64_t init_state(int sym) const {
        int64_t nbits_out = (delta_nbits[sym] + (1 << 15)) >> 16;
        int64_t value = (nbits_out << 16) - delta_nbits[sym];
        return state_table[(value >> nbits_out) + delta_find[sym]];
    }
    inline int64_t encode(int64_t state, int sym, FwdWriter& w) const {
        int64_t nbits_out = (state + delta_nbits[sym]) >> 16;
        w.push((uint64_t)state, (int)nbits_out);
        return state_table[(state >> nbits_out) + delta_find[sym]];
    }
};

}  // namespace

extern "C" {

// Collapse a token cover into zstd sequences. Tokens: (pos, len, dist)
// per token, len==0 = literal. Adjacent same-distance matches with no
// literals between them merge (ML ceiling 131074). Outputs parallel
// (ll, off, ml) arrays and the literal byte stream. Returns nseq.
long long compu_zstd_seq_from_tokens(
    const uint8_t* data, long long ntok,
    const int64_t* tok_pos, const int64_t* tok_len, const int64_t* tok_dist,
    int32_t* out_ll, int32_t* out_off, int32_t* out_ml,
    uint8_t* out_lits, long long* lits_len) {
    long long nseq = 0;
    long long ll = 0;          // pending literal count
    long long run_start = 0;
    long long lp = 0;          // literal bytes emitted
    for (long long i = 0; i < ntok; i++) {
        long long l = tok_len[i];
        if (l == 0) {
            if (ll == 0) run_start = tok_pos[i];
            ll++;
        } else {
            if (nseq > 0 && ll == 0 && out_off[nseq - 1] == (int32_t)tok_dist[i] &&
                (long long)out_ml[nseq - 1] + l <= 131074) {
                out_ml[nseq - 1] += (int32_t)l;
            } else {
                memcpy(out_lits + lp, data + run_start, (size_t)ll);
                lp += ll;
                out_ll[nseq] = (int32_t)ll;
                out_off[nseq] = (int32_t)tok_dist[i];
                out_ml[nseq] = (int32_t)l;
                nseq++;
                ll = 0;
            }
            run_start = tok_pos[i] + l;
        }
    }
    if (ll) {
        memcpy(out_lits + lp, data + run_start, (size_t)ll);
        lp += ll;
    }
    *lits_len = lp;
    return nseq;
}

// Repeat-offset resolution (mirror of encode.py::_resolve_offset_values /
// the decoder's ring). rep[3] is in/out; out_values gets OF values
// (1..3 = repeat slots, else offset+3).
void compu_zstd_resolve_offsets(
    const int32_t* ll, const int32_t* off, long long n,
    int64_t* rep, int64_t* out_values) {
    int64_t r0 = rep[0], r1 = rep[1], r2 = rep[2];
    for (long long i = 0; i < n; i++) {
        int64_t o = off[i];
        int64_t val;
        if (ll[i] != 0) {
            if (o == r0) val = 1;
            else if (o == r1) val = 2;
            else if (o == r2) val = 3;
            else val = o + 3;
        } else {
            if (o == r1) val = 1;
            else if (o == r2) val = 2;
            else if (o == r0 - 1 && o > 0) val = 3;
            else val = o + 3;
        }
        out_values[i] = val;
        if (val > 3) {
            r2 = r1; r1 = r0; r0 = o;
        } else {
            int64_t idx = val - 1 + (ll[i] == 0 ? 1 : 0);
            if (idx == 1) { r1 = r0; r0 = o; }          // rep[2] keeps
            else if (idx >= 2) { r2 = r1; r1 = r0; r0 = o; }
        }
    }
    rep[0] = r0; rep[1] = r1; rep[2] = r2;
}

// The sequences-section bitstream: interleaved FSE states + extra bits,
// exact twin of the push loop in encode.py::_sequences_section.
// Per channel: has_enc=0 means RLE (no state machine). Returns bytes
// written to `out`, or -1 on overflow.
long long compu_zstd_seq_bitstream(
    long long n,
    const int32_t* ll_codes, const int32_t* ml_codes, const int32_t* of_codes,
    const int32_t* ll_x, const int32_t* ll_xb,
    const int32_t* ml_x, const int32_t* ml_xb,
    const int64_t* of_x, const int32_t* of_xb,
    int ll_has, const int64_t* ll_st, const int64_t* ll_dn, const int64_t* ll_df, int ll_log,
    int ml_has, const int64_t* ml_st, const int64_t* ml_dn, const int64_t* ml_df, int ml_log,
    int of_has, const int64_t* of_st, const int64_t* of_dn, const int64_t* of_df, int of_log,
    uint8_t* out, long long out_cap) {
    if (n <= 0) return 0;
    FwdWriter w{out, (size_t)out_cap};
    FseEnc ll_e{ll_st, ll_dn, ll_df, ll_log};
    FseEnc ml_e{ml_st, ml_dn, ml_df, ml_log};
    FseEnc of_e{of_st, of_dn, of_df, of_log};
    long long last = n - 1;
    int64_t ll_state = ll_has ? ll_e.init_state(ll_codes[last]) : 0;
    int64_t ml_state = ml_has ? ml_e.init_state(ml_codes[last]) : 0;
    int64_t of_state = of_has ? of_e.init_state(of_codes[last]) : 0;

    // extras push order: ll, ml, of (reverse of the decoder's read order)
    w.push((uint64_t)ll_x[last], ll_xb[last]);
    w.push((uint64_t)ml_x[last], ml_xb[last]);
    w.push((uint64_t)of_x[last], of_xb[last]);
    for (long long i = last - 1; i >= 0; i--) {
        if (of_has) of_state = of_e.encode(of_state, of_codes[i], w);
        if (ml_has) ml_state = ml_e.encode(ml_state, ml_codes[i], w);
        if (ll_has) ll_state = ll_e.encode(ll_state, ll_codes[i], w);
        w.push((uint64_t)ll_x[i], ll_xb[i]);
        w.push((uint64_t)ml_x[i], ml_xb[i]);
        w.push((uint64_t)of_x[i], of_xb[i]);
        if (w.overflow) return -1;
    }
    // init-state flushes: decoder reads ll, of, ml first -> push ml, of, ll
    if (ml_has) w.push((uint64_t)ml_state, ml_log);
    if (of_has) w.push((uint64_t)of_state, of_log);
    if (ll_has) w.push((uint64_t)ll_state, ll_log);
    long long r = (long long)w.finish();
    return w.overflow ? -1 : r;
}

// Huffman literal stream (BackwardBitWriter semantics: first symbol lands
// at the top of the integer, i.e. push symbols in REVERSE order into an
// LSB-first accumulator, sentinel last). Returns bytes written, -1 on
// overflow.
long long compu_huf_encode_stream(
    const uint8_t* data, long long n,
    const uint32_t* code, const int32_t* nbits,
    uint8_t* out, long long out_cap) {
    FwdWriter w{out, (size_t)out_cap};
    for (long long i = n - 1; i >= 0; i--) {
        uint8_t b = data[i];
        w.push(code[b], nbits[b]);
        if (w.overflow) return -1;
    }
    long long r = (long long)w.finish();
    return w.overflow ? -1 : r;
}

// Two-state FSE stream over a symbol sequence (Huffman weight
// descriptions, huff.py::_describe_fse): state A codes even positions,
// B odd; encode walks backward; flush B then A. Returns bytes, -1 on
// overflow or n < 2.
long long compu_fse_pair_stream(
    const uint8_t* syms, long long n,
    const int64_t* st, const int64_t* dn, const int64_t* df, int table_log,
    uint8_t* out, long long out_cap) {
    if (n < 2) return -1;
    FwdWriter w{out, (size_t)out_cap};
    FseEnc e{st, dn, df, table_log};
    int64_t state_a = -1, state_b = -1;
    for (long long i = n - 1; i >= 0; i--) {
        int sym = syms[i];
        if ((i & 1) == 0) {
            state_a = state_a < 0 ? e.init_state(sym) : e.encode(state_a, sym, w);
        } else {
            state_b = state_b < 0 ? e.init_state(sym) : e.encode(state_b, sym, w);
        }
        if (w.overflow) return -1;
    }
    if (state_a < 0 || state_b < 0) return -1;
    w.push((uint64_t)state_b, table_log);
    w.push((uint64_t)state_a, table_log);
    long long r = (long long)w.finish();
    return w.overflow ? -1 : r;
}

// Pareto match candidates per position (twin of deflate_encode.py::
// find_matches_k, which stays the reference implementation): up to K
// (length, distance) pairs per position, discovered nearest-first along a
// 3-byte-prefix hash chain, slots filled in discovery order with slot K-1
// keeping the longest. Output arrays are (n, K) row-major int64.
long long compu_find_matches_k(
    const uint8_t* data, long long n, long long max_dist,
    int K, int depth, int nice, int deflate_heur, int hash_bits,
    int64_t* lens_k, int64_t* dists_k) {
    const int MIN_MATCH = 3, MAX_MATCH = 258;
    memset(lens_k, 0, sizeof(int64_t) * (size_t)(n * K));
    memset(dists_k, 0, sizeof(int64_t) * (size_t)(n * K));
    if (n < MIN_MATCH + 1) return 0;
    long long m = n - 2;
    int32_t* head = new int32_t[(size_t)1 << hash_bits];
    int32_t* prev = new int32_t[m];
    memset(head, 0xFF, sizeof(int32_t) << hash_bits);
    for (long long i = 0; i < m; i++) {
        uint32_t v = (uint32_t)data[i] | ((uint32_t)data[i + 1] << 8) |
                     ((uint32_t)data[i + 2] << 16);
        uint32_t h = (v * 2654435761u) >> (32 - hash_bits);
        prev[i] = head[h];
        head[h] = (int32_t)i;
    }
    for (long long i = 0; i < m; i++) {
        long long limit = n - i < MAX_MATCH ? n - i : MAX_MATCH;
        long long retire = nice < limit ? nice : limit;
        long long best = 0;
        int cnt = 0;
        int32_t cand = prev[i];
        for (int d = 0; d < depth; d++) {
            if (cand < 0 || i - cand > max_dist) break;
            // common prefix length, 8 bytes at a time
            const uint8_t* a = data + i;
            const uint8_t* b = data + cand;
            long long l = 0;
            while (l + 8 <= limit) {
                uint64_t x, y;
                memcpy(&x, a + l, 8);
                memcpy(&y, b + l, 8);
                uint64_t diff = x ^ y;
                if (diff) { l += __builtin_ctzll(diff) >> 3; goto done; }
                l += 8;
            }
            while (l < limit && a[l] == b[l]) l++;
        done:
            if (l > best) {
                best = l;
                int slot = cnt < K - 1 ? cnt : K - 1;
                lens_k[i * K + slot] = l;
                dists_k[i * K + slot] = i - cand;
                cnt++;
                if (best >= retire) break;
            }
            cand = prev[cand];
        }
    }
    if (deflate_heur) {
        for (long long i = 0; i < m * K; i++) {
            if (lens_k[i] == MIN_MATCH && dists_k[i] > 4096) {
                lens_k[i] = 0;
                dists_k[i] = 0;
            }
        }
    }
    delete[] head;
    delete[] prev;
    return 0;
}

// Token cover extraction (twin of deflate_encode.py::greedy_cover): the
// path 0 -> nxt[0] -> ... -> n, as a plain sequential walk. Returns the
// number of path positions written to out.
long long compu_greedy_cover(const int64_t* nxt, long long n, int64_t* out) {
    long long t = 0;
    long long j = 0;
    while (j < n) {
        out[t++] = j;
        j = nxt[j];
    }
    return t;
}

// Best-match-per-position chain walk (twin of deflate_encode.py::
// find_matches, the reference implementation): 3-byte-prefix hash chains,
// optional distance-1 pre-pass, optional 6-byte-prefix chain walk (deep
// quality ladders), optional patience early-retire. Applies the zlib
// "too far" heuristic and the Filtered length floor.
void compu_find_matches(
    const uint8_t* data, long long n, long long max_dist,
    int depth, int nice, int hash_bits, int patience, int hash6_depth,
    int filtered,
    int64_t* lens, int64_t* dists) {
    const int MIN_MATCH = 3, MAX_MATCH = 258;
    memset(lens, 0, sizeof(int64_t) * (size_t)n);
    memset(dists, 0, sizeof(int64_t) * (size_t)n);
    if (n < MIN_MATCH + 1) return;
    long long m = n - 2;
    int32_t* head = new int32_t[(size_t)1 << hash_bits];
    int32_t* prev = new int32_t[m];
    memset(head, 0xFF, sizeof(int32_t) << hash_bits);
    for (long long i = 0; i < m; i++) {
        uint32_t v = (uint32_t)data[i] | ((uint32_t)data[i + 1] << 8) |
                     ((uint32_t)data[i + 2] << 16);
        uint32_t h = (v * 2654435761u) >> (32 - hash_bits);
        prev[i] = head[h];
        head[h] = (int32_t)i;
    }
    int64_t* best_len = new int64_t[m]();
    int64_t* best_dist = new int64_t[m]();

    auto match_len = [&](long long i, long long c, long long limit) -> long long {
        const uint8_t* a = data + i;
        const uint8_t* b = data + c;
        long long l = 0;
        while (l + 8 <= limit) {
            uint64_t x, y;
            memcpy(&x, a + l, 8);
            memcpy(&y, b + l, 8);
            uint64_t diff = x ^ y;
            if (diff) return l + (__builtin_ctzll(diff) >> 3);
            l += 8;
        }
        while (l < limit && a[l] == b[l]) l++;
        return l;
    };
    auto limit_at = [&](long long i) -> long long {
        return n - i < MAX_MATCH ? n - i : MAX_MATCH;
    };

    if (patience || hash6_depth) {
        // distance-1 pre-pass: run positions retire immediately
        for (long long i = 1; i < m; i++) {
            long long l = match_len(i, i - 1, limit_at(i));
            if (l > best_len[i]) { best_len[i] = l; best_dist[i] = 1; }
        }
    }
    if (hash6_depth && m > 8) {
        long long m6 = m - 3;
        int32_t* head6 = new int32_t[1 << 17];
        int32_t* prev6 = new int32_t[m6];
        memset(head6, 0xFF, sizeof(int32_t) << 17);
        for (long long i = 0; i < m6; i++) {
            uint64_t v6 = 0;
            memcpy(&v6, data + i, 6);
            v6 &= 0xFFFFFFFFFFFFULL;
            uint64_t h6 = (v6 * 0x9E3779B97F4A7C15ULL) >> 47;
            prev6[i] = head6[h6];
            head6[h6] = (int32_t)i;
        }
        for (long long i = 0; i < m6; i++) {
            long long limit = limit_at(i);
            long long retire = nice < limit ? nice : limit;
            if (prev6[i] < 0 || best_len[i] >= retire) continue;
            int32_t cand = prev6[i];
            for (int d = 0; d < hash6_depth; d++) {
                if (cand < 0 || i - cand > max_dist || best_len[i] >= retire) break;
                long long l = match_len(i, cand, limit);
                if (l > best_len[i]) {
                    best_len[i] = l;
                    best_dist[i] = i - cand;
                }
                cand = prev6[cand];
            }
        }
        delete[] head6;
        delete[] prev6;
    }
    for (long long i = 0; i < m; i++) {
        long long limit = limit_at(i);
        long long retire = nice < limit ? nice : limit;
        int32_t cand = prev[i];
        long long li = 0;
        for (int d = 0; d < depth; d++) {
            if (cand < 0 || i - cand > max_dist || best_len[i] >= retire) break;
            if (patience && (long long)d - li >= patience) break;
            long long l = match_len(i, cand, limit);
            if (l > best_len[i]) {
                best_len[i] = l;
                best_dist[i] = i - cand;
                li = d;
            }
            cand = prev[cand];
        }
    }
    for (long long i = 0; i < m; i++) {
        long long bl = best_len[i];
        bool ok = bl >= MIN_MATCH;
        if (bl == MIN_MATCH && best_dist[i] > 4096) ok = false;  // zlib "too far"
        if (filtered && bl < 5) ok = false;
        if (ok) {
            lens[i] = bl;
            dists[i] = best_dist[i];
        }
    }
    delete[] head;
    delete[] prev;
    delete[] best_len;
    delete[] best_dist;
}

// btultra-style forward DP with arrival rep0 state — exact twin of the
// Python loop in encode.py::_zstd_optimal_tokens (which remains the
// reference implementation). Costs are precomputed by the (vectorized)
// Python caller; this runs only the O(n * (K + |sublens|)) relax loop and
// the backtrack. Returns the token count; tokens land in out_* arrays
// (len 0 = literal).
long long compu_zstd_optimal_parse(
    const uint8_t* full, long long hist_len, long long n,
    const int64_t* lens_k, const int64_t* dists_k, int K,
    const double* litcost,     // 256: per-byte literal cost
    const double* mlcost_len,  // 256: match cost by (l - 3), l in 3..258
    const double* dc_k,        // n*K: per-candidate distance-channel cost
    double rep_dc,             // repeat-offset match channel cost
    const int32_t* sublens, int n_sublens,
    int64_t rep0_init,
    int32_t* out_pos, int32_t* out_len, int32_t* out_dist) {
    const double INF = 1e18;
    double* cost = new double[n + 1];
    int64_t* rep0 = new int64_t[n + 1];
    int32_t* plen = new int32_t[n + 1];
    int64_t* pdist = new int64_t[n + 1];
    for (long long j = 0; j <= n; j++) {
        cost[j] = INF;
        rep0[j] = rep0_init;
        plen[j] = 0;
        pdist[j] = 0;
    }
    cost[0] = 0.0;

    int64_t rep_memo_r = -1;
    long long rep_memo_l = 0;
    long long rep_memo_i = -10;
    const uint8_t* base = full + hist_len;
    for (long long i = 0; i < n; i++) {
        double ci = cost[i];
        int64_t r0 = rep0[i];
        // literal step
        {
            double c = ci + litcost[base[i]];
            if (c < cost[i + 1]) {
                cost[i + 1] = c; rep0[i + 1] = r0; plen[i + 1] = 0; pdist[i + 1] = 0;
            }
        }
        // rep0 match measured on the fly (carry memo: same rep distance =>
        // matchlen(i+1) == matchlen(i) - 1 exactly, unless capped)
        if (hist_len + i - r0 >= 0) {
            const uint8_t* src = full + hist_len + i - r0;
            const uint8_t* dst = base + i;
            long long lmax = n - i < 258 ? n - i : 258;
            long long l;
            if (r0 == rep_memo_r && rep_memo_i == i - 1 && rep_memo_l > 0) {
                l = rep_memo_l - 1;
                if (rep_memo_l >= 258) {
                    while (l < lmax && src[l] == dst[l]) l++;
                }
                if (l > lmax) l = lmax;
            } else {
                l = 0;
                while (l < lmax && src[l] == dst[l]) l++;
            }
            rep_memo_r = r0; rep_memo_l = l; rep_memo_i = i;
            if (l >= 3) {
                double c = ci + mlcost_len[l - 3] + rep_dc;
                if (c < cost[i + l]) {
                    cost[i + l] = c; rep0[i + l] = r0;
                    plen[i + l] = (int32_t)l; pdist[i + l] = r0;
                }
                for (int s = 0; s < n_sublens; s++) {
                    long long lb = sublens[s];
                    if (lb >= l) break;
                    double cb = ci + mlcost_len[lb - 3] + rep_dc;
                    if (cb < cost[i + lb]) {
                        cost[i + lb] = cb; rep0[i + lb] = r0;
                        plen[i + lb] = (int32_t)lb; pdist[i + lb] = r0;
                    }
                }
            }
        }
        // finder candidates (pareto slots, nearest-first)
        const int64_t* row_l = lens_k + i * K;
        const int64_t* row_d = dists_k + i * K;
        const double* row_c = dc_k + i * K;
        long long prev_l = 2;
        for (int k = 0; k < K; k++) {
            long long L = row_l[k];
            if (L < 3 || L <= prev_l) continue;
            int64_t D = row_d[k];
            double dc = row_c[k];
            double c = ci + mlcost_len[L - 3] + dc;
            if (c < cost[i + L]) {
                cost[i + L] = c; rep0[i + L] = D;
                plen[i + L] = (int32_t)L; pdist[i + L] = D;
            }
            for (int s = 0; s < n_sublens; s++) {
                long long lb = sublens[s];
                if (lb >= L) break;
                if (lb <= prev_l) continue;
                double cb = ci + mlcost_len[lb - 3] + dc;
                if (cb < cost[i + lb]) {
                    cost[i + lb] = cb; rep0[i + lb] = D;
                    plen[i + lb] = (int32_t)lb; pdist[i + lb] = D;
                }
            }
            prev_l = L;
        }
    }
    // backtrack (emitted back-to-front, then reversed)
    long long t = 0;
    long long j = n;
    while (j > 0) {
        int32_t l = plen[j];
        if (l) {
            out_pos[t] = (int32_t)(j - l);
            out_len[t] = l;
            out_dist[t] = (int32_t)pdist[j];
            j -= l;
        } else {
            out_pos[t] = (int32_t)(j - 1);
            out_len[t] = 0;
            out_dist[t] = 0;
            j -= 1;
        }
        t++;
    }
    // reverse in place
    for (long long a = 0, b = t - 1; a < b; a++, b--) {
        int32_t x;
        x = out_pos[a]; out_pos[a] = out_pos[b]; out_pos[b] = x;
        x = out_len[a]; out_len[a] = out_len[b]; out_len[b] = x;
        x = out_dist[a]; out_dist[a] = out_dist[b]; out_dist[b] = x;
    }
    delete[] cost; delete[] rep0; delete[] plen; delete[] pdist;
    return t;
}

// Repeat-offset promotion (twin of encode.py::_promote_rep_offsets): swap
// a match's offset for a repeat-history distance when the same bytes exist
// there; tracks the 3-slot ring exactly as the decoder does. off[] is
// modified in place; rep[3] is in/out.
void compu_zstd_promote_rep(
    const uint8_t* full, long long nfull, long long hist_len,
    const int32_t* ll, int32_t* off, const int32_t* ml, long long n,
    int64_t* rep) {
    int64_t r0 = rep[0], r1 = rep[1], r2 = rep[2];
    long long pos = hist_len;
    for (long long i = 0; i < n; i++) {
        pos += ll[i];
        int64_t o = off[i];
        int64_t new_off = o;
        long long m = ml[i];
        int64_t cands[3];
        if (ll[i] != 0) { cands[0] = r0; cands[1] = r1; cands[2] = r2; }
        else { cands[0] = r1; cands[1] = r2; cands[2] = r0 - 1; }
        for (int c = 0; c < 3; c++) {
            int64_t rd = cands[c];
            if (rd == o) break;  // already coded as a (cheaper or equal) repeat
            if (rd <= 0 || pos - rd < 0 || pos + m > nfull) continue;
            if (memcmp(full + pos - rd, full + pos, (size_t)m) == 0) {
                new_off = rd;
                break;
            }
        }
        off[i] = (int32_t)new_off;
        // history update, identical to the decoder
        int64_t val;
        if (ll[i] != 0) {
            if (new_off == r0) val = 1;
            else if (new_off == r1) val = 2;
            else if (new_off == r2) val = 3;
            else val = new_off + 3;
        } else {
            if (new_off == r1) val = 1;
            else if (new_off == r2) val = 2;
            else if (new_off == r0 - 1 && new_off > 0) val = 3;
            else val = new_off + 3;
        }
        if (val > 3) {
            r2 = r1; r1 = r0; r0 = new_off;
        } else {
            int64_t idx = val - 1 + (ll[i] == 0 ? 1 : 0);
            if (idx == 1) { r1 = r0; r0 = new_off; }
            else if (idx >= 2) { r2 = r1; r1 = r0; r0 = new_off; }
        }
        pos += m;
    }
    rep[0] = r0; rep[1] = r1; rep[2] = r2;
}

}  // extern "C"
