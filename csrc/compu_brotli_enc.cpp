// Native hot loops for the brotli ENCODER's per-command stages.
//
// Role: the reference's brotli encode hot loop lives in libbrotli
// (reference src/encoder/brotli_c.rs:54-61 ->
// BrotliEncoderCompressStream); here the meta-block planning (context
// clustering, prefix-code construction, header serialization) stays in
// Python (formats/brotli/encode.py) and only the per-token/per-symbol
// loops move to C++:
//
//   - compu_brotli_commands_from_tokens: token cover -> command list
//     (insert runs + copies, same-distance merge);
//   - compu_brotli_plan_distances: ring short-code / implicit / explicit
//     distance coding with the decoder's exact 4-slot ring;
//   - compu_brotli_emit_commands: the body bitstream (command symbols,
//     length extras, context-mapped literals, distance symbols) with
//     cross-chunk bit-phase carry.
//
// Each mirrors a pure-Python twin in encode.py that remains the
// reference implementation; outputs are byte-identical (tests).

#include <cstdint>
#include <cstring>

namespace {

// normative length-code tables (RFC 7932 §5)
static const int INSERT_BASE[24] = {0, 1, 2, 3, 4, 5, 6, 8, 10, 14, 18, 26,
                                    34, 50, 66, 98, 130, 194, 322, 578, 1090,
                                    2114, 6210, 22594};
static const int INSERT_EXTRA[24] = {0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3,
                                     4, 4, 5, 5, 6, 7, 8, 9, 10, 12, 14, 24};
static const int COPY_BASE[24] = {2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 18,
                                  22, 30, 38, 54, 70, 102, 134, 198, 326,
                                  582, 1094, 2118};
static const int COPY_EXTRA[24] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2,
                                   3, 3, 4, 4, 5, 5, 6, 7, 8, 9, 10, 24};

struct Sink {
    uint8_t* out;
    long long cap;
    long long n = 0;
    uint64_t acc;
    int nbits;
    bool overflow = false;

    inline void push(uint64_t v, int bits) {
        if (bits == 0) return;
        acc |= (v & ((1ULL << bits) - 1)) << nbits;
        nbits += bits;
        while (nbits >= 8) {
            if (n >= cap) { overflow = true; return; }
            out[n++] = (uint8_t)acc;
            acc >>= 8;
            nbits -= 8;
        }
    }
};

}  // namespace

extern "C" {

// Token cover -> commands. Tokens (pos, len, dist); len==0 = literal.
// Adjacent same-distance copies with no literals between merge up to
// max_copy. Output arrays (start, ins, cl, dist) with dist == -1 for the
// trailing literal-only command. Returns ncmd.
long long compu_brotli_commands_from_tokens(
    long long ntok,
    const int64_t* tok_pos, const int64_t* tok_len, const int64_t* tok_dist,
    long long max_copy,
    int64_t* out_start, int64_t* out_ins, int64_t* out_cl, int64_t* out_dist) {
    long long ncmd = 0;
    long long pending = 0, pending_start = 0;
    for (long long i = 0; i < ntok; i++) {
        long long l = tok_len[i];
        if (l == 0) {
            if (pending == 0) pending_start = tok_pos[i];
            pending++;
        } else {
            if (ncmd > 0 && pending == 0 && out_dist[ncmd - 1] == tok_dist[i] &&
                out_dist[ncmd - 1] >= 0 && out_cl[ncmd - 1] + l <= max_copy) {
                out_cl[ncmd - 1] += l;
            } else {
                out_start[ncmd] = pending_start;
                out_ins[ncmd] = pending;
                out_cl[ncmd] = l;
                out_dist[ncmd] = tok_dist[i];
                ncmd++;
                pending = 0;
            }
            pending_start = tok_pos[i] + l;
        }
    }
    if (pending) {
        out_start[ncmd] = pending_start;
        out_ins[ncmd] = pending;
        out_cl[ncmd] = 0;
        out_dist[ncmd] = -1;
        ncmd++;
    }
    return ncmd;
}

// Distance plan (twin of encode.py::_plan_distances). Inputs: per-command
// (ins code, copy code, dist; dist -1 = literal-only). ring[4] in/out.
// Outputs per command: dsym (-2 = literal-only, -1 = implicit ring[0],
// else the distance symbol), dextra, dbits. Returns 0, or -1 when an
// explicit distance exceeds the 24-bit code range.
long long compu_brotli_plan_distances(
    long long ncmd,
    const int64_t* ic, const int64_t* cc, const int64_t* dist,
    int64_t* ring,
    int64_t* out_dsym, int64_t* out_dextra, int64_t* out_dbits) {
    int64_t r0 = ring[0], r1 = ring[1], r2 = ring[2], r3 = ring[3];
    for (long long i = 0; i < ncmd; i++) {
        int64_t d = dist[i];
        if (d < 0) {
            out_dsym[i] = -2;
            out_dextra[i] = 0;
            out_dbits[i] = 0;
            continue;
        }
        if (d == r0 && ic[i] < 8 && cc[i] < 16) {
            out_dsym[i] = -1;  // implicit: command symbol < 128, no dsym
            out_dextra[i] = 0;
            out_dbits[i] = 0;
            continue;
        }
        int sc = -1;
        if (d == r0) sc = 0;
        else if (d == r1) sc = 1;
        else if (d == r2) sc = 2;
        else if (d == r3) sc = 3;
        if (sc < 0) {
            for (int dsym = 4; dsym < 16; dsym++) {
                int64_t base = dsym < 10 ? r0 : r1;
                int k = dsym < 10 ? dsym - 4 : dsym - 10;
                int64_t delta = (k >> 1) + 1;
                int64_t cand = (k & 1) ? base + delta : base - delta;
                if (cand == d && cand > 0) { sc = dsym; break; }
            }
        }
        if (sc >= 0) {
            out_dsym[i] = sc;
            out_dextra[i] = 0;
            out_dbits[i] = 0;
            if (sc != 0) { r3 = r2; r2 = r1; r1 = r0; r0 = d; }
        } else {
            // explicit (NPOSTFIX=0, NDIRECT=0)
            int64_t val = d - 1;
            int nbits = 1;
            int64_t dsym = -1, extra = 0;
            for (; nbits <= 24; nbits++) {
                int64_t lo = (2LL << nbits) - 4;
                int64_t hi = (3LL << nbits) - 4;
                int64_t nxt = (4LL << nbits) - 4;
                if (lo <= val && val < hi) {
                    dsym = 16 + (nbits - 1) * 2;
                    extra = val - lo;
                    break;
                }
                if (hi <= val && val < nxt) {
                    dsym = 16 + (nbits - 1) * 2 + 1;
                    extra = val - hi;
                    break;
                }
            }
            if (dsym < 0) return -1;
            out_dsym[i] = dsym;
            out_dextra[i] = extra;
            out_dbits[i] = nbits;
            r3 = r2; r2 = r1; r1 = r0; r0 = d;
        }
    }
    ring[0] = r0; ring[1] = r1; ring[2] = r2; ring[3] = r3;
    return 0;
}

// Body bitstream emission (twin of the loop at the end of
// encode.py::_write_data_meta_block). Prefix codes come as flat
// (code, len) arrays; len 0 emits nothing (the degenerate single-symbol
// codes). Bit phase carries in acc/nbits. Returns bytes written to out,
// -1 on overflow.
long long compu_brotli_emit_commands(
    const uint8_t* data, long long n, const uint8_t* tail2,
    long long ncmd,
    const int64_t* start, const int64_t* ins, const int64_t* cl,
    const int64_t* dist,
    const int64_t* ic, const int64_t* cc, const int64_t* cmd,
    const int64_t* dsym, const int64_t* dextra, const int64_t* dbits,
    const int64_t* cmd_codes, const int64_t* cmd_lens,
    const int64_t* dist_codes, const int64_t* dist_lens,
    int ntrees, const int64_t* lit_codes, const int64_t* lit_lens,
    const int64_t* cmap, const uint8_t* lut0, const uint8_t* lut1,
    uint64_t acc_in, int nbits_in,
    uint8_t* out, long long out_cap,
    uint64_t* acc_out, int* nbits_out) {
    Sink w{out, out_cap, 0, acc_in, nbits_in};
    // ext[k] = byte at position k-2 (tail carries the previous chunk):
    // context p1 = ext[k+1], p2 = ext[k]
    for (long long i = 0; i < ncmd; i++) {
        w.push((uint64_t)cmd_codes[cmd[i]], (int)cmd_lens[cmd[i]]);
        int icode = (int)ic[i];
        int ccode = (int)cc[i];
        w.push((uint64_t)(ins[i] - INSERT_BASE[icode]), INSERT_EXTRA[icode]);
        long long cl_eff = dist[i] >= 0 ? cl[i] : 2;
        w.push((uint64_t)(cl_eff - COPY_BASE[ccode]), COPY_EXTRA[ccode]);
        long long s = start[i];
        long long e = s + ins[i];
        if (ntrees > 1) {
            for (long long k = s; k < e; k++) {
                // ext = tail2 + data; context p1 = ext[k+1], p2 = ext[k]
                int p1 = k >= 1 ? data[k - 1] : tail2[1];
                int p2 = k >= 2 ? data[k - 2] : tail2[k];
                int cid = lut0[p1] | lut1[p2];
                long long tree = cmap[cid];
                int b = data[k];
                w.push((uint64_t)lit_codes[tree * 256 + b],
                       (int)lit_lens[tree * 256 + b]);
            }
        } else {
            for (long long k = s; k < e; k++) {
                int b = data[k];
                w.push((uint64_t)lit_codes[b], (int)lit_lens[b]);
            }
        }
        if (dist[i] >= 0 && dsym[i] >= 0) {
            w.push((uint64_t)dist_codes[dsym[i]], (int)dist_lens[dsym[i]]);
            w.push((uint64_t)dextra[i], (int)dbits[i]);
        }
        if (w.overflow) return -1;
    }
    *acc_out = w.acc;
    *nbits_out = w.nbits;
    return w.n;
}

}  // extern "C"
