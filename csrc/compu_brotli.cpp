// Native Brotli decoder (RFC 7932) for the compu_tpu host runtime.
//
// Role: the reference ships TWO interchangeable brotli decode backends
// behind one vtable (reference src/decoder/brotli_c.rs:22-28 wrapping
// the C library and src/decoder/brotli.rs:20-26 wrapping rust-brotli); this
// file is this framework's second brotli implementation — a from-scratch
// meta-block decoder, NOT a copy of libbrotli (different structure:
// per-tree flat LUTs, absolute-bit-position reader, meta-block-checkpoint
// resume via C++ exceptions). The pure-Python decoder
// (compu_tpu/formats/brotli/decode.py) remains the reference
// implementation and the fallback when no toolchain exists.
//
// Resumable contract:
//   compu_brotli_run(state, in, in_len, final, out, out_cap, &consumed,
//                    &written)
//     -> 0 NEED_INPUT (consumed rolls back to the last complete meta-block)
//        1 NEED_OUTPUT (out full; drain and call again)
//        2 DONE (last meta-block consumed)
//       <0 error (codes map onto formats/brotli/decode.py ERR_*)
//
// The stream is bit-oriented, so the sub-byte remainder of the consumed
// position persists in the state; the caller re-feeds from the reported
// consumed byte.
//
// Spec data (static dictionary, context table, word transforms) is
// injected once per process via compu_brotli_set_tables — the Python side
// owns the vendored RFC appendix blobs.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

constexpr int NEED_INPUT = 0;
constexpr int NEED_OUTPUT = 1;
constexpr int DONE = 2;
constexpr int ESTREAM = -1;    // ERR_STREAM
constexpr int EPREFIX = -2;    // ERR_PREFIX
constexpr int ECONTEXT = -3;   // ERR_CONTEXT
constexpr int EDISTANCE = -4;  // ERR_DISTANCE
constexpr int EDICT = -5;      // ERR_DICT
constexpr int ETRANSFORM = -6; // ERR_TRANSFORM
constexpr int EBLOCK = -7;     // ERR_BLOCK
constexpr int EWINDOW = -8;    // ERR_WINDOW

struct NeedMore {};
struct Corrupt {
    int code;
};

// --- injected spec data (RFC 7932 appendices; owned by the Python side) ---
static std::vector<uint8_t> g_dict;
static std::vector<uint8_t> g_context;  // 2048 = 4 modes x 512
struct Transform {
    int type;  // 0 identity, 1 omit_first, 2 omit_last, 3 ferment_first, 4 ferment_all
    int param;
    std::vector<uint8_t> prefix, suffix;
};
static std::vector<Transform> g_transforms;
static int g_dict_offsets[26];
static const int DICT_SIZE_BITS[25] = {0, 0, 0, 0, 10, 10, 11, 11, 10, 10,
                                       10, 10, 10, 9,  9,  8,  7,  7,  8, 7,
                                       7,  6,  6,  5,  5};

// --- normative constant tables (RFC 7932 §4-§7) ---
static const int CLCODE_ORDER[18] = {1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9,
                                     10, 11, 12, 13, 14, 15};
static const int CLCODE_LUT_LEN[16] = {2, 2, 2, 3, 2, 2, 2, 4, 2, 2, 2, 3, 2, 2, 2, 4};
static const int CLCODE_LUT_VAL[16] = {0, 4, 3, 2, 0, 4, 3, 1, 0, 4, 3, 2, 0, 4, 3, 5};
static const int BLOCK_COUNT_BASE[26] = {1, 5, 9, 13, 17, 25, 33, 41, 49, 65,
                                         81, 97, 113, 145, 177, 209, 241, 305,
                                         369, 497, 753, 1265, 2289, 4337, 8433, 16625};
static const int BLOCK_COUNT_EXTRA[26] = {2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5,
                                          5, 5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 24};
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
static const int INSERT_RANGE_LUT[9] = {0, 0, 8, 8, 0, 16, 8, 16, 16};
static const int COPY_RANGE_LUT[9] = {0, 8, 0, 8, 16, 0, 16, 8, 16};
constexpr int NUM_COMMAND_SYMBOLS = 704;
constexpr int NUM_LITERAL_SYMBOLS = 256;
constexpr int NUM_BLOCK_LEN_SYMBOLS = 26;
constexpr int MAXBITS = 15;

// ---------------------------------------------------------------------------
// forward LSB-first bit reader (absolute bit position; throws NeedMore)
// ---------------------------------------------------------------------------
struct Bits {
    const uint8_t* p;
    size_t len;         // bytes
    size_t nbits;       // len * 8
    size_t bitpos;

    inline uint64_t load_at(size_t pos) const {
        // up to 57 valid bits starting at `pos`, zero-filled past the end
        size_t byte = pos >> 3;
        if (byte >= len) return 0;
        uint64_t v = 0;
        size_t avail = len - byte;
        memcpy(&v, p + byte, avail >= 8 ? 8 : avail);
        return v >> (pos & 7);
    }
    inline uint32_t read(int n) {
        if (bitpos + (size_t)n > nbits) throw NeedMore{};
        uint32_t r = n ? (uint32_t)(load_at(bitpos) & ((1ULL << n) - 1)) : 0;
        bitpos += (size_t)n;
        return r;
    }
    inline uint32_t peek(int n) const {
        return n ? (uint32_t)(load_at(bitpos) & ((1ULL << n) - 1)) : 0;
    }
    inline void skip(size_t n) {
        if (bitpos + n > nbits) throw NeedMore{};
        bitpos += n;
    }
    inline size_t remaining() const { return nbits - bitpos; }
    inline void align_byte() { bitpos = (bitpos + 7) & ~(size_t)7; }
};

// ---------------------------------------------------------------------------
// canonical prefix code with a flat LUT (codes bit-reversed, LSB-first)
// ---------------------------------------------------------------------------
struct Prefix {
    int single = -1;  // degenerate 0-bit code
    int max_bits = 0;
    std::vector<uint16_t> sym;
    std::vector<uint8_t> len;

    void build(const uint8_t* lengths, int n) {
        int count[MAXBITS + 1] = {0};
        int nz = 0, last = -1;
        for (int i = 0; i < n; i++) {
            if (lengths[i]) { count[lengths[i]]++; nz++; last = i; }
        }
        if (nz == 0) throw Corrupt{EPREFIX};
        if (nz == 1) { single = last; max_bits = 0; return; }
        single = -1;
        max_bits = 0;
        for (int l = MAXBITS; l >= 1; l--)
            if (count[l]) { max_bits = l; break; }
        int codes[MAXBITS + 1];
        int code = 0;
        for (int l = 1; l <= MAXBITS; l++) {
            code = (code + count[l - 1]) << 1;
            codes[l] = code;
        }
        size_t size = (size_t)1 << max_bits;
        sym.assign(size, 0);
        len.assign(size, 0);
        for (int i = 0; i < n; i++) {
            int l = lengths[i];
            if (!l) continue;
            uint32_t c = (uint32_t)codes[l]++;
            uint32_t rev = 0;
            for (int k = 0; k < l; k++) { rev = (rev << 1) | (c & 1); c >>= 1; }
            for (size_t idx = rev; idx < size; idx += ((size_t)1 << l)) {
                sym[idx] = (uint16_t)i;
                len[idx] = (uint8_t)l;
            }
        }
    }
    inline int decode(Bits& r) const {
        if (single >= 0) return single;
        uint32_t idx = r.peek(max_bits);
        int l = len[idx];
        if (l == 0) {
            if (r.remaining() < (size_t)max_bits) throw NeedMore{};
            throw Corrupt{EPREFIX};
        }
        if (r.remaining() < (size_t)l) throw NeedMore{};
        r.bitpos += (size_t)l;
        return sym[idx];
    }
};

static int read_count_code(Bits& r) {
    if (r.read(1) == 0) return 1;
    int k = r.read(3);
    return (1 << k) + 1 + (k ? (int)r.read(k) : 0);
}

static void read_prefix_code(Bits& r, int alphabet_size, Prefix& out) {
    int hskip = r.read(2);
    if (hskip == 1) {
        // simple code: 1-4 explicit symbols
        int alpha_bits = 1;
        while ((1 << alpha_bits) < alphabet_size) alpha_bits++;
        if (alphabet_size <= 1) alpha_bits = 1;
        int nsym = r.read(2) + 1;
        int syms[4];
        for (int i = 0; i < nsym; i++) {
            syms[i] = r.read(alpha_bits);
            if (syms[i] >= alphabet_size) throw Corrupt{EPREFIX};
            for (int j = 0; j < i; j++)
                if (syms[j] == syms[i]) throw Corrupt{EPREFIX};
        }
        std::vector<uint8_t> lengths((size_t)alphabet_size, 0);
        if (nsym == 1) {
            out.single = syms[0];
            out.max_bits = 0;
            out.sym.clear();
            out.len.clear();
            return;
        }
        if (nsym == 2) {
            lengths[syms[0]] = 1; lengths[syms[1]] = 1;
        } else if (nsym == 3) {
            lengths[syms[0]] = 1; lengths[syms[1]] = 2; lengths[syms[2]] = 2;
        } else {
            if (r.read(1)) {
                lengths[syms[0]] = 1; lengths[syms[1]] = 2;
                lengths[syms[2]] = 3; lengths[syms[3]] = 3;
            } else {
                for (int i = 0; i < 4; i++) lengths[syms[i]] = 2;
            }
        }
        out.build(lengths.data(), alphabet_size);
        return;
    }
    // complex code
    uint8_t cl_lengths[18] = {0};
    int space = 32, num_codes = 0;
    for (int i = hskip; i < 18; i++) {
        uint32_t idx4 = r.peek(4);
        int l = CLCODE_LUT_LEN[idx4];
        if (r.remaining() < (size_t)l) throw NeedMore{};
        r.bitpos += (size_t)l;
        int v = CLCODE_LUT_VAL[idx4];
        cl_lengths[CLCODE_ORDER[i]] = (uint8_t)v;
        if (v) {
            num_codes++;
            space -= 32 >> v;
            if (space <= 0) break;
        }
    }
    if (num_codes != 1 && space != 0) throw Corrupt{EPREFIX};
    Prefix cl_code;
    cl_code.build(cl_lengths, 18);

    std::vector<uint8_t> lengths((size_t)alphabet_size, 0);
    long space2 = 32768;
    int prev_nonzero = 8;
    int i = 0, rep_sym = 0;
    long rep_count = 0;
    while (i < alphabet_size && space2 > 0) {
        int sym = cl_code.decode(r);
        if (sym < 16) {
            lengths[i++] = (uint8_t)sym;
            if (sym) {
                prev_nonzero = sym;
                space2 -= 32768 >> sym;
            }
            rep_sym = 0;
            rep_count = 0;
        } else {
            int extra_bits = sym == 16 ? 2 : 3;
            int extra = r.read(extra_bits);
            long reps;
            if (rep_sym == sym) {
                long old = rep_count;
                rep_count = ((rep_count - 2) << extra_bits) + 3 + extra;
                reps = rep_count - old;
            } else {
                rep_sym = sym;
                rep_count = 3 + extra;
                reps = rep_count;
            }
            if (i + reps > alphabet_size) throw Corrupt{EPREFIX};
            if (sym == 16) {
                for (long k = 0; k < reps; k++) lengths[i + k] = (uint8_t)prev_nonzero;
                space2 -= (32768 >> prev_nonzero) * reps;
            }
            i += (int)reps;
        }
    }
    if (space2 < 0) throw Corrupt{EPREFIX};
    if (space2 > 0) {
        int nz = 0;
        for (int k = 0; k < alphabet_size; k++)
            if (lengths[k]) nz++;
        if (nz != 1) throw Corrupt{EPREFIX};
    }
    out.build(lengths.data(), alphabet_size);
}

static void read_context_map(Bits& r, int ntrees, int size, std::vector<uint8_t>& cmap) {
    cmap.assign((size_t)size, 0);
    if (ntrees < 2) return;
    int rlemax = 0;
    if (r.read(1)) rlemax = r.read(4) + 1;
    Prefix code;
    read_prefix_code(r, ntrees + rlemax, code);
    int i = 0;
    while (i < size) {
        int sym = code.decode(r);
        if (sym == 0) {
            cmap[i++] = 0;
        } else if (sym <= rlemax) {
            long reps = (1L << sym) + r.read(sym);
            if (i + reps > size) throw Corrupt{ECONTEXT};
            i += (int)reps;
        } else {
            int v = sym - rlemax;
            if (v >= ntrees) throw Corrupt{ECONTEXT};
            cmap[i++] = (uint8_t)v;
        }
    }
    if (r.read(1)) {  // inverse move-to-front
        uint8_t mtf[256];
        for (int k = 0; k < 256; k++) mtf[k] = (uint8_t)k;
        for (int j = 0; j < size; j++) {
            int v = cmap[j];
            uint8_t value = mtf[v];
            cmap[j] = value;
            memmove(mtf + 1, mtf, (size_t)v);
            mtf[0] = value;
        }
    }
}

struct BlockCategory {
    int ntypes;
    int btype = 0, prev = 1;
    long long remaining;
    Prefix type_code, count_code;

    void init(Bits& r) {
        ntypes = read_count_code(r);
        btype = 0;
        prev = 1;
        if (ntypes >= 2) {
            read_prefix_code(r, ntypes + 2, type_code);
            read_prefix_code(r, NUM_BLOCK_LEN_SYMBOLS, count_code);
            remaining = read_count(r);
        } else {
            remaining = 1LL << 62;
        }
    }
    long long read_count(Bits& r) {
        int sym = count_code.decode(r);
        return BLOCK_COUNT_BASE[sym] + (long long)r.read(BLOCK_COUNT_EXTRA[sym]);
    }
    inline void tick(Bits& r) {
        if (remaining == 0) {
            int sym = type_code.decode(r);
            int nw;
            if (sym == 0) nw = prev;
            else if (sym == 1) nw = (btype + 1) % ntypes;
            else nw = sym - 2;
            if (nw >= ntypes) throw Corrupt{EBLOCK};
            prev = btype;
            btype = nw;
            remaining = read_count(r);
        }
        remaining--;
    }
};

// ---------------------------------------------------------------------------
// decoder state
// ---------------------------------------------------------------------------
struct BrotliState {
    bool have_window = false;
    int window_bits = 0;
    long long window_size = 0;
    bool done = false;
    int bit_sub = 0;  // sub-byte bit offset into the next input byte
    long long ring[4] = {4, 11, 15, 16};
    std::vector<uint8_t> out;  // decoded output kept as the window source
    long long out_dropped = 0;
    size_t pending = 0;  // undrained bytes at the tail of `out`
};

static void ferment(uint8_t* w, size_t n, bool all_chars) {
    size_t i = 0;
    while (i < n) {
        uint8_t c = w[i];
        if (c < 192) {
            if (c >= 97 && c <= 122) w[i] ^= 32;
            i += 1;
        } else if (c < 224) {
            if (i + 1 < n) w[i + 1] ^= 32;
            i += 2;
        } else {
            if (i + 2 < n) w[i + 2] ^= 5;
            i += 3;
        }
        if (!all_chars) break;
    }
}

// append a transformed dictionary word to `dst`
static void dictionary_word(int copy_len, long long address, std::vector<uint8_t>& dst,
                            size_t* appended) {
    if (copy_len < 4 || copy_len > 24) throw Corrupt{EDICT};
    int ndbits = DICT_SIZE_BITS[copy_len];
    long long word_id = address & ((1LL << ndbits) - 1);
    long long transform_id = address >> ndbits;
    if (transform_id >= (long long)g_transforms.size()) throw Corrupt{ETRANSFORM};
    size_t offset = (size_t)g_dict_offsets[copy_len] + (size_t)word_id * (size_t)copy_len;
    if (offset + (size_t)copy_len > g_dict.size()) throw Corrupt{EDICT};
    const Transform& t = g_transforms[(size_t)transform_id];
    uint8_t mid[24];
    memcpy(mid, g_dict.data() + offset, (size_t)copy_len);
    size_t mlen = (size_t)copy_len;
    const uint8_t* mp = mid;
    switch (t.type) {
        case 0: break;  // identity
        case 1:  // omit_first
            mp = mid + (t.param < copy_len ? t.param : copy_len);
            mlen = (size_t)(copy_len - (t.param < copy_len ? t.param : copy_len));
            break;
        case 2:  // omit_last
            mlen = (size_t)(t.param < copy_len ? copy_len - t.param : 0);
            break;
        case 3: ferment(mid, mlen, false); break;
        case 4: ferment(mid, mlen, true); break;
        default: throw Corrupt{ETRANSFORM};
    }
    size_t before = dst.size();
    dst.insert(dst.end(), t.prefix.begin(), t.prefix.end());
    dst.insert(dst.end(), mp, mp + mlen);
    dst.insert(dst.end(), t.suffix.begin(), t.suffix.end());
    *appended = dst.size() - before;
}

static void read_window_bits(BrotliState* s, Bits& r) {
    int wbits;
    if (r.read(1) == 0) {
        wbits = 16;
    } else {
        int n = r.read(3);
        if (n != 0) {
            wbits = 17 + n;
        } else {
            int m = r.read(3);
            if (m == 0) wbits = 17;
            else if (m == 1) throw Corrupt{EWINDOW};
            else wbits = 8 + m;
        }
    }
    s->window_bits = wbits;
    s->window_size = (1LL << wbits) - 16;
    s->have_window = true;
}

static long long resolve_distance(BrotliState* s, int dsym, Bits& r, int ndirect,
                                  int npostfix, int postfix_mask) {
    long long* ring = s->ring;
    if (dsym < 16) {
        if (dsym < 4) return ring[dsym];
        long long base = dsym < 10 ? ring[0] : ring[1];
        int k = dsym < 10 ? dsym - 4 : dsym - 10;
        long long delta = (k >> 1) + 1;
        return (k & 1) ? base + delta : base - delta;
    }
    if (dsym < 16 + ndirect) return dsym - 16 + 1;
    int dcode = dsym - ndirect - 16;
    int nbits = 1 + (dcode >> (npostfix + 1));
    int hcode = dcode >> npostfix;
    int lcode = dcode & postfix_mask;
    long long offset = ((2LL + (hcode & 1)) << nbits) - 4;
    long long extra = r.read(nbits);
    return ((offset + extra) << npostfix) + lcode + ndirect + 1;
}

static void read_compressed_meta_block(BrotliState* s, Bits& r, long long mlen) {
    BlockCategory lit_blocks, cmd_blocks, dist_blocks;
    lit_blocks.init(r);
    cmd_blocks.init(r);
    dist_blocks.init(r);

    int npostfix = r.read(2);
    int ndirect = r.read(4) << npostfix;
    std::vector<int> cmodes((size_t)lit_blocks.ntypes);
    for (int i = 0; i < lit_blocks.ntypes; i++) cmodes[i] = r.read(2);

    int ntrees_l = read_count_code(r);
    std::vector<uint8_t> cmap_l;
    read_context_map(r, ntrees_l, 64 * lit_blocks.ntypes, cmap_l);
    int ntrees_d = read_count_code(r);
    std::vector<uint8_t> cmap_d;
    read_context_map(r, ntrees_d, 4 * dist_blocks.ntypes, cmap_d);

    std::vector<Prefix> lit_codes((size_t)ntrees_l);
    for (int i = 0; i < ntrees_l; i++)
        read_prefix_code(r, NUM_LITERAL_SYMBOLS, lit_codes[i]);
    std::vector<Prefix> cmd_codes((size_t)cmd_blocks.ntypes);
    for (int i = 0; i < cmd_blocks.ntypes; i++)
        read_prefix_code(r, NUM_COMMAND_SYMBOLS, cmd_codes[i]);
    int dist_alphabet = 16 + ndirect + (48 << npostfix);
    std::vector<Prefix> dist_codes((size_t)ntrees_d);
    for (int i = 0; i < ntrees_d; i++)
        read_prefix_code(r, dist_alphabet, dist_codes[i]);

    std::vector<uint8_t>& out = s->out;
    long long* ring = s->ring;
    const uint8_t* ctx = g_context.data();
    int postfix_mask = (1 << npostfix) - 1;
    long long to_decode = mlen;
    while (to_decode > 0) {
        cmd_blocks.tick(r);
        int cmd_sym = cmd_codes[(size_t)cmd_blocks.btype].decode(r);
        int range_idx = cmd_sym >> 6;
        bool implicit = false;
        if (range_idx < 2) implicit = true;
        else range_idx -= 2;
        int insert_code = INSERT_RANGE_LUT[range_idx] + ((cmd_sym >> 3) & 7);
        int copy_code = COPY_RANGE_LUT[range_idx] + (cmd_sym & 7);
        long long insert_len = INSERT_BASE[insert_code] + (long long)r.read(INSERT_EXTRA[insert_code]);
        long long copy_len = COPY_BASE[copy_code] + (long long)r.read(COPY_EXTRA[copy_code]);

        // literals
        for (long long k = 0; k < insert_len; k++) {
            lit_blocks.tick(r);
            int bt = lit_blocks.btype;
            int mode = cmodes[(size_t)bt];
            size_t olen = out.size();
            int p1 = olen ? out[olen - 1] : 0;
            int p2 = olen > 1 ? out[olen - 2] : 0;
            int cid = ctx[(mode << 9) + p1] | ctx[(mode << 9) + 256 + p2];
            const Prefix& tree = lit_codes[cmap_l[(size_t)((bt << 6) + cid)]];
            out.push_back((uint8_t)tree.decode(r));
        }
        to_decode -= insert_len;
        if (to_decode <= 0) {
            if (to_decode < 0) throw Corrupt{ESTREAM};
            break;
        }

        // distance
        int dsym = 0;
        long long distance;
        if (implicit) {
            distance = ring[0];
        } else {
            dist_blocks.tick(r);
            int cid = copy_len > 4 ? 3 : (int)copy_len - 2;
            const Prefix& tree = dist_codes[cmap_d[(size_t)((dist_blocks.btype << 2) + cid)]];
            dsym = tree.decode(r);
            distance = resolve_distance(s, dsym, r, ndirect, npostfix, postfix_mask);
            if (distance <= 0) throw Corrupt{EDISTANCE};
        }

        long long total_len = (long long)out.size() + s->out_dropped;
        long long max_distance = total_len < s->window_size ? total_len : s->window_size;
        if (!implicit && dsym != 0 && distance <= max_distance) {
            ring[3] = ring[2]; ring[2] = ring[1]; ring[1] = ring[0];
            ring[0] = distance;
        }
        if (distance <= max_distance) {
            size_t start = out.size() - (size_t)distance;
            out.resize(out.size() + (size_t)copy_len);
            uint8_t* dst = out.data() + out.size() - (size_t)copy_len;
            const uint8_t* src = out.data() + start;
            if (distance >= copy_len) {
                memcpy(dst, src, (size_t)copy_len);
            } else {
                for (long long k = 0; k < copy_len; k++) dst[k] = src[k];
            }
            to_decode -= copy_len;
        } else {
            long long address = distance - max_distance - 1;
            size_t appended = 0;
            dictionary_word((int)copy_len, address, out, &appended);
            if ((long long)appended > to_decode) throw Corrupt{EDICT};
            to_decode -= (long long)appended;
        }
    }
}

// one meta-block; sets s->done when the last block is consumed
static void read_meta_block(BrotliState* s, Bits& r) {
    int islast = r.read(1);
    if (islast && r.read(1)) {  // ISLASTEMPTY
        s->done = true;
        return;
    }
    int mnibbles = r.read(2);
    if (mnibbles == 3) {
        // metadata block: byte-aligned skip
        if (r.read(1)) throw Corrupt{EBLOCK};
        int mskipbytes = r.read(2);
        long long skip = 0;
        for (int k = 0; k < mskipbytes; k++)
            skip |= (long long)r.read(8) << (8 * k);
        if (mskipbytes && skip == 0) throw Corrupt{EBLOCK};
        if (mskipbytes) skip += 1;
        r.align_byte();
        if (r.remaining() < (size_t)(8 * skip)) throw NeedMore{};
        r.bitpos += (size_t)(8 * skip);
        if (islast) s->done = true;
        return;
    }
    long long mlen = 0;
    for (int k = 0; k < mnibbles + 4; k++)
        mlen |= (long long)r.read(4) << (4 * k);
    mlen += 1;
    if (!islast && r.read(1)) {  // ISUNCOMPRESSED
        r.align_byte();
        if (r.remaining() < (size_t)(8 * mlen)) throw NeedMore{};
        size_t start = r.bitpos >> 3;
        s->out.insert(s->out.end(), r.p + start, r.p + start + (size_t)mlen);
        r.bitpos += (size_t)(8 * mlen);
        return;
    }
    read_compressed_meta_block(s, r, mlen);
    if (islast) s->done = true;
}

}  // namespace

extern "C" {

void compu_brotli_set_tables(const uint8_t* dict, size_t dict_len,
                             const uint8_t* context, size_t context_len,
                             const uint8_t* transforms, size_t transforms_len) {
    g_dict.assign(dict, dict + dict_len);
    g_context.assign(context, context + context_len);
    g_transforms.clear();
    // packed: [type u8, param u8, prefix_len u8, suffix_len u8,
    //          prefix bytes..., suffix bytes...] per transform
    size_t i = 0;
    while (i + 4 <= transforms_len) {
        Transform t;
        t.type = transforms[i];
        t.param = transforms[i + 1];
        size_t plen = transforms[i + 2], slen = transforms[i + 3];
        i += 4;
        if (i + plen + slen > transforms_len) break;
        t.prefix.assign(transforms + i, transforms + i + plen);
        i += plen;
        t.suffix.assign(transforms + i, transforms + i + slen);
        i += slen;
        g_transforms.push_back(std::move(t));
    }
    g_dict_offsets[0] = 0;
    for (int l = 0; l < 25; l++)
        g_dict_offsets[l + 1] = g_dict_offsets[l] +
            (DICT_SIZE_BITS[l] ? l * (1 << DICT_SIZE_BITS[l]) : 0);
}

void* compu_brotli_new() {
    return new (std::nothrow) BrotliState();
}

void compu_brotli_free(void* p) { delete (BrotliState*)p; }

void compu_brotli_reset(void* p) {
    BrotliState* s = (BrotliState*)p;
    *s = BrotliState();
}

int compu_brotli_run(void* p, const uint8_t* in, size_t in_len, int final_input,
                     uint8_t* out, size_t out_cap,
                     size_t* in_consumed, size_t* out_written) {
    (void)final_input;
    BrotliState* s = (BrotliState*)p;
    size_t op = 0;
    size_t consumed_bytes = 0;
    int status = NEED_INPUT;

    // drain pending first
    if (s->pending) {
        size_t take = s->pending < out_cap ? s->pending : out_cap;
        memcpy(out, s->out.data() + s->out.size() - s->pending, take);
        s->pending -= take;
        op += take;
        if (s->pending) {
            *in_consumed = 0;
            *out_written = op;
            return NEED_OUTPUT;
        }
    }

    Bits r{in, in_len, in_len * 8, (size_t)s->bit_sub};
    try {
        if (!s->have_window) {
            size_t ck = r.bitpos;
            try {
                read_window_bits(s, r);
            } catch (NeedMore&) {
                r.bitpos = ck;
                throw;
            }
        }
        while (!s->done) {
            size_t checkpoint = r.bitpos;
            long long ring_ck[4] = {s->ring[0], s->ring[1], s->ring[2], s->ring[3]};
            size_t out_len_ck = s->out.size();
            try {
                read_meta_block(s, r);
            } catch (NeedMore&) {
                // roll back the partial meta-block entirely
                memcpy(s->ring, ring_ck, sizeof(ring_ck));
                s->out.resize(out_len_ck);
                r.bitpos = checkpoint;
                throw;
            }
            size_t produced = s->out.size() - out_len_ck;
            s->pending += produced;
            // drain
            if (s->pending) {
                size_t take = s->pending < out_cap - op ? s->pending : out_cap - op;
                memcpy(out + op, s->out.data() + s->out.size() - s->pending, take);
                s->pending -= take;
                op += take;
                if (s->pending) { status = NEED_OUTPUT; goto commit; }
            }
            // trim the window source (keep window + undrained tail)
            {
                size_t keep = (size_t)s->window_size;
                if (keep < s->pending) keep = s->pending;
                if (s->out.size() > keep + (1u << 18)) {
                    size_t drop = s->out.size() - keep;
                    s->out_dropped += (long long)drop;
                    s->out.erase(s->out.begin(), s->out.begin() + (long)drop);
                }
            }
        }
        status = DONE;
        // done: consume through the last byte the final bit position touches
        consumed_bytes = (r.bitpos + 7) >> 3;
        if (consumed_bytes > in_len) consumed_bytes = in_len;
        s->bit_sub = 0;
        *in_consumed = consumed_bytes;
        *out_written = op;
        return status;
    } catch (NeedMore&) {
        status = NEED_INPUT;
    } catch (Corrupt& c) {
        *in_consumed = r.bitpos >> 3;
        *out_written = op;
        return c.code;
    } catch (...) {
        *in_consumed = r.bitpos >> 3;
        *out_written = op;
        return ESTREAM;
    }

commit:
    consumed_bytes = r.bitpos >> 3;
    s->bit_sub = (int)(r.bitpos & 7);
    *in_consumed = consumed_bytes;
    *out_written = op;
    return status;
}

}  // extern "C"
