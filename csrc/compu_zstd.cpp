// Native Zstandard frame decoder (RFC 8878) for the compu_tpu host runtime.
//
// Role: the reference delegates zstd decode to libzstd
// (reference src/decoder/zstd.rs:109-111 -> ZSTD_decompressStream);
// this is the equivalent native hot loop for this framework's host path —
// a from-scratch decoder, NOT a copy of libzstd (different structure: one
// flat table per entropy stage, absolute-bit-position backward reader,
// whole-unit resumable state machine). The pure-Python decoder
// (compu_tpu/formats/zstd/decode.py) remains the reference implementation
// and the fallback when no toolchain exists.
//
// Resumable contract (mirrors src/decoder/mod.rs:150-157 semantics):
//   compu_zstd_run(state, in, in_len, out, out_cap, &consumed, &written)
//     -> 0 NEED_INPUT (consumed bytes up to the last complete unit)
//        1 NEED_OUTPUT (out full; drain and call again, input may be empty)
//        2 DONE (frame fully decoded and checksum verified)
//       <0 error (codes map onto formats/zstd/decode.py ERR_*)
//
// Units are whole frame headers / whole blocks: the compressed size of
// every unit is known from its first bytes, so the state machine never
// suspends mid-unit — NEED_INPUT always rolls back to a unit boundary.
//
// Built into libcompu_runtime.so (see compu_tpu/runtime/native.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

constexpr int NEED_INPUT = 0;
constexpr int NEED_OUTPUT = 1;
constexpr int DONE = 2;
constexpr int EMAGIC = -1;     // ERR_MAGIC
constexpr int EFRAME = -2;     // ERR_FRAME
constexpr int EBLOCK = -3;     // ERR_BLOCK
constexpr int ELITERALS = -4;  // ERR_LITERALS
constexpr int ESEQ = -5;       // ERR_SEQUENCES
constexpr int EOFFSET = -6;    // ERR_OFFSET
constexpr int ECHECKSUM = -7;  // ERR_CHECKSUM
constexpr int EWINDOW = -8;    // ERR_WINDOW
constexpr int EDICT = -9;      // ERR_DICT

constexpr uint32_t ZSTD_MAGIC = 0xFD2FB528u;
constexpr uint32_t SKIPPABLE_LOW = 0x184D2A50u;
constexpr size_t MAX_BLOCK = 128 * 1024;
constexpr int HUF_MAX_BITS = 11;

// --- sequence code tables (RFC 8878 §3.1.1.3.2.1; normative constants) ---
static const uint32_t LL_BASE[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
    2048, 4096, 8192, 16384, 32768, 65536};
static const uint8_t LL_BITS[36] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t ML_BASE[53] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37,
    39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051,
    4099, 8195, 16387, 32771, 65539};
static const uint8_t ML_BITS[53] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2,
    3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// Predefined FSE distributions (RFC 8878; accuracy logs 6/6/5).
static const int16_t LL_DEF[36] = {
    4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
    -1, -1, -1, -1};
static const int16_t ML_DEF[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
    -1, -1, -1, -1, -1};
static const int16_t OF_DEF[29] = {
    1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

constexpr int MAX_LL_SYMBOL = 35, MAX_ML_SYMBOL = 52, MAX_OF_SYMBOL = 31;
constexpr int MAX_LL_LOG = 9, MAX_ML_LOG = 9, MAX_OF_LOG = 8;

// ---------------------------------------------------------------------------
// streaming xxh64 (frame content checksum)
// ---------------------------------------------------------------------------
constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
                   P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
                   P5 = 0x27D4EB2F165667C5ULL;
static inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

struct Xxh64Stream {
    uint64_t v1, v2, v3, v4;
    uint64_t total;
    uint8_t buf[32];
    size_t buflen;

    void reset() {
        v1 = P1 + P2; v2 = P2; v3 = 0; v4 = 0 - P1;  // seed 0
        total = 0;
        buflen = 0;
    }
    void round(const uint8_t* p) {
        uint64_t k;
        memcpy(&k, p, 8);      v1 = rotl64(v1 + k * P2, 31) * P1;
        memcpy(&k, p + 8, 8);  v2 = rotl64(v2 + k * P2, 31) * P1;
        memcpy(&k, p + 16, 8); v3 = rotl64(v3 + k * P2, 31) * P1;
        memcpy(&k, p + 24, 8); v4 = rotl64(v4 + k * P2, 31) * P1;
    }
    void update(const uint8_t* p, size_t n) {
        total += n;
        if (buflen) {
            size_t need = 32 - buflen;
            if (n < need) { memcpy(buf + buflen, p, n); buflen += n; return; }
            memcpy(buf + buflen, p, need);
            round(buf);
            p += need; n -= need; buflen = 0;
        }
        while (n >= 32) { round(p); p += 32; n -= 32; }
        if (n) { memcpy(buf, p, n); buflen = n; }
    }
    uint64_t digest() const {
        uint64_t h;
        if (total >= 32) {
            h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
            const uint64_t vs[4] = {v1, v2, v3, v4};
            for (int i = 0; i < 4; i++) {
                h ^= rotl64(vs[i] * P2, 31) * P1;
                h = h * P1 + P4;
            }
        } else {
            h = P5;  // seed 0 + P5
        }
        h += total;
        const uint8_t* p = buf;
        const uint8_t* end = buf + buflen;
        while (p + 8 <= end) {
            uint64_t k;
            memcpy(&k, p, 8);
            h ^= rotl64(k * P2, 31) * P1;
            h = rotl64(h, 27) * P1 + P4;
            p += 8;
        }
        if (p + 4 <= end) {
            uint32_t k;
            memcpy(&k, p, 4);
            h ^= (uint64_t)k * P1;
            h = rotl64(h, 23) * P2 + P3;
            p += 4;
        }
        while (p < end) {
            h ^= (*p++) * P5;
            h = rotl64(h, 11) * P1;
        }
        h ^= h >> 33; h *= P2; h ^= h >> 29; h *= P3; h ^= h >> 32;
        return h;
    }
};

// ---------------------------------------------------------------------------
// backward bit reader: the stream is one little-endian integer; the last
// non-zero byte's top set bit is a sentinel; reads consume high bits
// downward. Position is kept as an absolute bit index (may go negative at
// the tail: reads then zero-fill from below, which the format permits).
// ---------------------------------------------------------------------------
struct BackBits {
    const uint8_t* p;
    size_t len;
    long long bitpos;  // bits remaining above the read point
    bool bad;

    bool init(const uint8_t* data, size_t n) {
        p = data;
        len = n;
        bad = false;
        if (n == 0 || data[n - 1] == 0) return false;
        int top = 31 - __builtin_clz((uint32_t)data[n - 1]);
        bitpos = (long long)(n - 1) * 8 + top;  // sentinel dropped
        return true;
    }
    // extract `n` bits at absolute bit position `pos` (pos >= 0)
    inline uint64_t extract(long long pos, int n) const {
        size_t byte = (size_t)(pos >> 3);
        int shift = (int)(pos & 7);
        uint64_t v = 0;
        size_t avail = len - byte;
        if (avail >= 8) {
            memcpy(&v, p + byte, 8);
        } else {
            memcpy(&v, p + byte, avail);
        }
        v >>= shift;
        if (shift + n > 64 && avail >= 8) {
            // straddles the 8-byte load; top bits come from the next byte
            uint64_t hi = (byte + 8 < len) ? p[byte + 8] : 0;
            v |= hi << (64 - shift);
        }
        return n >= 64 ? v : (v & ((1ULL << n) - 1));
    }
    inline uint32_t read(int n) {
        bitpos -= n;
        if (n == 0) return 0;
        if (bitpos >= 0) return (uint32_t)extract(bitpos, n);
        if (bitpos < -64) { bad = true; return 0; }
        long long over = -bitpos;  // bits below zero read as zero
        if (over >= n) return 0;
        return (uint32_t)(extract(0, (int)(n - over)) << over);
    }
    // peek n bits without consuming (for Huffman max-bits lookahead)
    inline uint32_t peek(int n) const {
        long long pos = bitpos - n;
        if (pos >= 0) return (uint32_t)extract(pos, n);
        long long over = -pos;
        if (over >= n) return 0;
        return (uint32_t)(extract(0, (int)(n - over)) << over);
    }
};

// ---------------------------------------------------------------------------
// forward bit reader (FSE table descriptions)
// ---------------------------------------------------------------------------
struct FwdBits {
    const uint8_t* p;
    size_t len;
    size_t bitpos;
    bool bad;

    uint32_t read(int n) {
        if (n == 0) return 0;
        size_t byte = bitpos >> 3;
        if (byte >= len) { bad = true; return 0; }
        uint64_t v = 0;
        size_t avail = len - byte;
        memcpy(&v, p + byte, avail >= 8 ? 8 : avail);
        uint32_t r = (uint32_t)((v >> (bitpos & 7)) & ((1ULL << n) - 1));
        bitpos += n;
        return r;
    }
};

// ---------------------------------------------------------------------------
// FSE decode table (max accuracy log 9 -> 512 entries)
// ---------------------------------------------------------------------------
struct FseTable {
    uint8_t symbol[512];
    uint8_t nbits[512];
    uint16_t baseline[512];
    int table_log;
    int rle;  // >= 0: degenerate single-symbol mode, table unused
    bool valid;
};

static bool fse_build(FseTable& t, const int16_t* counts, int nsyms, int table_log) {
    t.table_log = table_log;
    t.rle = -1;
    int size = 1 << table_log;
    int16_t spread[512];
    for (int i = 0; i < size; i++) spread[i] = -1;
    int high = size - 1;
    for (int s = 0; s < nsyms; s++)
        if (counts[s] == -1) spread[high--] = (int16_t)s;
    int pos = 0;
    int step = (size >> 1) + (size >> 3) + 3;
    int mask = size - 1;
    for (int s = 0; s < nsyms; s++) {
        if (counts[s] <= 0) continue;
        for (int c = 0; c < counts[s]; c++) {
            spread[pos] = (int16_t)s;
            pos = (pos + step) & mask;
            while (pos > high) pos = (pos + step) & mask;
        }
    }
    if (pos != 0) return false;
    for (int i = 0; i < size; i++)
        if (spread[i] < 0) return false;
    uint16_t symbol_next[256];
    for (int s = 0; s < nsyms; s++)
        symbol_next[s] = (uint16_t)(counts[s] > 0 ? counts[s] : 1);
    for (int i = 0; i < size; i++) {
        int s = spread[i];
        uint32_t x = symbol_next[s]++;
        int hb = 31 - __builtin_clz(x);
        int nb = table_log - hb;
        t.symbol[i] = (uint8_t)s;
        t.nbits[i] = (uint8_t)nb;
        t.baseline[i] = (uint16_t)((x << nb) - size);
    }
    t.valid = true;
    return true;
}

// FSE_readNCount semantics (forward bitstream). Returns bytes consumed
// (rounded up), or -1 on corruption. counts[] zero-filled to max_symbol+1.
static int fse_read_counts(const uint8_t* data, size_t len, int max_symbol,
                           int max_log, int16_t* counts, int* table_log_out) {
    FwdBits r{data, len, 0, false};
    int table_log = (int)r.read(4) + 5;
    if (r.bad || table_log > max_log) return -1;
    int size = 1 << table_log;
    int remaining = size + 1;
    int threshold = size;
    int nbits = table_log + 1;
    int n = 0;
    bool previous0 = false;
    for (int i = 0; i <= max_symbol; i++) counts[i] = 0;
    while (remaining > 1 && n <= max_symbol) {
        if (previous0) {
            for (;;) {
                uint32_t rep = r.read(2);
                if (r.bad) return -1;
                for (uint32_t k = 0; k < rep && n <= max_symbol; k++) counts[n++] = 0;
                if (rep != 3) break;
            }
            previous0 = false;
            if (n > max_symbol) break;
            continue;
        }
        int maxv = (2 * threshold - 1) - remaining;
        // speculative wide read, then decide how many bits were really used
        size_t save = r.bitpos;
        uint32_t val = r.read(nbits);
        if (r.bad) {
            // near the tail a full-width read may overrun even though the
            // short form fits; retry with nbits-1
            r.bad = false;
            r.bitpos = save;
            val = r.read(nbits - 1);
            if (r.bad) return -1;
            val &= (uint32_t)(threshold - 1);
            if ((int)val >= maxv) return -1;
            // fall through with short form
            int count = (int)val - 1;
            remaining -= count < 0 ? -count : count;
            counts[n++] = (int16_t)count;
            previous0 = (count == 0);
            while (remaining < threshold) { nbits--; threshold >>= 1; }
            continue;
        }
        int count;
        if ((int)(val & (threshold - 1)) < maxv) {
            count = (int)(val & (threshold - 1));
            r.bitpos = save + (size_t)(nbits - 1);
        } else {
            count = (int)(val & (2 * threshold - 1));
            if (count >= threshold) count -= maxv;
        }
        count -= 1;  // transmitted value = probability + 1
        remaining -= count < 0 ? -count : count;
        counts[n++] = (int16_t)count;
        previous0 = (count == 0);
        while (remaining < threshold) { nbits--; threshold >>= 1; }
    }
    if (remaining != 1 || n > max_symbol + 1) return -1;
    *table_log_out = table_log;
    return (int)((r.bitpos + 7) / 8);
}

// ---------------------------------------------------------------------------
// zstd canonical Huffman (max 11 bits): flat LUT indexed by the next
// max_bits stream bits.
// ---------------------------------------------------------------------------
struct HufTable {
    uint8_t symbol[1 << HUF_MAX_BITS];
    uint8_t nbits[1 << HUF_MAX_BITS];
    int max_bits;
    bool valid;
};

static bool huf_build(HufTable& t, const uint8_t* weights, int n) {
    uint64_t total = 0;
    for (int i = 0; i < n; i++)
        if (weights[i] > 0) total += 1ULL << (weights[i] - 1);
    if (total == 0) return false;
    int m = 64 - __builtin_clzll(total - 1);
    if (total == 1) m = 0;
    if ((1ULL << m) != total || m > HUF_MAX_BITS || m == 0) return false;
    t.max_bits = m;
    size_t size = (size_t)1 << m;
    // canonical fill: ascending weight (longest codes first), symbols in
    // natural order within a weight; weight-w symbols span 2^(w-1) cells
    size_t pos = 0;
    for (int w = 1; w <= m; w++) {
        size_t span = (size_t)1 << (w - 1);
        int nb = m + 1 - w;
        for (int s = 0; s < n; s++) {
            if (weights[s] != w) continue;
            if (pos + span > size) return false;
            memset(t.symbol + pos, s, span);
            memset(t.nbits + pos, nb, span);
            pos += span;
        }
    }
    if (pos != size) return false;
    t.valid = true;
    return true;
}

// Parse a Huffman tree description; fills weights[] (incl. derived last
// weight), sets *nweights, returns bytes consumed or -1.
static int huf_read_weights(const uint8_t* data, size_t len, uint8_t* weights,
                            int* nweights) {
    if (len == 0) return -1;
    int header = data[0];
    int n;
    int consumed;
    if (header >= 128) {
        n = header - 127;
        int nbytes = (n + 1) / 2;
        if ((size_t)(1 + nbytes) > len) return -1;
        for (int i = 0; i < n; i++) {
            uint8_t b = data[1 + i / 2];
            weights[i] = (i % 2 == 0) ? (b >> 4) : (b & 0x0F);
        }
        consumed = 1 + nbytes;
    } else {
        int csize = header;
        if ((size_t)(1 + csize) > len) return -1;
        const uint8_t* blob = data + 1;
        int16_t counts[256];
        int table_log;
        int used = fse_read_counts(blob, (size_t)csize, 255, 6, counts, &table_log);
        if (used < 0) return -1;
        FseTable ft;
        if (!fse_build(ft, counts, 256, table_log)) return -1;
        BackBits r;
        if (used >= csize || !r.init(blob + used, (size_t)(csize - used))) return -1;
        uint32_t s1 = r.read(table_log);
        uint32_t s2 = r.read(table_log);
        n = 0;
        for (;;) {
            // up to 255 explicit weights (the 256th is derived below)
            if (n >= 255) return -1;
            weights[n++] = ft.symbol[s1];
            s1 = ft.baseline[s1] + r.read(ft.nbits[s1]);
            if (r.bitpos < 0) {
                if (n >= 255) return -1;
                weights[n++] = ft.symbol[s2];
                break;
            }
            if (n >= 255) return -1;
            weights[n++] = ft.symbol[s2];
            s2 = ft.baseline[s2] + r.read(ft.nbits[s2]);
            if (r.bitpos < 0) {
                if (n >= 255) return -1;
                weights[n++] = ft.symbol[s1];
                break;
            }
            if (n > 254) return -1;
        }
        if (r.bad) return -1;
        consumed = 1 + csize;
    }
    // derive the last weight (power-of-two completion)
    uint64_t total = 0;
    for (int i = 0; i < n; i++)
        if (weights[i] > 0) total += 1ULL << (weights[i] - 1);
    if (total == 0 || n > 255) return -1;
    // pow2 = smallest power of two >= total; if exact, bump (the derived
    // last symbol must have a nonzero weight)
    uint64_t pow2 = total == 1 ? 1 : 1ULL << (64 - __builtin_clzll(total - 1));
    if (pow2 == total) pow2 <<= 1;
    uint64_t missing = pow2 - total;
    // missing must itself be a power of two
    if (missing == 0 || (missing & (missing - 1)) != 0) return -1;
    int last_w = 64 - __builtin_clzll(missing);
    if (last_w > HUF_MAX_BITS) return -1;
    weights[n++] = (uint8_t)last_w;
    *nweights = n;
    return consumed;
}

// ---------------------------------------------------------------------------
// decoder state
// ---------------------------------------------------------------------------
enum Phase { P_MAGIC, P_SKIPPABLE, P_FRAME_HEADER, P_BLOCK, P_CHECKSUM, P_DONE };

struct ZstdState {
    int phase;
    int window_log_max;
    uint64_t skippable_remaining;
    bool has_checksum, single_segment, last_block;
    long long content_size;  // -1 unknown
    uint64_t window_size;
    uint64_t frame_decoded;
    Xxh64Stream xxh;
    uint32_t rep[3];
    FseTable ll, of, ml;
    HufTable huf;
    uint8_t* win;
    size_t win_cap, win_len;
    size_t pending;  // undrained decoded bytes at the tail of win
    uint8_t literals[MAX_BLOCK];
};

static bool win_reserve(ZstdState* s, size_t extra) {
    if (s->win_len + extra <= s->win_cap) return true;
    size_t cap = s->win_cap ? s->win_cap : (1 << 20);
    while (cap < s->win_len + extra) cap *= 2;
    uint8_t* nw = (uint8_t*)realloc(s->win, cap);
    if (!nw) return false;
    s->win = nw;
    s->win_cap = cap;
    return true;
}

static void win_compact(ZstdState* s) {
    // keep window_size + MAX_BLOCK of history (plus anything undrained)
    size_t limit = (size_t)s->window_size + MAX_BLOCK;
    if (limit < s->pending) limit = s->pending;
    if (s->win_len > limit + (1 << 20)) {
        size_t keep = limit;
        memmove(s->win, s->win + s->win_len - keep, keep);
        s->win_len = keep;
    }
}

// decode one compressed block's literals section.
// Returns bytes consumed from `block`, sets *lit_len; -ELITERALS style code on error.
static long long decode_literals(ZstdState* s, const uint8_t* block, size_t len,
                                 size_t* lit_len) {
    if (len == 0) return ELITERALS;
    int b0 = block[0];
    int lit_type = b0 & 3;
    int size_format = (b0 >> 2) & 3;
    if (lit_type <= 1) {  // Raw / RLE
        size_t regen, hdr;
        if (size_format == 0 || size_format == 2) {
            regen = (size_t)(b0 >> 3);
            hdr = 1;
        } else if (size_format == 1) {
            if (len < 2) return ELITERALS;
            regen = (size_t)((b0 >> 4) | (block[1] << 4));
            hdr = 2;
        } else {
            if (len < 3) return ELITERALS;
            regen = (size_t)((b0 >> 4) | (block[1] << 4) | (block[2] << 12));
            hdr = 3;
        }
        if (regen > MAX_BLOCK) return ELITERALS;
        if (lit_type == 0) {
            if (len < hdr + regen) return ELITERALS;
            memcpy(s->literals, block + hdr, regen);
            *lit_len = regen;
            return (long long)(hdr + regen);
        }
        if (len <= hdr) return ELITERALS;
        memset(s->literals, block[hdr], regen);
        *lit_len = regen;
        return (long long)(hdr + 1);
    }
    // Compressed (2) / Treeless (3)
    size_t regen, comp, hdr;
    int streams;
    if (size_format == 0) {
        if (len < 3) return ELITERALS;
        streams = 1;
        regen = (size_t)((b0 >> 4) | ((block[1] & 0x3F) << 4));
        comp = (size_t)((block[1] >> 6) | (block[2] << 2));
        hdr = 3;
    } else if (size_format == 1) {
        if (len < 3) return ELITERALS;
        streams = 4;
        regen = (size_t)((b0 >> 4) | ((block[1] & 0x3F) << 4));
        comp = (size_t)((block[1] >> 6) | (block[2] << 2));
        hdr = 3;
    } else if (size_format == 2) {
        if (len < 4) return ELITERALS;
        streams = 4;
        regen = (size_t)((b0 >> 4) | (block[1] << 4) | ((block[2] & 3) << 12));
        comp = (size_t)((block[2] >> 2) | (block[3] << 6));
        hdr = 4;
    } else {
        if (len < 5) return ELITERALS;
        streams = 4;
        regen = (size_t)((b0 >> 4) | (block[1] << 4) | ((block[2] & 0x3F) << 12));
        comp = (size_t)((block[2] >> 6) | (block[3] << 2) | (block[4] << 10));
        hdr = 5;
    }
    if (regen > MAX_BLOCK || len < hdr + comp) return ELITERALS;
    const uint8_t* payload = block + hdr;
    size_t plen = comp;
    if (lit_type == 2) {
        uint8_t weights[256];
        int nw;
        int used = huf_read_weights(payload, plen, weights, &nw);
        if (used < 0 || !huf_build(s->huf, weights, nw)) return ELITERALS;
        payload += used;
        plen -= (size_t)used;
    } else if (!s->huf.valid) {
        return ELITERALS;  // treeless literals without a prior tree
    }
    const HufTable& t = s->huf;
    int m = t.max_bits;
    uint8_t* dst = s->literals;
    if (streams == 1) {
        BackBits r;
        if (!r.init(payload, plen)) return ELITERALS;
        for (size_t i = 0; i < regen; i++) {
            uint32_t idx = r.peek(m);
            int nb = t.nbits[idx];
            if (nb == 0) return ELITERALS;
            dst[i] = t.symbol[idx];
            r.bitpos -= nb;
            if (r.bitpos < -32) return ELITERALS;
        }
    } else {
        if (plen < 6) return ELITERALS;
        size_t s1 = (size_t)(payload[0] | (payload[1] << 8));
        size_t s2 = (size_t)(payload[2] | (payload[3] << 8));
        size_t s3 = (size_t)(payload[4] | (payload[5] << 8));
        const uint8_t* body = payload + 6;
        size_t blen = plen - 6;
        if (blen < s1 + s2 + s3) return ELITERALS;
        size_t sizes[4] = {s1, s2, s3, blen - s1 - s2 - s3};
        size_t per = (regen + 3) / 4;
        size_t cnts[4] = {per, per, per, regen - 3 * per};
        if (regen < 3 * per) return ELITERALS;
        size_t off = 0;
        for (int k = 0; k < 4; k++) {
            BackBits r;
            if (!r.init(body + off, sizes[k])) return ELITERALS;
            for (size_t i = 0; i < cnts[k]; i++) {
                uint32_t idx = r.peek(m);
                int nb = t.nbits[idx];
                if (nb == 0) return ELITERALS;
                *dst++ = t.symbol[idx];
                r.bitpos -= nb;
                if (r.bitpos < -32) return ELITERALS;
            }
            off += sizes[k];
        }
    }
    *lit_len = regen;
    return (long long)(hdr + comp);
}

// read one sequence-section table header; returns bytes consumed or <0 error
static int read_seq_table(ZstdState* s, const uint8_t* data, size_t len, int mode,
                          FseTable& t, const int16_t* def_dist, int def_nsyms,
                          int def_log, int max_symbol, int max_log) {
    if (mode == 0) {  // predefined
        if (!fse_build(t, def_dist, def_nsyms, def_log)) return ESEQ;
        return 0;
    }
    if (mode == 1) {  // RLE
        if (len == 0) return ESEQ;
        if (data[0] > max_symbol) return ESEQ;
        t.rle = data[0];
        t.valid = true;
        return 1;
    }
    if (mode == 2) {  // FSE compressed
        int16_t counts[64];
        int table_log;
        int used = fse_read_counts(data, len, max_symbol, max_log, counts, &table_log);
        if (used < 0) return ESEQ;
        if (!fse_build(t, counts, max_symbol + 1, table_log)) return ESEQ;
        return used;
    }
    // mode 3: repeat — table (or RLE) persists from the previous block
    if (!t.valid) return ESEQ;
    return 0;
}

// Decode one compressed block into the window tail. Returns produced byte
// count, or <0 error.
static long long decode_block(ZstdState* s, const uint8_t* block, size_t len) {
    size_t lit_len = 0;
    long long used = decode_literals(s, block, len, &lit_len);
    if (used < 0) return used;
    const uint8_t* data = block + used;
    size_t dlen = len - (size_t)used;
    if (dlen == 0) return ESEQ;
    // sequence count
    size_t nseq;
    size_t p;
    int b0 = data[0];
    if (b0 == 0) {
        nseq = 0;
        p = 1;
    } else if (b0 < 128) {
        nseq = (size_t)b0;
        p = 1;
    } else if (b0 < 255) {
        if (dlen < 2) return ESEQ;
        nseq = ((size_t)(b0 - 128) << 8) + data[1];
        p = 2;
    } else {
        if (dlen < 3) return ESEQ;
        nseq = (size_t)data[1] + ((size_t)data[2] << 8) + 0x7F00;
        p = 3;
    }
    if (nseq == 0) {
        // literals only
        if (!win_reserve(s, lit_len)) return EBLOCK;
        memcpy(s->win + s->win_len, s->literals, lit_len);
        s->win_len += lit_len;
        return (long long)lit_len;
    }
    if (dlen <= p) return ESEQ;
    int modes = data[p];
    if (modes & 3) return ESEQ;
    p += 1;
    int ll_mode = (modes >> 6) & 3;
    int of_mode = (modes >> 4) & 3;
    int ml_mode = (modes >> 2) & 3;
    int r;
    s->ll.rle = (ll_mode == 3) ? s->ll.rle : -1;
    r = read_seq_table(s, data + p, dlen - p, ll_mode, s->ll, LL_DEF, 36,
                       6, MAX_LL_SYMBOL, MAX_LL_LOG);
    if (r < 0) return r;
    p += (size_t)r;
    s->of.rle = (of_mode == 3) ? s->of.rle : -1;
    r = read_seq_table(s, data + p, dlen - p, of_mode, s->of, OF_DEF, 29,
                       5, MAX_OF_SYMBOL, MAX_OF_LOG);
    if (r < 0) return r;
    p += (size_t)r;
    s->ml.rle = (ml_mode == 3) ? s->ml.rle : -1;
    r = read_seq_table(s, data + p, dlen - p, ml_mode, s->ml, ML_DEF, 53,
                       6, MAX_ML_SYMBOL, MAX_ML_LOG);
    if (r < 0) return r;
    p += (size_t)r;
    if (p > dlen) return ESEQ;

    BackBits br;
    if (!br.init(data + p, dlen - p)) return ESEQ;
    uint32_t ll_state = 0, of_state = 0, ml_state = 0;
    if (s->ll.rle < 0) ll_state = br.read(s->ll.table_log);
    if (s->of.rle < 0) of_state = br.read(s->of.table_log);
    if (s->ml.rle < 0) ml_state = br.read(s->ml.table_log);
    if (br.bad) return ESEQ;

    // worst-case output bound for the reserve: lit_len + sum(ml). We grow
    // as we go instead: reserve per sequence (cheap amortized).
    size_t produced = 0;
    size_t lit_pos = 0;
    uint32_t* rep = s->rep;
    for (size_t i = 0; i < nseq; i++) {
        int of_code = s->of.rle >= 0 ? s->of.rle : s->of.symbol[of_state];
        int ml_sym = s->ml.rle >= 0 ? s->ml.rle : s->ml.symbol[ml_state];
        int ll_sym = s->ll.rle >= 0 ? s->ll.rle : s->ll.symbol[ll_state];
        if (of_code > MAX_OF_SYMBOL || ml_sym > MAX_ML_SYMBOL || ll_sym > MAX_LL_SYMBOL)
            return ESEQ;
        // extra bits: offset, then match length, then literals length
        uint64_t offset_value = (1ULL << of_code) + br.read(of_code);
        size_t ml = (size_t)ML_BASE[ml_sym] + br.read(ML_BITS[ml_sym]);
        size_t ll = (size_t)LL_BASE[ll_sym] + br.read(LL_BITS[ll_sym]);
        if (br.bad) return ESEQ;
        uint64_t offset;
        if (offset_value > 3) {
            offset = offset_value - 3;
            rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = (uint32_t)offset;
        } else {
            unsigned idx = (unsigned)(offset_value - 1) + (ll == 0 ? 1 : 0);
            if (idx == 0) {
                offset = rep[0];
            } else if (idx == 1) {
                offset = rep[1];
                rep[1] = rep[0]; rep[0] = (uint32_t)offset;
            } else if (idx == 2) {
                offset = rep[2];
                rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = (uint32_t)offset;
            } else {  // ll == 0 && offset_value == 3
                if (rep[0] <= 1) return EOFFSET;
                offset = rep[0] - 1;
                rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = (uint32_t)offset;
            }
        }
        // literals copy
        if (lit_pos + ll > lit_len) return ESEQ;
        if (!win_reserve(s, ll + ml)) return EBLOCK;
        memcpy(s->win + s->win_len, s->literals + lit_pos, ll);
        s->win_len += ll;
        lit_pos += ll;
        produced += ll;
        // match copy
        if (ml) {
            if (offset > s->win_len) return EOFFSET;
            uint8_t* dst = s->win + s->win_len;
            const uint8_t* src = dst - offset;
            if (offset >= ml) {
                memcpy(dst, src, ml);
            } else {
                for (size_t k = 0; k < ml; k++) dst[k] = src[k];
            }
            s->win_len += ml;
            produced += ml;
        }
        // state updates (not after the last sequence): ll, ml, of order
        if (i + 1 < nseq) {
            if (s->ll.rle < 0)
                ll_state = s->ll.baseline[ll_state] + br.read(s->ll.nbits[ll_state]);
            if (s->ml.rle < 0)
                ml_state = s->ml.baseline[ml_state] + br.read(s->ml.nbits[ml_state]);
            if (s->of.rle < 0)
                of_state = s->of.baseline[of_state] + br.read(s->of.nbits[of_state]);
            if (br.bad) return ESEQ;
        }
    }
    // trailing literals
    size_t tail = lit_len - lit_pos;
    if (tail) {
        if (!win_reserve(s, tail)) return EBLOCK;
        memcpy(s->win + s->win_len, s->literals + lit_pos, tail);
        s->win_len += tail;
        produced += tail;
    }
    return (long long)produced;
}

}  // namespace

extern "C" {

void* compu_zstd_new(int window_log_max) {
    ZstdState* s = (ZstdState*)calloc(1, sizeof(ZstdState));
    if (!s) return nullptr;
    s->window_log_max = window_log_max > 0 ? window_log_max : 31;
    s->phase = P_MAGIC;
    s->rep[0] = 1; s->rep[1] = 4; s->rep[2] = 8;
    s->xxh.reset();
    return s;
}

void compu_zstd_free(void* p) {
    if (!p) return;
    ZstdState* s = (ZstdState*)p;
    free(s->win);
    free(s);
}

void compu_zstd_reset(void* p) {
    ZstdState* s = (ZstdState*)p;
    uint8_t* win = s->win;
    size_t cap = s->win_cap;
    int wlm = s->window_log_max;
    memset(s, 0, sizeof(ZstdState));
    s->win = win;
    s->win_cap = cap;
    s->window_log_max = wlm;
    s->phase = P_MAGIC;
    s->rep[0] = 1; s->rep[1] = 4; s->rep[2] = 8;
    s->xxh.reset();
}

int compu_zstd_run(void* p, const uint8_t* in, size_t in_len,
                   uint8_t* out, size_t out_cap,
                   size_t* in_consumed, size_t* out_written) {
    ZstdState* s = (ZstdState*)p;
    size_t ip = 0;  // input position
    size_t op = 0;  // output position
    int status = NEED_INPUT;

    // drain pending first
    if (s->pending) {
        size_t take = s->pending < out_cap ? s->pending : out_cap;
        memcpy(out, s->win + s->win_len - s->pending, take);
        s->pending -= take;
        op += take;
        if (s->pending) { status = NEED_OUTPUT; goto finish; }
    }

    for (;;) {
        size_t avail = in_len - ip;
        if (s->phase == P_DONE) { status = DONE; break; }
        if (s->phase == P_MAGIC) {
            if (avail < 4) { status = NEED_INPUT; break; }
            uint32_t word;
            memcpy(&word, in + ip, 4);
            if (word == ZSTD_MAGIC) {
                ip += 4;
                s->phase = P_FRAME_HEADER;
            } else if (word >= SKIPPABLE_LOW && word <= SKIPPABLE_LOW + 15) {
                if (avail < 8) { status = NEED_INPUT; break; }
                uint32_t size;
                memcpy(&size, in + ip + 4, 4);
                ip += 8;
                s->skippable_remaining = size;
                s->phase = P_SKIPPABLE;
            } else {
                status = EMAGIC; break;
            }
            continue;
        }
        if (s->phase == P_SKIPPABLE) {
            size_t take = avail < s->skippable_remaining ? avail : (size_t)s->skippable_remaining;
            ip += take;
            s->skippable_remaining -= take;
            if (s->skippable_remaining) { status = NEED_INPUT; break; }
            s->phase = P_MAGIC;
            continue;
        }
        if (s->phase == P_FRAME_HEADER) {
            if (avail < 1) { status = NEED_INPUT; break; }
            int fhd = in[ip];
            int fcs_flag = fhd >> 6;
            bool single_segment = (fhd & 0x20) != 0;
            bool has_checksum = (fhd & 0x04) != 0;
            int dict_flag = fhd & 3;
            if (fhd & 0x08) { status = EFRAME; break; }
            size_t need = 1;
            if (!single_segment) need += 1;
            static const int dict_sizes[4] = {0, 1, 2, 4};
            static const int fcs_sizes[4] = {0, 2, 4, 8};
            need += (size_t)dict_sizes[dict_flag];
            int fcs_size = fcs_sizes[fcs_flag];
            if (single_segment && fcs_flag == 0) fcs_size = 1;
            need += (size_t)fcs_size;
            if (avail < need) { status = NEED_INPUT; break; }
            size_t q = ip + 1;
            uint64_t window_size = 0;
            if (!single_segment) {
                int wd = in[q++];
                int exponent = wd >> 3, mantissa = wd & 7;
                uint64_t base = 1ULL << (10 + exponent);
                window_size = base + (base / 8) * (uint64_t)mantissa;
            }
            if (dict_flag) { status = EDICT; break; }
            long long content_size = -1;
            if (fcs_size) {
                uint64_t raw = 0;
                memcpy(&raw, in + q, (size_t)fcs_size);
                q += (size_t)fcs_size;
                if (fcs_size == 2) raw += 256;
                content_size = (long long)raw;
            }
            if (single_segment) window_size = (uint64_t)(content_size < 0 ? 0 : content_size);
            if (window_size > (1ULL << s->window_log_max)) { status = EWINDOW; break; }
            ip = q;
            s->single_segment = single_segment;
            s->has_checksum = has_checksum;
            s->content_size = content_size;
            s->window_size = window_size ? window_size : (1ULL << 27);
            s->phase = P_BLOCK;
            s->last_block = false;
            s->rep[0] = 1; s->rep[1] = 4; s->rep[2] = 8;
            s->huf.valid = false;
            s->ll.valid = s->of.valid = s->ml.valid = false;
            s->ll.rle = s->of.rle = s->ml.rle = -1;
            s->xxh.reset();
            s->frame_decoded = 0;
            continue;
        }
        if (s->phase == P_BLOCK) {
            if (avail < 3) { status = NEED_INPUT; break; }
            uint32_t hdr = (uint32_t)in[ip] | ((uint32_t)in[ip + 1] << 8) |
                           ((uint32_t)in[ip + 2] << 16);
            bool last = hdr & 1;
            int btype = (hdr >> 1) & 3;
            size_t size = hdr >> 3;
            size_t q = ip + 3;
            long long produced;
            if (btype == 0) {  // raw
                if (in_len - q < size) { status = NEED_INPUT; break; }
                if (!win_reserve(s, size)) { status = EBLOCK; break; }
                memcpy(s->win + s->win_len, in + q, size);
                s->win_len += size;
                produced = (long long)size;
                q += size;
            } else if (btype == 1) {  // RLE
                if (in_len - q < 1) { status = NEED_INPUT; break; }
                if (size > 32 * MAX_BLOCK) { status = EBLOCK; break; }
                if (!win_reserve(s, size)) { status = EBLOCK; break; }
                memset(s->win + s->win_len, in[q], size);
                s->win_len += size;
                produced = (long long)size;
                q += 1;
            } else if (btype == 2) {
                if (size > MAX_BLOCK) { status = EBLOCK; break; }
                if (in_len - q < size) { status = NEED_INPUT; break; }
                produced = decode_block(s, in + q, size);
                if (produced < 0) { status = (int)produced; break; }
                q += size;
            } else {
                status = EBLOCK; break;
            }
            ip = q;
            if (s->has_checksum)
                s->xxh.update(s->win + s->win_len - (size_t)produced, (size_t)produced);
            s->frame_decoded += (uint64_t)produced;
            s->pending += (size_t)produced;
            if (last) {
                if (s->content_size >= 0 &&
                    s->frame_decoded != (uint64_t)s->content_size) {
                    status = EFRAME; break;
                }
                s->phase = s->has_checksum ? P_CHECKSUM : P_DONE;
            }
            // drain what we can; stop on full output
            if (s->pending) {
                size_t take = s->pending < out_cap - op ? s->pending : out_cap - op;
                memcpy(out + op, s->win + s->win_len - s->pending, take);
                s->pending -= take;
                op += take;
                if (s->pending) { status = NEED_OUTPUT; break; }
            }
            win_compact(s);
            continue;
        }
        if (s->phase == P_CHECKSUM) {
            if (avail < 4) { status = NEED_INPUT; break; }
            uint32_t expect;
            memcpy(&expect, in + ip, 4);
            uint32_t got = (uint32_t)(s->xxh.digest() & 0xFFFFFFFFu);
            if (expect != got) { status = ECHECKSUM; break; }
            ip += 4;
            s->phase = P_DONE;
            continue;
        }
    }

finish:
    *in_consumed = ip;
    *out_written = op;
    return status;
}

}  // extern "C"
