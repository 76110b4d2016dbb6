// A Zstandard frame decoder (RFC 8878) and CRC-32C, for reading the JAX
// package's Orbax checkpoints (OCDBT nodes and zarr chunks are zstd frames)
// without libzstd. Plain C interface, loaded with ctypes by
// cenet_tpu_torch/native/__init__.py.
//
// Covered: raw, RLE and compressed blocks; raw, RLE, Huffman and treeless
// literals in one or four streams; sequences in predefined, RLE, FSE and
// repeat modes with the three repeat offsets; window and frame content sizes
// with or without the single-segment flag; skippable and concatenated frames;
// the XXH64 content checksum, verified when a frame carries one. A frame that
// names a dictionary is refused. Every read is bounds-checked: a truncated or
// corrupt input returns an error, never reads or writes out of range.

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
    std::string msg;
};

[[noreturn]] void fail(const char* what) { throw Error{what}; }

inline void need(bool ok, const char* what) {
    if (!ok) fail(what);
}

inline uint32_t rd16(const uint8_t* p) { return uint32_t(p[0]) | uint32_t(p[1]) << 8; }
inline uint32_t rd24(const uint8_t* p) { return rd16(p) | uint32_t(p[2]) << 16; }
inline uint32_t rd32(const uint8_t* p) { return rd16(p) | rd16(p + 2) << 16; }
inline uint64_t rd64(const uint8_t* p) { return uint64_t(rd32(p)) | uint64_t(rd32(p + 4)) << 32; }

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

// ---- XXH64 (content checksum) ------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL, P3 = 1609587929392839161ULL,
                   P4 = 9650029242287828579ULL, P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
    const uint8_t* end = p + n;
    uint64_t h;
    if (n >= 32) {
        uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
        for (; p + 32 <= end; p += 32) {
            v1 = xround(v1, rd64(p));
            v2 = xround(v2, rd64(p + 8));
            v3 = xround(v3, rd64(p + 16));
            v4 = xround(v4, rd64(p + 24));
        }
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
    } else {
        h = P5;
    }
    h += n;
    for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
    if (p + 4 <= end) {
        h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
        p += 4;
    }
    for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

// ---- bit readers --------------------------------------------------------------

// Bits of a buffer numbered from the least significant bit of byte 0; a
// backward stream (Huffman, FSE) is read from its top, which the last byte
// marks with its highest set bit. Reads below bit 0 return zeros and leave
// `pos` negative, which is how the decoders see that a stream overran.
struct BackBits {
    const uint8_t* p;
    size_t n;
    int64_t pos;

    BackBits(const uint8_t* src, size_t len) : p(src), n(len) {
        need(len > 0, "empty bitstream");
        uint8_t last = src[len - 1];
        need(last != 0, "bitstream without its end marker");
        pos = int64_t(len - 1) * 8 + highbit(last);
    }

    // the `k` bits (k <= 56) just below bit `top`, most significant first
    inline uint64_t bits_below(int64_t top, int k) const {
        if (k == 0) return 0;
        int64_t lo = top - k;
        if (lo >= 0) {
            size_t b = size_t(lo >> 3);
            uint64_t w = 0;
            if (b + 8 <= n) {
                std::memcpy(&w, p + b, 8);
            } else {
                for (size_t i = b; i < n; ++i) w |= uint64_t(p[i]) << (8 * (i - b));
            }
            return (w >> (lo & 7)) & ((uint64_t(1) << k) - 1);
        }
        if (top <= 0) return 0;
        // part of the window lies below bit 0: those bits are zeros
        uint64_t w = 0;
        size_t bytes = size_t((top + 7) >> 3);
        for (size_t i = 0; i < bytes && i < n; ++i) w |= uint64_t(p[i]) << (8 * i);
        w &= (top >= 64) ? ~uint64_t(0) : ((uint64_t(1) << top) - 1);
        return w << (-lo);
    }
    inline uint64_t peek(int k) const { return bits_below(pos, k); }
    inline uint64_t read(int k) {
        uint64_t v = bits_below(pos, k);
        pos -= k;
        return v;
    }
};

// ---- FSE ------------------------------------------------------------------------

struct FseCell {
    uint16_t symbol;
    uint8_t nbits;
    uint16_t base;
};

struct FseTable {
    int log = 0;
    std::vector<FseCell> cells;
};

// Build the decoding table of a normalized distribution (RFC 8878 4.1.1).
void build_fse(FseTable& t, const int16_t* norm, int nsym, int log) {
    const uint32_t size = 1u << log;
    t.log = log;
    t.cells.assign(size, FseCell{0, 0, 0});
    std::vector<uint32_t> next(nsym);
    uint32_t high = size - 1;
    for (int s = 0; s < nsym; ++s) {
        if (norm[s] == -1) {
            t.cells[high--].symbol = uint16_t(s);
            next[s] = 1;
        } else {
            next[s] = uint32_t(norm[s]);
        }
    }
    const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    uint32_t pos = 0;
    for (int s = 0; s < nsym; ++s) {
        for (int i = 0; i < norm[s]; ++i) {
            t.cells[pos].symbol = uint16_t(s);
            do {
                pos = (pos + step) & mask;
            } while (pos > high);
        }
    }
    need(pos == 0, "FSE distribution does not fill its table");
    for (uint32_t i = 0; i < size; ++i) {
        uint16_t s = t.cells[i].symbol;
        uint32_t x = next[s]++;
        int nb = log - highbit(x);
        t.cells[i].nbits = uint8_t(nb);
        t.cells[i].base = uint16_t((x << nb) - size);
    }
}

void build_rle(FseTable& t, int symbol) {
    t.log = 0;
    t.cells.assign(1, FseCell{uint16_t(symbol), 0, 0});
}

// Read an FSE table description (RFC 8878 4.1.1) from the front of src; returns
// the bytes it took.
size_t read_fse_table(FseTable& t, const uint8_t* src, size_t len, int max_symbol, int max_log) {
    need(len >= 1, "truncated FSE table description");
    // a forward bit reader over at most the whole input
    size_t bitpos = 0;
    auto bits = [&](int k) -> uint32_t {
        uint64_t w = 0;
        size_t b = bitpos >> 3;
        for (size_t i = 0; i < 8 && b + i < len; ++i) w |= uint64_t(src[b + i]) << (8 * i);
        return uint32_t((w >> (bitpos & 7)) & ((uint64_t(1) << k) - 1));
    };
    int log = int(bits(4)) + 5;
    bitpos += 4;
    need(log <= max_log, "FSE accuracy log too large");
    int16_t norm[256] = {0};
    int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1, sym = 0;
    bool prev_zero = false;
    while (remaining > 1 && sym <= max_symbol) {
        if (prev_zero) {
            int n0 = sym;
            for (;;) {
                uint32_t r = bits(2);
                bitpos += 2;
                n0 += int(r);
                if (r != 3) break;
                need(bitpos <= len * 8, "truncated FSE table description");
            }
            need(n0 <= max_symbol + 1, "FSE zero run past the last symbol");
            while (sym < n0) norm[sym++] = 0;
            if (sym > max_symbol) break;
        }
        int max = (2 * threshold - 1) - remaining;
        int count;
        uint32_t v = bits(nb);
        if (int(v & uint32_t(threshold - 1)) < max) {
            count = int(v & uint32_t(threshold - 1));
            bitpos += size_t(nb - 1);
        } else {
            count = int(v & uint32_t(2 * threshold - 1));
            if (count >= threshold) count -= max;
            bitpos += size_t(nb);
        }
        need(bitpos <= len * 8, "truncated FSE table description");
        --count;
        remaining -= count < 0 ? -count : count;
        norm[sym++] = int16_t(count);
        prev_zero = count == 0;
        while (remaining < threshold && nb > 1) {
            --nb;
            threshold >>= 1;
        }
    }
    need(remaining == 1, "FSE distribution does not sum to its table size");
    need(sym <= max_symbol + 1, "FSE symbol past the maximum");
    build_fse(t, norm, sym, log);
    return (bitpos + 7) >> 3;
}

// ---- Huffman literals ------------------------------------------------------------

struct HufCell {
    uint8_t symbol;
    uint8_t nbits;
};

struct HufTable {
    int max_bits = 0;
    std::vector<HufCell> cells;
};

// Read a Huffman tree description (RFC 8878 4.2.1); returns the bytes it took.
size_t read_huffman(HufTable& h, const uint8_t* src, size_t len) {
    need(len >= 1, "truncated Huffman tree description");
    uint8_t w[256] = {0};
    int n = 0;
    size_t used;
    uint32_t header = src[0];
    if (header < 128) {  // FSE-compressed weights, two interleaved states
        size_t csize = header;
        need(csize >= 1 && 1 + csize <= len, "truncated Huffman weights");
        FseTable t;
        size_t tsize = read_fse_table(t, src + 1, csize, 255, 6);
        need(tsize < csize, "Huffman weights without a bitstream");
        BackBits br(src + 1 + tsize, csize - tsize);
        uint32_t s1 = uint32_t(br.read(t.log)), s2 = uint32_t(br.read(t.log));
        need(br.pos >= 0, "truncated Huffman weights bitstream");
        auto emit = [&](uint32_t s) {
            need(n < 255, "too many Huffman weights");
            w[n++] = uint8_t(t.cells[s].symbol);
        };
        auto update = [&](uint32_t& s) {
            const FseCell& c = t.cells[s];
            s = c.base + uint32_t(br.read(c.nbits));
        };
        for (;;) {
            emit(s1);
            update(s1);
            if (br.pos < 0) {
                emit(s2);
                break;
            }
            emit(s2);
            update(s2);
            if (br.pos < 0) {
                emit(s1);
                break;
            }
        }
        used = 1 + csize;
    } else {  // direct 4-bit weights
        n = int(header) - 127;
        size_t bytes = size_t(n + 1) / 2;
        need(1 + bytes <= len, "truncated Huffman weights");
        for (int i = 0; i < n; ++i) w[i] = (i & 1) ? (src[1 + i / 2] & 15) : (src[1 + i / 2] >> 4);
        used = 1 + bytes;
    }
    uint32_t total = 0;
    for (int i = 0; i < n; ++i) {
        need(w[i] <= 12, "Huffman weight too large");
        if (w[i]) total += 1u << (w[i] - 1);
    }
    need(total > 0, "Huffman tree without weights");
    int max_bits = highbit(total) + 1;
    need(max_bits <= 11, "Huffman code longer than 11 bits");
    uint32_t rest = (1u << max_bits) - total;
    need((rest & (rest - 1)) == 0, "Huffman weights do not complete a power of two");
    need(n < 256, "too many Huffman symbols");
    w[n++] = uint8_t(highbit(rest) + 1);
    h.max_bits = max_bits;
    h.cells.assign(size_t(1) << max_bits, HufCell{0, 0});
    size_t pos = 0;
    for (int weight = 1; weight <= max_bits; ++weight) {
        for (int s = 0; s < n; ++s) {
            if (w[s] != weight) continue;
            size_t span = size_t(1) << (weight - 1);
            need(pos + span <= h.cells.size(), "Huffman weights overfill the table");
            for (size_t i = 0; i < span; ++i) h.cells[pos + i] = HufCell{uint8_t(s), uint8_t(max_bits + 1 - weight)};
            pos += span;
        }
    }
    need(pos == h.cells.size(), "Huffman weights underfill the table");
    return used;
}

// One Huffman-coded stream of literals being decoded.
struct HufStream {
    BackBits br;
    uint8_t* out;
    size_t count, i;
};

// Decode streams side by side (independent chains for the core to overlap):
// while each has 8 whole bytes below its top, one load gives four codes
// (4 x 11 bits fit in the 56 loaded below the top); then each finishes alone.
void huffman_streams(const HufTable& h, HufStream* st, int n) {
    const HufCell* cells = h.cells.data();
    const int mb = h.max_bits;
    const uint64_t mask = (uint64_t(1) << mb) - 1;
    for (;;) {
        bool all = true;
        for (int k = 0; k < n; ++k) all = all && st[k].br.pos >= 64 && st[k].i + 4 <= st[k].count;
        if (!all) break;
        for (int k = 0; k < n; ++k) {
            HufStream& s = st[k];
            size_t b = size_t(s.br.pos >> 3) - 7;
            uint64_t w;
            std::memcpy(&w, s.br.p + b, 8);
            int avail = int(s.br.pos - int64_t(8 * b));
            for (int j = 0; j < 4; ++j) {
                HufCell c = cells[(w >> (avail - mb)) & mask];
                s.out[s.i++] = c.symbol;
                avail -= c.nbits;
            }
            s.br.pos = int64_t(8 * b) + avail;
        }
    }
    for (int k = 0; k < n; ++k) {
        HufStream& s = st[k];
        for (; s.i < s.count; ++s.i) {
            HufCell c = cells[s.br.peek(mb)];
            s.out[s.i] = c.symbol;
            s.br.pos -= c.nbits;
        }
        need(s.br.pos == 0, "Huffman stream does not end where its literals do");
    }
}

// ---- sequences --------------------------------------------------------------------

const uint32_t LL_BASE[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,   9,   10,  11,   12,   13,   14,    15,    16,   18,
                              20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,  14,   15,   16,   17,   18,    19,    20,
                              21, 22, 23, 24, 25, 26, 27, 28,  29,  30,  31,  32,   33,   34,   35,   37,    39,    41,
                              43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,  1,  1,  1,  1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

constexpr size_t BLOCK_MAX = 128 * 1024;

// What one frame's blocks share: the previous tables and the repeat offsets.
struct FrameState {
    HufTable huf;
    bool have_huf = false;
    FseTable ll, of, ml;
    bool have_ll = false, have_of = false, have_ml = false;
    uint32_t rep[3] = {1, 4, 8};
};

size_t read_table_mode(int mode, FseTable& t, bool& have, const uint8_t* src, size_t len, const int16_t* def,
                       int def_n, int def_log, int max_symbol, int max_log) {
    switch (mode) {
        case 0:
            build_fse(t, def, def_n, def_log);
            have = true;
            return 0;
        case 1:
            need(len >= 1, "truncated RLE sequence table");
            need(src[0] <= max_symbol, "RLE sequence symbol past the maximum");
            build_rle(t, src[0]);
            have = true;
            return 1;
        case 2: {
            size_t used = read_fse_table(t, src, len, max_symbol, max_log);
            have = true;
            return used;
        }
        default:
            need(have, "repeat mode without a previous table");
            return 0;
    }
}

// Decode one compressed block into out[*op...cap), the frame's output so far
// being out[frame_start, *op).
void compressed_block(FrameState& fs, const uint8_t* src, size_t len, uint8_t* out, size_t& op, size_t cap,
                      size_t frame_start, std::vector<uint8_t>& litbuf) {
    const uint8_t* end = src + len;
    const uint8_t* ip = src;
    need(len >= 1, "empty compressed block");
    // literals section
    int ltype = ip[0] & 3, sf = (ip[0] >> 2) & 3;
    size_t regen = 0, csize = 0, hsize = 0;
    int streams = 1;
    if (ltype <= 1) {
        if ((sf & 1) == 0) {
            regen = ip[0] >> 3;
            hsize = 1;
        } else if (sf == 1) {
            need(len >= 2, "truncated literals header");
            regen = (ip[0] >> 4) + (size_t(ip[1]) << 4);
            hsize = 2;
        } else {
            need(len >= 3, "truncated literals header");
            regen = (ip[0] >> 4) + (size_t(ip[1]) << 4) + (size_t(ip[2]) << 12);
            hsize = 3;
        }
    } else {
        if (sf <= 1) {
            need(len >= 3, "truncated literals header");
            uint32_t v = rd24(ip);
            regen = (v >> 4) & 0x3ff;
            csize = (v >> 14) & 0x3ff;
            hsize = 3;
            streams = sf == 0 ? 1 : 4;
        } else if (sf == 2) {
            need(len >= 4, "truncated literals header");
            uint32_t v = rd32(ip);
            regen = (v >> 4) & 0x3fff;
            csize = v >> 18;
            hsize = 4;
            streams = 4;
        } else {
            need(len >= 5, "truncated literals header");
            uint64_t v = uint64_t(rd32(ip)) | uint64_t(ip[4]) << 32;
            regen = (v >> 4) & 0x3ffff;
            csize = (v >> 22) & 0x3ffff;
            hsize = 5;
            streams = 4;
        }
    }
    need(regen <= BLOCK_MAX, "literals larger than a block");
    ip += hsize;
    const uint8_t* lit;
    if (ltype == 0) {
        need(size_t(end - ip) >= regen, "truncated raw literals");
        lit = ip;
        ip += regen;
    } else if (ltype == 1) {
        need(end - ip >= 1, "truncated RLE literals");
        litbuf.assign(regen, *ip);
        lit = litbuf.data();
        ip += 1;
    } else {
        need(size_t(end - ip) >= csize, "truncated Huffman literals");
        const uint8_t* lp = ip;
        size_t llen = csize;
        if (ltype == 2) {
            size_t used = read_huffman(fs.huf, lp, llen);
            fs.have_huf = true;
            lp += used;
            llen -= used;
        } else {
            need(fs.have_huf, "treeless literals without a previous Huffman table");
        }
        litbuf.resize(regen);
        if (streams == 1) {
            HufStream one{BackBits(lp, llen), litbuf.data(), regen, 0};
            huffman_streams(fs.huf, &one, 1);
        } else {
            need(llen >= 6, "truncated 4-stream literals");
            size_t s1 = rd16(lp), s2 = rd16(lp + 2), s3 = rd16(lp + 4);
            need(6 + s1 + s2 + s3 <= llen, "4-stream jump table past its literals");
            size_t s4 = llen - 6 - s1 - s2 - s3;
            size_t q = (regen + 3) / 4, last = regen - 3 * q;
            need(regen >= 3 * q, "4-stream literals too short");
            const uint8_t* sp = lp + 6;
            uint8_t* lb = litbuf.data();
            HufStream four[4] = {{BackBits(sp, s1), lb, q, 0},
                                 {BackBits(sp + s1, s2), lb + q, q, 0},
                                 {BackBits(sp + s1 + s2, s3), lb + 2 * q, q, 0},
                                 {BackBits(sp + s1 + s2 + s3, s4), lb + 3 * q, last, 0}};
            huffman_streams(fs.huf, four, 4);
        }
        lit = litbuf.data();
        ip += csize;
    }
    // sequences section
    const size_t block_start = op;
    size_t lit_used = 0;
    need(end - ip >= 1, "missing sequences header");
    size_t nseq = ip[0];
    if (nseq == 0) {
        ip += 1;
    } else if (nseq < 128) {
        ip += 1;
    } else if (nseq < 255) {
        need(end - ip >= 2, "truncated sequences header");
        nseq = ((nseq - 128) << 8) + ip[1];
        ip += 2;
    } else {
        need(end - ip >= 3, "truncated sequences header");
        nseq = size_t(ip[1]) + (size_t(ip[2]) << 8) + 0x7f00;
        ip += 3;
    }
    if (nseq > 0) {
        need(end - ip >= 1, "missing sequence modes");
        uint8_t modes = *ip++;
        need((modes & 3) == 0, "reserved bits set in the sequence modes");
        ip += read_table_mode(modes >> 6, fs.ll, fs.have_ll, ip, size_t(end - ip), LL_DEFAULT, 36, 6, 35, 9);
        ip += read_table_mode((modes >> 4) & 3, fs.of, fs.have_of, ip, size_t(end - ip), OF_DEFAULT, 29, 5, 31, 8);
        ip += read_table_mode((modes >> 2) & 3, fs.ml, fs.have_ml, ip, size_t(end - ip), ML_DEFAULT, 53, 6, 52, 9);
        need(ip < end, "missing sequences bitstream");
        BackBits br(ip, size_t(end - ip));
        uint32_t sll = uint32_t(br.read(fs.ll.log)), sof = uint32_t(br.read(fs.of.log)),
                 sml = uint32_t(br.read(fs.ml.log));
        for (size_t i = 0; i < nseq; ++i) {
            const FseCell& cof = fs.of.cells[sof];
            const FseCell& cml = fs.ml.cells[sml];
            const FseCell& cll = fs.ll.cells[sll];
            uint32_t ofc = cof.symbol, mlc = cml.symbol, llc = cll.symbol;
            need(ofc <= 31 && mlc <= 52 && llc <= 35, "sequence code past its table");
            uint64_t ofv = (uint64_t(1) << ofc) + br.read(int(ofc));
            size_t ml = ML_BASE[mlc] + size_t(br.read(ML_BITS[mlc]));
            size_t ll = LL_BASE[llc] + size_t(br.read(LL_BITS[llc]));
            size_t offset;
            if (ofv > 3) {
                offset = size_t(ofv - 3);
                fs.rep[2] = fs.rep[1];
                fs.rep[1] = fs.rep[0];
                fs.rep[0] = uint32_t(offset);
            } else {
                uint32_t idx = uint32_t(ofv) + (ll == 0 ? 1 : 0);
                if (idx == 1) {
                    offset = fs.rep[0];
                } else {
                    offset = idx == 4 ? size_t(fs.rep[0]) - 1 : fs.rep[idx - 1];
                    need(offset != 0, "repeat offset of zero");
                    if (idx != 2) fs.rep[2] = fs.rep[1];
                    fs.rep[1] = fs.rep[0];
                    fs.rep[0] = uint32_t(offset);
                }
            }
            if (i + 1 < nseq) {
                sll = cll.base + uint32_t(br.read(cll.nbits));
                sml = cml.base + uint32_t(br.read(cml.nbits));
                sof = cof.base + uint32_t(br.read(cof.nbits));
            }
            need(br.pos >= 0, "sequences bitstream overrun");
            // execute: literals, then the match
            need(ll <= regen - lit_used, "sequence takes more literals than decoded");
            need(op + ll + ml <= cap, "output larger than its buffer");
            need(op + ll + ml - block_start <= BLOCK_MAX, "block larger than 128 KiB");
            std::memcpy(out + op, lit + lit_used, ll);
            op += ll;
            lit_used += ll;
            need(offset <= op - frame_start, "match offset before the frame's start");
            uint8_t* d = out + op;
            const uint8_t* s = d - offset;
            if (offset >= ml) {
                std::memcpy(d, s, ml);
            } else {
                for (size_t k = 0; k < ml; ++k) d[k] = s[k];
            }
            op += ml;
        }
        need(br.pos == 0, "sequences bitstream not consumed to its end");
    } else {
        need(ip == end, "bytes after an empty sequences section");
    }
    size_t rest = regen - lit_used;
    need(op + rest <= cap, "output larger than its buffer");
    need(op + rest - block_start <= BLOCK_MAX, "block larger than 128 KiB");
    std::memcpy(out + op, lit + lit_used, rest);
    op += rest;
}

constexpr uint32_t MAGIC = 0xFD2FB528u;

struct FrameHeader {
    size_t header_size;
    bool has_fcs, checksum, single;
    uint64_t fcs, window;
};

FrameHeader frame_header(const uint8_t* p, size_t len) {
    need(len >= 5, "truncated frame header");
    uint8_t fhd = p[4];
    FrameHeader h{};
    int fcs_flag = fhd >> 6, did_flag = fhd & 3;
    h.single = (fhd >> 5) & 1;
    h.checksum = (fhd >> 2) & 1;
    need(((fhd >> 3) & 1) == 0, "reserved bit set in the frame header");
    size_t pos = 5;
    if (!h.single) {
        need(len >= pos + 1, "truncated frame header");
        uint8_t wd = p[pos++];
        uint64_t base = uint64_t(1) << (10 + (wd >> 3));
        h.window = base + (base / 8) * (wd & 7);
    }
    const size_t did_size[4] = {0, 1, 2, 4};
    size_t ds = did_size[did_flag];
    need(len >= pos + ds, "truncated frame header");
    uint32_t did = 0;
    for (size_t i = 0; i < ds; ++i) did |= uint32_t(p[pos + i]) << (8 * i);
    need(did == 0, "frame names a dictionary, which this decoder does not take");
    pos += ds;
    size_t fs = fcs_flag == 0 ? (h.single ? 1 : 0) : (size_t(1) << fcs_flag);
    need(len >= pos + fs, "truncated frame header");
    h.has_fcs = fs > 0;
    h.fcs = 0;
    for (size_t i = 0; i < fs; ++i) h.fcs |= uint64_t(p[pos + i]) << (8 * i);
    if (fs == 2) h.fcs += 256;
    pos += fs;
    if (h.single) h.window = h.fcs;
    h.header_size = pos;
    return h;
}

// Decode every frame of src into out[0, cap); returns the bytes written. With
// out == nullptr only sizes are checked: returns the summed content sizes, or
// throws "unknown size" when a frame does not state its own.
size_t decode_all(const uint8_t* src, size_t len, uint8_t* out, size_t cap) {
    size_t ip = 0, op = 0;
    std::vector<uint8_t> litbuf;
    need(len > 0, "empty input");
    while (ip < len) {
        need(len - ip >= 4, "truncated frame magic");
        uint32_t magic = rd32(src + ip);
        if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
            need(len - ip >= 8, "truncated skippable frame");
            uint64_t n = rd32(src + ip + 4);
            need(n <= len - ip - 8, "truncated skippable frame");
            ip += 8 + size_t(n);
            continue;
        }
        need(magic == MAGIC, "not a zstd frame (bad magic number)");
        FrameHeader h = frame_header(src + ip, len - ip);
        ip += h.header_size;
        if (out == nullptr) {
            if (!h.has_fcs) fail("unknown size");
            op += size_t(h.fcs);
            // walk the blocks to find the frame's end
            for (;;) {
                need(len - ip >= 3, "truncated block header");
                uint32_t bh = rd24(src + ip);
                size_t bsize = bh >> 3;
                int btype = (bh >> 1) & 3;
                need(btype != 3, "reserved block type");
                size_t body = btype == 1 ? 1 : bsize;
                need(len - ip - 3 >= body, "truncated block");
                ip += 3 + body;
                if (bh & 1) break;
            }
            if (h.checksum) {
                need(len - ip >= 4, "truncated content checksum");
                ip += 4;
            }
            continue;
        }
        FrameState fs;
        const size_t frame_start = op;
        const size_t block_max = size_t(h.window < BLOCK_MAX ? h.window : BLOCK_MAX);
        for (;;) {
            need(len - ip >= 3, "truncated block header");
            uint32_t bh = rd24(src + ip);
            ip += 3;
            bool last = bh & 1;
            int btype = (bh >> 1) & 3;
            size_t bsize = bh >> 3;
            need(btype != 3, "reserved block type");
            if (btype == 0) {
                need(bsize <= block_max || h.single, "raw block larger than the block maximum");
                need(len - ip >= bsize, "truncated raw block");
                need(cap - op >= bsize, "output larger than its buffer");
                std::memcpy(out + op, src + ip, bsize);
                ip += bsize;
                op += bsize;
            } else if (btype == 1) {
                need(len - ip >= 1, "truncated RLE block");
                need(cap - op >= bsize, "output larger than its buffer");
                std::memset(out + op, src[ip], bsize);
                ip += 1;
                op += bsize;
            } else {
                need(bsize <= BLOCK_MAX, "compressed block larger than 128 KiB");
                need(len - ip >= bsize, "truncated compressed block");
                compressed_block(fs, src + ip, bsize, out, op, cap, frame_start, litbuf);
                ip += bsize;
            }
            if (last) break;
        }
        if (h.has_fcs) need(op - frame_start == h.fcs, "frame content size disagrees with its blocks");
        if (h.checksum) {
            need(len - ip >= 4, "truncated content checksum");
            uint32_t want = rd32(src + ip);
            uint32_t got = uint32_t(xxh64(out + frame_start, op - frame_start));
            need(want == got, "content checksum mismatch");
            ip += 4;
        }
    }
    return op;
}

void set_err(char* err, size_t errcap, const std::string& msg) {
    if (err && errcap) std::snprintf(err, errcap, "%s", msg.c_str());
}

uint32_t CRC32C_TABLE[8][256];

void crc_init() {
    for (uint32_t i = 0; i < 256; ++i) {
        uint32_t c = i;
        for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
        CRC32C_TABLE[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
        for (int t = 1; t < 8; ++t)
            CRC32C_TABLE[t][i] = (CRC32C_TABLE[t - 1][i] >> 8) ^ CRC32C_TABLE[0][CRC32C_TABLE[t - 1][i] & 0xff];
}

struct CrcInit {
    CrcInit() { crc_init(); }
} crc_init_once;

}  // namespace

extern "C" {

// Bytes of all frames' content when every frame states its size, -2 when one
// does not, -1 on a malformed header (message in err).
int64_t cenet_zstd_content_size(const uint8_t* src, size_t len, char* err, size_t errcap) {
    try {
        return int64_t(decode_all(src, len, nullptr, 0));
    } catch (const Error& e) {
        if (e.msg == "unknown size") return -2;
        set_err(err, errcap, e.msg);
        return -1;
    }
}

// Decode every frame of src into dst[0, cap); returns the bytes written, -2
// when dst is too small, -1 on a malformed input (message in err).
int64_t cenet_zstd_decompress(const uint8_t* src, size_t len, uint8_t* dst, size_t cap, char* err, size_t errcap) {
    try {
        return int64_t(decode_all(src, len, dst, cap));
    } catch (const Error& e) {
        set_err(err, errcap, e.msg);
        return e.msg == "output larger than its buffer" ? -2 : -1;
    }
}

// CRC-32C (Castagnoli) of src, continuing from crc (0 to start).
uint32_t cenet_crc32c(const uint8_t* src, size_t len, uint32_t crc) {
    uint32_t c = ~crc;
    while (len >= 8) {
        uint32_t lo = c ^ rd32(src), hi = rd32(src + 4);
        c = CRC32C_TABLE[7][lo & 0xff] ^ CRC32C_TABLE[6][(lo >> 8) & 0xff] ^ CRC32C_TABLE[5][(lo >> 16) & 0xff] ^
            CRC32C_TABLE[4][lo >> 24] ^ CRC32C_TABLE[3][hi & 0xff] ^ CRC32C_TABLE[2][(hi >> 8) & 0xff] ^
            CRC32C_TABLE[1][(hi >> 16) & 0xff] ^ CRC32C_TABLE[0][hi >> 24];
        src += 8;
        len -= 8;
    }
    while (len--) c = (c >> 8) ^ CRC32C_TABLE[0][(c ^ *src++) & 0xff];
    return ~c;
}

}  // extern "C"
