// Copy of lua_mapreduce_tpu/core/native/shufflemerge.cpp. The torch package
// builds its own library from it (core/native_build.py) and imports
// nothing of the JAX package; the two libraries read and write the
// same files.
//
// Native k-way shuffle merge over sorted JSON-line run files.
//
// The reference's bulk-data path is native C++ (luamongo + mongo-cxx-driver
// GridFS chunk streaming, SURVEY.md §2.4); this is the new framework's
// native piece for the same role on the host shuffle: merge every mapper's
// sorted run for one partition into a single run whose equal-key value
// lists are concatenated — the merge_iterator contract (reference
// utils.lua:206-271) executed in one C++ pass instead of a Python heap
// loop, so the reduce phase streams one pre-merged file.
//
// Record format: one JSON array per line, [key, [v1, v2, ...]] (see
// core/serialize.py). Keys are compared with EXACTLY serialize.key_lt's
// total order: type rank (bool < number < string < array < null), then
// value — numbers int-exact when both sides are integral, strings by
// Unicode code point (== UTF-8 byte order after unescaping), arrays
// lexicographic then by length. Values are never parsed: their raw JSON
// spans are spliced into the output line untouched.
//
// C ABI (ctypes): smerge_files(inputs, n, output) -> 0 ok, 1 I/O error,
// 2 parse error. The output file is written directly; the Python caller
// owns tmp+rename atomicity (the fs.lua:80-115 discipline).
//
// smerge_fold_sum(inputs, n, output) additionally FOLDS each merged
// group: when a task's reducefn is declared ``native_reduce = "sum"``
// (associative+commutative integer sum — the wordcount/grad-count
// shape), the merge emits ["key",[<sum>]] directly, fusing the reduce
// into the merge pass. Any non-integer value or int64 overflow returns
// rc=2 so the Python reducefn (arbitrary precision) stays the truth.
//
// Input files may independently be v1 JSON-line text OR v2 "JSEG0001"
// framed binary segments (core/segment.py, DESIGN §17): the run cursor
// sniffs the 8-byte magic and decodes frames LAZILY — one frame
// (~256KB decoded, CRC-checked) at a time, raw or zlib-compressed
// (zlib only when built with -DLMR_HAVE_ZLIB -lz; a compressed frame
// without it returns rc=2 so the Python reader stays the truth).
// Output stays v1 text: readers sniff per file, so a text spill merged
// from binary segments is always valid.

#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <fstream>
#include <queue>
#include <string>
#include <vector>

#ifdef LMR_HAVE_ZLIB
#include <zlib.h>
#endif

namespace {

struct Key {
    int rank = 4;               // bool=0, num=1, str=2, arr=3, null=4
    bool bval = false;
    bool is_int = false;
    bool neg = false;           // sign of an integral key
    std::string digits;         // |value| digit string of an integral key
    double dval = 0.0;
    std::string sval;           // UTF-8 bytes, unescaped
    std::vector<Key> arr;
};

// ---- minimal JSON parsing (keys only; values stay raw) --------------------

void skip_ws(const char*& p) {
    while (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n') ++p;
}

bool parse_hex4(const char*& p, unsigned& out) {
    out = 0;
    for (int i = 0; i < 4; ++i) {
        char c = *p++;
        out <<= 4;
        if (c >= '0' && c <= '9') out |= (unsigned)(c - '0');
        else if (c >= 'a' && c <= 'f') out |= (unsigned)(c - 'a' + 10);
        else if (c >= 'A' && c <= 'F') out |= (unsigned)(c - 'A' + 10);
        else return false;
    }
    return true;
}

void append_utf8(std::string& s, unsigned cp) {
    if (cp < 0x80) {
        s += (char)cp;
    } else if (cp < 0x800) {
        s += (char)(0xC0 | (cp >> 6));
        s += (char)(0x80 | (cp & 0x3F));
    } else if (cp < 0x10000) {
        s += (char)(0xE0 | (cp >> 12));
        s += (char)(0x80 | ((cp >> 6) & 0x3F));
        s += (char)(0x80 | (cp & 0x3F));
    } else {
        s += (char)(0xF0 | (cp >> 18));
        s += (char)(0x80 | ((cp >> 12) & 0x3F));
        s += (char)(0x80 | ((cp >> 6) & 0x3F));
        s += (char)(0x80 | (cp & 0x3F));
    }
}

bool parse_string(const char*& p, std::string& out) {
    if (*p != '"') return false;
    ++p;
    while (*p && *p != '"') {
        if (*p == '\\') {
            ++p;
            switch (*p) {
                case '"': out += '"'; ++p; break;
                case '\\': out += '\\'; ++p; break;
                case '/': out += '/'; ++p; break;
                case 'b': out += '\b'; ++p; break;
                case 'f': out += '\f'; ++p; break;
                case 'n': out += '\n'; ++p; break;
                case 'r': out += '\r'; ++p; break;
                case 't': out += '\t'; ++p; break;
                case 'u': {
                    ++p;
                    unsigned cp;
                    if (!parse_hex4(p, cp)) return false;
                    if (cp >= 0xD800 && cp <= 0xDBFF && p[0] == '\\' &&
                        p[1] == 'u') {
                        p += 2;
                        unsigned lo;
                        if (!parse_hex4(p, lo)) return false;
                        cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
                    }
                    append_utf8(out, cp);
                    break;
                }
                default: return false;
            }
        } else {
            out += *p++;
        }
    }
    if (*p != '"') return false;
    ++p;
    return true;
}

bool parse_key(const char*& p, Key& k) {
    skip_ws(p);
    if (*p == 't') {
        if (strncmp(p, "true", 4)) return false;
        p += 4; k.rank = 0; k.bval = true; return true;
    }
    if (*p == 'f') {
        if (strncmp(p, "false", 5)) return false;
        p += 5; k.rank = 0; k.bval = false; return true;
    }
    if (*p == 'n') {
        if (strncmp(p, "null", 4)) return false;
        p += 4; k.rank = 4; return true;
    }
    if (*p == '"') {
        k.rank = 2;
        return parse_string(p, k.sval);
    }
    if (*p == '[') {
        ++p;
        k.rank = 3;
        skip_ws(p);
        if (*p == ']') { ++p; return true; }
        while (true) {
            k.arr.emplace_back();
            if (!parse_key(p, k.arr.back())) return false;
            skip_ws(p);
            if (*p == ',') { ++p; continue; }
            if (*p == ']') { ++p; return true; }
            return false;
        }
    }
    if (*p == '-' || (*p >= '0' && *p <= '9')) {
        const char* start = p;
        bool integral = true;
        if (*p == '-') ++p;
        while (*p >= '0' && *p <= '9') ++p;
        if (*p == '.' || *p == 'e' || *p == 'E') {
            integral = false;
            if (*p == '.') { ++p; while (*p >= '0' && *p <= '9') ++p; }
            if (*p == 'e' || *p == 'E') {
                ++p;
                if (*p == '+' || *p == '-') ++p;
                while (*p >= '0' && *p <= '9') ++p;
            }
        }
        std::string num(start, (size_t)(p - start));
        k.rank = 1;
        k.dval = strtod(num.c_str(), nullptr);
        if (integral) {
            // exact arbitrary-precision compare via the digit string —
            // Python ints never round through double (two 2**64-scale
            // keys differing by 1 must NOT merge)
            k.is_int = true;
            k.neg = num[0] == '-';
            k.digits = k.neg ? num.substr(1) : num;
            if (k.digits == "0") k.neg = false;         // -0 == 0
        }
        return true;
    }
    return false;
}

// Exact compare of an arbitrary-precision integer key (neg, |digits|)
// against a double key parsed from a non-integral literal. Python
// compares int-vs-float exactly, so rounding the int through double
// (lossy past 2^53) would silently merge keys Python keeps distinct.
int int_vs_double_cmp(bool neg, const std::string& digits, double d) {
    if (d == HUGE_VAL) return -1;               // any int < +inf
    if (d == -HUGE_VAL) return 1;               // any int > -inf
    static const char* TWO53 = "9007199254740992";  // 2^53, 16 digits
    if (digits.size() < 16 ||
        (digits.size() == 16 && digits.compare(TWO53) <= 0)) {
        // |int| <= 2^53: double holds it exactly
        double iv = strtod(digits.c_str(), nullptr);
        if (neg) iv = -iv;
        return iv < d ? -1 : (iv > d ? 1 : 0);
    }
    bool dneg = std::signbit(d);
    double ad = dneg ? -d : d;
    if (ad < 9007199254740992.0)
        // |d| < 2^53 < |int| → the int's magnitude wins; sign decides
        return neg ? -1 : 1;
    // |d| >= 2^53: d is integral-valued; %.0f prints its exact decimal
    // (binary→decimal of an integer-valued double is exact, <= 309 digits)
    char buf[352];
    snprintf(buf, sizeof buf, "%.0f", ad);
    if (neg != dneg) return neg ? -1 : 1;
    size_t blen = strlen(buf);
    int mag;
    if (digits.size() != blen) {
        mag = digits.size() < blen ? -1 : 1;
    } else {
        int c = digits.compare(buf);
        mag = c < 0 ? -1 : (c > 0 ? 1 : 0);
    }
    return neg ? -mag : mag;
}

// key_lt: -1 / 0 / +1 matching serialize.key_lt's total order
int key_cmp(const Key& a, const Key& b) {
    if (a.rank != b.rank) return a.rank < b.rank ? -1 : 1;
    switch (a.rank) {
        case 0:
            if (a.bval == b.bval) return 0;
            return a.bval ? 1 : -1;         // false < true
        case 1:
            if (a.is_int && b.is_int) {
                if (a.neg != b.neg) return a.neg ? -1 : 1;
                int mag;
                if (a.digits.size() != b.digits.size())
                    mag = a.digits.size() < b.digits.size() ? -1 : 1;
                else {
                    int c = a.digits.compare(b.digits);
                    mag = c < 0 ? -1 : (c > 0 ? 1 : 0);
                }
                return a.neg ? -mag : mag;
            }
            if (a.is_int) return int_vs_double_cmp(a.neg, a.digits, b.dval);
            if (b.is_int) return -int_vs_double_cmp(b.neg, b.digits, a.dval);
            return a.dval < b.dval ? -1 : (a.dval > b.dval ? 1 : 0);
        case 2: {
            int c = a.sval.compare(b.sval);  // UTF-8 bytes == code points
            return c < 0 ? -1 : (c > 0 ? 1 : 0);
        }
        case 3: {
            size_t n = a.arr.size() < b.arr.size() ? a.arr.size()
                                                   : b.arr.size();
            for (size_t i = 0; i < n; ++i) {
                int c = key_cmp(a.arr[i], b.arr[i]);
                if (c) return c;
            }
            if (a.arr.size() != b.arr.size())
                return a.arr.size() < b.arr.size() ? -1 : 1;
            return 0;
        }
        default:
            return 0;                       // null == null
    }
}

// find the end of a balanced JSON value starting at p (string-aware);
// returns nullptr on malformed input
const char* span_end(const char* p) {
    skip_ws(p);
    if (*p == '"') {
        ++p;
        while (*p && *p != '"') {
            if (*p == '\\' && p[1]) ++p;
            ++p;
        }
        return *p == '"' ? p + 1 : nullptr;
    }
    if (*p == '[' || *p == '{') {
        char open = *p, close = (*p == '[') ? ']' : '}';
        int depth = 0;
        while (*p) {
            if (*p == '"') {
                ++p;
                while (*p && *p != '"') {
                    if (*p == '\\' && p[1]) ++p;
                    ++p;
                }
                if (!*p) return nullptr;
            } else if (*p == open) {
                ++depth;
            } else if (*p == close) {
                if (--depth == 0) return p + 1;
            }
            ++p;
        }
        return nullptr;
    }
    while (*p && *p != ',' && *p != ']' && *p != '}' && *p != ' ' &&
           *p != '\t' && *p != '\r' && *p != '\n')
        ++p;
    return p;
}

// ---- JSEG0001 segment decoding --------------------------------------------

const char SEG_MAGIC[8] = {'J', 'S', 'E', 'G', '0', '0', '0', '1'};

// CRC-32 (zlib polynomial) over the DECODED frame payload — implemented
// locally so raw-codec segments verify even in a zlib-less build
uint32_t crc32_ieee(const unsigned char* p, size_t n) {
    static uint32_t table[256];
    static bool init = false;
    if (!init) {
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i;
            for (int k = 0; k < 8; ++k)
                c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
            table[i] = c;
        }
        init = true;
    }
    uint32_t c = 0xFFFFFFFFu;
    for (size_t i = 0; i < n; ++i)
        c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

uint32_t le32(const unsigned char* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}

uint64_t le64(const unsigned char* p) {
    return (uint64_t)le32(p) | ((uint64_t)le32(p + 4) << 32);
}

// ---- run-file cursor ------------------------------------------------------

struct Run {
    std::ifstream f;
    std::string line;
    Key key;
    std::string key_raw;        // raw JSON of the key (spliced to output)
    std::string vals_raw;       // raw contents INSIDE the values [ ... ]
    bool ok = false;

    // segment state (v2 inputs); text inputs keep seg=false
    bool seg = false;
    uint64_t frame_off = 0;     // next frame header offset
    uint64_t frames_end = 0;    // first byte past the data region
    std::string dbuf;           // decoded-but-unconsumed payload bytes
    size_t dpos = 0;

    // Sniff the open file: position it for text getline, or arm the
    // frame decoder. Returns 0 ok, 1 open failure, 2 malformed segment.
    int arm() {
        if (!f.is_open()) return 1;
        char head[8];
        f.read(head, 8);
        if (f.gcount() == 8 && memcmp(head, SEG_MAGIC, 8) == 0) {
            f.clear();
            f.seekg(0, std::ios::end);
            uint64_t size = (uint64_t)f.tellg();
            if (size < 32) return 2;             // magic + 24-byte trailer
            unsigned char tr[24];
            f.seekg((std::streamoff)(size - 24));
            f.read(reinterpret_cast<char*>(tr), 24);
            if (f.gcount() != 24 || memcmp(tr + 16, SEG_MAGIC, 8) != 0)
                return 2;
            frames_end = le64(tr);
            if (frames_end < 8 || frames_end > size) return 2;
            seg = true;
            frame_off = 8;
            f.clear();
            f.seekg(8);
            return 0;
        }
        f.clear();
        f.seekg(0);
        return 0;
    }

    // Decode the next frame into dbuf. 0 ok, 1 no more frames, 2 error.
    int load_frame() {
        if (frame_off >= frames_end) return 1;
        unsigned char hdr[13];
        f.seekg((std::streamoff)frame_off);
        f.read(reinterpret_cast<char*>(hdr), 13);
        if (f.gcount() != 13) return 2;
        uint32_t enc = le32(hdr), dec = le32(hdr + 4);
        unsigned codec = hdr[8];
        uint32_t crc = le32(hdr + 9);
        if (frame_off + 13 + enc > frames_end) return 2;
        std::string data(enc, '\0');
        f.read(&data[0], (std::streamsize)enc);
        if ((uint32_t)f.gcount() != enc) return 2;
        std::string payload;
        if (codec == 0) {
            payload.swap(data);
        } else if (codec == 1) {
#ifdef LMR_HAVE_ZLIB
            payload.resize(dec);
            uLongf dlen = dec;
            if (uncompress(reinterpret_cast<Bytef*>(&payload[0]), &dlen,
                           reinterpret_cast<const Bytef*>(data.data()),
                           enc) != Z_OK || dlen != dec)
                return 2;
#else
            return 2;           // compressed frame, zlib-less build
#endif
        } else {
            return 2;           // lz4 (and anything newer): Python owns it
        }
        if (payload.size() != dec ||
            crc32_ieee(reinterpret_cast<const unsigned char*>(
                           payload.data()), payload.size()) != crc)
            return 2;
        // keep any half-consumed tail (payloads end in '\n', so this is
        // defensive only) and swap the decoded frame in
        dbuf.erase(0, dpos);
        dbuf += payload;
        dpos = 0;
        frame_off += 13 + (uint64_t)enc;
        return 0;
    }

    // 0 = line loaded, 1 = eof, 2 = error — the getline analog that
    // serves both formats (frames decode lazily, one at a time)
    int next_line() {
        if (!seg)
            return std::getline(f, line) ? 0 : 1;
        while (true) {
            size_t nl = dbuf.find('\n', dpos);
            if (nl != std::string::npos) {
                line.assign(dbuf, dpos, nl - dpos);
                dpos = nl + 1;
                return 0;
            }
            int st = load_frame();
            if (st == 2) return 2;
            if (st == 1) {
                if (dpos < dbuf.size()) {        // unterminated tail
                    line.assign(dbuf, dpos, std::string::npos);
                    dpos = dbuf.size();
                    return 0;
                }
                return 1;
            }
        }
    }

    // 0 = record loaded, 1 = eof, 2 = parse error
    int advance() {
        int st;
        while ((st = next_line()) == 0) {
            size_t b = line.find_first_not_of(" \t\r\n");
            if (b == std::string::npos) continue;       // skip blank lines
            const char* p = line.c_str();
            skip_ws(p);
            if (*p != '[') return 2;
            ++p;
            skip_ws(p);
            const char* kstart = p;
            key = Key();
            if (!parse_key(p, key)) return 2;
            key_raw.assign(kstart, (size_t)(p - kstart));
            skip_ws(p);
            if (*p != ',') return 2;
            ++p;
            skip_ws(p);
            if (*p != '[') return 2;
            const char* vend = span_end(p);
            if (!vend) return 2;
            vals_raw.assign(p + 1, (size_t)(vend - p - 2));  // inside [ ]
            ok = true;
            return 0;
        }
        ok = false;
        return st;              // 1 eof, 2 frame/decode error
    }
};

struct HeapCmp {
    const std::vector<Run*>* runs;
    bool operator()(int a, int b) const {
        // std::priority_queue is a max-heap; invert for min-key order
        return key_cmp((*runs)[a]->key, (*runs)[b]->key) > 0;
    }
};

// Accumulate every integer token inside a raw values span ("1,-2,3")
// into total. Returns false (→ rc=2 fallback) on any non-integer token
// or int64 overflow — Python's arbitrary-precision sum owns those.
bool fold_span_sum(const std::string& span, long long& total) {
    const char* p = span.c_str();
    while (true) {
        skip_ws(p);
        if (!*p) return true;
        bool neg = false;
        if (*p == '-') { neg = true; ++p; }
        if (*p < '0' || *p > '9') return false;
        long long v = 0;
        while (*p >= '0' && *p <= '9') {
            if (__builtin_mul_overflow(v, 10LL, &v) ||
                __builtin_add_overflow(v, (long long)(*p - '0'), &v))
                return false;
            ++p;
        }
        if (*p == '.' || *p == 'e' || *p == 'E') return false;  // float
        if (neg) v = -v;
        if (__builtin_add_overflow(total, v, &total)) return false;
        skip_ws(p);
        if (*p == ',') { ++p; continue; }
        if (!*p) return true;
        return false;                   // strings/arrays/objects
    }
}

int smerge_core(const char** inputs, int n_inputs, const char* output,
                int fold_sum);

}  // namespace

extern "C" int smerge_files(const char** inputs, int n_inputs,
                            const char* output) {
    return smerge_core(inputs, n_inputs, output, 0);
}

extern "C" int smerge_fold_sum(const char** inputs, int n_inputs,
                               const char* output) {
    return smerge_core(inputs, n_inputs, output, 1);
}

namespace {

int smerge_core(const char** inputs, int n_inputs, const char* output,
                int fold_sum) {
    std::vector<Run*> runs;
    runs.reserve((size_t)n_inputs);
    for (int i = 0; i < n_inputs; ++i) {
        Run* r = new Run();
        r->f.open(inputs[i], std::ios::binary);   // segments are binary;
        runs.push_back(r);                        // getline is \n-framed
    }
    int rc = 0;
    {
        std::priority_queue<int, std::vector<int>, HeapCmp> heap(
            HeapCmp{&runs});
        for (int i = 0; i < n_inputs && rc == 0; ++i) {
            rc = runs[(size_t)i]->arm();          // sniff v1 text vs v2 seg
            if (rc) break;
            int st = runs[(size_t)i]->advance();
            if (st == 0) heap.push(i);
            else if (st == 2) rc = 2;
        }
        std::ofstream out;
        if (rc == 0) {
            out.open(output, std::ios::trunc);
            if (!out.is_open()) rc = 1;
        }
        while (rc == 0 && !heap.empty()) {
            int first = heap.top();
            heap.pop();
            std::vector<int> drained{first};
            while (!heap.empty() &&
                   key_cmp(runs[(size_t)heap.top()]->key,
                           runs[(size_t)first]->key) == 0) {
                drained.push_back(heap.top());
                heap.pop();
            }
            // concatenate in run-file order (deterministic reduce
            // inputs, matching core/merge.py's contract)
            std::sort(drained.begin(), drained.end());
            if (fold_sum) {
                long long total = 0;
                for (int j : drained) {
                    if (!fold_span_sum(runs[(size_t)j]->vals_raw, total)) {
                        rc = 2;
                        break;
                    }
                }
                if (rc) break;
                out << '[' << runs[(size_t)first]->key_raw << ",["
                    << total << "]]\n";
            } else {
                std::string merged;
                for (int j : drained) {
                    if (runs[(size_t)j]->vals_raw.empty()) continue;
                    if (!merged.empty()) merged += ',';
                    merged += runs[(size_t)j]->vals_raw;
                }
                out << '[' << runs[(size_t)first]->key_raw << ",["
                    << merged << "]]\n";
            }
            for (int j : drained) {
                int st = runs[(size_t)j]->advance();
                if (st == 0) heap.push(j);
                else if (st == 2) { rc = 2; break; }
            }
        }
        if (rc == 0) {
            out.flush();
            if (!out.good()) rc = 1;
        }
    }
    for (Run* r : runs) delete r;
    return rc;
}

}  // namespace
