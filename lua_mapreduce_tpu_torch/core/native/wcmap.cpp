// Copy of lua_mapreduce_tpu/core/native/wcmap.cpp. The torch package
// builds its own library from it (core/native_build.py) and imports
// nothing of the JAX package; the two libraries read and write the
// same files.
//
// Native wordcount map: tokenize + count + partition + serialize in one
// C++ pass.
//
// The reference's performance rests on native code for the data path
// (luamongo/mongo-cxx serialization + transport, SURVEY.md §2.4); this is
// the same idea applied to the map side of the Europarl-scale wordcount,
// where pure-Python tokenize/emit/serialize dominates the benchmark's map
// cluster time. A task module OPTS IN by declaring `mapfn.native_map`
// (see core/native_wcmap.py); the engine golden-diffs this path against
// the Python mapfn it replaces (tests/test_native_wcmap.py).
//
// Contract replicated exactly:
// - tokens split on the ASCII slice of Python str.split()'s whitespace
//   (space, \t-\r, \x1c-\x1f); files containing ANY non-ASCII byte
//   return rc=2 (fall back) because Python also splits on Unicode
//   whitespace (NBSP etc.) and byte-level tokenization could diverge
// - partition = (sum of the first `hash_prefix` BYTES of the word) % n
//   (examples partitionfn, reference partitionfn.lua:1-16 byte-sum role)
// - per partition, records sorted by key byte-order (== Python's sort for
//   single-rank str keys, serialize.sorted_keys fast path)
// - record lines byte-identical to serialize.dump_record:
//   ["<json-escaped word>",[<count>]]\n  (ensure_ascii=False escaping)
// - output written tmp + rename per partition (fs.lua:80-115 atomicity);
//   empty partitions produce no file
//
// C ABI: wc_map_file(input, out_tmp_paths, out_final_paths, n_reducers,
// hash_prefix) -> 0 ok, 1 I/O error, 2 fall back to Python.

#include <fcntl.h>
#include <unistd.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

bool is_space(unsigned char c) {
    // ASCII slice of Python str.split() whitespace: ' ', \t \n \v \f \r,
    // and the file/group/record/unit separators \x1c-\x1f
    return c == ' ' || (c >= '\t' && c <= '\r') ||
           (c >= 0x1c && c <= 0x1f);
}

bool all_ascii(const std::string& s) {
    for (unsigned char c : s)
        if (c >= 0x80) return false;
    return true;
}

// json.dumps(ensure_ascii=False) string escaping
void append_escaped(std::string& out, const std::string& w) {
    for (unsigned char c : w) {
        switch (c) {
            case '"': out += "\\\""; break;
            case '\\': out += "\\\\"; break;
            case '\b': out += "\\b"; break;
            case '\f': out += "\\f"; break;
            case '\n': out += "\\n"; break;
            case '\r': out += "\\r"; break;
            case '\t': out += "\\t"; break;
            default:
                if (c < 0x20) {
                    char buf[8];
                    snprintf(buf, sizeof buf, "\\u%04x", c);
                    out += buf;
                } else {
                    out += static_cast<char>(c);
                }
        }
    }
}

}  // namespace

extern "C" int wc_map_file(const char* input_path,
                           const char** out_tmp_paths,
                           const char** out_final_paths,
                           int n_reducers, int hash_prefix) {
    std::ifstream in(input_path, std::ios::binary);
    if (!in.is_open()) return 1;
    std::string data((std::istreambuf_iterator<char>(in)),
                     std::istreambuf_iterator<char>());
    if (!in.good() && !in.eof()) return 1;
    if (!all_ascii(data)) return 2;    // Unicode whitespace → Python path

    std::unordered_map<std::string, long long> counts;
    counts.reserve(1 << 16);
    size_t i = 0, n = data.size();
    while (i < n) {
        while (i < n && is_space(data[i])) ++i;
        size_t start = i;
        while (i < n && !is_space(data[i])) ++i;
        if (i > start)
            ++counts[data.substr(start, i - start)];
    }

    using Entry = std::pair<const std::string*, long long>;
    std::vector<std::vector<Entry>> parts(static_cast<size_t>(n_reducers));
    std::unordered_map<std::string, long long>::const_iterator it;
    for (it = counts.begin(); it != counts.end(); ++it) {
        const std::string& w = it->first;
        unsigned long h = 0;
        size_t lim = std::min(w.size(), static_cast<size_t>(hash_prefix));
        for (size_t j = 0; j < lim; ++j)
            h += static_cast<unsigned char>(w[j]);
        parts[h % n_reducers].emplace_back(&w, it->second);
    }

    for (int p = 0; p < n_reducers; ++p) {
        if (parts[p].empty()) continue;
        std::sort(parts[p].begin(), parts[p].end(),
                  [](const Entry& a, const Entry& b) {
                      return *a.first < *b.first;
                  });
        std::ofstream out(out_tmp_paths[p],
                          std::ios::binary | std::ios::trunc);
        if (!out.is_open()) return 1;
        std::string buf;
        buf.reserve(1 << 20);
        for (const Entry& e : parts[p]) {
            buf += "[\"";
            append_escaped(buf, *e.first);
            buf += "\",[";
            buf += std::to_string(e.second);
            buf += "]]\n";
            if (buf.size() > (1 << 20)) {
                out.write(buf.data(), static_cast<std::streamsize>(buf.size()));
                buf.clear();
            }
        }
        out.write(buf.data(), static_cast<std::streamsize>(buf.size()));
        out.flush();
        if (!out.good()) return 1;
        out.close();
        // fsync before rename — the Python builder's durability
        // discipline (store/sharedfs.py flush+fsync+replace): without it
        // a crash can durably publish a truncated run under its final
        // name and the reducer would silently merge it
        int fd = ::open(out_tmp_paths[p], O_RDONLY);
        if (fd < 0) return 1;
        if (::fsync(fd) != 0) { ::close(fd); return 1; }
        ::close(fd);
        if (std::rename(out_tmp_paths[p], out_final_paths[p]) != 0) return 1;
    }
    return 0;
}
