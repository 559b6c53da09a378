// Native byte-pair-encoding core for the CLIP tokenizer.
//
// The reference tokenizer is pure Python (src/open_clip/tokenizer.py:133-265);
// its hot path — the per-word merge loop — dominates host-side tokenization
// cost at training scale. This C++ core implements the same algorithm
// (greedy lowest-rank adjacent merge over the byte-to-unicode-mapped word)
// behind a minimal C ABI consumed via ctypes (tokenizer.py picks it up when
// the shared object builds; falls back to Python otherwise).
//
// Interface contract (all strings UTF-8):
//   bpe_create(merges_blob, vocab_blob) -> handle
//     merges_blob: '\n'-separated "first second" pairs in rank order
//     vocab_blob:  '\n'-separated token strings in id order
//   bpe_encode_word(handle, word, out, max_out) -> n_ids (or -1 on overflow)
//     word: the byte-to-unicode mapped word WITHOUT the </w> suffix; the
//     core appends </w> to the final symbol, mirroring tokenizer.bpe().
//   Results are memoized per word inside the handle (write-once cache).

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
    size_t operator()(const std::pair<std::string, std::string>& p) const {
        std::hash<std::string> h;
        return h(p.first) * 1000003u ^ h(p.second);
    }
};

struct BpeState {
    std::unordered_map<std::pair<std::string, std::string>, int, PairHash> ranks;
    std::unordered_map<std::string, int> vocab;
    std::unordered_map<std::string, std::vector<int>> cache;
    std::mutex cache_mu;
};

// Split a UTF-8 string into code points (as byte substrings).
static void utf8_split(const std::string& s, std::vector<std::string>& out) {
    size_t i = 0;
    while (i < s.size()) {
        unsigned char c = s[i];
        size_t len = 1;
        if ((c & 0x80u) == 0) len = 1;
        else if ((c & 0xE0u) == 0xC0u) len = 2;
        else if ((c & 0xF0u) == 0xE0u) len = 3;
        else if ((c & 0xF8u) == 0xF0u) len = 4;
        if (i + len > s.size()) len = 1;  // tolerate malformed tails
        out.emplace_back(s.substr(i, len));
        i += len;
    }
}

static void split_lines(const char* blob, std::vector<std::string>& out) {
    const char* p = blob;
    const char* start = p;
    while (*p) {
        if (*p == '\n') {
            out.emplace_back(start, p - start);
            start = p + 1;
        }
        ++p;
    }
    if (p != start) out.emplace_back(start, p - start);
}

static void encode_uncached(const BpeState& st, const std::string& word,
                            std::vector<int>& ids) {
    std::vector<std::string> symbols;
    utf8_split(word, symbols);
    if (symbols.empty()) return;
    symbols.back() += "</w>";

    if (symbols.size() > 1) {
        for (;;) {
            int best_rank = INT32_MAX;
            size_t best_i = 0;
            for (size_t i = 0; i + 1 < symbols.size(); ++i) {
                auto it = st.ranks.find({symbols[i], symbols[i + 1]});
                if (it != st.ranks.end() && it->second < best_rank) {
                    best_rank = it->second;
                    best_i = i;
                }
            }
            if (best_rank == INT32_MAX) break;
            // merge every adjacent occurrence of the best pair, left to right
            const std::string first = symbols[best_i];
            const std::string second = symbols[best_i + 1];
            std::vector<std::string> merged;
            merged.reserve(symbols.size());
            for (size_t i = 0; i < symbols.size();) {
                if (i + 1 < symbols.size() && symbols[i] == first &&
                    symbols[i + 1] == second) {
                    merged.emplace_back(first + second);
                    i += 2;
                } else {
                    merged.emplace_back(symbols[i]);
                    i += 1;
                }
            }
            symbols.swap(merged);
            if (symbols.size() == 1) break;
        }
    }

    ids.reserve(symbols.size());
    for (const auto& sym : symbols) {
        auto it = st.vocab.find(sym);
        if (it != st.vocab.end()) ids.push_back(it->second);
        // unknown symbols are impossible with a complete byte-level vocab;
        // silently skipped if they somehow occur
    }
}

}  // namespace

extern "C" {

void* bpe_create(const char* merges_blob, const char* vocab_blob) {
    auto* st = new BpeState();
    std::vector<std::string> lines;
    split_lines(merges_blob, lines);
    int rank = 0;
    for (const auto& line : lines) {
        size_t sp = line.find(' ');
        if (sp == std::string::npos) continue;
        st->ranks[{line.substr(0, sp), line.substr(sp + 1)}] = rank++;
    }
    lines.clear();
    split_lines(vocab_blob, lines);
    for (size_t i = 0; i < lines.size(); ++i) st->vocab[lines[i]] = (int)i;
    return st;
}

int bpe_encode_word(void* handle, const char* word, int32_t* out, int max_out) {
    auto* st = static_cast<BpeState*>(handle);
    std::string key(word);
    {
        std::lock_guard<std::mutex> lock(st->cache_mu);
        auto it = st->cache.find(key);
        if (it != st->cache.end()) {
            if ((int)it->second.size() > max_out) return -1;
            std::memcpy(out, it->second.data(), it->second.size() * sizeof(int32_t));
            return (int)it->second.size();
        }
    }
    std::vector<int> ids;
    encode_uncached(*st, key, ids);
    {
        std::lock_guard<std::mutex> lock(st->cache_mu);
        st->cache.emplace(std::move(key), ids);
    }
    if ((int)ids.size() > max_out) return -1;
    for (size_t i = 0; i < ids.size(); ++i) out[i] = ids[i];
    return (int)ids.size();
}

void bpe_destroy(void* handle) { delete static_cast<BpeState*>(handle); }

}  // extern "C"
