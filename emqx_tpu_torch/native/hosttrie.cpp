// Native host-side wildcard-filter trie: the hot-path twin of
// emqx_tpu_torch/ops/trie_host.py (same MQTT matching semantics: '+'/'#'
// per level, '#' also matches its parent, root wildcards excluded for
// '$'-topics — the rules of emqx_trie_search.erl:260-348).
//
// The match engine's host tiers (every wildcard filter, the filters
// too deep for the device tables, the residual since the last build)
// and its host re-matches of overflowed rows run here.  Exposed
// through a plain C interface for ctypes; the Python wrapper
// (emqx_tpu_torch/ops/trie_native.py) interns arbitrary Python fid
// objects to dense int64 handles.
//
// Levels are the '/'-separated byte strings of the filter, stored
// verbatim (UTF-8 passthrough, empty levels preserved).

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

// C++17-portable child lookup: heterogeneous unordered_map find()
// (P0919) needs libstdc++ >= 11, so lookups go through one
// thread_local std::string key buffer instead — assign() reuses its
// capacity, so the hot path still allocates no level strings after
// warm-up, on every toolchain this repo meets.
using ChildMap = std::unordered_map<std::string, int32_t>;

thread_local std::string tl_key;

static inline ChildMap::iterator find_sv(ChildMap& ch,
                                         std::string_view sv) {
    tl_key.assign(sv.data(), sv.size());
    return ch.find(tl_key);
}

struct Node {
    ChildMap children;
    // fid -> insertion sequence number; the seq tags let one trie
    // serve both the full set (ht_match) and the "inserted since the
    // last fold watermark" residual view (ht_match_since) without a
    // second structure or a rebuild at fold time
    std::unordered_map<int64_t, int64_t> exact;  // filters ending here
    std::unordered_map<int64_t, int64_t> hash;   // filters '<path>/#'
    // max insert seq anywhere in this node's subtree (monotone upper
    // bound; deletes leave it stale, which only costs pruning power).
    // ht_match_since skips whole subtrees below the watermark, so the
    // residual walk is O(residual-touched paths), not O(full trie).
    int64_t max_seq = 0;
    bool empty() const {
        return children.empty() && exact.empty() && hash.empty();
    }
};

struct Trie {
    std::vector<Node> nodes;      // index 0 = root
    std::vector<int32_t> free_;   // pruned node slots for reuse
    // fid -> its filter string (needed for delete + replace semantics)
    std::unordered_map<int64_t, std::string> filters;
    int64_t seq = 0;              // monotonically increasing insert tag
    Trie() { nodes.emplace_back(); }

    int32_t alloc() {
        if (!free_.empty()) {
            int32_t i = free_.back();
            free_.pop_back();
            nodes[i] = Node();
            return i;
        }
        nodes.emplace_back();
        return (int32_t)nodes.size() - 1;
    }
};

// split on '/', preserving empty levels ("a//b" -> ["a", "", "b"]);
// "" -> [""] (one empty level), matching emqx_tpu_torch.topic.words.
// string_views into the caller's buffer: zero allocations.
static void split_levels(const char* s, std::vector<std::string_view>& out) {
    out.clear();
    const char* start = s;
    const char* p = s;
    for (;; ++p) {
        if (*p == '/' || *p == '\0') {
            out.emplace_back(start, (size_t)(p - start));
            if (*p == '\0') break;
            start = p + 1;
        }
    }
}

thread_local std::vector<std::string_view> tl_ws;

static void remove_path(Trie* t, const std::string& flt, int64_t fid) {
    std::vector<std::string_view> ws;
    split_levels(flt.c_str(), ws);
    bool terminal_hash = !ws.empty() && ws.back() == "#";
    size_t body = terminal_hash ? ws.size() - 1 : ws.size();
    std::vector<int32_t> path;  // nodes along the walk (excluding root)
    int32_t node = 0;
    for (size_t i = 0; i < body; ++i) {
        auto it = find_sv(t->nodes[node].children, ws[i]);
        if (it == t->nodes[node].children.end()) return;
        path.push_back(node);
        node = it->second;
    }
    if (terminal_hash)
        t->nodes[node].hash.erase(fid);
    else
        t->nodes[node].exact.erase(fid);
    // prune now-empty nodes bottom-up
    for (size_t i = body; i-- > 0;) {
        int32_t parent = path[i];
        auto it = find_sv(t->nodes[parent].children, ws[i]);
        if (it == t->nodes[parent].children.end()) break;
        int32_t child = it->second;
        if (!t->nodes[child].empty()) break;
        t->nodes[parent].children.erase(it);
        t->free_.push_back(child);
        node = parent;
    }
}

}  // namespace

extern "C" {

void* ht_new() { return new Trie(); }

void ht_free(void* h) { delete static_cast<Trie*>(h); }

int64_t ht_len(void* h) {
    return (int64_t)static_cast<Trie*>(h)->filters.size();
}

// Insert `flt` under `fid`; re-inserting the same fid replaces its
// previous filter.  Returns the assigned sequence tag (> 0), or 0 when
// the set did not change (same fid, same filter).
int64_t ht_insert(void* h, const char* flt, int64_t fid) {
    Trie* t = static_cast<Trie*>(h);
    auto it = t->filters.find(fid);
    if (it != t->filters.end()) {
        if (it->second == flt) return 0;
        remove_path(t, it->second, fid);
    }
    auto& ws = tl_ws;
    split_levels(flt, ws);
    bool terminal_hash = !ws.empty() && ws.back() == "#";
    size_t body = terminal_hash ? ws.size() - 1 : ws.size();
    int32_t node = 0;
    for (size_t i = 0; i < body; ++i) {
        auto& ch = t->nodes[node].children;
        auto cit = find_sv(ch, ws[i]);
        if (cit == ch.end()) {
            int32_t nn = t->alloc();
            // alloc() may reallocate nodes; re-find the child map
            t->nodes[node].children.emplace(std::string(ws[i]), nn);
            node = nn;
        } else {
            node = cit->second;
        }
    }
    int64_t seq = ++t->seq;
    if (terminal_hash)
        t->nodes[node].hash[fid] = seq;
    else
        t->nodes[node].exact[fid] = seq;
    t->filters[fid] = flt;
    // refresh subtree max along the inserted path (root included)
    node = 0;
    t->nodes[0].max_seq = seq;
    for (size_t i = 0; i < body; ++i) {
        node = find_sv(t->nodes[node].children, ws[i])->second;
        t->nodes[node].max_seq = seq;
    }
    return seq;
}

// Batch insert (the emqx_router_syncer batching shape: route ops
// arrive in windows, and one GIL-released call amortizes the ctypes
// boundary).  Filter i = blob[starts[i], starts[i]+lens[i]); seqs_out
// gets each insert's sequence tag (0 when unchanged).
void ht_insert_batch(void* h, const char* blob, const int64_t* starts,
                     const int64_t* lens, const int64_t* fids,
                     int64_t n, int64_t* seqs_out) {
    for (int64_t i = 0; i < n; i++) {
        std::string f(blob + starts[i], static_cast<size_t>(lens[i]));
        seqs_out[i] = ht_insert(h, f.c_str(), fids[i]);
    }
}

// Latest assigned sequence tag (the fold watermark source).
int64_t ht_seq(void* h) { return static_cast<Trie*>(h)->seq; }

int32_t ht_delete(void* h, int64_t fid) {
    Trie* t = static_cast<Trie*>(h);
    auto it = t->filters.find(fid);
    if (it == t->filters.end()) return 0;
    remove_path(t, it->second, fid);
    t->filters.erase(it);
    return 1;
}

// Match a concrete topic.  Fills `out` (capacity `cap`) with matching
// fids and returns the TOTAL match count (callers grow the buffer and
// retry when the return exceeds cap).
int64_t ht_match(void* h, const char* topic, int64_t* out, int64_t cap) {
    Trie* t = static_cast<Trie*>(h);
    std::vector<std::string_view> name;
    split_levels(topic, name);
    bool dollar = !name.empty() && !name[0].empty() && name[0][0] == '$';
    int64_t n = 0;
    auto emit = [&](const std::unordered_map<int64_t, int64_t>& ids) {
        for (auto& kv : ids) {
            if (n < cap) out[n] = kv.first;
            ++n;
        }
    };
    std::vector<std::pair<int32_t, size_t>> stack;
    stack.emplace_back(0, 0);
    const size_t len = name.size();
    while (!stack.empty()) {
        auto [node, i] = stack.back();
        stack.pop_back();
        // root '#' never matches '$'-topics
        if (!(dollar && node == 0)) emit(t->nodes[node].hash);
        if (i == len) {
            emit(t->nodes[node].exact);
            continue;
        }
        auto& ch = t->nodes[node].children;
        auto lit = find_sv(ch, name[i]);
        if (lit != ch.end()) stack.emplace_back(lit->second, i + 1);
        if (!(dollar && i == 0)) {
            auto plus = find_sv(ch, std::string_view("+", 1));
            if (plus != ch.end()) stack.emplace_back(plus->second, i + 1);
        }
    }
    return n;
}

// Like ht_match, but only filters whose insertion tag is >= min_seq —
// the residual ("inserted since the last fold") view used by the match
// engine's overlay.  Same walk, filtered emit.
int64_t ht_match_since(void* h, const char* topic, int64_t min_seq,
                       int64_t* out, int64_t cap) {
    Trie* t = static_cast<Trie*>(h);
    std::vector<std::string_view> name;
    split_levels(topic, name);
    bool dollar = !name.empty() && !name[0].empty() && name[0][0] == '$';
    int64_t n = 0;
    auto emit = [&](const std::unordered_map<int64_t, int64_t>& ids) {
        for (auto& kv : ids) {
            if (kv.second < min_seq) continue;
            if (n < cap) out[n] = kv.first;
            ++n;
        }
    };
    std::vector<std::pair<int32_t, size_t>> stack;
    if (t->nodes[0].max_seq >= min_seq) stack.emplace_back(0, 0);
    const size_t len = name.size();
    while (!stack.empty()) {
        auto [node, i] = stack.back();
        stack.pop_back();
        if (!(dollar && node == 0)) emit(t->nodes[node].hash);
        if (i == len) {
            emit(t->nodes[node].exact);
            continue;
        }
        auto& ch = t->nodes[node].children;
        auto lit = find_sv(ch, name[i]);
        if (lit != ch.end() && t->nodes[lit->second].max_seq >= min_seq)
            stack.emplace_back(lit->second, i + 1);
        if (!(dollar && i == 0)) {
            auto plus = find_sv(ch, std::string_view("+", 1));
            if (plus != ch.end() && t->nodes[plus->second].max_seq >= min_seq)
                stack.emplace_back(plus->second, i + 1);
        }
    }
    return n;
}

}  // extern "C"
