// Native token dictionary + batch filter and topic encoders.
//
// The automaton build encodes every wildcard filter, and the match
// engine encodes each window's topics that its row cache misses; the
// per-word Python loop holds the GIL for the whole burst.  This
// encoder does the same work in one ctypes call (GIL released): split
// each filter on '/', map words to dense ids ('+' -> PLUS_TOK,
// trailing '#' -> is_hash), and fill the caller's numpy arrays in
// place.
//
// Token-id semantics mirror emqx_tpu_torch/ops/dictionary.py exactly:
// sequential non-negative ids in first-seen order; PLUS_TOK = -3,
// PAD_TOK = -4.  The Python TokenDict stays the lookup map: every word
// NEW to this call is reported back as (id, offset, length) into the
// input blob so the caller can mirror it into its dict — both maps
// always hold the identical word -> id relation.
//
// Thread safety: none here; callers serialize mutations (the engine's
// locks), same contract as the Python dict it mirrors.

#include <cstdint>
#include <string>
#include <string_view>
#include <unordered_map>

namespace {

constexpr int32_t PLUS_TOK = -3;
constexpr int32_t PAD_TOK = -4;
constexpr int32_t UNKNOWN_TOK = -2;

struct TokDict {
    std::unordered_map<std::string, int32_t> ids;
};

}  // namespace

extern "C" {

void* td_new() { return new TokDict(); }

void td_free(void* h) { delete static_cast<TokDict*>(h); }

int64_t td_len(void* h) {
    return static_cast<int64_t>(static_cast<TokDict*>(h)->ids.size());
}

int32_t td_add(void* h, const char* w, int64_t len) {
    auto* d = static_cast<TokDict*>(h);
    std::string key(w, static_cast<size_t>(len));
    auto it = d->ids.find(key);
    if (it != d->ids.end()) return it->second;
    int32_t id = static_cast<int32_t>(d->ids.size());
    d->ids.emplace(std::move(key), id);
    return id;
}

// Bulk-seed the mirror from an existing Python dict: word i =
// blob[starts[i], starts[i]+lens[i]) gets id i (insertion order ==
// id order for the Python dict being mirrored).
void td_seed(void* h, const char* blob, const int64_t* starts,
             const int64_t* lens, int64_t n) {
    auto* d = static_cast<TokDict*>(h);
    d->ids.reserve(static_cast<size_t>(n) * 2);
    for (int64_t i = 0; i < n; i++) {
        d->ids.emplace(
            std::string(blob + starts[i], static_cast<size_t>(lens[i])),
            static_cast<int32_t>(i));
    }
}

int32_t td_get(void* h, const char* w, int64_t len) {
    auto* d = static_cast<TokDict*>(h);
    auto it = d->ids.find(std::string(w, static_cast<size_t>(len)));
    return it == d->ids.end() ? -2 /* UNKNOWN_TOK */ : it->second;
}

// Encode `n` filters out of `blob` (filter i = blob[starts[i],
// starts[i]+lens[i])), writing mat[i*max_levels ..], blen[i], ish[i].
// New words are reported as new_ids[k] / new_spans[2k]=offset /
// new_spans[2k+1]=len.  Returns the count of new words (>= 0) —
// ALWAYS, including on failure, because words inserted before the
// failing filter are already in this map and the caller's Python
// mirror must learn them or the two dictionaries diverge for good.
// *err_i reports the first filter whose body exceeds max_levels (the
// call stops there; its arena rows are not usable), or -1 on success.
int64_t td_encode_filters(void* h, const char* blob, const int64_t* starts,
                          const int64_t* lens, int64_t n,
                          int32_t max_levels, int32_t* mat,
                          int32_t* blen, uint8_t* ish, int32_t* new_ids,
                          int64_t* new_spans, int64_t new_cap,
                          int64_t* err_i) {
    auto* d = static_cast<TokDict*>(h);
    int64_t n_new = 0;
    *err_i = -1;
    for (int64_t i = 0; i < n; i++) {
        const char* s = blob + starts[i];
        const int64_t len = lens[i];
        int32_t* row = mat + i * max_levels;
        for (int32_t k = 0; k < max_levels; k++) row[k] = PAD_TOK;
        // trailing '#' level => hash terminal, stripped from the body
        int64_t body_len = len;
        bool hash = false;
        if (len >= 1 && s[len - 1] == '#' &&
            (len == 1 || s[len - 2] == '/')) {
            hash = true;
            body_len = len >= 2 ? len - 2 : 0;  // drop "#" and its '/'
        }
        ish[i] = hash ? 1 : 0;
        int32_t nlev = 0;
        if (!(body_len == 0 && hash && len == 1)) {
            // split body on '/'; an empty body with hash ("#") has no
            // levels at all, but "a//#" keeps its empty middle level
            int64_t start = 0;
            for (int64_t p = 0; p <= body_len; p++) {
                if (p == body_len || s[p] == '/') {
                    if (nlev >= max_levels) {
                        *err_i = i;
                        return n_new;
                    }
                    const char* w = s + start;
                    const int64_t wl = p - start;
                    if (wl == 1 && w[0] == '+') {
                        row[nlev++] = PLUS_TOK;
                    } else {
                        std::string key(w, static_cast<size_t>(wl));
                        auto it = d->ids.find(key);
                        int32_t id;
                        if (it != d->ids.end()) {
                            id = it->second;
                        } else {
                            id = static_cast<int32_t>(d->ids.size());
                            d->ids.emplace(std::move(key), id);
                            if (n_new < new_cap) {
                                new_ids[n_new] = id;
                                new_spans[2 * n_new] = starts[i] + start;
                                new_spans[2 * n_new + 1] = wl;
                            }
                            n_new++;
                        }
                        row[nlev++] = id;
                    }
                    start = p + 1;
                }
            }
        }
        blen[i] = nlev;
    }
    return n_new;
}

// Topic-row encode (the publish-path tokenizer's MISS path): topic
// i = blob[starts[i], starts[i]+lens[i]) fills row i of the caller's
// mat/lens/dollar slices — get-only lookups (UNKNOWN for words no
// filter ever used), truncation at `levels`, '$'-flag from the first
// byte.  The caller owns the hit cache (a Python dict keyed on the
// topic string, invalidated when the dictionary grows).
void td_encode_topics_into(void* h, const char* blob,
                           const int64_t* starts, const int64_t* lens,
                           int64_t n, int32_t levels, int32_t* mat,
                           int32_t* out_lens, uint8_t* dollar) {
    auto* d = static_cast<TokDict*>(h);
    for (int64_t i = 0; i < n; i++) {
        const char* s = blob + starts[i];
        const int64_t len = lens[i];
        int32_t* mrow = mat + i * levels;
        for (int32_t k = 0; k < levels; k++) mrow[k] = PAD_TOK;
        dollar[i] = (len > 0 && s[0] == '$') ? 1 : 0;
        int32_t nlev = 0;
        int64_t start = 0;
        for (int64_t p = 0; p <= len && nlev < levels; p++) {
            if (p == len || s[p] == '/') {
                auto wit = d->ids.find(
                    std::string(s + start, static_cast<size_t>(p - start)));
                mrow[nlev++] =
                    wit == d->ids.end() ? UNKNOWN_TOK : wit->second;
                start = p + 1;
            }
        }
        out_lens[i] = nlev;
    }
}

}  // extern "C"
