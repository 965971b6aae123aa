// GIL-released sort/unique primitives for the automaton assembler.
//
// numpy's argsort/unique hold the GIL; the assembler runs them over
// million-row edge arrays.  ctypes calls release the GIL, so the build
// of a large filter set no longer holds the publish path's threads
// for the length of its sorts.

#include <algorithm>
#include <cstdint>
#include <numeric>

extern "C" {

// Stable argsort of int64 keys: order_out[k] = index of k-th smallest.
void su_argsort_i64(const int64_t* in, int64_t n, int64_t* order_out) {
    std::iota(order_out, order_out + n, int64_t{0});
    std::stable_sort(order_out, order_out + n,
                     [in](int64_t a, int64_t b) { return in[a] < in[b]; });
}

// unique + inverse (np.unique(..., return_inverse=True) semantics):
// uniq_out gets the sorted distinct values, inv_out[i] the position of
// in[i] within them.  Returns the distinct count.  uniq_out needs
// capacity n; scratch needs capacity n.
int64_t su_unique_inverse_i64(const int64_t* in, int64_t n,
                              int64_t* uniq_out, int64_t* inv_out,
                              int64_t* scratch) {
    if (n == 0) return 0;
    su_argsort_i64(in, n, scratch);
    int64_t m = 0;
    int64_t prev = 0;
    for (int64_t k = 0; k < n; k++) {
        const int64_t i = scratch[k];
        const int64_t v = in[i];
        if (k == 0 || v != prev) {
            uniq_out[m++] = v;
            prev = v;
        }
        inv_out[i] = m - 1;
    }
    return m;
}

}  // extern "C"
