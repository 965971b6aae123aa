// Hand-written Hopper (sm_90a) kernels for the broker's publish path:
// the trie-automaton frontier scan (dense, compact and sharded outputs)
// and the per-delivery decide pass.  Plain C entry points, bound with ctypes by
// emqx_tpu_torch/ops/_kernels.py; every launch goes on the caller's
// stream and each entry point returns cudaGetLastError().
//
// Replaces (JAX package, compiled by XLA for the TPU):
//   match_rows_kernel            emqx_tpu/ops/match_kernel.py:70 _match_core
//                                (+ :53 _fp_lookup) as used by
//                                :159 match_batch (dense output)
//   scan_counts_kernel +
//   compact_scatter_kernel       :190 match_batch_compact's compaction
//                                (:224-234: exclusive scan of the
//                                clipped counts, scatter into flat,
//                                int16 counts, total)
//   decide_kernel                :270 decide_batch
//   sharded_match_rows_kernel    emqx_tpu/parallel/sharded.py:176-230
//                                sharded_match: the shard_map of
//                                match_batch over the (sub, pub) mesh
//                                and its psum of counts over sub
//
// What bounds them on this card.  The match scan is bound by random
// gathers: per live frontier lane per level one 64 B bucket row
// (fp_rows) and one 32 B node row (node_rows).  The tables are about
// 12 MB at 1M filters and fit the 50 MB L2; at 10M filters they do not,
// and every gather is a DRAM transaction.  Arithmetic (two 32-bit
// hashes, an 8-wide compare and a 2F-element sort per lane) is small
// beside it.  This first version gives each topic row one thread, keeps
// the frontier and the 2F candidates in per-thread arrays and sorts
// them by insertion: simple and exactly the reference semantics; the
// latency of the dependent gathers is hidden only by the number of rows
// in flight.  decide is a streaming gather-and-pack, bound by its bytes.
//
// The sharded match runs the same per-row scan (scan_row) for every
// (row, shard) pair of a grid whose y axis is the shard: the shards
// that live on one device share one launch, each reading its own slice
// of the stacked tables and its own salt from the device array
// salts[K].  The TPU version reduces the per-shard counts with a psum
// over the sub axis; here each (row, shard) thread adds its clipped
// count into total[row] with an integer atomicAdd, exact in any order.
// Across devices the caller adds the per-device partial totals.
//
// Semantics that must hold bit for bit (see match_kernel.py):
//   - candidates: F literal lookups then F '+' children, sorted
//     ascending, adjacent duplicates replaced by SENTINEL in place, the
//     first F slots kept; a live candidate past slot F is overflow;
//   - codes leave in the order root '#', per level the lanes in slot
//     order, then final exact hits; node*2 overflows int32 for SENTINEL
//     lanes, so codes are only formed for hit lanes;
//   - '$'-topics: no root '+' (candidates and verification), no root '#';
//   - rows past their length keep their frontier and record nothing;
//   - the literal child is the MAX child over the fingerprint hits,
//     fingerprints compared as int32 bit patterns.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr int kPlusTok = -3;
constexpr int kBucket = 8;
constexpr int kFMax = 16;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ uint32_t mix32(uint32_t a, uint32_t b) {
  uint32_t x = a * 0x9E3779B1u;
  uint32_t y = b * 0x85EBCA6Bu + 0x165667B1u;
  uint32_t h = x ^ y;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  return h;
}

__device__ __forceinline__ int clamp_node(int c, int n_nodes) {
  return c < 0 ? 0 : (c >= n_nodes ? n_nodes - 1 : c);
}

// The frontier scan of one topic row through one automaton (the body
// K2 and K5 share, so the two cannot drift apart).  Writes the row's
// first m_cap codes (-1 padded) to out and returns the clipped count;
// *ovf_out is the overflow flag (frontier overflow or count > m_cap).
__device__ __forceinline__ int scan_row(
    const int* __restrict__ fp_rows, int nb,
    const int* __restrict__ node_rows, int n_nodes, uint32_t salt,
    const int* __restrict__ toks, int len, bool is_dollar, int f_width,
    int m_cap, int* __restrict__ out, bool* ovf_out) {
  const uint32_t s2 = salt * 0x9E3779B1u;
  int frontier[kFMax];
  int plus_child[kFMax];  // node row col 0 of each lane's node
  int exact_flag[kFMax];  // node row col 2
  int cand[2 * kFMax];
  for (int k = 0; k < f_width; ++k) frontier[k] = kSentinel;
  frontier[0] = 0;
  plus_child[0] = node_rows[0];
  exact_flag[0] = node_rows[2];

  int count = 0;
  bool over = false;
  // root '#': never on a '$'-topic
  if (node_rows[1] > 0 && !is_dollar) {
    if (count < m_cap) out[count] = 1;
    ++count;
  }
  for (int i = 0; i < len; ++i) {
    const int tok = toks[i];
    const bool root_dollar = is_dollar && i == 0;
    for (int k = 0; k < f_width; ++k) {
      const int node = frontier[k];
      int lit = kSentinel, plus = kSentinel;
      if (node != kSentinel) {
        const uint32_t pu = (uint32_t)node, tu = (uint32_t)tok;
        const uint32_t h0 = mix32(pu + salt, tu);
        const int fp = (int)mix32(tu, pu ^ s2);
        const int4* bucket = reinterpret_cast<const int4*>(
            fp_rows + (size_t)(h0 & (uint32_t)(nb - 1)) * (2 * kBucket));
        const int4 f0 = bucket[0], f1 = bucket[1];
        const int4 c0 = bucket[2], c1 = bucket[3];
        int child = -1;
        child = (f0.x == fp && c0.x > child) ? c0.x : child;
        child = (f0.y == fp && c0.y > child) ? c0.y : child;
        child = (f0.z == fp && c0.z > child) ? c0.z : child;
        child = (f0.w == fp && c0.w > child) ? c0.w : child;
        child = (f1.x == fp && c1.x > child) ? c1.x : child;
        child = (f1.y == fp && c1.y > child) ? c1.y : child;
        child = (f1.z == fp && c1.z > child) ? c1.z : child;
        child = (f1.w == fp && c1.w > child) ? c1.w : child;
        if (child >= 0) lit = child;
        if (!root_dollar) plus = plus_child[k];
      }
      cand[k] = lit;
      cand[f_width + k] = plus;
    }
    // insertion sort of the 2F candidates, ascending
    const int n_cand = 2 * f_width;
    for (int a = 1; a < n_cand; ++a) {
      const int v = cand[a];
      int b = a - 1;
      while (b >= 0 && cand[b] > v) {
        cand[b + 1] = cand[b];
        --b;
      }
      cand[b + 1] = v;
    }
    // duplicate kill against the sorted values, then the overflow flag
    for (int a = f_width; a < n_cand; ++a) {
      if (cand[a] != kSentinel && cand[a] != cand[a - 1]) over = true;
    }
    int nf[kFMax];
    for (int k = f_width - 1; k >= 1; --k)
      nf[k] = (cand[k] == cand[k - 1]) ? kSentinel : cand[k];
    nf[0] = cand[0];
    // incoming-edge verification against the previous frontier
    for (int k = 0; k < f_width; ++k) {
      const int c = nf[k];
      if (c == kSentinel) continue;
      const int4* nr = reinterpret_cast<const int4*>(
          node_rows + (size_t)clamp_node(c, n_nodes) * 8);
      const int4 r0 = nr[0], r1 = nr[1];
      const int eparent = r1.x, etok = r1.y;
      bool in_prev = false;
      for (int q = 0; q < f_width; ++q) in_prev |= (eparent == frontier[q]);
      const bool plus_ok = etok == kPlusTok && !root_dollar;
      if (in_prev && (etok == tok || plus_ok)) {
        plus_child[k] = r0.x;
        exact_flag[k] = r0.z;
        if (r0.y > 0) {  // '#'-terminal hit at this level
          if (count < m_cap) out[count] = c * 2 + 1;
          ++count;
        }
      } else {
        nf[k] = kSentinel;
      }
    }
    for (int k = 0; k < f_width; ++k) frontier[k] = nf[k];
  }
  for (int k = 0; k < f_width; ++k) {
    if (frontier[k] != kSentinel && exact_flag[k] > 0) {
      if (count < m_cap) out[count] = frontier[k] * 2;
      ++count;
    }
  }
  const int count_c = count < m_cap ? count : m_cap;
  for (int j = count_c; j < m_cap; ++j) out[j] = -1;
  *ovf_out = over || count > m_cap;
  return count_c;
}

// K2: one thread per topic row.  Writes the row's codes to codes[row],
// the clipped count to counts[row] and the overflow flag to ovf[row].
__global__ void match_rows_kernel(
    const int* __restrict__ fp_rows, int nb,
    const int* __restrict__ node_rows, int n_nodes, uint32_t salt,
    const int* __restrict__ tokens, const int* __restrict__ lengths,
    const uint8_t* __restrict__ dollar, int n_rows, int levels,
    int f_width, int m_cap,
    int* __restrict__ codes, int* __restrict__ counts,
    uint8_t* __restrict__ ovf) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const int len = lengths[row] < levels ? lengths[row] : levels;
  bool over;
  counts[row] = scan_row(fp_rows, nb, node_rows, n_nodes, salt,
                         tokens + (size_t)row * levels, len,
                         dollar[row] != 0, f_width, m_cap,
                         codes + (size_t)row * m_cap, &over);
  ovf[row] = over ? 1 : 0;
}

// K5: the (row, shard) grid of the sharded match.  Shard k (blockIdx.y)
// scans row against its slice of the stacked tables fp_rows [K, nb,
// 2*kBucket] and node_rows [K, n_nodes, 8] with its own salt salts[k],
// writes codes [K, B, m_cap], counts [K, B] and ovf [K, B], and adds its
// clipped count into total[row] (zeroed by the caller): the psum over
// the sub axis, exact in any order because it is an integer sum.
__global__ void sharded_match_rows_kernel(
    const int* __restrict__ fp_rows, int nb,
    const int* __restrict__ node_rows, int n_nodes,
    const uint32_t* __restrict__ salts, const int* __restrict__ tokens,
    const int* __restrict__ lengths, const uint8_t* __restrict__ dollar,
    int n_rows, int levels, int f_width, int m_cap,
    int* __restrict__ codes, int* __restrict__ counts,
    uint8_t* __restrict__ ovf, int* __restrict__ total) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const int k = blockIdx.y;
  const size_t kr = (size_t)k * n_rows + row;
  const int len = lengths[row] < levels ? lengths[row] : levels;
  bool over;
  const int n = scan_row(
      fp_rows + (size_t)k * nb * (2 * kBucket), nb,
      node_rows + (size_t)k * n_nodes * 8, n_nodes, salts[k],
      tokens + (size_t)row * levels, len, dollar[row] != 0, f_width, m_cap,
      codes + kr * m_cap, &over);
  counts[kr] = n;
  ovf[kr] = over ? 1 : 0;
  if (n) atomicAdd(total + row, n);
}

// Exclusive scan of the clipped counts by one block walking the rows in
// chunks of kScanThreads, carrying the running sum; writes total.
__global__ void scan_counts_kernel(const int* __restrict__ counts,
                                   int n_rows, int* __restrict__ row_start,
                                   int* __restrict__ total) {
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < n_rows; base += kScanThreads) {
    const int idx = base + tid;
    const int v = idx < n_rows ? counts[idx] : 0;
    int x = v;  // inclusive warp scan
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
      }
      warp_sums[lane] = w;  // inclusive prefix over warps
    }
    __syncthreads();
    const int warp_off = warp ? warp_sums[warp - 1] : 0;
    if (idx < n_rows) row_start[idx] = carry + warp_off + x - v;
    __syncthreads();
    if (tid == 0) carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (tid == 0) total[0] = carry;
}

// Rows scatter their codes to flat[row_start + j] (dropping positions
// >= c_cap) and write the int16 counts (negative on overflow); flat
// positions from total on are filled with -1.  The two loops touch
// disjoint positions, so they share one grid.
__global__ void compact_scatter_kernel(
    const int* __restrict__ codes, const int* __restrict__ counts,
    const uint8_t* __restrict__ ovf, const int* __restrict__ row_start,
    const int* __restrict__ total, int n_rows, int m_cap, int c_cap,
    int* __restrict__ flat, int16_t* __restrict__ counts_out) {
  const int stride = gridDim.x * blockDim.x;
  const int start = blockIdx.x * blockDim.x + threadIdx.x;
  for (int row = start; row < n_rows; row += stride) {
    const int n = counts[row];
    const int off = row_start[row];
    const int* src = codes + (size_t)row * m_cap;
    for (int j = 0; j < n && off + j < c_cap; ++j) flat[off + j] = src[j];
    counts_out[row] = (int16_t)(ovf[row] ? -n - 1 : n);
  }
  const int tot = total[0];
  for (int t = (tot < c_cap ? tot : c_cap) + start; t < c_cap; t += stride)
    flat[t] = -1;
}

// One thread per delivery: five gathers, one packed byte.
__global__ void decide_kernel(
    const int8_t* __restrict__ oa_qos, const uint8_t* __restrict__ oa_nl,
    const uint8_t* __restrict__ oa_rap, const uint8_t* __restrict__ oa_subid,
    const int* __restrict__ opts_rows, const int* __restrict__ client_rows,
    const int* __restrict__ msg_idx, const int8_t* __restrict__ m_qos,
    const uint8_t* __restrict__ m_retain, const int* __restrict__ m_from_row,
    int n, uint8_t* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int o = opts_rows[t];
  const int m = msg_idx[t];
  const int oq = oa_qos[o];
  const int mq = m_qos[m];
  const bool drop = oa_nl[o] && client_rows[t] == m_from_row[m];
  const bool ret = m_retain[m] && oa_rap[o];
  const int packed = (mq < oq ? mq : oq) | ((mq > oq ? mq : oq) << 2) |
                     (drop ? 1 << 4 : 0) | (ret ? 1 << 5 : 0) |
                     (oa_subid[o] ? 1 << 6 : 0);
  out[t] = (uint8_t)packed;
}

constexpr int kRowThreads = 128;

int blocks_for(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

const char* emqx_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int emqx_match_rows(const int* fp_rows, int nb, const int* node_rows,
                    int n_nodes, unsigned int salt, const int* tokens,
                    const int* lengths, const uint8_t* dollar, int n_rows,
                    int levels, int f_width, int m_cap, int* codes,
                    int* counts, uint8_t* ovf, void* stream) {
  match_rows_kernel<<<blocks_for(n_rows, kRowThreads), kRowThreads, 0,
                      (cudaStream_t)stream>>>(
      fp_rows, nb, node_rows, n_nodes, salt, tokens, lengths, dollar,
      n_rows, levels, f_width, m_cap, codes, counts, ovf);
  return (int)cudaGetLastError();
}

int emqx_sharded_match_rows(const int* fp_rows, int nb,
                            const int* node_rows, int n_nodes,
                            const uint32_t* salts, int n_shards,
                            const int* tokens, const int* lengths,
                            const uint8_t* dollar, int n_rows, int levels,
                            int f_width, int m_cap, int* codes, int* counts,
                            uint8_t* ovf, int* total, void* stream) {
  if (n_shards < 1 || n_shards > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(blocks_for(n_rows, kRowThreads), n_shards);
  sharded_match_rows_kernel<<<grid, kRowThreads, 0, (cudaStream_t)stream>>>(
      fp_rows, nb, node_rows, n_nodes, salts, tokens, lengths, dollar,
      n_rows, levels, f_width, m_cap, codes, counts, ovf, total);
  return (int)cudaGetLastError();
}

int emqx_compact(const int* codes, const int* counts, const uint8_t* ovf,
                 int n_rows, int m_cap, int c_cap, int* row_start,
                 int* total, int* flat, int16_t* counts_out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  scan_counts_kernel<<<1, kScanThreads, 0, s>>>(counts, n_rows, row_start,
                                                total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  long long work = n_rows > c_cap ? n_rows : c_cap;
  int blocks = blocks_for(work, 256);
  if (blocks > 4096) blocks = 4096;
  compact_scatter_kernel<<<blocks, 256, 0, s>>>(
      codes, counts, ovf, row_start, total, n_rows, m_cap, c_cap, flat,
      counts_out);
  return (int)cudaGetLastError();
}

int emqx_decide(const int8_t* oa_qos, const uint8_t* oa_nl,
                const uint8_t* oa_rap, const uint8_t* oa_subid,
                const int* opts_rows, const int* client_rows,
                const int* msg_idx, const int8_t* m_qos,
                const uint8_t* m_retain, const int* m_from_row, int n,
                uint8_t* out, void* stream) {
  decide_kernel<<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
      oa_qos, oa_nl, oa_rap, oa_subid, opts_rows, client_rows, msg_idx,
      m_qos, m_retain, m_from_row, n, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
