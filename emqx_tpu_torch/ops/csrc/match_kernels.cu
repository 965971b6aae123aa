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
//   match_compact_kernel         :190 match_batch_compact: the same scan
//                                and its compaction (:224-234: exclusive
//                                scan of the clipped counts, scatter into
//                                flat, int16 counts, total) in one pass
//   decide_kernel                :270 decide_batch (with its index
//                                range check, which the JAX wrapper's
//                                gathers clamp instead, fused in)
//   sharded_match_rows_kernel    emqx_tpu/parallel/sharded.py:176-230
//                                sharded_match: the shard_map of
//                                match_batch over the (sub, pub) mesh
//                                and its psum of counts over sub
//
// What bounds them on this card.  The match scan is bound by random
// gathers: per live frontier lane per level one 64 B bucket row
// (fp_rows) and one 32 B node row (node_rows).  The tables are about
// 12 MB at 1M filters and fit the 50 MB L2; at 10M filters they do not,
// and every gather is a DRAM transaction.  Each level of a topic row
// costs two dependent gathers, so the scan is bound by their latency
// unless many of them are in flight.  decide is a streaming
// gather-and-pack, bound by its bytes (see decide_kernel).
//
// The lane-group scan (scan_group, shared by the three match kernels).
// A topic row is walked by a group of G lanes of one warp, G the next
// power of two >= f_width (a template parameter, 1..16; the entry points
// dispatch on it).  Lane k owns frontier slot k and keeps its node, its
// '+' child and its exact flag in registers; lanes k >= f_width hold
// SENTINEL.  Per level every live lane hashes its own (node, tok) and
// loads its own bucket row, so a row's gathers are in flight together.
// The 2F candidates (lane k: its literal child and its '+' child) are
// sorted as 2G values by a bitonic network: shuffles between lanes for
// strides < G, a compare-exchange inside the lane for stride G, laid out
// so that sorted position k < G lands in lane k's first register.
// SENTINEL is the largest int, so the padding lanes sort last and change
// nothing.  Duplicates die against the neighbour (a shuffle up), the
// overflow flag is a ballot, each lane verifies its own candidate's node
// row against the previous frontier (broadcast by shuffles), and hits
// leave at count + popc(ballot & lanes below), which keeps the
// reference's order.  No array is indexed at run time, so nothing lives
// in local memory.  A real topic keeps about one live slot a level, so
// most lanes hold SENTINEL; three exact shortcuts make a level cost in
// proportion to its live slots: the scan stops at an empty frontier,
// few live candidates are placed by rank instead of the network
// (kRankSort below), and edges are checked against the live slots only.
//
// The sharded match runs scan_group for every (row, shard) pair of a
// grid whose y axis is the shard: the shards that live on one device
// share one launch, each reading its own slice of the stacked tables
// and its own salt from the device array salts[K].  The TPU version
// reduces the per-shard counts with a psum over the sub axis; here one
// lane of each (row, shard) group adds the clipped count into
// total[row] with an integer atomicAdd, exact in any order.  Across
// devices the caller adds the per-device partial totals.
//
// The compact match is one pass: each block stages its rows' codes in
// shared memory, scans their clipped counts, finds its offset in flat
// by a chained scan with decoupled look-back (blocks ordered by an
// atomic ticket, so a block only ever waits on blocks that already run)
// and writes its codes there.  The entry point fills flat with -1 and
// zeroes the look-back scratch (two memsets) before the launch.
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
#include <type_traits>

namespace {

constexpr int kSentinel = 0x7fffffff;
constexpr int kPlusTok = -3;
constexpr int kBucket = 8;
constexpr int kFMax = 16;
constexpr int kRowThreads = 128;
// scan kernels: at least 8 blocks of 128 lanes an SM, so up to 64
// registers a lane (without it ptxas gave one instantiation 32 and a
// spill)
constexpr int kMinBlocks = 8;
constexpr unsigned kFull = 0xffffffffu;
// candidates are placed by rank instead of the bitonic network when at
// most min(G, kRankSort) of them are live
constexpr int kRankSort = 4;
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemMax = 227 * 1024 - 2048;  // less K1's static arrays
// look-back status words: value << 2 | flag
constexpr unsigned long long kAggregate = 1, kPrefix = 2;

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

// Ascending bitonic sort of the group's 2G values: element gl in a,
// element G + gl in b.  Stride j < G pairs lanes gl and gl ^ j (same
// register), stride G pairs a and b of one lane.
template <int G>
__device__ __forceinline__ void sort_2g(int& a, int& b, int gl,
                                        unsigned gmask) {
#pragma unroll
  for (int s = 2; s <= 2 * G; s <<= 1) {
#pragma unroll
    for (int j = s >> 1; j > 0; j >>= 1) {
      if (j == G) {
        const int lo = min(a, b);
        b = max(a, b);
        a = lo;
      } else {
        const int pa = __shfl_xor_sync(gmask, a, j);
        const int pb = __shfl_xor_sync(gmask, b, j);
        const bool lower = (gl & j) == 0;
        const bool up_a = (gl & s) == 0;  // ascending run of element gl
        const bool up_b = ((G + gl) & s) == 0;
        a = lower == up_a ? min(a, pa) : max(a, pa);
        b = lower == up_b ? min(b, pb) : max(b, pb);
      }
    }
  }
}

// The same ascending order when at most min(G, kRankSort) of the 2G
// values are live (not SENTINEL), as most levels of a real topic are:
// each live
// value's rank is the live values below it plus its equals earlier in
// candidate order (the a's by lane, then the b's), and lane r takes the
// value of rank r.  Positions from the live count on hold SENTINEL.
// live_a / live_b are the group's ballots of live a and b values.
template <int G>
__device__ __forceinline__ void rank_2g(int& a, int& b, unsigned live_a,
                                        unsigned live_b, unsigned gmask,
                                        unsigned below) {
  const int n_a = __popc(live_a);
  const int ord_a = __popc(live_a & below);
  const int ord_b = n_a + __popc(live_b & below);
  int rank_a = 0, rank_b = 0, ord = 0;
  for (unsigned m = live_a; m; m &= m - 1, ++ord) {
    const int v = __shfl_sync(gmask, a, __ffs(m) - 1);
    rank_a += v < a || (v == a && ord < ord_a);
    rank_b += v < b || (v == b && ord < ord_b);
  }
  for (unsigned m = live_b; m; m &= m - 1, ++ord) {
    const int v = __shfl_sync(gmask, b, __ffs(m) - 1);
    rank_a += v < a || (v == a && ord < ord_a);
    rank_b += v < b || (v == b && ord < ord_b);
  }
  const int gl = threadIdx.x & (G - 1);
  int sa = kSentinel;  // every rank is < G: every b slot is SENTINEL
  for (unsigned m = live_a; m; m &= m - 1) {
    const int src = __ffs(m) - 1;
    const int v = __shfl_sync(gmask, a, src);
    if (__shfl_sync(gmask, rank_a, src) == gl) sa = v;
  }
  for (unsigned m = live_b; m; m &= m - 1) {
    const int src = __ffs(m) - 1;
    const int v = __shfl_sync(gmask, b, src);
    if (__shfl_sync(gmask, rank_b, src) == gl) sa = v;
  }
  a = sa;
  b = kSentinel;
}

// The frontier scan of one topic row through one automaton by a group
// of G lanes (the body K1, K2 and K5 share, so they cannot drift
// apart).  Every lane of the group calls it with the same row.  Writes
// the row's codes at positions < m_cap of out (global or shared memory;
// positions past the count are left alone) and returns the unclipped
// count; *over_out is the frontier-overflow flag.
template <int G>
__device__ __forceinline__ int scan_group(
    const int* __restrict__ fp_rows, int nb,
    const int* __restrict__ node_rows, int n_nodes, uint32_t salt,
    const int* __restrict__ toks, int len, bool is_dollar, int f_width,
    int m_cap, int* out, bool* over_out) {
  static_assert(G >= 1 && G <= kFMax && (G & (G - 1)) == 0, "group width");
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const unsigned gmask = ((1u << G) - 1u) << (lane & ~(G - 1));
  const unsigned below = gmask & ((1u << lane) - 1u);
  const uint32_t s2 = salt * 0x9E3779B1u;
  const int4 root = *reinterpret_cast<const int4*>(node_rows);
  int node = gl == 0 ? 0 : kSentinel;
  int plus_child = root.x;  // node row col 0 of this lane's node
  int exact_flag = root.z;  // node row col 2
  int count = 0;
  bool over = false;
  // root '#': never on a '$'-topic
  if (root.y > 0 && !is_dollar) {
    if (gl == 0) out[0] = 1;
    count = 1;
  }
  for (int i = 0; i < len; ++i) {
    // an empty frontier stays empty and records nothing
    const unsigned live = __ballot_sync(gmask, node != kSentinel) & gmask;
    if (!live) break;
    const int tok = toks[i];
    const bool root_dollar = is_dollar && i == 0;
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
      if (!root_dollar) plus = plus_child;
    }
    // lit becomes sorted[gl], plus sorted[G + gl]
    const unsigned live_lit = __ballot_sync(gmask, lit != kSentinel) & gmask;
    const unsigned live_plus = __ballot_sync(gmask, plus != kSentinel) & gmask;
    if (__popc(live_lit) + __popc(live_plus) <= (G < kRankSort ? G : kRankSort))
      rank_2g<G>(lit, plus, live_lit, live_plus, gmask, below);
    else
      sort_2g<G>(lit, plus, gl, gmask);
    // duplicate kill against the sorted values, then the overflow flag
    const int up0 = __shfl_up_sync(gmask, lit, 1, G);
    const int up1 = __shfl_up_sync(gmask, plus, 1, G);
    const int top = __shfl_sync(gmask, lit, G - 1, G);
    const int k0 = (gl > 0 && lit == up0) ? kSentinel : lit;
    const int k1 = (plus == (gl == 0 ? top : up1)) ? kSentinel : plus;
    const bool past_f = (gl >= f_width && k0 != kSentinel) || k1 != kSentinel;
    over |= (__ballot_sync(gmask, past_f) & gmask) != 0;
    int nf = gl < f_width ? k0 : kSentinel;
    // incoming-edge verification against the previous frontier
    int4 r0 = make_int4(0, 0, 0, 0), r1 = make_int4(0, 0, 0, 0);
    if (nf != kSentinel) {
      const int4* nr = reinterpret_cast<const int4*>(
          node_rows + (size_t)clamp_node(nf, n_nodes) * 8);
      r0 = nr[0];
      r1 = nr[1];
    }
    const int eparent = r1.x, etok = r1.y;
    // against the live slots; a dead slot below f_width holds SENTINEL
    bool in_prev = eparent == kSentinel && __popc(live) < f_width;
    for (unsigned m = live; m; m &= m - 1)
      in_prev |= eparent == __shfl_sync(gmask, node, __ffs(m) - 1);
    const bool plus_ok = etok == kPlusTok && !root_dollar;
    const bool ok = nf != kSentinel && in_prev && (etok == tok || plus_ok);
    const bool hash_hit = ok && r0.y > 0;  // '#'-terminal hit at this level
    const unsigned hits = __ballot_sync(gmask, hash_hit) & gmask;
    if (hash_hit) {
      const int pos = count + __popc(hits & below);
      if (pos < m_cap) out[pos] = nf * 2 + 1;
    }
    count += __popc(hits);
    if (ok) {
      plus_child = r0.x;
      exact_flag = r0.z;
    } else {
      nf = kSentinel;
    }
    node = nf;
  }
  const bool exact_hit = node != kSentinel && exact_flag > 0;
  const unsigned hits = __ballot_sync(gmask, exact_hit) & gmask;
  if (exact_hit) {
    const int pos = count + __popc(hits & below);
    if (pos < m_cap) out[pos] = node * 2;
  }
  count += __popc(hits);
  *over_out = over;
  return count;
}

// A dense row's -1 padding from n on, the group's lanes on neighbouring
// addresses, 16 B a store where the row is 16 B aligned.
template <int G>
__device__ __forceinline__ void pad_row(int* __restrict__ out, int n,
                                        int m_cap, int gl, bool vec) {
  if (vec) {
    const int n4 = (n + 3) & ~3;
    for (int j = n + gl; j < n4; j += G) out[j] = -1;
    int4* o4 = reinterpret_cast<int4*>(out);
    const int4 m1 = make_int4(-1, -1, -1, -1);
    for (int q = (n4 >> 2) + gl; q < (m_cap >> 2); q += G) o4[q] = m1;
  } else {
    for (int j = n + gl; j < m_cap; j += G) out[j] = -1;
  }
}

// K2: one group of G lanes per topic row.  Writes the row's codes to
// codes[row], the clipped count to counts[row] and the overflow flag to
// ovf[row].
template <int G>
__global__ void __launch_bounds__(kRowThreads, kMinBlocks)
match_rows_kernel(
    const int* __restrict__ fp_rows, int nb,
    const int* __restrict__ node_rows, int n_nodes, uint32_t salt,
    const int* __restrict__ tokens, const int* __restrict__ lengths,
    const uint8_t* __restrict__ dollar, int n_rows, int levels,
    int f_width, int m_cap,
    int* __restrict__ codes, int* __restrict__ counts,
    uint8_t* __restrict__ ovf) {
  const int row = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) / G);
  if (row >= n_rows) return;  // the whole group leaves together
  const int gl = threadIdx.x & (G - 1);
  const int len = lengths[row] < levels ? lengths[row] : levels;
  int* out = codes + (size_t)row * m_cap;
  bool over;
  const int count = scan_group<G>(
      fp_rows, nb, node_rows, n_nodes, salt, tokens + (size_t)row * levels,
      len, dollar[row] != 0, f_width, m_cap, out, &over);
  const int n = count < m_cap ? count : m_cap;
  pad_row<G>(out, n, m_cap, gl,
             (m_cap & 3) == 0 && ((uintptr_t)codes & 15) == 0);
  if (gl == 0) {
    counts[row] = n;
    ovf[row] = over || count > m_cap ? 1 : 0;
  }
}

// K5: the (row, shard) grid of the sharded match.  Shard k (blockIdx.y)
// scans row against its slice of the stacked tables fp_rows [K, nb,
// 2*kBucket] and node_rows [K, n_nodes, 8] with its own salt salts[k],
// writes codes [K, B, m_cap], counts [K, B] and ovf [K, B], and adds its
// clipped count into total[row] (zeroed by the caller): the psum over
// the sub axis, exact in any order because it is an integer sum.
template <int G>
__global__ void __launch_bounds__(kRowThreads, kMinBlocks)
sharded_match_rows_kernel(
    const int* __restrict__ fp_rows, int nb,
    const int* __restrict__ node_rows, int n_nodes,
    const uint32_t* __restrict__ salts, const int* __restrict__ tokens,
    const int* __restrict__ lengths, const uint8_t* __restrict__ dollar,
    int n_rows, int levels, int f_width, int m_cap,
    int* __restrict__ codes, int* __restrict__ counts,
    uint8_t* __restrict__ ovf, int* __restrict__ total) {
  const int row = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) / G);
  if (row >= n_rows) return;
  const int gl = threadIdx.x & (G - 1);
  const int k = blockIdx.y;
  const size_t kr = (size_t)k * n_rows + row;
  const int len = lengths[row] < levels ? lengths[row] : levels;
  int* out = codes + kr * m_cap;
  bool over;
  const int count = scan_group<G>(
      fp_rows + (size_t)k * nb * (2 * kBucket), nb,
      node_rows + (size_t)k * n_nodes * 8, n_nodes, salts[k],
      tokens + (size_t)row * levels, len, dollar[row] != 0, f_width, m_cap,
      out, &over);
  const int n = count < m_cap ? count : m_cap;
  pad_row<G>(out, n, m_cap, gl,
             (m_cap & 3) == 0 && ((uintptr_t)codes & 15) == 0);
  if (gl == 0) {
    counts[kr] = n;
    ovf[kr] = over || count > m_cap ? 1 : 0;
    if (n) atomicAdd(total + row, n);
  }
}

// Warp 0 of a K1 block: the exclusive scan of the block's clipped row
// counts (row_cnt -> row_off, up to 4 rows a lane), then the block's
// offset in flat by a decoupled look-back over the status words of the
// earlier tickets, 32 at a time: status[t] is the block's aggregate
// (flag kAggregate) until it knows its inclusive prefix (kPrefix).
// Ticket t only waits on tickets < t, whose blocks already run.
__device__ __forceinline__ unsigned long long block_offset(
    int t, int rows, const int* row_cnt, int* row_off,
    unsigned long long* status, bool last, int* total) {
  const int lane = threadIdx.x;
  const int i0 = lane * 4;
  const int c0 = i0 < rows ? row_cnt[i0] : 0;
  const int c1 = i0 + 1 < rows ? row_cnt[i0 + 1] : 0;
  const int c2 = i0 + 2 < rows ? row_cnt[i0 + 2] : 0;
  const int c3 = i0 + 3 < rows ? row_cnt[i0 + 3] : 0;
  const int sum = c0 + c1 + c2 + c3;
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  const unsigned long long agg = (unsigned)__shfl_sync(kFull, incl, 31);
  const int off = incl - sum;
  if (i0 < rows) row_off[i0] = off;
  if (i0 + 1 < rows) row_off[i0 + 1] = off + c0;
  if (i0 + 2 < rows) row_off[i0 + 2] = off + c0 + c1;
  if (i0 + 3 < rows) row_off[i0 + 3] = off + c0 + c1 + c2;
  unsigned long long excl = 0;
  if (t > 0) {
    if (lane == 0) atomicExch(status + t, (agg << 2) | kAggregate);
    for (int j = t - 1 - lane;; j -= 32) {
      unsigned long long s = kPrefix;  // before ticket 0: a prefix of 0
      if (j >= 0) {
        do {
          s = *reinterpret_cast<volatile unsigned long long*>(status + j);
        } while ((s & 3) == 0);
      }
      const unsigned pre = __ballot_sync(kFull, (s & 3) == kPrefix);
      const int stop = pre ? __ffs(pre) - 1 : 31;
      unsigned long long v = lane <= stop ? s >> 2 : 0;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
      excl += v;
      if (pre) break;
    }
  }
  if (lane == 0) {
    atomicExch(status + t, ((excl + agg) << 2) | kPrefix);
    if (last) *total = (int)(uint32_t)(excl + agg);
  }
  return excl;
}

// K1 in one pass: ticket t's block scans rows [t*rows, (t+1)*rows) with
// the lane-group body, staging each row's codes (stage_w ints, at least
// every code the row can record below m_cap) in shared memory; warp 0
// finds the block's offset (block_offset); then each group writes its
// row's codes to flat[offset + j], dropping positions >= c_cap, and its
// int16 count (-n-1 on overflow).  flat is -1 filled and scratch
// (scratch[0] the ticket counter, scratch[1 + t] the status words)
// zeroed by the entry point.
template <int G>
__global__ void __launch_bounds__(kRowThreads, kMinBlocks)
match_compact_kernel(
    const int* __restrict__ fp_rows, int nb,
    const int* __restrict__ node_rows, int n_nodes, uint32_t salt,
    const int* __restrict__ tokens, const int* __restrict__ lengths,
    const uint8_t* __restrict__ dollar, int n_rows, int levels,
    int f_width, int m_cap, int stage_w, int c_cap,
    int* __restrict__ flat, int16_t* __restrict__ counts_out,
    int* __restrict__ total, unsigned long long* __restrict__ scratch) {
  extern __shared__ int stage[];
  __shared__ int row_cnt[kRowThreads];
  __shared__ int row_off[kRowThreads];
  __shared__ unsigned long long block_excl;
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = (int)atomicAdd(scratch, 1ull);
  __syncthreads();
  const int t = ticket;
  const int rows = blockDim.x / G;
  const int local = threadIdx.x / G;
  const int gl = threadIdx.x & (G - 1);
  const int row = t * rows + local;
  int* out = stage + local * stage_w;
  int n = 0;
  bool ovf = false;
  if (row < n_rows) {
    const int len = lengths[row] < levels ? lengths[row] : levels;
    bool over;
    const int count = scan_group<G>(
        fp_rows, nb, node_rows, n_nodes, salt, tokens + (size_t)row * levels,
        len, dollar[row] != 0, f_width, m_cap, out, &over);
    n = count < m_cap ? count : m_cap;
    ovf = over || count > m_cap;
  }
  if (gl == 0) row_cnt[local] = n;
  __syncthreads();
  if (threadIdx.x < 32) {
    const unsigned long long excl =
        block_offset(t, rows, row_cnt, row_off, scratch + 1,
                     t == (int)gridDim.x - 1, total);
    if (threadIdx.x == 0) block_excl = excl;
  }
  __syncthreads();
  if (row < n_rows) {
    const unsigned long long base = block_excl + (unsigned)row_off[local];
    for (int j = gl; j < n; j += G) {
      if (base + j < (unsigned long long)c_cap) flat[base + j] = out[j];
    }
    if (gl == 0) counts_out[row] = (int16_t)(ovf ? -n - 1 : n);
  }
}

// K3, decide.  Each thread takes kDecidePer consecutive deliveries: its
// opts rows, client rows and message indices come in as 16 B vector
// loads (a scalar path serves the ragged tail and pointers that are
// not 16 B aligned), the options as one packed word a row
// (match_kernel.pack_opts: the qos, no-local, retain-as-published and
// subscription-id bytes), gathered once a delivery, and each message's
// from row, qos and retain through L1, where a window's few thousand
// messages (6 B each) stay.  (Staging them in shared memory first, one
// copy a block, measured slower: every block then waits for its copy
// before its first decision.)  The index range check is fused in: a
// delivery whose opts row is outside [0, n_opts) or whose message is
// outside [0, n_msgs) reads nothing, gets the byte 0 and sets *err,
// which the entry point zeroed.  The output leaves as one 8 B store a
// thread.  Bound by its bytes: ~13 B a delivery in and out, plus the
// gathered rows.
constexpr int kDecideThreads = 256;
constexpr int kDecidePer = 8;

__global__ void __launch_bounds__(kDecideThreads) decide_kernel(
    const int* __restrict__ oa, int n_opts, const int* __restrict__ opts_rows,
    const int* __restrict__ client_rows, const int* __restrict__ msg_idx,
    const int8_t* __restrict__ m_qos, const uint8_t* __restrict__ m_retain,
    const int* __restrict__ m_from_row, int n_msgs, int n, bool aligned,
    uint8_t* __restrict__ out, int* __restrict__ err) {
  const long long first =
      ((long long)blockIdx.x * kDecideThreads + threadIdx.x) * kDecidePer;
  const int cnt = (int)max(0LL, min((long long)kDecidePer, n - first));
  int o[kDecidePer], c[kDecidePer], mi[kDecidePer];
  if (cnt == kDecidePer && aligned) {
    const int4* vo = reinterpret_cast<const int4*>(opts_rows + first);
    const int4* vc = reinterpret_cast<const int4*>(client_rows + first);
    const int4* vm = reinterpret_cast<const int4*>(msg_idx + first);
#pragma unroll
    for (int k = 0; k < kDecidePer / 4; ++k) {
      const int4 a = vo[k], b = vc[k], d = vm[k];
      o[4 * k] = a.x; o[4 * k + 1] = a.y; o[4 * k + 2] = a.z;
      o[4 * k + 3] = a.w;
      c[4 * k] = b.x; c[4 * k + 1] = b.y; c[4 * k + 2] = b.z;
      c[4 * k + 3] = b.w;
      mi[4 * k] = d.x; mi[4 * k + 1] = d.y; mi[4 * k + 2] = d.z;
      mi[4 * k + 3] = d.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kDecidePer; ++k) {
      const bool in = k < cnt;
      o[k] = in ? opts_rows[first + k] : 0;
      c[k] = in ? client_rows[first + k] : 0;
      mi[k] = in ? msg_idx[first + k] : 0;
    }
  }
  unsigned bad = 0;
  uint32_t word[kDecidePer / 4];
#pragma unroll
  for (int k = 0; k < kDecidePer / 4; ++k) word[k] = 0;
#pragma unroll
  for (int k = 0; k < kDecidePer; ++k) {
    const bool ok = (unsigned)o[k] < (unsigned)n_opts &&
                    (unsigned)mi[k] < (unsigned)n_msgs;
    bad |= (unsigned)(k < cnt && !ok) << k;
    if (!ok || k >= cnt) continue;  // reads nothing, decides 0
    const int w = __ldg(oa + o[k]);
    const int m = mi[k];
    const int mq = m_qos[m];
    const int oq = (int)(int8_t)(w & 0xFF);
    const bool drop = ((w >> 8) & 0xFF) && c[k] == m_from_row[m];
    const bool rt = m_retain[m] && ((w >> 16) & 0xFF);
    const int packed = (mq < oq ? mq : oq) | ((mq > oq ? mq : oq) << 2) |
                       (drop ? 1 << 4 : 0) | (rt ? 1 << 5 : 0) |
                       (((w >> 24) & 0xFF) ? 1 << 6 : 0);
    word[k / 4] |= (uint32_t)(packed & 0xFF) << (8 * (k % 4));
  }
  if (__any_sync(0xffffffffu, bad != 0) && threadIdx.x % 32 == 0) *err = 1;
  if (cnt == kDecidePer && aligned) {
    *reinterpret_cast<uint2*>(out + first) = make_uint2(word[0], word[1]);
  } else {
#pragma unroll
    for (int k = 0; k < kDecidePer; ++k)
      if (k < cnt) out[first + k] = (uint8_t)(word[k / 4] >> (8 * (k % 4)));
  }
}

int blocks_for(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

// Calls fn with std::integral_constant<int, G>, G the group width of
// f_width (the next power of two); -1 for an f_width out of [1, kFMax].
template <class Fn>
int with_group(int f_width, Fn&& fn) {
  if (f_width < 1 || f_width > kFMax) return (int)cudaErrorInvalidValue;
  if (f_width == 1) return fn(std::integral_constant<int, 1>{});
  if (f_width == 2) return fn(std::integral_constant<int, 2>{});
  if (f_width <= 4) return fn(std::integral_constant<int, 4>{});
  if (f_width <= 8) return fn(std::integral_constant<int, 8>{});
  return fn(std::integral_constant<int, 16>{});
}

int group_width(int f_width) {
  return with_group(f_width, [](auto g) { return decltype(g)::value; });
}

// K1's block shape: as many rows as kRowThreads lanes hold, fewer (down
// to one warp) while the staged codes pass the default 48 KB of shared
// memory.  A row stages min(m_cap, 1 + (levels + 1) * f_width) codes: a
// row records at most F '#' hits a level, F exact hits and the root '#'.
struct CompactShape {
  int threads, rows, stage_w;
  size_t smem;
};

CompactShape compact_shape(int levels, int f_width, int m_cap) {
  const int g = group_width(f_width);
  const long long most = 1 + (long long)(levels + 1) * f_width;
  CompactShape c;
  c.stage_w = (int)(most < m_cap ? most : m_cap);
  c.threads = kRowThreads;
  while (c.threads > 32 &&
         (size_t)(c.threads / g) * c.stage_w * 4 > kSmemDefault)
    c.threads >>= 1;
  c.rows = c.threads / g;
  c.smem = (size_t)c.rows * c.stage_w * 4;
  return c;
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
  return with_group(f_width, [&](auto g) {
    constexpr int G = decltype(g)::value;
    match_rows_kernel<G><<<blocks_for((long long)n_rows * G, kRowThreads),
                           kRowThreads, 0, (cudaStream_t)stream>>>(
        fp_rows, nb, node_rows, n_nodes, salt, tokens, lengths, dollar,
        n_rows, levels, f_width, m_cap, codes, counts, ovf);
    return (int)cudaGetLastError();
  });
}

int emqx_sharded_match_rows(const int* fp_rows, int nb,
                            const int* node_rows, int n_nodes,
                            const uint32_t* salts, int n_shards,
                            const int* tokens, const int* lengths,
                            const uint8_t* dollar, int n_rows, int levels,
                            int f_width, int m_cap, int* codes, int* counts,
                            uint8_t* ovf, int* total, void* stream) {
  if (n_shards < 1 || n_shards > 65535) return (int)cudaErrorInvalidValue;
  return with_group(f_width, [&](auto g) {
    constexpr int G = decltype(g)::value;
    dim3 grid(blocks_for((long long)n_rows * G, kRowThreads), n_shards);
    sharded_match_rows_kernel<G><<<grid, kRowThreads, 0,
                                   (cudaStream_t)stream>>>(
        fp_rows, nb, node_rows, n_nodes, salts, tokens, lengths, dollar,
        n_rows, levels, f_width, m_cap, codes, counts, ovf, total);
    return (int)cudaGetLastError();
  });
}

// The int64 words of K1's look-back scratch for this batch (the ticket
// counter and one status word per block), or -1 when the widths are out
// of range or a block's staged codes do not fit shared memory.
long long emqx_match_compact_scratch(int n_rows, int levels, int f_width,
                                     int m_cap) {
  if (f_width < 1 || f_width > kFMax || n_rows < 1 || levels < 1 ||
      m_cap < 1)
    return -1;
  const CompactShape c = compact_shape(levels, f_width, m_cap);
  if (c.smem > kSmemMax) return -1;
  return 1 + blocks_for(n_rows, c.rows);
}

int emqx_match_compact(const int* fp_rows, int nb, const int* node_rows,
                       int n_nodes, unsigned int salt, const int* tokens,
                       const int* lengths, const uint8_t* dollar, int n_rows,
                       int levels, int f_width, int m_cap, int c_cap,
                       int* flat, int16_t* counts_out, int* total,
                       unsigned long long* scratch, long long scratch_words,
                       void* stream) {
  const long long words =
      emqx_match_compact_scratch(n_rows, levels, f_width, m_cap);
  if (words < 0 || scratch_words < words || c_cap < 1)
    return (int)cudaErrorInvalidValue;
  const CompactShape c = compact_shape(levels, f_width, m_cap);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(flat, 0xFF, (size_t)c_cap * 4, s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(scratch, 0, (size_t)words * 8, s);
  if (err != cudaSuccess) return (int)err;
  return with_group(f_width, [&](auto g) {
    constexpr int G = decltype(g)::value;
    if (c.smem > kSmemDefault) {
      const cudaError_t e = cudaFuncSetAttribute(
          match_compact_kernel<G>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
      if (e != cudaSuccess) return (int)e;
    }
    match_compact_kernel<G><<<(int)(words - 1), c.threads, c.smem, s>>>(
        fp_rows, nb, node_rows, n_nodes, salt, tokens, lengths, dollar,
        n_rows, levels, f_width, m_cap, c.stage_w, c_cap, flat, counts_out,
        total, scratch);
    return (int)cudaGetLastError();
  });
}

int emqx_decide(const int* oa, int n_opts, const int* opts_rows,
                const int* client_rows, const int* msg_idx,
                const int8_t* m_qos, const uint8_t* m_retain,
                const int* m_from_row, int n_msgs, int n, uint8_t* out,
                int* err, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(err, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return (int)cudaSuccess;
  if (n_opts < 1 || n_msgs < 1) return (int)cudaErrorInvalidValue;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(opts_rows) |
        reinterpret_cast<uintptr_t>(client_rows) |
        reinterpret_cast<uintptr_t>(msg_idx) |
        reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long threads = (n + kDecidePer - 1) / kDecidePer;
  decide_kernel<<<blocks_for(threads, kDecideThreads), kDecideThreads, 0,
                  s>>>(oa, n_opts, opts_rows, client_rows, msg_idx, m_qos,
                       m_retain, m_from_row, n_msgs, n, aligned, out, err);
  return (int)cudaGetLastError();
}

}  // extern "C"
