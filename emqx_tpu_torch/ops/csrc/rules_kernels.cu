// Hand-written Hopper (sm_90a) kernel for the rule engine's WHERE
// matrix: every rule's WHERE program, lowered once per rules rev
// (state.py rules_lowered_from_reference), run over one window's column
// planes (rules/columns.py WindowColumns), giving the [R, W] pass
// matrix.  Plain C entry point, bound with ctypes by emqx_tpu_torch/ops/
// _kernels.py; the launch goes on the caller's stream and the entry
// point returns cudaGetLastError().
//
// Replaces (JAX package, compiled by XLA for the TPU):
//   rules_eval_kernel   emqx_tpu/ops/match_kernel.py:502 rules_eval_batch
//
// The TPU kernel computes all 22 opcodes masked over the whole [R, W]
// plane at every step and selects, in float32.  Everything here is
// float64.  The TPU has no float64, so the JAX engine sends arithmetic
// programs and float32-lossy values to its float64 numpy twin
// (rules_eval_host).  The H100 has native float64: this kernel equals
// that twin bit for bit on every window, so every rules window runs
// here.  For that:
//   - arithmetic uses the _rn intrinsics, which the compiler never
//     contracts into an fma (numpy rounds ta - q*safe twice);
//   - division is IEEE (never build with --use_fast_math);
//   - a NaN lane is undefined, and every comparison with NaN is false.
//
// What bounds it on this card.  Per cell (rule, message) the work is a
// few instructions a step: the output (one byte a cell, 41 MB at 10,000
// rules x 4,096 messages) needs ~12 us of HBM, and the program's float64
// and int32 operations less.  What a step costs around those few
// instructions is what decides the time: an interpreter that keeps its
// register file in local memory, clears it per thread, clamps every
// operand and recomputes 64-bit plane addresses spends ~one SM clock a
// step a message on that alone.  The design takes each of those out:
//
//   - The program is lowered on the host once per rules rev: only the
//     steps the result depends on, in Sethi-Ullman order, renamed onto
//     kNumSlots numeric registers and 32 boolean ones (29..31 are the
//     constants clear, true and false); plane loads and literals are
//     operands, not steps; register operands are checked there, so the
//     kernel clamps none of them.  No program predicate.build_stack
//     makes needs more than 5 numeric registers (its programs are trees
//     of at most 48 steps); the boolean file holds the widest live set
//     any 48-step program can reach (24).
//   - The numeric registers are kNumSlots doubles in registers, read
//     and written through select chains on the step's slot index; the
//     boolean registers are two 32-bit words (T and F bits), read and
//     written with shifts.  The slot index is warp-uniform (a warp runs
//     one rule), so nothing diverges, and no array is indexed at run
//     time: ptxas keeps no stack frame.
//   - Each lane runs its warp's rule over kPer = 4 messages at once, so
//     a step's record fetch, decode and uniform branches are paid once
//     for 4 messages, and the 4 messages' operations are independent
//     instructions in flight together.  (One message a lane spent ~150
//     SM issue slots a warp-step on the H100, mostly waiting on that
//     chain; PERF.md has the numbers.)
//   - A block stages its message slice's planes (kTile = 128 messages)
//     in shared memory once, with its rules' step records beside them;
//     its 8 warps then run its rules over that tile, each warp one rule
//     over all 128 messages, so the planes come from L2 once per block.
//     Tile offsets are 32-bit; a plane index clamps into [0, P).
//     Windows with more planes than the tile budget, or with P x W past
//     INT_MAX, read the planes from global memory through L1 (the
//     kStaged = false instance, whose plane offsets are 64-bit).
//   - A warp gathers its 128 results with 4 ballots, and each lane
//     writes the bytes of 4 consecutive messages as one 4 B word: one
//     coalesced 128 B segment of the output row (bytes when W is not a
//     multiple of 4, at the window's ragged end).
//
// Grid: x = blocks of rules (a rule count past 65,535 fits: gridDim.x is
// 2^31 - 1), y = kTile-message slices of the window; a window of more
// than 65,535 slices (gridDim.y's limit) is walked with a stride of
// gridDim.y, one slice after another in each block.

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxSteps = 48;  // rules/predicate.py MAX_STEPS
constexpr int kNumSlots = 5;   // numeric registers (state.py RULES_NUM_SLOTS)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;  // messages a lane runs a rule over
constexpr int kTile = 32 * kPer;  // messages a block stages
constexpr int kMaxRulesPerBlock = 128;
constexpr size_t kTileBudget = 96 * 1024;  // staged planes, bytes
constexpr size_t kProgBudget = 64 * 1024;  // staged step records, bytes
constexpr size_t kSmemDefault = 48 * 1024;

// opcodes: rules/predicate.py R_* (tests/test_torch_rules_kernel.py
// checks that the two lists agree).  The lowered records use a subset:
// R_CGT carries all four ordered compares (order mask lt 1, eq 2, gt 4
// and kRank in its flags), and R_EQC also carries R_EQVL.
enum : int {
  R_NOP = 0,
  R_NLOAD = 1,
  R_NLIT = 2,
  R_NNEG = 3,
  R_NADD = 4,
  R_NSUB = 5,
  R_NMUL = 6,
  R_NDIV = 7,
  R_NIDV = 8,
  R_NMOD = 9,
  R_BLIT = 10,
  R_BNOT = 11,
  R_BAND = 12,
  R_BOR = 13,
  R_CGT = 14,
  R_CLT = 15,
  R_CGE = 16,
  R_CLE = 17,
  R_EQVV = 18,
  R_EQVL = 19,
  R_EQSL = 20,
  R_EQC = 21,
  R_PRES = 22,
};

// numeric operand kinds (state.py SRC_*), in bits 16.. of an operand
constexpr int kSrcPlane = 1;
constexpr int kSrcLit = 2;
constexpr int kRank = 8;  // R_CGT: compare string ranks of planes p, q
constexpr int kOkPlane = 8;  // R_EQC: the error plane in w3
constexpr unsigned kBoolInit = 1u << 30;  // boolean slot 30: true
constexpr unsigned kBoolInitF = 1u << 31;  // boolean slot 31: false

// A window's planes: staged in shared memory (stride kTile, message m
// local to the block; Off = int) or in global memory (stride W, m the
// message; Off = long long, so P x W may pass INT_MAX).
template <typename Off>
struct Planes {
  const double* num;
  const int* sid;
  const uint8_t* err;
  const uint8_t* prs;
  int stride;
  int top;  // P - 1, at least 0

  __device__ __forceinline__ Off row(unsigned p) const {
    return (Off)min(p, (unsigned)top) * stride;
  }
};

__device__ __forceinline__ bool ordered(int mask, double a, double b) {
  return ((mask & 1) && a < b) || ((mask & 2) && a == b) ||
         ((mask & 4) && a > b);
}

__device__ __forceinline__ bool ordered_i(int mask, int a, int b) {
  return ((mask & 1) && a < b) || ((mask & 2) && a == b) ||
         ((mask & 4) && a > b);
}

// One rule's lowered steps over this lane's kPer messages m[v]
// (messages lane + 32 v of the warp's tile): bit v of the result is set
// when the rule passes on message v.  Every slot index, operand kind
// and opcode is the same for the whole warp, so each step's fetch,
// decode and branches are paid once for kPer messages.
template <typename PL>
__device__ __forceinline__ unsigned run_rule(
    const uint4* __restrict__ st, int n, int res,
    const double* __restrict__ lit, const int* __restrict__ lit_ranks,
    const PL& pl, const int (&m)[kPer]) {
  double nv[kPer][kNumSlots];
  unsigned nd[kPer], bt[kPer], bf[kPer];
#pragma unroll
  for (int v = 0; v < kPer; ++v) {
#pragma unroll
    for (int k = 0; k < kNumSlots; ++k) nv[v][k] = 0.0;
    nd[v] = 0;  // defined bit per numeric slot
    bt[v] = kBoolInit;
    bf[v] = kBoolInitF;
  }

  // numeric operand: a slot (kNumSlots reads clear), a plane, a literal
  auto operand = [&](unsigned desc, double (&x)[kPer], bool (&d)[kPer]) {
    const unsigned kind = desc >> 16, idx = desc & 0xFFFFu;
    if (kind == kSrcPlane) {
      const auto row = pl.row(idx);
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        x[v] = pl.num[row + m[v]];
        d[v] = !isnan(x[v]);
      }
    } else if (kind == kSrcLit) {
      const double l = lit[idx];
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        x[v] = l;
        d[v] = true;
      }
    } else {
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        x[v] = 0.0;
#pragma unroll
        for (int k = 0; k < kNumSlots; ++k)
          x[v] = idx == (unsigned)k ? nv[v][k] : x[v];
        d[v] = (nd[v] >> idx) & 1u;
      }
    }
  };
  auto set_num = [&](unsigned dst, const double (&x)[kPer],
                     const bool (&d)[kPer]) {
#pragma unroll
    for (int v = 0; v < kPer; ++v) {
#pragma unroll
      for (int k = 0; k < kNumSlots; ++k)
        nv[v][k] = dst == (unsigned)k ? x[v] : nv[v][k];
      nd[v] = (nd[v] & ~(1u << dst)) | ((unsigned)d[v] << dst);
    }
  };
  auto set_bool = [&](int v, unsigned dst, bool t, bool f, bool neg) {
    const bool tt = neg ? f : t, ff = neg ? t : f;
    bt[v] = (bt[v] & ~(1u << dst)) | ((unsigned)tt << dst);
    bf[v] = (bf[v] & ~(1u << dst)) | ((unsigned)ff << dst);
  };

  for (int s = 0; s < n; ++s) {
    const uint4 q = st[s];
    const int op = q.x & 0xFF;
    const unsigned dst = (q.x >> 8) & 0xFFu;
    const int fl = q.x >> 16;
    // most frequent first: compares, and / or, equalities
    if (op == R_CGT) {
      double x[kPer], y[kPer];
      bool dx[kPer], dy[kPer];
      operand(q.y, x, dx);
      operand(q.z, y, dy);
      const auto rp = pl.row(q.w & 0xFFFFu), rq = pl.row(q.w >> 16);
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const bool d = dx[v] && dy[v];
        const bool c = ordered(fl, x[v], y[v]);
        bool t = d && c, f = d && !c;
        if (fl & kRank) {
          // both sides bare vars: strings order by per-window rank
          const int sl = pl.sid[rp + m[v]], sr = pl.sid[rq + m[v]];
          if (sl >= 0 && sr >= 0) {
            const bool cs = ordered_i(fl, sl, sr);
            t = t || cs;
            f = f || !cs;
          }
        }
        set_bool(v, dst, t, f, false);
      }
    } else if (op == R_BAND || op == R_BOR) {
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const bool tl = (bt[v] >> q.y) & 1u, fl_ = (bf[v] >> q.y) & 1u;
        const bool tr = (bt[v] >> q.z) & 1u, fr = (bf[v] >> q.z) & 1u;
        if (op == R_BAND)
          set_bool(v, dst, tl && tr, fl_ || (tl && fr), false);
        else
          set_bool(v, dst, tl || (fl_ && tr), fl_ && fr, false);
      }
    } else if (op == R_EQC) {
      double x[kPer], y[kPer];
      bool ld[kPer], rd[kPer];
      operand(q.y, x, ld);
      operand(q.z, y, rd);
      const auto ro = pl.row(q.w);
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const bool e = ld[v] && rd[v] && x[v] == y[v];
        const bool ok = (fl & kOkPlane) ? pl.err[ro + m[v]] == 0 : true;
        const bool cd = ((fl & 2) ? ld[v] : true) && ((fl & 4) ? rd[v] : true);
        set_bool(v, dst, e && ok, cd && !e && ok, fl & 1);
      }
    } else if (op == R_EQSL) {
      const auto rp = pl.row(q.y);
      const int lid = lit_ranks[q.z];
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const bool ok = pl.err[rp + m[v]] == 0;
        const int sv = pl.sid[rp + m[v]];
        set_bool(v, dst, ok && sv == lid, ok && sv != lid, fl & 1);
      }
    } else if (op == R_PRES) {
      const auto rp = pl.row(q.y);
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const bool ok = pl.err[rp + m[v]] == 0, p = pl.prs[rp + m[v]] != 0;
        set_bool(v, dst, ok && p, ok && !p, fl & 1);
      }
    } else if (op == R_EQVV) {
      const auto rp = pl.row(q.y), rq = pl.row(q.z);
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const auto i0 = rp + m[v], i1 = rq + m[v];
        const double lp = pl.num[i0], rv = pl.num[i1];
        const int sl = pl.sid[i0], sr = pl.sid[i1];
        const bool el = pl.err[i0] != 0, er = pl.err[i1] != 0;
        // null = null is TRUE here (lookup ok, nothing there)
        const bool nul = !el && !pl.prs[i0] && !er && !pl.prs[i1];
        const bool e = lp == rv || (sl != -1 && sl == sr) || nul;
        const bool ok = !el && !er;
        set_bool(v, dst, e && ok, !e && ok, fl & 1);
      }
    } else if (op == R_BNOT) {
#pragma unroll
      for (int v = 0; v < kPer; ++v)
        set_bool(v, dst, (bf[v] >> q.y) & 1u, (bt[v] >> q.y) & 1u, false);
    } else if (op == R_NNEG) {
      double x[kPer];
      bool d[kPer];
      operand(q.y, x, d);
#pragma unroll
      for (int v = 0; v < kPer; ++v) x[v] = -x[v];
      set_num(dst, x, d);
    } else {  // R_NADD .. R_NMOD
      double lv[kPer], rv[kPer];
      bool ld[kPer], rd[kPer];
      operand(q.y, lv, ld);
      operand(q.z, rv, rd);
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        bool d = ld[v] && rd[v];
        double r;
        if (op == R_NADD) {
          r = __dadd_rn(lv[v], rv[v]);
        } else if (op == R_NSUB) {
          r = __dsub_rn(lv[v], rv[v]);
        } else if (op == R_NMUL) {
          r = __dmul_rn(lv[v], rv[v]);
        } else if (op == R_NDIV) {
          const bool ok = rv[v] != 0.0;  // NaN != 0: divides
          r = ok ? __ddiv_rn(lv[v], rv[v]) : 0.0;
          d = d && ok;
        } else {
          // div / mod: truncate both, then floor-divide
          const double ta = trunc(lv[v]);
          const double tb = trunc(rv[v]);
          const bool ok = tb != 0.0;
          const double safe = ok ? tb : 1.0;
          const double qq = floor(__ddiv_rn(ta, safe));
          r = op == R_NIDV ? qq : __dsub_rn(ta, __dmul_rn(qq, safe));
          d = d && ok;
        }
        lv[v] = r;
        ld[v] = d;
      }
      set_num(dst, lv, ld);
    }
  }
  unsigned pass = 0;
#pragma unroll
  for (int v = 0; v < kPer; ++v) pass |= ((bt[v] >> res) & 1u) << v;
  return pass;
}

// Two blocks an SM at most 128 registers a thread: without the minimum,
// ptxas capped this kernel at 48 registers and spilled.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 2) rules_eval_kernel(
    const uint4* __restrict__ steps, const double* __restrict__ lits,
    const int* __restrict__ meta, int n_rules, int n_steps, int n_lits,
    int rules_per_block, const int* __restrict__ lit_ranks,
    const double* __restrict__ num, const int* __restrict__ sid,
    const uint8_t* __restrict__ err, const uint8_t* __restrict__ prs,
    int n_planes, int w_n, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r0 = blockIdx.x * rules_per_block;
  const int nr = min(rules_per_block, n_rules - r0);
  const int m0 = blockIdx.y * kTile;
  uint4* s_steps = reinterpret_cast<uint4*>(smem);
  double* s_lits =
      reinterpret_cast<double*>(s_steps + rules_per_block * n_steps);
  int* s_meta = reinterpret_cast<int*>(s_lits + rules_per_block * n_lits);
  // the staging loops are unrolled so that a thread's loads are in
  // flight together, not one L2 round trip after another
  const uint4* g_steps = steps + (long long)r0 * n_steps;
#pragma unroll 4
  for (int i = threadIdx.x; i < nr * n_steps; i += kThreads)
    s_steps[i] = g_steps[i];
  const double* g_lits = lits + (long long)r0 * n_lits;
#pragma unroll 4
  for (int i = threadIdx.x; i < nr * n_lits; i += kThreads)
    s_lits[i] = g_lits[i];
  for (int i = threadIdx.x; i < nr; i += kThreads) s_meta[i] = meta[r0 + i];

  Planes<typename std::conditional<kStaged, int, long long>::type> pl;
  pl.top = max(n_planes, 1) - 1;
  // the tile: num [P][kTile] | sid [P][kTile] | err | prs
  const size_t prog = ((size_t)rules_per_block *
                           (n_steps * sizeof(uint4) + n_lits * 8 + 4) +
                       15) & ~(size_t)15;
  const int tp = pl.top + 1;
  double* t_num = reinterpret_cast<double*>(smem + prog);
  int* t_sid = reinterpret_cast<int*>(t_num + tp * kTile);
  uint8_t* t_err = reinterpret_cast<uint8_t*>(t_sid + tp * kTile);
  uint8_t* t_prs = t_err + tp * kTile;
  if (kStaged) {
    pl.num = t_num;
    pl.sid = t_sid;
    pl.err = t_err;
    pl.prs = t_prs;
    pl.stride = kTile;
  } else {
    pl.num = num;
    pl.sid = sid;
    pl.err = err;
    pl.prs = prs;
    pl.stride = w_n;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slices = (int)(((long long)w_n + kTile - 1) / kTile);
  for (int sl = blockIdx.y; sl < slices; sl += gridDim.y) {
    const long long m0 = (long long)sl * kTile;
    if (kStaged) {
      if (sl != (int)blockIdx.y) __syncthreads();  // the last tile is read
      // messages past the window and an empty plane space read as
      // "lookup ok, nothing there"
#pragma unroll 4
      for (int i = threadIdx.x; i < tp * kTile; i += kThreads) {
        const int p = i / kTile;
        const long long mm = m0 + i % kTile;
        const bool in = n_planes > 0 && mm < w_n;
        const long long g = (long long)p * w_n + mm;
        t_num[i] = in ? num[g] : CUDART_NAN;
        t_sid[i] = in ? sid[g] : -1;
        t_err[i] = in ? err[g] : 0;
        t_prs[i] = in ? prs[g] : 0;
      }
    }
    __syncthreads();  // the tile and the step records are staged

    int m[kPer];  // this lane's messages: lane + 32 v of the tile
#pragma unroll
    for (int v = 0; v < kPer; ++v)
      m[v] = kStaged ? lane + 32 * v
                     : (int)min(m0 + lane + 32 * v, (long long)w_n - 1);
    // lane l stores messages 4l .. 4l+3 of the tile: one 4 B word, so a
    // warp writes its rule's 128 results as one 128 B row segment
    const long long first = m0 + 4 * lane;
    const bool words = (w_n & 3) == 0 && first + 3 < w_n;
    for (int ri = warp; ri < nr; ri += kWarps) {
      const int mt = s_meta[ri];
      const unsigned pass =
          run_rule(s_steps + ri * n_steps, mt & 0xFF, (mt >> 8) & 0xFF,
                   s_lits + ri * n_lits, lit_ranks, pl, m);
      unsigned b[kPer];  // bit j of b[v]: message 32 v + j
#pragma unroll
      for (int v = 0; v < kPer; ++v)
        b[v] = __ballot_sync(0xffffffffu, (pass >> v) & 1u);
      unsigned mine = b[0];
#pragma unroll
      for (int v = 1; v < kPer; ++v) mine = lane / 8 == v ? b[v] : mine;
      const unsigned nib = (mine >> (4 * (lane % 8))) & 0xFu;
      const uint32_t word = (nib & 1u) | ((nib & 2u) << 7) |
                            ((nib & 4u) << 14) | ((nib & 8u) << 21);
      uint8_t* row = out + (long long)(r0 + ri) * w_n;
      if (words) {
        *reinterpret_cast<uint32_t*>(row + first) = word;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (first + i < w_n) row[first + i] = (word >> (8 * i)) & 1u;
      }
    }
  }
}

template <bool kStaged>
int launch(const uint4* steps, const double* lits, const int* meta,
           int n_rules, int n_steps, int n_lits, int rpb, dim3 grid,
           size_t smem, const int* lit_ranks, const double* num,
           const int* sid, const uint8_t* err, const uint8_t* prs,
           int n_planes, int w_n, uint8_t* out, cudaStream_t s) {
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        rules_eval_kernel<kStaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rules_eval_kernel<kStaged><<<grid, kThreads, smem, s>>>(
      steps, lits, meta, n_rules, n_steps, n_lits, rpb, lit_ranks, num, sid,
      err, prs, n_planes, w_n, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// steps [R, n_steps] 16 B records, lits [R, n_lits], meta [R] (step
// count | result slot << 8): ops/rules_lowering.py lower_rules.
int emqx_rules_eval(const void* steps, const double* lits, const int* meta,
                    int n_rules, int n_steps, int n_lits,
                    const int* lit_ranks, const double* num, const int* sid,
                    const uint8_t* err, const uint8_t* prs, int n_planes,
                    int w_n, uint8_t* out, void* stream) {
  if (n_steps < 1 || n_steps > kMaxSteps || n_lits < 1 || n_rules < 0 ||
      w_n < 0 || n_planes < 0 || n_planes > 0x10000)
    return (int)cudaErrorInvalidValue;
  if (n_rules == 0 || w_n == 0) return (int)cudaSuccess;
  const int slices = (int)(((long long)w_n + kTile - 1) / kTile);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // as many rules a block as keep two blocks an SM busy and the step
  // records inside their budget
  const size_t per_rule = (size_t)n_steps * sizeof(uint4) + n_lits * 8 + 4;
  int rpb = kMaxRulesPerBlock;
  while (rpb > kWarps &&
         ((size_t)rpb * per_rule > kProgBudget ||
          (long long)((n_rules + rpb - 1) / rpb) * slices < 2LL * sms))
    rpb >>= 1;
  const size_t prog = ((size_t)rpb * per_rule + 15) & ~(size_t)15;
  const size_t tile = (size_t)(n_planes > 0 ? n_planes : 1) * kTile *
                      (sizeof(double) + sizeof(int) + 2);
  const dim3 grid((n_rules + rpb - 1) / rpb, min(slices, 65535));
  cudaStream_t s = (cudaStream_t)stream;
  const uint4* st = reinterpret_cast<const uint4*>(steps);
  if (tile <= kTileBudget && (long long)n_planes * w_n <= INT_MAX)
    return launch<true>(st, lits, meta, n_rules, n_steps, n_lits, rpb, grid,
                        prog + tile, lit_ranks, num, sid, err, prs, n_planes,
                        w_n, out, s);
  return launch<false>(st, lits, meta, n_rules, n_steps, n_lits, rpb, grid,
                       prog, lit_ranks, num, sid, err, prs, n_planes, w_n,
                       out, s);
}

}  // extern "C"
