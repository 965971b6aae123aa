// Hand-written Hopper (sm_90a) kernel for one rule's WHERE predicate
// over a batch of messages: the register program that rules/
// predicate.py lower_predicate flattens a PredicateProgram's tree into,
// run over the rule's var columns (the n:/s:/e: lanes of
// PredicateProgram.extract_columns), giving one pass bit per message.
// Plain C entry point, bound with ctypes by emqx_tpu_torch/ops/
// _kernels.py; the launch goes on the caller's stream and the entry
// point returns cudaGetLastError().
//
// Replaces (JAX package, compiled by XLA for the TPU):
//   predicate_eval_kernel   emqx_tpu/rules/predicate.py:106-121
//                           PredicateProgram.eval_batch(use_jax=True):
//                           the jit of _eval / _eval_cmp /
//                           _num_eval_pair with xp=jnp
//
// Everything is float64.  The TPU computes in float32, so the JAX
// package sends a batch to its numpy path (float64) whenever a value
// or literal does not round-trip through float32 or the WHERE has
// arithmetic (_f32_safe).  This kernel equals the numpy path bit for
// bit on every input, and so equals the float32 path wherever that
// runs.  For that:
//   - arithmetic uses the _rn intrinsics, which the compiler never
//     contracts into an fma (numpy rounds ta - q*safe and a*b + c
//     twice);
//   - division is IEEE (never build with --use_fast_math);
//   - a NaN lane is undefined, and every comparison with NaN is false
//     (an ordering's F lane is defined & !(a > b), not a <= b).
//
// What bounds it.  Per message the kernel reads 8 B of num, 4 B of sid
// and 1 B of err for each lane the program names, and writes one byte;
// the few float64 operations per step are far below the card's rate,
// so its bound is bytes, and one rule over a 4,096-message window is a
// few tens of kilobytes: the launch itself is most of its time.  What a
// step costs around its few operations decides the rest, so the design
// takes out what the first port spent there:
//
//   - No local memory.  The program is the same for every thread of the
//     launch, so every register index is uniform.  The numeric registers
//     are kSlots doubles a message, read and written through select
//     chains on the index; the boolean (T, F) registers and the numeric
//     defined flags are bits of three 32-bit words a message.  No array
//     is indexed at run time, so ptxas keeps no stack frame.  The
//     kernel is a template on kSlots (2, 4, 8, 16): the wrapper runs the
//     smallest instance that holds the numeric registers the program
//     names (state.py predicate_program_from_code counts them).
//   - No clamps.  state.py predicate_program_from_code checks every
//     opcode, register, var lane and literal index on upload, so a
//     step's operands are used as they are.
//   - Each lane runs kPer messages (lane + 32 v of its warp's slice):
//     with more than one, a step's record read, decode and uniform
//     branches are paid once for kPer messages.
//   - A block stages the program in shared memory kChunk steps at a
//     time (a long IN list does not bound it), and resolves there, once
//     a step for the block, what each thread would otherwise compute:
//     the 64-bit offset of each var lane the step reads and the id of
//     its string literal.  A message's own index is computed once.
//
// kPer = 1 and kThreads = 32 won a sweep of 1, 2 and 4 messages a lane
// and 32, 64 and 128 threads a block on the H100 at 4,096 messages (one
// warp a block spreads a window over the most SMs); at 262,144 messages
// 4 a lane ran faster.  tools/k6_sweep.py rebuilds this file with
// -DK6_PER and -DK6_THREADS; PERF.md has its numbers.

#include <cstdint>
#include <cuda_runtime.h>

#ifndef K6_PER
#define K6_PER 1
#endif
#ifndef K6_THREADS
#define K6_THREADS 32
#endif

namespace {

constexpr int kRegs = 16;  // rules/predicate.py PRED_REGS
constexpr int kChunk = 128;  // program steps staged per pass
constexpr int kPer = K6_PER;  // messages a lane runs
constexpr int kThreads = K6_THREADS;
constexpr int kTile = kThreads * kPer;  // messages a block runs
static_assert(kThreads % 32 == 0 && kPer >= 1, "whole warps");

// opcodes: rules/predicate.py P_* (tests/test_torch_predicate.py
// checks that the two lists agree)
enum : int {
  P_NLOAD = 1,
  P_NLIT = 2,
  P_NNEG = 3,
  P_NADD = 4,
  P_NSUB = 5,
  P_NMUL = 6,
  P_NDIV = 7,
  P_NIDV = 8,
  P_NMOD = 9,
  P_BLIT = 10,
  P_BNOT = 11,
  P_BAND = 12,
  P_BOR = 13,
  P_CGT = 14,
  P_CLT = 15,
  P_CGE = 16,
  P_CLE = 17,
  P_EQN = 18,
  P_EQS = 19,
};

// A step as the block runs it.  The upload's record is eight int32:
// op, dst, a, b, c, d, flags, unused (rules/predicate.py
// PredicateCode.steps), with the float64 literal in a row beside it.
struct Rec {
  int op, dst, a, b;  // a, b: registers (P_BLIT: a is the value)
  int flags, c, d, lid;  // c, d >= 0: P_EQN's var lanes; lid: P_EQS's id
  long long oa, oc, od;  // element offsets of var lanes a, c and d
  double lit;
};

__device__ __forceinline__ bool bit(unsigned w, int i) {
  return (w >> i) & 1u;
}

__device__ __forceinline__ unsigned with_bit(unsigned w, int i, bool b) {
  return (w & ~(1u << i)) | ((unsigned)b << i);
}

// register i of a message's numeric file (i is warp-uniform and inside
// the file: the upload checks registers, the wrapper picks kSlots)
template <int kSlots>
__device__ __forceinline__ double pick(const double (&x)[kSlots], int i) {
  double r = x[0];
#pragma unroll
  for (int k = 1; k < kSlots; ++k) r = i == k ? x[k] : r;
  return r;
}

template <int kSlots>
__device__ __forceinline__ void place(double (&x)[kSlots], int i, double v) {
#pragma unroll
  for (int k = 0; k < kSlots; ++k) x[k] = i == k ? v : x[k];
}

template <int kSlots>
__global__ void __launch_bounds__(kThreads) predicate_eval_kernel(
    const int* __restrict__ prog, const double* __restrict__ lit,
    int n_steps, int result, const double* __restrict__ num,
    const int* __restrict__ sid, const uint8_t* __restrict__ err,
    const int* __restrict__ lit_ids, int w_n, uint8_t* __restrict__ out) {
  __shared__ Rec s_rec[kChunk];
  // this lane's messages; a lane past the batch runs on the last
  // message (so every load stays inside the lanes) and stores nothing
  const long long first = (long long)blockIdx.x * kTile +
                          (threadIdx.x / 32) * 32 * kPer + threadIdx.x % 32;
  int m[kPer];
#pragma unroll
  for (int v = 0; v < kPer; ++v)
    m[v] = (int)min(first + 32 * v, (long long)w_n - 1);

  double nv[kPer][kSlots];
  unsigned nd[kPer], bt[kPer], bf[kPer];  // defined, T and F bits
#pragma unroll
  for (int v = 0; v < kPer; ++v) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) nv[v][k] = 0.0;
    nd[v] = bt[v] = bf[v] = 0;
  }

  for (int base = 0; base < n_steps; base += kChunk) {
    const int n = min(n_steps - base, kChunk);
    if (base) __syncthreads();  // the previous chunk is no longer read
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const int* q = prog + 8LL * (base + t);
      Rec r;
      r.op = q[0];
      r.dst = q[1];
      r.a = q[2];
      r.b = q[3];
      r.c = q[4];
      r.d = q[5];
      r.flags = q[6];
      const bool lane_a = r.op == P_NLOAD || r.op == P_EQS;
      r.oa = lane_a ? (long long)r.a * w_n : 0;
      r.oc = r.c >= 0 ? (long long)r.c * w_n : 0;
      r.od = r.d >= 0 ? (long long)r.d * w_n : 0;
      r.lid = r.op == P_EQS ? lit_ids[r.b] : 0;
      r.lit = lit[base + t];
      s_rec[t] = r;
    }
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      const Rec& r = s_rec[s];
      const int op = r.op, dst = r.dst;
      switch (op) {
        case P_NLOAD: {
          const double* col = num + r.oa;
#pragma unroll
          for (int v = 0; v < kPer; ++v) {
            const double x = col[m[v]];
            place(nv[v], dst, x);
            nd[v] = with_bit(nd[v], dst, !isnan(x));
          }
          break;
        }
        case P_NLIT: {
          const double x = r.lit;
#pragma unroll
          for (int v = 0; v < kPer; ++v) {
            place(nv[v], dst, x);
            nd[v] = with_bit(nd[v], dst, true);
          }
          break;
        }
        case P_NNEG: {
          const int a = r.a;
#pragma unroll
          for (int v = 0; v < kPer; ++v) {
            place(nv[v], dst, -pick(nv[v], a));
            nd[v] = with_bit(nd[v], dst, bit(nd[v], a));
          }
          break;
        }
        case P_NADD:
        case P_NSUB:
        case P_NMUL:
        case P_NDIV:
        case P_NIDV:
        case P_NMOD: {
          const int a = r.a, b = r.b;
#pragma unroll
          for (int v = 0; v < kPer; ++v) {
            const double lv = pick(nv[v], a), rv = pick(nv[v], b);
            bool d = bit(nd[v], a) && bit(nd[v], b);
            double x;
            if (op == P_NADD) {
              x = __dadd_rn(lv, rv);
            } else if (op == P_NSUB) {
              x = __dsub_rn(lv, rv);
            } else if (op == P_NMUL) {
              x = __dmul_rn(lv, rv);
            } else if (op == P_NDIV) {
              const bool ok = rv != 0.0;  // NaN != 0: divides
              x = ok ? __ddiv_rn(lv, rv) : 0.0;
              d = d && ok;
            } else {
              // div / mod: truncate both, then floor-divide
              const double ta = trunc(lv);
              const double tb = trunc(rv);
              const bool ok = tb != 0.0;
              const double safe = ok ? tb : 1.0;
              const double q = floor(__ddiv_rn(ta, safe));
              x = op == P_NIDV ? q : __dsub_rn(ta, __dmul_rn(q, safe));
              d = d && ok;
            }
            place(nv[v], dst, x);
            nd[v] = with_bit(nd[v], dst, d);
          }
          break;
        }
        case P_BLIT: {
          const bool t = r.a == 1;
#pragma unroll
          for (int v = 0; v < kPer; ++v) {
            bt[v] = with_bit(bt[v], dst, t);
            bf[v] = with_bit(bf[v], dst, !t);
          }
          break;
        }
        case P_BNOT: {
          const int a = r.a;
#pragma unroll
          for (int v = 0; v < kPer; ++v) {
            const bool t = bit(bf[v], a), f = bit(bt[v], a);
            bt[v] = with_bit(bt[v], dst, t);
            bf[v] = with_bit(bf[v], dst, f);
          }
          break;
        }
        case P_BAND:
        case P_BOR: {
          const int a = r.a, b = r.b;
#pragma unroll
          for (int v = 0; v < kPer; ++v) {
            const bool tl = bit(bt[v], a), fl = bit(bf[v], a);
            const bool tr = bit(bt[v], b), fr = bit(bf[v], b);
            const bool t = op == P_BAND ? tl && tr : tl || (fl && tr);
            const bool f = op == P_BAND ? fl || (tl && fr) : fl && fr;
            bt[v] = with_bit(bt[v], dst, t);
            bf[v] = with_bit(bf[v], dst, f);
          }
          break;
        }
        case P_CGT:
        case P_CLT:
        case P_CGE:
        case P_CLE: {
          const int a = r.a, b = r.b;
#pragma unroll
          for (int v = 0; v < kPer; ++v) {
            const bool d = bit(nd[v], a) && bit(nd[v], b);
            const double lv = pick(nv[v], a), rv = pick(nv[v], b);
            const bool c = op == P_CGT   ? lv > rv
                           : op == P_CLT ? lv < rv
                           : op == P_CGE ? lv >= rv
                                         : lv <= rv;
            bt[v] = with_bit(bt[v], dst, d && c);
            bf[v] = with_bit(bf[v], dst, d && !c);
          }
          break;
        }
        case P_EQN: {
          // numeric equality: total over simple sides (a lookup error
          // on a var side poisons both polarities), a compound side
          // brings its definedness into the F lane; var = var also
          // matches on the id lanes
          const int a = r.a, b = r.b, fl = r.flags;
          const bool hc = r.c >= 0, hd = r.d >= 0;
#pragma unroll
          for (int v = 0; v < kPer; ++v) {
            const bool ld = bit(nd[v], a), rd = bit(nd[v], b);
            bool e = ld && rd && pick(nv[v], a) == pick(nv[v], b);
            bool ok = true;
            if (hc) ok = ok && err[r.oc + m[v]] == 0;
            if (hd) ok = ok && err[r.od + m[v]] == 0;
            if (hc && hd) {
              const int li = sid[r.oc + m[v]];
              e = e || (li >= 0 && li == sid[r.od + m[v]]);
            }
            const bool cd = ((fl & 2) ? ld : true) && ((fl & 4) ? rd : true);
            const bool t = e && ok, f = cd && !e && ok;
            const bool neg = fl & 1;
            bt[v] = with_bit(bt[v], dst, neg ? f : t);
            bf[v] = with_bit(bf[v], dst, neg ? t : f);
          }
          break;
        }
        case P_EQS: {
          // string-literal equality on a var's id lane: -2 (literal
          // absent from the batch) equals no id, -1 (not a string)
          // included
          const int lid = r.lid;
          const bool neg = r.flags & 1;
#pragma unroll
          for (int v = 0; v < kPer; ++v) {
            const bool ok = err[r.oa + m[v]] == 0;
            const int x = sid[r.oa + m[v]];
            const bool t = ok && x == lid, f = ok && x != lid;
            bt[v] = with_bit(bt[v], dst, neg ? f : t);
            bf[v] = with_bit(bf[v], dst, neg ? t : f);
          }
          break;
        }
        default:  // the upload admits no other opcode
          break;
      }
    }
  }
#pragma unroll
  for (int v = 0; v < kPer; ++v)
    if (first + 32 * v < w_n) out[m[v]] = bit(bt[v], result);
}

template <int kSlots>
int launch(const int* prog, const double* lit, int n_steps, int result,
           const double* num, const int* sid, const uint8_t* err,
           const int* lit_ids, int w_n, uint8_t* out, cudaStream_t s) {
  const int blocks = (int)(((long long)w_n + kTile - 1) / kTile);
  predicate_eval_kernel<kSlots><<<blocks, kThreads, 0, s>>>(
      prog, lit, n_steps, result, num, sid, err, lit_ids, w_n, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// prog [n_steps, 8] int32 and lit [n_steps] float64: a program that
// state.py predicate_program_from_code has checked; num / sid / err
// [n_vars, w_n]; slots: the numeric registers the program names (the
// instance run is the smallest of 2, 4, 8 and 16 that holds them).
int emqx_predicate_eval(const int* prog, const double* lit, int n_steps,
                        int result, const double* num, const int* sid,
                        const uint8_t* err, int n_vars, const int* lit_ids,
                        int n_lits, int w_n, int slots, uint8_t* out,
                        void* stream) {
  if (n_steps < 1 || n_vars < 1 || n_lits < 0 || w_n < 0 || result < 0 ||
      result >= kRegs || slots < 0 || slots > kRegs)
    return (int)cudaErrorInvalidValue;
  if (w_n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (slots <= 2)
    return launch<2>(prog, lit, n_steps, result, num, sid, err, lit_ids, w_n,
                     out, s);
  if (slots <= 4)
    return launch<4>(prog, lit, n_steps, result, num, sid, err, lit_ids, w_n,
                     out, s);
  if (slots <= 8)
    return launch<8>(prog, lit, n_steps, result, num, sid, err, lit_ids, w_n,
                     out, s);
  return launch<16>(prog, lit, n_steps, result, num, sid, err, lit_ids, w_n,
                    out, s);
}

}  // extern "C"
