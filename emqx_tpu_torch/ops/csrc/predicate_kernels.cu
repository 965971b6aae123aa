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
// Design.  XLA fuses the traced tree into one elementwise pass over the
// batch.  Here one thread runs one message through the whole program.
// The program is the same for every thread, so the switch on the
// opcode never diverges within a warp.  The block stages the program
// in shared memory kChunk steps at a time (a long IN list does not
// bound it); each thread keeps its registers in a small local array
// of doubles and flag bytes.  The lowering allocates registers in
// Sethi-Ullman order, so a tree of n nodes needs about log2(n) of
// them and kRegs bounds nothing a WHERE clause can spell.
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
// few tens of kilobytes: a launch-bound kernel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRegs = 16;        // rules/predicate.py PRED_REGS
constexpr int kChunk = 256;      // program steps staged per pass
constexpr int kThreads = 128;

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

// a step: op, dst, a, b, c, d, flags, unused (rules/predicate.py
// PredicateCode.steps); the numeric literal is a separate float64 row
struct Step {
  int op, dst, a, b, c, d, flags, pad;
};

// register flag bits: numeric registers use kDef, boolean registers the
// (T, F) short-circuit pair
constexpr uint8_t kDef = 1;
constexpr uint8_t kTrue = 2;
constexpr uint8_t kFalse = 4;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ uint8_t tf(bool t, bool f) {
  return (t ? kTrue : 0) | (f ? kFalse : 0);
}

__device__ __forceinline__ uint8_t tf_neg(bool t, bool f, bool neg) {
  return neg ? tf(f, t) : tf(t, f);
}

__global__ void __launch_bounds__(kThreads) predicate_eval_kernel(
    const Step* __restrict__ prog, const double* __restrict__ lit,
    int n_steps, int result, const double* __restrict__ num,
    const int* __restrict__ sid, const uint8_t* __restrict__ err,
    int n_vars, const int* __restrict__ lit_ids, int n_lits, int w_n,
    uint8_t* __restrict__ out) {
  __shared__ Step s_prog[kChunk];
  __shared__ double s_lit[kChunk];
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = w < w_n;
  const int hv = n_vars - 1;
  double nv[kRegs];
  uint8_t fl[kRegs];
  for (int r = 0; r < kRegs; ++r) {
    nv[r] = 0.0;
    fl[r] = 0;
  }
  // lane of var v for this message (var indices clamp; a valid program
  // is in range by construction)
  auto at = [&](int v) -> long long {
    return (long long)clampi(v, 0, hv) * w_n + w;
  };
  for (int base = 0; base < n_steps; base += kChunk) {
    const int n = n_steps - base < kChunk ? n_steps - base : kChunk;
    __syncthreads();  // the previous chunk is no longer read
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      s_prog[t] = prog[base + t];
      s_lit[t] = lit[base + t];
    }
    __syncthreads();
    if (!live) continue;
    for (int s = 0; s < n; ++s) {
      const Step st = s_prog[s];
      const int dst = clampi(st.dst, 0, kRegs - 1);
      const int a = clampi(st.a, 0, kRegs - 1);
      const int b = clampi(st.b, 0, kRegs - 1);
      switch (st.op) {
        case P_NLOAD: {
          const double v = num[at(st.a)];
          nv[dst] = v;
          fl[dst] = isnan(v) ? 0 : kDef;
          break;
        }
        case P_NLIT:
          nv[dst] = s_lit[s];
          fl[dst] = kDef;
          break;
        case P_NNEG:
          nv[dst] = -nv[a];
          fl[dst] = fl[a] & kDef;
          break;
        case P_NADD:
        case P_NSUB:
        case P_NMUL:
        case P_NDIV:
        case P_NIDV:
        case P_NMOD: {
          const double lv = nv[a];
          const double rv = nv[b];
          bool d = (fl[a] & fl[b] & kDef) != 0;
          double v;
          if (st.op == P_NADD) {
            v = __dadd_rn(lv, rv);
          } else if (st.op == P_NSUB) {
            v = __dsub_rn(lv, rv);
          } else if (st.op == P_NMUL) {
            v = __dmul_rn(lv, rv);
          } else if (st.op == P_NDIV) {
            const bool ok = rv != 0.0;  // NaN != 0: divides
            v = ok ? __ddiv_rn(lv, rv) : 0.0;
            d = d && ok;
          } else {
            // div / mod: truncate both, then floor-divide
            const double ta = trunc(lv);
            const double tb = trunc(rv);
            const bool ok = tb != 0.0;
            const double safe = ok ? tb : 1.0;
            const double q = floor(__ddiv_rn(ta, safe));
            v = st.op == P_NIDV ? q : __dsub_rn(ta, __dmul_rn(q, safe));
            d = d && ok;
          }
          nv[dst] = v;
          fl[dst] = d ? kDef : 0;
          break;
        }
        case P_BLIT:
          fl[dst] = tf(st.a == 1, st.a != 1);
          break;
        case P_BNOT: {
          const uint8_t x = fl[a];
          fl[dst] = tf((x & kFalse) != 0, (x & kTrue) != 0);
          break;
        }
        case P_BAND:
        case P_BOR: {
          const uint8_t x = fl[a];
          const uint8_t y = fl[b];
          const bool tl = x & kTrue, fl_ = x & kFalse;
          const bool tr = y & kTrue, fr = y & kFalse;
          fl[dst] = st.op == P_BAND ? tf(tl && tr, fl_ || (tl && fr))
                                    : tf(tl || (fl_ && tr), fl_ && fr);
          break;
        }
        case P_CGT:
        case P_CLT:
        case P_CGE:
        case P_CLE: {
          const bool d = (fl[a] & fl[b] & kDef) != 0;
          const double lv = nv[a], rv = nv[b];
          const bool c = st.op == P_CGT   ? lv > rv
                         : st.op == P_CLT ? lv < rv
                         : st.op == P_CGE ? lv >= rv
                                          : lv <= rv;
          fl[dst] = tf(d && c, d && !c);
          break;
        }
        case P_EQN: {
          // numeric equality: total over simple sides (a lookup error
          // on a var side poisons both polarities), a compound side
          // brings its definedness into the F lane; var = var also
          // matches on the id lanes
          const bool ld = fl[a] & kDef;
          const bool rd = fl[b] & kDef;
          bool e = ld && rd && nv[a] == nv[b];
          bool ok = true;
          if (st.c >= 0) ok = ok && err[at(st.c)] == 0;
          if (st.d >= 0) ok = ok && err[at(st.d)] == 0;
          if (st.c >= 0 && st.d >= 0) {
            const int li = sid[at(st.c)];
            e = e || (li >= 0 && li == sid[at(st.d)]);
          }
          const bool cd = ((st.flags & 2) ? ld : true) &&
                          ((st.flags & 4) ? rd : true);
          fl[dst] = tf_neg(e && ok, cd && !e && ok, (st.flags & 1) != 0);
          break;
        }
        case P_EQS: {
          // string-literal equality on a var's id lane: -2 (literal
          // absent from the batch) equals no id, -1 (not a string)
          // included
          const int lid = n_lits > 0 ? lit_ids[clampi(st.b, 0, n_lits - 1)]
                                     : -2;
          const bool ok = err[at(st.a)] == 0;
          const int v = sid[at(st.a)];
          fl[dst] = tf_neg(ok && v == lid, ok && v != lid,
                           (st.flags & 1) != 0);
          break;
        }
        default:  // unknown opcodes leave the register as it was
          break;
      }
    }
  }
  if (live) out[w] = (fl[clampi(result, 0, kRegs - 1)] & kTrue) ? 1 : 0;
}

}  // namespace

extern "C" {

int emqx_predicate_eval(const void* prog, const double* lit, int n_steps,
                        int result, const double* num, const int* sid,
                        const uint8_t* err, int n_vars, const int* lit_ids,
                        int n_lits, int w_n, uint8_t* out, void* stream) {
  if (n_steps < 1 || n_vars < 1) return (int)cudaErrorInvalidValue;
  if (w_n == 0) return (int)cudaSuccess;
  const int blocks = (w_n + kThreads - 1) / kThreads;
  predicate_eval_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const Step*>(prog), lit, n_steps, result, num, sid, err,
      n_vars, lit_ids, n_lits, w_n, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
