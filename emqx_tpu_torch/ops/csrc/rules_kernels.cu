// Hand-written Hopper (sm_90a) kernel for the rule engine's WHERE
// matrix: the stacked register program of every lowered rule
// (rules/predicate.py StackedRules) run over one window's column planes
// (rules/columns.py WindowColumns), giving the [R, W] pass matrix.
// Plain C entry point, bound with ctypes by emqx_tpu_torch/ops/
// _kernels.py; the launch goes on the caller's stream and the entry
// point returns cudaGetLastError().
//
// Replaces (JAX package, compiled by XLA for the TPU):
//   rules_eval_kernel   emqx_tpu/ops/match_kernel.py:502 rules_eval_batch
//
// Design.  The TPU kernel computes all 22 opcodes masked over the
// whole [R, W] plane at every step and selects, in float32.  Here one
// block runs one rule over 128 messages: the opcode at (rule, step) is
// the same for every thread of the block, so the switch below never
// diverges, and steps after the rule's result register are not run.
// The block stages its rule's program row (code, a0..a3, literal) in
// shared memory; each thread keeps the register file of its message
// in local memory: a double and a flag byte (defined, provably true,
// provably false) per step, ~430 B at the 48-step maximum.
//
// Everything is float64.  The TPU has no float64, so the JAX engine
// sends arithmetic programs and float32-lossy values to its float64
// numpy twin (rules_eval_host).  The H100 has native float64: this
// kernel equals that twin bit for bit on every window, so every rules
// window runs here.  For that:
//   - arithmetic uses the _rn intrinsics, which the compiler never
//     contracts into an fma (numpy rounds ta - q*safe twice);
//   - division is IEEE (never build with --use_fast_math);
//   - a NaN lane is undefined, and every comparison with NaN is false.
//
// What bounds it.  Per cell (rule, message) the kernel reads the
// planes each step names (8 B num, 4 B sid, 1 B err/prs) and writes one
// byte; consecutive rules in blockIdx.x share a window slice, so the
// planes come mostly from L2.  At 10,000 rules x 4,096 messages the
// 41 MB output alone needs ~12 us of HBM; the register program is
// ~10 operations per step per cell, against the card's 34 TFLOP/s of
// non-tensor float64.  The local-memory register file costs L1
// traffic; a later version can keep it in registers by bounding S.
//
// Grid: x = rule (gridDim.y is limited to 65,535, the rule count is
// not), y = 128-message slice of the window.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxSteps = 48;  // rules/predicate.py MAX_STEPS
constexpr int kRulesThreads = 128;

// opcodes: rules/predicate.py R_* (tests/test_torch_rules_kernel.py
// checks that the two lists agree)
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

// register flag bits
constexpr uint8_t kDef = 1;   // numeric value defined
constexpr uint8_t kTrue = 2;  // provably true
constexpr uint8_t kFalse = 4; // provably false without error

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Column plane reads.  Operand indices of a valid program are in
// range; out-of-range ones clamp (as the TPU kernel's gathers do) and
// an empty plane space reads as "lookup ok, nothing there".
struct Planes {
  const double* num;
  const int* sid;
  const uint8_t* err;
  const uint8_t* prs;
  int n_planes;
  int w_n;
  int w;

  __device__ __forceinline__ long long at(int p) const {
    return (long long)clampi(p, 0, n_planes - 1) * w_n + w;
  }
  __device__ __forceinline__ double num_at(int p) const {
    return n_planes > 0 ? num[at(p)] : CUDART_NAN;
  }
  __device__ __forceinline__ int sid_at(int p) const {
    return n_planes > 0 ? sid[at(p)] : -1;
  }
  __device__ __forceinline__ bool err_at(int p) const {
    return n_planes > 0 && err[at(p)] != 0;
  }
  __device__ __forceinline__ bool prs_at(int p) const {
    return n_planes > 0 && prs[at(p)] != 0;
  }
};

__device__ __forceinline__ uint8_t tf(bool t, bool f) {
  return (t ? kTrue : 0) | (f ? kFalse : 0);
}

// (t, f) with the pair swapped when negate is set
__device__ __forceinline__ uint8_t tf_neg(bool t, bool f, bool neg) {
  return neg ? tf(f, t) : tf(t, f);
}

__device__ __forceinline__ bool ordered(int op, double a, double b) {
  switch (op) {
    case R_CGT: return a > b;
    case R_CLT: return a < b;
    case R_CGE: return a >= b;
    default: return a <= b;  // R_CLE
  }
}

__device__ __forceinline__ bool ordered_i(int op, int a, int b) {
  switch (op) {
    case R_CGT: return a > b;
    case R_CLT: return a < b;
    case R_CGE: return a >= b;
    default: return a <= b;
  }
}

__global__ void __launch_bounds__(kRulesThreads) rules_eval_kernel(
    const int* __restrict__ code, const int* __restrict__ a0,
    const int* __restrict__ a1, const int* __restrict__ a2,
    const int* __restrict__ a3, const double* __restrict__ litn,
    const int* __restrict__ last, const int* __restrict__ lit_ranks,
    int n_lits, const double* __restrict__ num,
    const int* __restrict__ sid, const uint8_t* __restrict__ err,
    const uint8_t* __restrict__ prs, int n_steps, int n_planes, int w_n,
    uint8_t* __restrict__ out) {
  __shared__ int s_code[kMaxSteps];
  __shared__ int s_a0[kMaxSteps];
  __shared__ int s_a1[kMaxSteps];
  __shared__ int s_a2[kMaxSteps];
  __shared__ int s_a3[kMaxSteps];
  __shared__ double s_lit[kMaxSteps];
  const int r = blockIdx.x;
  const long long row = (long long)r * n_steps;
  for (int s = threadIdx.x; s < n_steps; s += blockDim.x) {
    s_code[s] = code[row + s];
    s_a0[s] = a0[row + s];
    s_a1[s] = a1[row + s];
    s_a2[s] = a2[row + s];
    s_a3[s] = a3[row + s];
    s_lit[s] = litn[row + s];
  }
  __syncthreads();
  const int w = blockIdx.y * blockDim.x + threadIdx.x;
  if (w >= w_n) return;
  const Planes pl{num, sid, err, prs, n_planes, w_n, w};
  const int top = clampi(last[r], 0, n_steps - 1);
  // registers never written read as 0 / all flags clear, as in the
  // plain version's zero-initialised register file
  double nv[kMaxSteps];
  uint8_t fl[kMaxSteps];
  for (int s = 0; s < n_steps; ++s) {
    nv[s] = 0.0;
    fl[s] = 0;
  }
  const int hi = n_steps - 1;
  for (int s = 0; s <= top; ++s) {
    const int op = s_code[s];
    const int i0 = s_a0[s];
    const int i1 = s_a1[s];
    const int i2 = s_a2[s];
    const int i3 = s_a3[s];
    switch (op) {
      case R_NLOAD: {
        const double v = pl.num_at(i0);
        nv[s] = v;
        fl[s] = isnan(v) ? 0 : kDef;
        break;
      }
      case R_NLIT:
        nv[s] = s_lit[s];
        fl[s] = kDef;
        break;
      case R_NNEG: {
        const int l = clampi(i0, 0, hi);
        nv[s] = -nv[l];
        fl[s] = fl[l] & kDef;
        break;
      }
      case R_NADD:
      case R_NSUB:
      case R_NMUL:
      case R_NDIV:
      case R_NIDV:
      case R_NMOD: {
        const int l = clampi(i0, 0, hi);
        const int rr = clampi(i1, 0, hi);
        const double lv = nv[l];
        const double rv = nv[rr];
        bool d = (fl[l] & fl[rr] & kDef) != 0;
        double v;
        if (op == R_NADD) {
          v = __dadd_rn(lv, rv);
        } else if (op == R_NSUB) {
          v = __dsub_rn(lv, rv);
        } else if (op == R_NMUL) {
          v = __dmul_rn(lv, rv);
        } else if (op == R_NDIV) {
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
          v = op == R_NIDV ? q : __dsub_rn(ta, __dmul_rn(q, safe));
          d = d && ok;
        }
        nv[s] = v;
        fl[s] = d ? kDef : 0;
        break;
      }
      case R_BLIT:
        fl[s] = tf(i0 == 1, i0 != 1);
        break;
      case R_BNOT: {
        const uint8_t x = fl[clampi(i0, 0, hi)];
        fl[s] = tf((x & kFalse) != 0, (x & kTrue) != 0);
        break;
      }
      case R_BAND:
      case R_BOR: {
        const uint8_t x = fl[clampi(i0, 0, hi)];
        const uint8_t y = fl[clampi(i1, 0, hi)];
        const bool tl = x & kTrue, fl_ = x & kFalse;
        const bool tr = y & kTrue, fr = y & kFalse;
        fl[s] = op == R_BAND ? tf(tl && tr, fl_ || (tl && fr))
                             : tf(tl || (fl_ && tr), fl_ && fr);
        break;
      }
      case R_CGT:
      case R_CLT:
      case R_CGE:
      case R_CLE: {
        const int l = clampi(i0, 0, hi);
        const int rr = clampi(i1, 0, hi);
        const bool d = (fl[l] & fl[rr] & kDef) != 0;
        const bool c = ordered(op, nv[l], nv[rr]);
        bool t = d && c;
        bool f = d && !c;
        if (i2 >= 0 && i3 >= 0) {
          // both sides bare vars: strings order by per-window rank
          const int sl = pl.sid_at(i2);
          const int sr = pl.sid_at(i3);
          if (sl >= 0 && sr >= 0) {
            const bool cs = ordered_i(op, sl, sr);
            t = t || cs;
            f = f || !cs;
          }
        }
        fl[s] = tf(t, f);
        break;
      }
      case R_EQVV: {
        const double lp = pl.num_at(i0);
        const double rp = pl.num_at(i1);
        const int sl = pl.sid_at(i0);
        const int sr = pl.sid_at(i1);
        const bool el = pl.err_at(i0);
        const bool er = pl.err_at(i1);
        // null = null is TRUE here (lookup ok, nothing there)
        const bool nul = !el && !pl.prs_at(i0) && !er && !pl.prs_at(i1);
        const bool e = (!isnan(lp) && !isnan(rp) && lp == rp) ||
                       (sl != -1 && sl == sr) || nul;
        const bool ok = !el && !er;
        fl[s] = tf_neg(e && ok, !e && ok, i2 == 1);
        break;
      }
      case R_EQVL: {
        const double v = pl.num_at(i0);
        const bool e = !isnan(v) && v == s_lit[s];
        const bool ok = !pl.err_at(i0);
        fl[s] = tf_neg(e && ok, !e && ok, i2 == 1);
        break;
      }
      case R_EQSL: {
        const int lid = n_lits > 0 ? lit_ranks[clampi(i1, 0, n_lits - 1)]
                                   : -1;
        const bool ok = !pl.err_at(i0);
        const int v = pl.sid_at(i0);
        fl[s] = tf_neg(ok && v == lid, ok && v != lid, i2 == 1);
        break;
      }
      case R_EQC: {
        const int l = clampi(i0, 0, hi);
        const int rr = clampi(i1, 0, hi);
        const bool ld = fl[l] & kDef;
        const bool rd = fl[rr] & kDef;
        const bool e = ld && rd && nv[l] == nv[rr];
        const bool ok = i3 >= 0 ? !pl.err_at(i3) : true;
        const bool cd = ((i2 & 2) ? ld : true) && ((i2 & 4) ? rd : true);
        fl[s] = tf_neg(e && ok, cd && !e && ok, (i2 & 1) != 0);
        break;
      }
      case R_PRES: {
        const bool ok = !pl.err_at(i0);
        const bool p = pl.prs_at(i0);
        fl[s] = tf_neg(ok && p, ok && !p, i2 == 1);
        break;
      }
      default:  // R_NOP and unknown opcodes leave the register clear
        break;
    }
  }
  out[(long long)r * w_n + w] = (fl[top] & kTrue) ? 1 : 0;
}

}  // namespace

extern "C" {

int emqx_rules_eval(const int* code, const int* a0, const int* a1,
                    const int* a2, const int* a3, const double* litn,
                    const int* last, const int* lit_ranks, int n_lits,
                    const double* num, const int* sid, const uint8_t* err,
                    const uint8_t* prs, int n_rules, int n_steps,
                    int n_planes, int w_n, uint8_t* out, void* stream) {
  if (n_steps < 1 || n_steps > kMaxSteps) return (int)cudaErrorInvalidValue;
  if (n_rules == 0 || w_n == 0) return (int)cudaSuccess;
  const int slices = (w_n + kRulesThreads - 1) / kRulesThreads;
  if (slices > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(n_rules, slices);
  rules_eval_kernel<<<grid, kRulesThreads, 0, (cudaStream_t)stream>>>(
      code, a0, a1, a2, a3, litn, last, lit_ranks, n_lits, num, sid, err,
      prs, n_steps, n_planes, w_n, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
