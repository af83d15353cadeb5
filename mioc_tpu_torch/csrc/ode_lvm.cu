// ode_lvm — the Lotka–Volterra fishing sweeps (forward Euler with its
// trapezoid cost, and the discrete adjoint with its gradient), one thread per
// row, by hand for Hopper.
//
// Replaces no TPU kernel: the JAX package runs these sweeps as lax.scan loops
// that XLA compiles (mioc_tpu/models/fishing.py).  The port first wrote them
// as a chain of small PyTorch ops per step (mioc_tpu_torch/models/fishing.py,
// LVMObj._forward_batch_torch and _adjoint_batch_torch, which stay as the
// plain version), about 7.5 launches a step: on the card a sweep of 1024
// steps cost ~130 ms of the host's launches for ~1 ms of device work.
//
// What bounds it on this card: each row is a chain of dependent float64
// operations, four a step in either sweep (fma, sub, mul, fma), with the
// state (y₀, y₁) or the adjoint (λ₀, λ₁) in registers; the rows are
// independent.  So a sweep is bound by nt × 4 float64 latencies, whatever the
// row count up to the card's threads; its bytes (the couplings A and the
// states in, the states, λ and ∇f out) are a few MB, microseconds at HBM
// rates.  A warp issues in order, so whatever stalls it stalls the chain.
// The design keeps it fed:
//   * the loads go through shared memory: each thread stages its own row's
//     couplings (and, in the adjoint, states and rule letters) for the next
//     window or chunk of steps with cp.async while it computes this one, and
//     reads back only what it staged itself (no barrier).  Loads into
//     registers a few steps ahead did not help: the wait for the oldest load
//     waited for the newer ones too, one memory latency a step;
//   * no branch between the steps of a full window (forward) or chunk
//     (adjoint), so the compiler interleaves one step's cost term or gradient
//     row with the next steps' chain; the edges (a partial window or chunk)
//     take a guarded loop;
//   * the stores go straight to device memory: the forward's states are
//     coalesced (time-major), the adjoint's λ and ∇f rows are not (each
//     thread writes its own row), which sets the adjoint's pace from 32 rows
//     on; staging them in shared memory to write row segments was slower.
// One warp per block spreads the rows over as many SMs as there are warps.
//
// Measured (python -m mioc_tpu_torch.profile_kernels --lvm-only; NVIDIA H100
// 80GB HBM3, 700 W), nt = 1024: the forward 47–48 µs at 1, 32 and 288 rows,
// ~23 cycles at 1980 MHz for each of its chain's 4096 operations, where one
// float64 operation's latency alone is 8.3 cycles (a bound of 17.2 µs); the
// adjoint 89 µs at one row and 189–191 µs at 32 and 288.  A call's host
// side (the couplings, the wrapper, the launch) takes longer than either.
//
// Rounding: every product and sum is an explicit intrinsic (Arith below), in
// the order of the PyTorch sweeps (which round as the JAX package's compiled
// CPU sweeps, ops/xla_order.py), so nvcc, which contracts a * b + c under the
// default -fmad, contracts nothing here and the bits equal the plain
// version's: f, the states, λ and ∇f.  NaN and inf pass through as there.
// The kernels are templates on the storage type: float64 rounds each
// operation in float64 (__fma_rn, __dmul_rn, __dadd_rn, __dsub_rn); float32
// rounds each product and sum in float32 (__fmul_rn, __fadd_rn, __fsub_rn)
// and each fma as xla_order.fma does there, the float64 fma of the float32
// operands (whose product is exact) rounded to float32.
//
// Forward, per row, k = 0 … nt-1 (A = (a, c) the couplings of step k):
//   y₀ ← fma(y₀·(fma(−β, y₁, α) − a_k), τ, y₀)
//   y₁ ← fma(y₁·(fma(δ, y₀, −γ) − c_k), τ, y₁)     (both from the old y)
//   f = τ · Σ_{n=0}^{nt} w_n·(½·fma(d₀, d₀, d₁·d₁)),  d = y_n − 1,
// with w the trapezoid weights and Σ in xla_order.window_sum's order: level
// 0 cuts the nt + 1 terms into windows of 32 that start `off0` before term 0
// (the leading pad, zeros, which add nothing), each summed from 0 in order;
// the window sums go on to the next level the same way, and the last level
// (≤ 32 values) is summed in order.  The kernel walks the steps window by
// window; the host gives the levels' offsets (ops/ode_cuda.py::window_plan).
//
// Adjoint, per row: λ = c·(y_nt − 1) with c = −½τ from the host; then for
// the scan's steps i = 0 … nt-2 (k = nt-2-i, y = y_{k+1}, A of step k+1):
//   S₀ = fma(−β, y₁, α) − a,  S₁ = fma(δ, y₀, −γ) − c,  C = (δy₁, −βy₀)
//   rule '4': ft₀ = fma(S₀, λ₀, C₀λ₁);  rule '5': ft₀ = fma(C₀, λ₁, λ₀S₀)
//   ft₁ = fma(S₁, λ₁, C₁λ₀)
//   λ ← fma(ft − (y − 1), τ, λ)
// with the rule letter of step i from a per-step table (the JAX scan's place
// of the step, objectives/ode.py::scan_rules).  The gradient row of step k,
// ∇f[k, m] = fma((c₂·y₁)·v2_m, λ₁, ((c₁·y₀)·v1_m)·λ₀) at (y_k, λ_k), is
// written in the same loop (row 0 from y_0 = state0, after it).
//
// Interface: plain C, one entry per sweep and storage type (_f64, _f32),
// pointers as void*, launched on the caller's stream; returns the launch's
// cudaError_t (0 = launched), -1 for arguments it does not take.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;   // rows per block: one warp
constexpr int kWindow = 32;    // xla_order.window_sum's window: the forward's stage
constexpr int kChunk = 16;     // adjoint steps a stage holds: 16 rule letters, one copy
constexpr int kMaxLevels = 4;  // levels of windows: nt + 1 ≤ 32^5
constexpr int kM = 3;          // control columns of the gradient: the three fishing modes

// The arithmetic of one storage type, each operation rounded as the PyTorch
// sweeps round it in that type, and the pair (y₀, y₁) or (a, c) as one load.
template <typename T>
struct Arith;

template <>
struct Arith<double> {
  using T2 = double2;
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double fma(double a, double b, double c) {
    return __fma_rn(a, b, c);
  }
  static __device__ __forceinline__ double2 pair(double x, double y) {
    return make_double2(x, y);
  }
};

template <>
struct Arith<float> {
  using T2 = float2;
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  // xla_order.fma in float32: the float64 sum a·b + c, rounded to float32.
  static __device__ __forceinline__ float fma(float a, float b, float c) {
    return __double2float_rn(__fma_rn((double)a, (double)b, (double)c));
  }
  static __device__ __forceinline__ float2 pair(float x, float y) { return make_float2(x, y); }
};

// xla_order.window_sum over a stream of values, one value at a time, in
// scalars (registers): level l (l < levels) sums windows of 32, level
// `levels` sums in order.  The forward sums level 0 itself, window by
// window, and streams the window sums through this.
template <typename T>
struct WindowSum {
  using M = Arith<T>;
  T a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  int p0, p1, p2;
  int levels;

  __device__ __forceinline__ WindowSum(int lv, int o0, int o1, int o2)
      : p0(o0), p1(o1), p2(o2), levels(lv) {}

  // Adds v to one level; where that level sums windows and its window is
  // full, hands the window's sum on in v and returns true.
  static __device__ __forceinline__ bool add(T& acc, int& pos, bool windowed, T& v) {
    acc = M::add(acc, v);
    if (!windowed || ++pos != kWindow) return false;
    v = acc;
    acc = 0;
    pos = 0;
    return true;
  }

  // v into level `from`, and on up as windows fill.
  __device__ __forceinline__ void push(T v, int from = 0) {
    if (from <= 0 && !add(a0, p0, levels > 0, v)) return;
    if (from <= 1 && !add(a1, p1, levels > 1, v)) return;
    if (from <= 2 && !add(a2, p2, levels > 2, v)) return;
    a3 = M::add(a3, v);
  }

  // The partial windows, level by level, then the last level's sum.
  __device__ __forceinline__ T finish() {
    if (levels > 0 && p0 != 0) push(a0, 1);
    if (levels > 1 && p1 != 0) push(a1, 2);
    if (levels > 2 && p2 != 0) push(a2, 3);
    return levels == 0 ? a0 : levels == 1 ? a1 : levels == 2 ? a2 : a3;
  }
};

// w·(½·fma(d₀, d₀, d₁·d₁)) with d = y − 1: one trapezoid term.
template <typename T>
__device__ __forceinline__ T cost(T y0, T y1, T w) {
  using M = Arith<T>;
  const T d0 = M::sub(y0, T(1)), d1 = M::sub(y1, T(1));
  return M::mul(w, M::mul(T(0.5), M::fma(d0, d0, M::mul(d1, d1))));
}

// The model's constants in the storage type (each rounded to it once, as
// the PyTorch sweeps' constant tensors are).
template <typename T>
struct Dynamics {
  T alpha, nbeta, ngamma, delta, tau;
};

// One Euler step of (y₀, y₁) with the couplings a.
template <typename T>
__device__ __forceinline__ void euler(const Dynamics<T>& p, typename Arith<T>::T2 a, T& y0,
                                      T& y1) {
  using M = Arith<T>;
  const T n0 = M::fma(M::mul(y0, M::sub(M::fma(p.nbeta, y1, p.alpha), a.x)), p.tau, y0);
  const T n1 = M::fma(M::mul(y1, M::sub(M::fma(p.delta, y0, p.ngamma), a.y)), p.tau, y1);
  y0 = n0;
  y1 = n1;
}

// Stages rows first, first + step, … (N of them; those in [lo, hi)) of src
// (rows, S) for this thread's row s into its column of dst, asynchronously.
template <int N, typename T2>
__device__ __forceinline__ void stage_rows(T2 (*dst)[kThreads], const T2* src, int first,
                                          int step, int lo, int hi, int S, int s) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int r = first + j * step;
    if (r >= lo && r < hi)
      __pipeline_memcpy_async(&dst[j][threadIdx.x], src + (size_t)r * S + s, sizeof(T2));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lvm_forward_kernel(const typename Arith<T>::T2* __restrict__ A, const T* __restrict__ state0,
                   typename Arith<T>::T2* __restrict__ ys, T* __restrict__ f, int nt, int S,
                   Dynamics<T> p, int levels, int off0, int off1, int off2, int off3) {
  using M = Arith<T>;
  using T2 = typename M::T2;
  // stage[b][j]: the couplings of term n0 + j's step (k = n0 + j - 1) of the
  // window whose first term is n0.
  __shared__ T2 stage[2][kWindow][kThreads];
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  const int off = levels > 0 ? off0 : 0;  // with no level, one window from term 0
  WindowSum<T> upper(levels > 0 ? levels - 1 : 0, off1, off2, off3);
  T y0 = state0[0], y1 = state0[1], total = 0;
  stage_rows<kWindow>(stage[0], A, -off - 1, 1, 0, nt, S, s);
  __pipeline_commit();
  const int windows = (nt + 1 + off + kWindow - 1) / kWindow;
  for (int w = 0, b = 0; w < windows; ++w, b ^= 1) {
    const int n0 = kWindow * w - off;
    stage_rows<kWindow>(stage[b ^ 1], A, n0 + kWindow - 1, 1, 0, nt, S, s);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this window's group
    T acc = 0;
    if (n0 >= 1 && n0 + kWindow <= nt) {  // every term a step of weight 1
#pragma unroll
      for (int j = 0; j < kWindow; ++j) {
        euler(p, stage[b][j][threadIdx.x], y0, y1);
        ys[(size_t)(n0 + j - 1) * S + s] = M::pair(y0, y1);
        acc = M::add(acc, cost(y0, y1, T(1)));
      }
    } else {
      for (int j = 0; j < kWindow; ++j) {
        const int n = n0 + j;
        if (n < 0 || n > nt) continue;
        if (n > 0) {
          euler(p, stage[b][j][threadIdx.x], y0, y1);
          ys[(size_t)(n - 1) * S + s] = M::pair(y0, y1);
        }
        acc = M::add(acc, cost(y0, y1, n == 0 || n == nt ? T(0.5) : T(1)));
      }
    }
    if (levels > 0)
      upper.push(acc);
    else
      total = acc;
  }
  f[s] = M::mul(p.tau, levels > 0 ? upper.finish() : total);
}

// One adjoint step of this thread's row: the gradient row of y (= y_{k+1})
// and λ (= λ_{k+1}) into df_row, then λ ← λ_k, stored into lam_row.
template <typename T>
__device__ __forceinline__ void adjoint_step(const Dynamics<T>& p, const T (&v1)[kM],
                                             const T (&v2)[kM], T c1, T c2,
                                             typename Arith<T>::T2 y, typename Arith<T>::T2 a,
                                             unsigned r, T& l0, T& l1, T* df_row,
                                             typename Arith<T>::T2* lam_row) {
  using M = Arith<T>;
  const T p0 = M::mul(c1, y.x), p1 = M::mul(c2, y.y);
#pragma unroll
  for (int m = 0; m < kM; ++m)
    df_row[m] = M::fma(M::mul(p1, v2[m]), l1, M::mul(M::mul(p0, v1[m]), l0));
  const T s0 = M::sub(M::fma(p.nbeta, y.y, p.alpha), a.x);
  const T s1 = M::sub(M::fma(p.delta, y.x, p.ngamma), a.y);
  const T q0 = M::mul(p.delta, y.y), q1 = M::mul(p.nbeta, y.x);
  const T ft0 = r == '5' ? M::fma(q0, l1, M::mul(l0, s0)) : M::fma(s0, l0, M::mul(q0, l1));
  const T ft1 = M::fma(s1, l1, M::mul(q1, l0));
  const T n0 = M::fma(M::sub(ft0, M::sub(y.x, T(1))), p.tau, l0);
  const T n1 = M::fma(M::sub(ft1, M::sub(y.y, T(1))), p.tau, l1);
  l0 = n0;
  l1 = n1;
  *lam_row = M::pair(l0, l1);
}

// Stages the adjoint's chunk of scan steps from i0 for this thread's row:
// y_{k+1} = ys[k] and A[k+1] (k = nt-2-i), and the chunk's 16 rule letters
// in one copy (the table's storage is padded to a multiple of 16 bytes).
template <typename T2>
__device__ __forceinline__ void stage_chunk(T2 (*sy)[kThreads], T2 (*sa)[kThreads], uint4* sr,
                                            const T2* ys, const T2* A, const uint8_t* rules,
                                            int i0, int nt, int S, int s) {
  if (i0 >= nt - 1) return;
  stage_rows<kChunk>(sy, ys, nt - 2 - i0, -1, 0, nt - 1, S, s);
  stage_rows<kChunk>(sa, A, nt - 1 - i0, -1, 1, nt, S, s);
  __pipeline_memcpy_async(&sr[threadIdx.x], rules + i0, sizeof(uint4));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lvm_adjoint_kernel(const typename Arith<T>::T2* __restrict__ A,
                   const typename Arith<T>::T2* __restrict__ ys,
                   const uint8_t* __restrict__ rules, const T* __restrict__ state0,
                   const T* __restrict__ v1g, const T* __restrict__ v2g,
                   typename Arith<T>::T2* __restrict__ lam, T* __restrict__ df, int nt, int S,
                   Dynamics<T> p, T lam_scale, T c1, T c2) {
  using M = Arith<T>;
  using T2 = typename M::T2;
  // sy[b][j], sa[b][j], sr[b]: y_{k+1} = ys[k], A[k+1] and the rule letters
  // of scan steps i0 + j (k = nt-2-i) of the chunk from i0.
  __shared__ T2 sy[2][kChunk][kThreads], sa[2][kChunk][kThreads];
  __shared__ uint4 sr[2][kThreads];
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  T v1[kM], v2[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    v1[m] = v1g[m];
    v2[m] = v2g[m];
  }
  T2* lam_row = lam + (size_t)s * nt;
  T* df_row = df + (size_t)s * nt * kM;
  const int steps = nt - 1;
  stage_chunk(sy[0], sa[0], sr[0], ys, A, rules, 0, nt, S, s);
  __pipeline_commit();
  const T2 yn = __ldg(ys + (size_t)(nt - 1) * S + s);
  T l0 = M::mul(lam_scale, M::sub(yn.x, T(1)));
  T l1 = M::mul(lam_scale, M::sub(yn.y, T(1)));
  lam_row[nt - 1] = M::pair(l0, l1);
  for (int i0 = 0, b = 0; i0 < steps; i0 += kChunk, b ^= 1) {
    stage_chunk(sy[b ^ 1], sa[b ^ 1], sr[b ^ 1], ys, A, rules, i0 + kChunk, nt, S, s);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this chunk's group
    if (i0 + kChunk <= steps) {
      const uint4 rw = sr[b][threadIdx.x];
      const unsigned words[4] = {rw.x, rw.y, rw.z, rw.w};
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int k = nt - 2 - i0 - j;
        adjoint_step(p, v1, v2, c1, c2, sy[b][j][threadIdx.x], sa[b][j][threadIdx.x],
                     (words[j / 4] >> (8 * (j % 4))) & 0xffu, l0, l1,
                     df_row + (size_t)(k + 1) * kM, lam_row + k);
      }
    } else {
      const uint8_t* letters = reinterpret_cast<const uint8_t*>(&sr[b][threadIdx.x]);
      for (int j = 0; j < steps - i0; ++j) {
        const int k = nt - 2 - i0 - j;
        adjoint_step(p, v1, v2, c1, c2, sy[b][j][threadIdx.x], sa[b][j][threadIdx.x],
                     letters[j], l0, l1, df_row + (size_t)(k + 1) * kM, lam_row + k);
      }
    }
  }
  const T p0 = M::mul(c1, state0[0]), p1 = M::mul(c2, state0[1]);
#pragma unroll
  for (int m = 0; m < kM; ++m)
    df_row[m] = M::fma(M::mul(p1, v2[m]), l1, M::mul(M::mul(p0, v1[m]), l0));
}

template <typename T>
int forward(const void* A, const void* state0, void* ys, void* f, int nt, int S, double alpha,
            double nbeta, double ngamma, double delta, double tau, int levels, int off0,
            int off1, int off2, int off3, void* stream) {
  using T2 = typename Arith<T>::T2;
  if (nt < 1 || S < 1 || levels < 0 || levels > kMaxLevels) return -1;
  lvm_forward_kernel<T><<<(S + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T2*>(A), static_cast<const T*>(state0), static_cast<T2*>(ys),
      static_cast<T*>(f), nt, S, Dynamics<T>{T(alpha), T(nbeta), T(ngamma), T(delta), T(tau)},
      levels, off0, off1, off2, off3);
  return (int)cudaGetLastError();
}

template <typename T>
int adjoint(const void* A, const void* ys, const void* rules, const void* state0,
            const void* v1, const void* v2, void* lam, void* df, int nt, int S, double alpha,
            double nbeta, double ngamma, double delta, double tau, double lam_scale, double c1,
            double c2, void* stream) {
  using T2 = typename Arith<T>::T2;
  if (nt < 1 || S < 1) return -1;
  lvm_adjoint_kernel<T><<<(S + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T2*>(A), static_cast<const T2*>(ys), static_cast<const uint8_t*>(rules),
      static_cast<const T*>(state0), static_cast<const T*>(v1), static_cast<const T*>(v2),
      static_cast<T2*>(lam), static_cast<T*>(df), nt, S,
      Dynamics<T>{T(alpha), T(nbeta), T(ngamma), T(delta), T(tau)}, T(lam_scale), T(c1),
      T(c2));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// A, ys: (nt, S, 2), time-major; state0: (2,); f: (S,), all of the entry's
// storage type.  levels and off0 … off3: the window plan of the nt + 1
// trapezoid terms (the leading pads of each level,
// ops/ode_cuda.py::window_plan).  The constants come as float64 and are
// rounded to the storage type here; nbeta, ngamma: −β, −γ.
int mioc_lvm_forward_f64(const void* A, const void* state0, void* ys, void* f, int nt, int S,
                         double alpha, double nbeta, double ngamma, double delta, double tau,
                         int levels, int off0, int off1, int off2, int off3, void* stream) {
  return forward<double>(A, state0, ys, f, nt, S, alpha, nbeta, ngamma, delta, tau, levels,
                         off0, off1, off2, off3, stream);
}

int mioc_lvm_forward_f32(const void* A, const void* state0, void* ys, void* f, int nt, int S,
                         double alpha, double nbeta, double ngamma, double delta, double tau,
                         int levels, int off0, int off1, int off2, int off3, void* stream) {
  return forward<float>(A, state0, ys, f, nt, S, alpha, nbeta, ngamma, delta, tau, levels,
                        off0, off1, off2, off3, stream);
}

// A, ys: (nt, S, 2), time-major; state0: (2,); v1, v2: (3,); lam: (S, nt,
// 2); df: (S, nt, 3), all of the entry's storage type; rules: nt-1 letters
// '4' or '5' in scan order, 16-byte aligned, its storage padded to a
// multiple of 16 bytes.  lam_scale: −½τ.  nbeta, ngamma: −β, −γ.
int mioc_lvm_adjoint_f64(const void* A, const void* ys, const void* rules, const void* state0,
                         const void* v1, const void* v2, void* lam, void* df, int nt, int S,
                         double alpha, double nbeta, double ngamma, double delta, double tau,
                         double lam_scale, double c1, double c2, void* stream) {
  return adjoint<double>(A, ys, rules, state0, v1, v2, lam, df, nt, S, alpha, nbeta, ngamma,
                         delta, tau, lam_scale, c1, c2, stream);
}

int mioc_lvm_adjoint_f32(const void* A, const void* ys, const void* rules, const void* state0,
                         const void* v1, const void* v2, void* lam, void* df, int nt, int S,
                         double alpha, double nbeta, double ngamma, double delta, double tau,
                         double lam_scale, double c1, double c2, void* stream) {
  return adjoint<float>(A, ys, rules, state0, v1, v2, lam, df, nt, S, alpha, nbeta, ngamma,
                        delta, tau, lam_scale, c1, c2, stream);
}

}  // extern "C"
