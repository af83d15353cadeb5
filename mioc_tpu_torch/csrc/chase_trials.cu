// chase_trials — the trial-wave chase: Kt budget caps per start against that
// start's one table set, by hand for Hopper.
//
// Replaces: mioc_tpu/ops/backtrack_pallas.py::_bt_kernel_trials (the TPU
// kernel behind backtrack_pallas_trials / _backtrack_trials_impl: the
// speculative trial wave of the batched multistart).  Computes exactly what
// mioc_tpu_torch.ops.bellman.backtrack_trials_plain computes: row (s, t) is
// the chase of chase.cu on start s's tables at the cap B_trials[s, t]:
//
//   seed:  (l, b) = flat argmin of phi0[s] masked to b ≤ B_trials[s, t],
//          ties to the smallest flat index l·(B+1) + b;
//   step k = 0 … nt-2:  l' = U[s, k, l, b];  b -= b̃[s, k, l];  l = l';
//   out[s, t, 0] = seed l, out[s, t, k+1] = l after step k.
//
// The caps are an int32 (S, Kt) tensor in device memory.  Kt ≤ 128.
//
// What bounds it on this card: like every chase, the chain of nt-1 dependent
// loads, so memory latency.  The TPU kernel DMAs each U plane once per step
// for all Kt trials; here one block serves one start (blockIdx.x = s) and
// its Kt chains walk in parallel, one thread each, in lockstep over k: all
// Kt reads of step k fall in the same (L, B+1) plane U[s, k], so the plane
// comes from device memory once and the other reads hit the cache.  The
// seeds' masked argmins are independent: one warp per trial (warps take
// trials round-robin), each a strided scan of the plane and a warp-shuffle
// (value, flat index) reduction with the first-index rule.
//
// Interface: plain C, pointers as void*, launched on the caller's stream;
// returns cudaGetLastError() after the launch (0 = launched).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTrials = 128;

template <typename T, typename UT>
__global__ void __launch_bounds__(kThreads)
chase_trials_kernel(const T* __restrict__ phi0,            // (S, L, B+1)
                    const int32_t* __restrict__ btilde,    // (S, nt, L)
                    const UT* __restrict__ U,              // (S, nt-1, L, B+1)
                    const int32_t* __restrict__ B_trials,  // (S, Kt)
                    int32_t* __restrict__ out,             // (S, Kt, nt)
                    int Kt, int nt, int L, int B) {
  __shared__ int seed[kMaxTrials];
  const int s = blockIdx.x;
  const int B1 = B + 1;
  const int P = L * B1;
  phi0 += (size_t)s * P;
  btilde += (size_t)s * nt * L;
  U += (size_t)s * (nt - 1) * P;
  B_trials += (size_t)s * Kt;
  out += (size_t)s * Kt * nt;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int t = warp; t < Kt; t += kWarps) {
    T best;
    int bi;
    mioc::scan_masked(phi0, P, B1, B_trials[t], lane, 32, best, bi);
    mioc::warp_argmin(best, bi);
    if (lane == 0) seed[t] = bi;
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t < Kt) {
    const int l = seed[t] / B1;
    mioc::walk(U, btilde, out + (size_t)t * nt, 0, nt, L, B, l, seed[t] - l * B1);
  }
}

template <typename T, typename UT>
int launch(const void* phi0, const void* btilde, const void* U, const void* B_trials,
           void* out, int S, int Kt, int nt, int L, int B, cudaStream_t stream) {
  chase_trials_kernel<T, UT><<<S, kThreads, 0, stream>>>(
      static_cast<const T*>(phi0), static_cast<const int32_t*>(btilde),
      static_cast<const UT*>(U), static_cast<const int32_t*>(B_trials),
      static_cast<int32_t*>(out), Kt, nt, L, B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype_bytes: 4 (float) or 8 (double) for phi0; u_bytes: 1 (int8) or 4
// (int32).  Returns a cudaError_t value (0 = success); -1 for an unsupported
// type pair or Kt outside 1 … 128.
int mioc_chase_trials(const void* phi0, const void* btilde, const void* U,
                      const void* B_trials, void* out, int S, int Kt, int nt, int L,
                      int B, int dtype_bytes, int u_bytes, void* stream) {
  if (Kt < 1 || Kt > kMaxTrials) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_bytes == 8 && u_bytes == 1)
    return launch<double, int8_t>(phi0, btilde, U, B_trials, out, S, Kt, nt, L, B, st);
  if (dtype_bytes == 8 && u_bytes == 4)
    return launch<double, int32_t>(phi0, btilde, U, B_trials, out, S, Kt, nt, L, B, st);
  if (dtype_bytes == 4 && u_bytes == 1)
    return launch<float, int8_t>(phi0, btilde, U, B_trials, out, S, Kt, nt, L, B, st);
  if (dtype_bytes == 4 && u_bytes == 4)
    return launch<float, int32_t>(phi0, btilde, U, B_trials, out, S, Kt, nt, L, B, st);
  return -1;
}

}  // extern "C"
