// chase — the DP path chase (backtrack) for one start, by hand for Hopper.
//
// Replaces: mioc_tpu/ops/backtrack_pallas.py::_bt_kernel (the TPU chase
// behind backtrack_pallas).  Computes exactly what
// mioc_tpu_torch.ops.bellman.backtrack_plain computes:
//
//   seed:  (l, b) = the flat argmin of phi0[l, b] masked to b ≤ B_new (+inf
//          elsewhere), ties to the smallest flat index l·(B+1) + b — the
//          reference's column-major argmin (smallest l, then smallest b);
//   step k = 0 … nt-2:  l' = U[k, l, b];  b -= b̃[k, l];  l = l'
//          (the lookup BEFORE the decrement: U is the post-shift table);
//   level_idx[0] = seed l, level_idx[k+1] = l after step k.
//
// B_new is a kernel argument, so a halved trust region re-launches on the
// same tables with no rebuild.
//
// What bounds it on this card: the chase is a chain of nt-1 dependent loads
// (the address of step k+1's U entry is the value of step k's), so it is
// bound by memory latency, not by bytes or operations: it touches only
// nt-1 entries of U and of b̃.  The design spends the block's threads where
// there is parallel work — the seed's argmin over the (L, B+1) plane, a
// block-wide (value, index) reduction that keeps the first-index rule — and
// walks the chain with one thread, reading the int8 or int32 U and widening
// it.  On a valid table the walk never leaves 0 ≤ b ≤ B; the read index is
// clamped into range all the same so a malformed table cannot read out of
// bounds.
//
// NaN: the comparisons ignore NaN where torch.argmin propagates it; the
// solver never chases a table built from a non-finite gradient.
//
// Interface: plain C, pointers as void*, launched on the caller's stream;
// returns cudaGetLastError() after the launch (0 = launched).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ T inf_of();
template <> __device__ __forceinline__ float inf_of<float>() { return CUDART_INF_F; }
template <> __device__ __forceinline__ double inf_of<double>() { return CUDART_INF; }

template <typename T>
__device__ __forceinline__ bool better(T v, int i, T best, int bi) {
  return v < best || (v == best && i < bi);
}

template <typename T, typename UT>
__global__ void __launch_bounds__(kThreads)
chase_kernel(const T* __restrict__ phi0,           // (L, B+1)
             const int32_t* __restrict__ btilde,   // (nt, L)
             const UT* __restrict__ U,             // (nt-1, L, B+1)
             int32_t* __restrict__ out,            // (nt,)
             int nt, int L, int B, int B_new) {
  __shared__ T sval[kThreads];
  __shared__ int sidx[kThreads];
  const int B1 = B + 1;
  const int P = L * B1;
  const T INF = inf_of<T>();

  // Seed: masked argmin with the first-index rule.  Masked entries are +inf
  // but stay candidates, so an all-inf plane gives index 0 as argmin does.
  T best = INF;
  int bi = INT_MAX;
  for (int idx = threadIdx.x; idx < P; idx += blockDim.x) {
    const int b = idx % B1;
    const T v = (b <= B_new) ? phi0[idx] : INF;
    if (better(v, idx, best, bi)) {
      best = v;
      bi = idx;
    }
  }
  sval[threadIdx.x] = best;
  sidx[threadIdx.x] = bi;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      const T v = sval[threadIdx.x + half];
      const int i = sidx[threadIdx.x + half];
      if (better(v, i, sval[threadIdx.x], sidx[threadIdx.x])) {
        sval[threadIdx.x] = v;
        sidx[threadIdx.x] = i;
      }
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    int l = sidx[0] / B1;
    int b = sidx[0] - l * B1;
    out[0] = l;
    for (int k = 0; k < nt - 1; ++k) {
      const int bc = min(max(b, 0), B);
      const int nl = static_cast<int>(U[((size_t)k * L + l) * B1 + bc]);
      b -= btilde[(size_t)k * L + l];  // decrement AFTER the lookup
      l = nl;
      out[k + 1] = l;
    }
  }
}

template <typename T, typename UT>
int launch(const void* phi0, const void* btilde, const void* U, void* out,
           int nt, int L, int B, int B_new, cudaStream_t stream) {
  chase_kernel<T, UT><<<1, kThreads, 0, stream>>>(
      static_cast<const T*>(phi0), static_cast<const int32_t*>(btilde),
      static_cast<const UT*>(U), static_cast<int32_t*>(out), nt, L, B, B_new);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype_bytes: 4 (float) or 8 (double) for phi0; u_bytes: 1 (int8) or 4
// (int32).  Returns a cudaError_t value (0 = success); -1 for an unsupported
// type pair.
int mioc_chase(const void* phi0, const void* btilde, const void* U, void* out,
               int nt, int L, int B, int B_new, int dtype_bytes, int u_bytes,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_bytes == 8 && u_bytes == 1)
    return launch<double, int8_t>(phi0, btilde, U, out, nt, L, B, B_new, s);
  if (dtype_bytes == 8 && u_bytes == 4)
    return launch<double, int32_t>(phi0, btilde, U, out, nt, L, B, B_new, s);
  if (dtype_bytes == 4 && u_bytes == 1)
    return launch<float, int8_t>(phi0, btilde, U, out, nt, L, B, B_new, s);
  if (dtype_bytes == 4 && u_bytes == 4)
    return launch<float, int32_t>(phi0, btilde, U, out, nt, L, B, B_new, s);
  return -1;
}

}  // extern "C"
