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
// B_new is a kernel argument, or read from device memory when the caller
// passes a pointer to it (the device TRM's halved budget, so that no chase
// needs a host read), so a halved trust region re-launches on the same
// tables with no rebuild.
//
// What bounds it on this card: the chase is a chain of nt-1 dependent loads
// (the address of step k+1's U entry is the value of step k's), so it is
// bound by memory latency, not by bytes or operations: it touches only
// nt-1 entries of U and of b̃.  The design spends the block's threads where
// there is parallel work — the seed's argmin over the (L, B+1) plane, a
// block-wide (value, index) reduction that keeps the first-index rule — and
// walks the chain with one thread, reading the int8 or int32 U and widening
// it (common.cuh).
//
// Interface: plain C, pointers as void*, launched on the caller's stream;
// returns cudaGetLastError() after the launch (0 = launched).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, typename UT>
__global__ void __launch_bounds__(kThreads)
chase_kernel(const T* __restrict__ phi0,           // (L, B+1)
             const int32_t* __restrict__ btilde,   // (nt, L)
             const UT* __restrict__ U,             // (nt-1, L, B+1)
             const int32_t* __restrict__ B_dev,    // () or nullptr
             int32_t* __restrict__ out,            // (nt,)
             int nt, int L, int B, int B_new) {
  __shared__ T sval[kThreads];
  __shared__ int sidx[kThreads];
  const int B1 = B + 1;
  const int cap = B_dev != nullptr ? *B_dev : B_new;
  const int flat = mioc::block_masked_argmin(phi0, L * B1, B1, cap, sval, sidx);
  if (threadIdx.x == 0) {
    const int l = flat / B1;
    mioc::walk(U, btilde, out, nt, L, B, l, flat - l * B1);
  }
}

template <typename T, typename UT>
int launch(const void* phi0, const void* btilde, const void* U, const void* B_dev,
           void* out, int nt, int L, int B, int B_new, cudaStream_t stream) {
  chase_kernel<T, UT><<<1, kThreads, 0, stream>>>(
      static_cast<const T*>(phi0), static_cast<const int32_t*>(btilde),
      static_cast<const UT*>(U), static_cast<const int32_t*>(B_dev),
      static_cast<int32_t*>(out), nt, L, B, B_new);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype_bytes: 4 (float) or 8 (double) for phi0; u_bytes: 1 (int8) or 4
// (int32).  B_dev: a device int32 holding the cap, or null to use B_new.
// Returns a cudaError_t value (0 = success); -1 for an unsupported type pair.
int mioc_chase(const void* phi0, const void* btilde, const void* U, const void* B_dev,
               void* out, int nt, int L, int B, int B_new, int dtype_bytes,
               int u_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_bytes == 8 && u_bytes == 1)
    return launch<double, int8_t>(phi0, btilde, U, B_dev, out, nt, L, B, B_new, s);
  if (dtype_bytes == 8 && u_bytes == 4)
    return launch<double, int32_t>(phi0, btilde, U, B_dev, out, nt, L, B, B_new, s);
  if (dtype_bytes == 4 && u_bytes == 1)
    return launch<float, int8_t>(phi0, btilde, U, B_dev, out, nt, L, B, B_new, s);
  if (dtype_bytes == 4 && u_bytes == 4)
    return launch<float, int32_t>(phi0, btilde, U, B_dev, out, nt, L, B, B_new, s);
  return -1;
}

}  // extern "C"
