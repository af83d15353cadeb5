// dp_build.cuh — the Bellman DP backward sweep, one start per block.
//
// The body of both build kernels: dp_build.cu launches it for one start
// (grid 1), dp_build_batched.cu for S starts that share one jump table
// (grid S, block s on stage[s], btilde[s], writing U[s] and phi0[s]).  Each
// block computes exactly what mioc_tpu_torch.ops.bellman.build_tables_plain
// computes for its start:
//
//   Φ_{nt-1}[l, b] = stage[nt-1, l] if b == b̃[nt-1, l] else +inf
//   for i = nt-2 … 0, for every (l, b):
//     s = b̃[i, l]
//     if s > smax or b < s:  val = +inf, arg = 0
//     else:                  val, arg = min_j Φ_{i+1}[j, b-s] + jump[l, j]
//                            (strict < over ascending j: the FIRST minimal j)
//     Φ_i[l, b] = stage[i, l] + val;   U[i, l, b] = arg
//   phi0 = Φ_0
//
// Φ is double-buffered in shared memory (one barrier per step), the jump
// table sits in shared memory, and the post-shift argmin plane U_i streams
// straight to device memory, unpadded (nt-1, L, B+1), int8 when L ≤ 127.
//
// NaN: the strict < ignores NaN where torch.min propagates it.  The solver
// never builds from a non-finite gradient (non-finite trials are rejected
// before they become u_old), and the tests feed finite inputs.

#pragma once

#include "common.cuh"

namespace mioc {

template <typename T, typename UT>
__global__ void dp_build_kernel(const T* __restrict__ stage,         // (S, nt, L)
                                const int32_t* __restrict__ btilde,  // (S, nt, L)
                                const T* __restrict__ jump,          // (L, L)
                                UT* __restrict__ U,                  // (S, nt-1, L, B+1)
                                T* __restrict__ phi0,                // (S, L, B+1)
                                int nt, int L, int B, int smax) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int B1 = B + 1;
  const int P = L * B1;
  const size_t s = blockIdx.x;
  stage += s * nt * L;
  btilde += s * nt * L;
  U += s * (size_t)(nt - 1) * P;
  phi0 += s * P;
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + P;
  T* jmp = nxt + P;
  const T INF = inf_of<T>();

  for (int idx = threadIdx.x; idx < L * L; idx += blockDim.x) jmp[idx] = jump[idx];
  // Terminal layer: exact-budget seed.
  const T* st_last = stage + (size_t)(nt - 1) * L;
  const int32_t* bt_last = btilde + (size_t)(nt - 1) * L;
  for (int idx = threadIdx.x; idx < P; idx += blockDim.x) {
    const int l = idx / B1;
    const int b = idx - l * B1;
    cur[idx] = (b == bt_last[l]) ? st_last[l] : INF;
  }
  __syncthreads();

  for (int i = nt - 2; i >= 0; --i) {
    const T* st = stage + (size_t)i * L;
    const int32_t* bt = btilde + (size_t)i * L;
    UT* Ui = U + (size_t)i * P;
    for (int idx = threadIdx.x; idx < P; idx += blockDim.x) {
      const int l = idx / B1;
      const int b = idx - l * B1;
      const int sh = bt[l];
      T val = INF;
      int arg = 0;
      if (sh <= smax && b >= sh) {
        const T* col = cur + (b - sh);
        const T* jl = jmp + l * L;
        val = col[0] + jl[0];
        for (int j = 1; j < L; ++j) {
          const T cand = col[j * B1] + jl[j];
          if (cand < val) {
            val = cand;
            arg = j;
          }
        }
      }
      nxt[idx] = st[l] + val;
      Ui[idx] = static_cast<UT>(arg);
    }
    __syncthreads();  // Φ_i complete; Φ_{i+1}'s buffer is free to overwrite
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int idx = threadIdx.x; idx < P; idx += blockDim.x) phi0[idx] = cur[idx];
}

template <typename T, typename UT>
int launch_dp_build(const void* stage, const void* btilde, const void* jump, void* U,
                    void* phi0, int S, int nt, int L, int B, int smax, int threads,
                    size_t smem, cudaStream_t stream) {
  auto kern = dp_build_kernel<T, UT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<S, threads, smem, stream>>>(
      static_cast<const T*>(stage), static_cast<const int32_t*>(btilde),
      static_cast<const T*>(jump), static_cast<UT*>(U), static_cast<T*>(phi0),
      nt, L, B, smax);
  return (int)cudaGetLastError();
}

// dtype_bytes: 4 (float) or 8 (double); u_bytes: 1 (int8) or 4 (int32).
// Returns a cudaError_t value (0 = success); -1 for an unsupported type pair.
inline int dp_build_dispatch(const void* stage, const void* btilde, const void* jump,
                             void* U, void* phi0, int S, int nt, int L, int B, int smax,
                             int dtype_bytes, int u_bytes, int threads, void* stream) {
  const size_t smem = (size_t)(2 * L * (B + 1) + L * L) * dtype_bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_bytes == 8 && u_bytes == 1)
    return launch_dp_build<double, int8_t>(stage, btilde, jump, U, phi0, S, nt, L, B, smax, threads, smem, st);
  if (dtype_bytes == 8 && u_bytes == 4)
    return launch_dp_build<double, int32_t>(stage, btilde, jump, U, phi0, S, nt, L, B, smax, threads, smem, st);
  if (dtype_bytes == 4 && u_bytes == 1)
    return launch_dp_build<float, int8_t>(stage, btilde, jump, U, phi0, S, nt, L, B, smax, threads, smem, st);
  if (dtype_bytes == 4 && u_bytes == 4)
    return launch_dp_build<float, int32_t>(stage, btilde, jump, U, phi0, S, nt, L, B, smax, threads, smem, st);
  return -1;
}

}  // namespace mioc
