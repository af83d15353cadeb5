// common.cuh — device helpers shared by the port's DP kernels.
//
// The seed of every chase is the flat argmin of a masked (L, B+1) plane with
// ties to the smaller flat index l·(B+1) + b (the reference's column-major
// argmin: smallest l, then smallest b).  Masked entries are +inf but stay
// candidates, so an all-+inf plane gives index 0, as torch.argmin does.
// The comparisons ignore NaN where torch.argmin propagates it; the solver
// never chases a table built from a non-finite gradient.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <limits.h>
#include <stdint.h>

namespace mioc {

template <typename T> __device__ __forceinline__ T inf_of();
template <> __device__ __forceinline__ float inf_of<float>() { return CUDART_INF_F; }
template <> __device__ __forceinline__ double inf_of<double>() { return CUDART_INF; }

// (v, i) beats (best, bi): smaller value, or the same value at a smaller index.
template <typename T>
__device__ __forceinline__ bool better(T v, int i, T best, int bi) {
  return v < best || (v == best && i < bi);
}

// This thread's share of the masked argmin: entries idx = first, first +
// step, … of the (L, B1) plane phi, masked to b ≤ cap.
template <typename T>
__device__ __forceinline__ void scan_masked(const T* __restrict__ phi, int P, int B1,
                                            int cap, int first, int step, T& best,
                                            int& bi) {
  const T INF = inf_of<T>();
  best = INF;
  bi = INT_MAX;
  for (int idx = first; idx < P; idx += step) {
    const int b = idx % B1;
    const T v = (b <= cap) ? phi[idx] : INF;
    if (better(v, idx, best, bi)) {
      best = v;
      bi = idx;
    }
  }
}

// Warp-wide (value, index) reduction; lane 0 ends with the warp's argmin.
template <typename T>
__device__ __forceinline__ void warp_argmin(T& best, int& bi) {
  for (int off = 16; off > 0; off >>= 1) {
    const T v = __shfl_down_sync(0xffffffffu, best, off);
    const int i = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(v, i, best, bi)) {
      best = v;
      bi = i;
    }
  }
}

// Block-wide masked argmin over the (L, B1) plane phi; every thread of the
// block must call it, and every thread gets the flat index.  sval and sidx
// are shared arrays of blockDim.x entries (a power of two).
template <typename T>
__device__ int block_masked_argmin(const T* __restrict__ phi, int P, int B1, int cap,
                                   T* sval, int* sidx) {
  T best;
  int bi;
  scan_masked(phi, P, B1, cap, threadIdx.x, blockDim.x, best, bi);
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
  const int flat = sidx[0];
  __syncthreads();  // sval/sidx may be reused after this
  return flat;
}

// The budget index of a lookup U[k, l, b], under the reference's rule (the
// JAX scan chase indexes U_k[l, b] with a traced b): a negative b counts
// from the end, b + (B+1), and the result is clamped to [0, B].  On every
// table whose seed is finite b stays in [0, B] and this is b itself; it
// differs only on a walk from a +inf seed, whose budget can fall below 0.
__device__ __forceinline__ int budget_index(int b, int B) {
  const int bn = b < 0 ? b + B + 1 : b;
  return min(max(bn, 0), B);
}

// The dependent walk of one chain from (l, b) at step k0, reading U and b̃ of
// one start: level_idx[k0] = l, level_idx[k+1] = l after step k.  Looks U up
// BEFORE the budget decrement (U is the post-shift table), at the index of
// budget_index().
template <typename UT>
__device__ __forceinline__ void walk(const UT* __restrict__ U,
                                     const int32_t* __restrict__ btilde, int32_t* out,
                                     int k0, int nt, int L, int B, int l, int b) {
  const int B1 = B + 1;
  out[k0] = l;
  for (int k = k0; k < nt - 1; ++k) {
    const int nl = static_cast<int>(U[((size_t)k * L + l) * B1 + budget_index(b, B)]);
    b -= btilde[(size_t)k * L + l];
    l = nl;
    out[k + 1] = l;
  }
}

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) & ~size_t(15); }

// Copy n bytes from global src to shared dst, where dst ≡ src (mod 16), with
// threads t = 0 … nthreads-1: bytes up to src's first 16-byte boundary, the
// aligned middle as 16-byte words, then the tail.  With ASYNC the middle
// goes by cp.async and the caller commits and waits
// (__pipeline_commit(); __pipeline_wait_prior(0)) before its barrier.
template <bool ASYNC>
__device__ __forceinline__ void stage_bytes(unsigned char* dst, const unsigned char* src,
                                            size_t n, int t, int nthreads) {
  size_t head = (16 - ((uintptr_t)src & 15)) & 15;
  if (head > n) head = n;
  for (size_t i = t; i < head; i += nthreads) dst[i] = src[i];
  const size_t nvec = (n - head) / 16;
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (size_t i = t; i < nvec; i += nthreads) {
    if (ASYNC)
      __pipeline_memcpy_async(d4 + i, s4 + i, 16);
    else
      d4[i] = __ldg(s4 + i);
  }
  for (size_t i = head + nvec * 16 + t; i < n; i += nthreads) dst[i] = src[i];
}

}  // namespace mioc
