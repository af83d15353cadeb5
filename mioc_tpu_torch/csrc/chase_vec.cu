// chase_vec — the DP path chase for one start with warp-broadcast state and
// U planes staged in shared memory, by hand for Hopper.
//
// Replaces: mioc_tpu/ops/backtrack_pallas.py::_bt_kernel_vec (the TPU chase
// selected by MIOC_CHASE=vec).  Computes exactly what chase.cu and
// mioc_tpu_torch.ops.bellman.backtrack_plain compute:
//
//   seed:  (l, b) = the flat argmin of phi0[l, b] masked to b ≤ cap (+inf
//          elsewhere), ties to the smallest flat index l·(B+1) + b, in
//          phi0's own dtype; a cap above B masks nothing;
//   step k = 0 … nt-2:  l' = U[k, l, b];  b -= b̃[k, l];  l = l'
//          (the lookup BEFORE the decrement);
//   level_idx[0] = seed l, level_idx[k+1] = l after step k.
//
// What differs from chase.cu is where the state and the planes live, as in
// the TPU kernel.  The TPU kernel keeps (l, b) as lane-broadcast vectors and
// DMAs chunks of K planes of U into VMEM, double-buffered, ahead of the walk.
// Here:
//   * (l, b) is held identically in all 32 lanes of warp 0, which walks; each
//     step's two lookups are broadcast reads of shared memory (one address for
//     the whole warp, no bank conflict), so the dependent chain never waits on
//     device memory;
//   * the other seven warps stage chunk c+1 — its K planes U[k0:k0+K] as one
//     contiguous byte range, 16-byte loads for its aligned middle, and its K
//     rows of b̃ — into the second shared buffer while warp 0 walks chunk c;
//     one __syncthreads() per chunk swaps the buffers;
//   * the level indices collect in the walking warp's lanes (lane p mod 32
//     holds index p) and leave in one coalesced 128-byte store per 32 steps,
//     the counterpart of the TPU kernel's (1, 128) index row.
//
// What bounds it on this card: the chain of nt-1 dependent steps, now at
// shared-memory latency per step instead of chase.cu's global (L2) latency,
// as long as the stagers keep ahead; they move the whole table (nt-1)·L·(B+1)
// entries through one SM, which becomes the bound when a plane is large (heat
// scale: 7.4 kB per step).  Bytes and operations of the card as a whole are
// far off: one start is one block on one SM.
//
// The chunk length K and the dynamic shared memory are chosen by the wrapper
// (mioc_tpu_torch/ops/backtrack_cuda.py::vec_chunk) with the layout below.
//
// Interface: plain C, pointers as void*, launched on the caller's stream;
// returns cudaGetLastError() after the launch (0 = launched).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // warp 0 walks, warps 1-7 stage

// Shared layout for chunks of K steps: two U buffers of round16(K·plane + 16)
// bytes (the extra 16 keep a chunk's global alignment mod 16), then two b̃
// buffers of K·L int32.
__host__ __device__ inline size_t ubuf_bytes(int K, size_t plane_bytes) {
  return mioc::round16((size_t)K * plane_bytes + 16);
}

// Offset of chunk c's first byte inside its shared buffer: the chunk's global
// address mod 16, so that the aligned middle lands on 16-byte words.
__device__ __forceinline__ size_t chunk_skew(const void* U, int c, int K,
                                             size_t plane_bytes) {
  return ((uintptr_t)U + (size_t)c * K * plane_bytes) & 15;
}

template <typename UT>
__device__ __forceinline__ void stage_chunk(unsigned char* ubuf, int32_t* bbuf,
                                            const UT* __restrict__ U,
                                            const int32_t* __restrict__ btilde, int c,
                                            int K, int nsteps, int L, size_t plane_bytes,
                                            int t, int nthreads) {
  const int k0 = c * K;
  const int kn = min(K, nsteps - k0);
  const unsigned char* src = reinterpret_cast<const unsigned char*>(U) + k0 * plane_bytes;
  mioc::stage_bytes<false>(ubuf + chunk_skew(U, c, K, plane_bytes), src,
                          (size_t)kn * plane_bytes, t, nthreads);
  const int32_t* bsrc = btilde + (size_t)k0 * L;
  for (int i = t; i < kn * L; i += nthreads) bbuf[i] = bsrc[i];
}

template <typename T, typename UT>
__global__ void __launch_bounds__(kThreads)
chase_vec_kernel(const T* __restrict__ phi0,           // (L, B+1)
                 const int32_t* __restrict__ btilde,   // (nt, L)
                 const UT* __restrict__ U,             // (nt-1, L, B+1)
                 const int32_t* __restrict__ B_dev,    // () or nullptr
                 int32_t* __restrict__ out,            // (nt,)
                 int nt, int L, int B, int B_new, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T sval[kThreads];
  __shared__ int sidx[kThreads];
  const int B1 = B + 1;
  const int cap = B_dev != nullptr ? *B_dev : B_new;
  const int flat = mioc::block_masked_argmin(phi0, L * B1, B1, cap, sval, sidx);

  const size_t plane_bytes = (size_t)L * B1 * sizeof(UT);
  const size_t ub = ubuf_bytes(K, plane_bytes);
  unsigned char* ubuf[2] = {smem, smem + ub};
  int32_t* bbuf[2] = {reinterpret_cast<int32_t*>(smem + 2 * ub),
                      reinterpret_cast<int32_t*>(smem + 2 * ub) + K * L};
  const int nsteps = nt - 1;
  const int nchunks = (nsteps + K - 1) / K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  int l = flat / B1, b = flat - l * B1;
  int mine = l;  // lane p mod 32 holds level index p; lane 0 starts with p = 0

  if (nchunks > 0)
    stage_chunk(ubuf[0], bbuf[0], U, btilde, 0, K, nsteps, L, plane_bytes, threadIdx.x,
                blockDim.x);
  __syncthreads();
  for (int c = 0; c < nchunks; ++c) {
    const int cur = c & 1;
    if (warp == 0) {
      const UT* up = reinterpret_cast<const UT*>(ubuf[cur] + chunk_skew(U, c, K, plane_bytes));
      const int32_t* bp = bbuf[cur];
      const int k0 = c * K;
      const int kn = min(K, nsteps - k0);
      for (int kk = 0; kk < kn; ++kk) {
        // The reference's index rule (common.cuh budget_index): b itself on
        // a walk from a finite seed.
        const int nl =
            static_cast<int>(up[((size_t)kk * L + l) * B1 + mioc::budget_index(b, B)]);
        b -= bp[kk * L + l];
        l = nl;
        const int p = k0 + kk + 1;
        if (lane == (p & 31)) mine = l;
        if ((p & 31) == 31) out[p - 31 + lane] = mine;
      }
    } else if (c + 1 < nchunks) {
      stage_chunk(ubuf[cur ^ 1], bbuf[cur ^ 1], U, btilde, c + 1, K, nsteps, L,
                  plane_bytes, threadIdx.x - 32, blockDim.x - 32);
    }
    __syncthreads();
  }
  if (warp == 0) {  // the last, partial group of 32 indices
    const int last = nt - 1;
    const int base = last & ~31;
    if ((last & 31) != 31 && base + lane <= last) out[base + lane] = mine;
  }
}

template <typename T, typename UT>
int launch(const void* phi0, const void* btilde, const void* U, const void* B_dev,
           void* out, int nt, int L, int B, int B_new, int K, cudaStream_t stream) {
  const size_t plane_bytes = (size_t)L * (B + 1) * sizeof(UT);
  const size_t smem = 2 * ubuf_bytes(K, plane_bytes) + 2 * (size_t)K * L * sizeof(int32_t);
  auto kern = chase_vec_kernel<T, UT>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<1, kThreads, smem, stream>>>(
      static_cast<const T*>(phi0), static_cast<const int32_t*>(btilde),
      static_cast<const UT*>(U), static_cast<const int32_t*>(B_dev),
      static_cast<int32_t*>(out), nt, L, B, B_new, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype_bytes: 4 (float) or 8 (double) for phi0; u_bytes: 1 (int8) or 4
// (int32).  B_dev: a device int32 holding the cap, or null to use B_new.  K:
// time steps per staged chunk (≥ 1).  Returns a cudaError_t value (0 =
// success); -1 for an unsupported type pair.
int mioc_chase_vec(const void* phi0, const void* btilde, const void* U, const void* B_dev,
                   void* out, int nt, int L, int B, int B_new, int K, int dtype_bytes,
                   int u_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 1) return -1;
  if (dtype_bytes == 8 && u_bytes == 1)
    return launch<double, int8_t>(phi0, btilde, U, B_dev, out, nt, L, B, B_new, K, s);
  if (dtype_bytes == 8 && u_bytes == 4)
    return launch<double, int32_t>(phi0, btilde, U, B_dev, out, nt, L, B, B_new, K, s);
  if (dtype_bytes == 4 && u_bytes == 1)
    return launch<float, int8_t>(phi0, btilde, U, B_dev, out, nt, L, B, B_new, K, s);
  if (dtype_bytes == 4 && u_bytes == 4)
    return launch<float, int32_t>(phi0, btilde, U, B_dev, out, nt, L, B, B_new, K, s);
  return -1;
}

}  // extern "C"
