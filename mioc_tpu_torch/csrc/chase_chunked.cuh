// chase_chunked.cuh — the chunked chase of state maps, shared by chase.cu
// (one table set, one row), chase_batched.cu (G table sets, R rows) and
// chase_trials.cu (S table sets of Kt rows each), and the chunk staging that
// chase_vec.cu uses too.
//
// Every row r chases the DP path of table set g(r) at its own cap:
//
//   seed:  (l, b) = the flat argmin of phi0_r[l, b] masked to b ≤ cap_r (+inf
//          elsewhere), ties to the smallest flat index l·(B+1) + b;
//   step k = 0 … nt-2:  l' = U_g[k, l, b];  b -= b̃_g[k, l];  l = l'
//          (the lookup BEFORE the decrement; a budget below 0 indexes as the
//          JAX scan chase does, common.cuh budget_index);
//   out[r, 0] = seed l, out[r, k+1] = l after step k.
//
// The rows and sets: G divides R and row r reads set g(r) = r / (R/G), so
// set g holds the R/G rows g·(R/G) … (g+1)·(R/G)-1.  G = 1 is the K caps of a
// single solve's trial wave against one build (every row on set 0); G = R is
// one table set per start; G = S with R = S·Kt is the trial wave of a
// multistart (Kt caps per start).  phi0_r is read at (r / pr)·sp: pr = 1 for
// a phi0 per row (a stride of 0 on phi0 alone still gives G = R), pr = Kt
// for one phi0 per set.  The maps below depend on U and b̃ only.
//
// The state space is finite (P = L·(B+1) states (l, b), b ∈ [0, B]) and each
// step maps states to states, so time is cut into C chunks of Tc steps and
// the chase runs in three phases of one cooperative launch:
//   A  tasks (g, c), grid-strided over the blocks that fit: stage chunk c of
//      set g into shared memory (16-byte cp.async for the planes, kept at
//      their global address mod 16), then every state walks the chunk and
//      writes its exit state to E[g, c, s] (int32, l·(B+1) + b), or the
//      sentinel -1 where its budget falls below 0 inside the chunk;
//   B  the seeds and the chains: one row (R = 1) takes the block-wide argmin
//      of block 0; more rows take one warp each (warp-wide argmin).  The row
//      then chains E[g(r), c, s_c] over the C chunks, which records entry[r,
//      c]; at a sentinel it finishes serially from that chunk's entry state
//      under the index rule and records first_bad[r] = c;
//   C  tasks (g, c) again, last first (the last one phase A staged is still
//      in shared memory): the block holding chunk c of set g re-walks it for
//      every row of set g whose first_bad lies beyond c, one thread per row
//      from its entry state, and writes out[r, cTc+1 …].  The R/G rows of a
//      set (the caps of a trial wave) share one staged chunk.
// Scratch (int32): E (G, C, P), entry (R, C), first_bad (R,).
//
// Measured (python -m mioc_tpu_torch.profile_kernels; NVIDIA H100 80GB HBM3,
// 700 W), device µs: one row (chase.cu) 13–14 at fishing, 16 at conv, 30 at
// heat scale with 32 chunks; 32 table sets at fishing (chase_batched.cu, 8
// chunks each) 36, of which phase A's walks ~10 (bound by the gathers' bank
// conflicts in shared memory) and phase C's one-thread re-walks ~7; the
// K=9 wave on one set 17–19 at fishing, 21–22 at conv; the trial wave of 32
// sets of 9 caps (chase_trials.cu) 36 at fishing, as 32 sets of one.

#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace mioc {
// Internal linkage: chase.cu, chase_batched.cu and chase_trials.cu each build
// their own library from this header, and the launcher's cached attributes belong to
// that library's kernel.  (With external linkage the dynamic loader binds the
// two libraries' function-local statics to one copy, and a launch skips
// setting its own kernel's shared-memory attribute.)
namespace {

constexpr int kChaseThreads = 1024;
constexpr int kSentinel = -1;

// Shared layout of one staged chunk of Tc steps: the U planes at the chunk's
// global address mod 16, in round16(Tc·plane + 16) bytes, then Tc rows of b̃.
__host__ __device__ inline size_t u_region(int Tc, size_t plane_bytes) {
  return round16((size_t)Tc * plane_bytes + 16);
}

__host__ __device__ inline size_t chunk_smem(int Tc, size_t plane_bytes, int L, int staged) {
  return staged ? u_region(Tc, plane_bytes) + (size_t)Tc * L * sizeof(int32_t) : 0;
}

// Where chunk c's planes and b̃ rows are read: shared memory (STAGED) or
// device memory in place.  k0: its first step; kn: its steps.  STAGED is a
// template case so that the walks' loads are shared-memory loads, not
// generic ones (a pointer that may be either compiles to generic loads).
template <typename UT>
struct ChunkView {
  const UT* up;
  const int32_t* bp;
  int k0, kn;
};

template <typename UT, bool STAGED>
__device__ __forceinline__ ChunkView<UT> chunk_view(unsigned char* smem,
                                                    const UT* __restrict__ U,
                                                    const int32_t* __restrict__ btilde,
                                                    int c, int Tc, int steps, int L, int P) {
  ChunkView<UT> v;
  v.k0 = c * Tc;
  v.kn = min(Tc, steps - v.k0);
  if constexpr (!STAGED) {
    v.up = U + (size_t)v.k0 * P;
    v.bp = btilde + (size_t)v.k0 * L;
  } else {
    const size_t plane = (size_t)P * sizeof(UT);
    const size_t skew = ((uintptr_t)U + (size_t)v.k0 * plane) & 15;
    v.up = reinterpret_cast<const UT*>(smem + skew);
    v.bp = reinterpret_cast<const int32_t*>(smem + u_region(Tc, plane));
  }
  return v;
}

// Start copying chunk c into shared memory (every thread of the block):
// cp.async, committed, not waited for.  The caller has passed a barrier since
// the last reads of the previous chunk, and waits with wait_chunk().
template <typename UT, bool STAGED>
__device__ __forceinline__ ChunkView<UT> issue_chunk(unsigned char* smem,
                                                     const UT* __restrict__ U,
                                                     const int32_t* __restrict__ btilde,
                                                     int c, int Tc, int steps, int L, int P) {
  const ChunkView<UT> v = chunk_view<UT, STAGED>(smem, U, btilde, c, Tc, steps, L, P);
  if constexpr (STAGED) {
    const size_t plane = (size_t)P * sizeof(UT);
    const unsigned char* src = reinterpret_cast<const unsigned char*>(U) + v.k0 * plane;
    stage_bytes<true>(smem + ((uintptr_t)src & 15), src, (size_t)v.kn * plane, threadIdx.x,
                      blockDim.x);
    int32_t* bs = reinterpret_cast<int32_t*>(smem + u_region(Tc, plane));
    const int32_t* bsrc = btilde + (size_t)v.k0 * L;
    for (int i = threadIdx.x; i < v.kn * L; i += blockDim.x)
      __pipeline_memcpy_async(bs + i, bsrc + i, sizeof(int32_t));
    __pipeline_commit();
  }
  return v;
}

// Wait for this thread's copies, then for the block's.
__device__ __forceinline__ void wait_chunk() {
  __pipeline_wait_prior(0);
  __syncthreads();
}

template <typename UT, bool STAGED>
__device__ __forceinline__ ChunkView<UT> stage_chunk(unsigned char* smem,
                                                     const UT* __restrict__ U,
                                                     const int32_t* __restrict__ btilde,
                                                     int c, int Tc, int steps, int L, int P) {
  const ChunkView<UT> v = issue_chunk<UT, STAGED>(smem, U, btilde, c, Tc, steps, L, P);
  wait_chunk();
  return v;
}

// Phase B of one row, on one thread: out[0], the chain over the chunks'
// maps E (C, P) of its set, entry (C,), and first_bad.
template <typename UT>
__device__ void chain_row(int flat, const int32_t* E, const UT* __restrict__ U,
                          const int32_t* __restrict__ btilde, int32_t* out, int32_t* entry,
                          int32_t* first_bad, int nt, int L, int B, int Tc, int C) {
  const int B1 = B + 1;
  const int P = L * B1;
  int s = flat;
  int bad = C;
  out[0] = s / B1;
  for (int c = 0; c < C; ++c) {
    entry[c] = s;
    const int e = __ldcg(E + (size_t)c * P + s);
    if (e == kSentinel) {
      bad = c;
      const int l = s / B1;
      walk(U, btilde, out, c * Tc, nt, L, B, l, s - l * B1);
      break;
    }
    s = e;
  }
  *first_bad = bad;
}

template <typename T, typename UT, bool STAGED>
__global__ void __launch_bounds__(kChaseThreads)
chunked_chase_kernel(const T* __restrict__ phi0,          // (R/pr, L, B+1), stride sp
                     const int32_t* __restrict__ btilde,  // (G, nt, L), stride sb
                     const UT* __restrict__ U,            // (G, nt-1, L, B+1), stride su
                     const int32_t* __restrict__ caps,    // (R,), or nullptr: cap
                     int cap,
                     int32_t* __restrict__ out,           // (R, nt)
                     int32_t* scratch,                    // E, entry, first_bad
                     int R, int G, int pr, int nt, int L, int B, int Tc, int C,
                     long long sp, long long sb, long long su) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T sval[kChaseThreads];
  __shared__ int sidx[kChaseThreads];
  const int B1 = B + 1;
  const int P = L * B1;
  const int steps = nt - 1;
  const int tasks = G * C;
  const int RG = R / G;  // rows per set
  int32_t* E = scratch;
  int32_t* entry = scratch + (size_t)tasks * P;
  int32_t* first_bad = entry + (size_t)R * C;
  int held = -1;  // the task whose chunk this block's shared memory holds

  for (int t = blockIdx.x; t < tasks; t += gridDim.x) {  // phase A
    const int g = t / C, c = t - g * C;
    const ChunkView<UT> v =
        stage_chunk<UT, STAGED>(smem, U + g * su, btilde + g * sb, c, Tc, steps, L, P);
    held = t;
    for (int s = threadIdx.x; s < P; s += blockDim.x) {
      int l = s / B1;
      int b = s - l * B1;
      for (int kk = 0; kk < v.kn; ++kk) {
        const int nl = static_cast<int>(v.up[(size_t)kk * P + l * B1 + b]);
        b -= v.bp[kk * L + l];
        l = nl;
        if (b < 0) break;
      }
      E[(size_t)t * P + s] = b < 0 ? kSentinel : l * B1 + b;
    }
    __syncthreads();  // the planes are free for the block's next chunk
  }
  cooperative_groups::this_grid().sync();

  if (R == 1) {  // phase B, one row: block 0's threads share the seed's argmin
    if (blockIdx.x == 0) {
      const int flat =
          block_masked_argmin(phi0, P, B1, caps != nullptr ? *caps : cap, sval, sidx);
      if (threadIdx.x == 0)
        chain_row(flat, E, U, btilde, out, entry, first_bad, nt, L, B, Tc, C);
    }
  } else {  // phase B, a warp per row, spread over the blocks first
    const int lane = threadIdx.x & 31;
    const int nb = gridDim.x;
    const int nwarps = nb * (kChaseThreads / 32);
    for (int r = (int)(threadIdx.x >> 5) * nb + (int)blockIdx.x; r < R; r += nwarps) {
      const int g = r / RG;
      T best;
      int bi;
      scan_masked(phi0 + (r / pr) * sp, P, B1, caps != nullptr ? caps[r] : cap, lane, 32, best,
                  bi);
      warp_argmin(best, bi);
      if (lane == 0)
        chain_row(bi, E + (size_t)g * C * P, U + g * su, btilde + g * sb, out + (size_t)r * nt,
                  entry + (size_t)r * C, first_bad + r, nt, L, B, Tc, C);
    }
  }
  cooperative_groups::this_grid().sync();

  // Phase C: this block's tasks, last first.
  const int bid = blockIdx.x, nb = gridDim.x;
  const int last = bid < tasks ? bid + (tasks - 1 - bid) / nb * nb : -1;
  for (int t = last; t >= 0; t -= nb) {
    const int g = t / C, c = t - g * C;
    const int r0 = g * RG;  // the rows of set g
    const int nr = RG;
    int need = 0;
    for (int j = threadIdx.x; j < nr && !need; j += blockDim.x)
      need = __ldcg(first_bad + r0 + j) > c;
    if (!__syncthreads_or(need)) continue;
    const UT* Ug = U + g * su;
    const int32_t* bg = btilde + g * sb;
    const ChunkView<UT> v = t == held
                                ? chunk_view<UT, STAGED>(smem, Ug, bg, c, Tc, steps, L, P)
                                : stage_chunk<UT, STAGED>(smem, Ug, bg, c, Tc, steps, L, P);
    held = t;
    for (int j = threadIdx.x; j < nr; j += blockDim.x) {
      const int r = r0 + j;
      if (__ldcg(first_bad + r) <= c) continue;
      int32_t* o = out + (size_t)r * nt + v.k0 + 1;
      const int s = __ldcg(entry + (size_t)r * C + c);
      int l = s / B1;
      int b = s - l * B1;
      for (int kk = 0; kk < v.kn; ++kk) {
        const int nl = static_cast<int>(v.up[(size_t)kk * P + l * B1 + b]);
        b -= v.bp[kk * L + l];
        l = nl;
        o[kk] = l;
      }
    }
    __syncthreads();  // the planes are free for the block's next chunk
  }
}

// Launch the chunked chase: one cooperative launch of at most the blocks
// that fit on the card at once (the blocks one SM holds at this shared
// memory, times the SMs), capped at the G·C tasks.  Both queries and the
// shared-memory attribute are kept for the last (device, smem) this kernel
// instance launched with, so a solve's repeated chases pay for them once.
// Returns a cudaError_t value (a refused cooperative launch returns its
// error).
template <typename T, typename UT, bool STAGED>
int launch_chunked_as(const void* phi0, const void* btilde, const void* U, const void* caps,
                      int cap, void* out, void* scratch, int R, int G, int pr, int nt, int L,
                      int B, int Tc, int C, long long sp, long long sb, long long su,
                      cudaStream_t stream) {
  const size_t plane = (size_t)L * (B + 1) * sizeof(UT);
  const size_t smem = chunk_smem(Tc, plane, L, STAGED);
  auto kern = chunked_chase_kernel<T, UT, STAGED>;
  static int last_dev = -1, last_blocks = 0;
  static size_t last_smem = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != last_dev || smem != last_smem) {
    int sms = 0, per_sm = 0;
    if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
      return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kChaseThreads,
                                                           smem)) != cudaSuccess)
      return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    last_dev = dev;
    last_smem = smem;
    last_blocks = per_sm * sms;
  }
  const long long tasks = (long long)G * C;
  const int grid = tasks < 1 ? 1 : tasks < last_blocks ? (int)tasks : last_blocks;
  const T* a0 = static_cast<const T*>(phi0);
  const int32_t* a1 = static_cast<const int32_t*>(btilde);
  const UT* a2 = static_cast<const UT*>(U);
  const int32_t* a3 = static_cast<const int32_t*>(caps);
  int32_t* a4 = static_cast<int32_t*>(out);
  int32_t* a5 = static_cast<int32_t*>(scratch);
  void* args[] = {&a0, &a1, &a2, &a3, &cap, &a4, &a5, &R, &G, &pr, &nt, &L, &B, &Tc, &C,
                  &sp, &sb, &su};
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(kChaseThreads), args,
                                  smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// R rows on G table sets (G divides R), phi0 of row r at (r / pr)·sp.
template <typename T, typename UT>
int launch_chunked(const void* phi0, const void* btilde, const void* U, const void* caps,
                   int cap, void* out, void* scratch, int R, int G, int pr, int nt, int L,
                   int B, int Tc, int C, int staged, long long sp, long long sb, long long su,
                   cudaStream_t stream) {
  if (R < 1 || G < 1 || R % G != 0 || pr < 1) return -1;
  return staged ? launch_chunked_as<T, UT, true>(phi0, btilde, U, caps, cap, out, scratch,
                                                  R, G, pr, nt, L, B, Tc, C, sp, sb, su, stream)
                : launch_chunked_as<T, UT, false>(phi0, btilde, U, caps, cap, out, scratch,
                                                   R, G, pr, nt, L, B, Tc, C, sp, sb, su,
                                                   stream);
}

}  // namespace
}  // namespace mioc
