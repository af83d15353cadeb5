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
// What bounds it: the recurrence is sequential in time, so each step is a
// round of L·(B+1) relaxations of L candidates ended by one __syncthreads().
// At small planes (fishing: 513 outputs, conv: 645) a step is latency: the
// barrier, and whatever the step has to wait for before it can relax.  The
// first design (one thread per output idx, strided) began every step with a
// load of stage[i] and b̃[i] from a row of device memory that no earlier step
// had touched, and an integer divide idx / (B+1): about 710 ns per step at
// fishing and 810 ns at conv on the H100 (chip_smoke.py).  At heat scale
// (7380 outputs, L = 36) the step is bound by one SM's shared-memory loads:
// two per relaxation, the Φ column entry and the jump entry.
//
// The design, against those:
//   * Staged rows.  The stage and b̃ rows sit in a ring in shared memory,
//     chunks of R time rows, double-buffered.  The last warp of the block
//     stages chunk q+1 with cp.async while the other warps sweep chunk q, and
//     waits for its copies before the barrier that ends chunk q's last step,
//     so a step keeps its single barrier and its compute threads read only
//     shared memory and registers.  Where the whole (nt-1) × L fits (fishing,
//     conv) R = nt-1 and the rows are staged once, before the sweep.  R = 0
//     reads the rows in place: only for the four (L ≤ 2) planes at the very
//     edge of the shared-memory limit where not even two ring rows fit.
//   * Fixed outputs per thread.  Thread t owns one level combination
//     l = t / tpl and the budgets b = t mod tpl + k·tpl, k < K: every output
//     of a thread shares one l, so one stage entry, one b̃ entry and one jump
//     row serve all of them, and the divide happens once, before the sweep.
//     With L ≤ 8 (kJumpRegs) the row jump[l, :] is held in registers, which
//     halves the shared-memory loads of a relaxation; above that it is read
//     from shared memory (or, where the ring needs its room, through the
//     read-only cache).
//   * Stores as before: U_i streams to device memory unpadded (nt-1, L, B+1),
//     int8 when L ≤ 127, coalesced (neighbouring threads, neighbouring b);
//     Φ stays double-buffered in shared memory.
// The wrapper (mioc_tpu_torch/ops/bellman_cuda.py::build_plan) picks R, the
// jump table's place, tpl and K; dp_smem_bytes below is the layout it sizes.
//
// What bounds it now (python -m mioc_tpu_torch.profile_kernels; NVIDIA H100
// 80GB HBM3, 700 W, SM clock 1980 MHz, float64): fishing 366 ns per step,
// conv 495.  A step with neither the relaxation nor the U store still takes
// 230 and 260 ns: the chain from the staged row through the Φ store to the
// barrier (the barrier itself 45–80 ns); fewer threads with more outputs
// each are slower, not faster (512 or 256 per block: 4–53% longer).  At
// fishing the relaxation adds 80 ns and the U store 70.
// At heat scale the relaxation's shared-memory loads are the time (17.6 ms;
// 1.5 ms without them).
//
// NaN: the strict < ignores NaN where torch.min propagates it.  The solver
// never builds from a non-finite gradient (non-finite trials are rejected
// before they become u_old), and the tests feed finite inputs.

#pragma once

#include <cuda_pipeline.h>

#include "common.cuh"

namespace mioc {

constexpr int kJumpRegs = 8;      // L ≤ 8: the row jump[l, :] lives in registers
constexpr int kMaxThreads = 1024;  // compute warps + the staging warp, at most

// Chunks of R rows over the nt-1 sweep steps (R = 0: the rows in place).
__host__ __device__ inline int ring_chunks(int nt, int R) {
  const int steps = nt - 1;
  return (steps > 0 && R > 0) ? (steps + R - 1) / R : 0;
}

// Dynamic shared memory, in this order: the Φ double buffer (2·P), the jump
// table when jsmem (L·L), the stage rows of the ring (nbuf·R·L) and its b̃
// rows (nbuf·R·L int32); nbuf = 2 when the sweep takes more than one chunk.
__host__ __device__ inline size_t dp_smem_bytes(int nt, int L, int B, int R, int jsmem,
                                                int tbytes) {
  const size_t nbuf = ring_chunks(nt, R) > 1 ? 2 : 1;
  return (size_t)2 * L * (B + 1) * tbytes + (jsmem ? (size_t)L * L * tbytes : 0) +
         (R > 0 ? nbuf * R * L * (tbytes + 4) : 0);
}

// Rows lo … hi of stage and b̃ into one ring buffer, by the staging warp's 32
// lanes, as cp.async of one element each (a row of L elements has no 16-byte
// alignment in general); the caller commits and waits.
template <typename T>
__device__ __forceinline__ void stage_ring_rows(T* st_buf, int32_t* bt_buf,
                                                const T* __restrict__ stage,
                                                const int32_t* __restrict__ btilde,
                                                int lo, int hi, int L, int lane) {
  const int n = (hi - lo + 1) * L;
  const T* st = stage + (size_t)lo * L;
  const int32_t* bt = btilde + (size_t)lo * L;
  for (int e = lane; e < n; e += 32) {
    __pipeline_memcpy_async(st_buf + e, st + e, sizeof(T));
    __pipeline_memcpy_async(bt_buf + e, bt + e, sizeof(int32_t));
  }
  __pipeline_commit();
}

// Where a thread's jump row is read: registers (L ≤ 8, unrolled over the
// exact L = LJ), shared memory, or device memory through the read-only
// cache.  Each is a template case, so every load has its address space known
// at compile time (a pointer that may be either is a slower generic load).
enum JumpAt { kJumpRegsAt = 0, kJumpShared = 1, kJumpGlobal = 2 };

template <typename T, typename UT, int LJ, int JUMP, bool INPLACE>
__global__ void __launch_bounds__(kMaxThreads)
dp_build_kernel(const T* __restrict__ stage,         // (S, nt, L)
                const int32_t* __restrict__ btilde,  // (S, nt, L)
                const T* __restrict__ jump,          // (L, L)
                UT* __restrict__ U,                  // (S, nt-1, L, B+1)
                T* __restrict__ phi0,                // (S, L, B+1)
                int nt, int L, int B, int smax, int R, int tpl, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int B1 = B + 1;
  const int P = L * B1;
  const size_t s = blockIdx.x;
  stage += s * nt * L;
  btilde += s * nt * L;
  U += s * (size_t)(nt - 1) * P;
  phi0 += s * P;
  const int nsteps = nt - 1;
  const int nchunks = INPLACE ? 0 : ring_chunks(nt, R);
  const int nbuf = nchunks > 1 ? 2 : 1;
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + P;
  T* jsm = nxt + P;
  T* ring_st = jsm + (JUMP == kJumpShared ? L * L : 0);
  int32_t* ring_bt = reinterpret_cast<int32_t*>(ring_st + (size_t)nbuf * R * L);
  const T INF = inf_of<T>();

  // Roles: threads below ncomp compute, the last warp stages ring rows.
  const int ncomp = blockDim.x - 32;
  const bool stager = threadIdx.x >= ncomp;
  const int lane = threadIdx.x - ncomp;
  // Fixed outputs: (l, b0 + k·tpl), k < K, b ≤ B.
  const bool active = threadIdx.x < L * tpl;
  const int l = active ? threadIdx.x / tpl : 0;
  const int b0 = threadIdx.x - l * tpl;

  if (JUMP == kJumpShared)
    for (int idx = threadIdx.x; idx < L * L; idx += blockDim.x) jsm[idx] = jump[idx];
  const T* jrow = (JUMP == kJumpShared ? jsm : jump) + l * L;
  T jr[LJ > 0 ? LJ : 1];
  if (JUMP == kJumpRegsAt) {
#pragma unroll
    for (int j = 0; j < LJ; ++j) jr[j] = jump[l * LJ + j];
  }

  // Terminal layer: exact-budget seed.
  if (active) {
    const T st_l = stage[(size_t)(nt - 1) * L + l];
    const int bt_l = btilde[(size_t)(nt - 1) * L + l];
    for (int k = 0; k < K; ++k) {
      const int b = b0 + k * tpl;
      if (b > B) break;
      cur[l * B1 + b] = (b == bt_l) ? st_l : INF;
    }
  }
  // Chunk 0 of the ring, by every thread, before the sweep.
  if (nchunks > 0) {
    const int lo0 = max(0, nsteps - R);
    const int n0 = (nsteps - lo0) * L;
    for (int e = threadIdx.x; e < n0; e += blockDim.x) {
      ring_st[e] = stage[(size_t)lo0 * L + e];
      ring_bt[e] = btilde[(size_t)lo0 * L + e];
    }
  }
  __syncthreads();

  const int rows = INPLACE ? nsteps : R;
  const int nch = INPLACE ? (nsteps > 0 ? 1 : 0) : nchunks;
  for (int q = 0; q < nch; ++q) {
    const int hi = nsteps - 1 - q * rows;
    const int lo = max(0, hi - rows + 1);
    const T* st_rows = INPLACE ? stage + (size_t)lo * L : ring_st + (size_t)(q & 1) * R * L;
    const int32_t* bt_rows =
        INPLACE ? btilde + (size_t)lo * L : ring_bt + (size_t)(q & 1) * R * L;
    const bool refill = !INPLACE && q + 1 < nch;
    if (stager && refill) {
      // Chunk q+1 into the other buffer: chunk q-1 left it at the barrier
      // that ended its last step.
      const int nhi = lo - 1;
      const int nlo = max(0, nhi - R + 1);
      stage_ring_rows(ring_st + (size_t)((q + 1) & 1) * R * L,
                      ring_bt + (size_t)((q + 1) & 1) * R * L, stage, btilde, nlo, nhi,
                      L, lane);
    }
    for (int r = hi - lo; r >= 0; --r) {
      if (active) {
        const int i = lo + r;
        const T st_l = st_rows[r * L + l];
        const int sh = bt_rows[r * L + l];
        T* nrow = nxt + l * B1;
        UT* Urow = U + (size_t)i * P + l * B1;
        for (int k = 0; k < K; ++k) {
          const int b = b0 + k * tpl;
          if (b > B) break;
          T val = INF;
          int arg = 0;
          if (sh <= smax && b >= sh) {
            const T* col = cur + (b - sh);
            if (JUMP == kJumpRegsAt) {
              val = col[0] + jr[0];
#pragma unroll
              for (int j = 1; j < LJ; ++j) {
                const T cand = col[j * B1] + jr[j];
                if (cand < val) {
                  val = cand;
                  arg = j;
                }
              }
            } else {
              val = col[0] + jrow[0];
              for (int j = 1; j < L; ++j) {
                const T cand = col[j * B1] + jrow[j];
                if (cand < val) {
                  val = cand;
                  arg = j;
                }
              }
            }
          }
          nrow[b] = st_l + val;
          Urow[b] = static_cast<UT>(arg);
        }
      }
      if (stager && refill && r == 0) __pipeline_wait_prior(0);
      __syncthreads();  // Φ_i complete; Φ_{i+1}'s buffer is free to overwrite
      T* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
  if (active) {
    for (int k = 0; k < K; ++k) {
      const int b = b0 + k * tpl;
      if (b > B) break;
      phi0[l * B1 + b] = cur[l * B1 + b];
    }
  }
}

template <typename T, typename UT, int LJ, int JUMP, bool INPLACE>
int launch_dp_build_case(const void* stage, const void* btilde, const void* jump, void* U,
                         void* phi0, int S, int nt, int L, int B, int smax, int R, int tpl,
                         int K, size_t smem, cudaStream_t stream) {
  const int threads = (L * tpl + 31) / 32 * 32 + 32;  // compute warps + the stager
  auto kern = dp_build_kernel<T, UT, LJ, JUMP, INPLACE>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<S, threads, smem, stream>>>(
      static_cast<const T*>(stage), static_cast<const int32_t*>(btilde),
      static_cast<const T*>(jump), static_cast<UT*>(U), static_cast<T*>(phi0),
      nt, L, B, smax, R, tpl, K);
  return (int)cudaGetLastError();
}

#define MIOC_DP_CASE(LJ, JUMP, INPLACE)                                                 \
  return launch_dp_build_case<T, UT, LJ, JUMP, INPLACE>(stage, btilde, jump, U, phi0, S, \
                                                        nt, L, B, smax, R, tpl, K, smem, \
                                                        stream)

// The register cases, one per L ≤ 8, with the rows in the ring.
template <typename T, typename UT>
int launch_dp_build_regs(const void* stage, const void* btilde, const void* jump, void* U,
                         void* phi0, int S, int nt, int L, int B, int smax, int R, int tpl,
                         int K, size_t smem, cudaStream_t stream) {
  switch (L) {
    case 1: MIOC_DP_CASE(1, kJumpRegsAt, false);
    case 2: MIOC_DP_CASE(2, kJumpRegsAt, false);
    case 3: MIOC_DP_CASE(3, kJumpRegsAt, false);
    case 4: MIOC_DP_CASE(4, kJumpRegsAt, false);
    case 5: MIOC_DP_CASE(5, kJumpRegsAt, false);
    case 6: MIOC_DP_CASE(6, kJumpRegsAt, false);
    case 7: MIOC_DP_CASE(7, kJumpRegsAt, false);
    case 8: MIOC_DP_CASE(8, kJumpRegsAt, false);
    default: return -1;
  }
}

// The template case of a plan: the jump row's place from L and jsmem, the
// rows in place when R = 0 and the sweep has steps.  int32 U (L > 127) never
// takes the register cases.
template <typename T, typename UT>
int launch_dp_build(const void* stage, const void* btilde, const void* jump, void* U,
                    void* phi0, int S, int nt, int L, int B, int smax, int R, int jsmem,
                    int tpl, int K, cudaStream_t stream) {
  const size_t smem = dp_smem_bytes(nt, L, B, R, jsmem, sizeof(T));
  const bool inplace = R == 0 && nt > 1;
  if (L <= kJumpRegs) {
    if constexpr (sizeof(UT) == 1) {
      if (jsmem) return -1;
      if (inplace) {  // rows in place: only L ≤ 2 (bellman_cuda.build_plan)
        if (L == 1) MIOC_DP_CASE(1, kJumpRegsAt, true);
        if (L == 2) MIOC_DP_CASE(2, kJumpRegsAt, true);
        return -1;
      }
      return launch_dp_build_regs<T, UT>(stage, btilde, jump, U, phi0, S, nt, L, B, smax,
                                         R, tpl, K, smem, stream);
    }
    return -1;
  }
  if (inplace) return -1;
  if (jsmem) MIOC_DP_CASE(0, kJumpShared, false);
  MIOC_DP_CASE(0, kJumpGlobal, false);
}

#undef MIOC_DP_CASE

// dtype_bytes: 4 (float) or 8 (double); u_bytes: 1 (int8) or 4 (int32).  R,
// jsmem, tpl, K: the plan of bellman_cuda.build_plan (ring rows, jump table
// in shared memory, threads per level combination, outputs per thread).
// Returns a cudaError_t value (0 = success); -1 for an unsupported type pair
// or plan.
inline int dp_build_dispatch(const void* stage, const void* btilde, const void* jump,
                             void* U, void* phi0, int S, int nt, int L, int B, int smax,
                             int R, int jsmem, int tpl, int K, int dtype_bytes,
                             int u_bytes, void* stream) {
  if (R < 0 || tpl < 1 || K < 1 || (long long)tpl * K < B + 1 ||
      (L * tpl + 31) / 32 * 32 + 32 > kMaxThreads)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_bytes == 8 && u_bytes == 1)
    return launch_dp_build<double, int8_t>(stage, btilde, jump, U, phi0, S, nt, L, B, smax, R, jsmem, tpl, K, st);
  if (dtype_bytes == 8 && u_bytes == 4)
    return launch_dp_build<double, int32_t>(stage, btilde, jump, U, phi0, S, nt, L, B, smax, R, jsmem, tpl, K, st);
  if (dtype_bytes == 4 && u_bytes == 1)
    return launch_dp_build<float, int8_t>(stage, btilde, jump, U, phi0, S, nt, L, B, smax, R, jsmem, tpl, K, st);
  if (dtype_bytes == 4 && u_bytes == 4)
    return launch_dp_build<float, int32_t>(stage, btilde, jump, U, phi0, S, nt, L, B, smax, R, jsmem, tpl, K, st);
  return -1;
}

}  // namespace mioc
