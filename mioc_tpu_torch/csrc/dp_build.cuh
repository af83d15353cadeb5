// dp_build.cuh — the Bellman DP backward sweep, one start per block or one
// start per thread-block cluster.
//
// The body of the build kernel: dp_build_batched.cu launches it for S ≥ 1
// starts that share one jump table (grid S, block s on stage[s],
// btilde[s], writing U[s] and phi0[s]; or, where
// bellman_cuda.cluster_build_plan takes C > 1, grid S·C in clusters of C
// CTAs, one cluster per start, CTA k owning the budget slice [lo_k,
// hi_k)).  Each start computes exactly what
// mioc_tpu_torch.ops.bellman.build_tables_plain computes for it:
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
// The cluster form (CLUSTER), against one SM per start: Φ_i[l, b] reads
// only Φ_{i+1}[·, b − s] with 0 ≤ s ≤ smax, so the budget axis splits across
// C CTAs, each on its own SM, with an smax-wide dependency between
// neighbours.  CTA k keeps, in each Φ row, H = smax halo budgets below lo_k
// and then its slice; threads own fixed outputs of the slice as above (tpl
// and K from the slice's width), relax them with the same ascending-j loop
// and strict < on the same Φ values, so every bit of U and Φ0 is the one
// block's.  A thread whose budget lies in a higher CTA's halo also stores
// the value there (DSMEM, cluster_group::map_shared_rank; usually only CTA
// k+1's top H budgets, as smax < width), into the buffer that is the
// receiver's next Φ: the buffers swap in lockstep, so the halo being written
// is never the one being read.  A cluster barrier (release/acquire) ends the
// step in place of __syncthreads(); the staging warp arrives too, as before.
// Each CTA stages every ring row (all L entries) itself, and writes U_i and
// Φ0 for its slice.  No grid-wide barrier: clusters are independent and
// queue past the SMs.  With a slice of ~7 budgets (one start at heat scale,
// 16 CTAs) a thread relaxes one output a step, and the step is the cluster
// barrier and the halo pushes: ~2.0 µs against ~9.5 on one block (nt 500,
// B 100; profile_kernels on an H100).  A slice of half the halo or less
// pushes each output into two or more halos, one store after another: at
// nt 200, B 40 sixteen CTAs of 3 budgets take 0.422 ms on the device
// against 0.378 for eight of 6, still half one block's 0.866.
//
// NaN: the strict < ignores NaN where torch.min propagates it.  The solver
// never builds from a non-finite gradient (non-finite trials are rejected
// before they become u_old), and the tests feed finite inputs.

#pragma once

#include <cooperative_groups.h>
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

// Dynamic shared memory, in this order: the Φ double buffer (2·L·RW, rows of
// RW entries: B+1 for one block per start, the halo and the widest slice in a
// cluster), the jump table when jsmem (L·L), the stage rows of the ring
// (nbuf·R·L) and its b̃ rows (nbuf·R·L int32); nbuf = 2 when the sweep takes
// more than one chunk.
__host__ __device__ inline size_t dp_smem_bytes(int nt, int L, int RW, int R, int jsmem,
                                                int tbytes) {
  const size_t nbuf = ring_chunks(nt, R) > 1 ? 2 : 1;
  return (size_t)2 * L * RW * tbytes + (jsmem ? (size_t)L * L * tbytes : 0) +
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

// The first budget of slice k of C over the B1 = B+1 budgets (k = C: B1).
// Slices differ in width by at most one and none is empty when C ≤ B1.
__host__ __device__ inline int slice_lo(int k, int C, int B1) {
  return (int)((long long)k * B1 / C);
}

// The barrier that ends a step: the block's, or the cluster's
// (barrier.cluster.arrive.release / wait.acquire), which also orders the
// step's DSMEM halo stores before the next step's reads.
template <bool CLUSTER>
__device__ __forceinline__ void step_barrier() {
  if constexpr (CLUSTER)
    cooperative_groups::this_cluster().sync();
  else
    __syncthreads();
}

// Φ_i[l, b] = v of this CTA (rank) into the halo of every higher CTA whose
// window holds b: CTA k2 keeps budgets [lo(k2) - H, lo(k2)) in the H entries
// before its slice in each Φ row (row: the row's first entry).  lo2 is the
// next CTA's lo; the caller has checked b ≥ lo2 - H.
template <typename T>
__device__ __forceinline__ void push_halo(T* buf, int row, int b, T v, int rank, int lo2,
                                          int C, int B1, int H) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  for (int k2 = rank + 1; k2 < C && b >= lo2 - H; ++k2, lo2 = slice_lo(k2, C, B1))
    cluster.map_shared_rank(buf, k2)[row + b - lo2 + H] = v;
}

template <typename T, typename UT, int LJ, int JUMP, bool INPLACE, bool CLUSTER>
__global__ void __launch_bounds__(kMaxThreads)
dp_build_kernel(const T* __restrict__ stage,         // (S, nt, L)
                const int32_t* __restrict__ btilde,  // (S, nt, L)
                const T* __restrict__ jump,          // (L, L)
                UT* __restrict__ U,                  // (S, nt-1, L, B+1)
                T* __restrict__ phi0,                // (S, L, B+1)
                int nt, int L, int B, int smax, int R, int tpl, int K, int C, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int B1 = B + 1;
  const int P = L * B1;
  // The start and this block's budgets [lo, hi): all of them for one block
  // per start; slice `rank` of C in a cluster, whose Φ rows hold a halo of H
  // budgets below lo first (RW entries a row).  Budget b sits at b + off.
  size_t s = blockIdx.x;
  int rank = 0, lo = 0, hi = B1, RW = B1;
  if constexpr (CLUSTER) {
    rank = (int)(blockIdx.x % C);
    s = blockIdx.x / C;
    lo = slice_lo(rank, C, B1);
    hi = slice_lo(rank + 1, C, B1);
    RW = H + (B1 + C - 1) / C;
  }
  const int off = CLUSTER ? H - lo : 0;
  stage += s * nt * L;
  btilde += s * nt * L;
  U += s * (size_t)(nt - 1) * P;
  phi0 += s * P;
  const int nsteps = nt - 1;
  const int nchunks = INPLACE ? 0 : ring_chunks(nt, R);
  const int nbuf = nchunks > 1 ? 2 : 1;
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + L * RW;
  T* jsm = nxt + L * RW;
  T* ring_st = jsm + (JUMP == kJumpShared ? L * L : 0);
  int32_t* ring_bt = reinterpret_cast<int32_t*>(ring_st + (size_t)nbuf * R * L);
  const T INF = inf_of<T>();

  // Roles: threads below ncomp compute, the last warp stages ring rows.
  const int ncomp = blockDim.x - 32;
  const bool stager = threadIdx.x >= ncomp;
  const int lane = threadIdx.x - ncomp;
  // Fixed outputs: (l, lo + b0 + k·tpl), k < K, below hi.
  const bool active = threadIdx.x < L * tpl;
  const int l = active ? threadIdx.x / tpl : 0;
  const int b0 = lo + threadIdx.x - l * tpl;

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
      if (b >= hi) break;
      cur[l * RW + b + off] = (b == bt_l) ? st_l : INF;
    }
  }
  if constexpr (CLUSTER) {  // the halo's terminal entries, from device memory
    for (int e = threadIdx.x; e < L * H; e += blockDim.x) {
      const int l2 = e / H;
      const int b = lo - H + (e - l2 * H);
      if (b >= 0)
        cur[l2 * RW + b + off] = b == btilde[(size_t)(nt - 1) * L + l2]
                                     ? stage[(size_t)(nt - 1) * L + l2]
                                     : INF;
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
  // (In a cluster this barrier also makes sure that every CTA has started
  // before the first DSMEM store.)
  step_barrier<CLUSTER>();

  const int rows = INPLACE ? nsteps : R;
  const int nch = INPLACE ? (nsteps > 0 ? 1 : 0) : nchunks;
  for (int q = 0; q < nch; ++q) {
    const int qhi = nsteps - 1 - q * rows;
    const int qlo = max(0, qhi - rows + 1);
    const T* st_rows = INPLACE ? stage + (size_t)qlo * L : ring_st + (size_t)(q & 1) * R * L;
    const int32_t* bt_rows =
        INPLACE ? btilde + (size_t)qlo * L : ring_bt + (size_t)(q & 1) * R * L;
    const bool refill = !INPLACE && q + 1 < nch;
    if (stager && refill) {
      // Chunk q+1 into the other buffer: chunk q-1 left it at the barrier
      // that ended its last step.
      const int nhi = qlo - 1;
      const int nlo = max(0, nhi - R + 1);
      stage_ring_rows(ring_st + (size_t)((q + 1) & 1) * R * L,
                      ring_bt + (size_t)((q + 1) & 1) * R * L, stage, btilde, nlo, nhi,
                      L, lane);
    }
    for (int r = qhi - qlo; r >= 0; --r) {
      if (active) {
        const int i = qlo + r;
        const T st_l = st_rows[r * L + l];
        const int sh = bt_rows[r * L + l];
        T* nrow = nxt + l * RW;
        UT* Urow = U + (size_t)i * P + l * B1;
        for (int k = 0; k < K; ++k) {
          const int b = b0 + k * tpl;
          if (b >= hi) break;
          T val = INF;
          int arg = 0;
          if (sh <= smax && b >= sh) {
            const T* col = cur + (b - sh + off);
            if (JUMP == kJumpRegsAt) {
              val = col[0] + jr[0];
#pragma unroll
              for (int j = 1; j < LJ; ++j) {
                const T cand = col[j * RW] + jr[j];
                if (cand < val) {
                  val = cand;
                  arg = j;
                }
              }
            } else {
              val = col[0] + jrow[0];
              for (int j = 1; j < L; ++j) {
                const T cand = col[j * RW] + jrow[j];
                if (cand < val) {
                  val = cand;
                  arg = j;
                }
              }
            }
          }
          const T v = st_l + val;
          nrow[b + off] = v;
          Urow[b] = static_cast<UT>(arg);
          if constexpr (CLUSTER) {
            if (b >= hi - H) push_halo(nxt, l * RW, b, v, rank, hi, C, B1, H);
          }
        }
      }
      if (stager && refill && r == 0) __pipeline_wait_prior(0);
      step_barrier<CLUSTER>();  // Φ_i complete; Φ_{i+1}'s buffer is free to overwrite
      T* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
  if (active) {
    for (int k = 0; k < K; ++k) {
      const int b = b0 + k * tpl;
      if (b >= hi) break;
      phi0[l * B1 + b] = cur[l * RW + b + off];
    }
  }
}

// Launch one template case: one block per start (CLUSTER false), or a
// cluster of C CTAs per start (grid S·C, cudaLaunchKernelEx with a cluster
// dimension; C > 8 with the non-portable size allowed).  With count given,
// a cluster case launches nothing and writes the number of such clusters
// the card can hold at once (cudaOccupancyMaxActiveClusters).  The
// attributes are set at every call: no cached state, so the two libraries
// built from this header share nothing.
template <typename T, typename UT, int LJ, int JUMP, bool INPLACE, bool CLUSTER>
int launch_dp_build_case(const void* stage, const void* btilde, const void* jump, void* U,
                         void* phi0, int S, int nt, int L, int B, int smax, int R, int tpl,
                         int K, int C, int H, size_t smem, cudaStream_t stream, int* count) {
  const int threads = (L * tpl + 31) / 32 * 32 + 32;  // compute warps + the stager
  auto kern = dp_build_kernel<T, UT, LJ, JUMP, INPLACE, CLUSTER>;
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const T* a0 = static_cast<const T*>(stage);
  const int32_t* a1 = static_cast<const int32_t*>(btilde);
  const T* a2 = static_cast<const T*>(jump);
  UT* a3 = static_cast<UT*>(U);
  T* a4 = static_cast<T*>(phi0);
  if constexpr (!CLUSTER) {
    kern<<<S, threads, smem, stream>>>(a0, a1, a2, a3, a4, nt, L, B, smax, R, tpl, K, 1, 0);
  } else {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             C > 8 ? 1 : 0);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)S * C);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    if (count != nullptr)
      return (int)cudaOccupancyMaxActiveClusters(count, (const void*)kern, &cfg);
    e = cudaLaunchKernelEx(&cfg, kern, a0, a1, a2, a3, a4, nt, L, B, smax, R, tpl, K, C, H);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

#define MIOC_DP_CASE(LJ, JUMP, INPLACE)                                                  \
  return launch_dp_build_case<T, UT, LJ, JUMP, INPLACE, CLUSTER>(                        \
      stage, btilde, jump, U, phi0, S, nt, L, B, smax, R, tpl, K, C, H, smem, stream, count)

// The register cases, one per L ≤ 8, with the rows in the ring.
template <typename T, typename UT, bool CLUSTER>
int launch_dp_build_regs(const void* stage, const void* btilde, const void* jump, void* U,
                         void* phi0, int S, int nt, int L, int B, int smax, int R, int tpl,
                         int K, int C, int H, size_t smem, cudaStream_t stream, int* count) {
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
// rows in place when R = 0 and the sweep has steps (one block per start
// only).  int32 U (L > 127) never takes the register cases.
template <typename T, typename UT, bool CLUSTER>
int launch_dp_build(const void* stage, const void* btilde, const void* jump, void* U,
                    void* phi0, int S, int nt, int L, int B, int smax, int R, int jsmem,
                    int tpl, int K, int C, int H, cudaStream_t stream, int* count) {
  const int RW = CLUSTER ? H + (B + C) / C : B + 1;
  const size_t smem = dp_smem_bytes(nt, L, RW, R, jsmem, sizeof(T));
  const bool inplace = R == 0 && nt > 1;
  if (L <= kJumpRegs) {
    if constexpr (sizeof(UT) == 1) {
      if (jsmem) return -1;
      if (inplace) {  // rows in place: only L ≤ 2 (bellman_cuda.build_plan)
        if constexpr (!CLUSTER) {
          if (L == 1) MIOC_DP_CASE(1, kJumpRegsAt, true);
          if (L == 2) MIOC_DP_CASE(2, kJumpRegsAt, true);
        }
        return -1;
      }
      return launch_dp_build_regs<T, UT, CLUSTER>(stage, btilde, jump, U, phi0, S, nt, L, B,
                                                  smax, R, tpl, K, C, H, smem, stream, count);
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
// in shared memory, threads per level combination, outputs per thread); C,
// H: CTAs per start and halo budgets (bellman_cuda.batched_build_plan; C = 1
// is one block per start, an ordinary launch).  count: see
// launch_dp_build_case.  Returns a cudaError_t value (0 = success); -1 for an
// unsupported type pair or plan.
template <bool CLUSTER>
int dp_build_dispatch(const void* stage, const void* btilde, const void* jump, void* U,
                      void* phi0, int S, int nt, int L, int B, int smax, int R, int jsmem,
                      int tpl, int K, int C, int H, int dtype_bytes, int u_bytes, void* stream,
                      int* count = nullptr) {
  const int width = CLUSTER ? (B + C) / C : B + 1;  // the widest slice
  if (R < 0 || tpl < 1 || K < 1 || (long long)tpl * K < width ||
      (L * tpl + 31) / 32 * 32 + 32 > kMaxThreads || (CLUSTER != (C > 1)) || C > B + 1 ||
      C > 16 || H < 0 || (!CLUSTER && H != 0))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MIOC_DP_TYPES(TT, UU)                                                           \
  return launch_dp_build<TT, UU, CLUSTER>(stage, btilde, jump, U, phi0, S, nt, L, B, smax, \
                                          R, jsmem, tpl, K, C, H, st, count)
  if (dtype_bytes == 8 && u_bytes == 1) MIOC_DP_TYPES(double, int8_t);
  if (dtype_bytes == 8 && u_bytes == 4) MIOC_DP_TYPES(double, int32_t);
  if (dtype_bytes == 4 && u_bytes == 1) MIOC_DP_TYPES(float, int8_t);
  if (dtype_bytes == 4 && u_bytes == 4) MIOC_DP_TYPES(float, int32_t);
#undef MIOC_DP_TYPES
  return -1;
}

}  // namespace mioc
