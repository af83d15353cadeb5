// chase_vec — the DP path chase for one start in one thread-block cluster,
// the table held in the cluster's distributed shared memory, by hand for
// Hopper.
//
// Replaces: mioc_tpu/ops/backtrack_pallas.py::_bt_kernel_vec (the TPU chase
// selected by MIOC_CHASE=vec).  Computes exactly what chase.cu and
// mioc_tpu_torch.ops.bellman.backtrack_plain compute:
//
//   seed:  (l, b) = the flat argmin of phi0[l, b] masked to b ≤ cap (+inf
//          elsewhere), ties to the smallest flat index l·(B+1) + b, in
//          phi0's own dtype; a cap above B masks nothing;
//   step k = 0 … nt-2:  l' = U[k, l, b];  b -= b̃[k, l];  l = l'
//          (the lookup BEFORE the decrement; a budget below 0 indexes as the
//          JAX scan chase does, common.cuh budget_index);
//   level_idx[0] = seed l, level_idx[k+1] = l after step k.
//
// A second Hopper design of chase.cu's function.  chase.cu spreads ~32
// chunks over the card in a cooperative launch and keeps its state maps in
// device memory; here one cluster of N CTAs (16 where the card schedules
// it, else 8) holds the whole table in its shared memory, in an ordinary
// launch (cudaLaunchKernelEx with a cluster dimension), with no grid barrier
// and no global scratch:
//   1  CTA i owns slice i of the time axis (Ts steps).  It stages the
//      slice's U planes and b̃ rows once (16-byte cp.async, planes kept at
//      their global address mod 16), and its threads build the state maps of
//      the slice's W sub-chunks (Tw steps each): every state (l, b) walks the
//      sub-chunk, four walks per thread side by side, and its exit state, or
//      the sentinel -1 where its budget falls below 0, goes to E[w, s] in the
//      CTA's shared memory; the W maps composed give the slice's map.  While
//      its copies are in flight, warp 0 of each CTA takes the masked argmin
//      of its share of phi0 and stores it into CTA 0's shared memory
//      (distributed shared memory, DSMEM).
//   2  cluster.sync(); then the chain, passed from CTA to CTA: CTA 0 combines
//      the N shares into the seed (ties to the smallest flat index), and the
//      CTA that holds a slice's entry state looks its exit up in its own
//      slice map and stores it into the mailbox of the next slice's owner
//      (one DSMEM store per slice: a one-way trip, where reading the next
//      map from CTA 0 would be a round trip).  A CTA waits on its mailbox
//      in its own shared memory.  At a sentinel the owner passes "skip" on
//      and finishes the path serially from its slice's entry on device
//      memory, under the index rule.
//   3  once its entry state is in, each CTA re-walks its slice, one warp per
//      sub-chunk: the warp takes the entry through the earlier sub-chunks'
//      maps and re-walks the sub-chunk in the staged planes with (l, b) held
//      in all 32 lanes (the TPU kernel's lane-broadcast state: each lookup
//      is a broadcast shared-memory read), the indices collected one per lane
//      and stored 32 at a time.  Its walk overlaps the chain's later hops.
//   No DSMEM access targets a CTA that may have finished: the shares are
//   stored before the cluster.sync(), and a mailbox store goes to a CTA
//   that is still waiting for it.
// Where the table is larger than the cluster's shared memory (heat scale:
// 1023 planes of 7.4 kB) the CTAs take the slices in Q rounds (slice j =
// q·N + i for CTA i), with one sub-chunk per slice and the maps in device
// memory, as chase.cu keeps them; the re-walk re-stages all but the last
// slice.  Where not even one plane fits, the planes are read in place.
//
// What bounds it on this card: the chain's N·Q one-way DSMEM hops, phase
// 1's walks (P·Ts shared-memory gathers per SM, bank conflicts their limit)
// and one sub-chunk's re-walk at shared-memory latency, and the staging of a
// slice per SM.  STAGED is a template case, so that the walks' loads are
// shared-memory loads, not generic ones.  The wrapper
// (mioc_tpu_torch/ops/backtrack_cuda.py::vec_plan) picks N, the slices and
// the sub-chunks, with the shared layout below.
//
// Measured (python -m mioc_tpu_torch.profile_kernels; NVIDIA H100 80GB HBM3,
// 700 W), device µs with 16 CTAs: 12 at fishing, 16 at conv (chase.cu: 13–14
// and 16), 68 at heat scale in 3 rounds (chase.cu: 30); with 8 CTAs 12–13,
// 19 and 107.  A chain hop costs ~0.3 µs; phase 1's maps 3 µs at fishing and
// 6 at conv.
//
// Interface: plain C, pointers as void*, launched on the caller's stream;
// returns the launch's cudaError_t (0 = launched).

#include <cooperative_groups.h>

#include "chase_chunked.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWalks = 4;     // map walks a thread runs side by side
constexpr int kMaxN = 16;     // CTAs in a cluster, at most
constexpr int kEmpty = INT_MIN;  // a mailbox not written yet
constexpr int kSkip = -2;     // the path left the maps upstream: no re-walk

// Shared layout of a CTA: the staged slice (chase_chunked.cuh chunk_smem:
// planes, then b̃ rows), then, where the maps stay in shared memory, the W
// sub-chunk maps E (W, P) and (W > 1) the slice map Ec (P,), then the Q
// mailboxes (the entry states of this CTA's slices).  Byte offsets.
struct VecLayout {
  size_t e, ec, entry, total;
};

__host__ __device__ inline VecLayout vec_layout(int Ts, size_t plane_bytes, int L, int P,
                                                int W, int Q, int staged, int maps_in_smem) {
  VecLayout v;
  v.e = mioc::chunk_smem(Ts, plane_bytes, L, staged);
  v.ec = v.e + (maps_in_smem ? (size_t)W * P * sizeof(int32_t) : 0);
  v.entry = v.ec + (maps_in_smem && W > 1 ? (size_t)P * sizeof(int32_t) : 0);
  v.total = v.entry + (size_t)Q * sizeof(int32_t);
  return v;
}

// Sub-chunk w of slice j: its first step k0 and its step count (≤ 0: empty).
__device__ __forceinline__ int sub_chunk(int j, int w, int Ts, int Tw, int steps, int& k0) {
  k0 = j * Ts + w * Tw;
  return min(min(Tw, (j + 1) * Ts - k0), steps - k0);
}

// The address of p (in this CTA's shared memory) in CTA rank's shared
// memory, and stores to such an address (DSMEM).
__device__ __forceinline__ uint32_t remote(const void* p, int rank) {
  uint32_t a;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(a)
      : "r"((uint32_t)__cvta_generic_to_shared(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void st_remote(uint32_t a, int v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ void st_remote(uint32_t a, float v) {
  st_remote(a, __float_as_int(v));
}

__device__ __forceinline__ void st_remote(uint32_t a, double v) {
  asm volatile("st.shared::cluster.u64 [%0], %1;" ::"r"(a), "l"(__double_as_longlong(v))
               : "memory");
}

// A mailbox store to another CTA, and the wait on one's own mailbox.
__device__ __forceinline__ void post(uint32_t a, int v) {
  asm volatile("st.relaxed.cluster.shared::cluster.u32 [%0], %1;" ::"r"(a), "r"(v)
               : "memory");
}

__device__ __forceinline__ int wait_mail(const int32_t* box) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(box);
  int v;
  do {
    asm volatile("ld.relaxed.cluster.shared::cta.u32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  } while (v == kEmpty);
  return v;
}

template <typename T, typename UT, bool STAGED>
__global__ void __launch_bounds__(kThreads)
chase_vec_kernel(const T* __restrict__ phi0,           // (L, B+1)
                 const int32_t* __restrict__ btilde,   // (nt, L)
                 const UT* __restrict__ U,             // (nt-1, L, B+1)
                 const int32_t* __restrict__ B_dev,    // () or nullptr
                 int32_t* __restrict__ out,            // (nt,)
                 int32_t* Eg,  // slice maps (N·Q, P) in device memory, unless in shared
                 int nt, int L, int B, int B_new, int Q, int Ts, int W, int Tw,
                 int maps_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T share_val[kMaxN];  // CTA 0: each CTA's share of the seed's argmin
  __shared__ int share_idx[kMaxN];
  cg::cluster_group cluster = cg::this_cluster();
  const int N = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int B1 = B + 1;
  const int P = L * B1;
  const int steps = nt - 1;
  const VecLayout lay = vec_layout(Ts, (size_t)P * sizeof(UT), L, P, W, Q, STAGED,
                                   maps_in_smem);
  if (maps_in_smem) Eg = nullptr;
  int32_t* Es = reinterpret_cast<int32_t*>(smem + lay.e);   // (W, P)
  int32_t* Ec = W > 1 ? reinterpret_cast<int32_t*>(smem + lay.ec) : Es;  // (P,)
  int32_t* entry = reinterpret_cast<int32_t*>(smem + lay.entry);  // (Q,) mailboxes
  for (int q = threadIdx.x; q < Q; q += kThreads) entry[q] = kEmpty;

  // Warp 0 of each CTA takes the argmin of its share of the masked phi0
  // (ties to the smallest flat index) and stores it into CTA 0.
  auto seed_share = [&]() {
    if (threadIdx.x < 32) {
      const int cap = B_dev != nullptr ? *B_dev : B_new;
      const int share = (P + N - 1) / N;
      const int hi = min(P, (rank + 1) * share);
      const T INF = mioc::inf_of<T>();
      T best = INF;
      int bi = INT_MAX;
      for (int idx = rank * share + threadIdx.x; idx < hi; idx += 32) {
        const T val = idx % B1 <= cap ? phi0[idx] : INF;
        if (mioc::better(val, idx, best, bi)) {
          best = val;
          bi = idx;
        }
      }
      mioc::warp_argmin(best, bi);
      if (threadIdx.x == 0) {
        st_remote(remote(share_val + rank, 0), best);
        st_remote(remote(share_idx + rank, 0), bi);
      }
    }
  };

  // Phase 1: the maps of this CTA's slices, a round each.  A thread walks
  // kWalks consecutive states of one sub-chunk side by side, so that their
  // shared-memory latencies overlap and they share the step's addresses; a
  // walk whose budget falls below 0 is marked dead and goes on from budget
  // 0 (valid loads, no branch; its map entry is the sentinel).  Then the
  // slice map: the sub-chunk maps composed (a sentinel stays one).
  bool seeded = false;
  int held = -1;  // the round whose slice the shared memory holds
  const int groups = (P + kWalks - 1) / kWalks;  // walk groups per sub-chunk
  for (int q = 0; q < Q; ++q) {
    const int j = q * N + rank;
    if (j * Ts >= steps) break;  // this and later slices lie past the end
    const mioc::ChunkView<UT> v =
        mioc::issue_chunk<UT, STAGED>(smem, U, btilde, j, Ts, steps, L, P);
    if (!seeded) {  // while the copies are in flight
      seed_share();
      seeded = true;
    }
    mioc::wait_chunk();
    held = q;
    int32_t* E = Eg != nullptr ? Eg + (size_t)j * P : Es;  // W = 1 where in device memory
    for (int t = threadIdx.x; t < W * groups; t += kThreads) {
      const int w = t / groups, g = t - w * groups;
      int k0;
      const int kn = sub_chunk(j, w, Ts, Tw, steps, k0);
      if (kn <= 0) continue;
      const UT* up = v.up + (size_t)(k0 - v.k0) * P;
      const int32_t* bp = v.bp + (k0 - v.k0) * L;
      int l[kWalks], b[kWalks];
      bool dead[kWalks];
#pragma unroll
      for (int m = 0; m < kWalks; ++m) {
        const int s = min(g * kWalks + m, P - 1);  // a short last group repeats a walk
        l[m] = s / B1;
        b[m] = s - l[m] * B1;
        dead[m] = false;
      }
      for (int kk = 0; kk < kn; ++kk) {
        const UT* upk = up + (size_t)kk * P;
        const int32_t* bpk = bp + kk * L;
#pragma unroll
        for (int m = 0; m < kWalks; ++m) {
          const int nl = static_cast<int>(upk[l[m] * B1 + b[m]]);
          const int nb = b[m] - bpk[l[m]];
          dead[m] |= nb < 0;
          l[m] = nl;
          b[m] = max(nb, 0);
        }
      }
      int32_t* Ew = E + (size_t)w * P;
#pragma unroll
      for (int m = 0; m < kWalks; ++m) {
        const int s = g * kWalks + m;
        if (s < P) Ew[s] = dead[m] ? mioc::kSentinel : l[m] * B1 + b[m];
      }
    }
    if (W > 1) {
      __syncthreads();
      for (int s = threadIdx.x; s < P; s += kThreads) {
        int x = s;
        for (int w = 0; w < W && x != mioc::kSentinel; ++w) {
          int k0;
          if (sub_chunk(j, w, Ts, Tw, steps, k0) <= 0) break;
          x = Es[(size_t)w * P + x];
        }
        Ec[s] = x;
      }
    }
    __syncthreads();  // the planes are free for the next round
  }
  if (!seeded) seed_share();  // no slice to stage (nt = 1, or N > nt-1)
  cluster.sync();  // the shares, the maps and the empty mailboxes are in place

  // Phase 2: the chain.  CTA 0 takes the seed; each CTA's thread 0 waits for
  // the entry state of each of its slices in turn, looks its exit up and
  // posts it to the next slice's owner.
  if (threadIdx.x == 0) {
    if (rank == 0) {
      T best = mioc::inf_of<T>();
      int s = INT_MAX;
      for (int r = 0; r < N; ++r) {
        if (mioc::better(share_val[r], share_idx[r], best, s)) {
          best = share_val[r];
          s = share_idx[r];
        }
      }
      out[0] = s / B1;
      if (steps > 0) entry[0] = s;
    }
    for (int q = 0; q < Q; ++q) {
      const int j = q * N + rank;
      if (j * Ts >= steps) break;
      const int s = wait_mail(entry + q);
      int e = kSkip;
      if (s != kSkip) {
        e = Eg != nullptr ? __ldcg(Eg + (size_t)j * P + s) : Ec[s];
        if (e == mioc::kSentinel) e = kSkip;
      }
      const int next = j + 1;
      if (next * Ts < steps) post(remote(entry + next / N, next % N), e);
      if (s != kSkip && e == kSkip) {  // the path leaves the maps in this slice
        const int l = s / B1;
        mioc::walk(U, btilde, out, j * Ts, nt, L, B, l, s - l * B1);
        entry[q] = kSkip;
      }
    }
  }
  __syncthreads();

  // Phase 3: the re-walk of each slice whose entry state is in, the last
  // staged first, a warp per sub-chunk with the state broadcast in its
  // lanes; a sub-chunk's entry is the slice's, through the earlier
  // sub-chunks' maps.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int q = Q - 1; q >= 0; --q) {
    const int j = q * N + rank;
    if (j * Ts >= steps || entry[q] == kSkip) continue;
    const mioc::ChunkView<UT> v =
        q == held ? mioc::chunk_view<UT, STAGED>(smem, U, btilde, j, Ts, steps, L, P)
                  : mioc::stage_chunk<UT, STAGED>(smem, U, btilde, j, Ts, steps, L, P);
    held = q;
    for (int w = warp; w < W; w += kThreads / 32) {
      int k0;
      const int kn = sub_chunk(j, w, Ts, Tw, steps, k0);
      if (kn <= 0) continue;
      int s = entry[q];
      for (int u = 0; u < w; ++u) s = Es[(size_t)u * P + s];
      const UT* up = v.up + (size_t)(k0 - v.k0) * P;
      const int32_t* bp = v.bp + (k0 - v.k0) * L;
      int l = s / B1;
      int b = s - l * B1;
      int mine = 0;  // lane p mod 32 holds level index p
      for (int kk = 0; kk < kn; ++kk) {
        const int nl = static_cast<int>(up[(size_t)kk * P + l * B1 + b]);
        b -= bp[kk * L + l];
        l = nl;
        const int p = k0 + kk + 1;
        if (lane == (p & 31)) mine = l;
        if ((p & 31) == 31 || kk == kn - 1) {
          const int i = (p & ~31) + lane;
          if (i > k0 && i <= p) out[i] = mine;
        }
      }
    }
    __syncthreads();  // the planes are free for the next slice
  }
}

// Set the kernel's attributes for a cluster of N CTAs with smem bytes of
// dynamic shared memory, and fill cfg (attr must outlive cfg's use).  The
// attributes are set again only when (device, smem, N) changes.
template <typename T, typename UT, bool STAGED>
cudaError_t configure(int N, size_t smem, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute& attr) {
  auto kern = chase_vec_kernel<T, UT, STAGED>;
  static int last_dev = -1, last_N = 0;
  static size_t last_smem = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != last_dev || smem != last_smem || N != last_N) {
    if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
      return e;
    if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed,
                                  N > 8 ? 1 : 0)) != cudaSuccess)
      return e;
    last_dev = dev;
    last_smem = smem;
    last_N = N;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(N);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = N;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

size_t plan_smem(int L, int B, int Q, int Ts, int W, int staged, int maps_in_smem,
                 int u_bytes) {
  const int P = L * (B + 1);
  return vec_layout(Ts, (size_t)P * u_bytes, L, P, W, Q, staged, maps_in_smem).total;
}

template <typename T, typename UT, bool STAGED>
int clusters_as(int N, size_t smem, int* count) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure<T, UT, STAGED>(N, smem, nullptr, cfg, attr);
  if (e != cudaSuccess) return (int)e;
  auto kern = chase_vec_kernel<T, UT, STAGED>;
  return (int)cudaOccupancyMaxActiveClusters(count, (const void*)kern, &cfg);
}

template <typename T, typename UT>
int clusters(int N, size_t smem, int staged, int* count) {
  return staged ? clusters_as<T, UT, true>(N, smem, count)
                : clusters_as<T, UT, false>(N, smem, count);
}

template <typename T, typename UT, bool STAGED>
int launch_as(const void* phi0, const void* btilde, const void* U, const void* B_dev,
              void* out, void* maps, int nt, int L, int B, int B_new, int N, int Q, int Ts,
              int W, int Tw, int maps_in_smem, cudaStream_t stream) {
  const size_t smem = plan_smem(L, B, Q, Ts, W, STAGED, maps_in_smem, sizeof(UT));
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure<T, UT, STAGED>(N, smem, stream, cfg, attr);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, chase_vec_kernel<T, UT, STAGED>, static_cast<const T*>(phi0),
                         static_cast<const int32_t*>(btilde), static_cast<const UT*>(U),
                         static_cast<const int32_t*>(B_dev), static_cast<int32_t*>(out),
                         static_cast<int32_t*>(maps), nt, L, B, B_new, Q, Ts, W, Tw,
                         maps_in_smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, typename UT>
int launch(const void* phi0, const void* btilde, const void* U, const void* B_dev, void* out,
           void* maps, int nt, int L, int B, int B_new, int N, int Q, int Ts, int W, int Tw,
           int staged, int maps_in_smem, cudaStream_t stream) {
  return staged ? launch_as<T, UT, true>(phi0, btilde, U, B_dev, out, maps, nt, L, B, B_new,
                                         N, Q, Ts, W, Tw, maps_in_smem, stream)
                : launch_as<T, UT, false>(phi0, btilde, U, B_dev, out, maps, nt, L, B, B_new,
                                          N, Q, Ts, W, Tw, maps_in_smem, stream);
}

}  // namespace

extern "C" {

// How many clusters of N CTAs, at the shared memory of the plan (Q, Ts, W,
// staged, maps_in_smem) of backtrack_cuda.vec_plan, the card can hold at
// once: *count (0 = none fits).  Returns a cudaError_t value; -1 for an
// unsupported type pair.
int mioc_chase_vec_clusters(int L, int B, int N, int Q, int Ts, int W, int staged,
                            int maps_in_smem, int dtype_bytes, int u_bytes, int* count) {
  *count = 0;
  const size_t smem = plan_smem(L, B, Q, Ts, W, staged, maps_in_smem, u_bytes);
  if (dtype_bytes == 8 && u_bytes == 1) return clusters<double, int8_t>(N, smem, staged, count);
  if (dtype_bytes == 8 && u_bytes == 4) return clusters<double, int32_t>(N, smem, staged, count);
  if (dtype_bytes == 4 && u_bytes == 1) return clusters<float, int8_t>(N, smem, staged, count);
  if (dtype_bytes == 4 && u_bytes == 4) return clusters<float, int32_t>(N, smem, staged, count);
  return -1;
}

// dtype_bytes: 4 (float) or 8 (double) for phi0; u_bytes: 1 (int8) or 4
// (int32).  B_dev: a device int32 holding the cap, or null to use B_new.
// maps: N·Q·L·(B+1) int32 on the device where the plan keeps the maps
// there (maps_in_smem = 0, one sub-chunk per slice), else unused.  N, Q, Ts, W, Tw, staged,
// maps_in_smem: the plan of backtrack_cuda.vec_plan.  Returns a cudaError_t
// value (0 = success; a refused cluster launch returns its error); -1 for an
// unsupported type pair or plan.
int mioc_chase_vec(const void* phi0, const void* btilde, const void* U, const void* B_dev,
                   void* out, void* maps, int nt, int L, int B, int B_new, int N, int Q,
                   int Ts, int W, int Tw, int staged, int maps_in_smem, int dtype_bytes,
                   int u_bytes, void* stream) {
  if (N < 1 || N > kMaxN || Q < 1 || Ts < 1 || W < 1 || Tw < 1 || (long long)W * Tw < Ts ||
      (long long)N * Q * Ts < nt - 1 || (!maps_in_smem && (W != 1 || (nt > 1 && !maps))))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MIOC_VEC_ARGS \
  phi0, btilde, U, B_dev, out, maps, nt, L, B, B_new, N, Q, Ts, W, Tw, staged, maps_in_smem, s
  if (dtype_bytes == 8 && u_bytes == 1) return launch<double, int8_t>(MIOC_VEC_ARGS);
  if (dtype_bytes == 8 && u_bytes == 4) return launch<double, int32_t>(MIOC_VEC_ARGS);
  if (dtype_bytes == 4 && u_bytes == 1) return launch<float, int8_t>(MIOC_VEC_ARGS);
  if (dtype_bytes == 4 && u_bytes == 4) return launch<float, int32_t>(MIOC_VEC_ARGS);
#undef MIOC_VEC_ARGS
  return -1;
}

}  // extern "C"
