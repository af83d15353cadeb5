// chase — the DP path chase (backtrack) for one start, by hand for Hopper:
// a chunked chase of state maps, across the card.
//
// Replaces: mioc_tpu/ops/backtrack_pallas.py::_bt_kernel (the TPU chase
// behind backtrack_pallas).  Computes exactly what
// mioc_tpu_torch.ops.bellman.backtrack_plain computes:
//
//   seed:  (l, b) = the flat argmin of phi0[l, b] masked to b ≤ B_new (+inf
//          elsewhere), ties to the smallest flat index l·(B+1) + b — the
//          reference's column-major argmin (smallest l, then smallest b);
//   step k = 0 … nt-2:  l' = U[k, l, b];  b -= b̃[k, l];  l = l'
//          (the lookup BEFORE the decrement: U is the post-shift table;
//          a budget below 0 indexes as the JAX scan chase does, common.cuh
//          budget_index);
//   level_idx[0] = seed l, level_idx[k+1] = l after step k.
//
// B_new is a kernel argument, or read from device memory when the caller
// passes a pointer to it (the device TRM's halved budget, so that no chase
// needs a host read), so a halved trust region re-launches on the same
// tables with no rebuild.
//
// What bounds it on this card: walked step by step, the chase is a chain of
// nt-1 dependent loads (the address of step k+1's U entry is the value of
// step k's): the first design walked it on one thread at L2 latency, about
// 205 ns per step at fishing (chip_smoke.py), with one SM of 132 busy.  Its
// bytes and operations are tiny.  But the state space is finite — P =
// L·(B+1) states (l, b), b ∈ [0, B] — and each step is a map from states to
// states, and maps compose.  So the design cuts time into C chunks of T steps
// and runs three phases:
//   A  one block per chunk, all chunks in parallel over the SMs: the chunk's
//      T U planes and b̃ rows are staged into shared memory (16-byte cp.async
//      for the planes), then every state walks the T steps there and its exit
//      state goes to a scratch map E[c, s] (int32, l·(B+1) + b).  A walk whose
//      budget falls below 0 inside the chunk writes a sentinel (-1): off the
//      path that happens; on a path from a finite seed it never does.
//   B  one thread: the seed (a block-wide masked argmin), then the C dependent
//      lookups s_{c+1} = E[c, s_c], C L2 round trips instead of nt-1, which
//      record each chunk's entry state.  At a sentinel the walk finishes
//      serially from that chunk's entry state on device memory, under the
//      reference's index rule, and the later chunks are skipped in phase C.
//   C  one block per chunk: re-walk the T steps from the entry state in the
//      staged planes (still in shared memory where the block staged that
//      chunk in phase A) and write level_idx[cT+1 …].
// The phases run in one cooperative launch with two grid-wide barriers; the
// grid is at most the blocks that fit on the card at once, and a block takes
// chunks c ≡ blockIdx.x (mod gridDim.x).  The bound is then phase B's C
// dependent reads plus one chunk's staging and walks.  The wrapper
// (mioc_tpu_torch/ops/backtrack_cuda.py::chase_plan) picks C and T, and reads
// the planes in place (not staged) where not even one plane fits.
//
// Measured (python -m mioc_tpu_torch.profile_kernels; NVIDIA H100 80GB HBM3,
// 700 W): 16 µs on the device at fishing, 20 at conv, 41 at heat scale, with
// about 32 chunks; 8 or 128 chunks were slower at fishing and conv (phase A's
// walks, or phase B's dependent reads, grow), 64 slightly faster at heat.  A
// call's host side (the wrapper and the cooperative launch) now takes longer
// than the kernel.
//
// Interface: plain C, pointers as void*, launched on the caller's stream;
// returns the launch's cudaError_t (0 = launched).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kSentinel = -1;

// Shared layout of one staged chunk of Tc steps: the U planes at the chunk's
// global address mod 16, in round16(Tc·plane + 16) bytes, then Tc rows of b̃.
__host__ __device__ inline size_t u_region(int Tc, size_t plane_bytes) {
  return mioc::round16((size_t)Tc * plane_bytes + 16);
}

__host__ __device__ inline size_t chunk_smem(int Tc, size_t plane_bytes, int L,
                                             int staged) {
  return staged ? u_region(Tc, plane_bytes) + (size_t)Tc * L * sizeof(int32_t) : 0;
}

// Where chunk c's planes and b̃ rows are read: shared memory (staged) or
// device memory in place.  k0: its first step; kn: its steps.
template <typename UT>
struct ChunkView {
  const UT* up;
  const int32_t* bp;
  int k0, kn;
};

template <typename UT>
__device__ __forceinline__ ChunkView<UT> chunk_view(unsigned char* smem,
                                                    const UT* __restrict__ U,
                                                    const int32_t* __restrict__ btilde,
                                                    int c, int Tc, int steps, int L, int P,
                                                    int staged) {
  ChunkView<UT> v;
  v.k0 = c * Tc;
  v.kn = min(Tc, steps - v.k0);
  if (!staged) {
    v.up = U + (size_t)v.k0 * P;
    v.bp = btilde + (size_t)v.k0 * L;
    return v;
  }
  const size_t plane = (size_t)P * sizeof(UT);
  const size_t skew = ((uintptr_t)U + (size_t)v.k0 * plane) & 15;
  v.up = reinterpret_cast<const UT*>(smem + skew);
  v.bp = reinterpret_cast<const int32_t*>(smem + u_region(Tc, plane));
  return v;
}

// Stage chunk c into shared memory (every thread of the block; ends with a
// barrier).  The caller has passed a barrier since the last reads of the
// previous chunk.
template <typename UT>
__device__ ChunkView<UT> stage_chunk(unsigned char* smem, const UT* __restrict__ U,
                                     const int32_t* __restrict__ btilde, int c, int Tc,
                                     int steps, int L, int P, int staged) {
  const ChunkView<UT> v = chunk_view(smem, U, btilde, c, Tc, steps, L, P, staged);
  if (staged) {
    const size_t plane = (size_t)P * sizeof(UT);
    const unsigned char* src = reinterpret_cast<const unsigned char*>(U) + v.k0 * plane;
    mioc::stage_bytes<true>(smem + ((uintptr_t)src & 15), src, (size_t)v.kn * plane,
                            threadIdx.x, blockDim.x);
    int32_t* bs = reinterpret_cast<int32_t*>(smem + u_region(Tc, plane));
    const int32_t* bsrc = btilde + (size_t)v.k0 * L;
    for (int i = threadIdx.x; i < v.kn * L; i += blockDim.x)
      __pipeline_memcpy_async(bs + i, bsrc + i, sizeof(int32_t));
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }
  __syncthreads();
  return v;
}

template <typename T, typename UT>
__global__ void __launch_bounds__(kThreads)
chase_kernel(const T* __restrict__ phi0,           // (L, B+1)
             const int32_t* __restrict__ btilde,   // (nt, L)
             const UT* __restrict__ U,             // (nt-1, L, B+1)
             const int32_t* __restrict__ B_dev,    // () or nullptr
             int32_t* __restrict__ out,            // (nt,)
             int32_t* scratch,                     // E (C, P), entry (C,), first_bad
             int nt, int L, int B, int B_new, int Tc, int C, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T sval[kThreads];
  __shared__ int sidx[kThreads];
  const int B1 = B + 1;
  const int P = L * B1;
  const int steps = nt - 1;
  int32_t* E = scratch;
  int32_t* entry = scratch + (size_t)C * P;
  int32_t* first_bad = entry + C;
  int held = -1;  // the chunk whose planes this block's shared memory holds

  {  // phase A
    for (int c = blockIdx.x; c < C; c += gridDim.x) {
      const ChunkView<UT> v = stage_chunk(smem, U, btilde, c, Tc, steps, L, P, staged);
      held = c;
      for (int s = threadIdx.x; s < P; s += blockDim.x) {
        int l = s / B1;
        int b = s - l * B1;
        for (int kk = 0; kk < v.kn; ++kk) {
          const int nl = static_cast<int>(v.up[(size_t)kk * P + l * B1 + b]);
          b -= v.bp[kk * L + l];
          l = nl;
          if (b < 0) break;
        }
        E[(size_t)c * P + s] = b < 0 ? kSentinel : l * B1 + b;
      }
      __syncthreads();  // the planes are free for the block's next chunk
    }
  }
  cg::this_grid().sync();

  if (blockIdx.x == 0) {  // phase B
    const int cap = B_dev != nullptr ? *B_dev : B_new;
    const int flat = mioc::block_masked_argmin(phi0, P, B1, cap, sval, sidx);
    if (threadIdx.x == 0) {
      int s = flat;
      int bad = C;
      out[0] = s / B1;
      for (int c = 0; c < C; ++c) {
        entry[c] = s;
        const int e = __ldcg(E + (size_t)c * P + s);
        if (e == kSentinel) {
          bad = c;
          const int l = s / B1;
          mioc::walk(U, btilde, out, c * Tc, nt, L, B, l, s - l * B1);
          break;
        }
        s = e;
      }
      *first_bad = bad;
    }
  }
  cg::this_grid().sync();

  {  // phase C
    const int bad = __ldcg(first_bad);
    // This block's chunks, last first: the last one phase A staged is still
    // in shared memory.
    const int bid = blockIdx.x, G = gridDim.x;
    const int last = bid < C ? bid + (C - 1 - bid) / G * G : -1;
    for (int c = last; c >= 0; c -= G) {
      if (c >= bad) continue;
      const ChunkView<UT> v =
          c == held ? chunk_view(smem, U, btilde, c, Tc, steps, L, P, staged)
                    : stage_chunk(smem, U, btilde, c, Tc, steps, L, P, staged);
      held = c;
      if (threadIdx.x == 0) {
        const int s = __ldcg(entry + c);
        int l = s / B1;
        int b = s - l * B1;
        for (int kk = 0; kk < v.kn; ++kk) {
          const int nl = static_cast<int>(v.up[(size_t)kk * P + l * B1 + b]);
          b -= v.bp[kk * L + l];
          l = nl;
          out[v.k0 + kk + 1] = l;
        }
      }
      __syncthreads();  // the planes are free for the block's next chunk
    }
  }
}

template <typename T, typename UT>
int launch(const void* phi0, const void* btilde, const void* U, const void* B_dev,
           void* out, void* scratch, int nt, int L, int B, int B_new, int Tc, int C,
           int staged, cudaStream_t stream) {
  const size_t plane = (size_t)L * (B + 1) * sizeof(UT);
  const size_t smem = chunk_smem(Tc, plane, L, staged);
  auto kern = chase_kernel<T, UT>;
  // A cooperative grid must fit on the card at once: the blocks one SM holds
  // at this shared memory, times the SMs.  Both queries and the shared-memory
  // attribute are kept for the last (device, smem) this instance launched
  // with, so a solve's repeated chases pay for them once.
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
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                           smem)) != cudaSuccess)
      return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    last_dev = dev;
    last_smem = smem;
    last_blocks = per_sm * sms;
  }
  const int grid = max(1, min(C, last_blocks));
  const T* a0 = static_cast<const T*>(phi0);
  const int32_t* a1 = static_cast<const int32_t*>(btilde);
  const UT* a2 = static_cast<const UT*>(U);
  const int32_t* a3 = static_cast<const int32_t*>(B_dev);
  int32_t* a4 = static_cast<int32_t*>(out);
  int32_t* a5 = static_cast<int32_t*>(scratch);
  void* args[] = {&a0, &a1, &a2, &a3, &a4, &a5, &nt, &L, &B, &B_new, &Tc, &C, &staged};
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(kThreads), args, smem,
                                  stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype_bytes: 4 (float) or 8 (double) for phi0; u_bytes: 1 (int8) or 4
// (int32).  B_dev: a device int32 holding the cap, or null to use B_new.
// scratch: C·L·(B+1) + C + 1 int32 on the device.  Tc, C, staged: the plan of
// backtrack_cuda.chase_plan (steps per chunk, chunks, planes staged in shared
// memory).  Returns a cudaError_t value (0 = success; a refused cooperative
// launch returns its error); -1 for an unsupported type pair or plan.
int mioc_chase(const void* phi0, const void* btilde, const void* U, const void* B_dev,
               void* out, void* scratch, int nt, int L, int B, int B_new, int Tc, int C,
               int staged, int dtype_bytes, int u_bytes, void* stream) {
  if (Tc < 1 || C < 0 || (long long)C * Tc < nt - 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_bytes == 8 && u_bytes == 1)
    return launch<double, int8_t>(phi0, btilde, U, B_dev, out, scratch, nt, L, B, B_new, Tc, C, staged, s);
  if (dtype_bytes == 8 && u_bytes == 4)
    return launch<double, int32_t>(phi0, btilde, U, B_dev, out, scratch, nt, L, B, B_new, Tc, C, staged, s);
  if (dtype_bytes == 4 && u_bytes == 1)
    return launch<float, int8_t>(phi0, btilde, U, B_dev, out, scratch, nt, L, B, B_new, Tc, C, staged, s);
  if (dtype_bytes == 4 && u_bytes == 4)
    return launch<float, int32_t>(phi0, btilde, U, B_dev, out, scratch, nt, L, B, B_new, Tc, C, staged, s);
  return -1;
}

}  // extern "C"
