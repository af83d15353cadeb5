// pde_dense — the dense implicit-Euler sweeps of a parabolic PDE objective
// (the state sweep rows · S⁻ᵀ and the adjoint sweep rows · S⁻¹), all nt
// steps of a batch of rows in one persistent launch, by hand for Hopper.
//
// Replaces no TPU kernel: the JAX package runs these sweeps as a lax.scan of
// one matrix product a step that XLA compiles (mioc_tpu/objectives/pde.py).
// The port first wrote them as a Python loop over the steps
// (mioc_tpu_torch/objectives/pde.py, PDEObjective._sweep, which stays as the
// plain version): an add and one 16-row torch.matmul a chunk and step, about
// three launches a step (cuBLAS's d884gemm, its splitKreduce, the add), so a
// sweep of nt = 500 steps cost ~26–29 ms of the host's launches for ~8 µs of
// device work a step.
//
// The recursion, for R rows of length N:
//   forward  v_{k+1} = fl(v_k + drive[k]) · op,      v_0  = v_end
//   reverse  v_k     = fl(v_{k+1} + drive[k]) · op,  v_nt = v_end
// with v_end a row vector (every row the same) or 0; all nt + 1 iterates are
// written, (nt + 1, R, N).  The add is rounded in the storage type, then the
// product.
//
// What bounds it on this card: every step waits for the last, and a step is
// R·N² multiply-adds (297k a row at heat's N = 545, 0.15 µs a row on the
// float64 FMA units of 16 SMs) on an operator of 2.38 MB in float64: more
// than one SM holds, less than the registers of sixteen.  So the design:
//   * a row group (up to 14 rows) is one thread-block cluster of 16 CTAs
//     (kCluster, the non-portable size) of 256 threads.  CTA c owns the
//     columns [c·CW, (c+1)·CW) of op and of the iterate, CW = ⌈N/16⌉ rounded
//     up to even; its thread (j, p) holds the kSpan = 40 terms k = 40·j …
//     40·j + 39 of the column pair 2p, 2p + 1 of op in registers for the
//     whole sweep: op is read from device memory once and never again (14
//     spans × 18 pairs = 252 threads at N = 545).  8 warps, two on each of
//     the SM's four schedulers, may take 255 registers a thread (9 warps
//     capped them at 168, and the 72 terms of op spilled);
//   * each step, thread (j, p) takes its 40-term partial dot products with
//     every row, two rows at a time (per row and column two fma chains, the
//     even and the odd terms).  It reads a row's terms from shared memory as
//     16-byte pairs, each feeding four multiply-adds (at one column a
//     thread the loads, not the FMA units, set the pace);
//   * the partials meet in shared memory, and thread (r, p) adds up the
//     spans of row r at columns 2p, 2p + 1 in span order, writes the iterate
//     and pushes the pair fl(v + drive) of the next input into the input
//     rows of all 16 CTAs of the cluster (st.shared::cluster.v2,
//     distributed shared memory).  The input rows are double-buffered, so
//     one cluster barrier a step (barrier.cluster arrive/wait, release and
//     acquire) suffices, and no CTA waits on a load from another;
//   * the pushes are bandwidth (~0.16 µs a row: 16 copies of every row), so
//     the rows go in chunks of 2 (groups of ≤ 4 rows) or 4: a chunk's
//     pushes travel while the next chunk's products run;
//   * row groups are independent clusters: a wave of R rows is ⌈R / rows⌉
//     clusters side by side, with no grid-wide barrier.  The wrapper takes
//     the fewest rows a group such that the card holds all groups at once
//     (ops/pde_cuda.py::group_rows); past 14 rows a group, the later
//     clusters wait for a free place and nothing waits on them;
//   * the product is float64 (or float32) FMA on the CUDA cores, never a
//     tensor-core format of fewer bits.
//
// Measured (python -m mioc_tpu_torch.profile_kernels --pde-only; NVIDIA H100
// 80GB HBM3, 700 W), N = 545, nt = 500, float64: 1.12, 1.54, 1.97 and
// 3.8–4.4 µs a step at 1, 8, 16 and 64 rows (one group of 1, 4 of 2, 6 of
// 3, 7 of up to 10 rows); the plain version takes 17–75 ms a sweep at those
// rows (three launches a step).  The designs tried first, each with the same
// bits: op's column slices resident in shared memory (153 KB a CTA), the
// rows gathered each step by loads from the other CTAs, 6.8 µs a step at 1
// row and 15 µs at 16; op in registers at one column a thread (490
// threads), 2.2 µs at 1 row and 12.7 at 16; two columns a thread in 9 warps,
// 2.2 and 10.3; in 8 warps without chunks, 1.1 and 6.9 (14 rows).  op read
// from L2 each step was not built: 2.38 MB a group a step is ~0.4 µs of L2
// at its full rate for one group, and the groups share it.  Above the FMA
// bound (0.15 µs a row) are ~0.9 µs a step of barrier and ~0.24 µs a row of
// products and ~0.16 µs of pushes, which the chunks partly hide.
//
// Bits: each output element is one dot product of one input row with one
// column of op.  Its terms are summed as ⌈KP/40⌉ spans of 40 (KP = N rounded
// up to even, zeros past N), each span as two sequential fma chains from +0
// (its even and its odd terms) added together, then the spans in order.
// That order is fixed by N alone: not by R, the row's place, its group or
// the rows a group holds.  So every row has the bits of its own single
// evaluation, without padding to a fixed row count (the contract of
// ops/rows.py).  The order differs from cuBLAS's, so the iterates differ
// from the plain version's by rounding.  Every product and sum is an
// explicit intrinsic (__fma_rn, __dadd_rn; __fmaf_rn, __fadd_rn), so nvcc
// contracts nothing.
//
// Interface: plain C, one entry per storage type (_f64, _f32), pointers as
// void*, launched on the caller's stream; returns the launch's cudaError_t
// (0 = launched), -1 for arguments it does not take.  How many clusters the
// card holds at once comes from mioc_pde_dense_clusters.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 16;   // CTAs of a row group
constexpr int kThreads = 256;  // threads of a CTA (8 warps): (span, column pair) pairs, at most
constexpr int kSpan = 40;      // terms of a dot product a thread holds, for two columns
constexpr int kMaxRows = 14;   // rows of a group, at most: (row, column pair) pairs ≤ kThreads
constexpr int kMaxSpans = 14;  // spans of a dot product, at most: (span, column pair) pairs ≤ kThreads
constexpr int kBatch = 7;      // partial sums a thread loads at once

template <typename T> struct Vec2;
template <> struct Vec2<double> { using type = double2; };
template <> struct Vec2<float> { using type = float2; };

__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");  // release
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");  // acquire
}

// The address of p (in this CTA's shared memory) in CTA rank's.
__device__ __forceinline__ uint32_t remote(const void* p, int rank) {
  uint32_t a;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(a)
      : "r"((uint32_t)__cvta_generic_to_shared(p)), "r"(rank));
  return a;
}

// A pair of elements stored at a remote address (distributed shared memory).
__device__ __forceinline__ void st_remote(uint32_t a, double2 v) {
  asm volatile("st.shared::cluster.v2.f64 [%0], {%1, %2};" ::"r"(a), "d"(v.x), "d"(v.y)
               : "memory");
}

__device__ __forceinline__ void st_remote(uint32_t a, float2 v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" ::"r"(a), "f"(v.x), "f"(v.y)
               : "memory");
}

// The partial dot products of thread (j, p) with NR rows (NR = 1, 2) of
// input: for row n, columns 2p and 2p + 1, the even and the odd terms of
// the span each in one fma chain from +0, the two chains added; stored to
// to[n·CW/2] as a pair.
template <int NR, typename T, typename T2>
__device__ __forceinline__ void span_products(const T* x, int AS, const T (&w0)[kSpan],
                                              const T (&w1)[kSpan], T2* to, int half_cw) {
  T ea[NR], oa[NR], eb[NR], ob[NR];
#pragma unroll
  for (int n = 0; n < NR; ++n) ea[n] = oa[n] = eb[n] = ob[n] = T(0);
#pragma unroll
  for (int i = 0; i < kSpan / 2; ++i) {
#pragma unroll
    for (int n = 0; n < NR; ++n) {
      const T2 a = reinterpret_cast<const T2*>(x + n * AS)[i];
      ea[n] = fma_rn(a.x, w0[2 * i], ea[n]);
      oa[n] = fma_rn(a.y, w0[2 * i + 1], oa[n]);
      eb[n] = fma_rn(a.x, w1[2 * i], eb[n]);
      ob[n] = fma_rn(a.y, w1[2 * i + 1], ob[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < NR; ++n) to[n * half_cw] = T2{add_rn(ea[n], oa[n]), add_rn(eb[n], ob[n])};
}

// The shape of the work at N, and a CTA's shared memory (elements of T).
struct Layout {
  int CW;   // columns a CTA owns: ⌈N/16⌉ rounded up to even
  int NP;   // column pairs a CTA owns, CW/2
  int NS;   // spans of kSpan terms, ⌈KP/kSpan⌉ (KP = N rounded up to even)
  int AS;   // row stride of the input rows: NS·kSpan, zeros past N
  size_t p_off, total;  // input rows (2, RB, AS), then partial sums (NS, RB, CW)
};

__host__ __device__ inline Layout layout(int N, int RB) {
  Layout l;
  const int cw = (N + kCluster - 1) / kCluster;
  l.CW = cw + (cw & 1);
  l.NP = l.CW / 2;
  l.NS = (N + (N & 1) + kSpan - 1) / kSpan;
  l.AS = l.NS * kSpan;
  l.p_off = 2 * (size_t)RB * l.AS;
  l.total = l.p_off + (size_t)l.NS * RB * l.CW;
  return l;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
pde_dense_kernel(const T* __restrict__ v_end,  // (N,) or nullptr (0)
                 const T* __restrict__ drive,  // (nt, R, N)
                 const T* __restrict__ op,     // (N, N): v_next[j] = Σ_i a[i]·op[i][j]
                 T* __restrict__ out,          // (nt + 1, R, N)
                 int N, int nt, int R, int RB, int reverse) {
  using T2 = typename Vec2<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const A = reinterpret_cast<T*>(smem_raw);  // A[buf][r·AS + k]: a step's input rows
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const Layout lay = layout(N, RB);
  T* const P = A + lay.p_off;  // P[(j·RB + r)·CW + c]: span j's partial of output (r, c)
  const int c0 = rank * lay.CW;
  const int r0 = (int)(blockIdx.x / kCluster) * RB;
  const int nrows = min(RB, R - r0);
  const size_t RN = (size_t)R * N;
  const int tid = threadIdx.x;
  const int rows_buf = RB * lay.AS;

  // This thread's terms of op: span j, columns 2p and 2p + 1 of the CTA's.
  const int j = tid / lay.NP, p = tid - j * lay.NP;
  const bool worker = j < lay.NS;
  const int ca = c0 + 2 * p;  // the pair's first column of op and of the iterate
  T w0[kSpan], w1[kSpan];
#pragma unroll
  for (int i = 0; i < kSpan; ++i) {
    const int k = j * kSpan + i;
    const bool in = worker && k < N;
    w0[i] = (in && ca < N) ? op[(size_t)k * N + ca] : T(0);
    w1[i] = (in && ca + 1 < N) ? op[(size_t)k * N + ca + 1] : T(0);
  }
  // Both buffers of input rows zero (the terms past N stay so).
  for (int idx = tid; idx < 2 * rows_buf; idx += kThreads) A[idx] = T(0);
  cluster.sync();  // every CTA runs and is zeroed before any pushes to it

  // The outputs this thread adds up and pushes: row er, columns ca, ca + 1.
  const int er = tid / lay.NP;
  const bool eok = er < nrows && ca < N;
  const bool second = ca + 1 < N;
  const T* const drive_at = drive + ((size_t)r0 + er) * N + ca;  // + d·RN
  T* const out_at = out + ((size_t)r0 + er) * N + ca;            // + s·RN
  const int push_at = er * lay.AS + ca;                          // in a buffer of A
  const int chunk = RB <= 4 ? 2 : 4;  // rows a chunk (measured best for groups of 2–4 and of 10–14)

  // v_end into out[end]; the first input fl(v_end + drive[d(0)]) into buffer 0.
  if (eok) {
    const int end = reverse ? nt : 0;
    const size_t d0 = (size_t)(reverse ? nt - 1 : 0) * RN;
    const T v0 = v_end != nullptr ? v_end[ca] : T(0);
    const T v1 = v_end != nullptr && second ? v_end[ca + 1] : T(0);
    out_at[(size_t)end * RN] = v0;
    if (second) out_at[(size_t)end * RN + 1] = v1;
    if (nt > 0) {
      T2 a;
      a.x = add_rn(v0, drive_at[d0]);
      a.y = second ? add_rn(v1, drive_at[d0 + 1]) : T(0);
      for (int q = 0; q < kCluster; ++q) st_remote(remote(A + push_at, q), a);
    }
  }
  cluster_arrive();

  for (int s = 0; s < nt; ++s) {
    const int buf = s & 1;
    const int dst = reverse ? nt - 1 - s : s + 1;
    const bool more = s + 1 < nt;
    T d0 = T(0), d1 = T(0);
    if (more && eok) {
      const size_t dn = (size_t)(reverse ? nt - 2 - s : s + 1) * RN;
      d0 = __ldg(drive_at + dn);
      if (second) d1 = __ldg(drive_at + dn + 1);
    }
    cluster_wait();  // this step's input rows are all pushed

    // The rows in chunks: a chunk's pushes travel while the next chunk's
    // products run.
    for (int rc = 0; rc < nrows; rc += chunk) {
      const int rend = min(nrows, rc + chunk);
      if (worker) {
        const T* rows = A + buf * rows_buf + j * kSpan;
        T2* to = reinterpret_cast<T2*>(P + j * RB * lay.CW + 2 * p);
        int r = rc;
        for (; r + 1 < rend; r += 2)
          span_products<2>(rows + r * lay.AS, lay.AS, w0, w1, to + r * lay.NP, lay.NP);
        if (r < rend) span_products<1>(rows + r * lay.AS, lay.AS, w0, w1, to + r * lay.NP, lay.NP);
      }
      __syncthreads();
      if (!eok || er < rc || er >= rend) continue;
      const T2* from = reinterpret_cast<const T2*>(P + er * lay.CW + 2 * p);
      const int stride = RB * lay.CW / 2;
      T2 v = from[0];
#pragma unroll
      for (int j0 = 1; j0 < kMaxSpans; j0 += kBatch) {
        T2 u[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          if (j0 + q < lay.NS) u[q] = from[(j0 + q) * stride];
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          if (j0 + q < lay.NS) {
            v.x = add_rn(v.x, u[q].x);
            v.y = add_rn(v.y, u[q].y);
          }
      }
      out_at[(size_t)dst * RN] = v.x;
      if (second) out_at[(size_t)dst * RN + 1] = v.y;
      if (more) {
        T2 a;
        a.x = add_rn(v.x, d0);
        a.y = second ? add_rn(v.y, d1) : T(0);
        T* to = A + (buf ^ 1) * rows_buf + push_at;
        for (int q = 0; q < kCluster; ++q) st_remote(remote(to, q), a);
      }
    }
    cluster_arrive();  // this CTA's part of the next input rows is pushed
  }
  cluster_wait();
}

// Set the kernel's attributes (again where a launch needs more shared
// memory, or on another device) and fill cfg for `groups` clusters of
// kCluster CTAs (attr must outlive cfg's use).
template <typename T>
cudaError_t configure(int N, int RB, int groups, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute& attr) {
  auto kern = pde_dense_kernel<T>;
  const size_t smem = layout(N, RB).total * sizeof(T);
  static int last_dev = -1;
  static size_t last_smem = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != last_dev || smem > last_smem) {
    if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
      return e;
    if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
        cudaSuccess)
      return e;
    last_dev = dev;
    last_smem = smem;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(kCluster * groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// The kernel takes N where a CTA's (span, column) pairs fit its threads.
bool takes(int N, int RB) {
  if (N < 1 || RB < 1 || RB > kMaxRows) return false;
  const Layout l = layout(N, RB);
  return l.NS <= kMaxSpans && l.NS * l.NP <= kThreads && RB * l.NP <= kThreads;
}

template <typename T>
int launch(const void* v_end, const void* drive, const void* op, void* out, int N, int nt, int R,
           int RB, int reverse, void* stream) {
  if (!takes(N, RB) || nt < 0 || R < 1 || !op || !out || (nt > 0 && !drive)) return -1;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure<T>(N, RB, (R + RB - 1) / RB, static_cast<cudaStream_t>(stream), cfg,
                               attr);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, pde_dense_kernel<T>, static_cast<const T*>(v_end),
                         static_cast<const T*>(drive), static_cast<const T*>(op),
                         static_cast<T*>(out), N, nt, R, RB, reverse);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int clusters(int N, int RB, int* count) {
  if (!takes(N, RB)) return -1;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure<T>(N, RB, 1, nullptr, cfg, attr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveClusters(count, (const void*)pde_dense_kernel<T>, &cfg);
}

}  // namespace

extern "C" {

// v_end: (N,) or null (the zero row); drive: (nt, R, N); op: (N, N); out:
// (nt + 1, R, N); all contiguous, of the entry's storage type.  rows: the
// rows of a group, 1 … 16 (⌈R / rows⌉ clusters).  reverse: 0 the forward
// recursion, 1 the reverse.
int mioc_pde_dense_sweep_f64(const void* v_end, const void* drive, const void* op, void* out,
                             int N, int nt, int R, int rows, int reverse, void* stream) {
  return launch<double>(v_end, drive, op, out, N, nt, R, rows, reverse, stream);
}

int mioc_pde_dense_sweep_f32(const void* v_end, const void* drive, const void* op, void* out,
                             int N, int nt, int R, int rows, int reverse, void* stream) {
  return launch<float>(v_end, drive, op, out, N, nt, R, rows, reverse, stream);
}

// How many clusters of `rows` rows at N the card holds at once: *count (0 =
// none fits).  dtype_bytes: 8 (double) or 4 (float).  Returns a cudaError_t
// value; -1 for arguments it does not take.
int mioc_pde_dense_clusters(int N, int dtype_bytes, int rows, int* count) {
  *count = 0;
  if (dtype_bytes == 8) return clusters<double>(N, rows, count);
  if (dtype_bytes == 4) return clusters<float>(N, rows, count);
  return -1;
}

}  // extern "C"
