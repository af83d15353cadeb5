// chase_batched — S DP path chases at once, each at its own budget cap, by
// hand for Hopper.
//
// Replaces: mioc_tpu/ops/backtrack_pallas.py::_bt_kernel_batched (the TPU
// chase behind _backtrack_batched_impl, which the vmapped device TRM reaches
// through _cv_backtrack → _cv_batched_backtrack: the sequential inner loop of
// every multistart, the single solve's trial wave, the batched TRM step).
// Computes exactly what mioc_tpu_torch.ops.bellman.backtrack_batched_plain
// computes: for each start s, the chase of chase.cu on that start's tables at
// the cap B_new[s]:
//
//   seed:  (l, b) = flat argmin of phi0[s] masked to b ≤ B_new[s], ties to
//          the smallest flat index l·(B+1) + b;
//   step k = 0 … nt-2:  l' = U[s, k, l, b];  b -= b̃[s, k, l];  l = l';
//   out[s, 0] = seed l, out[s, k+1] = l after step k.
//
// The caps live in device memory (an int32 per start), so the device TRM's
// halved budgets need no host read.  Each start's tables are addressed by a
// batch stride per operand; a stride of 0 reads one table set for every
// start, which is how the single solve's trial wave chases K caps against
// one build with no K-fold copy of U.
//
// The TPU kernel advances all S starts in lockstep vector ops because one
// TPU core runs the grid in order.  On Hopper the starts are independent
// blocks: block s runs chase.cu's body on its own start.
//
// What bounds it on this card: each chase is a chain of nt-1 dependent loads
// (memory latency, not bytes or operations), so S chases take about the time
// of one as long as S ≤ 132 blocks find an SM each.  The block's threads
// share the seed's masked argmin over the (L, B+1) plane; one thread walks.
//
// Interface: plain C, pointers as void*, launched on the caller's stream;
// returns cudaGetLastError() after the launch (0 = launched).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, typename UT>
__global__ void __launch_bounds__(kThreads)
chase_batched_kernel(const T* __restrict__ phi0,          // (S, L, B+1), stride sp
                     const int32_t* __restrict__ btilde,  // (S, nt, L), stride sb
                     const UT* __restrict__ U,            // (S, nt-1, L, B+1), stride su
                     const int32_t* __restrict__ B_new,   // (S,)
                     int32_t* __restrict__ out,           // (S, nt)
                     int nt, int L, int B, long long sp, long long sb,
                     long long su) {
  __shared__ T sval[kThreads];
  __shared__ int sidx[kThreads];
  const int s = blockIdx.x;
  const int B1 = B + 1;
  phi0 += s * sp;
  btilde += s * sb;
  U += s * su;
  out += (size_t)s * nt;
  const int flat = mioc::block_masked_argmin(phi0, L * B1, B1, B_new[s], sval, sidx);
  if (threadIdx.x == 0) {
    const int l = flat / B1;
    mioc::walk(U, btilde, out, 0, nt, L, B, l, flat - l * B1);
  }
}

template <typename T, typename UT>
int launch(const void* phi0, const void* btilde, const void* U, const void* B_new,
           void* out, int S, int nt, int L, int B, long long sp, long long sb,
           long long su, cudaStream_t stream) {
  chase_batched_kernel<T, UT><<<S, kThreads, 0, stream>>>(
      static_cast<const T*>(phi0), static_cast<const int32_t*>(btilde),
      static_cast<const UT*>(U), static_cast<const int32_t*>(B_new),
      static_cast<int32_t*>(out), nt, L, B, sp, sb, su);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype_bytes: 4 (float) or 8 (double) for phi0; u_bytes: 1 (int8) or 4
// (int32).  sp, sb, su: the start-axis strides of phi0, btilde and U in
// elements (0 = one table set for all starts).  Returns a cudaError_t value
// (0 = success); -1 for an unsupported type pair.
int mioc_chase_batched(const void* phi0, const void* btilde, const void* U,
                       const void* B_new, void* out, int S, int nt, int L, int B,
                       long long sp, long long sb, long long su, int dtype_bytes,
                       int u_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_bytes == 8 && u_bytes == 1)
    return launch<double, int8_t>(phi0, btilde, U, B_new, out, S, nt, L, B, sp, sb, su, st);
  if (dtype_bytes == 8 && u_bytes == 4)
    return launch<double, int32_t>(phi0, btilde, U, B_new, out, S, nt, L, B, sp, sb, su, st);
  if (dtype_bytes == 4 && u_bytes == 1)
    return launch<float, int8_t>(phi0, btilde, U, B_new, out, S, nt, L, B, sp, sb, su, st);
  if (dtype_bytes == 4 && u_bytes == 4)
    return launch<float, int32_t>(phi0, btilde, U, B_new, out, S, nt, L, B, sp, sb, su, st);
  return -1;
}

}  // extern "C"
