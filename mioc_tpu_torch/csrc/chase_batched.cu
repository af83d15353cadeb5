// chase_batched — R DP path chases at once, each at its own budget cap, by
// hand for Hopper: the chunked chase of state maps over G table sets.
//
// Replaces: mioc_tpu/ops/backtrack_pallas.py::_bt_kernel_batched (the TPU
// chase behind _backtrack_batched_impl, which the vmapped device TRM reaches
// through _cv_backtrack → _cv_batched_backtrack: the sequential inner loop of
// every multistart, the single solve's trial wave, the batched TRM step).
// Computes exactly what mioc_tpu_torch.ops.bellman.backtrack_batched_plain
// computes: for each row s, the chase of chase.cu on that row's tables at
// the cap B_new[s]:
//
//   seed:  (l, b) = flat argmin of phi0[s] masked to b ≤ B_new[s], ties to
//          the smallest flat index l·(B+1) + b;
//   step k = 0 … nt-2:  l' = U[s, k, l, b];  b -= b̃[s, k, l];  l = l';
//   out[s, 0] = seed l, out[s, k+1] = l after step k.
//
// The caps live in device memory (an int32 per row), so the device TRM's
// halved budgets need no host read.  Each row's tables are addressed by a
// batch stride per operand; a stride of 0 reads one table set for every row,
// which is how the single solve's trial wave chases K caps against one build
// with no K-fold copy of U.
//
// The TPU kernel advances all S rows in lockstep vector ops because one TPU
// core runs the grid in order.  The first Hopper design gave each row a
// block whose one thread walked nt-1 dependent loads on device memory
// (~255 ns per step at fishing, PERF.md).  This one runs chase_chunked.cuh:
// the state maps of a chunk depend on U and b̃ only, never on the cap, so
// one set of maps per table set serves every row.  With U and b̃ both at
// stride 0 there is one table set (G = 1) and its maps are built once for
// the K rows of the wave; otherwise each row has its own (G = R).
//
// What bounds it on this card: phase A's staging of G·C chunks (the bytes
// of every table set, once) and its walks (shared-memory gathers, limited by
// bank conflicts), phase B's C dependent L2 reads per row (the rows' chains
// run side by side, a warp each), phase C's one-thread re-walk of a chunk,
// and the two grid barriers.  The wrapper (backtrack_cuda.chase_plan with sets=G) picks the
// chunks per set so that the G·C tasks fill the card.
//
// Measured (python -m mioc_tpu_torch.profile_kernels; NVIDIA H100 80GB HBM3,
// 700 W), device µs: 36 at fishing S=32 with 8 chunks per set (16: 45, 32:
// 62); the K=9 wave on one set 17–19 at fishing, 21–22 at conv (chase.cu at
// the same shapes: 16 and 19).
//
// Interface: plain C, pointers as void*, launched on the caller's stream;
// returns the launch's cudaError_t (0 = launched).

#include "chase_chunked.cuh"

extern "C" {

// dtype_bytes: 4 (float) or 8 (double) for phi0; u_bytes: 1 (int8) or 4
// (int32).  R rows, G table sets (1, or R with row r on set r).  sp, sb, su:
// the row-axis strides of phi0 and the set-axis strides of btilde and U in
// elements.  scratch: G·C·L·(B+1) + R·C + R int32 on the device.  Tc, C,
// staged: the plan of backtrack_cuda.chase_plan.  Returns a cudaError_t value
// (0 = success; a refused cooperative launch returns its error); -1 for an
// unsupported type pair or plan.
int mioc_chase_batched(const void* phi0, const void* btilde, const void* U,
                       const void* B_new, void* out, void* scratch, int R, int G, int nt,
                       int L, int B, int Tc, int C, int staged, long long sp, long long sb,
                       long long su, int dtype_bytes, int u_bytes, void* stream) {
  if (Tc < 1 || C < 0 || (long long)C * Tc < nt - 1 || R < 1 || (G != 1 && G != R))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MIOC_CHASE_ARGS \
  phi0, btilde, U, B_new, 0, out, scratch, R, G, 1, nt, L, B, Tc, C, staged, sp, sb, su, s
  if (dtype_bytes == 8 && u_bytes == 1) return mioc::launch_chunked<double, int8_t>(MIOC_CHASE_ARGS);
  if (dtype_bytes == 8 && u_bytes == 4) return mioc::launch_chunked<double, int32_t>(MIOC_CHASE_ARGS);
  if (dtype_bytes == 4 && u_bytes == 1) return mioc::launch_chunked<float, int8_t>(MIOC_CHASE_ARGS);
  if (dtype_bytes == 4 && u_bytes == 4) return mioc::launch_chunked<float, int32_t>(MIOC_CHASE_ARGS);
#undef MIOC_CHASE_ARGS
  return -1;
}

}  // extern "C"
