// dp_build — the Bellman DP backward sweep for one start, by hand for Hopper.
//
// Replaces: mioc_tpu/ops/bellman_pallas.py::_dp_kernel (the fused TPU build
// behind build_tables_pallas).  Computes exactly what
// mioc_tpu_torch.ops.bellman.build_tables_plain computes; the recurrence and
// its kernel body are in dp_build.cuh, shared with dp_build_batched.cu (this
// entry point launches it on one block).
//
// The TPU kernel rolls the contraction's output through smax+1 static lane
// rotations to apply the budget shift; here each output reads its shifted
// column Φ_{i+1}[:, b-s] directly from shared memory.  With the s > smax
// guard kept, the value and the index are the same.
//
// What bounds it on this card: the recurrence is sequential in time, so one
// start occupies one block on one SM, and each of the nt-1 steps ends in a
// __syncthreads().  The work per step is L·(B+1)·L add-and-compare pairs on
// shared memory (heat scale: 265 k; fishing: 1.5 k), so small planes are
// bound by the per-step latency (the barrier and the shared-memory loads of
// one relaxation chain), large ones by one SM's shared-memory loads — far
// from the card's HBM or FLOP roof, which counts all 132 SMs.  The design
// (dp_build.cuh) takes every device-memory load out of the step: the stage
// and b̃ rows come from a ring in shared memory that one warp fills with
// cp.async a chunk ahead; each thread's outputs are fixed before the sweep
// (one level combination each, so no per-step divide); the jump row sits in
// registers for L ≤ 8.  Φ stays double-buffered in shared memory (one
// barrier per step), and the post-shift argmin plane U_i streams straight to
// device memory, unpadded (nt-1, L, B+1), int8 when L ≤ 127 as on the TPU.
// Splitting one start over a thread-block cluster (distributed shared
// memory), the lever at heat scale, is the batched build's cluster form
// (dp_build.cuh); this single build still launches one block, until heat
// has a path in the port.
//
// Interface: plain C, pointers as void*, launched on the caller's stream;
// returns cudaGetLastError() after the launch (0 = launched).

#include "dp_build.cuh"

extern "C" {

// dtype_bytes: 4 (float) or 8 (double); u_bytes: 1 (int8) or 4 (int32); R,
// jsmem, tpl, K: the launch plan (mioc_tpu_torch/ops/bellman_cuda.py).
// Returns a cudaError_t value (0 = success); -1 for an unsupported type pair
// or plan.
int mioc_dp_build(const void* stage, const void* btilde, const void* jump,
                  void* U, void* phi0, int nt, int L, int B, int smax, int R, int jsmem,
                  int tpl, int K, int dtype_bytes, int u_bytes, void* stream) {
  return mioc::dp_build_dispatch<false>(stage, btilde, jump, U, phi0, 1, nt, L, B, smax, R,
                                        jsmem, tpl, K, 1, 0, dtype_bytes, u_bytes, stream);
}

}  // extern "C"
