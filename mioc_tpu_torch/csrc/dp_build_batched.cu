// dp_build_batched — the Bellman DP backward sweep for S starts at once, by
// hand for Hopper.
//
// Replaces: mioc_tpu/ops/bellman_pallas.py::_dp_kernel_batched (the TPU
// build behind build_tables_pallas_batched, which jax.vmap of the fused build
// reaches through the _cv_build rule: every multistart build and the
// batched TRM step).  Computes exactly what
// mioc_tpu_torch.ops.bellman.build_tables_batched_plain computes: for each
// start s, the recurrence of dp_build.cuh on stage[s] and btilde[s] with the
// shared jump table, giving U[s] (nt-1, L, B+1) and phi0[s] (L, B+1).
//
// The TPU kernel advances all S starts in lockstep vector ops, (S·Lp)
// sublanes × Bp lanes, because one TPU core runs the grid in order.  On
// Hopper the starts are independent blocks: block s runs the single build's
// body on its own start (the body is shared with dp_build.cu), so S starts
// occupy S of the 132 SMs and run side by side.
//
// What bounds it on this card: each block is the single build — a
// sequential recurrence of nt-1 barrier-separated steps on one SM — so with
// S ≤ 132 the batch takes about one start's time, and only past 132 starts
// (or past the blocks one SM can hold in shared memory) does it queue.  The
// byte and operation bounds over the whole card are S times the single
// build's, still decades below what one SM per start can reach.  Shared
// memory per block is the single build's plan (bellman_cuda.build_plan): the
// Φ double buffer, the jump table where it is not in registers, and the ring
// of staged stage/b̃ rows, at most 232,448 bytes.
//
// Interface: plain C, pointers as void*, launched on the caller's stream;
// returns cudaGetLastError() after the launch (0 = launched).

#include "dp_build.cuh"

extern "C" {

// dtype_bytes: 4 (float) or 8 (double); u_bytes: 1 (int8) or 4 (int32); R,
// jsmem, tpl, K: the launch plan (mioc_tpu_torch/ops/bellman_cuda.py).
// Returns a cudaError_t value (0 = success); -1 for an unsupported type pair
// or plan.
int mioc_dp_build_batched(const void* stage, const void* btilde, const void* jump,
                          void* U, void* phi0, int S, int nt, int L, int B, int smax,
                          int R, int jsmem, int tpl, int K, int dtype_bytes, int u_bytes,
                          void* stream) {
  return mioc::dp_build_dispatch(stage, btilde, jump, U, phi0, S, nt, L, B, smax, R,
                                 jsmem, tpl, K, dtype_bytes, u_bytes, stream);
}

}  // extern "C"
