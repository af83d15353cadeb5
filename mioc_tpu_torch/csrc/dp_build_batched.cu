// dp_build_batched — the Bellman DP backward sweep for S starts at once, or
// for one, by hand for Hopper.
//
// Replaces: mioc_tpu/ops/bellman_pallas.py::_dp_kernel_batched (the TPU
// build behind build_tables_pallas_batched, which jax.vmap of the fused build
// reaches through the _cv_build rule: every multistart build and the
// batched TRM step) and, at S = 1, ::_dp_kernel (the fused single build
// behind build_tables_pallas; a (nt-1, L, B+1) U is laid out as a
// (1, nt-1, L, B+1) one).  Computes exactly what
// mioc_tpu_torch.ops.bellman.build_tables_batched_plain computes: for each
// start s, the recurrence of dp_build.cuh on stage[s] and btilde[s] with the
// shared jump table, giving U[s] (nt-1, L, B+1) and phi0[s] (L, B+1).
//
// The TPU kernels roll the contraction's output through smax+1 static lane
// rotations to apply the budget shift and advance all S starts in lockstep
// vector ops, (S·Lp) sublanes × Bp lanes, because one TPU core runs the grid
// in order.  Here each output reads its shifted column Φ_{i+1}[:, b-s]
// directly from shared memory (with the s > smax guard kept, the value and
// the index are the same), and the starts are independent.  The first
// design gave each start one block running the build's body: a sequential
// recurrence of nt-1 barrier-separated steps on ONE SM, so S = 32 used 32 of
// the 132 SMs, S = 8 used 8 and a single start 1, and at heat scale (L = 36,
// B = 204) a step took ~17.6 µs of one SM's shared-memory loads while the
// other SMs sat idle.
//
// This one launches the body's cluster form where the plan asks for it
// (bellman_cuda.cluster_build_plan, for one start as for S): C CTAs per
// start, one cluster each, CTA k relaxing the budget slice [lo_k, hi_k) of
// all L level combinations with an smax-wide halo below it, pushed each step
// through distributed shared memory by the CTA that owns it, and a cluster
// barrier per step.  C = 1 is the first design's launch, unchanged: one
// block per start, no cluster (fishing and conv, every L ≤ 8).
//
// What bounds it on this card: per start, the nt-1 sequential steps; a step
// costs its slice's relaxations (L candidates each, two shared-memory loads
// per candidate) plus the cluster barrier, so C divides the first and adds
// the second.  The plan takes C > 1 only where the relaxations outweigh the
// barrier, and only as many CTAs as let all S clusters run at once.  A
// single heat-scale start (nt = 500, L = 36, B = 100) takes 16 CTAs of ~7
// budgets each: there the step is the cluster barrier and the halo pushes
// (an smax-wide halo against a 7-wide slice), no longer the relaxation.
// The byte and operation bounds over the whole card are decades below.
//
// Measured (python -m mioc_tpu_torch.profile_kernels, ms per call; NVIDIA
// H100 80GB HBM3, 700 W, float64): heat scale S=8 17.99 with one block per
// start, 4.06–4.13 with 9 CTAs per start, 4.93 with 16 (the card holds 7
// such clusters at once, so two waves).  One start (one run of
// --heat-only; device ms in brackets): at nt 1024, B 204 2.46–2.47 [2.360]
// with 16 CTAs, 17.84–17.94 [17.713] with one block; at heat500 (nt 500,
// B 100) 1.05–1.06 [0.991, ~2.0 µs a step] with 16 CTAs of 7 budgets,
// 4.78–4.81 [4.724] with one block; at large heat (nt 200, B 40) 0.48
// [0.422] with 16 CTAs of 3, 0.43 [0.378] with 8 of 6, 0.91 [0.866] with
// one block.  Fishing S=32: 0.44–0.47 with one block, 1.11–1.24 with any
// C > 1 (a cluster barrier costs ~0.65 µs a step more than the block's).
//
// Interface: plain C, pointers as void*, launched on the caller's stream;
// returns cudaGetLastError() after the launch (0 = launched).

#include "dp_build.cuh"

extern "C" {

// dtype_bytes: 4 (float) or 8 (double); u_bytes: 1 (int8) or 4 (int32); R,
// jsmem, tpl, K, C, H: the launch plan (bellman_cuda.batched_build_plan:
// ring rows, jump table in shared memory, threads per level combination,
// outputs per thread, CTAs per start, halo budgets).  Returns a cudaError_t
// value (0 = success; a refused cluster launch returns its error); -1 for an
// unsupported type pair or plan.
int mioc_dp_build_batched(const void* stage, const void* btilde, const void* jump,
                          void* U, void* phi0, int S, int nt, int L, int B, int smax,
                          int R, int jsmem, int tpl, int K, int C, int H, int dtype_bytes,
                          int u_bytes, void* stream) {
  if (C > 1)
    return mioc::dp_build_dispatch<true>(stage, btilde, jump, U, phi0, S, nt, L, B, smax, R,
                                         jsmem, tpl, K, C, H, dtype_bytes, u_bytes, stream);
  return mioc::dp_build_dispatch<false>(stage, btilde, jump, U, phi0, S, nt, L, B, smax, R,
                                        jsmem, tpl, K, C, H, dtype_bytes, u_bytes, stream);
}

// How many clusters of the plan (C > 1) the card can hold at once
// (cudaOccupancyMaxActiveClusters, into *count); nothing is launched.  0
// means the card does not schedule that cluster.  Returns a cudaError_t
// value, or -1 for an unsupported type pair or plan.
int mioc_dp_build_batched_clusters(int S, int nt, int L, int B, int smax, int R, int jsmem,
                                   int tpl, int K, int C, int H, int dtype_bytes, int u_bytes,
                                   int* count) {
  *count = 0;
  if (C < 2) return -1;
  return mioc::dp_build_dispatch<true>(nullptr, nullptr, nullptr, nullptr, nullptr, S, nt, L,
                                       B, smax, R, jsmem, tpl, K, C, H, dtype_bytes, u_bytes,
                                       nullptr, count);
}

}  // extern "C"
