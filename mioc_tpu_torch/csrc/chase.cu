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
// The body is chase_chunked.cuh's, with one table set and one row (G = R =
// 1), which chase_batched.cu runs over many.
//
// Measured (python -m mioc_tpu_torch.profile_kernels; NVIDIA H100 80GB HBM3,
// 700 W): 13–14 µs on the device at fishing, 16 at conv, 30 at heat scale,
// with about 32 chunks (16, 20 and 41 before the shared body's walks read
// shared memory through a pointer known to be shared); 8 or 128 chunks were
// slower at fishing and conv (phase A's walks, or phase B's dependent reads,
// grow), 64 slightly faster at heat.  A call's host side (the wrapper and the
// launch, 30–50 µs) takes longer than the kernel.
//
// Interface: plain C, pointers as void*, launched on the caller's stream;
// returns the launch's cudaError_t (0 = launched).

#include "chase_chunked.cuh"

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
#define MIOC_CHASE_ARGS \
  phi0, btilde, U, B_dev, B_new, out, scratch, 1, 1, 1, nt, L, B, Tc, C, staged, 0, 0, 0, s
  if (dtype_bytes == 8 && u_bytes == 1) return mioc::launch_chunked<double, int8_t>(MIOC_CHASE_ARGS);
  if (dtype_bytes == 8 && u_bytes == 4) return mioc::launch_chunked<double, int32_t>(MIOC_CHASE_ARGS);
  if (dtype_bytes == 4 && u_bytes == 1) return mioc::launch_chunked<float, int8_t>(MIOC_CHASE_ARGS);
  if (dtype_bytes == 4 && u_bytes == 4) return mioc::launch_chunked<float, int32_t>(MIOC_CHASE_ARGS);
#undef MIOC_CHASE_ARGS
  return -1;
}

}  // extern "C"
