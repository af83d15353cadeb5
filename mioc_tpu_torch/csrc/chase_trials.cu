// chase_trials — the trial-wave chase: Kt budget caps per start against that
// start's one table set, by hand for Hopper: the chunked chase of state maps
// over S table sets of Kt rows each.
//
// Replaces: mioc_tpu/ops/backtrack_pallas.py::_bt_kernel_trials (the TPU
// kernel behind backtrack_pallas_trials / _backtrack_trials_impl: the
// speculative trial wave of the batched multistart).  Computes exactly what
// mioc_tpu_torch.ops.bellman.backtrack_trials_plain computes: row (s, t) is
// the chase of chase.cu on start s's tables at the cap B_trials[s, t]:
//
//   seed:  (l, b) = flat argmin of phi0[s] masked to b ≤ B_trials[s, t],
//          ties to the smallest flat index l·(B+1) + b;
//   step k = 0 … nt-2:  l' = U[s, k, l, b];  b -= b̃[s, k, l];  l = l';
//   out[s, t, 0] = seed l, out[s, t, k+1] = l after step k.
//
// The caps are an int32 (S, Kt) tensor in device memory.  Kt ≤ 128.
//
// The TPU kernel DMAs each U plane once per step for all Kt trials.  The
// first Hopper design gave each start a block whose Kt threads walked all
// nt-1 dependent steps out of device memory in lockstep (~185 ns a step at
// fishing, 189 µs a wave).  This one runs chase_chunked.cuh with G = S table
// sets and R = S·Kt rows, row r on set r / Kt: the state maps of a chunk
// depend on U and b̃ only, never on the cap, so phase A maps each start's
// chunks once for all its Kt caps, phase B chains each row (a warp per row,
// the seed a warp-wide argmin of its start's phi0), and phase C re-walks
// each staged chunk for the Kt rows of its start, a thread per row.
//
// What bounds it on this card: as for chase_batched.cu at G = S (phase A's
// shared-memory gathers, phase C's one-thread re-walk of a chunk, phase B's
// C dependent L2 reads per row, two grid barriers); the rows add only phase
// B's warps and phase C's threads.  The wrapper
// (backtrack_cuda.chase_plan with sets=S, rows=S·Kt) picks the chunks per
// set so that the S·C tasks fill the card.
//
// Measured (python -m mioc_tpu_torch.profile_kernels; NVIDIA H100 80GB HBM3,
// 700 W), fishing S=32, Kt=9, float64: 36 µs on the device (the first
// design: 189); without phase A's maps 23, without phase C's re-walk 26.
//
// Interface: plain C, pointers as void*, launched on the caller's stream;
// returns the launch's cudaError_t (0 = launched).

#include "chase_chunked.cuh"

namespace {
constexpr int kMaxTrials = 128;
}  // namespace

extern "C" {

// dtype_bytes: 4 (float) or 8 (double) for phi0; u_bytes: 1 (int8) or 4
// (int32).  phi0 (S, L, B+1), btilde (S, nt, L), U (S, nt-1, L, B+1),
// B_trials (S, Kt) and out (S, Kt, nt), all contiguous.  scratch:
// S·C·L·(B+1) + S·Kt·C + S·Kt int32 on the device (E (S, C, P), entry (S·Kt,
// C), first_bad (S·Kt,)).  Tc, C, staged: the plan of
// backtrack_cuda.chase_plan with sets=S, rows=S·Kt.  Returns a cudaError_t value (0 = success; a refused
// cooperative launch returns its error); -1 for an unsupported type pair or
// plan, or Kt outside 1 … 128.
int mioc_chase_trials(const void* phi0, const void* btilde, const void* U,
                      const void* B_trials, void* out, void* scratch, int S, int Kt, int nt,
                      int L, int B, int Tc, int C, int staged, int dtype_bytes, int u_bytes,
                      void* stream) {
  if (Kt < 1 || Kt > kMaxTrials || S < 1 || Tc < 1 || C < 0 || (long long)C * Tc < nt - 1)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long P = (long long)L * (B + 1);
  const long long sb = (long long)nt * L, su = (long long)(nt - 1) * P;
#define MIOC_TRIALS_ARGS                                                                   \
  phi0, btilde, U, B_trials, 0, out, scratch, S * Kt, S, Kt, nt, L, B, Tc, C, staged, P, \
      sb, su, s
  if (dtype_bytes == 8 && u_bytes == 1) return mioc::launch_chunked<double, int8_t>(MIOC_TRIALS_ARGS);
  if (dtype_bytes == 8 && u_bytes == 4) return mioc::launch_chunked<double, int32_t>(MIOC_TRIALS_ARGS);
  if (dtype_bytes == 4 && u_bytes == 1) return mioc::launch_chunked<float, int8_t>(MIOC_TRIALS_ARGS);
  if (dtype_bytes == 4 && u_bytes == 4) return mioc::launch_chunked<float, int32_t>(MIOC_TRIALS_ARGS);
#undef MIOC_TRIALS_ARGS
  return -1;
}

}  // extern "C"
