// launch_probe — an empty kernel, launched three ways through the same plain
// C interface and ctypes route as the port's kernels, so that
// profile_kernels.py can time the host side of a call apart from any
// kernel's work: an ordinary launch (<<<>>>), a cooperative launch
// (cudaLaunchCooperativeKernel, as chase.cu and chase_batched.cu launch) and
// a cluster launch (cudaLaunchKernelEx with a cluster dimension, as
// chase_vec.cu launches).  Not a kernel of any path.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel(int) {}

}  // namespace

extern "C" {

// kind: 0 ordinary, 1 cooperative, 2 cluster of `blocks` CTAs (≤ 8).
// Returns a cudaError_t value.
int mioc_launch_probe(int kind, int blocks, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int arg = 0;
  cudaError_t e;
  if (kind == 0) {
    empty_kernel<<<blocks, threads, 0, s>>>(arg);
    e = cudaSuccess;
  } else if (kind == 1) {
    void* args[] = {&arg};
    e = cudaLaunchCooperativeKernel((const void*)empty_kernel, dim3(blocks), dim3(threads),
                                    args, 0, s);
  } else {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = blocks;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.stream = s;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, empty_kernel, arg);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
