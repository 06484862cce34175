// An empty kernel: the launch floor. chip_smoke.py times it in the same
// CUDA-graph harness and at the same block count as each kernel of the
// path, so a kernel's time can be read against what a launch of that
// grid costs with no work at all. Not on any path of the package.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
