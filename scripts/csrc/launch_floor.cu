// An empty kernel launched on a grid of thread-block clusters: the device
// time of one launch that does no work, the floor that chip_smoke.py and
// scripts/torch_step_kernels_ab.py read the step epilogues' times against.
// Not a kernel of any sampler path.

#include <cuda_runtime.h>

__global__ void empty_cluster_kernel() {}

// `rows` clusters of `cluster` CTAs of 256 threads, as the step epilogues
// launch them
extern "C" int launch_floor(int cluster, int rows, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(cluster, rows);
  cfg.blockDim = dim3(256);
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, empty_cluster_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
