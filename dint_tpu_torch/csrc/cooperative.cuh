// cooperative.cuh: the occupancy query and the cooperative launch of the
// port's one-launch kernels with a grid barrier (lock_arbitrate.cu,
// lock_validate.cu, scalar_scatter.cu). A cooperative launch
// (cudaLaunchKernelEx with cudaLaunchAttributeCooperative, which stream
// capture accepts) guarantees that every block of the grid is resident at
// once, so `cooperative_groups::this_grid().sync()` cannot deadlock; the
// card refuses a grid it cannot hold at once. Since CUDA 11 a grid sync
// needs no relocatable device code, so the libraries build with
// ops/_build.py's plain flags.
#pragma once
#include <cuda_runtime.h>

namespace {

// The most blocks of `kernel` (`threads` a block) that a cooperative launch
// may have on `device`: its SM count times the blocks an SM holds at once.
// cudaErrorNotSupported where the device has no cooperative launch.
template <typename Kernel>
cudaError_t cooperative_grid(Kernel kernel, int threads, int device,
                             int* blocks) {
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                         device);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    0);
  if (e != cudaSuccess) return e;
  *blocks = sms * per_sm;
  return cudaSuccess;
}

// One cooperative launch of `kernel(args)` over `blocks` blocks of
// `threads`. A refused launch (cudaErrorCooperativeLaunchTooLarge for a
// grid the card cannot hold at once) returns its error, cleared so that it
// is reported once.
template <typename Kernel, typename Args>
cudaError_t cooperative_launch(Kernel kernel, const Args& args, int blocks,
                               int threads, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args);
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

}  // namespace
