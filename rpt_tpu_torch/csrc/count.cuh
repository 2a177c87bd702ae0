// The launch count of a kernel (rpt_tpu_torch/kernels.py `launch_counter`).
// A counted wrapper passes the address of its int64 count, a comparison
// passes null; one thread adds one each time the kernel runs, so a launch
// recorded in a CUDA graph counts on every replay.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void count_launch(unsigned long long* launches) {
  if (launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1ull);
}
