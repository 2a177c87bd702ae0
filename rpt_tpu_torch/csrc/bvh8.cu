// Wide-BVH (8-ary) ray traversal for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of rpt_tpu/ops/bvh8_pallas.py:
//   rpt_bvh8_closest  <- _make_kernel8(occl=False), via bvh8_closest_hit_pallas
//   rpt_bvh8_occluded <- _make_kernel8(occl=True),  via bvh8_occluded_pallas
// The TPU's chunking, visit-plan prepass and (8, 128) tiles exist only for
// its SMEM/VMEM budgets: here the whole tree sits in device memory (the
// 120k-triangle dragon packs into ~11 MB, which the 50 MB L2 holds). The
// node and triangle layouts are documented in rpt_tpu_torch/ops/bvh8.py,
// which packs them and holds the plain torch versions these kernels are
// tested against.
//
// The walk itself is csrc/group_walk.cuh, instantiated one-level here and
// two-level in tlas8.cu: one ray per thread, a node-group stack in shared
// memory sized by the pack's exact `group_depth`, a node's references read
// with two 16-byte loads, its hit leaves tested at once (that header says
// what bounds the walk on this card and what the design does about it).
//
// C interface for ctypes: each entry point launches on the given stream,
// allocates nothing, and returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue if the stack does not fit in one block's shared
// memory. The kernel adds one to `launches` when it runs, unless it is null
// (count.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "count.cuh"       // count_launch
#include "group_walk.cuh"  // group_walk, group_stack_smem

namespace {

// A cap of 64 registers, not __launch_bounds__(kBlock): under the launch
// bound ptxas gave the any hit 63 registers and an 8-byte spill; capped at
// 64 neither kernel spills, in the same time (PERF.md, Findings).
template <bool kOccl>
__global__ void __maxnreg__(64)
bvh8_walk(const float4* __restrict__ bounds, const int* __restrict__ meta,
          const float4* __restrict__ tris, const float* __restrict__ o,
          const float* __restrict__ d, const bool* __restrict__ active,
          const float* __restrict__ t_max, int n, float t_min, float* __restrict__ t_out,
          int* __restrict__ id_out, bool* __restrict__ occ_out, unsigned long long* launches) {
  count_launch(launches);
  group_walk<kOccl, false>(bounds, meta, 0, nullptr, nullptr, tris, o, d, active, t_max, n, t_min, t_out,
                           id_out, nullptr, occ_out);
}

// Lets the kernel take the most dynamic shared memory a block holds. Set
// once per kernel, on the first launch that needs more than 48 KB.
template <bool kOccl>
cudaError_t allow_group_stack() {
  static const cudaError_t err =
      cudaFuncSetAttribute(bvh8_walk<kOccl>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  return err;
}

// Launch on `stream` with a group stack of `depth` levels per thread.
template <bool kOccl>
int launch(int depth, int64_t n, cudaStream_t stream, const float* bounds, const int* meta,
           const float* tris, const float* o, const float* d, const bool* active, const float* t_max,
           float t_min, float* t_out, int* id_out, bool* occ_out, unsigned long long* launches) {
  if (n <= 0) return 0;
  size_t smem;
  cudaError_t err = group_stack_smem(depth, &smem);
  if (err == cudaSuccess && smem > 48 * 1024) err = allow_group_stack<kOccl>();
  if (err != cudaSuccess) return (int)err;
  bvh8_walk<kOccl><<<grid_for(n), kBlock, smem, stream>>>(
      reinterpret_cast<const float4*>(bounds), meta, reinterpret_cast<const float4*>(tris), o, d,
      active, t_max, (int)n, t_min, t_out, id_out, occ_out, launches);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rpt_bvh8_closest(const float* bounds, const int* meta, int depth, const float* tris, const float* o,
                     const float* d, const bool* active, int64_t n, float t_min, float* t_out,
                     int* id_out, unsigned long long* launches, void* stream) {
  return launch<false>(depth, n, (cudaStream_t)stream, bounds, meta, tris, o, d, active, nullptr, t_min,
                       t_out, id_out, nullptr, launches);
}

int rpt_bvh8_occluded(const float* bounds, const int* meta, int depth, const float* tris, const float* o,
                      const float* d, const bool* active, const float* t_max, int64_t n,
                      float t_min, bool* occ_out, unsigned long long* launches, void* stream) {
  return launch<true>(depth, n, (cudaStream_t)stream, bounds, meta, tris, o, d, active, t_max, t_min,
                      nullptr, nullptr, occ_out, launches);
}

}  // extern "C"
