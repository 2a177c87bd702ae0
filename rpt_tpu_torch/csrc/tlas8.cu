// Two-level wide-BVH ray traversal for instanced meshes on NVIDIA Hopper
// (sm_90a): an 8-ary TLAS over instances and one shared 8-ary BLAS per mesh.
//
// Replaces the TPU kernels of rpt_tpu/ops/tlas8_pallas.py:
//   rpt_tlas8_closest  <- _make_kernel_t8(occl=False, resident=True|False),
//                         via _traverse_t8 and tlas8_closest_hit_pallas
//   rpt_tlas8_occluded <- _make_kernel_t8(occl=True, resident=True|False),
//                         via _traverse_t8_occl and tlas8_occluded_pallas
// One kernel covers both TPU memory modes: the "resident" and "dma" modes,
// the ring of node copies and the pending-leaf double buffer exist only to
// fit the TPU's VMEM and hide its DMA latency. Here the whole table sits in
// device memory (the 768-instance brick city packs into a few MB, which the
// 50 MB L2 holds). The pack layout is documented in
// rpt_tpu_torch/ops/tlas8.py, which also holds the plain torch versions
// these kernels are tested against.
//
// The walk itself is csrc/group_walk.cuh, instantiated two-level here and
// one-level in bvh8.cu: one ray per thread, a node-group stack in shared
// memory sized by the pack's exact `group_depth`, an instance child
// re-expressing the ray in its frame, ties kept in the reference's preorder
// (that header says what bounds the walk on this card and what the design
// does about it, for float32 and for float64). `inst` is the pack's
// `inst_rows`: one 16-real record per TLAS leaf rank.
//
// Each query comes in two real types (walk.cuh): rpt_tlas8_closest and
// rpt_tlas8_occluded walk float32 rays over the float32 pack, their `_f64`
// twins float64 rays over the float64 pack (float64 instance rows and
// triangle rows, float boxes rounded outward), the counterpart of the
// reference's float64 XLA loop (rpt_tpu/ops/tlas.py instanced_closest_hit),
// since its Pallas kernels do not run under jax_enable_x64.
//
// C interface for ctypes: each entry point launches on the given stream,
// allocates nothing, and returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue if the stack does not fit in one block's shared
// memory. The kernel adds one to `launches` when it runs, unless it is null
// (count.cuh). rpt_tlas8_occupancy reads a kernel's registers, spill and
// blocks per SM at that launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "count.cuh"       // count_launch
#include "group_walk.cuh"  // group_walk, group_stack_smem, group_walk_occupancy

namespace {

template <bool kOccl>
__global__ void __launch_bounds__(kBlock)
tlas8_walk(const float4* __restrict__ bounds, const int* __restrict__ meta, int n_tlas,
           const float* __restrict__ inst, const float* __restrict__ tris, const float* __restrict__ o,
           const float* __restrict__ d, const bool* __restrict__ active,
           const float* __restrict__ t_max, int n, float t_min, float* __restrict__ t_out,
           int* __restrict__ id_out, int* __restrict__ inst_out, bool* __restrict__ occ_out,
           unsigned long long* launches) {
  count_launch(launches);
  group_walk<kOccl, true>(bounds, meta, n_tlas, inst, tris, o, d, active, t_max, n, t_min, t_out, id_out, inst_out,
                          occ_out);
}

// The float64 walk (group_walk.cuh's design for it: float boxes,
// plane-first triangle rows), capped so that kMinBlocksF64 blocks of 128
// rays fit an SM's register file: the closest hit at 8 blocks (64
// registers, 80 bytes of spill, 32 warps), the any hit at 7 (72 registers,
// 40 bytes, 28 warps). Without a cap ptxas takes 123 and 122 registers (16
// warps); each cap of 6 to 8 blocks measured faster on the brick city, and
// these two the fastest (PERF.md).
template <bool kOccl>
constexpr int kMinBlocksF64 = kOccl ? 7 : 8;

template <bool kOccl>
__global__ void __launch_bounds__(kBlock, kMinBlocksF64<kOccl>)
tlas8_walk_f64(const float4* __restrict__ bounds, const int* __restrict__ meta, int n_tlas,
               const double* __restrict__ inst, const double* __restrict__ tris, const double* __restrict__ o,
               const double* __restrict__ d, const bool* __restrict__ active,
               const double* __restrict__ t_max, int n, double t_min, double* __restrict__ t_out,
               int* __restrict__ id_out, int* __restrict__ inst_out, bool* __restrict__ occ_out,
               unsigned long long* launches) {
  count_launch(launches);
  group_walk<kOccl, true>(bounds, meta, n_tlas, inst, tris, o, d, active, t_max, n, t_min, t_out, id_out, inst_out,
                          occ_out);
}

template <bool kOccl, typename Real>
constexpr auto walk_kernel() {
  if constexpr (sizeof(Real) == 4) {
    return tlas8_walk<kOccl>;
  } else {
    return tlas8_walk_f64<kOccl>;
  }
}

// Lets the kernel take the most dynamic shared memory a block holds. Set
// once per kernel and card, on the first launch there that needs more than
// 48 KB.
template <bool kOccl, typename Real>
cudaError_t allow_group_stack() {
  static PerCard state;
  return once_per_card(state, [] {
    return cudaFuncSetAttribute(walk_kernel<kOccl, Real>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kMaxSmem);
  });
}

// Launch on `stream` with a group stack of `depth` levels per thread.
template <bool kOccl, typename Real>
int launch(int depth, int64_t n, cudaStream_t stream, const float* bounds, const int* meta, int n_tlas,
           const Real* inst, const Real* tris, const Real* o, const Real* d, const bool* active,
           const Real* t_max, Real t_min, Real* t_out, int* id_out, int* inst_out, bool* occ_out,
           unsigned long long* launches) {
  if (n <= 0) return 0;
  size_t smem;
  cudaError_t err = group_stack_smem(depth, &smem);
  if (err == cudaSuccess && smem > 48 * 1024) err = allow_group_stack<kOccl, Real>();
  if (err != cudaSuccess) return (int)err;
  const auto kernel = walk_kernel<kOccl, Real>();
  kernel<<<grid_for(n), kBlock, smem, stream>>>(
      reinterpret_cast<const float4*>(bounds), meta, n_tlas, inst, tris, o, d, active, t_max, (int)n, t_min, t_out,
      id_out, inst_out, occ_out, launches);
  return (int)cudaGetLastError();
}

// The occupancy of one kernel at the launch of a group stack of `depth`
// levels (group_walk.cuh group_walk_occupancy).
template <bool kOccl, typename Real>
cudaError_t occupancy(int depth, int* out) {
  return group_walk_occupancy(walk_kernel<kOccl, Real>(), allow_group_stack<kOccl, Real>, depth, out);
}

}  // namespace

extern "C" {

// The occupancy (above) of the kernel of `kind` on the current card: bit 0
// the any hit, bit 1 float64. Returns a CUDA error.
int rpt_tlas8_occupancy(int kind, int depth, int* out) {
  switch (kind) {
    case 0: return (int)occupancy<false, float>(depth, out);
    case 1: return (int)occupancy<true, float>(depth, out);
    case 2: return (int)occupancy<false, double>(depth, out);
    case 3: return (int)occupancy<true, double>(depth, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

int rpt_tlas8_closest(const float* bounds, const int* meta, int n_tlas, int depth, const float* inst,
                      const float* tris, const float* o, const float* d, const bool* active, int64_t n, float t_min,
                      float* t_out, int* id_out, int* inst_out, unsigned long long* launches, void* stream) {
  return launch<false, float>(depth, n, (cudaStream_t)stream, bounds, meta, n_tlas, inst, tris, o, d, active,
                              nullptr, t_min, t_out, id_out, inst_out, nullptr, launches);
}

int rpt_tlas8_occluded(const float* bounds, const int* meta, int n_tlas, int depth, const float* inst,
                       const float* tris, const float* o, const float* d, const bool* active, const float* t_max,
                       int64_t n, float t_min, bool* occ_out, unsigned long long* launches, void* stream) {
  return launch<true, float>(depth, n, (cudaStream_t)stream, bounds, meta, n_tlas, inst, tris, o, d, active, t_max,
                             t_min, nullptr, nullptr, nullptr, occ_out, launches);
}

int rpt_tlas8_closest_f64(const float* bounds, const int* meta, int n_tlas, int depth, const double* inst,
                          const double* tris, const double* o, const double* d, const bool* active, int64_t n,
                          double t_min, double* t_out, int* id_out, int* inst_out, unsigned long long* launches,
                          void* stream) {
  return launch<false, double>(depth, n, (cudaStream_t)stream, bounds, meta, n_tlas, inst, tris, o, d, active,
                               nullptr, t_min, t_out, id_out, inst_out, nullptr, launches);
}

int rpt_tlas8_occluded_f64(const float* bounds, const int* meta, int n_tlas, int depth, const double* inst,
                           const double* tris, const double* o, const double* d, const bool* active,
                           const double* t_max, int64_t n, double t_min, bool* occ_out, unsigned long long* launches,
                           void* stream) {
  return launch<true, double>(depth, n, (cudaStream_t)stream, bounds, meta, n_tlas, inst, tris, o, d, active, t_max,
                              t_min, nullptr, nullptr, nullptr, occ_out, launches);
}

}  // extern "C"
