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
// Each query comes in two real types (walk.cuh): rpt_bvh8_closest and
// rpt_bvh8_occluded walk float32 rays over the float32 pack, their `_f64`
// twins float64 rays over the float64 pack (float64 triangle rows, float
// boxes rounded outward), the counterpart of the reference's float64 XLA
// loop, since its Pallas kernels do not run under jax_enable_x64. The
// float64 walk tests its boxes in float against a float copy of the ray,
// made once (group_walk.cuh); below, why its rows stay whole and its
// registers uncapped.
//
// C interface for ctypes: each entry point launches on the given stream,
// allocates nothing, and returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue if the stack does not fit in one block's shared
// memory. The kernel adds one to `launches` when it runs, unless it is null
// (count.cuh). rpt_bvh8_occupancy reads a kernel's registers, spill and
// blocks per SM at that launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "count.cuh"       // count_launch
#include "group_walk.cuh"  // group_walk, group_stack_smem, group_walk_occupancy

namespace {

// A cap of 64 registers, not __launch_bounds__(kBlock): under the launch
// bound ptxas gave the any hit 63 registers and an 8-byte spill; capped at
// 64 neither kernel spills, in the same time (PERF.md, Findings).
template <bool kOccl>
__global__ void __maxnreg__(64)
bvh8_walk(const float4* __restrict__ bounds, const int* __restrict__ meta,
          const float* __restrict__ tris, const float* __restrict__ o,
          const float* __restrict__ d, const bool* __restrict__ active,
          const float* __restrict__ t_max, int n, float t_min, float* __restrict__ t_out,
          int* __restrict__ id_out, bool* __restrict__ occ_out, unsigned long long* launches) {
  count_launch(launches);
  group_walk<kOccl, false>(bounds, meta, 0, (const float*)nullptr, tris, o, d, active, t_max, n, t_min, t_out,
                           id_out, nullptr, occ_out);
}

// The float64 walk. Measured on the trefoil's wavefronts in turns
// (PERF.md): the float box test took the closest hit from 0.48 to 0.41 ms
// a launch and the any hit from 0.36 to 0.32, at 96 and 86 registers (20
// warps a SM). What paid two-level did not pay here: plane-first rows
// (walk.cuh tri_plane) took it to 69 / 64 registers and 28 / 32 warps but
// made it 1.29x / 1.34x slower, as the rest of a row is then loaded in a
// second round after the plane test; and every cap of 6, 7 or 8 blocks of
// 128 rays (80, 72, 64 registers, 16-128 bytes of spill) was 1.02-1.25x
// slower than none. So whole rows, ten 16-byte loads in flight at once,
// and no cap below the launch bound's.
template <bool kOccl>
__global__ void __launch_bounds__(kBlock)
bvh8_walk_f64(const float4* __restrict__ bounds, const int* __restrict__ meta,
              const double* __restrict__ tris, const double* __restrict__ o,
              const double* __restrict__ d, const bool* __restrict__ active,
              const double* __restrict__ t_max, int n, double t_min, double* __restrict__ t_out,
              int* __restrict__ id_out, bool* __restrict__ occ_out, unsigned long long* launches) {
  count_launch(launches);
  group_walk<kOccl, false>(bounds, meta, 0, (const double*)nullptr, tris, o, d, active, t_max, n, t_min, t_out,
                           id_out, nullptr, occ_out);
}

template <bool kOccl, typename Real>
constexpr auto walk_kernel() {
  if constexpr (sizeof(Real) == 4) {
    return bvh8_walk<kOccl>;
  } else {
    return bvh8_walk_f64<kOccl>;
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
int launch(int depth, int64_t n, cudaStream_t stream, const float* bounds, const int* meta,
           const Real* tris, const Real* o, const Real* d, const bool* active, const Real* t_max,
           Real t_min, Real* t_out, int* id_out, bool* occ_out, unsigned long long* launches) {
  if (n <= 0) return 0;
  size_t smem;
  cudaError_t err = group_stack_smem(depth, &smem);
  if (err == cudaSuccess && smem > 48 * 1024) err = allow_group_stack<kOccl, Real>();
  if (err != cudaSuccess) return (int)err;
  const auto kernel = walk_kernel<kOccl, Real>();
  kernel<<<grid_for(n), kBlock, smem, stream>>>(
      reinterpret_cast<const float4*>(bounds), meta, tris, o, d, active, t_max, (int)n, t_min, t_out, id_out,
      occ_out, launches);
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
int rpt_bvh8_occupancy(int kind, int depth, int* out) {
  switch (kind) {
    case 0: return (int)occupancy<false, float>(depth, out);
    case 1: return (int)occupancy<true, float>(depth, out);
    case 2: return (int)occupancy<false, double>(depth, out);
    case 3: return (int)occupancy<true, double>(depth, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

int rpt_bvh8_closest(const float* bounds, const int* meta, int depth, const float* tris, const float* o,
                     const float* d, const bool* active, int64_t n, float t_min, float* t_out,
                     int* id_out, unsigned long long* launches, void* stream) {
  return launch<false, float>(depth, n, (cudaStream_t)stream, bounds, meta, tris, o, d, active, nullptr, t_min,
                              t_out, id_out, nullptr, launches);
}

int rpt_bvh8_occluded(const float* bounds, const int* meta, int depth, const float* tris, const float* o,
                      const float* d, const bool* active, const float* t_max, int64_t n,
                      float t_min, bool* occ_out, unsigned long long* launches, void* stream) {
  return launch<true, float>(depth, n, (cudaStream_t)stream, bounds, meta, tris, o, d, active, t_max, t_min,
                             nullptr, nullptr, occ_out, launches);
}

int rpt_bvh8_closest_f64(const float* bounds, const int* meta, int depth, const double* tris, const double* o,
                         const double* d, const bool* active, int64_t n, double t_min, double* t_out,
                         int* id_out, unsigned long long* launches, void* stream) {
  return launch<false, double>(depth, n, (cudaStream_t)stream, bounds, meta, tris, o, d, active, nullptr, t_min,
                               t_out, id_out, nullptr, launches);
}

int rpt_bvh8_occluded_f64(const float* bounds, const int* meta, int depth, const double* tris, const double* o,
                          const double* d, const bool* active, const double* t_max, int64_t n,
                          double t_min, bool* occ_out, unsigned long long* launches, void* stream) {
  return launch<true, double>(depth, n, (cudaStream_t)stream, bounds, meta, tris, o, d, active, t_max, t_min,
                              nullptr, nullptr, occ_out, launches);
}

}  // extern "C"
