// Binary-BVH ray traversal for NVIDIA Hopper (sm_90a), walked over
// child-pair nodes (the closest hit near first).
//
// Replaces the TPU kernels of rpt_tpu/ops/bvh_pallas.py:
//   rpt_bvh2_closest  <- _kernel,      via _traverse and bvh_closest_hit_pallas
//   rpt_bvh2_occluded <- _kernel_occl, via _traverse_occl and bvh_occluded_pallas
// The TPU's subtree chunks and (8, 128) tiles exist only for its SMEM/VMEM
// budgets: here the whole tree sits in device memory (the 120k-triangle
// dragon packs into about 12 MB, which the 50 MB L2 holds). These kernels
// take every tree (the scene compiler's fallback where the wide pack is
// refused): a stack too deep for a 128-ray block's shared memory runs in a
// smaller block or, past what one block holds, in a global scratch buffer.
// The pack layout is documented in rpt_tpu_torch/ops/bvh2.py, which also
// holds the plain torch version and the launch plan.
//
// The walk itself is csrc/pair_walk.cuh, instantiated one-level here and
// two-level in tlas2.cu: one ray per thread, a 64-byte child-pair node per
// visit, on a stack sized by the pack's exact `stack_depth`, the closest
// hit loading the next node while it tests the current node's leaves (that
// header says what bounds the walk on this card and what the design does
// about it). The kernels below are its thin wrappers, one per query and stack
// space.
//
// Each query comes in two real types (walk.cuh): rpt_bvh2_closest and
// rpt_bvh2_occluded walk float32 rays over the float32 pack, their `_f64`
// twins float64 rays over the float64 pack (float64 triangle rows, float
// boxes rounded outward), the counterpart of the reference's float64 XLA
// loop, since its Pallas kernels do not run under jax_enable_x64. Both
// float64 walks test their boxes in float against a float copy of the ray
// (pair_walk.cuh; below, what was measured).
//
// C interface for ctypes: each entry point launches on the given stream
// with `block` threads per block, allocates nothing (the caller passes the
// global stack, or null for the shared one), and returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// block size or shared stack the launch cannot take. The kernel adds one
// to `launches` when it runs, unless it is null (count.cuh).
// rpt_bvh2_occupancy reads a kernel's registers, spill and blocks per SM
// at a launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "count.cuh"      // count_launch
#include "pair_walk.cuh"  // pair_walk, pair_walk_occupancy, kMaxSmem

namespace {

// No launch bound or register cap: __maxnreg__(56) and (48) ran the closest
// hit 1.01x and 1.03x slower on the dragon in turns ((48) spilled), and
// under (64) the prefetching closest hit spills (PERF.md). The float64 walk
// (Real = double) has none either. Its closest hit tests its boxes in float
// in the prefetching loop (pair_walk.cuh): in turns, 0.0250 -> 0.0238 ms a
// launch on the toy plane and 0.526 -> 0.477 on the 120k-triangle trefoil,
// at the parent's 128 registers and 16 warps a SM. Every step that bought
// warps was slower than that on both (PERF.md): plane-first rows
// (70 registers, 28 warps) 1.15x / 1.13x; the loop without prefetch (104
// registers) 1.23x / 1.30x, with plane-first rows (62, 32 warps) 1.29x /
// 1.32x; caps of 5, 6, 7 and 8 blocks of 128 rays (96, 80, 72, 64
// registers; 24-160 bytes of spill) 1.08-1.49x on the toy plane, and on the
// trefoil 0.99x (cap 5) to 1.21x. The rule that chose: the fastest on the
// toy plane, the kernel's row, of the designs within 2% of the parent on
// the trefoil.
//
// The float64 any hit tests its boxes in float too, in the loop that tests
// leaves first, rows whole, no cap: in turns (graph ms a launch, PERF.md)
// 0.4635 -> 0.4326 on the trefoil (1.071x) and 0.0154 -> 0.0142 on the toy
// plane (1.087x), at 84 registers and 20 warps a SM (80 and 24 before).
// Against it (plane-first rows, caps and near-first order against its twin
// with t_max rounded once a ray, level with it), on the trefoil / the toy
// plane: plane-first rows (48 registers, 40 warps) 1.124x / 1.288x slower;
// caps of 6, 7 and 8 blocks of 128 rays (80, 72, 64 registers; 0, 24, 64
// bytes of spill) 1.073x, 1.006x, 1.062x / 1.16x, 1.10x, 1.17x, and on
// plane-first rows 1.03-1.05x / 1.13-1.17x; near-first order 1.001x /
// 1.085x (3.8% more box tests); the prefetching loop (98 registers) 1.070x
// / 1.001x; a leaf's rows without the early exit (104) 1.10x / 1.12x. t_max
// rounded to float once a ray (86 registers) and the double ray loaded
// again at each leaf (84) ran level with it, within what a second copy of
// the same tree differed by (0.3%).
// The rule that chose: the fastest on the trefoil, where the kernel lost
// the most, of the designs within 2% of the parent on the toy plane; of
// designs level within that 0.3%, the one with the least code.
template <bool kOccl, bool kGlobalStack, typename Real>
__global__ void
bvh2_walk(const float4* __restrict__ nodes, const Real* __restrict__ tris, const Real* __restrict__ o,
          const Real* __restrict__ d, const bool* __restrict__ active, const Real* __restrict__ t_max,
          int n, Real t_min, unsigned* __restrict__ global_stack, int depth, Real* __restrict__ t_out,
          int* __restrict__ id_out, bool* __restrict__ occ_out, unsigned long long* launches) {
  count_launch(launches);
  pair_walk<kOccl, false, kGlobalStack>(nodes, 0, (const Real*)nullptr, tris, o, d, active, t_max, n, t_min,
                                        global_stack, depth, t_out, id_out, nullptr, occ_out);
}

// Lets the shared-stack kernel take the most dynamic shared memory a block
// holds. Set once per kernel and card, on the first launch there that needs
// more than the default 48 KB, not on every launch: small trees are
// launch-bound.
template <bool kOccl, typename Real>
cudaError_t allow_shared_stack() {
  static PerCard state;
  return once_per_card(state, [] {
    return cudaFuncSetAttribute(bvh2_walk<kOccl, false, Real>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kMaxSmem);
  });
}

// Launch on `stream`: `block` threads per block and a stack of `depth`
// levels per thread, in `global_stack` if given, else in dynamic shared
// memory.
template <bool kOccl, typename Real>
int launch(int block, int depth, unsigned* global_stack, int64_t n, cudaStream_t stream, const float* nodes,
           const Real* tris, const Real* o, const Real* d, const bool* active, const Real* t_max,
           Real t_min, Real* t_out, int* id_out, bool* occ_out, unsigned long long* launches) {
  if (n <= 0) return 0;
  if (block <= 0 || block > kBlock || depth < 0) return (int)cudaErrorInvalidValue;
  const int grid = (int)((n + block - 1) / block);
  const float4* nodes4 = reinterpret_cast<const float4*>(nodes);
  if (global_stack != nullptr) {
    bvh2_walk<kOccl, true, Real><<<grid, block, 0, stream>>>(nodes4, tris, o, d, active, t_max, (int)n, t_min,
                                                             global_stack, depth, t_out, id_out, occ_out, launches);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)block * (size_t)depth * sizeof(unsigned);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_shared_stack<kOccl, Real>();
    if (err != cudaSuccess) return (int)err;
  }
  bvh2_walk<kOccl, false, Real><<<grid, block, smem, stream>>>(nodes4, tris, o, d, active, t_max, (int)n, t_min,
                                                               nullptr, depth, t_out, id_out, occ_out, launches);
  return (int)cudaGetLastError();
}

// The occupancy (pair_walk.cuh pair_walk_occupancy) of one kernel at a
// launch of `block` threads and `smem` bytes of dynamic shared memory a
// block (0 with the global stack).
template <bool kOccl, bool kGlobalStack, typename Real>
cudaError_t occupancy(int block, size_t smem, int* out) {
  return pair_walk_occupancy(bvh2_walk<kOccl, kGlobalStack, Real>, allow_shared_stack<kOccl, Real>, block, smem, out);
}

}  // namespace

extern "C" {

// The occupancy (above) of the kernel of `kind` on the current card: bit 0
// the any hit, bit 1 float64, bit 2 the global stack. Returns a CUDA error.
int rpt_bvh2_occupancy(int kind, int block, int smem, int* out) {
  if (block <= 0 || block > kBlock || smem < 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)smem;
  switch (kind) {
    case 0: return (int)occupancy<false, false, float>(block, bytes, out);
    case 1: return (int)occupancy<true, false, float>(block, bytes, out);
    case 2: return (int)occupancy<false, false, double>(block, bytes, out);
    case 3: return (int)occupancy<true, false, double>(block, bytes, out);
    case 4: return (int)occupancy<false, true, float>(block, bytes, out);
    case 5: return (int)occupancy<true, true, float>(block, bytes, out);
    case 6: return (int)occupancy<false, true, double>(block, bytes, out);
    case 7: return (int)occupancy<true, true, double>(block, bytes, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

int rpt_bvh2_closest(const float* nodes, const float* tris, const float* o, const float* d, const bool* active,
                     int64_t n, float t_min, float* t_out, int* id_out, int block, int depth,
                     unsigned* global_stack, unsigned long long* launches, void* stream) {
  return launch<false, float>(block, depth, global_stack, n, (cudaStream_t)stream, nodes, tris, o, d, active,
                              nullptr, t_min, t_out, id_out, nullptr, launches);
}

int rpt_bvh2_occluded(const float* nodes, const float* tris, const float* o, const float* d, const bool* active,
                      const float* t_max, int64_t n, float t_min, bool* occ_out, int block, int depth,
                      unsigned* global_stack, unsigned long long* launches, void* stream) {
  return launch<true, float>(block, depth, global_stack, n, (cudaStream_t)stream, nodes, tris, o, d, active,
                             t_max, t_min, nullptr, nullptr, occ_out, launches);
}

int rpt_bvh2_closest_f64(const float* nodes, const double* tris, const double* o, const double* d,
                         const bool* active, int64_t n, double t_min, double* t_out, int* id_out, int block,
                         int depth, unsigned* global_stack, unsigned long long* launches, void* stream) {
  return launch<false, double>(block, depth, global_stack, n, (cudaStream_t)stream, nodes, tris, o, d, active,
                               nullptr, t_min, t_out, id_out, nullptr, launches);
}

int rpt_bvh2_occluded_f64(const float* nodes, const double* tris, const double* o, const double* d,
                          const bool* active, const double* t_max, int64_t n, double t_min, bool* occ_out,
                          int block, int depth, unsigned* global_stack, unsigned long long* launches,
                          void* stream) {
  return launch<true, double>(block, depth, global_stack, n, (cudaStream_t)stream, nodes, tris, o, d, active,
                              t_max, t_min, nullptr, nullptr, occ_out, launches);
}

}  // extern "C"
