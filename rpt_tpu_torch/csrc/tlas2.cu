// Two-level binary-BVH ray traversal for instanced meshes on NVIDIA Hopper
// (sm_90a): a binary TLAS with one instance per leaf and one shared binary
// BLAS per mesh, walked over child-pair nodes (the closest hit near first).
//
// Replaces the TPU kernels of rpt_tpu/ops/tlas_pallas.py:
//   rpt_tlas2_closest  <- _kernel,      via _traverse and tlas_closest_hit_pallas
//   rpt_tlas2_occluded <- _kernel_occl, via _traverse_occl and tlas_occluded_pallas
// The TPU kernel keeps every table in SMEM and so refuses scenes past a
// 700,000-byte budget (tlas_pallas_eligible); here the tables sit in device
// memory. These kernels are the last resort for instanced scenes (the
// scene compiler takes them where the wide two-level pack is refused), so
// they take every scene: a stack too deep for a 128-ray block's shared
// memory runs in a smaller block or, past what one block holds, in a
// global scratch buffer. The pack layout is documented in
// rpt_tpu_torch/ops/tlas2.py; the plain torch version and the launch plan
// are in ops/bvh2.py.
//
// The walk itself is csrc/pair_walk.cuh, instantiated two-level here and
// one-level in bvh2.cu: one ray per thread, a 64-byte child-pair node per
// visit, on a stack sized by the pack's exact `stack_depth` (that header says what bounds the walk on this card
// and what the design does about it). The kernels below are its thin
// wrappers, one per query and stack space.
//
// Each query comes in two real types (walk.cuh): rpt_tlas2_closest and
// rpt_tlas2_occluded walk float32 rays over the float32 pack, their `_f64`
// twins float64 rays over the float64 pack (float64 instance records and
// triangle rows, float boxes rounded outward), the counterpart of the
// reference's float64 XLA loop (rpt_tpu/ops/tlas.py instanced_closest_hit),
// since its Pallas kernels do not run under jax_enable_x64.
//
// C interface for ctypes: each entry point launches on the given stream
// with `block` threads per block, allocates nothing (the caller passes the
// global stack, or null for the shared one), and returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// block size or shared stack the launch cannot take. The kernel adds one
// to `launches` when it runs, unless it is null (count.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "count.cuh"      // count_launch
#include "pair_walk.cuh"  // pair_walk, pair_walk_occupancy, kMaxSmem

namespace {

// The float walk has no launch bound or register cap: under
// __launch_bounds__(128) ptxas holds the closest hit to 64 registers and
// spills 16 bytes (the any hit 8), under __maxnreg__(72) and (80) it spills
// or runs slower; without either it takes 70-72 (closest) and 60-61 (any
// hit) registers and spills nothing, at 1.027x and 1.009x the spilling
// build's time in turns on the brick city (PERF.md).
template <bool kOccl, bool kGlobalStack, typename Real>
__global__ void
tlas2_walk(const float4* __restrict__ nodes, int n_tlas, const Real* __restrict__ inst,
           const Real* __restrict__ tris, const Real* __restrict__ o, const Real* __restrict__ d,
           const bool* __restrict__ active, const Real* __restrict__ t_max, int n, Real t_min,
           unsigned* __restrict__ global_stack, int depth, Real* __restrict__ t_out,
           int* __restrict__ id_out, int* __restrict__ inst_out, bool* __restrict__ occ_out,
           unsigned long long* launches) {
  count_launch(launches);
  pair_walk<kOccl, true, kGlobalStack>(nodes, n_tlas, inst, tris, o, d, active, t_max, n, t_min, global_stack,
                                       depth, t_out, id_out, inst_out, occ_out);
}

// The float64 walk: the same walk over double rays (pair_walk.cuh's design
// for it: float boxes, plane-first triangle rows), capped so that
// kMinBlocksF64 blocks of 128 rays fit an SM's register file. The trade is
// not the float walk's: the closest hit capped at 8 blocks (64 registers,
// 64 bytes of spill, 32 warps) and the any hit at 7 (72 registers, no
// spill, 28 warps) measured faster than either with no cap or with caps of
// 5 to 9 blocks (PERF.md).
template <bool kOccl>
constexpr int kMinBlocksF64 = kOccl ? 7 : 8;

template <bool kOccl, bool kGlobalStack>
__global__ void __launch_bounds__(kBlock, kMinBlocksF64<kOccl>)
tlas2_walk_f64(const float4* __restrict__ nodes, int n_tlas, const double* __restrict__ inst,
               const double* __restrict__ tris, const double* __restrict__ o, const double* __restrict__ d,
               const bool* __restrict__ active, const double* __restrict__ t_max, int n, double t_min,
               unsigned* __restrict__ global_stack, int depth, double* __restrict__ t_out,
               int* __restrict__ id_out, int* __restrict__ inst_out, bool* __restrict__ occ_out,
               unsigned long long* launches) {
  count_launch(launches);
  pair_walk<kOccl, true, kGlobalStack>(nodes, n_tlas, inst, tris, o, d, active, t_max, n, t_min, global_stack,
                                       depth, t_out, id_out, inst_out, occ_out);
}

// The kernel of a query, stack space and real type.
template <bool kOccl, bool kGlobalStack, typename Real>
auto walk_kernel() {
  if constexpr (std::is_same_v<Real, double>) {
    return tlas2_walk_f64<kOccl, kGlobalStack>;
  } else {
    return tlas2_walk<kOccl, kGlobalStack, Real>;
  }
}

// Lets the shared-stack kernel take the most dynamic shared memory a block
// holds. Set once per kernel and card, on the first launch there that needs
// more than the default 48 KB, not on every launch.
template <bool kOccl, typename Real>
cudaError_t allow_shared_stack() {
  static PerCard state;
  return once_per_card(state, [] {
    return cudaFuncSetAttribute(walk_kernel<kOccl, false, Real>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kMaxSmem);
  });
}

// Launch on `stream`: `block` threads per block and a stack of `depth`
// levels per thread, in `global_stack` if given, else in dynamic shared
// memory.
template <bool kOccl, typename Real>
int launch(int block, int depth, unsigned* global_stack, int64_t n, cudaStream_t stream, const float* nodes,
           int n_tlas, const Real* inst, const Real* tris, const Real* o, const Real* d,
           const bool* active, const Real* t_max, Real t_min, Real* t_out, int* id_out,
           int* inst_out, bool* occ_out, unsigned long long* launches) {
  if (n <= 0) return 0;
  if (block <= 0 || block > kBlock || depth < 0) return (int)cudaErrorInvalidValue;
  const int grid = (int)((n + block - 1) / block);
  const float4* nodes4 = reinterpret_cast<const float4*>(nodes);
  if (global_stack != nullptr) {
    const auto kernel = walk_kernel<kOccl, true, Real>();
    kernel<<<grid, block, 0, stream>>>(nodes4, n_tlas, inst, tris, o, d, active, t_max, (int)n, t_min, global_stack,
                                       depth, t_out, id_out, inst_out, occ_out, launches);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)block * (size_t)depth * sizeof(unsigned);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_shared_stack<kOccl, Real>();
    if (err != cudaSuccess) return (int)err;
  }
  const auto kernel = walk_kernel<kOccl, false, Real>();
  kernel<<<grid, block, smem, stream>>>(nodes4, n_tlas, inst, tris, o, d, active, t_max, (int)n, t_min, nullptr, depth,
                                        t_out, id_out, inst_out, occ_out, launches);
  return (int)cudaGetLastError();
}

// The occupancy (pair_walk.cuh pair_walk_occupancy) of one kernel at a
// launch of `block` threads and `smem` bytes of dynamic shared memory a
// block (0 with the global stack).
template <bool kOccl, bool kGlobalStack, typename Real>
cudaError_t occupancy(int block, size_t smem, int* out) {
  return pair_walk_occupancy(walk_kernel<kOccl, kGlobalStack, Real>(), allow_shared_stack<kOccl, Real>, block, smem,
                             out);
}

}  // namespace

extern "C" {

// The occupancy (above) of the kernel of `kind` on the current card: bit 0
// the any hit, bit 1 float64, bit 2 the global stack. Returns a CUDA error.
int rpt_tlas2_occupancy(int kind, int block, int smem, int* out) {
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

int rpt_tlas2_closest(const float* nodes, int n_tlas, const float* inst, const float* tris, const float* o,
                      const float* d, const bool* active, int64_t n, float t_min, float* t_out, int* id_out,
                      int* inst_out, int block, int depth, unsigned* global_stack, unsigned long long* launches,
                      void* stream) {
  return launch<false, float>(block, depth, global_stack, n, (cudaStream_t)stream, nodes, n_tlas, inst, tris, o,
                              d, active, nullptr, t_min, t_out, id_out, inst_out, nullptr, launches);
}

int rpt_tlas2_occluded(const float* nodes, int n_tlas, const float* inst, const float* tris, const float* o,
                       const float* d, const bool* active, const float* t_max, int64_t n, float t_min,
                       bool* occ_out, int block, int depth, unsigned* global_stack, unsigned long long* launches,
                       void* stream) {
  return launch<true, float>(block, depth, global_stack, n, (cudaStream_t)stream, nodes, n_tlas, inst, tris, o,
                             d, active, t_max, t_min, nullptr, nullptr, nullptr, occ_out, launches);
}

int rpt_tlas2_closest_f64(const float* nodes, int n_tlas, const double* inst, const double* tris,
                          const double* o, const double* d, const bool* active, int64_t n, double t_min,
                          double* t_out, int* id_out, int* inst_out, int block, int depth, unsigned* global_stack,
                          unsigned long long* launches, void* stream) {
  return launch<false, double>(block, depth, global_stack, n, (cudaStream_t)stream, nodes, n_tlas, inst, tris, o,
                               d, active, nullptr, t_min, t_out, id_out, inst_out, nullptr, launches);
}

int rpt_tlas2_occluded_f64(const float* nodes, int n_tlas, const double* inst, const double* tris,
                           const double* o, const double* d, const bool* active, const double* t_max, int64_t n,
                           double t_min, bool* occ_out, int block, int depth, unsigned* global_stack,
                           unsigned long long* launches, void* stream) {
  return launch<true, double>(block, depth, global_stack, n, (cudaStream_t)stream, nodes, n_tlas, inst, tris, o,
                              d, active, t_max, t_min, nullptr, nullptr, nullptr, occ_out, launches);
}

}  // extern "C"
