// Binary-BVH ray traversal by skip links for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of rpt_tpu/ops/bvh_pallas.py:
//   rpt_bvh2_closest  <- _kernel,      via _traverse and bvh_closest_hit_pallas
//   rpt_bvh2_occluded <- _kernel_occl, via _traverse_occl and bvh_occluded_pallas
// The node and triangle layouts are documented in rpt_tpu_torch/ops/bvh2.py,
// which packs them and holds the plain torch versions these kernels are
// tested against.
//
// What bounds it on this card: as for the wide walk (bvh8.cu), neither bytes
// nor arithmetic. Per ray it does a few to a few tens of box tests and a
// few leaf tests (f32 ALU work), each behind a dependent load of a 48-byte
// node or an 80-byte triangle row. The pack sits in the 50 MB L2: 15 KB for
// the 108-triangle toy plane, 11.3 MB for the 120k-triangle dragon (1.5 MB
// of nodes, 10.3 MB of triangle rows). The least time the card could take
// is that of reading the rays and the pack once (bytes) or of the f32
// operations of the tests (operations), 5-9 us per 518,400-ray launch on
// these paths; the kernel is held back by load latency and by warp
// divergence (PERF.md has the measured times beside the bound).
//
// What this design does about it (right and simple first):
//   - one ray per thread and no stack at all: the tree is stored in
//     preorder with a skip link per node, so a ray walks by one index,
//     ptr + 1 into a hit internal node and skip past a missed box or a
//     tested leaf. No packet-wide vote as on the TPU: each ray prunes by
//     its own slab test, on lo <= its best hit so far (closest) or on
//     lo <= t_max (any hit);
//   - a node is two 16-byte loads of bounds and one of meta, a triangle
//     five 16-byte loads, all through the read-only path;
//   - a leaf's triangles are tested at once against the best hit so far,
//     and the any-hit walk returns at its first occluder.
// The walk visits no child near-first: on a large mesh it tests more boxes
// than the wide walk does (counted by the plain walk, in PERF.md).
//
// Numerics: the slab and triangle tests are those of the wide kernels
// (walk.cuh), written in the same order as the plain torch version
// (ops/bvh2.py), and the build uses -fmad=false: the kernel and the plain
// version agree bit for bit.
//
// C interface for ctypes: each entry point launches on the given stream,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"  // Ray, load_ray, node_hit, leaf_closest, leaf_any, layout constants

namespace {

template <bool kOccl>
__global__ void __launch_bounds__(kBlock)
bvh2_walk(const float4* __restrict__ bounds, const int4* __restrict__ meta, int num_nodes,
          const float4* __restrict__ tris, const float* __restrict__ o,
          const float* __restrict__ d, const bool* __restrict__ active,
          const float* __restrict__ t_max, int n, float t_min, float* __restrict__ t_out,
          int* __restrict__ id_out, bool* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (active != nullptr && !active[i]) {
    if (kOccl) {
      occ_out[i] = false;
    } else {
      t_out[i] = kBig;
      id_out[i] = 0;
    }
    return;
  }
  const Ray r = load_ray(o, d, i);

  // Closest hit: `upper` is the running best t. Any hit: it is t_max.
  float upper = kOccl ? t_max[i] : kBig;
  int best = 0;
  int ptr = 0;
  while (ptr < num_nodes) {
    const int4 m = __ldg(meta + ptr);  // skip, leaf_start, leaf_count, 0
    if (!node_hit(bounds + 2 * (size_t)ptr, r, t_min, upper)) {
      ptr = m.x;
      continue;
    }
    if (m.z == 0) {  // internal: into the left child, the next in preorder
      ++ptr;
      continue;
    }
    const float4* tr = tris + (size_t)m.y * kTriStride4;
    if (kOccl) {
      if (leaf_any(tr, m.z, r, t_min, upper)) {
        occ_out[i] = true;
        return;
      }
    } else {
      int kb;
      const float t_leaf = leaf_closest(tr, m.z, r, t_min, &kb);
      if (t_leaf < upper) {
        upper = t_leaf;
        best = m.y + kb;
      }
    }
    ptr = m.x;
  }
  if (kOccl) {
    occ_out[i] = false;
  } else {
    t_out[i] = upper;
    id_out[i] = best;
  }
}

}  // namespace

extern "C" {

int rpt_bvh2_closest(const float* bounds, const int* meta, int64_t num_nodes, const float* tris,
                     const float* o, const float* d, const bool* active, int64_t n, float t_min,
                     float* t_out, int* id_out, void* stream) {
  if (n <= 0) return 0;
  bvh2_walk<false><<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(bounds), reinterpret_cast<const int4*>(meta), (int)num_nodes,
      reinterpret_cast<const float4*>(tris), o, d, active, nullptr, (int)n, t_min, t_out, id_out,
      nullptr);
  return (int)cudaGetLastError();
}

int rpt_bvh2_occluded(const float* bounds, const int* meta, int64_t num_nodes, const float* tris,
                      const float* o, const float* d, const bool* active, const float* t_max,
                      int64_t n, float t_min, bool* occ_out, void* stream) {
  if (n <= 0) return 0;
  bvh2_walk<true><<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(bounds), reinterpret_cast<const int4*>(meta), (int)num_nodes,
      reinterpret_cast<const float4*>(tris), o, d, active, t_max, (int)n, t_min, nullptr, nullptr,
      occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
