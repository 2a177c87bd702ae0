// Wide-BVH (8-ary) ray traversal for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of rpt_tpu/ops/bvh8_pallas.py:
//   rpt_bvh8_closest  <- _make_kernel8(occl=False), via bvh8_closest_hit_pallas
//   rpt_bvh8_occluded <- _make_kernel8(occl=True),  via bvh8_occluded_pallas
// The node, meta and triangle layouts are documented in
// rpt_tpu_torch/ops/bvh8.py, which packs them and holds the plain torch
// versions these kernels are tested against.
//
// What bounds it on this card: a BVH walk is neither a streaming nor a
// dense-math workload. Per ray it does tens of box tests and a few triangle
// tests (f32 ALU work) separated by dependent loads of node and triangle
// rows (latency). The whole 120k-triangle tree (~1 MB of wide nodes, ~10 MB
// of triangle rows) fits in the 50 MB L2, so the least time the card could
// take is set by the f32 operations of those tests, or by reading the rays
// and the pack once, whichever is larger; both are microseconds. The
// kernel is held back instead by load latency and by divergence: the 32
// rays of a warp walk different nodes and loop different lengths
// (PERF.md has the measured times beside the bound).
//
// What this design does about it (right and simple first):
//   - one ray per thread and a per-thread stack, so no ray waits on another
//     ray's walk, and no packet-wide vote as on the TPU: each ray takes the
//     near-to-far child order of its own direction octant;
//   - a node's 8 child boxes are 12 sixteen-byte loads through the
//     read-only path, its meta a few 4-byte loads, a triangle 5 sixteen-byte
//     loads; the 8 child slab tests of one node are independent and overlap
//     each other's latency;
//   - pruning on the running best hit (closest) or on t_max (any hit), and
//     the any-hit walk returns at its first occluder.
// Warp-coherent scheduling (ray sorting, persistent threads, a wide-node
// test per warp) is later work.
//
// Numerics: every expression is written in the same order as the plain
// torch version (ops/bvh8.py `_leaf_t` and the slab test), and the build
// uses -fmad=false so nvcc contracts no multiply-add into an FMA: the
// kernel and the plain version then agree bit for bit.
//
// C interface for ctypes: each entry point launches on the given stream,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"  // Ray, load_ray, child_mask, leaf_closest, leaf_any, layout constants

namespace {

template <bool kOccl>
__global__ void __launch_bounds__(kBlock)
bvh8_walk(const float4* __restrict__ bounds, const int* __restrict__ meta,
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
  int stack[kStackCap];
  int sp = 1;
  stack[0] = 0;
  while (sp > 0) {
    const int w = stack[--sp];
    const unsigned mask = child_mask(bounds + (size_t)w * kNode4, r, t_min, upper);
    const int* m = meta + (size_t)w * kMeta;
    const int word = __ldg(m + 16 + r.oct);
    // Hit internal children, far first, so the nearest is popped next.
#pragma unroll
    for (int k = 7; k >= 0; --k) {
      const int ck = (word >> (4 * k)) & 7;
      if (((mask >> ck) & 1u) && __ldg(m + 8 + ck) == 0) stack[sp++] = __ldg(m + ck);
    }
    // Hit leaves, near first, each against the best hit so far.
    for (int k = 0; k < 8; ++k) {
      const int ck = (word >> (4 * k)) & 7;
      const int cnt = __ldg(m + 8 + ck);
      if (!((mask >> ck) & 1u) || cnt <= 0) continue;
      const int start = __ldg(m + ck);
      const float4* tr = tris + (size_t)start * kTriStride4;
      if (kOccl) {
        if (leaf_any(tr, cnt, r, t_min, upper)) {
          occ_out[i] = true;
          return;
        }
      } else {
        int kb;
        const float t_leaf = leaf_closest(tr, cnt, r, t_min, &kb);
        if (t_leaf < upper) {
          upper = t_leaf;
          best = start + kb;
        }
      }
    }
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

int rpt_bvh8_closest(const float* bounds, const int* meta, const float* tris, const float* o,
                     const float* d, const bool* active, int64_t n, float t_min, float* t_out,
                     int* id_out, void* stream) {
  if (n <= 0) return 0;
  bvh8_walk<false><<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(bounds), meta, reinterpret_cast<const float4*>(tris), o, d,
      active, nullptr, (int)n, t_min, t_out, id_out, nullptr);
  return (int)cudaGetLastError();
}

int rpt_bvh8_occluded(const float* bounds, const int* meta, const float* tris, const float* o,
                      const float* d, const bool* active, const float* t_max, int64_t n,
                      float t_min, bool* occ_out, void* stream) {
  if (n <= 0) return 0;
  bvh8_walk<true><<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(bounds), meta, reinterpret_cast<const float4*>(tris), o, d,
      active, t_max, (int)n, t_min, nullptr, nullptr, occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
