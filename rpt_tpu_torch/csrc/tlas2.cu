// Two-level binary-BVH ray traversal by skip links for instanced meshes on
// NVIDIA Hopper (sm_90a): a binary TLAS with one instance per leaf, and one
// shared binary BLAS per mesh.
//
// Replaces the TPU kernels of rpt_tpu/ops/tlas_pallas.py:
//   rpt_tlas2_closest  <- _kernel,      via _traverse and tlas_closest_hit_pallas
//   rpt_tlas2_occluded <- _kernel_occl, via _traverse_occl and tlas_occluded_pallas
// The TPU kernel keeps every table in SMEM and so refuses scenes past a
// 700,000-byte budget (tlas_pallas_eligible); here the tables sit in device
// memory and no scene is refused. The layout is documented in
// rpt_tpu_torch/ops/tlas2.py, which also holds the plain torch versions
// these kernels are tested against.
//
// What bounds it on this card: as for the other walks, neither bytes nor
// arithmetic. Per ray it does tens of box tests at both levels, a few
// instance entries (an 18-multiply affine transform each) and a few leaf
// tests, each behind a dependent load; the 768-instance brick city's tables
// (0.9 MB of nodes and instances, 5.1 MB of triangle rows) sit in the 50 MB
// L2. The least time the card could take is that of the f32 operations or
// of reading the rays and the tables once, 6-11 us per 518,400-ray launch
// there; the kernel is held back by load latency and warp divergence
// (PERF.md has the measured times beside the bound).
//
// What this design does about it (right and simple first):
//   - one ray per thread and no stack at all. The outer walk follows the
//     TLAS's skip links in world space; at a leaf whose box the ray hits it
//     loads the instance's 3x4 world->local affine (walk.cuh to_local,
//     direction NOT normalized, so local t == world t and the prune on the
//     running best holds at both levels), walks the instance's BLAS range
//     [root, end) by its own skip links in local space, and resumes the
//     TLAS at the leaf's skip link. That is why it is the fallback for a
//     wide two-level table whose stack bound is too deep (ops/tlas8.py);
//   - a node is two 16-byte loads of bounds and one of meta; an instance
//     three 16-byte loads of its affine and one 8-byte load of its range;
//   - a leaf's triangles are tested at once against the best hit so far;
//     the any-hit walk returns at its first occluder.
//
// Numerics: the slab, transform and triangle tests are those of the wide
// kernels (walk.cuh), written in the same order as the plain torch version
// (ops/tlas2.py), and the build uses -fmad=false: the kernel and the plain
// version agree bit for bit.
//
// C interface for ctypes: each entry point launches on the given stream,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"  // Ray, load_ray, to_local, node_hit, leaf_closest, leaf_any

namespace {

struct Tables {
  const float4* t_bounds;  // (Mt, 8) f32 world space
  const int4* t_meta;      // (Mt, 4) i32 [skip, instance id (-1 internal), 0, 0]
  const float4* b_bounds;  // (Mb, 8) f32 local space
  const int4* b_meta;      // (Mb, 4) i32 [skip (global), first triangle row, count, 0]
  const float4* inst;      // (K, 12) f32 world->local rows
  const int2* inst_range;  // (K, 2) i32 [BLAS root, one past its last node]
  const float4* tris;      // (L*8, 20) f32 local-space triangle rows
  int num_tlas;
};

template <bool kOccl>
__global__ void __launch_bounds__(kBlock)
tlas2_walk(const Tables tb, const float* __restrict__ o, const float* __restrict__ d,
           const bool* __restrict__ active, const float* __restrict__ t_max, int n, float t_min,
           float* __restrict__ t_out, int* __restrict__ id_out, int* __restrict__ inst_out,
           bool* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (active != nullptr && !active[i]) {
    if (kOccl) {
      occ_out[i] = false;
    } else {
      t_out[i] = kBig;
      id_out[i] = 0;
      inst_out[i] = 0;
    }
    return;
  }
  const Ray w = load_ray(o, d, i);  // the world ray
  Ray l = w;                        // the current instance's local ray

  // Closest hit: `upper` is the running best t. Any hit: it is t_max.
  float upper = kOccl ? t_max[i] : kBig;
  int best = 0;
  int best_inst = 0;
  int tptr = 0;
  while (tptr < tb.num_tlas) {
    const int4 tm = __ldg(tb.t_meta + tptr);
    if (!node_hit(tb.t_bounds + 2 * (size_t)tptr, w, t_min, upper)) {
      tptr = tm.x;
      continue;
    }
    if (tm.y < 0) {  // internal: into the left child
      ++tptr;
      continue;
    }
    const int k = tm.y;
    to_local(tb.inst + (size_t)k * kInst4, w, &l);
    const int2 range = __ldg(tb.inst_range + k);
    int bptr = range.x;
    while (bptr < range.y) {
      const int4 bm = __ldg(tb.b_meta + bptr);
      if (!node_hit(tb.b_bounds + 2 * (size_t)bptr, l, t_min, upper)) {
        bptr = bm.x;
        continue;
      }
      if (bm.z == 0) {
        ++bptr;
        continue;
      }
      const float4* tr = tb.tris + (size_t)bm.y * kTriStride4;
      if (kOccl) {
        if (leaf_any(tr, bm.z, l, t_min, upper)) {
          occ_out[i] = true;
          return;
        }
      } else {
        int kb;
        const float t_leaf = leaf_closest(tr, bm.z, l, t_min, &kb);
        if (t_leaf < upper) {
          upper = t_leaf;
          best = bm.y + kb;
          best_inst = k;
        }
      }
      bptr = bm.x;
    }
    tptr = tm.x;
  }
  if (kOccl) {
    occ_out[i] = false;
  } else {
    t_out[i] = upper;
    id_out[i] = best;
    inst_out[i] = best_inst;
  }
}

Tables tables(const float* t_bounds, const int* t_meta, int64_t num_tlas, const float* b_bounds,
              const int* b_meta, const float* inst, const int* inst_range, const float* tris) {
  return Tables{reinterpret_cast<const float4*>(t_bounds), reinterpret_cast<const int4*>(t_meta),
                reinterpret_cast<const float4*>(b_bounds), reinterpret_cast<const int4*>(b_meta),
                reinterpret_cast<const float4*>(inst),     reinterpret_cast<const int2*>(inst_range),
                reinterpret_cast<const float4*>(tris),     (int)num_tlas};
}

}  // namespace

extern "C" {

int rpt_tlas2_closest(const float* t_bounds, const int* t_meta, int64_t num_tlas,
                      const float* b_bounds, const int* b_meta, const float* inst,
                      const int* inst_range, const float* tris, const float* o, const float* d,
                      const bool* active, int64_t n, float t_min, float* t_out, int* id_out,
                      int* inst_out, void* stream) {
  if (n <= 0) return 0;
  tlas2_walk<false><<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>(
      tables(t_bounds, t_meta, num_tlas, b_bounds, b_meta, inst, inst_range, tris), o, d, active,
      nullptr, (int)n, t_min, t_out, id_out, inst_out, nullptr);
  return (int)cudaGetLastError();
}

int rpt_tlas2_occluded(const float* t_bounds, const int* t_meta, int64_t num_tlas,
                       const float* b_bounds, const int* b_meta, const float* inst,
                       const int* inst_range, const float* tris, const float* o, const float* d,
                       const bool* active, const float* t_max, int64_t n, float t_min,
                       bool* occ_out, void* stream) {
  if (n <= 0) return 0;
  tlas2_walk<true><<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>(
      tables(t_bounds, t_meta, num_tlas, b_bounds, b_meta, inst, inst_range, tris), o, d, active,
      t_max, (int)n, t_min, nullptr, nullptr, nullptr, occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
