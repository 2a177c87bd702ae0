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
// device memory (the 768-instance brick city packs into ~5.5 MB, which the
// 50 MB L2 holds). The pack layout is documented in
// rpt_tpu_torch/ops/tlas8.py, which also holds the plain torch versions
// these kernels are tested against.
//
// What bounds it on this card: as for the one-level walk (bvh8.cu), a BVH
// walk is neither a streaming nor a dense-math workload. Per ray it does a
// few tens of box tests, a few instance entries (an 18-multiply affine
// transform each) and a few triangle tests, separated by dependent loads of
// node, instance and triangle rows. The least time the card could take is
// that of the f32 operations or of reading the rays and the pack once,
// microseconds either way; the kernel is held back by load latency and by
// warp divergence (PERF.md has the measured times beside the bound).
//
// What this design does about it (right and simple first):
//   - one ray per thread and a per-thread stack of tagged entries
//     `node << 2 | tag`:
//       tag 0: a wide node slabbed with the world ray (the TLAS part);
//       tag 1: a wide node slabbed with the current instance's local ray;
//       tag 2: an instance entry: load the 3x4 world->local affine as three
//              float4 (walk.cuh to_local), re-express the ray with the
//              direction NOT normalized
//              (so local t == world t and the running-best prune holds at
//              both levels), and replace the entry with the mesh's BLAS
//              root, tag 1.
//     LIFO order guarantees that every tag-1 entry above an instance entry
//     belongs to that instance, so one local ray per thread suffices;
//   - triangle leaves are tested at once, in the current local frame;
//   - children are visited near to far by the world direction's octant at
//     both levels (far-first pushes of internal and instance children, then
//     near-first leaves); the order changes nothing but exact ties;
//   - pruning on the running best hit (closest) or on t_max (any hit); the
//     any-hit walk returns at its first occluder.
// Warp-coherent scheduling (ray sorting, persistent threads) is later work.
//
// Numerics: every expression is written in the same order as the plain
// torch version (ops/bvh8.py `_walk_plain`), the instance transform as
// ((a0*ox + a1*oy) + a2*oz) + a3, and the build uses -fmad=false: the
// kernel and the plain version agree bit for bit.
//
// C interface for ctypes: each entry point launches on the given stream,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"  // Ray, load_ray, to_local, child_mask, leaf_closest, leaf_any

namespace {

constexpr int kInstChild = -2;  // meta b of an instance child (a = instance id)
constexpr int kTagWorld = 0;
constexpr int kTagLocal = 1;
constexpr int kTagInst = 2;

template <bool kOccl>
__global__ void __launch_bounds__(kBlock)
tlas8_walk(const float4* __restrict__ bounds, const int* __restrict__ meta,
           const float4* __restrict__ inst, const int* __restrict__ inst_root,
           const float4* __restrict__ tris, const float* __restrict__ o,
           const float* __restrict__ d, const bool* __restrict__ active,
           const float* __restrict__ t_max, int n, float t_min, float* __restrict__ t_out,
           int* __restrict__ id_out, int* __restrict__ inst_out, bool* __restrict__ occ_out) {
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
  Ray l = w;  // the current instance's local ray, set at each instance entry

  // Closest hit: `upper` is the running best t. Any hit: it is t_max.
  float upper = kOccl ? t_max[i] : kBig;
  int best = 0;
  int best_inst = 0;
  int cur_inst = 0;
  int stack[kStackCap];
  int sp = 1;
  stack[0] = kTagWorld;  // the TLAS root, wide node 0
  while (sp > 0) {
    const int e = stack[--sp];
    const int tag = e & 3;
    const int idx = e >> 2;
    if (tag == kTagInst) {
      to_local(inst + (size_t)idx * kInst4, w, &l);
      cur_inst = idx;
      stack[sp++] = (__ldg(inst_root + idx) << 2) | kTagLocal;
      continue;
    }
    const Ray r = (tag == kTagLocal) ? l : w;
    const unsigned mask = child_mask(bounds + (size_t)idx * kNode4, r, t_min, upper);
    const int* m = meta + (size_t)idx * kMeta;
    const int word = __ldg(m + 16 + w.oct);
    // Hit internal and instance children, far first, so the nearest is
    // popped next. An internal child keeps its parent's frame.
#pragma unroll
    for (int k = 7; k >= 0; --k) {
      const int ck = (word >> (4 * k)) & 7;
      const int b = __ldg(m + 8 + ck);
      if (((mask >> ck) & 1u) && (b == 0 || b == kInstChild)) {
        stack[sp++] = (__ldg(m + ck) << 2) | (b == kInstChild ? kTagInst : tag);
      }
    }
    // Hit triangle leaves (BLAS part only), near first, each against the
    // best hit so far, in the current instance's frame.
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
          best_inst = cur_inst;
        }
      }
    }
  }
  if (kOccl) {
    occ_out[i] = false;
  } else {
    t_out[i] = upper;
    id_out[i] = best;
    inst_out[i] = best_inst;
  }
}

}  // namespace

extern "C" {

int rpt_tlas8_closest(const float* bounds, const int* meta, const float* inst,
                      const int* inst_root, const float* tris, const float* o, const float* d,
                      const bool* active, int64_t n, float t_min, float* t_out, int* id_out,
                      int* inst_out, void* stream) {
  if (n <= 0) return 0;
  tlas8_walk<false><<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(bounds), meta, reinterpret_cast<const float4*>(inst),
      inst_root, reinterpret_cast<const float4*>(tris), o, d, active, nullptr, (int)n, t_min,
      t_out, id_out, inst_out, nullptr);
  return (int)cudaGetLastError();
}

int rpt_tlas8_occluded(const float* bounds, const int* meta, const float* inst,
                       const int* inst_root, const float* tris, const float* o, const float* d,
                       const bool* active, const float* t_max, int64_t n, float t_min,
                       bool* occ_out, void* stream) {
  if (n <= 0) return 0;
  tlas8_walk<true><<<grid_for(n), kBlock, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(bounds), meta, reinterpret_cast<const float4*>(inst),
      inst_root, reinterpret_cast<const float4*>(tris), o, d, active, t_max, (int)n, t_min,
      nullptr, nullptr, nullptr, occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
