// The node-group walk of the wide-BVH kernels, written once for both:
// bvh8.cu instantiates it one-level (one wide tree), tlas8.cu two-level (a
// wide TLAS over instances and one wide BLAS per mesh, in one table).
//
// What bounds it on this card: a BVH walk is neither a streaming nor a
// dense-math workload. Per ray it does tens of box tests, a few triangle
// tests and (two-level) a few instance entries, an 18-multiply affine
// transform each, separated by dependent loads of node, instance and
// triangle rows from L2 (the packs of the repo's scenes, a few MB to ~10
// MB, fit in the 50 MB L2). The least time the card could take is that of
// the f32 operations or of reading the rays and the pack once,
// microseconds either way; the walk is held back by load latency, which
// only more warps in flight hide, and by warp divergence (PERF.md has the
// measured times beside the bound).
//
// What this design does about it: one ray per thread and a node-group
// stack (Ylitie, Karras and Laine, HPG 2017):
//   - visiting a node slab-tests its 8 children against the best hit so
//     far, reads its 8 child references with two 16-byte loads and its
//     octant word with one, tests its hit triangle leaves at once, near
//     first, in the current frame, and makes its hit wide-node and
//     instance children one group, held in registers: (node, 8-bit mask of
//     them by rank in the direction's octant order);
//   - the walk enters the group's lowest rank and pushes the group back as
//     one 32-bit entry `node << 8 | mask` while bits remain, so the stack
//     holds at most one entry per tree level. Its exact worst-case depth,
//     the pack's `group_depth`, sizes it in dynamic shared memory, indexed
//     [level][thread] so that neighbouring lanes fall in different banks;
//     no per-thread local-memory stack;
//   - two-level: an instance child (payload its TLAS leaf rank) loads a
//     record of the 3x4 world->local affine, its BLAS root and its id
//     (walk.cuh kRec), re-expresses the ray with the direction NOT
//     normalized (walk.cuh to_local: local t == world t, so the
//     running-best prune holds at both levels) and enters its BLAS root.
//     LIFO order means one ray per thread, in the frame of the nodes being
//     visited, suffices: the world ray is loaded again at an instance entry
//     and on the return to a TLAS group. One-level, all of that is
//     compiled out;
//   - pruning on the running best hit (closest) or on t_max (any hit),
//     widened by 8 ulps (walk.cuh box_upper) so that a leaf whose entry
//     rounds past a triangle at that t is still visited; the any-hit walk
//     returns at its first occluder;
//   - ties: the reference takes, among equal t, the leaf it visits first in
//     preorder. A leaf's best row replaces the best hit on t < best, or on
//     t == best with a smaller key, which is that order: (TLAS leaf rank,
//     packed row) two-level, the row alone one-level (rows rise in the
//     binary tree's preorder, ops/bvh8.py). The walk carries the rank and
//     reads the winner's instance id from its record at the end.
// The visit order is that of a stack with one entry per hit child, pushed
// far first: a node's leaves, then its children near to far, each subtree
// whole before the next sibling. The nodes keep their f32 child boxes: a
// 128-byte node with 8-bit boxes decoded in the kernel was measured slower
// on the brick city, whose triangle rows, not its nodes, make up the bytes
// (PERF.md, Findings). Warp-coherent scheduling (ray sorting, persistent
// threads) is later work.
//
// Numerics: every expression is written in the same order as the plain
// torch version (ops/bvh8.py `_group_walk`), the instance transform as
// ((a0*ox + a1*oy) + a2*oz) + a3, and the build uses -fmad=false: the
// kernels and the plain version agree bit for bit.
//
// The table layout (bounds (Mw, 48) f32, meta (Mw, 16) i32: 8 child
// references `payload << 2 | kind`, 8 octant words) is documented in
// rpt_tpu_torch/ops/bvh8.py and ops/tlas8.py. The walk is a template over
// the real type (walk.cuh): float for float32 renders, double for float64
// ones, whose rays, triangle rows, instance records and hit distances are
// double and whose node boxes are float, rounded outward. Both double
// walks test those boxes in float (below).
//
// The float64 walks (the `_f64` kernels of bvh8.cu and tlas8.cu). As in
// the binary pair (pair_walk.cuh), what held them back was the register
// file and so the warps each SM keeps in flight, not FP64 throughput:
// instantiated as the float walk in double they held every ray component,
// inverse, entry and the running best as 64-bit pairs, 94-128 registers,
// 16-20 warps per SM (PERF.md). Their design:
//   - the 8 child boxes are tested in float (walk.cuh child_mask_f,
//     box_entry_f) against a float copy of the ray, widened so that it
//     takes every box the double test takes (its widening covers
//     box_upper's; tests/test_torch_ties.py); one-level the copy is made
//     once, two-level again wherever the ray changes frame;
//   - two-level, a triangle row's plane is tested first and the rest of
//     the row is loaded only for a t that could count (walk.cuh tri_plane,
//     `kSplitRows`), and tlas8.cu caps the kernels' registers
//     (kMinBlocksF64: 8 blocks of 128 rays a SM for the closest hit, 7 for
//     the any hit); one-level, rows whole and no cap (bvh8.cu says why).
// Measured in turns (PERF.md): tlas8 on the brick city 0.385 -> 0.312 ms a
// closest-hit launch, 0.170 -> 0.150 an any hit, where the caps, not the
// float boxes alone (123 registers without a cap), bought the warps; bvh8
// on the trefoil 0.48 -> 0.41 and 0.36 -> 0.32, the float boxes alone.
// The float walks compile as before: `kFloatBox` is false there.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "walk.cuh"  // Ray, load_ray, to_local, child_mask, leaf_closest, leaf_any

namespace {

constexpr int kMetaG = 16;   // int32 per node: 8 child references, 8 octant words
constexpr int kKindNode = 1;  // reference kinds (ops/bvh8.py): 0 empty, 1 node, 2 instance, 3 leaf
constexpr int kKindInst = 2;
constexpr int kKindLeaf = 3;

// The walk of ray i = blockIdx.x * blockDim.x + threadIdx.x, from node 0,
// in the real type Real (float or double) of the rays, triangle rows and
// instance records; the node boxes are float in both.
// One-level (kTwoLevel false): n_tlas, inst and inst_out are not read.
// kOccl: writes occ_out; else t_out, id_out (and inst_out).
template <bool kOccl, bool kTwoLevel, typename Real>
__device__ __forceinline__ void group_walk(
    const float4* __restrict__ bounds, const int* __restrict__ meta, int n_tlas,
    const Real* __restrict__ inst, const Real* __restrict__ tris, const Real* __restrict__ o,
    const Real* __restrict__ d, const bool* __restrict__ active, const Real* __restrict__ t_max, int n,
    Real t_min, Real* __restrict__ t_out, int* __restrict__ id_out, int* __restrict__ inst_out,
    bool* __restrict__ occ_out) {
  extern __shared__ unsigned group_stack[];  // [level][threadIdx.x]
  unsigned* stack = group_stack + threadIdx.x;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (active != nullptr && !active[i]) {
    if (kOccl) {
      occ_out[i] = false;
    } else {
      t_out[i] = Num<Real>::big;
      id_out[i] = 0;
      if (kTwoLevel) inst_out[i] = 0;
    }
    return;
  }
  // A float64 walk tests its boxes in float against rf, the float copy of
  // r (walk.cuh box_entry_f); two-level also a row's plane before the rest
  // of the row (walk.cuh tri_plane), which was slower one-level. The head
  // of this file says why.
  constexpr bool kFloatBox = std::is_same_v<Real, double>;
  constexpr bool kSplitRows = kFloatBox && kTwoLevel;
  // The ray in the frame of the nodes being visited. The world ray is not
  // kept beside it: it is loaded again where the walk needs it (an instance
  // entry, a return to the TLAS), which saves the registers of a second ray.
  Ray<Real> r = load_ray(o, d, i);
  RayF rf;
  float t_min_f = 0.0f;
  if constexpr (kFloatBox) {
    rf = float_ray(r);
    t_min_f = __double2float_rd(t_min);
  }
  bool local = false;

  // Closest hit: `upper` is the running best t. Any hit: it is t_max.
  Real upper = kOccl ? t_max[i] : Num<Real>::big;
  int best = 0;
  int best_rank = -1;
  int cur_rank = 0;  // the current instance's TLAS leaf rank
  int sp = 0;
  int node = 0;  // the root
  while (true) {
    // Visit `node`, in r's frame.
    unsigned hit;
    if constexpr (kFloatBox) {
      hit = child_mask_f(bounds + (size_t)node * kNode4, rf, t_min_f, __double2float_ru(upper));
    } else {
      hit = child_mask(bounds + (size_t)node * kNode4, r, t_min, box_upper(upper));
    }
    const int* m = meta + (size_t)node * kMetaG;
    const int4 ra = __ldg(reinterpret_cast<const int4*>(m));
    const int4 rb = __ldg(reinterpret_cast<const int4*>(m) + 1);
    const int kind[8] = {ra.x & 3, ra.y & 3, ra.z & 3, ra.w & 3, rb.x & 3, rb.y & 3, rb.z & 3, rb.w & 3};
    unsigned leaves = 0, groups = 0;  // by slot
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const unsigned h = (hit >> c) & 1u;
      leaves |= (h && kind[c] == kKindLeaf) << c;
      groups |= (h && (kind[c] == kKindNode || kind[c] == kKindInst)) << c;
    }
    const int word = __ldg(m + 8 + r.oct);
    unsigned lmask = 0, gmask = 0;  // by rank
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int ck = (word >> (4 * k)) & 7;
      lmask |= ((leaves >> ck) & 1u) << k;
      gmask |= ((groups >> ck) & 1u) << k;
    }
    // Hit triangle leaves, near first, each against the best hit so far.
    while (lmask) {
      const int k = __ffs(lmask) - 1;
      lmask &= lmask - 1;
      const int payload = __ldg(m + ((word >> (4 * k)) & 7)) >> 2;
      const int start = (payload >> 3) << 3;
      const int cnt = (payload & 7) + 1;
      const Real* tr = tris + (size_t)start * kTriStride;
      if (kOccl) {
        bool occluded;
        if constexpr (kSplitRows) {
          occluded = leaf_any_split(tr, cnt, r, t_min, upper);
        } else {
          occluded = leaf_any(tr, cnt, r, t_min, upper);
        }
        if (occluded) {
          occ_out[i] = true;
          return;
        }
      } else {
        int kb;
        Real t_leaf;
        if constexpr (kSplitRows) {
          t_leaf = leaf_closest_split(tr, cnt, r, t_min, upper, &kb);
        } else {
          t_leaf = leaf_closest(tr, cnt, r, t_min, &kb);
        }
        // Ties: a smaller key, (TLAS leaf rank, row) two-level, the row
        // one-level, is the reference's preorder.
        const int row = start + kb;
        bool better;
        if constexpr (kTwoLevel) {
          better = t_leaf < upper || (t_leaf == upper && upper < Num<Real>::big &&
                                      (cur_rank < best_rank || (cur_rank == best_rank && row < best)));
        } else {
          better = t_leaf < upper || (t_leaf == upper && upper < Num<Real>::big && row < best);
        }
        if (better) {
          upper = t_leaf;
          best = row;
          if (kTwoLevel) best_rank = cur_rank;
        }
      }
    }
    // Move on: this node's group, else the group on top of the stack.
    int g_node = node;
    int g_word = word;
    if (gmask == 0) {
      if (sp == 0) break;
      const unsigned e = stack[(--sp) * kBlock];
      g_node = (int)(e >> 8);
      gmask = e & 255u;
      g_word = __ldg(meta + (size_t)g_node * kMetaG + 8 + r.oct);
    }
    const int k = __ffs(gmask) - 1;
    gmask &= gmask - 1;
    if (gmask) stack[(sp++) * kBlock] = ((unsigned)g_node << 8) | gmask;
    if constexpr (kTwoLevel) {
      // A TLAS group's children are entered in the world frame. A BLAS
      // group's frame is still r's: LIFO order pops every group of an
      // instance's BLAS before any TLAS group below it.
      if (g_node < n_tlas && local) {
        r = load_ray(o, d, i);
        if constexpr (kFloatBox) rf = float_ray(r);
        local = false;
      }
    }
    const int ref = __ldg(meta + (size_t)g_node * kMetaG + ((g_word >> (4 * k)) & 7));
    node = ref >> 2;
    if constexpr (kTwoLevel) {
      if ((ref & 3) == kKindInst) {
        // An instance (payload its TLAS leaf rank): the world ray in its
        // frame, then its BLAS root.
        const Real* rec = inst + (size_t)node * kRec;
        to_local(rec, load_ray(o, d, i), &r);
        if constexpr (kFloatBox) rf = float_ray(r);
        local = true;
        cur_rank = node;
        node = __ldg(reinterpret_cast<const int*>(rec + 12));
      }
    }
  }
  if (kOccl) {
    occ_out[i] = false;
  } else {
    t_out[i] = upper;
    id_out[i] = best;
    if constexpr (kTwoLevel) {
      inst_out[i] =
          best_rank >= 0 ? __ldg(reinterpret_cast<const int*>(inst + (size_t)best_rank * kRec + 12) + 1) : 0;
    }
  }
}

// The dynamic shared memory of a group stack of `depth` levels per thread:
// cudaErrorInvalidValue if the stack does not fit in one block. A launch
// past 48 KB first raises its kernel's limit, once per kernel (the callers'
// `allow_group_stack`): a call per launch would be a CUDA API call inside
// every graph capture of the launch.
inline cudaError_t group_stack_smem(int depth, size_t* smem) {
  *smem = (size_t)kBlock * (size_t)(depth > 0 ? depth : 0) * sizeof(unsigned);
  if (depth < 0 || *smem > kMaxSmem) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The occupancy of a walk kernel at the launch of a group stack of `depth`
// levels (`allow` its caller's allow_group_stack): out[0] registers a
// thread, out[1] local (spill) bytes a thread (cudaFuncGetAttributes),
// out[2] blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// out[3] their warps.
template <typename Kernel, typename Allow>
cudaError_t group_walk_occupancy(Kernel kernel, Allow allow, int depth, int* out) {
  size_t smem;
  cudaError_t err = group_stack_smem(depth, &smem);
  if (err == cudaSuccess && smem > 48 * 1024) err = allow();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kBlock, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = blocks * (kBlock / 32);
  return cudaSuccess;
}

}  // namespace
