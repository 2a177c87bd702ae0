// The walk over child-pair nodes of the binary kernels, written once for
// both: bvh2.cu instantiates it one-level (one binary tree), tlas2.cu
// two-level (a binary TLAS over instances and one binary BLAS per mesh, in
// one node table).
//
// What bounds it on this card: a BVH walk is neither a streaming nor a
// dense-math workload. Per ray it does tens of box tests, a few triangle
// tests and (two-level) a few instance entries (an 18-multiply affine
// transform each), separated by dependent loads of node, instance and
// triangle rows from L2 (the 768-instance brick city's tables, about 6 MB,
// and the 120k-triangle dragon's, about 12 MB, fit in the 50 MB L2).
// The least time the card could take is that of the f32 operations or of
// reading the rays and the tables once, microseconds either way; the walk
// is held back by load latency and by warp divergence (PERF.md has the
// measured times beside the bound).
//
// What this design does about it: one ray per thread, and per visit one
// 64-byte pair node, four independent 16-byte loads, that carries both
// children's boxes and references:
//   - both children are slab-tested against [t_min, upper] (upper = the
//     running best hit, or t_max for the any hit; inclusive, as in the
//     reference; widened by 8 ulps, walk.cuh box_upper, so that a leaf
//     whose entry rounds past a triangle at that t is still visited; the
//     float box test's own widening covers that), so one round trip to L2
//     buys two box tests;
//   - a hit triangle leaf is tested at once; of two hit node or instance
//     children the closest-hit walk enters the nearer (by entry distance,
//     A on a tie) and pushes the farther, so it shrinks its running best
//     before it reaches the far subtrees; the any-hit walk, whose t_max does
//     not shrink, enters A (left first measured 7.7% faster than near first
//     on the brick city, PERF.md); one hit child is entered; with none, the
//     walk pops;
//   - which node comes next does not depend on the leaf tests, so the
//     one-level closest hit issues the next node's loads before it tests
//     the current node's leaves, and the two latencies overlap (1.27x
//     faster on the dragon in turns, PERF.md). The any hit, which returns
//     at its first occluder, and the two-level walk, whose next node may
//     switch the ray's frame, test the leaves first (the one-level any hit
//     measured 3% slower prefetching);
//   - two-level, an instance child (payload its TLAS leaf rank) loads a
//     64-byte record: the 3x4 world->local affine (walk.cuh to_local, direction NOT
//     normalized, so local t == world t and the prune on the running best
//     holds at both levels), its BLAS root and its instance id. LIFO order
//     means one ray, in the frame of the nodes being visited, suffices: the
//     world ray is loaded again at an instance entry and when a TLAS node
//     (index < n_tlas) is popped in a local frame. One-level, all of that
//     is compiled out;
//   - the stack holds one 32-bit reference per pushed far child. Its exact
//     worst-case depth, the pack's `stack_depth`, sizes it; it lives in
//     dynamic shared memory indexed [level][thread] (neighbouring lanes in
//     different banks), or, for a tree too deep for one block's shared
//     memory, in a global scratch buffer indexed the same way (the launch
//     plan is ops/bvh2.py `launch_plan`). No per-thread local-memory array;
//   - ties: the reference takes, among equal t, the leaf it visits first in
//     preorder. A leaf's hit replaces the best on t < best, or on t == best
//     with a smaller key, which is that order: (TLAS leaf rank, packed row)
//     two-level, the row alone one-level (the leaves' rows rise in
//     preorder). The any-hit walk returns at its first occluder.
//
// Numerics: every expression is written in the same order as the plain torch
// version (ops/bvh2.py `_pair_walk`), and the build uses -fmad=false: the
// kernels and the plain version agree bit for bit. The walk is a template over
// the real type (walk.cuh): float for float32 renders, double for float64
// ones, whose rays, triangle rows, instance records and hit distances are
// double and whose pair nodes keep float boxes, rounded outward. Every
// double walk tests them in float (below). An instance record is 16 reals:
// the 3x4 rows, then [BLAS root, id] as int32 at real 12.
//
// The two-level float64 walk (tlas2.cu's `_f64` kernels). What held it back
// was the register file, and hence the warps each SM keeps in flight to
// hide the loads' latency, not FP64 throughput (its operations take 0.01 ms
// of the card's time a launch, its bytes as long). Instantiated as the
// float walk in double, it held every ray component, inverse direction,
// entry distance and the running best as 64-bit pairs: ptxas gave it
// 132-134 registers (closest hit) and 98-102 (any hit), 12 and 16 warps per
// SM, against 28 and 32 in float32 (`[occupancy]`, PERF.md). At equal warps
// it still takes 1.6x its float twin, so warps are not all of it (what
// else differs: the double triangle tests, the wider rows and instance
// records; not measured apart). Its design:
//   - its boxes are tested in float (walk.cuh box_entry_f) against a float
//     copy of the ray, widened so that it takes every box the double test
//     takes; the nearer child is chosen by the float entry. The double
//     inverse direction is then dead, and the box test's registers and
//     operations are float's;
//   - a triangle row's plane is tested first and the rest of the row is
//     loaded only for a t that could count (walk.cuh tri_plane): 6 of its
//     17 reals live, not 17;
//   - tlas2.cu caps the kernels so that 8 (closest hit) and 7 (any hit)
//     blocks of 128 rays fit an SM: 32 and 28 warps, 64 registers with 64
//     bytes of spill and 72 with none. Each step measured faster in turns
//     on the brick city (PERF.md): 0.536 -> 0.354 ms a closest-hit launch,
//     0.264 -> 0.189 an any hit.
//
// The one-level float64 closest hit (bvh2.cu's `_f64` closest-hit kernel)
// takes the float box test alone, in its prefetching loop: the float copy
// of the ray and float entries in place of the double inverse direction
// and entries, the nearer child by the float entry. Its registers stay at
// 128 (16 warps a SM): their peak is the leaf test's whole double row with
// the next node's loads in flight, not the box test. What bought warps
// here (plane-first rows, the loop without prefetch, register caps) cost
// more than it gave; bvh2.cu says what was measured.
//
// The one-level float64 any hit (bvh2.cu's `_f64` any-hit kernel) takes the
// float box test too, in the loop that tests leaves first, with rows whole
// and no cap: its double inverse direction is dead, though the float copy of
// the ray beside the double one leaves it 84 registers (80 before). t_max
// rounded to float once a ray in place of once a visit, plane-first rows,
// register caps, near-first order, the prefetching loop and a leaf's rows
// without the early exit each measured no faster; bvh2.cu gives the times.
// The float walks compile as before: `kFloatBox` and `kSplit` are false
// there.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "walk.cuh"  // Ray, load_ray, to_local, box_entry, leaf_closest, leaf_any

namespace {

constexpr int kPair4 = 4;  // float4 per pair node: 2 boxes, then [refA, refB, 0, 0]
constexpr int kRefInst = 2;  // reference kinds (ops/bvh8.py): 0 empty, 1 node, 2 instance, 3 leaf
constexpr int kRefLeaf = 3;

// Test the triangle leaf `ref` in r's frame. Any hit: true on an occluder in
// [t_min, upper]. Closest: the leaf's best row replaces the running best on
// a smaller (t, rank, row), one-level on a smaller (t, row).
template <bool kOccl, bool kTwoLevel, typename Real>
__device__ __forceinline__ bool pair_leaf(const Real* __restrict__ tris, int ref, const Ray<Real>& r,
                                          Real t_min, int rank, Real* upper, int* best,
                                          int* best_rank) {
  const int payload = ref >> 2;
  const int start = (payload >> 3) << 3;
  const int cnt = (payload & 7) + 1;
  const Real* tr = tris + (size_t)start * kTriStride;
  // The two-level float64 walk tests a row's plane before it loads the rest
  // (walk.cuh tri_plane): the same answers, fewer registers held.
  constexpr bool kSplit = kTwoLevel && std::is_same_v<Real, double>;
  if constexpr (kOccl) {
    if constexpr (kSplit) {
      return leaf_any_split(tr, cnt, r, t_min, *upper);
    } else {
      return leaf_any(tr, cnt, r, t_min, *upper);
    }
  }
  int kb;
  Real t_leaf;
  if constexpr (kSplit) {
    t_leaf = leaf_closest_split(tr, cnt, r, t_min, *upper, &kb);
  } else {
    t_leaf = leaf_closest(tr, cnt, r, t_min, &kb);
  }
  const int row = start + kb;
  if constexpr (kTwoLevel) {
    if (t_leaf < *upper || (t_leaf == *upper && *upper < Num<Real>::big &&
                            (rank < *best_rank || (rank == *best_rank && row < *best)))) {
      *upper = t_leaf;
      *best = row;
      *best_rank = rank;
    }
  } else if (t_leaf < *upper || (t_leaf == *upper && *upper < Num<Real>::big && row < *best)) {
    *upper = t_leaf;
    *best = row;
  }
  return false;
}

// Load pair node `node`: its two boxes, then its references.
__device__ __forceinline__ void load_pair(const float4* __restrict__ nodes, int node, float4* a, float4* b,
                                          float4* c, int4* m) {
  const float4* nb = nodes + (size_t)node * kPair4;
  *a = __ldg(nb + 0);
  *b = __ldg(nb + 1);
  *c = __ldg(nb + 2);
  *m = __ldg(reinterpret_cast<const int4*>(nb + 3));
}

// The walk of ray i = blockIdx.x * blockDim.x + threadIdx.x from pair node
// 0. The stack: dynamic shared memory, or (kGlobalStack) `depth` levels per
// thread of `global_stack`. One-level (kTwoLevel false): n_tlas, inst and
// inst_out are not read. kOccl: writes occ_out; else t_out, id_out (and
// inst_out).
template <bool kOccl, bool kTwoLevel, bool kGlobalStack, typename Real>
__device__ __forceinline__ void pair_walk(
    const float4* __restrict__ nodes, int n_tlas, const Real* __restrict__ inst,
    const Real* __restrict__ tris, const Real* __restrict__ o, const Real* __restrict__ d,
    const bool* __restrict__ active, const Real* __restrict__ t_max, int n, Real t_min,
    unsigned* __restrict__ global_stack, int depth, Real* __restrict__ t_out,
    int* __restrict__ id_out, int* __restrict__ inst_out, bool* __restrict__ occ_out) {
  extern __shared__ unsigned pair_stack[];  // [level][threadIdx.x]
  unsigned* stack = kGlobalStack
                        ? global_stack + (size_t)blockIdx.x * blockDim.x * depth + threadIdx.x
                        : pair_stack + threadIdx.x;
  const int stride = blockDim.x;
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
  // The one-level closest hit loads the next node before it tests the
  // current node's leaves (which node comes next does not depend on them).
  constexpr bool kPrefetch = !kOccl && !kTwoLevel;
  // The float64 walks test their boxes in float (walk.cuh box_entry_f)
  // against rf, the float copy of r, kept beside it, and take the nearer
  // child by the float entry.
  constexpr bool kFloatBox = std::is_same_v<Real, double>;
  using Entry = std::conditional_t<kFloatBox, float, Real>;
  Ray<Real> r = load_ray(o, d, i);  // in the frame of the nodes being visited
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
  int rank = 0;  // the current instance's TLAS leaf rank
  int sp = 0;
  if constexpr (kPrefetch) {
    // As the loop below, but the next node's loads go out before the
    // current node's leaf tests. Its own loop: the loop below restructured
    // this way for every walk cost tlas2 1.17x / 1.10x and the one-level
    // any hit 1.05x (PERF.md).
    float4 a, b, c;
    int4 m;
    load_pair(nodes, 0, &a, &b, &c, &m);
    while (true) {
      Entry lo_a, lo_b;
      bool hit_a, hit_b;
      if constexpr (kFloatBox) {
        const float upper_f = __double2float_ru(upper);
        hit_a = box_entry_f(a.x, a.y, a.z, a.w, b.x, b.y, rf, t_min_f, upper_f, &lo_a);
        hit_b = box_entry_f(b.z, b.w, c.x, c.y, c.z, c.w, rf, t_min_f, upper_f, &lo_b) && m.y != 0;
      } else {
        const Real up = box_upper(upper);
        hit_a = box_entry(a.x, a.y, a.z, a.w, b.x, b.y, r, t_min, up, &lo_a);
        hit_b = box_entry(b.z, b.w, c.x, c.y, c.z, c.w, r, t_min, up, &lo_b) && m.y != 0;
      }
      const int ref_a = m.x;
      const int ref_b = m.y;
      const bool leaf_a = (ref_a & 3) == kRefLeaf;
      const bool leaf_b = (ref_b & 3) == kRefLeaf;
      const bool go_a = hit_a && !leaf_a;
      const bool go_b = hit_b && !leaf_b;
      int next = -1;
      if (go_a && go_b) {
        const bool b_first = lo_b < lo_a;
        stack[(sp++) * stride] = (unsigned)(b_first ? ref_a : ref_b);
        next = b_first ? ref_b : ref_a;
      } else if (go_a || go_b) {
        next = go_a ? ref_a : ref_b;
      } else if (sp > 0) {
        next = (int)stack[(--sp) * stride];
      }
      if (next >= 0) load_pair(nodes, next >> 2, &a, &b, &c, &m);
      if (hit_a && leaf_a) pair_leaf<kOccl, kTwoLevel>(tris, ref_a, r, t_min, rank, &upper, &best, &best_rank);
      if (hit_b && leaf_b) pair_leaf<kOccl, kTwoLevel>(tris, ref_b, r, t_min, rank, &upper, &best, &best_rank);
      if (next < 0) break;
    }
  } else {
    int node = 0;  // the TLAS root
    while (true) {
      // Visit `node`, in r's frame: both children's boxes, then its leaves.
      const float4* nb = nodes + (size_t)node * kPair4;
      const float4 a = __ldg(nb + 0);
      const float4 b = __ldg(nb + 1);
      const float4 c = __ldg(nb + 2);
      const int4 m = __ldg(reinterpret_cast<const int4*>(nb + 3));
      Entry lo_a, lo_b;
      bool hit_a, hit_b;
      if constexpr (kFloatBox) {
        const float upper_f = __double2float_ru(upper);
        hit_a = box_entry_f(a.x, a.y, a.z, a.w, b.x, b.y, rf, t_min_f, upper_f, &lo_a);
        hit_b = box_entry_f(b.z, b.w, c.x, c.y, c.z, c.w, rf, t_min_f, upper_f, &lo_b) && m.y != 0;
      } else {
        const Real up = box_upper(upper);
        hit_a = box_entry(a.x, a.y, a.z, a.w, b.x, b.y, r, t_min, up, &lo_a);
        hit_b = box_entry(b.z, b.w, c.x, c.y, c.z, c.w, r, t_min, up, &lo_b) && m.y != 0;
      }
      const bool leaf_a = (m.x & 3) == kRefLeaf;
      const bool leaf_b = (m.y & 3) == kRefLeaf;
      if (hit_a && leaf_a && pair_leaf<kOccl, kTwoLevel>(tris, m.x, r, t_min, rank, &upper, &best, &best_rank)) {
        occ_out[i] = true;
        return;
      }
      if (hit_b && leaf_b && pair_leaf<kOccl, kTwoLevel>(tris, m.y, r, t_min, rank, &upper, &best, &best_rank)) {
        occ_out[i] = true;
        return;
      }
      // Move on: of two hit children the nearer (closest hit) or A (any
      // hit), the other pushed; the one hit child; else the top of the
      // stack.
      const bool go_a = hit_a && !leaf_a;
      const bool go_b = hit_b && !leaf_b;
      int next;
      if (go_a && go_b) {
        const bool b_first = !kOccl && lo_b < lo_a;
        stack[(sp++) * stride] = (unsigned)(b_first ? m.x : m.y);
        next = b_first ? m.y : m.x;
      } else if (go_a || go_b) {
        next = go_a ? m.x : m.y;
      } else {
        if (sp == 0) break;
        next = (int)stack[(--sp) * stride];
      }
      node = next >> 2;
      if constexpr (kTwoLevel) {
        if ((next & 3) == kRefInst) {
          // An instance: the world ray in its frame, then its BLAS root.
          const Real* rec = inst + (size_t)node * kRec;
          to_local(rec, load_ray(o, d, i), &r);
          if constexpr (kFloatBox) rf = float_ray(r);
          local = true;
          rank = node;
          node = __ldg(reinterpret_cast<const int*>(rec + 12));
        } else if (node < n_tlas && local) {
          // A TLAS node popped in a local frame: every BLAS node of the
          // instance has been popped (LIFO), so back to the world ray.
          r = load_ray(o, d, i);
          if constexpr (kFloatBox) rf = float_ray(r);
          local = false;
        }
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

// The occupancy of a pair-walk kernel at a launch of `block` threads and
// `smem` bytes of dynamic shared memory a block (`allow` its library's
// allow_shared_stack, called past 48 KB): out[0] registers a thread, out[1]
// local (spill) bytes a thread (cudaFuncGetAttributes), out[2] blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[3] their warps.
template <typename Kernel, typename Allow>
cudaError_t pair_walk_occupancy(Kernel kernel, Allow allow, int block, size_t smem, int* out) {
  cudaError_t err = smem > 48 * 1024 ? allow() : cudaSuccess;
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, block, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = blocks * ((block + 31) / 32);
  return cudaSuccess;
}

}  // namespace
