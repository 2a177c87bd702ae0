// Pieces shared by the walks of bvh8.cu, tlas8.cu (through
// group_walk.cuh), bvh2.cu and tlas2.cu (through pair_walk.cuh): the ray
// and its load, the slab test of one box (of each child of a pair node,
// or of each of a wide node's 8 children), the instance
// transform, and the triangle tests on the precomputed 20-float rows. The
// layouts are documented in rpt_tpu_torch/ops/bvh8.py, ops/bvh2.py and
// ops/tlas2.py, whose plain
// torch walks repeat this arithmetic op for op (the sources are built with
// -fmad=false).
//
// Each .cu file includes this header once and is built into its own shared
// library, so the anonymous namespace gives every library its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kTriStride4 = 5;  // float4 per triangle row (20 floats)
constexpr int kNode4 = 12;      // float4 of child bounds per wide node
constexpr int kInst4 = 3;       // float4 per instance: the 3x4 world->local rows
constexpr int kBlock = 128;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  int oct;
};

__device__ __forceinline__ float safe_inv(float c) {
  float s = (fabsf(c) > 1e-20f) ? c : ((c < 0.0f) ? -1e-20f : 1e-20f);
  return 1.0f / s;
}

// Slab test of one box: does [lo, hi] overlap [t_min, upper] along the ray?
// *entry gets the ray's entry distance into the box (the slabs' lower end).
__device__ __forceinline__ bool box_entry(float lox, float loy, float loz, float hix, float hiy,
                                          float hiz, const Ray& r, float t_min, float upper,
                                          float* entry) {
  float t1x = (lox - r.ox) * r.ix;
  float t2x = (hix - r.ox) * r.ix;
  float t1y = (loy - r.oy) * r.iy;
  float t2y = (hiy - r.oy) * r.iy;
  float t1z = (loz - r.oz) * r.iz;
  float t2z = (hiz - r.oz) * r.iz;
  float lo = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
  float hi = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
  *entry = lo;
  return lo <= hi && hi >= t_min && lo <= upper;
}

__device__ __forceinline__ bool box_hit(float lox, float loy, float loz, float hix, float hiy,
                                        float hiz, const Ray& r, float t_min, float upper) {
  float entry;
  return box_entry(lox, loy, loz, hix, hiy, hiz, r, t_min, upper, &entry);
}

// Slab test of the 8 child boxes of one wide node: bit c set if child c's
// box overlaps [t_min, upper] along the ray.
__device__ __forceinline__ unsigned child_mask(const float4* __restrict__ nb, const Ray& r,
                                               float t_min, float upper) {
  float v[48];
#pragma unroll
  for (int q = 0; q < kNode4; ++q) {
    float4 x = __ldg(nb + q);
    v[4 * q + 0] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
  unsigned mask = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (box_hit(v[c], v[8 + c], v[16 + c], v[24 + c], v[32 + c], v[40 + c], r, t_min, upper)) {
      mask |= 1u << c;
    }
  }
  return mask;
}

// Load one ray from (N, 3) origin and direction rows, with its inverse
// direction and direction octant.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ o, const float* __restrict__ d,
                                        int i) {
  Ray r;
  r.ox = o[3 * i + 0];
  r.oy = o[3 * i + 1];
  r.oz = o[3 * i + 2];
  r.dx = d[3 * i + 0];
  r.dy = d[3 * i + 1];
  r.dz = d[3 * i + 2];
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  r.oct = (r.dx < 0.0f ? 1 : 0) | (r.dy < 0.0f ? 2 : 0) | (r.dz < 0.0f ? 4 : 0);
  return r;
}

// Re-express the world ray w in an instance's frame by the 3x4
// world->local affine rows a[0..2]: the direction is NOT normalized, so
// local t == world t and a prune on the running best holds at both levels.
__device__ __forceinline__ void to_local(const float4* __restrict__ a, const Ray& w, Ray* l) {
  const float4 r0 = __ldg(a + 0);
  const float4 r1 = __ldg(a + 1);
  const float4 r2 = __ldg(a + 2);
  l->ox = ((r0.x * w.ox + r0.y * w.oy) + r0.z * w.oz) + r0.w;
  l->oy = ((r1.x * w.ox + r1.y * w.oy) + r1.z * w.oz) + r1.w;
  l->oz = ((r2.x * w.ox + r2.y * w.oy) + r2.z * w.oz) + r2.w;
  l->dx = (r0.x * w.dx + r0.y * w.dy) + r0.z * w.dz;
  l->dy = (r1.x * w.dx + r1.y * w.dy) + r1.z * w.dz;
  l->dz = (r2.x * w.dx + r2.y * w.dy) + r2.z * w.dz;
  l->ix = safe_inv(l->dx);
  l->iy = safe_inv(l->dy);
  l->iz = safe_inv(l->dz);
}

// Plane + barycentric triangle test on a precomputed row
// (v0, e1, e2, pn, pv, d00, d01, d11, inv_den). Sets *ok for a hit in
// [t_min, inf) inside the triangle; returns its t.
__device__ __forceinline__ float tri_t(const float4* __restrict__ tr, const Ray& r, float t_min,
                                       bool* ok) {
  const float4 a = __ldg(tr + 0);  // v0x v0y v0z e1x
  const float4 b = __ldg(tr + 1);  // e1y e1z e2x e2y
  const float4 c = __ldg(tr + 2);  // e2z pnx pny pnz
  const float4 e = __ldg(tr + 3);  // pv d00 d01 d11
  const float inv_den = __ldg(reinterpret_cast<const float*>(tr + 4));
  float cosv = (c.y * r.dx + c.z * r.dy) + c.w * r.dz;
  float cos_safe = (fabsf(cosv) > 1e-8f) ? cosv : 1e-8f;
  float t = (e.x - ((c.y * r.ox + c.z * r.oy) + c.w * r.oz)) / cos_safe;
  float ddx = (r.ox + t * r.dx) - a.x;
  float ddy = (r.oy + t * r.dy) - a.y;
  float ddz = (r.oz + t * r.dz) - a.z;
  float d20 = (ddx * a.w + ddy * b.x) + ddz * b.y;
  float d21 = (ddx * b.z + ddy * b.w) + ddz * c.x;
  float v = (e.w * d20 - e.z * d21) * inv_den;
  float w = (e.y * d21 - e.z * d20) * inv_den;
  float u = (1.0f - v) - w;
  *ok = fabsf(cosv) >= 1e-8f && t >= t_min && u >= 0.0f && v >= 0.0f && w >= 0.0f;
  return t;
}

// Triangle test of one leaf's `cnt` rows for the closest hit: the lowest
// t in [t_min, inf) (strict <, so the lowest row wins a tie), kBig if
// none, and its row in *kb.
__device__ __forceinline__ float leaf_closest(const float4* __restrict__ tr, int cnt, const Ray& r,
                                              float t_min, int* kb) {
  float t_leaf = kBig;
  *kb = 0;
  for (int j = 0; j < cnt; ++j) {
    bool ok;
    float t = tri_t(tr + j * kTriStride4, r, t_min, &ok);
    t = ok ? t : kBig;
    if (t < t_leaf) {
      t_leaf = t;
      *kb = j;
    }
  }
  return t_leaf;
}

// Triangle test of one leaf's `cnt` rows for the any-hit query: is some t
// in [t_min, t_max]? Stops at the first such row.
__device__ __forceinline__ bool leaf_any(const float4* __restrict__ tr, int cnt, const Ray& r,
                                         float t_min, float t_max) {
  for (int j = 0; j < cnt; ++j) {
    bool ok;
    const float t = tri_t(tr + j * kTriStride4, r, t_min, &ok);
    if (ok && t <= t_max) return true;
  }
  return false;
}

inline int grid_for(int64_t n) { return (int)((n + kBlock - 1) / kBlock); }

}  // namespace
