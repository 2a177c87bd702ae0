// Pieces shared by the wide-BVH walks of bvh8.cu and tlas8.cu: the ray, the
// slab test of one wide node's 8 child boxes, and the triangle test on the
// precomputed 20-float rows. The layouts are documented in
// rpt_tpu_torch/ops/bvh8.py, whose plain torch walk repeats this arithmetic
// op for op (the sources are built with -fmad=false).
//
// Each .cu file includes this header once and is built into its own shared
// library, so the anonymous namespace gives every library its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kStackCap = 128;  // ops/bvh8.py STACK_CAP; the packs check the need
constexpr int kTriStride4 = 5;  // float4 per triangle row (20 floats)
constexpr int kNode4 = 12;      // float4 of child bounds per wide node
constexpr int kMeta = 24;       // int32 of meta per wide node
constexpr int kBlock = 128;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  int oct;
};

__device__ __forceinline__ float safe_inv(float c) {
  float s = (fabsf(c) > 1e-20f) ? c : ((c < 0.0f) ? -1e-20f : 1e-20f);
  return 1.0f / s;
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
    float t1x = (v[c] - r.ox) * r.ix;
    float t2x = (v[24 + c] - r.ox) * r.ix;
    float t1y = (v[8 + c] - r.oy) * r.iy;
    float t2y = (v[32 + c] - r.oy) * r.iy;
    float t1z = (v[16 + c] - r.oz) * r.iz;
    float t2z = (v[40 + c] - r.oz) * r.iz;
    float lo = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)), fminf(t1z, t2z));
    float hi = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)), fmaxf(t1z, t2z));
    if (lo <= hi && hi >= t_min && lo <= upper) mask |= 1u << c;
  }
  return mask;
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

inline int grid_for(int64_t n) { return (int)((n + kBlock - 1) / kBlock); }

}  // namespace
