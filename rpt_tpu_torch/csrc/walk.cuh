// Pieces shared by the walks of bvh8.cu, tlas8.cu (through
// group_walk.cuh), bvh2.cu and tlas2.cu (through pair_walk.cuh): the ray
// and its load, the slab test of one box (of each child of a pair node,
// or of each of a wide node's 8 children), the instance
// transform, and the triangle tests on the precomputed 20-value rows. The
// layouts are documented in rpt_tpu_torch/ops/bvh8.py, ops/bvh2.py and
// ops/tlas2.py, whose plain
// torch walks repeat this arithmetic op for op (the sources are built with
// -fmad=false).
//
// Everything is written once over the real type `Real` of the rays, the
// triangle rows, the instance transforms and the hit distances: float for
// the float32 renders, double for the float64 ones. The node boxes stay
// float in both (a float64 pack rounds them outward, so that they hold the
// float64 triangles) and are widened to Real where they are tested. With
// Real = float every conversion below is the identity, and the float
// instantiations compile to the code they were before the template.
//
// Each .cu file includes this header once and is built into its own shared
// library, so the anonymous namespace gives every library its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kTriStride = 20;  // reals per triangle row
constexpr int kNode4 = 12;      // float4 of child bounds per wide node
constexpr int kRec = 16;        // reals per instance record: 3x4 rows, then [BLAS root, id] as int32
constexpr int kBlock = 128;
constexpr int kMaxCards = 64;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory one block may hold (227 KB)

// The state of one kernel's `once_per_card` setting: a flag and a result
// for each card. Each kernel keeps one as a static.
struct PerCard {
  std::once_flag flag[kMaxCards];
  cudaError_t err[kMaxCards] = {};
};

// Runs `set` (a kernel attribute's setter) once per card and returns its
// result: an attribute belongs to the current card's context, so a card
// that has not set it does not have it. A thread that comes while another
// runs `set` for the same card waits for it and then reads its result.
template <typename Set>
cudaError_t once_per_card(PerCard& state, Set set) {
  int card = 0;
  const cudaError_t got = cudaGetDevice(&card);
  if (got != cudaSuccess) return got;
  if (card < 0 || card >= kMaxCards) return cudaErrorInvalidDevice;
  std::call_once(state.flag[card], [&] { state.err[card] = set(); });
  return state.err[card];
}

// The constants of each real type: the miss sentinel, the parallel-ray
// guard of the triangle test and the zero guard of the inverse direction,
// each the value the plain torch version uses in that type.
template <typename Real>
struct Num;
template <>
struct Num<float> {
  static constexpr float big = 3.0e38f, par = 1e-8f, tiny = 1e-20f, up = 0x1p-21f;
};
template <>
struct Num<double> {
  static constexpr double big = 3.0e38, par = 1e-8, tiny = 1e-20, up = 0x1p-50;
};

__device__ __forceinline__ float absr(float x) { return fabsf(x); }
__device__ __forceinline__ double absr(double x) { return fabs(x); }
__device__ __forceinline__ float minr(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double minr(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float maxr(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double maxr(double a, double b) { return fmax(a, b); }

// Four consecutive reals, read with one 16-byte load (float) or two (double).
template <typename Real>
struct Quad {
  Real x, y, z, w;
};
__device__ __forceinline__ Quad<float> ldq(const float* __restrict__ p) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  return {v.x, v.y, v.z, v.w};
}
__device__ __forceinline__ Quad<double> ldq(const double* __restrict__ p) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  return {a.x, a.y, b.x, b.y};
}

template <typename Real>
struct Ray {
  Real ox, oy, oz, dx, dy, dz, ix, iy, iz;
  int oct;
};

template <typename Real>
__device__ __forceinline__ Real safe_inv(Real c) {
  Real s = (absr(c) > Num<Real>::tiny) ? c : ((c < (Real)0) ? -Num<Real>::tiny : Num<Real>::tiny);
  return (Real)1 / s;
}

// The upper end of a box test: `upper` (the running best t, or t_max)
// widened by 8 ulps of itself (Num::up: 2^-21 in float, 2^-50 in double).
// A slab's entry is rounded three times ((lo - o), the inverse of d, their
// product) and a triangle's t twice or more, so a box whose entry is, in
// exact arithmetic, at or before a triangle's t can round to an entry an
// ulp or two past it: at a flat leaf, whose entry is its exit and lies on
// its triangles' plane, and at a leaf whose face a hit lies on. Tested
// against `upper` itself, the any hit at t_max = t would miss that triangle
// (the reference's rule is closest.t <= t_max), and the closest hit would
// skip a leaf tied at the running best, whose key could be smaller. Widened,
// the test takes such a box; a box taken in addition costs only a visit, as
// the triangle tests keep [t_min, upper] exactly. The flat leaves of
// tests/test_torch_f64.py `_edge_scene` need 2^-24 (float) and 2^-53
// (double) of upper, one u: 8u leaves room for the rest of the roundings,
// as box_entry_f's widening does.
template <typename Real>
__device__ __forceinline__ Real box_upper(Real upper) {
  return upper + absr(upper) * Num<Real>::up;
}

// Slab test of one box: does [lo, hi] overlap [t_min, upper] along the ray?
// *entry gets the ray's entry distance into the box (the slabs' lower end).
template <typename Real>
__device__ __forceinline__ bool box_entry(float lox, float loy, float loz, float hix, float hiy,
                                          float hiz, const Ray<Real>& r, Real t_min, Real upper,
                                          Real* entry) {
  Real t1x = ((Real)lox - r.ox) * r.ix;
  Real t2x = ((Real)hix - r.ox) * r.ix;
  Real t1y = ((Real)loy - r.oy) * r.iy;
  Real t2y = ((Real)hiy - r.oy) * r.iy;
  Real t1z = ((Real)loz - r.oz) * r.iz;
  Real t2z = ((Real)hiz - r.oz) * r.iz;
  Real lo = maxr(maxr(minr(t1x, t2x), minr(t1y, t2y)), minr(t1z, t2z));
  Real hi = minr(minr(maxr(t1x, t2x), maxr(t1y, t2y)), maxr(t1z, t2z));
  *entry = lo;
  return lo <= hi && hi >= t_min && lo <= upper;
}

template <typename Real>
__device__ __forceinline__ bool box_hit(float lox, float loy, float loz, float hix, float hiy,
                                        float hiz, const Ray<Real>& r, Real t_min, Real upper) {
  Real entry;
  return box_entry(lox, loy, loz, hix, hiy, hiz, r, t_min, upper, &entry);
}

// The float box test of a double walk (every float64 walk). The boxes are
// float; testing them in float against a float copy of the double ray
// makes the double inverse direction dead, and its operations are float's.
// RayF is that copy: the origin rounded to nearest, the inverse of the
// direction rounded to float (safe_inv in float, its zero guard signed by
// the double direction), and per axis a slack s = 2 |(double)of - o| |fi| +
// FLT_MIN that covers the origin's rounding (and any underflow). The double
// inverse direction is not needed: the walk's double division happens only
// in the triangle tests.
//
// box_entry_f widens each axis's slab [min(t1, t2), max(t1, t2)] outward by
// 2^-21 |t| + s before it takes the entry and exit, and tests them against
// t_min rounded down and upper rounded up to float. It accepts every box
// that box_entry accepts in double: each float slab end t_f lies within
// 4u |t_d| + s / 2 (u = 2^-24, to first order) of box_entry's t_d, for the
// roundings of o, of d and its inverse, of the subtraction and of the
// product; the widening covers that and its own two roundings (8u against
// the 4u needed, s against the s / 2 needed); min and max keep the order.
// So the walk reaches every leaf the double test reaches; a box it takes
// in addition costs only a visit.
struct RayF {
  float ox, oy, oz, ix, iy, iz, sx, sy, sz;
};

constexpr float kFltMin = 1.17549435e-38f;  // the smallest normal float
constexpr float kWiden = 0x1p-21f;          // 8u

__device__ __forceinline__ float inv_f(double d) {
  const float x = (float)d;
  const float s = (fabsf(x) > Num<float>::tiny) ? x : ((d < 0.0) ? -Num<float>::tiny : Num<float>::tiny);
  return 1.0f / s;
}

__device__ __forceinline__ float origin_slack(double o, float of, float fi) {
  return __double2float_rn(2.0 * (fabs((double)of - o) * fabs((double)fi))) + kFltMin;
}

template <typename Real>
__device__ __forceinline__ RayF float_ray(const Ray<Real>& r) {
  RayF f;
  f.ox = (float)r.ox;
  f.oy = (float)r.oy;
  f.oz = (float)r.oz;
  f.ix = inv_f(r.dx);
  f.iy = inv_f(r.dy);
  f.iz = inv_f(r.dz);
  f.sx = origin_slack(r.ox, f.ox, f.ix);
  f.sy = origin_slack(r.oy, f.oy, f.iy);
  f.sz = origin_slack(r.oz, f.oz, f.iz);
  return f;
}

__device__ __forceinline__ float widen_lo(float t, float s) { return t - (fabsf(t) * kWiden + s); }
__device__ __forceinline__ float widen_hi(float t, float s) { return t + (fabsf(t) * kWiden + s); }

__device__ __forceinline__ bool box_entry_f(float lox, float loy, float loz, float hix, float hiy, float hiz,
                                            const RayF& r, float t_min, float upper, float* entry) {
  float t1x = (lox - r.ox) * r.ix;
  float t2x = (hix - r.ox) * r.ix;
  float t1y = (loy - r.oy) * r.iy;
  float t2y = (hiy - r.oy) * r.iy;
  float t1z = (loz - r.oz) * r.iz;
  float t2z = (hiz - r.oz) * r.iz;
  float lo = fmaxf(fmaxf(widen_lo(fminf(t1x, t2x), r.sx), widen_lo(fminf(t1y, t2y), r.sy)),
                   widen_lo(fminf(t1z, t2z), r.sz));
  float hi = fminf(fminf(widen_hi(fmaxf(t1x, t2x), r.sx), widen_hi(fmaxf(t1y, t2y), r.sy)),
                   widen_hi(fmaxf(t1z, t2z), r.sz));
  *entry = lo;
  return lo <= hi && hi >= t_min && lo <= upper;
}

// Slab test of the 8 child boxes of one wide node: bit c set if child c's
// box overlaps [t_min, upper] along the ray (upper already widened by the
// caller, box_upper).
template <typename Real>
__device__ __forceinline__ unsigned child_mask(const float4* __restrict__ nb, const Ray<Real>& r,
                                               Real t_min, Real upper) {
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

// child_mask in float (box_entry_f): the 8 boxes against the float copy of
// a double ray, t_min rounded down and upper rounded up to float.
__device__ __forceinline__ unsigned child_mask_f(const float4* __restrict__ nb, const RayF& r, float t_min,
                                                 float upper) {
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
    float entry;
    if (box_entry_f(v[c], v[8 + c], v[16 + c], v[24 + c], v[32 + c], v[40 + c], r, t_min, upper, &entry)) {
      mask |= 1u << c;
    }
  }
  return mask;
}

// Load one ray from (N, 3) origin and direction rows, with its inverse
// direction and direction octant.
template <typename Real>
__device__ __forceinline__ Ray<Real> load_ray(const Real* __restrict__ o, const Real* __restrict__ d,
                                              int i) {
  Ray<Real> r;
  r.ox = o[3 * i + 0];
  r.oy = o[3 * i + 1];
  r.oz = o[3 * i + 2];
  r.dx = d[3 * i + 0];
  r.dy = d[3 * i + 1];
  r.dz = d[3 * i + 2];
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  r.oct = (r.dx < (Real)0 ? 1 : 0) | (r.dy < (Real)0 ? 2 : 0) | (r.dz < (Real)0 ? 4 : 0);
  return r;
}

// Re-express the world ray w in an instance's frame by the 3x4
// world->local affine rows a[0..11]: the direction is NOT normalized, so
// local t == world t and a prune on the running best holds at both levels.
template <typename Real>
__device__ __forceinline__ void to_local(const Real* __restrict__ a, const Ray<Real>& w, Ray<Real>* l) {
  const Quad<Real> r0 = ldq(a + 0);
  const Quad<Real> r1 = ldq(a + 4);
  const Quad<Real> r2 = ldq(a + 8);
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
template <typename Real>
__device__ __forceinline__ Real tri_t(const Real* __restrict__ tr, const Ray<Real>& r, Real t_min,
                                      bool* ok) {
  const Quad<Real> a = ldq(tr + 0);   // v0x v0y v0z e1x
  const Quad<Real> b = ldq(tr + 4);   // e1y e1z e2x e2y
  const Quad<Real> c = ldq(tr + 8);   // e2z pnx pny pnz
  const Quad<Real> e = ldq(tr + 12);  // pv d00 d01 d11
  const Real inv_den = __ldg(tr + 16);
  Real cosv = (c.y * r.dx + c.z * r.dy) + c.w * r.dz;
  Real cos_safe = (absr(cosv) > Num<Real>::par) ? cosv : Num<Real>::par;
  Real t = (e.x - ((c.y * r.ox + c.z * r.oy) + c.w * r.oz)) / cos_safe;
  Real ddx = (r.ox + t * r.dx) - a.x;
  Real ddy = (r.oy + t * r.dy) - a.y;
  Real ddz = (r.oz + t * r.dz) - a.z;
  Real d20 = (ddx * a.w + ddy * b.x) + ddz * b.y;
  Real d21 = (ddx * b.z + ddy * b.w) + ddz * c.x;
  Real v = (e.w * d20 - e.z * d21) * inv_den;
  Real w = (e.y * d21 - e.z * d20) * inv_den;
  Real u = ((Real)1 - v) - w;
  *ok = absr(cosv) >= Num<Real>::par && t >= t_min && u >= (Real)0 && v >= (Real)0 && w >= (Real)0;
  return t;
}

// tri_t in two halves, for a walk short of registers (the two-level float64
// walks; one-level, bvh8.cu measured it slower): tri_plane loads the row's
// plane (pn, pv) and returns the ray's t to it, its cosine in *cosv;
// tri_inside loads the rest of the row and tests whether the point at t
// lies inside the triangle. The arithmetic is
// tri_t's, op for op: a row is a hit of tri_t iff |cosv| >= par, t >= t_min
// and tri_inside holds. The leaf tests below test the plane first and load
// the rest of a row only for a t that could count.
template <typename Real>
__device__ __forceinline__ Real tri_plane(const Real* __restrict__ tr, const Ray<Real>& r, Real* cosv) {
  const Quad<Real> c = ldq(tr + 8);  // e2z pnx pny pnz
  const Real pv = __ldg(tr + 12);
  *cosv = (c.y * r.dx + c.z * r.dy) + c.w * r.dz;
  const Real cos_safe = (absr(*cosv) > Num<Real>::par) ? *cosv : Num<Real>::par;
  return (pv - ((c.y * r.ox + c.z * r.oy) + c.w * r.oz)) / cos_safe;
}

template <typename Real>
__device__ __forceinline__ bool tri_inside(const Real* __restrict__ tr, const Ray<Real>& r, Real t) {
  const Quad<Real> a = ldq(tr + 0);  // v0x v0y v0z e1x
  const Quad<Real> b = ldq(tr + 4);  // e1y e1z e2x e2y
  const Real e2z = __ldg(tr + 8);
  const Real d00 = __ldg(tr + 13);
  const Real d01 = __ldg(tr + 14);
  const Real d11 = __ldg(tr + 15);
  const Real inv_den = __ldg(tr + 16);
  Real ddx = (r.ox + t * r.dx) - a.x;
  Real ddy = (r.oy + t * r.dy) - a.y;
  Real ddz = (r.oz + t * r.dz) - a.z;
  Real d20 = (ddx * a.w + ddy * b.x) + ddz * b.y;
  Real d21 = (ddx * b.z + ddy * b.w) + ddz * e2z;
  Real v = (d11 * d20 - d01 * d21) * inv_den;
  Real w = (d00 * d21 - d01 * d20) * inv_den;
  Real u = ((Real)1 - v) - w;
  return u >= (Real)0 && v >= (Real)0 && w >= (Real)0;
}

// leaf_closest with the plane first: a row whose t exceeds `upper` (the
// running best) or the leaf's best so far is not loaded further. It cannot
// become the best hit, so the walk's answer is leaf_closest's.
template <typename Real>
__device__ __forceinline__ Real leaf_closest_split(const Real* __restrict__ tr, int cnt, const Ray<Real>& r,
                                                   Real t_min, Real upper, int* kb) {
  Real t_leaf = Num<Real>::big;
  *kb = 0;
  for (int j = 0; j < cnt; ++j) {
    const Real* row = tr + j * kTriStride;
    Real cosv;
    const Real t = tri_plane(row, r, &cosv);
    if (absr(cosv) >= Num<Real>::par && t >= t_min && t <= upper && t < t_leaf && tri_inside(row, r, t)) {
      t_leaf = t;
      *kb = j;
    }
  }
  return t_leaf;
}

// leaf_any with the plane first: the same answer.
template <typename Real>
__device__ __forceinline__ bool leaf_any_split(const Real* __restrict__ tr, int cnt, const Ray<Real>& r,
                                               Real t_min, Real t_max) {
  for (int j = 0; j < cnt; ++j) {
    const Real* row = tr + j * kTriStride;
    Real cosv;
    const Real t = tri_plane(row, r, &cosv);
    if (absr(cosv) >= Num<Real>::par && t >= t_min && t <= t_max && tri_inside(row, r, t)) return true;
  }
  return false;
}

// Triangle test of one leaf's `cnt` rows for the closest hit: the lowest
// t in [t_min, inf) (strict <, so the lowest row wins a tie), the miss
// sentinel if none, and its row in *kb.
template <typename Real>
__device__ __forceinline__ Real leaf_closest(const Real* __restrict__ tr, int cnt, const Ray<Real>& r,
                                             Real t_min, int* kb) {
  Real t_leaf = Num<Real>::big;
  *kb = 0;
  for (int j = 0; j < cnt; ++j) {
    bool ok;
    Real t = tri_t(tr + j * kTriStride, r, t_min, &ok);
    t = ok ? t : Num<Real>::big;
    if (t < t_leaf) {
      t_leaf = t;
      *kb = j;
    }
  }
  return t_leaf;
}

// Triangle test of one leaf's `cnt` rows for the any-hit query: is some t
// in [t_min, t_max]? Stops at the first such row.
template <typename Real>
__device__ __forceinline__ bool leaf_any(const Real* __restrict__ tr, int cnt, const Ray<Real>& r,
                                         Real t_min, Real t_max) {
  for (int j = 0; j < cnt; ++j) {
    bool ok;
    const Real t = tri_t(tr + j * kTriStride, r, t_min, &ok);
    if (ok && t <= t_max) return true;
  }
  return false;
}

inline int grid_for(int64_t n) { return (int)((n + kBlock - 1) / kBlock); }

}  // namespace
