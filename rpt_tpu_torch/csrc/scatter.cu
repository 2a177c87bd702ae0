// The scatter step of the port's wavefront (rpt_tpu_torch/ops/scatter.py),
// for NVIDIA Hopper (sm_90a): one depth's sampled direction, BSDF and path
// weight, one thread per lane.
//
// No TPU kernel stands behind this one: the JAX package leaves the shading
// math to XLA, which fuses it by itself. Eager PyTorch ran the same lines
// (materials.py `sample_f` and `bsdf`, then the weight) as some 450
// elementwise kernels a depth, each of which read and wrote (N,) or (N, 3)
// intermediates in device memory: half-vectors, tangent frames, Fresnel and
// Beckmann terms, three candidate directions. Here a lane reads its normal,
// wo, found, its material's gathered columns and the five uniform draws once
// (~73 bytes in float32), keeps every intermediate in registers, and writes
// wi, the masked weight w and ok once (25 bytes).
//
// What it computes, bit for bit with ops/scatter.py `scatter_plain` run by
// torch on the card (the card test holds it there): the same operations in
// the same order, each rounded where torch rounds it, the build's
// -fmad=false contracting none. Where one torch kernel does more than one
// rounding, this one does what that kernel does:
//   - a dot product is (x*x' + y*y') + z*z' (utils/vmath.py `dot`);
//   - torch.linalg.cross's component a*b - c*d is fma(a, b, -(c*d)), as
//     torch's own build (multiply-add contraction on) compiles it;
//   - torch.mean of a 3-vector is ((x + z) + y) * (N / 3N), the factor in the
//     real type (torch's reduction gives thread 0 elements 0 and 2, thread 1
//     element 1, and its MeanOps multiply by a factor); the wrapper passes
//     the factor;
//   - a division by a Python scalar is a product with its reciprocal in the
//     real type (torch's div_true with a CPU scalar), so x / pi is
//     x * (1 / pi);
//   - clamp, torch.minimum and sign keep torch's NaN rules and fminf/fmaxf;
//   - log, exp, atan, sin, cos, sqrt and rsqrt are the CUDA math library's
//     accurate functions, which torch's kernels call (no fast-math
//     intrinsics).
// The draws stay the threefry kernel's, made by the wrapper with the same
// keys as the plain version.
//
// What bounds it on this card: ~100 bytes a lane through device memory, so
// 1.44 M lanes take ~0.043 ms at 3.35 TB/s; beside that some 1,000
// instructions a lane of accurate transcendentals (five log/exp, an atan, four
// sin/cos, square roots) and two divisions, about as long again.
//
// C interface for ctypes: launches on the given stream, allocates nothing,
// returns cudaGetLastError() after the launch. Vectors are (n, 3) rows of
// the given row stride (elements, the last axis contiguous); every other
// array is (n,) and contiguous. `pdf`, unless it is null, receives the
// divisor of the weight (the sample's pdf where ok, else 1): what the
// wrapper's autograd path needs to rebuild the weight in torch. The kernel
// adds one to `launches` when it runs, unless it is null (count.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "count.cuh"  // count_launch

namespace {

constexpr int kBlock = 128;
constexpr double kPi = 3.141592653589793;

// The CUDA math library's accurate functions, by type.
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float atan_(float x) { return atanf(x); }
__device__ __forceinline__ double atan_(double x) { return atan(x); }
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }
__device__ __forceinline__ float fmax_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmax_(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float fmin_(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double fmin_(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename Real>
struct V3 {
  Real x, y, z;
};

template <typename Real>
__device__ __forceinline__ V3<Real> load3(const Real* p, int64_t i, int64_t stride) {
  const Real* r = p + i * stride;
  return {r[0], r[1], r[2]};
}

template <typename Real>
__device__ __forceinline__ void store3(Real* p, int64_t i, V3<Real> v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

template <typename Real>
__device__ __forceinline__ V3<Real> add(V3<Real> a, V3<Real> b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
template <typename Real>
__device__ __forceinline__ V3<Real> sub(V3<Real> a, V3<Real> b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
template <typename Real>
__device__ __forceinline__ V3<Real> scale(V3<Real> a, Real s) { return {a.x * s, a.y * s, a.z * s}; }
template <typename Real>
__device__ __forceinline__ V3<Real> pick(bool c, V3<Real> a, V3<Real> b) { return c ? a : b; }

// utils/vmath.py `dot`: (x + y) + z of the products.
template <typename Real>
__device__ __forceinline__ Real dot(V3<Real> a, V3<Real> b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }

// torch.linalg.cross, as torch's kernel is compiled (above).
template <typename Real>
__device__ __forceinline__ V3<Real> cross(V3<Real> a, V3<Real> b) {
  return {fma_(a.y, b.z, -(a.z * b.y)), fma_(a.z, b.x, -(a.x * b.z)), fma_(a.x, b.y, -(a.y * b.x))};
}

// utils/vmath.py `normalize`: v * rsqrt(|v|^2), and 0 at |v|^2 <= 1e-20.
template <typename Real>
__device__ __forceinline__ V3<Real> normalize(V3<Real> v) {
  const Real n2 = dot(v, v);
  const Real inv = n2 > Real(1e-20) ? rsqrt_(n2) : Real(0);
  return scale(v, inv);
}

// torch.clamp and its one-sided forms: NaN stays NaN.
template <typename Real>
__device__ __forceinline__ Real clamp_min(Real v, Real lo) { return v != v ? v : fmax_(v, lo); }
template <typename Real>
__device__ __forceinline__ Real clamp_max(Real v, Real hi) { return v != v ? v : fmin_(v, hi); }
template <typename Real>
__device__ __forceinline__ Real clip(Real v, Real lo, Real hi) { return v != v ? v : fmin_(fmax_(v, lo), hi); }

// torch.minimum: the first NaN, else fminf.
template <typename Real>
__device__ __forceinline__ Real minimum(Real a, Real b) { return a != a ? a : (b != b ? b : fmin_(a, b)); }

// torch.sign: (0 < x) - (x < 0), so 0 for a zero or a NaN.
template <typename Real>
__device__ __forceinline__ Real sign(Real x) { return Real((Real(0) < x) - (x < Real(0))); }

// materials.py `_safe`: |x| < 1e-9 becomes +-1e-9, keeping the sign of x.
template <typename Real>
__device__ __forceinline__ Real safe(Real x) {
  const Real eps = Real(1e-9);
  return fabs(x) < eps ? (x < Real(0) ? -eps : eps) : x;
}

// utils/vmath.py `safe_sqrt`.
template <typename Real>
__device__ __forceinline__ Real safe_sqrt(Real x) { return x > Real(0) ? sqrt_(x) : Real(0); }

template <typename Real>
__device__ __forceinline__ Real pow5(Real x) {
  const Real x2 = x * x;
  return x2 * x2 * x;
}

// The Beckmann exponent and cos^2 (materials.py `_beckmann_exponent`).
template <typename Real>
__device__ __forceinline__ void beckmann_exponent(V3<Real> n, V3<Real> h, Real m2, Real& expo, Real& cos2) {
  const V3<Real> c = cross(n, h);
  const Real sin2 = clip(dot(c, c), Real(0), Real(1));
  cos2 = clamp_min(Real(1) - sin2, Real(1e-12));
  expo = clamp_min(-sin2 / (cos2 * m2), Real(-80));
}

// materials.py `_beckmann_d` (cos_power 2) and `_beckmann_pdf` (1.5).
template <typename Real>
__device__ __forceinline__ Real beckmann(V3<Real> n, V3<Real> h, Real m2, Real cos_power) {
  Real expo, cos2;
  beckmann_exponent(n, h, m2, expo, cos2);
  const Real log_denom = log_(m2 * Real(kPi)) + cos_power * log_(cos2);
  return exp_(clamp_max(expo - log_denom, Real(80)));
}

// utils/vmath.py `orthonormal_basis` and `from_local`.
template <typename Real>
__device__ __forceinline__ V3<Real> from_local(V3<Real> n, Real lx, Real ly, Real lz) {
  const V3<Real> t_a = {n.y, -n.x, Real(0)};
  const V3<Real> t_b = {Real(0), -n.z, n.y};
  const V3<Real> t1 = normalize(pick(fabs(n.x) > Real(1e-12), t_a, t_b));
  const V3<Real> t2 = cross(n, t1);
  return add(add(scale(t1, lx), scale(t2, ly)), scale(n, lz));
}

template <typename Real>
struct Material {
  V3<Real> color;
  Real index, m2, f0s, metallic;
  bool transparent;
};

// materials.py `bsdf` for one lane.
template <typename Real>
__device__ __forceinline__ V3<Real> bsdf(const Material<Real>& mat, V3<Real> n, V3<Real> wo, V3<Real> wi) {
  const Real inv_pi = Real(1) / Real(kPi);
  const Real n_wi = dot(n, wi);
  const Real n_wo = dot(n, wo);
  const bool wi_out = n_wi >= Real(0);
  const bool wo_out = n_wo >= Real(0);
  const Real one_m = Real(1) - mat.metallic;
  const V3<Real> f0 = {mat.f0s * one_m + mat.color.x * mat.metallic, mat.f0s * one_m + mat.color.y * mat.metallic,
                       mat.f0s * one_m + mat.color.z * mat.metallic};

  // Same-side branch: Cook-Torrance + Lambert.
  const V3<Real> h = normalize(add(wi, wo));
  const Real wo_h = dot(wo, h);
  const Real n_h = dot(n, h);
  const Real d = beckmann(n, h, mat.m2, Real(2));
  const Real sin_t = safe_sqrt(Real(1) - wo_h * wo_h);
  const bool tir = !wi_out && sin_t * mat.index > Real(1);
  const Real p5 = pow5(Real(1) - wo_h);
  V3<Real> fres = {f0.x + (Real(1) - f0.x) * p5, f0.y + (Real(1) - f0.y) * p5, f0.z + (Real(1) - f0.z) * p5};
  if (tir) fres = {Real(1), Real(1), Real(1)};
  Real g = minimum(n_wi * n_h, n_wo * n_h);
  g = clamp_max(Real(2) * g / safe(wo_h), Real(1));
  const Real s = d * g / safe(Real(4) * n_wo * n_wi);
  const V3<Real> spec = scale(fres, s);
  const V3<Real> diff = {(Real(1) - fres.x) * mat.color.x * inv_pi, (Real(1) - fres.y) * mat.color.y * inv_pi,
                         (Real(1) - fres.z) * mat.color.z * inv_pi};
  const V3<Real> refl = mat.transparent ? spec : add(spec, diff);

  // Opposite-side branch: Walter-style BTDF.
  const Real eta_t = wo_out ? mat.index : Real(1) / mat.index;
  const V3<Real> h2 = normalize(add(scale(wi, eta_t), wo));
  const Real wi_h2 = dot(wi, h2);
  const Real wo_h2 = dot(wo, h2);
  const Real n_h2 = dot(n, h2);
  const Real d2 = beckmann(n, h2, mat.m2, Real(2));
  const Real p5b = pow5(Real(1) - fabs(wi_h2));
  const V3<Real> fres2 = {f0.x + (Real(1) - f0.x) * p5b, f0.y + (Real(1) - f0.y) * p5b,
                          f0.z + (Real(1) - f0.z) * p5b};
  Real g2 = minimum(fabs(n_wi * n_h2), fabs(n_wo * n_h2));
  g2 = clamp_max(Real(2) * g2 / safe(fabs(wo_h2)), Real(1));
  const Real scl = fabs(wi_h2 * wo_h2 / safe(n_wi * n_wo));
  const Real sq = eta_t * wi_h2 + wo_h2;
  const Real denom = safe(sq * sq);
  const Real q = scl * d2 * g2 / denom;
  const V3<Real> refr = {q * (Real(1) - fres2.x) * mat.color.x, q * (Real(1) - fres2.y) * mat.color.y,
                         q * (Real(1) - fres2.z) * mat.color.z};

  const V3<Real> out = wi_out == wo_out ? refl : refr;
  const bool blocked = !mat.transparent && (!wi_out || !wo_out);
  return blocked ? V3<Real>{Real(0), Real(0), Real(0)} : out;
}

template <typename Real>
__global__ void __launch_bounds__(kBlock)
scatter_kernel(int64_t n, const Real* __restrict__ normal, int64_t normal_stride, const Real* __restrict__ wo_in,
               int64_t wo_stride, const bool* __restrict__ found, const Real* __restrict__ color,
               int64_t color_stride, const Real* __restrict__ index, const Real* __restrict__ roughness,
               const Real* __restrict__ metallic, const Real* __restrict__ transparent,
               const Real* __restrict__ u_theta, const Real* __restrict__ u_phi, const Real* __restrict__ u_disk_r,
               const Real* __restrict__ u_disk_a, const Real* __restrict__ u_lobe, Real third,
               Real* __restrict__ wi_out, Real* __restrict__ w_out, bool* __restrict__ ok_out,
               Real* __restrict__ pdf_out, unsigned long long* launches) {
  count_launch(launches);
  const int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const V3<Real> nrm = load3(normal, i, normal_stride);
  const V3<Real> wo = load3(wo_in, i, wo_stride);
  Material<Real> mat;
  mat.color = load3(color, i, color_stride);
  mat.index = index[i];
  mat.metallic = metallic[i];
  mat.transparent = transparent[i] > Real(0.5);
  const Real r = roughness[i];
  mat.m2 = clamp_min(r * r, Real(1e-12));
  const Real f0r = (mat.index - Real(1)) / (mat.index + Real(1));
  mat.f0s = f0r * f0r;

  // materials.py `sample_f`.
  const Real inv_pi = Real(1) / Real(kPi);
  const Real mean = ((mat.color.x + mat.color.z) + mat.color.y) * third;
  Real f_est = (Real(1) - mat.metallic) * mat.f0s + mat.metallic * mean;
  f_est = f_est * Real(0.8) + Real(0.2);
  const Real n_wo = dot(wo, nrm);
  const Real eta_t = n_wo > Real(0) ? mat.index : Real(1) / mat.index;

  const Real theta = atan_(sqrt_(-mat.m2 * log_(u_theta[i])));
  const Real sin_t = sin_(theta), cos_t = cos_(theta);
  const Real phi = u_phi[i];
  const V3<Real> h = from_local(nrm, cos_(phi) * sin_t, sin_(phi) * sin_t, cos_t);
  const Real h_wo = dot(h, wo);
  const V3<Real> wi_spec = sub(scale(h, Real(2) * h_wo), wo);

  const Real rad = sqrt_(u_disk_r[i]);
  const Real ang = u_disk_a[i];
  const Real dx = rad * cos_(ang), dy = rad * sin_(ang);
  const Real dz = safe_sqrt(Real(1) - (dx * dx + dy * dy));
  const V3<Real> wi_diff = from_local(nrm, dx, dy, dz);

  const V3<Real> wo_perp = sub(wo, scale(h, h_wo));
  const V3<Real> wi_perp = {-wo_perp.x / eta_t, -wo_perp.y / eta_t, -wo_perp.z / eta_t};
  const Real sin2_ti = dot(wi_perp, wi_perp);
  const bool tir = sin2_ti > Real(1);
  const Real cos_ti = safe_sqrt(Real(1) - sin2_ti);
  const V3<Real> wi_trans = add(scale(h, -sign(h_wo) * cos_ti), wi_perp);

  const bool pick_spec = u_lobe[i] < f_est;
  const V3<Real> wi = pick_spec ? wi_spec : (mat.transparent ? wi_trans : wi_diff);
  const bool valid = !(!pick_spec && mat.transparent && tir);

  const Real n_wi = dot(wi, nrm);
  const V3<Real> hs = normalize(add(wi, wo));
  const Real p_spec = f_est * beckmann(nrm, hs, mat.m2, Real(1.5)) / safe(Real(4) * fabs(dot(hs, wo)));
  const Real p_diff = (Real(1) - f_est) * clamp_min(n_wi, Real(0)) * inv_pi;
  const V3<Real> ht = normalize(add(scale(wi, eta_t), wo));
  const Real ht_wo = dot(ht, wo);
  const Real ht_wi = dot(ht, wi);
  const Real jt = eta_t * ht_wi + ht_wo;
  const Real jac = fabs(ht_wo) / safe(jt * jt);
  Real p_trans = (Real(1) - f_est) * beckmann(nrm, ht, mat.m2, Real(1.5)) * jac;
  if ((n_wo >= Real(0)) == (n_wi >= Real(0))) p_trans = Real(0);
  const Real pdf = p_spec + (mat.transparent ? p_trans : p_diff);

  // integrator.py's weight: f |wi.n| / pdf where the sample counts, else 0.
  const V3<Real> f = bsdf(mat, nrm, wo, wi);
  const bool ok = found[i] && valid && pdf > Real(1e-10);
  const Real pdf_safe = ok ? pdf : Real(1);
  const Real x = fabs(dot(wi, nrm)) / pdf_safe;
  const V3<Real> w = ok ? scale(f, x) : V3<Real>{Real(0), Real(0), Real(0)};
  store3(wi_out, i, wi);
  store3(w_out, i, w);
  ok_out[i] = ok;
  if (pdf_out != nullptr) pdf_out[i] = pdf_safe;
}

template <typename Real>
int launch(int64_t n, const Real* normal, int64_t normal_stride, const Real* wo, int64_t wo_stride, const bool* found,
           const Real* color, int64_t color_stride, const Real* index, const Real* roughness, const Real* metallic,
           const Real* transparent, const Real* u_theta, const Real* u_phi, const Real* u_disk_r,
           const Real* u_disk_a, const Real* u_lobe, Real third, Real* wi, Real* w, bool* ok, Real* pdf,
           unsigned long long* launches, void* stream) {
  if (n <= 0) return 0;
  const unsigned grid = (unsigned)((n + kBlock - 1) / kBlock);
  scatter_kernel<Real><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      n, normal, normal_stride, wo, wo_stride, found, color, color_stride, index, roughness, metallic, transparent,
      u_theta, u_phi, u_disk_r, u_disk_a, u_lobe, third, wi, w, ok, pdf, launches);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rpt_scatter(int64_t n, const float* normal, int64_t normal_stride, const float* wo, int64_t wo_stride,
                const bool* found, const float* color, int64_t color_stride, const float* index,
                const float* roughness, const float* metallic, const float* transparent, const float* u_theta,
                const float* u_phi, const float* u_disk_r, const float* u_disk_a, const float* u_lobe, float third,
                float* wi, float* w, bool* ok, float* pdf, unsigned long long* launches, void* stream) {
  return launch<float>(n, normal, normal_stride, wo, wo_stride, found, color, color_stride, index, roughness, metallic,
                       transparent, u_theta, u_phi, u_disk_r, u_disk_a, u_lobe, third, wi, w, ok, pdf, launches,
                       stream);
}

int rpt_scatter_f64(int64_t n, const double* normal, int64_t normal_stride, const double* wo, int64_t wo_stride,
                    const bool* found, const double* color, int64_t color_stride, const double* index,
                    const double* roughness, const double* metallic, const double* transparent,
                    const double* u_theta, const double* u_phi, const double* u_disk_r, const double* u_disk_a,
                    const double* u_lobe, double third, double* wi, double* w, bool* ok, double* pdf,
                    unsigned long long* launches, void* stream) {
  return launch<double>(n, normal, normal_stride, wo, wo_stride, found, color, color_stride, index, roughness,
                        metallic, transparent, u_theta, u_phi, u_disk_r, u_disk_a, u_lobe, third, wi, w, ok, pdf,
                        launches, stream);
}

}  // extern "C"
