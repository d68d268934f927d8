// One lane of the bounce step's shading, after the closest hit: the code
// csrc/shade.cu runs one thread a lane on the card. The same source builds
// for the host (without __CUDACC__), where the CPU tests hold it to the
// torch route of models/integrator.py _bounce_step.
//
// Every operation is the torch route's, in its order, with its rounding
// spelled out (add / sub / mul / dvd are __fadd_rn / __fsub_rn / __fmul_rn /
// __fdiv_rn). What PyTorch's CUDA kernels do that the Python source does
// not show:
// - a float32 tensor divided by a Python number is multiplied by the
//   reciprocal rounded to float32 (the host passes inv_pi, inv_n_lights,
//   inv_s and inv_lam_range so);
// - torch.sum over a trailing dim of n <= 32 elements runs last_pow2(n)
//   threads a row; thread j adds elements j, j + w, ... into four
//   accumulators in turn, folds them, and the threads fold at shuffle
//   offsets 1, 2, 4, ... (aten_sum); the dot of three is (p0 + p2) + p1,
//   and no such sum is -0;
// - torch.linalg.norm over three is the square root of that sum of the
//   squares; torch.linalg.cross contracts its first product into an FMA:
//   fma(a_j, b_k, -(a_k b_j));
// - torch.clamp passes NaN and is fmaxf / fminf otherwise; torch.sign is
//   (0 < x) - (x < 0).
// The einsum of env_radiance over three or more lights goes through a
// cuBLAS kernel whose order is not fixed; it is summed in light order here,
// and such scenes are held to the torch route within a tolerance.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define CRT_HD __device__ __forceinline__
#else
#include <cmath>
#define CRT_HD static inline
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline float __fsqrt_rn(float a) { return std::sqrt(a); }
static inline float __fmaf_rn(float a, float b, float c) {
  return std::fma(a, b, c);
}
#endif

// The launch's arguments (ops/shade_kernel.py ShadeArgs): n lanes of kS
// wavelengths; every array is C-contiguous, bools one byte.
struct CrtShadeArgs {
  // the path state entering the bounce
  const float* o;          // (n, 3)
  const float* d;          // (n, 3)
  const float* beta;       // (n, S)
  const float* L;          // (n, S)
  const float* lam;        // (n, S)
  const float* lam_pdf;    // (n, S)
  const uint8_t* alive;    // (n,)
  const uint8_t* specular; // (n,)
  const float* pdf_prev;   // (n,)
  const float* n_prev;     // (n, 3)
  // the surface record of scene_surface and its material id
  const float* t;           // (n,)
  const uint8_t* valid;     // (n,)
  const float* p;           // (n, 3)
  const float* n;           // (n, 3)
  const float* uv;          // (n, 2)
  const float* wo;          // (n, 3)
  const uint8_t* backface;  // (n,)
  const int64_t* mid;       // (n,)
  // the bounce's sampler draws (u_sel, u_pos unused in walk mode, u_rr
  // unless roulette)
  const float* u_sel;  // (n,)
  const float* u_pos;  // (n, 2)
  const float* u2;     // (n, 2)
  const float* u1;     // (n,)
  const float* u_rr;   // (n,)
  // the pass's spectral cache: (n, S, n_cols), [lights | emission | eta | k]
  const float* svals;
  // the material table (n_mats rows)
  const int64_t* mat_kind;
  const float* mat_coeffs;  // (M, 3)
  const uint8_t* mat_use_texture;
  const float* mat_roughness;
  // the light table (n_lights rows)
  const int64_t* light_kind;
  const float* light_position;   // (L, 3)
  const float* light_direction;  // (L, 3)
  const float* light_edge1;      // (L, 3)
  const float* light_edge2;      // (L, 3)
  const float* light_scale;      // (L,)
  const float* texture;          // (tex_h, tex_w, 3) or null
  // outputs: the next state, the shadow ray and the pending NEE term
  float* o_out;
  float* d_out;
  float* beta_out;
  float* L_out;
  uint8_t* alive_out;
  uint8_t* specular_out;
  float* pdf_prev_out;
  float* n_prev_out;
  float* lam_pdf_out;
  float* shadow_o;  // (n, 3)
  float* shadow_d;  // (n, 3)
  float* shadow_t;  // (n,)
  float* nee;       // (n, S)
  int32_t n_lanes, n_lights, n_mats, n_cols, mode, roulette, has_rough,
      tex_w, tex_h;
  float ray_eps_scale, world_radius, inv_pi, inv_n_lights, inv_s,
      inv_lam_range;
};

namespace crt_shade {

constexpr int kS = 8;
constexpr int kMaxLights = 32;
enum { kMis = 0, kSimple = 1, kWalk = 2 };
enum { kLambertian = 0, kConductor = 1, kDielectric = 2, kRoughConductor = 3 };
enum { kPoint = 0, kDistant = 1, kQuad = 2, kAmbient = 3 };

constexpr double kPiD = 3.14159265358979323846;
// Python floats as PyTorch's float32 kernels take them.
constexpr float kPi = static_cast<float>(kPiD);
constexpr float kTwoPi = static_cast<float>(2.0 * kPiD);
constexpr float kPiOver2 = static_cast<float>(kPiD / 2.0);
constexpr float kPiOver4 = static_cast<float>(kPiD / 4.0);
constexpr float kInvPiMul = static_cast<float>(1.0 / kPiD);  // x * INV_PI
constexpr float kLambdaMin = 360.0f;

CRT_HD float add(float a, float b) { return __fadd_rn(a, b); }
CRT_HD float sub(float a, float b) { return __fsub_rn(a, b); }
CRT_HD float mul(float a, float b) { return __fmul_rn(a, b); }
CRT_HD float dvd(float a, float b) { return __fdiv_rn(a, b); }
CRT_HD float sqr(float a) { return __fsqrt_rn(a); }
CRT_HD bool isnan_(float x) { return x != x; }
CRT_HD float fabs_(float x) { return fabsf(x); }
CRT_HD bool isfinite_(float x) { return __fsub_rn(x, x) == 0.0f; }
CRT_HD float fmax_(float a, float b) { return fmaxf(a, b); }
CRT_HD float fmin_(float a, float b) { return fminf(a, b); }

// torch.clamp(x, min=lo) and torch.clamp(x, lo, hi)
CRT_HD float clamp_lo(float x, float lo) {
  return isnan_(x) ? x : fmax_(x, lo);
}
CRT_HD float clamp2(float x, float lo, float hi) {
  return isnan_(x) ? x : fmin_(fmax_(x, lo), hi);
}
CRT_HD float sign_(float x) {
  return static_cast<float>((0.0f < x) - (x < 0.0f));
}
// amax: NaN wins
CRT_HD float max_nan(float a, float b) {
  return (isnan_(a) || a > b) ? a : b;
}

// torch.sum over a trailing dim of m <= kMaxLights elements x(0..m-1). ATen
// starts each accumulator at +0; that only turns a -0 into +0, which the
// final + 0 does once.
template <typename F>
CRT_HD float aten_sum(int m, F x) {
  if (m == 1) return add(x(0), 0.0f);
  if (m == 2) return add(add(x(0), x(1)), 0.0f);
  if (m == 3) return add(add(add(x(0), x(2)), x(1)), 0.0f);
  int w = 1;
  while (w * 2 <= m) w *= 2;
  float part[kMaxLights];
  for (int j = 0; j < w; ++j) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int k = 0;
    for (int i = j; i < m; i += w, ++k) acc[k & 3] = add(acc[k & 3], x(i));
    part[j] = add(add(add(acc[0], acc[1]), acc[2]), acc[3]);
  }
  for (int off = 1; off < w; off <<= 1) {
    for (int j = 0; j + off < w; j += 2 * off) {
      part[j] = add(part[j], part[j + off]);
    }
  }
  return add(part[0], 0.0f);
}

// torch.sum(a * b, -1) over three
CRT_HD float dot3(const float a[3], const float b[3]) {
  return add(add(add(mul(a[0], b[0]), mul(a[2], b[2])), mul(a[1], b[1])),
             0.0f);
}
// torch.linalg.norm(a, dim=-1) over three
CRT_HD float norm3(const float a[3]) {
  return sqr(add(add(add(mul(a[0], a[0]), mul(a[2], a[2])), mul(a[1], a[1])),
                 0.0f));
}
// torch.linalg.cross
CRT_HD void cross3(const float a[3], const float b[3], float out[3]) {
  for (int c = 0; c < 3; ++c) {
    const int j = (c + 1) % 3, k = (c + 2) % 3;
    out[c] = __fmaf_rn(a[j], b[k], -mul(a[k], b[j]));
  }
}

CRT_HD void load3(const float* src, int64_t i, float out[3]) {
  out[0] = src[3 * i];
  out[1] = src[3 * i + 1];
  out[2] = src[3 * i + 2];
}
CRT_HD void store3(float* dst, int64_t i, const float v[3]) {
  dst[3 * i] = v[0];
  dst[3 * i + 1] = v[1];
  dst[3 * i + 2] = v[2];
}

// A lane's kS floats at src + i * kS: two 16-byte accesses where the row is
// so aligned (a fresh torch tensor always is), else one float at a time.
CRT_HD void load8(const float* src, int64_t i, float out[kS]) {
  const float* row = src + i * kS;
#ifdef __CUDACC__
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const float4 a = reinterpret_cast<const float4*>(row)[0];
    const float4 b = reinterpret_cast<const float4*>(row)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
    return;
  }
#endif
  for (int s = 0; s < kS; ++s) out[s] = row[s];
}
CRT_HD void store8(float* dst, int64_t i, const float v[kS]) {
  float* row = dst + i * kS;
#ifdef __CUDACC__
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    reinterpret_cast<float4*>(row)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(row)[1] = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
#endif
  for (int s = 0; s < kS; ++s) row[s] = v[s];
}

// materials.build_frame (Duff et al.)
CRT_HD void build_frame(const float n[3], float t1[3], float t2[3]) {
  const float s = n[2] >= 0.0f ? 1.0f : -1.0f;
  const float a = dvd(-1.0f, add(s, n[2]));
  const float b = mul(mul(n[0], n[1]), a);
  t1[0] = add(1.0f, mul(mul(s, mul(n[0], n[0])), a));
  t1[1] = mul(s, b);
  t1[2] = mul(-s, n[0]);
  t2[0] = b;
  t2[1] = add(s, mul(mul(n[1], n[1]), a));
  t2[2] = -n[1];
}

// materials.to_local / to_world
CRT_HD void to_local(const float t[3], const float b[3], const float n[3],
                     const float w[3], float out[3]) {
  out[0] = dot3(w, t);
  out[1] = dot3(w, b);
  out[2] = dot3(w, n);
}
CRT_HD void to_world(const float t[3], const float b[3], const float n[3],
                     const float w[3], float out[3]) {
  for (int c = 0; c < 3; ++c) {
    out[c] = add(add(mul(w[0], t[c]), mul(w[1], b[c])), mul(w[2], n[c]));
  }
}

// sampling.sample_cosine_hemisphere (Malley over the concentric disk)
CRT_HD void cosine_hemisphere(float u0, float u1, float out[3]) {
  const float x = sub(mul(2.0f, u0), 1.0f);
  const float y = sub(mul(2.0f, u1), 1.0f);
  const bool zero = (x == 0.0f) && (y == 0.0f);
  const bool xmaj = fabs_(x) > fabs_(y);
  float ratio;
  if (xmaj) {
    ratio = x != 0.0f ? dvd(y, x) : 0.0f;
  } else {
    ratio = y != 0.0f ? dvd(x, y) : 0.0f;
  }
  const float r = xmaj ? x : y;
  const float theta = xmaj ? mul(kPiOver4, ratio)
                           : sub(kPiOver2, mul(kPiOver4, ratio));
  const float dx = zero ? 0.0f : mul(r, cosf(theta));
  const float dy = zero ? 0.0f : mul(r, sinf(theta));
  out[0] = dx;
  out[1] = dy;
  out[2] = sqr(clamp_lo(sub(sub(1.0f, mul(dx, dx)), mul(dy, dy)), 0.0f));
}

// color.sigmoid_polynomial at the normalized wavelength t
CRT_HD float lam_norm(float lam, float inv_range) {
  return sub(mul(mul(sub(lam, kLambdaMin), inv_range), 2.0f), 1.0f);
}
CRT_HD float sigmoid_poly(const float c[3], float t) {
  const float x = add(mul(add(mul(c[2], t), c[1]), t), c[0]);
  return add(0.5f, dvd(x, mul(2.0f, sqr(add(1.0f, mul(x, x))))));
}

// montecarlo.power_heuristic(1, f, 1, g)
CRT_HD float power_heuristic(float f, float g) {
  const float ff = mul(f, f);
  return dvd(ff, clamp_lo(add(ff, mul(g, g)), static_cast<float>(1e-30)));
}

CRT_HD float fresnel_conductor(float ci, float eta, float k) {
  ci = clamp2(ci, static_cast<float>(1e-5), 1.0f);
  const float cos2 = mul(ci, ci);
  const float sin2 = sub(1.0f, cos2);
  const float eta2 = mul(eta, eta);
  const float k2 = mul(k, k);
  const float t0 = sub(add(eta2, k2), sin2);
  const float a2b2 =
      sqr(clamp_lo(add(mul(t0, t0), mul(mul(4.0f, eta2), k2)), 0.0f));
  const float t1 = add(a2b2, cos2);
  const float a = sqr(clamp_lo(mul(0.5f, add(a2b2, t0)), 0.0f));
  const float t2 = mul(mul(2.0f, a), ci);
  const float rs =
      dvd(sub(t1, t2), clamp_lo(add(t1, t2), static_cast<float>(1e-9)));
  const float t3 = add(mul(cos2, a2b2), mul(sin2, sin2));
  const float t4 = mul(t2, sin2);
  const float rp = dvd(mul(rs, sub(t3, t4)),
                       clamp_lo(add(t3, t4), static_cast<float>(1e-9)));
  return mul(0.5f, add(rs, rp));
}

CRT_HD float fresnel_dielectric(float ci, float eta) {
  ci = clamp2(ci, 0.0f, 1.0f);
  const float sin2_t =
      dvd(clamp_lo(sub(1.0f, mul(ci, ci)), 0.0f), mul(eta, eta));
  const float cos_t = sqr(clamp_lo(sub(1.0f, sin2_t), 0.0f));
  const float r_par =
      dvd(sub(mul(eta, ci), cos_t),
          clamp_lo(add(mul(eta, ci), cos_t), static_cast<float>(1e-9)));
  const float r_perp =
      dvd(sub(ci, mul(eta, cos_t)),
          clamp_lo(add(ci, mul(eta, cos_t)), static_cast<float>(1e-9)));
  const float f = mul(0.5f, add(mul(r_par, r_par), mul(r_perp, r_perp)));
  return sin2_t >= 1.0f ? 1.0f : f;
}

CRT_HD float ggx_d(float cos_h, float alpha) {
  const float a2 = mul(alpha, alpha);
  const float denom = add(mul(mul(cos_h, cos_h), sub(a2, 1.0f)), 1.0f);
  return dvd(a2, clamp_lo(mul(mul(kPi, denom), denom),
                          static_cast<float>(1e-12)));
}

CRT_HD float ggx_g1(float cos_v, float alpha) {
  const float a2 = mul(alpha, alpha);
  const float c = clamp2(cos_v, static_cast<float>(1e-5), 1.0f);
  return dvd(mul(2.0f, c),
             clamp_lo(add(c, sqr(add(a2, mul(mul(sub(1.0f, a2), c), c)))),
                      static_cast<float>(1e-12)));
}

CRT_HD void ggx_sample_half(float u0, float u1, float alpha, float h[3]) {
  const float a2 = mul(alpha, alpha);
  const float cos_h = sqr(clamp2(
      dvd(sub(1.0f, u0), add(1.0f, mul(sub(a2, 1.0f), u0))), 0.0f, 1.0f));
  const float sin_h = sqr(clamp_lo(sub(1.0f, mul(cos_h, cos_h)), 0.0f));
  const float phi = mul(kTwoPi, u1);
  h[0] = mul(sin_h, cosf(phi));
  h[1] = mul(sin_h, sinf(phi));
  h[2] = cos_h;
}

// materials._rough_conductor_fpdf: f (S) and the pdf
CRT_HD float rough_conductor_fpdf(const float wo_l[3], const float wi_l[3],
                                  float alpha, const float eta[kS],
                                  const float k[kS], const float tint[kS],
                                  float f[kS]) {
  const float cos_o = wo_l[2];
  const float cos_i = wi_l[2];
  const bool same = (cos_o > static_cast<float>(1e-5)) &&
                    (cos_i > static_cast<float>(1e-5));
  float h[3];
  for (int c = 0; c < 3; ++c) h[c] = add(wo_l[c], wi_l[c]);
  const float hn = clamp_lo(norm3(h), static_cast<float>(1e-12));
  for (int c = 0; c < 3; ++c) h[c] = dvd(h[c], hn);
  const float cos_h = clamp2(h[2], 0.0f, 1.0f);
  const float odoth = clamp_lo(dot3(wo_l, h), static_cast<float>(1e-6));
  const float d_val = ggx_d(cos_h, alpha);
  const float g = mul(ggx_g1(cos_o, alpha), ggx_g1(cos_i, alpha));
  const float scale =
      dvd(mul(d_val, g), clamp_lo(mul(mul(4.0f, cos_o), cos_i),
                                  static_cast<float>(1e-6)));
  for (int s = 0; s < kS; ++s) {
    f[s] = same ? mul(mul(fresnel_conductor(odoth, eta[s], k[s]), tint[s]),
                      scale)
                : 0.0f;
  }
  return same ? dvd(mul(d_val, cos_h), mul(4.0f, odoth)) : 0.0f;
}

// The material of a lane: materials.MaterialView, the texture's
// coefficients and the spectra the cache holds for its row.
struct Material {
  int64_t kind;
  float coeffs[3];
  bool use_texture;
  float roughness;
  bool has_tex;
  float tex[3];
};

// material_albedo at t[s] (the normalized wavelengths)
CRT_HD void albedo(const Material& m, const float t[kS], float out[kS]) {
  for (int s = 0; s < kS; ++s) {
    const float a = sigmoid_poly(m.coeffs, t[s]);
    out[s] = (m.has_tex && m.use_texture) ? mul(a, sigmoid_poly(m.tex, t[s]))
                                          : a;
  }
}

// scene.texture_lookup: bilinear sigmoid coefficients
CRT_HD void texture_lookup(const float* tex, int w, int h, const float uv[2],
                           float out[3]) {
  const float x = mul(clamp2(uv[0], 0.0f, 1.0f), static_cast<float>(w - 1));
  const float y =
      mul(clamp2(sub(1.0f, uv[1]), 0.0f, 1.0f), static_cast<float>(h - 1));
  int64_t x0 = static_cast<int64_t>(floorf(x));
  int64_t y0 = static_cast<int64_t>(floorf(y));
  x0 = x0 < 0 ? 0 : (x0 > w - 2 ? w - 2 : x0);
  y0 = y0 < 0 ? 0 : (y0 > h - 2 ? h - 2 : y0);
  const float fx = sub(x, static_cast<float>(x0));
  const float fy = sub(y, static_cast<float>(y0));
  const float gx = sub(1.0f, fx);
  const float gy = sub(1.0f, fy);
  const float* r0 = tex + (y0 * w + x0) * 3;
  const float* r1 = tex + ((y0 + 1) * w + x0) * 3;
  for (int c = 0; c < 3; ++c) {
    const float top = add(mul(gx, r0[c]), mul(fx, r0[3 + c]));
    const float bot = add(mul(gx, r1[c]), mul(fx, r1[3 + c]));
    out[c] = add(mul(gy, top), mul(fy, bot));
  }
}

// The surface point a lane shades.
struct Surface {
  float p[3], n[3], wo[3];
  bool backface;
  float tb[3], bb[3];  // build_frame(n)
};

// lights.sample_light: wi, dist, Li (S), pdf, kind
struct LightSample {
  float wi[3];
  float dist;
  float li[kS];
  float pdf;
  int64_t kind;
};

CRT_HD void sample_light(const CrtShadeArgs& a, const Surface& sf,
                         const float* lvals, int S_stride, float u_sel,
                         float u_pos0, float u_pos1, LightSample& ls) {
  const int nl = a.n_lights;
  int64_t li = static_cast<int64_t>(mul(u_sel, static_cast<float>(nl)));
  li = li < 0 ? 0 : (li > nl - 1 ? nl - 1 : li);
  const int64_t kind = a.light_kind[li];
  const float scale = a.light_scale[li];
  float spd_at[kS];
  for (int s = 0; s < kS; ++s) spd_at[s] = mul(lvals[s * S_stride + li], scale);
  const float far_ = a.world_radius;
  float pdf = 1.0f;
  ls.kind = kind;
  if (kind == kPoint) {
    float to_l[3], pos[3];
    load3(a.light_position, li, pos);
    for (int c = 0; c < 3; ++c) to_l[c] = sub(pos[c], sf.p[c]);
    const float dist2 = clamp_lo(dot3(to_l, to_l), static_cast<float>(1e-12));
    const float dist = sqr(dist2);
    for (int c = 0; c < 3; ++c) ls.wi[c] = dvd(to_l[c], dist);
    ls.dist = dist;
    for (int s = 0; s < kS; ++s) ls.li[s] = dvd(spd_at[s], dist2);
  } else if (kind == kDistant) {
    float dir[3];
    load3(a.light_direction, li, dir);
    for (int c = 0; c < 3; ++c) ls.wi[c] = -dir[c];
    ls.dist = far_;
    for (int s = 0; s < kS; ++s) ls.li[s] = spd_at[s];
  } else if (kind == kQuad) {
    float pos[3], e1[3], e2[3], qp[3], qn[3], to_q[3];
    load3(a.light_position, li, pos);
    load3(a.light_edge1, li, e1);
    load3(a.light_edge2, li, e2);
    for (int c = 0; c < 3; ++c) {
      qp[c] = add(add(pos[c], mul(u_pos0, e1[c])), mul(u_pos1, e2[c]));
    }
    cross3(e1, e2, qn);
    const float area = clamp_lo(norm3(qn), static_cast<float>(1e-12));
    for (int c = 0; c < 3; ++c) qn[c] = dvd(qn[c], area);
    for (int c = 0; c < 3; ++c) to_q[c] = sub(qp[c], sf.p[c]);
    const float dq2 = clamp_lo(dot3(to_q, to_q), static_cast<float>(1e-12));
    const float dq = sqr(dq2);
    float neg[3];
    for (int c = 0; c < 3; ++c) {
      ls.wi[c] = dvd(to_q[c], dq);
      neg[c] = -ls.wi[c];
    }
    const float cos_l = dot3(neg, qn);
    pdf = dvd(dq2, clamp_lo(mul(area, fabs_(cos_l)),
                            static_cast<float>(1e-12)));
    ls.dist = dq;
    for (int s = 0; s < kS; ++s) ls.li[s] = cos_l > 0.0f ? spd_at[s] : 0.0f;
  } else {
    float w_l[3];
    cosine_hemisphere(u_pos0, u_pos1, w_l);
    to_world(sf.tb, sf.bb, sf.n, w_l, ls.wi);
    pdf = mul(clamp_lo(dot3(ls.wi, sf.n), static_cast<float>(1e-9)),
              a.inv_pi);
    ls.dist = far_;
    for (int s = 0; s < kS; ++s) ls.li[s] = spd_at[s];
  }
  ls.pdf = mul(pdf, a.inv_n_lights);
}

// lights.pdf_light_direction for one ray (o, d) whose hit lies at t_hit
CRT_HD float pdf_light_direction(const CrtShadeArgs& a, const float o[3],
                                 const float d[3], float t_hit) {
  const int nl = a.n_lights;
  auto term = [&](int l) -> float {
    float e1[3], e2[3], corner[3], qn[3], rel[3], co[3], neg[3];
    load3(a.light_edge1, l, e1);
    load3(a.light_edge2, l, e2);
    load3(a.light_position, l, corner);
    cross3(e1, e2, qn);
    const float area = clamp_lo(norm3(qn), static_cast<float>(1e-12));
    for (int c = 0; c < 3; ++c) qn[c] = dvd(qn[c], area);
    const float denom = dot3(d, qn);
    const float safe =
        fabs_(denom) < static_cast<float>(1e-9) ? 1.0f : denom;
    for (int c = 0; c < 3; ++c) co[c] = sub(corner[c], o[c]);
    const float t_q = dvd(dot3(co, qn), safe);
    for (int c = 0; c < 3; ++c) rel[c] = sub(add(o[c], mul(d[c], t_q)), corner[c]);
    const float g11 = dot3(e1, e1), g12 = dot3(e1, e2), g22 = dot3(e2, e2);
    const float det = clamp_lo(sub(mul(g11, g22), mul(g12, g12)),
                               static_cast<float>(1e-20));
    const float r1 = dot3(rel, e1), r2 = dot3(rel, e2);
    const float u = dvd(sub(mul(g22, r1), mul(g12, r2)), det);
    const float v = dvd(sub(mul(g11, r2), mul(g12, r1)), det);
    for (int c = 0; c < 3; ++c) neg[c] = -d[c];
    const float cos_l = dot3(neg, qn);
    const float lo = static_cast<float>(-1e-4);
    const float hi = static_cast<float>(1.0 + 1e-4);
    const bool ok =
        a.light_kind[l] == kQuad && fabs_(denom) >= static_cast<float>(1e-9) &&
        t_q > 0.0f && u >= lo && u <= hi && v >= lo && v <= hi &&
        cos_l > static_cast<float>(1e-6) &&
        fabs_(sub(t_q, t_hit)) <=
            mul(static_cast<float>(1e-2),
                clamp_lo(t_hit, static_cast<float>(1e-6)));
    const float pq = dvd(mul(t_q, t_q), clamp_lo(mul(area, fabs_(cos_l)),
                                                 static_cast<float>(1e-12)));
    return ok ? pq : 0.0f;
  };
  return mul(aten_sum(nl, term), a.inv_n_lights);
}

// materials.bsdf_eval: f (S) and the pdf of the sampleable lobes
CRT_HD float bsdf_eval(const CrtShadeArgs& a, const Material& m,
                       const Surface& sf, const float wi[3],
                       const float t_lam[kS], const float eta[kS],
                       const float k[kS], float f[kS]) {
  const float cos_i = dot3(sf.n, wi);
  const bool same_hemi = (dot3(sf.n, sf.wo) > 0.0f) && (cos_i > 0.0f);
  const bool is_diffuse = (m.kind == kLambertian) && same_hemi;
  float pdf = 0.0f;
  if (is_diffuse) {
    albedo(m, t_lam, f);
    for (int s = 0; s < kS; ++s) f[s] = mul(f[s], kInvPiMul);
    pdf = mul(clamp_lo(cos_i, 0.0f), kInvPiMul);
  } else {
    for (int s = 0; s < kS; ++s) f[s] = 0.0f;
  }
  if (a.has_rough && m.kind == kRoughConductor) {
    float tint[kS], wo_l[3], wi_l[3];
    for (int s = 0; s < kS; ++s) tint[s] = sigmoid_poly(m.coeffs, t_lam[s]);
    to_local(sf.tb, sf.bb, sf.n, sf.wo, wo_l);
    to_local(sf.tb, sf.bb, sf.n, wi, wi_l);
    pdf = rough_conductor_fpdf(wo_l, wi_l, m.roughness, eta, k, tint, f);
  }
  return pdf;
}

// materials.bsdf_sample: wi, weight (S), pdf, is_specular, and whether the
// sample terminates the secondary wavelengths
struct BsdfSample {
  float wi[3];
  float w[kS];
  float pdf;
  bool is_spec, term;
};

CRT_HD void conductor_weight(const Material& m, const Surface& sf,
                             const float t_lam[kS], const float eta[kS],
                             const float k[kS], float w[kS]) {
  const float cos_i = fabs_(dot3(sf.n, sf.wo));
  for (int s = 0; s < kS; ++s) {
    w[s] = mul(fresnel_conductor(cos_i, eta[s], k[s]),
               sigmoid_poly(m.coeffs, t_lam[s]));
  }
}

CRT_HD void reflect(const Surface& sf, float out[3]) {
  const float two_dot = mul(2.0f, dot3(sf.wo, sf.n));
  for (int c = 0; c < 3; ++c) out[c] = add(-sf.wo[c], mul(two_dot, sf.n[c]));
}

CRT_HD void bsdf_sample(const CrtShadeArgs& a, const Material& m,
                        const Surface& sf, float u20, float u21, float u1,
                        const float t_lam[kS], const float eta[kS],
                        const float k[kS], BsdfSample& bs) {
  const int64_t kind = m.kind;
  bs.is_spec = (kind == kConductor) || (kind == kDielectric);
  bs.term = kind == kDielectric;
  bs.pdf = 1.0f;
  if (kind == kLambertian) {
    float wl[3];
    cosine_hemisphere(u20, u21, wl);
    to_world(sf.tb, sf.bb, sf.n, wl, bs.wi);
    albedo(m, t_lam, bs.w);
    bs.pdf = mul(clamp_lo(wl[2], static_cast<float>(1e-9)), kInvPiMul);
  } else if (kind == kConductor || (kind == kRoughConductor && !a.has_rough)) {
    reflect(sf, bs.wi);
    conductor_weight(m, sf, t_lam, eta, k, bs.w);
  } else if (kind == kRoughConductor) {
    float h[3], wo_l[3], wi_l[3], tint[kS], f[kS];
    ggx_sample_half(u20, u21, m.roughness, h);
    to_local(sf.tb, sf.bb, sf.n, sf.wo, wo_l);
    const float two_dot = mul(2.0f, dot3(wo_l, h));
    for (int c = 0; c < 3; ++c) wi_l[c] = sub(mul(two_dot, h[c]), wo_l[c]);
    to_world(sf.tb, sf.bb, sf.n, wi_l, bs.wi);
    for (int s = 0; s < kS; ++s) tint[s] = sigmoid_poly(m.coeffs, t_lam[s]);
    const float pdf = rough_conductor_fpdf(wo_l, wi_l, m.roughness, eta, k,
                                           tint, f);
    const float ratio = dvd(clamp_lo(wi_l[2], 0.0f),
                            clamp_lo(pdf, static_cast<float>(1e-12)));
    const bool ok = pdf > static_cast<float>(1e-12);
    for (int s = 0; s < kS; ++s) bs.w[s] = ok ? mul(f[s], ratio) : 0.0f;
    bs.pdf = pdf;
  } else {
    // the dielectric (and any other kind value, as the torch route picks)
    const float eta_hero = eta[0];
    const float eta_rel = sf.backface ? dvd(1.0f, eta_hero) : eta_hero;
    const float cos_i = fabs_(dot3(sf.n, sf.wo));
    const float fr = fresnel_dielectric(cos_i, eta_rel);
    bool refl = u1 < fr;
    // materials.refract(wo, n, eta_rel), then normalized
    const float ci = dot3(sf.wo, sf.n);
    const float sin2_t =
        dvd(clamp_lo(sub(1.0f, mul(ci, ci)), 0.0f), mul(eta_rel, eta_rel));
    const float cos_t = sqr(clamp_lo(sub(1.0f, sin2_t), 0.0f));
    const float coef = sub(dvd(ci, eta_rel), cos_t);
    float wt[3];
    for (int c = 0; c < 3; ++c) {
      wt[c] = add(dvd(-sf.wo[c], eta_rel), mul(coef, sf.n[c]));
    }
    const float wn = clamp_lo(norm3(wt), static_cast<float>(1e-9));
    for (int c = 0; c < 3; ++c) wt[c] = dvd(wt[c], wn);
    refl = refl || (sin2_t >= 1.0f);
    if (refl) {
      reflect(sf, bs.wi);
    } else {
      for (int c = 0; c < 3; ++c) bs.wi[c] = wt[c];
    }
    const float w = refl ? 1.0f : dvd(1.0f, mul(eta_rel, eta_rel));
    for (int s = 0; s < kS; ++s) bs.w[s] = w;
  }
}

// One lane of crt_shade_bounce.
CRT_HD void shade_lane(const CrtShadeArgs& a, int64_t i) {
  const int C = a.n_cols;
  const int nl = a.n_lights;
  const int nm = a.n_mats;
  const bool alive = a.alive[i] != 0;
  const bool valid = a.valid[i] != 0;
  const bool hit = valid && alive;
  const bool miss = alive && !valid;
  const bool specular = a.specular[i] != 0;
  const float pdf_prev = a.pdf_prev[i];
  const float* svals = a.svals + i * kS * C;

  float d[3], beta[kS], L[kS];
  load3(a.d, i, d);
  load8(a.beta, i, beta);
  load8(a.L, i, L);

  // the environment: lights.env_radiance under the mode's weight
  float env_add[kS];
  for (int s = 0; s < kS; ++s) env_add[s] = 0.0f;
  if (miss) {
    float w_env = 1.0f;
    if (a.mode == kMis) {
      if (!specular) {
        int n_amb = 0;
        for (int l = 0; l < nl; ++l) n_amb += a.light_kind[l] == kAmbient;
        float n_prev[3];
        load3(a.n_prev, i, n_prev);
        const float cos_p = clamp_lo(dot3(n_prev, d), 0.0f);
        const float pdf_amb = mul(
            mul(mul(static_cast<float>(n_amb), a.inv_n_lights), cos_p),
            a.inv_pi);
        w_env = power_heuristic(pdf_prev, pdf_amb);
      }
    } else if (a.mode == kSimple) {
      w_env = specular ? 1.0f : 0.0f;
    }
    for (int s = 0; s < kS; ++s) {
      float env = 0.0f;
      for (int l = 0; l < nl; ++l) {
        const float wl = a.light_kind[l] == kAmbient ? a.light_scale[l] : 0.0f;
        const float term = mul(svals[s * C + l], wl);
        env = l == 0 ? term : add(env, term);
      }
      env_add[s] = mul(mul(beta[s], env), w_env);
    }
  }
  for (int s = 0; s < kS; ++s) L[s] = add(L[s], env_add[s]);

  // spawn_eps
  float p[3];
  load3(a.p, i, p);
  const float t_hit = a.t[i];
  const float t_fin = isfinite_(t_hit) ? t_hit : 0.0f;
  const float mag = add(max_nan(max_nan(fabs_(p[0]), fabs_(p[1])), fabs_(p[2])),
                        fabs_(t_fin));
  const float eps = mul(a.ray_eps_scale,
                        clamp_lo(mag, static_cast<float>(1e-3)));

  if (!hit) {
    float o[3], n_prev[3];
    load3(a.o, i, o);
    load3(a.n_prev, i, n_prev);
    store3(a.o_out, i, o);
    store3(a.d_out, i, d);
    float lam_pdf[kS], zero[kS];
    load8(a.lam_pdf, i, lam_pdf);
    for (int s = 0; s < kS; ++s) {
      L[s] = add(L[s], 0.0f);
      zero[s] = 0.0f;
    }
    store8(a.beta_out, i, zero);
    store8(a.L_out, i, L);
    store8(a.lam_pdf_out, i, lam_pdf);
    if (a.mode != kWalk) store8(a.nee, i, zero);
    a.alive_out[i] = 0;
    a.specular_out[i] = specular;
    a.pdf_prev_out[i] = pdf_prev;
    store3(a.n_prev_out, i, n_prev);
    if (a.mode != kWalk) {
      store3(a.shadow_o, i, p);
      store3(a.shadow_d, i, d);
      a.shadow_t[i] = sub(mul(-1.0f, static_cast<float>(1.0 - 1e-3)), eps);
    }
    return;
  }

  // the surface and its material (MaterialView.create, _cache_select)
  Surface sf;
  for (int c = 0; c < 3; ++c) sf.p[c] = p[c];
  load3(a.n, i, sf.n);
  load3(a.wo, i, sf.wo);
  sf.backface = a.backface[i] != 0;
  build_frame(sf.n, sf.tb, sf.bb);
  int64_t mid = a.mid[i];
  mid = mid < 0 ? 0 : (mid > nm - 1 ? nm - 1 : mid);
  Material m;
  m.kind = a.mat_kind[mid];
  for (int c = 0; c < 3; ++c) m.coeffs[c] = a.mat_coeffs[3 * mid + c];
  m.use_texture = a.mat_use_texture[mid] != 0;
  m.roughness = a.mat_roughness[mid];
  m.has_tex = a.texture != nullptr;
  if (m.has_tex) {
    float uv[2] = {a.uv[2 * i], a.uv[2 * i + 1]};
    texture_lookup(a.texture, a.tex_w, a.tex_h, uv, m.tex);
  }
  float t_lam[kS], eta[kS], k[kS];
  load8(a.lam, i, t_lam);
  for (int s = 0; s < kS; ++s) {
    t_lam[s] = lam_norm(t_lam[s], a.inv_lam_range);
    eta[s] = svals[s * C + nl + nm + mid];
    k[s] = svals[s * C + nl + 2 * nm + mid];
  }

  // emission, one-sided, under the mode's weight
  {
    float w_emit = 1.0f;
    bool count = true;
    if (a.mode == kMis) {
      if (!specular) {
        float o[3];
        load3(a.o, i, o);
        w_emit = power_heuristic(pdf_prev, pdf_light_direction(a, o, d, t_hit));
      }
    } else if (a.mode == kSimple) {
      count = specular;
    }
    for (int s = 0; s < kS; ++s) {
      const float emit = sf.backface ? 0.0f : svals[s * C + nl + mid];
      const float contrib = mul(mul(beta[s], emit), w_emit);
      L[s] = add(L[s], count ? contrib : 0.0f);
    }
  }

  // next-event estimation: the shadow ray and the pending term
  if (a.mode != kWalk) {
    LightSample ls;
    sample_light(a, sf, svals, C, a.u_sel[i], a.u_pos[2 * i], a.u_pos[2 * i + 1],
                 ls);
    float f[kS];
    const float pdf_b = bsdf_eval(a, m, sf, ls.wi, t_lam, eta, k, f);
    const float cos_l = clamp_lo(dot3(ls.wi, sf.n), 0.0f);
    const float ratio = dvd(cos_l, clamp_lo(ls.pdf, static_cast<float>(1e-12)));
    float w_l = 1.0f;
    if (a.mode == kMis && (ls.kind == kQuad || ls.kind == kAmbient)) {
      w_l = power_heuristic(ls.pdf, pdf_b);
    }
    for (int s = 0; s < kS; ++s) {
      f[s] = mul(mul(mul(beta[s], f[s]), ls.li[s]), ratio);
      if (a.mode == kMis) f[s] = mul(f[s], w_l);
    }
    store8(a.nee, i, f);
    const float side = mul(sign_(dot3(ls.wi, sf.n)), eps);
    float so[3];
    for (int c = 0; c < 3; ++c) so[c] = add(sf.p[c], mul(sf.n[c], side));
    store3(a.shadow_o, i, so);
    store3(a.shadow_d, i, ls.wi);
    a.shadow_t[i] =
        sub(mul(ls.dist, static_cast<float>(1.0 - 1e-3)), eps);
  }

  // BSDF sampling, the dispersion collapse and Russian roulette
  BsdfSample bs;
  bsdf_sample(a, m, sf, a.u2[2 * i], a.u2[2 * i + 1], a.u1[i], t_lam, eta, k,
              bs);
  float beta_new[kS], lam_pdf[kS];
  load8(a.lam_pdf, i, lam_pdf);
  bool done = true;
  for (int s = 0; s < kS; ++s) {
    beta_new[s] = mul(beta[s], bs.w[s]);
    if (s > 0) done = done && lam_pdf[s] == 0.0f;
  }
  if (bs.term && !done) {
    lam_pdf[0] = mul(lam_pdf[0], a.inv_s);
    for (int s = 1; s < kS; ++s) {
      lam_pdf[s] = 0.0f;
      beta_new[s] = 0.0f;
    }
  }
  float max_beta = beta_new[0];
  for (int s = 1; s < kS; ++s) max_beta = max_nan(max_beta, beta_new[s]);
  bool survive = true;
  if (a.roulette) {
    const float q = clamp2(max_beta, static_cast<float>(0.05), 1.0f);
    survive = a.u_rr[i] < q;
    for (int s = 0; s < kS; ++s) beta_new[s] = dvd(beta_new[s], q);
  }
  const bool alive_new = survive && (max_beta > 0.0f);
  const float side = mul(sign_(dot3(bs.wi, sf.n)), eps);
  float o_new[3];
  for (int c = 0; c < 3; ++c) o_new[c] = add(sf.p[c], mul(sf.n[c], side));
  store3(a.o_out, i, o_new);
  store3(a.d_out, i, bs.wi);
  for (int s = 0; s < kS; ++s) beta_new[s] = alive_new ? beta_new[s] : 0.0f;
  store8(a.beta_out, i, beta_new);
  store8(a.L_out, i, L);
  store8(a.lam_pdf_out, i, lam_pdf);
  a.alive_out[i] = alive_new;
  a.specular_out[i] = bs.is_spec;
  a.pdf_prev_out[i] = bs.pdf;
  store3(a.n_prev_out, i, sf.n);
}

// One element j (lane j / kS) of crt_shade_resolve: L += nee where the
// lane's shadow ray is clear.
CRT_HD void resolve_element(float* L, const float* nee, const uint8_t* occ,
                            int64_t j) {
  L[j] = add(L[j], occ[j / kS] == 0 ? nee[j] : 0.0f);
}

}  // namespace crt_shade
