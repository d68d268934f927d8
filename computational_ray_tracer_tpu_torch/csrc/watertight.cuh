// The watertight ray/triangle test shared by the port's CUDA kernels
// (mesh_intersect.cu, octree_traverse.cu).
//
// Every rounding is spelled with __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn,
// which nvcc never contracts into FMA, in exactly the operation order of
// the plain PyTorch version (ops/mesh_intersect_kernel.py: ray_shear and
// watertight), so kernels and plain version agree bit for bit. The Dekker
// split uses 4097 (2^12 + 1), the float32 factor of ops/shapes.py.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace crt {

constexpr double kEps = 5.9604644775390625e-08;  // 2^-24
constexpr float gamma_f(int n) {
  return static_cast<float>((n * kEps) / (1.0 - n * kEps));
}
// gamma(n) bounds, rounded to float32 as the plain version's constants are.
constexpr float kG2 = gamma_f(2), kG3 = gamma_f(3), kG5 = gamma_f(5);

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float fmax3(float a, float b, float c) {
  return fmaxf(fmaxf(a, b), c);
}

// A ray's origin and its shear: kz is the first axis of largest |d|,
// (kx, ky) follow it cyclically.
struct Ray {
  float ox, oy, oz;
  bool kz_x, kz_y;
  float inv_dz, sx, sy;
};

__device__ __forceinline__ void perm(const Ray& r, float vx, float vy, float vz,
                                     float& px, float& py, float& pz) {
  pz = r.kz_x ? vx : (r.kz_y ? vy : vz);
  px = r.kz_x ? vy : (r.kz_y ? vz : vx);
  py = r.kz_x ? vz : (r.kz_y ? vx : vy);
}

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  Ray r;
  r.ox = ox;
  r.oy = oy;
  r.oz = oz;
  const float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
  r.kz_x = (adx >= ady) && (adx >= adz);
  r.kz_y = (!r.kz_x) && (ady >= adz);
  float dxp, dyp, dzp;
  perm(r, dx, dy, dz, dxp, dyp, dzp);
  r.inv_dz = __fdiv_rn(1.0f, dzp);
  r.sx = mul(-dxp, r.inv_dz);
  r.sy = mul(-dyp, r.inv_dz);
  return r;
}

// The watertight test in three stages, so that a kernel can stop early
// (mesh_intersect.cu): edge_stage translates, shears and computes the edge
// functions (the sign test, the bulk of the work); range_stage the
// determinant, the scaled z and t_scaled (the range test); hit_stage the
// division, t, its error bound and the barycentrics. Each stage does the
// float32 operations of the one-piece test in its order, so stopping after
// a failed stage changes no value that is read. A Pair holds what the
// later stages read.
struct Pair {
  float ax, ay, bx, by, cx, cy;  // sheared x and y of the three vertices
  float az, bz, cz;              // permuted z; scaled by inv_dz in range_stage
  float e0, e1, e2;              // edge functions
  float det, t_scaled;           // set by range_stage
};

// Dekker halves of a: hi + lo == a exactly.
struct Split {
  float hi, lo;
};

__device__ __forceinline__ Split split(float a) {
  const float ca = mul(a, 4097.0f);
  const float hi = sub(ca, sub(ca, a));
  return {hi, sub(a, hi)};
}

// two_prod_err and dop from precomputed splits (each sheared coordinate
// takes part in two edge functions; splitting it once gives the same bits).
__device__ __forceinline__ float two_prod_err(Split a, Split b, float ab) {
  return add(add(add(sub(mul(a.hi, b.hi), ab), mul(a.hi, b.lo)),
                 mul(a.lo, b.hi)),
             mul(a.lo, b.lo));
}

__device__ __forceinline__ float dop(float a, Split sa, float b, Split sb,
                                     float c, Split sc, float d, Split sd) {
  const float ab = mul(a, b);
  const float cd = mul(c, d);
  return add(sub(ab, cd), sub(two_prod_err(sa, sb, ab),
                              two_prod_err(sc, sd, cd)));
}

// a*b - c*d with exact-product correction, each factor split here.
__device__ __forceinline__ float dop(float a, float b, float c, float d) {
  return dop(a, split(a), b, split(b), c, split(c), d, split(d));
}

// Stage 1 from the vertices already permuted and translated to the ray's
// origin: (axp, ayp, azp) = perm(p0 - o), and so on. True when the three
// edge functions share a sign.
__device__ __forceinline__ bool edge_stage(const Ray& r, float axp, float ayp,
                                           float azp, float bxp, float byp,
                                           float bzp, float cxp, float cyp,
                                           float czp, Pair& p) {
  p.ax = add(axp, mul(r.sx, azp));
  p.ay = add(ayp, mul(r.sy, azp));
  p.bx = add(bxp, mul(r.sx, bzp));
  p.by = add(byp, mul(r.sy, bzp));
  p.cx = add(cxp, mul(r.sx, czp));
  p.cy = add(cyp, mul(r.sy, czp));
  p.az = azp;
  p.bz = bzp;
  p.cz = czp;
  const Split sax = split(p.ax), say = split(p.ay), sbx = split(p.bx),
              sby = split(p.by), scx = split(p.cx), scy = split(p.cy);
  p.e0 = dop(p.bx, sbx, p.cy, scy, p.by, sby, p.cx, scx);
  p.e1 = dop(p.cx, scx, p.ay, say, p.cy, scy, p.ax, sax);
  p.e2 = dop(p.ax, sax, p.by, sby, p.ay, say, p.bx, sbx);
  return (p.e0 >= 0.0f && p.e1 >= 0.0f && p.e2 >= 0.0f) ||
         (p.e0 <= 0.0f && p.e1 <= 0.0f && p.e2 <= 0.0f);
}

// Stage 2: a nonzero determinant and 0 < t < tm in the scaled domain.
__device__ __forceinline__ bool range_stage(const Ray& r, float tm, Pair& p) {
  p.det = add(add(p.e0, p.e1), p.e2);
  p.az = mul(r.inv_dz, p.az);
  p.bz = mul(r.inv_dz, p.bz);
  p.cz = mul(r.inv_dz, p.cz);
  p.t_scaled = add(add(mul(p.e0, p.az), mul(p.e1, p.bz)), mul(p.e2, p.cz));
  const float ts = p.det < 0.0f ? -p.t_scaled : p.t_scaled;
  return p.det != 0.0f && ts > 0.0f && ts < mul(tm, fabsf(p.det));
}

// Stage 3: t, b1 = e1/det, b2 = e2/det, and whether t clears its
// conservative error bound.
__device__ __forceinline__ bool hit_stage(const Pair& p, float& t, float& b1,
                                          float& b2) {
  const float inv_det = __fdiv_rn(1.0f, p.det != 0.0f ? p.det : 1.0f);
  t = mul(p.t_scaled, inv_det);

  const float max_z = fmax3(fabsf(p.az), fabsf(p.bz), fabsf(p.cz));
  const float delta_z = mul(kG3, max_z);
  const float max_x = fmax3(fabsf(p.ax), fabsf(p.bx), fabsf(p.cx));
  const float max_y = fmax3(fabsf(p.ay), fabsf(p.by), fabsf(p.cy));
  const float delta_x = mul(kG5, add(max_x, max_z));
  const float delta_y = mul(kG5, add(max_y, max_z));
  const float delta_e =
      mul(2.0f, add(add(mul(mul(kG2, max_x), max_y), mul(delta_y, max_x)),
                    mul(delta_x, max_y)));
  const float max_e = fmax3(fabsf(p.e0), fabsf(p.e1), fabsf(p.e2));
  const float delta_t =
      mul(mul(3.0f, add(add(mul(mul(kG3, max_e), max_z), mul(delta_e, max_z)),
                        mul(delta_z, max_e))),
          fabsf(inv_det));

  b1 = mul(p.e1, inv_det);
  b2 = mul(p.e2, inv_det);
  return t > delta_t;
}

// Does the ray hit triangle v = (p0 xyz, p1 xyz, p2 xyz) in (0, tm)? On a
// hit, t is the distance and (b1, b2) = (e1, e2) / det the barycentrics.
// The one-piece test of the octree kernel (the same operations as the
// three stages, every one computed): on an H100 the octree kernel ran 1-6%
// slower built from the stages than from this form.
__device__ __forceinline__ bool watertight(const Ray& r, float tm,
                                           const float v[9], float& t,
                                           float& b1, float& b2) {
  float axp, ayp, azp, bxp, byp, bzp, cxp, cyp, czp;
  perm(r, sub(v[0], r.ox), sub(v[1], r.oy), sub(v[2], r.oz), axp, ayp, azp);
  perm(r, sub(v[3], r.ox), sub(v[4], r.oy), sub(v[5], r.oz), bxp, byp, bzp);
  perm(r, sub(v[6], r.ox), sub(v[7], r.oy), sub(v[8], r.oz), cxp, cyp, czp);
  const float ax = add(axp, mul(r.sx, azp)), ay = add(ayp, mul(r.sy, azp));
  const float bx = add(bxp, mul(r.sx, bzp)), by = add(byp, mul(r.sy, bzp));
  const float cx = add(cxp, mul(r.sx, czp)), cy = add(cyp, mul(r.sy, czp));

  const float e0 = dop(bx, cy, by, cx);
  const float e1 = dop(cx, ay, cy, ax);
  const float e2 = dop(ax, by, ay, bx);
  const bool same_side = (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) ||
                         (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f);
  const float det = add(add(e0, e1), e2);
  const bool nonzero = det != 0.0f;

  const float az = mul(r.inv_dz, azp), bz = mul(r.inv_dz, bzp),
              cz = mul(r.inv_dz, czp);
  const float t_scaled = add(add(mul(e0, az), mul(e1, bz)), mul(e2, cz));
  const float ts = det < 0.0f ? -t_scaled : t_scaled;
  const bool in_range = (ts > 0.0f) && (ts < mul(tm, fabsf(det)));

  const float inv_det = __fdiv_rn(1.0f, nonzero ? det : 1.0f);
  t = mul(t_scaled, inv_det);

  // conservative error bound on t
  const float max_z = fmax3(fabsf(az), fabsf(bz), fabsf(cz));
  const float delta_z = mul(kG3, max_z);
  const float max_x = fmax3(fabsf(ax), fabsf(bx), fabsf(cx));
  const float max_y = fmax3(fabsf(ay), fabsf(by), fabsf(cy));
  const float delta_x = mul(kG5, add(max_x, max_z));
  const float delta_y = mul(kG5, add(max_y, max_z));
  const float delta_e =
      mul(2.0f, add(add(mul(mul(kG2, max_x), max_y), mul(delta_y, max_x)),
                    mul(delta_x, max_y)));
  const float max_e = fmax3(fabsf(e0), fabsf(e1), fabsf(e2));
  const float delta_t =
      mul(mul(3.0f, add(add(mul(mul(kG3, max_e), max_z), mul(delta_e, max_z)),
                        mul(delta_z, max_e))),
          fabsf(inv_det));

  b1 = mul(e1, inv_det);
  b2 = mul(e2, inv_det);
  return same_side && nonzero && in_range && (t > delta_t);
}

}  // namespace crt
