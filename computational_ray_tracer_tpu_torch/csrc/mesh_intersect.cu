// Brute-force watertight ray/triangle closest hit for NVIDIA Hopper (sm_90a).
//
// Replaces: computational_ray_tracer_tpu/ops/pallas_intersect.py
//   _intersect_kernel (launched by _mesh_intersect_impl, wrapped by
//   mesh_intersect_pallas). It computes, for every ray, the closest hit
//   against every triangle with the watertight test (translate, permute to
//   the dominant axis, shear, DifferenceOfProducts edge functions, a
//   gamma-bounded t), and returns t (+inf on a miss), the triangle id (-1 on
//   a miss) and the barycentrics b1 = e1/det, b2 = e2/det at the winner.
//
// What bounds it on the H100: about 140 fp32 operations per ray-triangle
//   pair against 40 bytes of triangle data that every ray of a block
//   shares, so the kernel is compute-bound in fp32 (67 TFLOP/s outside the
//   tensor cores); device memory sees one read of each ray and one write
//   of each result.
//
// What the design does about it: one thread per ray, 256 rays per block,
//   and the block walks all triangles in tiles of 256 staged through shared
//   memory as SoA (9 vertex floats + the mask, 10 KB per tile). Every thread
//   reads the same shared word at a time, which is a broadcast, so there are
//   no bank conflicts, and the only per-pair work is arithmetic. The TPU
//   kernel's sequential triangle grid axis with an output-resident running
//   best becomes the per-thread loop; nothing crosses blocks.
//
// Numerics: the arithmetic is written with __fmul_rn/__fadd_rn/__fsub_rn/
//   __fdiv_rn, which nvcc never contracts into FMA, in exactly the operation
//   order of the plain PyTorch version (mesh_intersect_kernel.py), so the two
//   agree bit for bit. The Dekker split uses 4097 (2^12 + 1), the float32
//   factor of ops/shapes.py, not the 0x10001 of the TPU kernel. Each
//   triangle's hit is decided against the ray's own t_max; the winner is
//   the smallest t with a strict '<', so the lowest index wins exact ties.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;
constexpr double kEps = 5.9604644775390625e-08;  // 2^-24
constexpr float gamma_f(int n) {
  return static_cast<float>((n * kEps) / (1.0 - n * kEps));
}
// gamma(n) bounds, rounded to float32 as the plain version's constants are.
constexpr float kG2 = gamma_f(2), kG3 = gamma_f(3), kG5 = gamma_f(5);

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// Error of the rounded product ab = fl(a*b) by Dekker splitting.
__device__ __forceinline__ float two_prod_err(float a, float b, float ab) {
  const float ca = mul(a, 4097.0f);
  const float a_hi = sub(ca, sub(ca, a));
  const float a_lo = sub(a, a_hi);
  const float cb = mul(b, 4097.0f);
  const float b_hi = sub(cb, sub(cb, b));
  const float b_lo = sub(b, b_hi);
  return add(add(add(sub(mul(a_hi, b_hi), ab), mul(a_hi, b_lo)),
                 mul(a_lo, b_hi)),
             mul(a_lo, b_lo));
}

// a*b - c*d with exact-product correction.
__device__ __forceinline__ float dop(float a, float b, float c, float d) {
  const float ab = mul(a, b);
  const float cd = mul(c, d);
  return add(sub(ab, cd), sub(two_prod_err(a, b, ab), two_prod_err(c, d, cd)));
}

__device__ __forceinline__ float fmax3(float a, float b, float c) {
  return fmaxf(fmaxf(a, b), c);
}

__global__ void __launch_bounds__(kThreads)
mesh_intersect_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ tmax,
                      const float* __restrict__ tris,
                      const float* __restrict__ mask, int n, int f,
                      float* __restrict__ t_out, int* __restrict__ idx_out,
                      float* __restrict__ b1_out, float* __restrict__ b2_out) {
  __shared__ float s_tri[10][kTile];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n;
  const int r = active ? i : 0;

  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float tm = tmax[r];

  // Branch-free axis permutation: kz = argmax |d|, (kx, ky) cyclic.
  const float adx = fabsf(dx), ady = fabsf(dy), adz = fabsf(dz);
  const bool kz_x = (adx >= ady) && (adx >= adz);
  const bool kz_y = (!kz_x) && (ady >= adz);
#define CRT_PERM(vx, vy, vz, px, py, pz)                 \
  const float pz = kz_x ? (vx) : (kz_y ? (vy) : (vz));   \
  const float px = kz_x ? (vy) : (kz_y ? (vz) : (vx));   \
  const float py = kz_x ? (vz) : (kz_y ? (vx) : (vy));
  CRT_PERM(dx, dy, dz, dxp, dyp, dzp)
  const float inv_dz = __fdiv_rn(1.0f, dzp);
  const float sx = mul(-dxp, inv_dz);
  const float sy = mul(-dyp, inv_dz);

  float best_t = CUDART_INF_F;
  int best_i = -1;
  float best_b1 = 0.0f, best_b2 = 0.0f;

  for (int base = 0; base < f; base += kTile) {
    __syncthreads();
    for (int k = threadIdx.x; k < kTile; k += kThreads) {
      const int j = base + k;
      if (j < f) {
#pragma unroll
        for (int c = 0; c < 9; ++c) s_tri[c][k] = tris[c * f + j];
        s_tri[9][k] = mask ? mask[j] : 1.0f;
      }
    }
    __syncthreads();
    if (!active) continue;
    const int cnt = min(kTile, f - base);
    for (int k = 0; k < cnt; ++k) {
      if (!(s_tri[9][k] > 0.0f)) continue;
      // translate, permute, shear each vertex
      const float v0x = sub(s_tri[0][k], ox), v0y = sub(s_tri[1][k], oy),
                  v0z = sub(s_tri[2][k], oz);
      const float v1x = sub(s_tri[3][k], ox), v1y = sub(s_tri[4][k], oy),
                  v1z = sub(s_tri[5][k], oz);
      const float v2x = sub(s_tri[6][k], ox), v2y = sub(s_tri[7][k], oy),
                  v2z = sub(s_tri[8][k], oz);
      CRT_PERM(v0x, v0y, v0z, axp, ayp, azp)
      CRT_PERM(v1x, v1y, v1z, bxp, byp, bzp)
      CRT_PERM(v2x, v2y, v2z, cxp, cyp, czp)
      const float ax = add(axp, mul(sx, azp)), ay = add(ayp, mul(sy, azp));
      const float bx = add(bxp, mul(sx, bzp)), by = add(byp, mul(sy, bzp));
      const float cx = add(cxp, mul(sx, czp)), cy = add(cyp, mul(sy, czp));

      const float e0 = dop(bx, cy, by, cx);
      const float e1 = dop(cx, ay, cy, ax);
      const float e2 = dop(ax, by, ay, bx);
      const bool same_side = (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) ||
                             (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f);
      const float det = add(add(e0, e1), e2);
      const bool nonzero = det != 0.0f;

      const float az = mul(inv_dz, azp), bz = mul(inv_dz, bzp),
                  cz = mul(inv_dz, czp);
      const float t_scaled = add(add(mul(e0, az), mul(e1, bz)), mul(e2, cz));
      const float ts = det < 0.0f ? -t_scaled : t_scaled;
      const bool in_range = (ts > 0.0f) && (ts < mul(tm, fabsf(det)));

      const float inv_det = __fdiv_rn(1.0f, nonzero ? det : 1.0f);
      const float t = mul(t_scaled, inv_det);

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

      const bool hit = same_side && nonzero && in_range && (t > delta_t);
      if (hit && t < best_t) {
        best_t = t;
        best_i = base + k;
        best_b1 = mul(e1, inv_det);
        best_b2 = mul(e2, inv_det);
      }
    }
  }
#undef CRT_PERM
  if (active) {
    t_out[i] = best_t;
    idx_out[i] = best_i;
    b1_out[i] = best_b1;
    b2_out[i] = best_b2;
  }
}

}  // namespace

// C interface, bound with ctypes. Pointers are device pointers; `mask` may
// be null (every triangle enabled). Launches on `stream` and returns
// cudaGetLastError() of the launch (0 on success). Does not synchronise.
extern "C" int crt_mesh_intersect(const float* o, const float* d,
                                  const float* tmax, const float* tris,
                                  const float* mask, int n, int f,
                                  float* t_out, int* idx_out, float* b1_out,
                                  float* b2_out, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  mesh_intersect_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      o, d, tmax, tris, mask, n, f, t_out, idx_out, b1_out, b2_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* crt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
