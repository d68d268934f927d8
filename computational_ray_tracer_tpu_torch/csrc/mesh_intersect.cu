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
// What bounds it on the H100: 175 fp32 operations per ray-triangle pair
//   (PAIR_FLOPS in ops/mesh_intersect_kernel.py) against 40 bytes of
//   triangle data that every ray of a block shares, so the kernel is
//   compute-bound in fp32 (67 TFLOP/s outside the tensor cores); device
//   memory sees one read of each ray and one write of each result.
//
// What the design does about it: one thread per ray, 256 rays per block,
//   and the block walks all triangles in tiles of 256 staged through shared
//   memory as SoA (9 vertex floats + the mask, 10 KB per tile). Every thread
//   reads the same shared word at a time, which is a broadcast, so there are
//   no bank conflicts, and the only per-pair work is arithmetic. The TPU
//   kernel's sequential triangle grid axis with an output-resident running
//   best becomes the per-thread loop; nothing crosses blocks.
//
// Numerics: the per-pair test is watertight.cuh's, written with __fmul_rn/
//   __fadd_rn/__fsub_rn/__fdiv_rn, which nvcc never contracts into FMA, in
//   exactly the operation order of the plain PyTorch version
//   (mesh_intersect_kernel.watertight), so the two agree bit for bit. The
//   Dekker split uses 4097 (2^12 + 1), the float32 factor of ops/shapes.py,
//   not the 0x10001 of the TPU kernel. Each
//   triangle's hit is decided against the ray's own t_max; the winner is
//   the smallest t with a strict '<', so the lowest index wins exact ties.

#include "watertight.cuh"

namespace {

using namespace crt;

constexpr int kThreads = 256;
constexpr int kTile = 256;

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

  const Ray ray = make_ray(o[3 * r], o[3 * r + 1], o[3 * r + 2], d[3 * r],
                           d[3 * r + 1], d[3 * r + 2]);
  const float tm = tmax[r];

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
      float v[9];
#pragma unroll
      for (int c = 0; c < 9; ++c) v[c] = s_tri[c][k];
      float t, b1, b2;
      const bool hit = watertight(ray, tm, v, t, b1, b2);
      if (hit && t < best_t) {
        best_t = t;
        best_i = base + k;
        best_b1 = b1;
        best_b2 = b2;
      }
    }
  }
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
