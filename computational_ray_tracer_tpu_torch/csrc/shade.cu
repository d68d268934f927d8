// The bounce step's shading for NVIDIA Hopper (sm_90a): one launch a bounce
// after the closest hit, and one after the any-hit launch.
//
// Replaces: no Pallas kernel. The JAX package shades with jnp operations in
//   computational_ray_tracer_tpu/models/integrator.py _bounce_step, which
//   XLA fuses; the port's torch route (models/integrator.py _bounce_step,
//   models/materials.py, models/lights.py) runs them as ~600 ATen kernels a
//   bounce, each streaming (lanes, 8) float32 tensors through memory.
//
// What it computes, for each lane (csrc/shade.cuh shade_lane, one thread a
//   lane, the 8 wavelengths in registers), from the surface record of
//   scene_surface, the path state and the bounce's sampler draws, bit for
//   bit with the torch route on the card:
//   - the environment and the emission terms under the mode's weights
//     (mis: the power heuristic against pdf_ambient_direction /
//     pdf_light_direction; simple; walk);
//   - sample_light for the point, distant, quad and ambient kinds;
//   - bsdf_eval and bsdf_sample for the Lambertian, conductor, rough GGX
//     conductor and dielectric kinds, the texture's bilinear coefficients,
//     the dispersion collapse;
//   - Russian roulette and the next ray;
//   and writes the next state, the shadow ray (scene_occluded's offset
//   origin, its direction, its t_max) and the pending NEE term with its MIS
//   weight. crt_shade_resolve then adds that term to L where the any-hit
//   launch found the shadow ray clear.
//
// What bounds it on the H100: bytes. A lane reads about 0.5-0.7 KB (the
//   state, the surface record, the draws and its row of the spectral cache)
//   and writes about 0.25 KB; its arithmetic, a few hundred operations and a
//   few transcendentals, is small beside that at 3.35 TB/s.
//
// What the design does about it: one pass over the lanes; lanes without a
//   hit (dead or escaped) read and write only what they pass on; no shared
//   memory, no atomics, every intermediate in registers. The resolve runs
//   one thread a float of L, so its loads and stores coalesce.

#include <cstdint>

#include <cuda_runtime.h>

#include "shade.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    shade_kernel(const CrtShadeArgs a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.n_lanes) return;
  crt_shade::shade_lane(a, i);
}

// One thread a float of L, so that the warp's loads and stores coalesce.
__global__ void __launch_bounds__(256)
    resolve_kernel(float* L, const float* nee, const uint8_t* occ,
                   int64_t total) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (j >= total) return;
  crt_shade::resolve_element(L, nee, occ, j);
}

}  // namespace

extern "C" int crt_shade_bounce(const CrtShadeArgs* args, void* stream) {
  if (args == nullptr || args->n_lanes < 0 || args->n_lights < 1 ||
      args->n_lights > crt_shade::kMaxLights || args->n_mats < 1 ||
      args->n_cols != args->n_lights + 3 * args->n_mats || args->mode < 0 ||
      args->mode > crt_shade::kWalk ||
      (args->texture != nullptr && (args->tex_w < 2 || args->tex_h < 2))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (args->n_lanes == 0) return 0;
  const dim3 grid(static_cast<unsigned>(
      (static_cast<long long>(args->n_lanes) + kThreads - 1) / kThreads));
  shade_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int crt_shade_resolve(float* L, const float* nee,
                                 const uint8_t* occ, int n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int64_t total = static_cast<int64_t>(n) * crt_shade::kS;
  const dim3 grid(static_cast<unsigned>((total + 255) / 256));
  resolve_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      L, nee, occ, total);
  return static_cast<int>(cudaGetLastError());
}
