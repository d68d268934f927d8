// The per-pixel sampler draws for NVIDIA Hopper (sm_90a): one launch a draw.
//
// Replaces: no Pallas kernel. The JAX package draws with jnp operations in
//   computational_ray_tracer_tpu/ops/rng.py, and the port's plain version,
//   ops/rng.py, does the same with PyTorch int64 tensors: every 32-bit word
//   in an int64, every multiply split into 16-bit halves, a (lanes, 32)
//   int64 tensor a Sobol' dimension, and a masked step over the whole
//   wavefront for each of the (w + 1) - n cycle-walk steps. A draw is then
//   250 to 1,200 elementwise kernels; this kernel is one.
//
// What it computes, for each lane r: the draw of pixel id pixel[r] at the
//   sample index and under the seed (one value each for every lane, read
//   from a 0-d device tensor or given by the host) in dimension dim, as
//   float32 (n,) for a 1D draw or (n, 2) for a 2D draw, for the kinds
//   independent, stratified (jittered or centred) and sobol (Owen-scrambled,
//   padded per pixel, the index shuffled by a permutation of [0, spp)), bit
//   for bit with ops/rng.py:
//   - mix_bits, hash_u32 and _mul are uint32 multiplies, shifts and XORs;
//   - permutation_element is Kensler's cycle walk as a per-lane loop of at
//     most (w + 1) - n steps that stops once x < n: the plain version's
//     masked steps leave such an x as it is, so the two agree for every
//     index, one >= n included (the plain version's documented result);
//   - sobol_sample_u32 XORs the 32 direction numbers of the dimension,
//     predicated on the index bits; they travel as a kernel parameter, so
//     every lane reads the same constant-bank word;
//   - fast_owen_scramble and _reverse_bits32 are __brev and the same four
//     multiply-XOR steps;
//   - u32_to_float is (bits >> 8) to float times 2^-24 (exact), and the
//     stratified (stratum + delta) / spp is __fadd_rn then __fmul_rn by the
//     float32 reciprocal the host computed: PyTorch's CUDA division of a
//     float32 tensor by a Python number multiplies by 1 / number rounded to
//     float32, so this is the plain version's rounding on the card. The
//     library is built with -fmad=false and nothing here is contracted.
//   Dimensions >= 72 read the table at dim % 72 while the scramble stays
//   keyed on the unwrapped dim, as the plain version.
//
// What bounds it on the H100: 32-bit integer operations. A lane does about
//   230 of them for a 1D Sobol' draw, about 380 for a 2D one and 130-170
//   plus 32 a cycle-walk step for a stratified draw, and moves 12-16 bytes
//   (an int64 pixel id in, one or two floats out). At 262,144 lanes that is
//   ~6e7-1e8 operations, a few microseconds at the card's int32 rate, against
//   ~1 us of bytes at 3.35 TB/s.
//
// What the design does about it: one pass over the lanes, one thread a lane,
//   every intermediate in registers, no shared memory. A 2D draw computes
//   what its two dimensions share once: the hash prefix, the shuffled index
//   or the stratum. Everything else uniform across lanes (the permutation's
//   mask and walk length, the reciprocals, the direction numbers) is
//   computed on the host and passed by value. The seed, like the sample
//   index, is given by the host or read from a 0-d device tensor (a captured
//   pass kept across frames, each with its own seed); every lane hashes it,
//   one hash word against the ~230 of a draw.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

enum Kind : int { kIndependent = 0, kStratified = 1, kSobol = 2 };

}  // namespace

// The draw's uniform parameters, filled by the wrapper (ops/rng_kernel.py,
// SamplerParams): the same layout on both sides.
struct CrtSamplerParams {
  uint32_t seed;       // seed & 0xFFFFFFFF (unread with a device seed)
  uint32_t dim0;       // dim & 0xFFFFFFFF
  uint32_t dim1;       // (dim + 1) & 0xFFFFFFFF
  uint32_t n;          // the permutation's size: spp, or xs * ys (2D strata)
  uint32_t w;          // the next power of two above n - 1, less one
  uint32_t walk;       // (w + 1) - n if n is not a power of two, else 0
  uint32_t xs;         // strata along x (2D stratified)
  uint32_t jitter;     // 0: the stratum's centre
  float scale0;        // float32 1 / spp, or 1 / xs (2D)
  float scale1;        // float32 1 / ys (2D)
  uint32_t sobol[2][32];  // direction numbers of dims dim0 % 72, dim1 % 72
};

namespace {

__device__ __forceinline__ uint32_t mix_bits(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

// One more word of hash_u32: hash_u32(..., a) from hash_u32(...).
__device__ __forceinline__ uint32_t hash_step(uint32_t h, uint32_t a) {
  return mix_bits(h ^ (a * 0x01000193u));
}

// hash_u32's initial word: hash_u32(a) is hash_step(kHashInit, a).
constexpr uint32_t kHashInit = 0x9E3779B9u;

__device__ __forceinline__ float u32_to_float(uint32_t bits) {
  return __fmul_rn(__uint2float_rn(bits >> 8), 5.9604644775390625e-08f);
}

__device__ __forceinline__ uint32_t scramble_round(uint32_t x, uint32_t w,
                                                   uint32_t k0, uint32_t k1,
                                                   uint32_t c_mul,
                                                   uint32_t c_xor,
                                                   uint32_t s) {
  x = (x * c_mul) & w;
  x ^= x >> s;
  x ^= k0;
  x = (x * c_xor) & w;
  x ^= k1;
  return x ^ (x >> 2);
}

__device__ __forceinline__ uint32_t scramble(uint32_t x, uint32_t w,
                                             uint32_t k0, uint32_t k1) {
  x = scramble_round(x, w, k0, k1, 0x9E3779B9u, 0x85EBCA6Bu, 5);
  x = scramble_round(x, w, k0, k1, 0xC2B2AE35u, 0x27D4EB2Fu, 3);
  x = scramble_round(x, w, k0, k1, 0x165667B1u, 0x9E3779B9u, 7);
  return x & w;
}

// permutation_element(i, n, p): the walk stops at the first x < n, which
// the plain version's remaining masked steps would leave unchanged.
__device__ __forceinline__ uint32_t permute(uint32_t i, uint32_t p,
                                            const CrtSamplerParams& q) {
  const uint32_t k0 = p & q.w, k1 = (p >> 16) & q.w;
  uint32_t x = scramble(i & q.w, q.w, k0, k1);
  for (uint32_t step = 0; step < q.walk && x >= q.n; ++step) {
    x = scramble(x, q.w, k0, k1);
  }
  return (x + p) % q.n;
}

__device__ __forceinline__ uint32_t sobol_u32(uint32_t index,
                                              const uint32_t* cols) {
  uint32_t v = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    v ^= cols[k] & (0u - ((index >> k) & 1u));
  }
  return v;
}

__device__ __forceinline__ uint32_t owen(uint32_t v, uint32_t seed) {
  v = __brev(v) + seed;
  v ^= v * 0x6C50B47Cu;
  v ^= v * 0xB82F1E52u;
  v ^= v * 0xC7AFE638u;
  v ^= v * 0x8D22F6E6u;
  return __brev(v);
}

template <int KIND, bool TWO_D>
__global__ void __launch_bounds__(kThreads)
sampler_kernel(const int64_t* __restrict__ pixel, int n,
               const int64_t* __restrict__ sample_dev, long long sample_host,
               const int64_t* __restrict__ seed_dev,
               const CrtSamplerParams q, float* __restrict__ out) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const uint32_t px = static_cast<uint32_t>(__ldg(pixel + r));
  const uint32_t s = static_cast<uint32_t>(
      sample_dev != nullptr ? __ldg(sample_dev) : sample_host);
  const uint32_t seed =
      seed_dev != nullptr ? static_cast<uint32_t>(__ldg(seed_dev)) : q.seed;
  const uint32_t seed_hash = hash_step(kHashInit, seed);  // hash_u32(seed)
  float v0, v1 = 0.0f;
  if (KIND == kIndependent) {
    const uint32_t h = hash_step(hash_step(seed_hash, px), s);
    v0 = u32_to_float(hash_step(h, q.dim0));
    if (TWO_D) v1 = u32_to_float(hash_step(h, q.dim1));
  } else if (KIND == kStratified) {
    const uint32_t key = hash_step(
        hash_step(hash_step(kHashInit, px), q.dim0), seed);
    const uint32_t stratum = permute(s, key, q);
    float d0 = 0.5f, d1 = 0.5f;
    if (q.jitter) {
      const uint32_t h = hash_step(hash_step(seed_hash, px), s);
      d0 = u32_to_float(hash_step(h, q.dim0));
      if (TWO_D) d1 = u32_to_float(hash_step(h, q.dim1));
    }
    if (TWO_D) {
      v0 = __fmul_rn(__fadd_rn(__uint2float_rn(stratum % q.xs), d0),
                     q.scale0);
      v1 = __fmul_rn(__fadd_rn(__uint2float_rn(stratum / q.xs), d1),
                     q.scale1);
    } else {
      v0 = __fmul_rn(__fadd_rn(__uint2float_rn(stratum), d0), q.scale0);
    }
  } else {
    const uint32_t h = hash_step(seed_hash, px);
    const uint32_t h0 = hash_step(h, q.dim0);
    const uint32_t idx = permute(s, hash_step(h0, 0x55555555u), q);
    v0 = u32_to_float(owen(sobol_u32(idx, q.sobol[0]), h0));
    if (TWO_D) {
      v1 = u32_to_float(owen(sobol_u32(idx, q.sobol[1]),
                             hash_step(h, q.dim1)));
    }
  }
  if (TWO_D) {
    reinterpret_cast<float2*>(out)[r] = make_float2(v0, v1);
  } else {
    out[r] = v0;
  }
}

template <int KIND>
void launch_kind(bool two_d, dim3 grid, cudaStream_t stream,
                 const int64_t* pixel, int n, const int64_t* sample_dev,
                 long long sample_host, const int64_t* seed_dev,
                 const CrtSamplerParams& q, float* out) {
  if (two_d) {
    sampler_kernel<KIND, true><<<grid, kThreads, 0, stream>>>(
        pixel, n, sample_dev, sample_host, seed_dev, q, out);
  } else {
    sampler_kernel<KIND, false><<<grid, kThreads, 0, stream>>>(
        pixel, n, sample_dev, sample_host, seed_dev, q, out);
  }
}

}  // namespace

// One draw of kind 0 (independent), 1 (stratified) or 2 (sobol), 1D
// (two_d = 0: out (n,) float32) or 2D (out (n, 2) float32), for the pixel ids
// pixel (n,) int64 at the sample index *sample_dev (a 0-d int64 device
// tensor) or, where sample_dev is null, sample_host, under the seed
// *seed_dev (a 0-d int64 device tensor, its low 32 bits) or, where seed_dev
// is null, params->seed. Launched on ``stream``; returns cudaGetLastError()
// (0: launched).
extern "C" int crt_sampler_draw(int kind, int two_d, const int64_t* pixel,
                                int n, const int64_t* sample_dev,
                                long long sample_host, const int64_t* seed_dev,
                                const CrtSamplerParams* params, float* out,
                                void* stream) {
  if (n < 0 || kind < kIndependent || kind > kSobol || params == nullptr ||
      params->n == 0 || (kind == kStratified && two_d && params->xs == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const CrtSamplerParams q = *params;
  const dim3 grid(static_cast<unsigned>(
      (static_cast<long long>(n) + kThreads - 1) / kThreads));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool two = two_d != 0;
  if (kind == kIndependent) {
    launch_kind<kIndependent>(two, grid, s, pixel, n, sample_dev,
                              sample_host, seed_dev, q, out);
  } else if (kind == kStratified) {
    launch_kind<kStratified>(two, grid, s, pixel, n, sample_dev, sample_host,
                             seed_dev, q, out);
  } else {
    launch_kind<kSobol>(two, grid, s, pixel, n, sample_dev, sample_host,
                        seed_dev, q, out);
  }
  return static_cast<int>(cudaGetLastError());
}
