// Brute-force watertight ray/triangle closest hit and any hit for NVIDIA
// Hopper (sm_90a).
//
// Replaces: computational_ray_tracer_tpu/ops/pallas_intersect.py
//   _intersect_kernel (launched by _mesh_intersect_impl, wrapped by
//   mesh_intersect_pallas). It computes, for every ray, the closest hit
//   against every triangle with the watertight test (translate, permute to
//   the dominant axis, shear, DifferenceOfProducts edge functions, a
//   gamma-bounded t), and returns t (+inf on a miss), the triangle id (-1 on
//   a miss) and the barycentrics b1 = e1/det, b2 = e2/det at the winner.
//   The any-hit mode (the JAX scene's id >= 0 test on that output) returns
//   one byte per ray and stops at the ray's first hit.
//
// What bounds it on the H100: fp32 arithmetic issued one rounding at a
//   time. A pair that fails the edge-sign test costs 108 operations
//   (translate 9, shear 12, six Dekker splits 24, three DifferenceOfProducts
//   63), one that fails the range test after it 119, one that reaches the
//   division 151 (EDGE_FLOPS, RANGE_FLOPS and PAIR_FLOPS in
//   ops/mesh_intersect_kernel.py);
//   the triangles (36 bytes each) are shared by every ray of a block, so
//   device memory sees one read of each live ray and one write of each
//   result. Without FMA contraction an add or a multiply issues at half the
//   published 67 TFLOP/s, which counts an FMA as two operations.
//
// What the design does about it, aimed at the Cornell pass (12 triangles,
//   262,144 rays, 50-100% of them live):
//   - Live rays only. A block of 256 rays writes the miss of every ray with
//     t_max <= 0 (or NaN), which cannot hit (the range test needs
//     0 < ts < t_max |det|), and packs its live rays onto its first
//     threads in ray order, so whole warps of dead rays drop out. One
//     launch: on an H100 80GB HBM3, a global queue of live rays (a second
//     kernel, as the octree kernel has) was 7-14% faster on the Cornell
//     pass's sparse any-hit launches and 4-5% slower on its full ones;
//     each thread keeping its own ray was 7-34% slower where a quarter to
//     a half of the rays are dead.
//   - Triangles staged once per block, masked ones dropped while staging
//     (a ballot and a prefix over the block's warps keep the kept ones in
//     index order), and stored in the three axis permutations of the
//     watertight test: a lane reads its ray's permutation with three
//     16-byte shared loads, so the per-pair permute selects are gone (the
//     ray's origin is permuted once instead: the same subtractions). At
//     F <= 256 one tile holds the mesh and the block syncs twice in all;
//     larger meshes go in tiles of 256 with two syncs a tile.
//   - Two passes over each 32 triangles. The first runs the edge-sign
//     test (108 operations, the bulk) branch-free, two pairs in flight,
//     into a bit mask; the second takes the set bits in triangle order,
//     recomputes those pairs' edge functions (the same bits) and runs the
//     range test, then the division, t, its error bound and the
//     barycentrics. Branching after every pair's sign test left the loop
//     without instruction-level parallelism; moving the range test into
//     the first pass cost more than it saved (few pairs pass the sign
//     test).
//   - Ray loads: each live ray's thread loads its 6 floats of o and d, so
//     a sparse wavefront reads o and d of the live rays only.
//   - Any hit: one byte a ray, the ray's lane stops after the 32 triangles
//     holding its first hit, and a block whose rays are all done skips its
//     remaining tiles.
//   - At most 64 registers (4 resident blocks of 256 threads).
//   - Optional per-ray counters (pairs tested, pairs past the edge-sign
//     test, pairs past the range test) for the bound; the main path passes
//     null pointers.
//
// Numerics: the per-pair test is watertight.cuh's, in its three stages, bit
//   for bit the plain version's (mesh_intersect_kernel.watertight). The
//   Dekker split uses 4097 (2^12 + 1), the float32 factor of ops/shapes.py,
//   not the 0x10001 of the TPU kernel. Each triangle's hit is decided
//   against the ray's own t_max; the winner is the smallest t, and the
//   lowest index among exact ties, as the one-piece loop with a strict '<'
//   in index order gives. Any hit is the OR of the same per-triangle
//   predicate, so it equals the closest hit's id >= 0.

#include "watertight.cuh"

namespace {

using namespace crt;

constexpr int kThreads = 256;            // rays per block, one per thread
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads;          // triangles per staged tile
constexpr int kRow = 3;                  // float4 per permuted triangle row
constexpr int kSlot = 3 * kRow;          // float4 per staged triangle
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMinBlocks = 4;            // resident blocks an SM

struct Outputs {
  float* t;
  int* idx;
  float* b1;
  float* b2;
  unsigned char* hit;
  int* tests;
  int* passed;
  int* ranged;
};

template <bool kAnyHit>
__device__ __forceinline__ void write_ray(const Outputs& out, int i, float t,
                                          int idx, float b1, float b2,
                                          int tests, int passed, int ranged) {
  if (kAnyHit) {
    out.hit[i] = idx >= 0 ? 1 : 0;
  } else {
    out.t[i] = t;
    out.idx[i] = idx;
    out.b1[i] = b1;
    out.b2[i] = b2;
  }
  if (out.tests) out.tests[i] = tests;
  if (out.passed) out.passed[i] = passed;
  if (out.ranged) out.ranged[i] = ranged;
}

// v's coordinates in the axis order of permutation p (0: x y z; 1, the
// dominant axis x: y z x; 2, dominant y: z x y), as Ray's perm orders them.
__device__ __forceinline__ void permuted(int p, float x, float y, float z,
                                         float& px, float& py, float& pz) {
  px = p == 0 ? x : (p == 1 ? y : z);
  py = p == 0 ? y : (p == 1 ? z : x);
  pz = p == 0 ? z : (p == 1 ? x : y);
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mesh_intersect_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ tmax,
                      const float* __restrict__ tris,
                      const unsigned char* __restrict__ mask, int n, int f,
                      Outputs out) {
  // Staged triangles: slot s, permutation p is s_tri[s * kSlot + p * kRow].
  extern __shared__ float4 s_tri[];
  __shared__ int s_id[kTile];               // triangle id of each slot
  __shared__ int s_count[2][kWarps];        // kept triangles, live rays
  __shared__ int s_live[kThreads];          // the block's live rays

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int first = blockIdx.x * kThreads;
  const int i = first + tid;
  const bool live = i < n && __ldg(&tmax[i]) > 0.0f;
  if (i < n && !live) {
    write_ray<kAnyHit>(out, i, CUDART_INF_F, -1, 0.0f, 0.0f, 0, 0, 0);
  }
  const unsigned live_bits = __ballot_sync(kFull, live);
  if (lane == 0) s_count[1][warp] = __popc(live_bits);

  int ray = -1;              // the ray this thread holds, -1 when none
  Ray r{};
  float opx = 0.0f, opy = 0.0f, opz = 0.0f, tm = 0.0f;
  int perm_row = 0;          // float4 offset of the ray's permutation
  float best_t = CUDART_INF_F, best_b1 = 0.0f, best_b2 = 0.0f;
  int best_i = -1, tests = 0, passed = 0, ranged = 0;
  bool done = false;         // any hit: the ray has hit

  // Stage 1 of the ray against staged slot k (its permutation's row).
  auto edge = [&](int k, Pair& pr) {
    const float4* q = s_tri + k * kSlot + perm_row;
    const float4 q0 = q[0], q1 = q[1], q2 = q[2];
    return edge_stage(r, sub(q0.x, opx), sub(q0.y, opy), sub(q0.z, opz),
                      sub(q0.w, opx), sub(q1.x, opy), sub(q1.y, opz),
                      sub(q1.z, opx), sub(q1.w, opy), sub(q2.x, opz), pr);
  };

  const int f_tiles = f > 0 ? f : 1;  // one pass even without triangles
  for (int base = 0; base < f_tiles; base += kTile) {
    const int j = base + tid;
    const bool keep = tid < kTile && j < f && (mask == nullptr || mask[j]);
    const unsigned keep_bits = __ballot_sync(kFull, keep);
    if (lane == 0) s_count[0][warp] = __popc(keep_bits);
    // Every thread is done with the previous tile's slots; any hit leaves
    // the loop when no ray of the block is still looking.
    const bool busy = ray >= 0 && !done;
    if (!__syncthreads_or(busy || base == 0)) break;

    int slot = 0, cnt = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_count[0][w];
      slot += w < warp ? c : 0;
      cnt += c;
    }
    if (keep) {
      slot += __popc(keep_bits & below);
      float v[9];
#pragma unroll
      for (int c = 0; c < 9; ++c) v[c] = __ldg(&tris[c * f + j]);
      float4* row = s_tri + slot * kSlot;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        float ax, ay, az, bx, by, bz, cx, cy, cz;
        permuted(p, v[0], v[1], v[2], ax, ay, az);
        permuted(p, v[3], v[4], v[5], bx, by, bz);
        permuted(p, v[6], v[7], v[8], cx, cy, cz);
        row[p * kRow] = make_float4(ax, ay, az, bx);
        row[p * kRow + 1] = make_float4(by, bz, cx, cy);
        row[p * kRow + 2] = make_float4(cz, 0.0f, 0.0f, 0.0f);
      }
      s_id[slot] = j;
    }
    int n_live = 0;
    if (base == 0) {
      int at = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int c = s_count[1][w];
        at += w < warp ? c : 0;
        n_live += c;
      }
      if (live) s_live[at + __popc(live_bits & below)] = tid;
    }
    __syncthreads();

    if (base == 0 && tid < n_live) {
      ray = first + s_live[tid];
      const float* ro = o + 3 * ray;
      const float* rd = d + 3 * ray;
      r = make_ray(__ldg(ro), __ldg(ro + 1), __ldg(ro + 2), __ldg(rd),
                   __ldg(rd + 1), __ldg(rd + 2));
      const int p = r.kz_x ? 1 : (r.kz_y ? 2 : 0);
      perm(r, r.ox, r.oy, r.oz, opx, opy, opz);
      perm_row = p * kRow;
      tm = __ldg(&tmax[ray]);
    }
    if (ray < 0 || done) continue;

    for (int k0 = 0; k0 < cnt && !done; k0 += 32) {
      const int m = min(32, cnt - k0);
      // Pass 1, branch-free: the edge-sign test of up to 32 triangles, two
      // pairs in flight, as a bit mask.
      unsigned side = 0u;
#pragma unroll 2
      for (int b = 0; b < m; ++b) {
        Pair pr;
        side |= static_cast<unsigned>(edge(k0 + b, pr)) << b;
      }
      // Pass 2, in triangle order: the pairs past the sign test again (the
      // same values), the range test, then the costly stage.
      unsigned rest = side;
      int hit_bit = -1;
      while (rest != 0u) {
        const int b = __ffs(rest) - 1;
        rest &= rest - 1u;
        Pair pr;
        edge(k0 + b, pr);
        float t, b1, b2;
        if (!range_stage(r, tm, pr)) continue;
        ++ranged;
        if (!hit_stage(pr, t, b1, b2)) continue;
        if (kAnyHit) {
          hit_bit = b;
          break;
        }
        if (t < best_t) {  // triangle order: the lowest index wins ties
          best_t = t;
          best_i = s_id[k0 + b];
          best_b1 = b1;
          best_b2 = b2;
        }
      }
      if (hit_bit >= 0) {
        done = true;
        tests += hit_bit + 1;
        passed += __popc(side & ((2u << hit_bit) - 1u));
      } else {
        tests += m;
        passed += __popc(side);
      }
    }
  }
  if (ray < 0) return;
  write_ray<kAnyHit>(out, ray, best_t, kAnyHit ? (done ? 0 : -1) : best_i,
                     best_b1, best_b2, tests, passed, ranged);
}

template <bool kAnyHit>
int launch(const float* o, const float* d, const float* tmax,
           const float* tris, const unsigned char* mask, int n, int f,
           const Outputs& out, void* stream) {
  if (n <= 0) return 0;
  const int slots = f < kTile ? (f > 0 ? f : 1) : kTile;
  const size_t smem = static_cast<size_t>(slots) * kSlot * sizeof(float4);
  mesh_intersect_kernel<kAnyHit>
      <<<(n + kThreads - 1) / kThreads, kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(o, d, tmax, tris, mask, n, f,
                                               out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes. Pointers are device pointers: o, d (n, 3)
// float32, tmax (n,), tris (9, f) float32 [p0 xyz, p1 xyz, p2 xyz] rows,
// mask (f,) bytes, nonzero to keep a triangle, or null (every triangle
// kept). tests_out, passed_out and ranged_out (n,) int32 may be null:
// pairs tested, pairs past the edge-sign test and pairs past the range
// test as well, per ray. Each launches one kernel on `stream` and returns
// cudaGetLastError() of the launch (0 on success). Neither synchronises.
extern "C" int crt_mesh_intersect(const float* o, const float* d,
                                  const float* tmax, const float* tris,
                                  const unsigned char* mask, int n, int f,
                                  float* t_out, int* idx_out, float* b1_out,
                                  float* b2_out, int* tests_out,
                                  int* passed_out, int* ranged_out,
                                  void* stream) {
  const Outputs out{t_out,     idx_out,    b1_out,    b2_out,
                    nullptr,   tests_out,  passed_out, ranged_out};
  return launch<false>(o, d, tmax, tris, mask, n, f, out, stream);
}

// Any hit: hit_out (n,) bytes, 1 where a triangle is hit in (0, t_max).
extern "C" int crt_mesh_anyhit(const float* o, const float* d,
                               const float* tmax, const float* tris,
                               const unsigned char* mask, int n, int f,
                               unsigned char* hit_out, int* tests_out,
                               int* passed_out, int* ranged_out,
                               void* stream) {
  const Outputs out{nullptr, nullptr,   nullptr,    nullptr,
                    hit_out, tests_out, passed_out, ranged_out};
  return launch<true>(o, d, tmax, tris, mask, n, f, out, stream);
}

extern "C" const char* crt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
