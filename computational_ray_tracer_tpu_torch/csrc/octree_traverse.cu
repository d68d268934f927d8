// Octree traversal of a ray wavefront, closest hit or any hit, for sm_90a.
//
// Replaces: computational_ray_tracer_tpu/ops/pallas_octree.py
//   _traverse_kernel (pallas_call at :718; wrapped by octree_intersect_pallas
//   and octree_anyhit_pallas). The TPU kernel walks a packet of 1024 rays
//   with one shared SMEM stack, a pending-chunk queue and double-buffered
//   leaf DMA, because the TPU has no per-lane control flow. None of that is
//   carried over: here each thread traverses its own ray.
//
// What it computes: the closest hit (t, triangle id, b1, b2) of each ray in
//   (0, t_max) against the packed octree of ops/octree_kernel.py (sibling-
//   group node rows of 8 x 16 floats, leaf triangles packed 8 per 128-float
//   row, slot -> triangle id through row_tri), or in any-hit mode whether
//   any triangle is hit in (0, t_max); plus per-ray counters of triangle
//   tests and sibling-group pops.
//
// What bounds it on the H100: fp32 arithmetic. A ray/triangle pair costs
//   175 operations (PAIR_FLOPS in ops/mesh_intersect_kernel.py) and a
//   ray/box slab test 23; the tree (0.6 MB of nodes and 30 MB of leaf rows
//   for the 327,680-triangle mesh at cap 192) fits the 50 MB L2, so device
//   memory sees each table about once. Divergence (rays of a warp walking
//   different subtrees, leaves of different sizes) and the latency of the
//   dependent node loads cost more than either bound.
//
// Design: one ray per thread, 128 threads per block, rays in the order the
//   caller gives (raster order for camera rays, the (octant, Morton) packet
//   order for shadow rays, so neighbouring threads share subtrees). Each
//   thread keeps a stack of sibling-group ids in local memory. A pop loads
//   the group's row and visits its 8 children near to far (child j has rank
//   j ^ octant(ray)): a hit leaf's triangles are tested at once, so t_best
//   tightens before the farther siblings are tested, and the hit interior
//   children are pushed compactly, farthest first, so the nearest pops
//   next. A stack of 7 * kMaxTreeDepth + 1 entries always suffices (one pop
//   and at most 8 pushes per level); the launcher refuses deeper trees.
//
// Numerics: the per-pair test is watertight.cuh's, bit for bit the plain
//   version's (ops/mesh_intersect_kernel.watertight), folded with a strict
//   '<'. The slab test repeats the plain version's (ops/octree.py
//   octree_traverse): the 1/d guard sign(d) * 1e-20 + 1e-30 below |d| <
//   1e-20 (not the TPU kernel's +-1e-20), t_far widened by 1 + 2 gamma(3),
//   and the conditions tn <= tf, tf > 0, tn < t_best. Any-hit mode uses the
//   same predicate with t_best fixed at t_max and returns at the first hit,
//   so the occlusion bit equals the plain closest hit's id >= 0 (the TPU
//   kernel's division-free scaled test is not ported: it is not bit-equal
//   to that predicate). The traversal order differs from the plain
//   version's, so closest hits can differ in exact ties.
//
// Traps: empty sibling slots carry inverted +-1e30 bounds, which pass the
//   slab test, so slots are gated by child_group >= 0 or count > 0 alone;
//   child_group, leaf_row_off and count are exact floats converted with
//   __float2int_rz; padding slots and masked triangles are all-zero rows
//   (det = 0, never a hit); rays with t_max <= 0 miss at once.

#include "watertight.cuh"

namespace {

using namespace crt;

constexpr int kThreads = 128;
constexpr int kMaxTreeDepth = 24;  // ops/octree.py MAX_TREE_DEPTH
constexpr int kStack = 7 * kMaxTreeDepth + 1;
constexpr int kNodeLanes = 16;     // floats per child slot
constexpr int kGroupFloats = 8 * kNodeLanes;
constexpr int kTriLanes = 16;      // floats per packed triangle slot
constexpr int kTriPerRow = 8;
// 1 + 2 gamma(3), rounded to float32 as the plain version's constant is.
constexpr float kSlabWiden = static_cast<float>(
    1.0 + 2.0 * ((3 * kEps) / (1.0 - 3 * kEps)));

// The plain version's reciprocal of a direction component.
__device__ __forceinline__ float safe_inv(float v) {
  if (fabsf(v) < 1e-20f) {
    const float s = v > 0.0f ? 1e-20f : (v < 0.0f ? -1e-20f : 0.0f);
    v = add(s, 1e-30f);
  }
  return __fdiv_rn(1.0f, v);
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
octree_traverse_kernel(const float* __restrict__ o,
                       const float* __restrict__ d,
                       const float* __restrict__ tmax, int n,
                       const float* __restrict__ nodes,
                       const float* __restrict__ leaf_verts,
                       const int* __restrict__ row_tri,
                       float* __restrict__ t_out, int* __restrict__ idx_out,
                       float* __restrict__ b1_out,
                       float* __restrict__ b2_out,
                       int* __restrict__ tests_out,
                       int* __restrict__ pops_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;

  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float tm = tmax[i];
  float t_best = tm;
  int best_slot = -1;
  float best_b1 = 0.0f, best_b2 = 0.0f;
  int tests = 0, pops = 0;

  if (tm > 0.0f) {
    const Ray ray = make_ray(ox, oy, oz, dx, dy, dz);
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    const int octant = (dx < 0.0f ? 4 : 0) | (dy < 0.0f ? 2 : 0) |
                       (dz < 0.0f ? 1 : 0);
    int stack[kStack];
    int sp = 0;
    stack[sp++] = 0;  // group 0 holds the root in slot 7
    bool found = false;
    while (sp > 0 && !found) {
      const float* row = nodes + static_cast<size_t>(stack[--sp]) *
                                     kGroupFloats;
      ++pops;
      unsigned push = 0;  // bit r: the interior child of rank r was hit
      for (int r = 0; r < 8 && !found; ++r) {
        const float4* c = reinterpret_cast<const float4*>(
            row + (r ^ octant) * kNodeLanes);
        const float4 q0 = __ldg(c), q1 = __ldg(c + 1), q2 = __ldg(c + 2);
        const int child = __float2int_rz(q1.z);
        const int count = __float2int_rz(q2.x);
        if (child < 0 && count <= 0) continue;
        const float t0x = mul(sub(q0.x, ox), ix), t1x = mul(sub(q0.w, ox), ix);
        const float t0y = mul(sub(q0.y, oy), iy), t1y = mul(sub(q1.x, oy), iy);
        const float t0z = mul(sub(q0.z, oz), iz), t1z = mul(sub(q1.y, oz), iz);
        const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                               fminf(t0z, t1z));
        const float tf = mul(fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                   fmaxf(t0z, t1z)),
                             kSlabWiden);
        if (!(tn <= tf && tf > 0.0f && tn < t_best)) continue;
        if (child >= 0) {
          push |= 1u << r;
          continue;
        }
        const int slot0 = __float2int_rz(q1.w) * kTriPerRow;
        for (int k = 0; k < count; ++k) {
          const float4* p = reinterpret_cast<const float4*>(
              leaf_verts + static_cast<size_t>(slot0 + k) * kTriLanes);
          const float4 a = __ldg(p), b = __ldg(p + 1), e = __ldg(p + 2);
          const float v[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, e.x};
          ++tests;
          float t, b1, b2;
          if (!watertight(ray, t_best, v, t, b1, b2)) continue;
          if (kAnyHit) {
            best_slot = slot0 + k;
            found = true;
            break;
          }
          if (t < t_best) {
            t_best = t;
            best_slot = slot0 + k;
            best_b1 = b1;
            best_b2 = b2;
          }
        }
      }
      for (int r = 7; r >= 0; --r) {
        if ((push >> r) & 1u) {
          stack[sp++] = __float2int_rz(row[(r ^ octant) * kNodeLanes + 6]);
        }
      }
    }
  }

  const bool hit = best_slot >= 0;
  idx_out[i] = hit ? row_tri[best_slot] : -1;
  if (t_out) t_out[i] = hit ? t_best : CUDART_INF_F;
  if (b1_out) b1_out[i] = best_b1;
  if (b2_out) b2_out[i] = best_b2;
  if (tests_out) tests_out[i] = tests;
  if (pops_out) pops_out[i] = pops;
}

}  // namespace

// C interface, bound with ctypes. Pointers are device pointers: o, d (n, 3),
// tmax (n,), nodes (G, 128), leaf_verts (rows, 128), row_tri (rows * 8,).
// idx_out is required; t_out, b1_out, b2_out, tests_out and pops_out may be
// null. anyhit != 0 selects the any-hit mode (idx_out >= 0 where occluded).
// Launches on `stream` and returns cudaGetLastError() of the launch (0 on
// success), or cudaErrorInvalidValue for a tree deeper than the stack
// allows. Does not synchronise.
extern "C" int crt_octree_traverse(const float* o, const float* d,
                                   const float* tmax, int n,
                                   const float* nodes,
                                   const float* leaf_verts,
                                   const int* row_tri, int depth, int anyhit,
                                   float* t_out, int* idx_out, float* b1_out,
                                   float* b2_out, int* tests_out,
                                   int* pops_out, void* stream) {
  if (depth < 0 || depth > kMaxTreeDepth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (anyhit) {
    octree_traverse_kernel<true><<<blocks, kThreads, 0, s>>>(
        o, d, tmax, n, nodes, leaf_verts, row_tri, t_out, idx_out, b1_out,
        b2_out, tests_out, pops_out);
  } else {
    octree_traverse_kernel<false><<<blocks, kThreads, 0, s>>>(
        o, d, tmax, n, nodes, leaf_verts, row_tri, t_out, idx_out, b1_out,
        b2_out, tests_out, pops_out);
  }
  return static_cast<int>(cudaGetLastError());
}
