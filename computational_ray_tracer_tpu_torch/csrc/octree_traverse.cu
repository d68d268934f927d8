// Octree traversal of a ray wavefront, closest hit or any hit, for sm_90a.
//
// Replaces: computational_ray_tracer_tpu/ops/pallas_octree.py
//   _traverse_kernel (pallas_call at :718; wrapped by octree_intersect_pallas
//   and octree_anyhit_pallas). The TPU kernel walks a packet of 1024 rays
//   with one shared SMEM stack, a pending-chunk queue and double-buffered
//   leaf DMA, because the TPU has no per-lane control flow. Here each lane
//   of a warp traverses its own ray.
//
// What it computes: the closest hit (t, triangle id, b1, b2) of each ray in
//   (0, t_max) against the packed octree of ops/octree_kernel.py (sibling-
//   group node rows of 8 x 16 floats, leaf triangles packed 8 per 128-float
//   row, slot -> triangle id through row_tri), or in any-hit mode whether
//   any triangle is hit in (0, t_max); plus per-ray counters of triangle
//   tests and sibling-group pops.
//
// What bounds it on the H100: fp32 arithmetic. A ray/triangle test needs
//   108 operations for its edge-sign test and up to 151 in all (EDGE_FLOPS
//   and PAIR_FLOPS in ops/mesh_intersect_kernel.py), a ray/box slab test
//   23. Divergence (lanes of a warp walking different
//   subtrees, leaves of different sizes, lanes whose ray is done) and the
//   latency of dependent loads cost more than either bound; on sparse
//   wavefronts (a few thousand live rays of 262,144) the longest ray's
//   chain of loads and tests sets the time.
//
// Design (after Aila & Laine 2009 and Ylitie, Karras & Laine 2017):
//   - A short stack of compressed entries in shared memory. An entry is a
//     sibling group's id (24 bits) and an 8-bit mask of its hit interior
//     children not yet visited, bit r for near-to-far rank r (child slot
//     r ^ octant(ray)). A pop takes the lowest rank, clears it, keeps the
//     entry while bits remain and reads that child's group id from the
//     group's row. One entry per level: kMaxTreeDepth + 1 entries per lane,
//     laid out [entry][thread] so a warp's accesses hit 32 banks.
//   - Live rays first. A first kernel writes the miss of every ray with
//     t_max <= 0 and appends the others' indices to a queue, in order
//     within each block of 256 rays; the traversal sees live rays only.
//   - Persistent warps. The grid holds as many blocks as stay resident
//     (fewer for a launch of fewer rays than resident warps);
//     each warp takes queue entries from a global counter, one per idle
//     lane, whenever at least kRefillMin lanes are idle or none is busy;
//     lanes whose ray is done (an any-hit's first hit) take new rays
//     instead of idling until the warp's slowest ray ends. A warp holds at
//     most ceil(live / warps) rays (1 to 32), so a sparse wavefront whose
//     live rays sit together (the packet-ordered shadow rays of the deep
//     bounces) is spread over the whole card instead of a few warps.
//   - While-while: every busy lane walks (one child slot per step, the
//     next slot's loads issued before this one's slab test) until it holds
//     a hit leaf or its ray is done; then the warp tests its lanes' leaves
//     together and walks again, so lanes at interior nodes do not wait on
//     a neighbour's leaf of up to 192 triangles at every slot.
//   - Leaves tested by the whole warp. When the lanes' leaves take fewer
//     rounds one at a time with 32 lanes (the sum over lanes of
//     ceil(count / 32)) than each lane on its own (the largest count), the
//     warp takes them in turn: the owner's ray is broadcast, lane l tests
//     triangles l, l + 32, ... of the leaf (coalesced loads of the packed
//     rows) and a shuffle reduction keeps the first of the equal minima;
//     any hit keeps the first hit. Otherwise each lane tests its own leaf,
//     loading each triangle one test ahead. A lone ray with thousands of
//     tests (sparse bounce wavefronts) runs 32 triangles at a time.
//   Each ray visits the tree as a one-ray-per-thread traversal with a full
//   stack of group ids would: depth first, a group's 8 children near to
//   far, a hit leaf tested before the next sibling's slab test, the hit
//   interior children visited nearest first after the row. Both counters
//   are those of that order.
//
// Numerics: the per-pair test is watertight.cuh's, bit for bit the plain
//   version's (ops/mesh_intersect_kernel.watertight). A leaf's triangles
//   are tested against the ray's t_best at leaf entry and folded to the
//   first of the smallest hits, which beats t_best only if strictly
//   smaller: the plain version's leaf step (ops/octree.py
//   octree_traverse), so both leaf paths give one result and no result
//   depends on which rays share a warp. The slab test repeats the plain
//   version's: the 1/d guard sign(d) * 1e-20 + 1e-30 below |d| < 1e-20,
//   t_far widened by 1 + 2 gamma(3), and the conditions tn <= tf, tf > 0,
//   tn < t_best. Any-hit mode uses the same predicate with t_best fixed
//   at t_max and ends the ray at its first hit (its test count stops
//   there too), so the occlusion bit equals the plain closest hit's
//   id >= 0. The visiting order differs from the plain version's, so
//   closest hits can differ in exact ties.
//
// Traps: empty sibling slots carry inverted +-1e30 bounds, which pass the
//   slab test, so slots are gated by child_group >= 0 or count > 0 alone;
//   child_group, leaf_row_off and count are exact floats converted with
//   __float2int_rz; padding slots and masked triangles are all-zero rows
//   (det = 0, never a hit); the wrapper refuses trees whose group ids do
//   not fit an entry's 24 bits; every warp-wide intrinsic runs where all
//   32 lanes have reconverged (idle lanes run the loop body with nothing
//   to do).

#include "watertight.cuh"

namespace {

using namespace crt;

constexpr int kThreads = 128;
constexpr int kLiveThreads = 256;  // rays per block of the live-ray kernel
constexpr int kMaxTreeDepth = 24;  // ops/octree.py MAX_TREE_DEPTH
constexpr int kStack = kMaxTreeDepth + 1;
constexpr int kRefillMin = 8;      // idle lanes that make a warp fetch rays
constexpr int kNodeLanes = 16;     // floats per child slot
constexpr int kGroupFloats = 8 * kNodeLanes;
constexpr int kTriLanes = 16;      // floats per packed triangle slot
constexpr int kTriPerRow = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoSlot = 0x7fffffff;  // no hit in a leaf
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

// The plain version's slab test of the child box lo = q0.xyz, hi = (q0.w,
// q1.x, q1.y) for a ray from (ox, oy, oz) with reciprocal direction
// (ix, iy, iz) whose closest hit so far is at t_best.
__device__ __forceinline__ bool slab_hit(const float4& q0, const float4& q1,
                                         float ox, float oy, float oz,
                                         float ix, float iy, float iz,
                                         float t_best) {
  const float t0x = mul(sub(q0.x, ox), ix), t1x = mul(sub(q0.w, ox), ix);
  const float t0y = mul(sub(q0.y, oy), iy), t1y = mul(sub(q1.x, oy), iy);
  const float t0z = mul(sub(q0.z, oz), iz), t1z = mul(sub(q1.y, oz), iz);
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fminf(t0z, t1z));
  const float tf = mul(fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                             fmaxf(t0z, t1z)),
                       kSlabWiden);
  return tn <= tf && tf > 0.0f && tn < t_best;
}

// Lane src's ray, to every lane.
__device__ __forceinline__ Ray shfl_ray(const Ray& r, int src) {
  Ray s;
  s.ox = __shfl_sync(kFull, r.ox, src);
  s.oy = __shfl_sync(kFull, r.oy, src);
  s.oz = __shfl_sync(kFull, r.oz, src);
  s.kz_x = __shfl_sync(kFull, static_cast<int>(r.kz_x), src) != 0;
  s.kz_y = __shfl_sync(kFull, static_cast<int>(r.kz_y), src) != 0;
  s.inv_dz = __shfl_sync(kFull, r.inv_dz, src);
  s.sx = __shfl_sync(kFull, r.sx, src);
  s.sy = __shfl_sync(kFull, r.sy, src);
  return s;
}

// The watertight test of packed triangle slot `slot` against (0, tm).
__device__ __forceinline__ bool test_slot(const Ray& r, float tm,
                                          const float* __restrict__ leaf_verts,
                                          int slot, float& t, float& b1,
                                          float& b2) {
  const float4* p = reinterpret_cast<const float4*>(
      leaf_verts + static_cast<size_t>(slot) * kTriLanes);
  const float4 a = __ldg(p), b = __ldg(p + 1);
  const float v[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w,
                      __ldg(reinterpret_cast<const float*>(p + 2))};
  return watertight(r, tm, v, t, b1, b2);
}

struct Outputs {
  float* t;
  int* idx;
  float* b1;
  float* b2;
  int* tests;
  int* pops;
};

__device__ __forceinline__ void write_ray(const Outputs& out, int i,
                                          const int* __restrict__ row_tri,
                                          int best_slot, float t_best,
                                          float b1, float b2, int tests,
                                          int pops) {
  const bool hit = best_slot >= 0;
  out.idx[i] = hit ? __ldg(&row_tri[best_slot]) : -1;
  if (out.t) out.t[i] = hit ? t_best : CUDART_INF_F;
  if (out.b1) out.b1[i] = b1;
  if (out.b2) out.b2[i] = b2;
  if (out.tests) out.tests[i] = tests;
  if (out.pops) out.pops[i] = pops;
}

// The miss of every ray with t_max <= 0 (or NaN); the others' indices go to
// queue[0 .. *live), each block's in ray order at a slot taken from *live.
__global__ void __launch_bounds__(kLiveThreads)
octree_live_rays(const float* __restrict__ tmax, int n,
                 const int* __restrict__ row_tri, Outputs out,
                 int* __restrict__ live, int* __restrict__ queue) {
  __shared__ int s_warp[kLiveThreads / 32];
  __shared__ int s_base;
  const int i = blockIdx.x * kLiveThreads + threadIdx.x;
  const unsigned lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  const bool alive = i < n && __ldg(&tmax[i]) > 0.0f;
  if (i < n && !alive) write_ray(out, i, row_tri, -1, 0.0f, 0.0f, 0.0f, 0, 0);
  const unsigned m = __ballot_sync(kFull, alive);
  if (lane == 0) s_warp[warp] = __popc(m);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kLiveThreads / 32; ++w) {
      const int c = s_warp[w];
      s_warp[w] = total;
      total += c;
    }
    s_base = total > 0 ? atomicAdd(live, total) : 0;
  }
  __syncthreads();
  if (alive) queue[s_base + s_warp[warp] + __popc(m & ((1u << lane) - 1u))] = i;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
octree_traverse_kernel(const float* __restrict__ o,
                       const float* __restrict__ d,
                       const float* __restrict__ tmax,
                       const float* __restrict__ nodes,
                       const float* __restrict__ leaf_verts,
                       const int* __restrict__ row_tri, Outputs out,
                       int* __restrict__ next_entry,
                       const int* __restrict__ live_count,
                       const int* __restrict__ queue) {
  __shared__ unsigned s_stack[kStack * kThreads];
  unsigned* const stack = s_stack + threadIdx.x;  // entry j: stack[j * kThreads]
  const unsigned lane = threadIdx.x & 31u;
  // Rays a warp holds at once: the live rays spread over every warp.
  const int live = *live_count;
  const int warps = gridDim.x * (kThreads / 32);
  const int cap = min(32, max(1, (live + warps - 1) / warps));
  const int refill_min = min(kRefillMin, cap);

  int ray = -1;            // the ray this lane holds, -1 when idle
  bool exhausted = lane >= static_cast<unsigned>(cap);  // no ray to take
  Ray r{};
  float ix = 0.0f, iy = 0.0f, iz = 0.0f;
  int octant = 0;
  float t_best = 0.0f, best_b1 = 0.0f, best_b2 = 0.0f;
  int best_slot = -1, tests = 0, pops = 0;
  int sp = 0;              // entries on the stack
  int cur = 0;             // the group whose row is being walked
  int rank = 8;            // next child rank of that row (8: row done)
  unsigned push = 0;       // hit interior children of the row, by rank
  int leaf_slot0 = 0, leaf_count = 0;  // the hit leaf to test next
  // Slot `rank` of group `cur`, loaded one step ahead of its slab test.
  float4 s0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), s1 = s0;
  float s_count = 0.0f;
  auto load_slot = [&](int rk) {
    const float4* c = reinterpret_cast<const float4*>(
        nodes + static_cast<size_t>(cur) * kGroupFloats +
        (rk ^ octant) * kNodeLanes);
    s0 = __ldg(c);
    s1 = __ldg(c + 1);
    s_count = __ldg(reinterpret_cast<const float*>(c + 2));
  };

  for (;;) {
    const unsigned idle = __ballot_sync(kFull, ray < 0 && !exhausted);
    const unsigned busy = __ballot_sync(kFull, ray >= 0);
    if (idle != 0u && (busy == 0u || __popc(idle) >= refill_min)) {
      const int leader = __ffs(idle) - 1;
      int base = 0;
      if (lane == static_cast<unsigned>(leader)) {
        base = atomicAdd(next_entry, __popc(idle));
      }
      base = __shfl_sync(kFull, base, leader);
      if ((idle >> lane) & 1u) {
        const int e = base + __popc(idle & ((1u << lane) - 1u));
        if (e >= live) {
          exhausted = true;
        } else {
          const int i = queue[e];
          const float dx = __ldg(&d[3 * i]), dy = __ldg(&d[3 * i + 1]),
                      dz = __ldg(&d[3 * i + 2]);
          r = make_ray(__ldg(&o[3 * i]), __ldg(&o[3 * i + 1]),
                       __ldg(&o[3 * i + 2]), dx, dy, dz);
          ix = safe_inv(dx);
          iy = safe_inv(dy);
          iz = safe_inv(dz);
          octant = (dx < 0.0f ? 4 : 0) | (dy < 0.0f ? 2 : 0) |
                   (dz < 0.0f ? 1 : 0);
          t_best = __ldg(&tmax[i]);
          best_slot = -1;
          best_b1 = best_b2 = 0.0f;
          tests = 0;
          pops = 1;  // group 0, which holds the root in slot 7
          sp = 0;
          cur = 0;
          rank = 0;
          push = 0u;
          leaf_count = 0;
          ray = i;
          load_slot(0);
        }
      }
    }
    if (!__any_sync(kFull, ray >= 0)) {
      if (__all_sync(kFull, exhausted)) break;
      continue;
    }

    // Walk until this lane holds a hit leaf or its ray is done. Idle lanes
    // skip to the end of the loop body, where the warp reconverges.
    bool done = ray < 0;
    while (!done && leaf_count == 0) {
      if (rank == 8) {
        if (sp == 0) {
          done = true;
          break;
        }
        unsigned* const top = stack + (sp - 1) * kThreads;
        const unsigned e = *top;
        const unsigned mask = e & 0xffu;
        const int nearest = __ffs(mask) - 1;
        if (mask & (mask - 1u)) {
          *top = e & (e - 1u);  // clears the lowest set rank bit
        } else {
          --sp;
        }
        const int g = static_cast<int>(e >> 8);
        cur = __float2int_rz(__ldg(nodes + static_cast<size_t>(g) *
                                               kGroupFloats +
                                   (nearest ^ octant) * kNodeLanes + 6));
        rank = 0;
        ++pops;
        load_slot(0);
      }
      const float4 q0 = s0, q1 = s1;
      const int count = __float2int_rz(s_count);
      if (rank < 7) load_slot(rank + 1);
      const int child = __float2int_rz(q1.z);
      if (child >= 0 || count > 0) {
        if (slab_hit(q0, q1, r.ox, r.oy, r.oz, ix, iy, iz, t_best)) {
          if (child >= 0) {
            push |= 1u << rank;
          } else {
            leaf_slot0 = __float2int_rz(q1.w) * kTriPerRow;
            leaf_count = count;
          }
        }
      }
      if (++rank == 8 && push != 0u) {
        stack[sp * kThreads] = (static_cast<unsigned>(cur) << 8) | push;
        ++sp;
        push = 0u;
      }
    }

    // Test the leaves the warp's lanes hold: each lane its own, loading
    // each triangle one test ahead, or, when it takes fewer rounds, the
    // whole warp one lane's leaf at a time, 32 triangles a round.
    const int rounds = __reduce_add_sync(kFull, (leaf_count + 31) >> 5);
    const int longest = __reduce_max_sync(kFull, leaf_count);
    if (rounds < longest) {
      unsigned pending = __ballot_sync(kFull, leaf_count > 0);
      while (pending != 0u) {
        const int src = __ffs(pending) - 1;
        pending &= pending - 1u;
        const int slot0 = __shfl_sync(kFull, leaf_slot0, src);
        const int cnt = __shfl_sync(kFull, leaf_count, src);
        const float t_leaf = __shfl_sync(kFull, t_best, src);
        const Ray rs = shfl_ray(r, src);
        float bt = CUDART_INF_F, bb1 = 0.0f, bb2 = 0.0f;
        int bk = kNoSlot;
        for (int k0 = 0; k0 < cnt; k0 += 32) {
          const int k = k0 + static_cast<int>(lane);
          bool h = false;
          float t = 0.0f, b1 = 0.0f, b2 = 0.0f;
          if (k < cnt) {
            h = test_slot(rs, t_leaf, leaf_verts, slot0 + k, t, b1, b2);
          }
          if (kAnyHit) {
            const unsigned hits = __ballot_sync(kFull, h);
            if (hits != 0u) {
              bk = k0 + __ffs(hits) - 1;
              break;
            }
          } else if (h && t < bt) {
            bt = t;
            bk = k;
            bb1 = b1;
            bb2 = b2;
          }
        }
        if (!kAnyHit) {
          // The first of the warp's equal minima, as a lane's own loop keeps.
          for (int m = 16; m > 0; m >>= 1) {
            const float ot = __shfl_xor_sync(kFull, bt, m);
            const int ok = __shfl_xor_sync(kFull, bk, m);
            const float o1 = __shfl_xor_sync(kFull, bb1, m);
            const float o2 = __shfl_xor_sync(kFull, bb2, m);
            if (ot < bt || (ot == bt && ok < bk)) {
              bt = ot;
              bk = ok;
              bb1 = o1;
              bb2 = o2;
            }
          }
        }
        if (lane == static_cast<unsigned>(src)) {
          if (kAnyHit) {
            tests += bk == kNoSlot ? cnt : bk + 1;
            if (bk != kNoSlot) {
              best_slot = slot0 + bk;
              done = true;
            }
          } else {
            tests += cnt;
            if (bk != kNoSlot && bt < t_best) {
              t_best = bt;
              best_slot = slot0 + bk;
              best_b1 = bb1;
              best_b2 = bb2;
            }
          }
        }
      }
    } else if (leaf_count > 0) {
      const float t_leaf = t_best;
      const float4* p = reinterpret_cast<const float4*>(
          leaf_verts + static_cast<size_t>(leaf_slot0) * kTriLanes);
      float4 a = __ldg(p), b = __ldg(p + 1);
      float ex = __ldg(reinterpret_cast<const float*>(p + 2));
      for (int k = 0; k < leaf_count; ++k) {
        const float v[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, ex};
        if (k + 1 < leaf_count) {
          p += kTriLanes / 4;
          a = __ldg(p);
          b = __ldg(p + 1);
          ex = __ldg(reinterpret_cast<const float*>(p + 2));
        }
        ++tests;
        float t, b1, b2;
        if (!watertight(r, t_leaf, v, t, b1, b2)) continue;
        if (kAnyHit) {
          best_slot = leaf_slot0 + k;
          done = true;
          break;
        }
        if (t < t_best) {
          t_best = t;
          best_slot = leaf_slot0 + k;
          best_b1 = b1;
          best_b2 = b2;
        }
      }
    }
    leaf_count = 0;

    if (done && ray >= 0) {
      write_ray(out, ray, row_tri, best_slot, t_best, best_b1, best_b2,
                tests, pops);
      ray = -1;
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      sms = 132;
    }
  }
  return sms;
}

// Blocks of `kernel` that stay resident on the card.
template <typename K>
int resident_blocks(K kernel) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    0) != cudaSuccess ||
      per_sm < 1) {
    per_sm = 1;
  }
  return per_sm * sm_count();
}

}  // namespace

// C interface, bound with ctypes. Pointers are device pointers: o, d (n, 3),
// tmax (n,), nodes (G, 128), leaf_verts (rows, 128), row_tri (rows * 8,),
// scratch (n + 2,) int32 whose first two entries must be 0 at launch (the
// persistent warps' queue counter, the live-ray count, then the queue; the
// caller allocates it). idx_out is required; t_out, b1_out, b2_out,
// tests_out and pops_out may be null. anyhit != 0 selects the any-hit mode
// (idx_out >= 0 where occluded). The caller guarantees G < 2^24. Launches
// two kernels on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a tree deeper than the stack allows. Does not
// synchronise.
extern "C" int crt_octree_traverse(const float* o, const float* d,
                                   const float* tmax, int n,
                                   const float* nodes,
                                   const float* leaf_verts,
                                   const int* row_tri, int depth, int anyhit,
                                   float* t_out, int* idx_out, float* b1_out,
                                   float* b2_out, int* tests_out,
                                   int* pops_out, int* scratch,
                                   void* stream) {
  if (depth < 0 || depth > kMaxTreeDepth || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const Outputs out{t_out, idx_out, b1_out, b2_out, tests_out, pops_out};
  int* const next_entry = scratch;
  int* const live = scratch + 1;
  int* const queue = scratch + 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  octree_live_rays<<<(n + kLiveThreads - 1) / kLiveThreads, kLiveThreads, 0,
                     s>>>(tmax, n, row_tri, out, live, queue);
  // Up to one warp per ray, so that the rays of a small launch spread too.
  const int want = (n + kThreads / 32 - 1) / (kThreads / 32);
  if (anyhit) {
    static const int resident = resident_blocks(octree_traverse_kernel<true>);
    octree_traverse_kernel<true><<<want < resident ? want : resident,
                                   kThreads, 0, s>>>(
        o, d, tmax, nodes, leaf_verts, row_tri, out, next_entry, live, queue);
  } else {
    static const int resident = resident_blocks(octree_traverse_kernel<false>);
    octree_traverse_kernel<false><<<want < resident ? want : resident,
                                    kThreads, 0, s>>>(
        o, d, tmax, nodes, leaf_verts, row_tri, out, next_entry, live, queue);
  }
  return static_cast<int>(cudaGetLastError());
}
