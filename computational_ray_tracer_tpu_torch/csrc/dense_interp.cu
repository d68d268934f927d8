// Dense-spectrum interpolation for NVIDIA Hopper (sm_90a).
//
// Replaces: computational_ray_tracer_tpu/ops/pallas_interp.py:36
//   _interp_kernel (wrapped by dense_interp_pallas). For every row r it
//   computes tables[i0[r]] * (1 - w[r]) + tables[i0[r] + 1] * w[r]: the
//   lerp of two neighbouring rows of a (K, C) table of 1 nm spectra, K <= 512
//   rows, C <= 128 columns, into an (n, C) output.
//
// What bounds it on the H100: bytes. Per row it reads i0 and w (8 bytes) and
//   writes C floats; it does 4 fp32 operations per output element. At the
//   flagship's spectral-cache shape (n = 2,097,152 rows, C = 5) that is about
//   59 MB, some 17.5 us at 3.35 TB/s, against 42 MFLOP (0.6 us at
//   67 TFLOP/s).
//
// What the design does about it: the TPU kernel gathers through two one-hot
//   bf16 hi/lo matrix products because a TPU core has no fast per-lane
//   gather; the card gathers natively, so this kernel reads the two rows
//   directly and keeps float32 exactly.
//   - Narrow tables (C <= 8, C a template parameter, so e / C is a multiply
//     and a shift; the table at most 16 KB): blocks stay resident, each
//     stages the table in shared memory once (9.4 KB at C = 5) and its
//     warps walk over chunks of 128 rows. A lane reads the i0 and w of 4
//     rows as one int4 and one float4, a chunk ahead, and leaves the
//     clamped row offset and the weight in shared memory; then neighbouring
//     lanes compute neighbouring output elements (a few table rows per
//     instruction), park them in shared memory, and the warp writes the
//     chunk's 128 C floats as coalesced 16-byte stores. The last chunk of
//     a ragged n, and inputs not 16-byte aligned, take a scalar path.
//   - Wide tables (C > 8, e.g. 471 x 128, or a narrow table above 16 KB):
//     a warp takes 32 rows; lane l reads row l's i0 and w, and the warp
//     then walks the 32 rows, each lane lerping columns 4 l .. 4 l + 3 as
//     float4 (C % 4 == 0 and aligned pointers), else one column at a time,
//     reading the table through the read-only cache.
//   On an H100 staging the table measured faster than reading it through
//   __ldg at C = 3 and C = 5 (PERF.md).
//
// Numerics: __fadd_rn(__fmul_rn(v0, __fsub_rn(1, w)), __fmul_rn(v1, w)),
//   which nvcc never contracts into FMA, in the operation order of the plain
//   PyTorch version (interp_kernel.dense_interp_plain), so the two agree bit
//   for bit. Both clamp i0 to [0, K-2], so they compute one function on any
//   index and the kernel never reads outside the table.

#include <cstdint>
#include <mutex>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // wide tables
constexpr int kWarps = kThreads / 32;
constexpr int kNarrowThreads = 128;
constexpr int kNarrowWarps = kNarrowThreads / 32;
constexpr int kChunk = 128;      // rows per warp, narrow tables
constexpr int kMaxNarrow = 8;
constexpr int kMaxStagedTableBytes = 16 * 1024;

__device__ __forceinline__ float lerp(float v0, float v1, float w) {
  return __fadd_rn(__fmul_rn(v0, __fsub_rn(1.0f, w)), __fmul_rn(v1, w));
}

__device__ __forceinline__ int clamp_row(int i, int k) {
  return min(max(i, 0), k - 2);
}

template <int C>
__global__ void __launch_bounds__(kNarrowThreads)
dense_interp_narrow(const float* __restrict__ tables, int k,
                    const int* __restrict__ i0, const float* __restrict__ w,
                    int n, float* __restrict__ out, bool aligned) {
  extern __shared__ float table[];  // k * C floats
  __shared__ __align__(16) int s_off[kNarrowWarps][kChunk];
  __shared__ __align__(16) float s_w[kNarrowWarps][kChunk];
  __shared__ __align__(16) float s_out[kNarrowWarps][kChunk * C];
  for (int j = threadIdx.x; j < k * C; j += kNarrowThreads) {
    table[j] = __ldg(&tables[j]);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* const off = s_off[warp];
  float* const wt = s_w[warp];
  float* const res = s_out[warp];
  const int chunks = (n + kChunk - 1) / kChunk;
  const int stride = gridDim.x * kNarrowWarps;
  // A chunk of 128 rows read with vector loads; its i0 and w are loaded
  // one chunk ahead.
  auto vector_chunk = [&](int ch) {
    return aligned && ch < n / kChunk;
  };
  int4 ii = make_int4(0, 0, 0, 0);
  float4 ww = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  auto fetch = [&](int ch) {
    ii = __ldg(reinterpret_cast<const int4*>(i0 + ch * kChunk) + lane);
    ww = __ldg(reinterpret_cast<const float4*>(w + ch * kChunk) + lane);
  };
  int chunk = blockIdx.x * kNarrowWarps + warp;
  if (vector_chunk(chunk)) fetch(chunk);
  for (; chunk < chunks; chunk += stride) {
    const int row0 = chunk * kChunk;
    const int rows = min(kChunk, n - row0);
    const bool full = vector_chunk(chunk);
    if (full) {
      reinterpret_cast<int4*>(off)[lane] = make_int4(
          clamp_row(ii.x, k) * C, clamp_row(ii.y, k) * C,
          clamp_row(ii.z, k) * C, clamp_row(ii.w, k) * C);
      reinterpret_cast<float4*>(wt)[lane] = ww;
    } else {
      for (int q = lane; q < rows; q += 32) {
        off[q] = clamp_row(__ldg(&i0[row0 + q]), k) * C;
        wt[q] = __ldg(&w[row0 + q]);
      }
    }
    if (vector_chunk(chunk + stride)) fetch(chunk + stride);
    __syncwarp();
    float* const dst = out + static_cast<size_t>(row0) * C;
    if (full) {
      // Neighbouring lanes take neighbouring elements (a few table rows
      // per instruction); the results go out as 16-byte stores.
#pragma unroll
      for (int m = 0; m < 4 * C; ++m) {
        const int e = 32 * m + lane;
        const int r = e / C;
        const int a = off[r] + (e - r * C);
        res[e] = lerp(table[a], table[a + C], wt[r]);
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < C; ++j) {
        reinterpret_cast<float4*>(dst)[32 * j + lane] =
            reinterpret_cast<const float4*>(res)[32 * j + lane];
      }
    } else {
      for (int e = lane; e < rows * C; e += 32) {
        const int r = e / C;
        const int a = off[r] + (e - r * C);
        dst[e] = lerp(table[a], table[a + C], wt[r]);
      }
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
dense_interp_wide(const float* __restrict__ table, int k, int c,
                  const int* __restrict__ i0, const float* __restrict__ w,
                  int n, float* __restrict__ out, bool vec4) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kWarps;
  for (int row0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32; row0 < n;
       row0 += warps * 32) {
    const int mine = row0 + lane;
    const int my_off = mine < n ? clamp_row(__ldg(&i0[mine]), k) * c : 0;
    const float my_w = mine < n ? __ldg(&w[mine]) : 0.0f;
    const int rows = min(32, n - row0);
    for (int q = 0; q < rows; ++q) {
      const int a = __shfl_sync(0xffffffffu, my_off, q);
      const float wr = __shfl_sync(0xffffffffu, my_w, q);
      float* const dst = out + static_cast<size_t>(row0 + q) * c;
      if (vec4) {
        for (int col = 4 * lane; col < c; col += 128) {
          const float4 v0 = __ldg(reinterpret_cast<const float4*>(table + a + col));
          const float4 v1 =
              __ldg(reinterpret_cast<const float4*>(table + a + c + col));
          *reinterpret_cast<float4*>(dst + col) =
              make_float4(lerp(v0.x, v1.x, wr), lerp(v0.y, v1.y, wr),
                          lerp(v0.z, v1.z, wr), lerp(v0.w, v1.w, wr));
        }
      } else {
        for (int col = lane; col < c; col += 32) {
          dst[col] = lerp(__ldg(&table[a + col]), __ldg(&table[a + c + col]),
                          wr);
        }
      }
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

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

template <int C>
int launch_narrow(const float* tables, int k, const int* i0, const float* w,
                  int n, float* out, cudaStream_t s) {
  const bool aligned = aligned16(i0) && aligned16(w) && aligned16(out);
  const size_t smem = static_cast<size_t>(k) * C * sizeof(float);
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, dense_interp_narrow<C>, kNarrowThreads, smem) !=
          cudaSuccess ||
      per_sm < 1) {
    per_sm = 1;
  }
  const int cap = per_sm * sm_count();
  const int want = (n + kChunk * kNarrowWarps - 1) / (kChunk * kNarrowWarps);
  dense_interp_narrow<C><<<want < cap ? want : cap, kNarrowThreads, smem,
                           s>>>(tables, k, i0, w, n, out, aligned);
  return static_cast<int>(cudaGetLastError());
}

int launch(const float* tables, int k, int c, const int* i0, const float* w,
           int n, float* out, cudaStream_t s) {
  if (c > kMaxNarrow ||
      static_cast<long long>(k) * c * 4 > kMaxStagedTableBytes) {
    const int cap = sm_count() * (2048 / kThreads);
    const int want = (n + 32 * kWarps - 1) / (32 * kWarps);
    const bool vec4 = c % 4 == 0 && aligned16(tables) && aligned16(out);
    dense_interp_wide<<<want < cap ? want : cap, kThreads, 0, s>>>(
        tables, k, c, i0, w, n, out, vec4);
    return static_cast<int>(cudaGetLastError());
  }
  switch (c) {
    case 1: return launch_narrow<1>(tables, k, i0, w, n, out, s);
    case 2: return launch_narrow<2>(tables, k, i0, w, n, out, s);
    case 3: return launch_narrow<3>(tables, k, i0, w, n, out, s);
    case 4: return launch_narrow<4>(tables, k, i0, w, n, out, s);
    case 5: return launch_narrow<5>(tables, k, i0, w, n, out, s);
    case 6: return launch_narrow<6>(tables, k, i0, w, n, out, s);
    case 7: return launch_narrow<7>(tables, k, i0, w, n, out, s);
    default: return launch_narrow<8>(tables, k, i0, w, n, out, s);
  }
}

// ---------------------------------------------------------------------------
// Backward: the table gradient.
//
// For every row r, grad[i0[r], :] += (1 - w[r]) g[r, :] and
// grad[i0[r] + 1, :] += w[r] g[r, :], i0 clamped to [0, K-2] as in the
// forward; i0 and w get no gradient (the wavelengths are a sampling
// decision). The output is tiny ((K, C), K = 471 on every pass) and every
// row lands on it twice: the 2^21 rows of the Cornell headline's cache add
// into each of its 471 table rows about 8,900 times.
//
// What bounds it on the H100: bytes, g read once (4 n C), i0 and w (8 n),
// the table written once: 45 us at the headline's 2^21 x 16.
//
// Design (one launch; no float atomics, so the result has the same bits in
// every run: the order of every sum depends only on the shape and the card,
// its SM count and how many clusters of the kernel it holds at once). A
// block of T threads (256 where a tile has at most 16 columns and n fills
// the card, else 512) holds a table of K x ct (ct = min(C, 32) columns;
// wider tables are cut into column tiles, grid.y) in shared memory and
// walks its range of rows in chunks of up to T rows:
//   1. Staging, double buffered (chunk i + 1 is in flight while chunk i is
//      sorted and summed): the chunk's i0 and w, and at ct = C its g (one
//      contiguous span), by bulk (TMA) copies that one thread issues on an
//      mbarrier a buffer; a column tile's rows of g by 16-byte cp.async;
//      4-byte cp.async for ragged tails and unaligned inputs.
//   2. Sort. A stable two-pass radix sort (5-bit digits, one row a thread;
//      five ballots rank a warp's rows and count each digit, and every warp
//      sums the warp-by-digit counts itself: two barriers a pass) orders the
//      chunk's rows by table row, each entry carrying its w. Its work is
//      sized to the chunk, not to K.
//   3. Segmented sums. The sorted chunk is cut into T / ct equal ranges of
//      positions, and the ct threads of a range (lanes over columns) walk
//      it in order, keeping the running sums of (1 - w) g and w g of the
//      current table row in registers. A run of one table row that starts
//      in an earlier range reaches the thread that owns it (the range where
//      it starts) as a carry, added in range order after a barrier, so a
//      run as long as the chunk (every row on one table row) is spread over
//      all of the block's threads. Each table row is one run of the sorted
//      chunk, so its owner adds the (1 - w) sum into cell (j, col) alone,
//      and the w sum into cell (j + 1, col) at once when run j + 1 is its
//      own or absent, else after the next barrier (kept in registers).
//      Six barriers a chunk in all.
//   4. Reduction in the launch. Clusters of up to 8 blocks sum their tables
//      over distributed shared memory in rank order, each block a slice of
//      the cells. One cluster writes the gradient; more write cluster
//      partials, and the last cluster to finish (a ticket counter, which it
//      resets for the next launch and graph replay) sums them in cluster
//      order. The grid is as many blocks as the card holds at once, fewer
//      for small n (each block at least kMinRowsPerBlock rows), in clusters
//      of the largest size that keeps 90% of them resident.
// On the H100 the kernel is bound by the latency of its barrier phases and
// by instructions, not by bytes (PERF.md).
// Numerics: (1 - w) g and w g rounded as the plain version rounds them
//   (__fsub_rn, __fmul_rn); every sum __fadd_rn; built with -fmad=false.
//   The order of the sums differs from the plain version's index_add_, so
//   the two agree to float rounding, not bit for bit.
// ---------------------------------------------------------------------------

constexpr int kBwdMaxCols = 32;        // columns a tile
constexpr int kRowBits = 10;           // a sort entry: table row << 10 | row
constexpr int kRowMask = (1 << kRowBits) - 1;
constexpr int kSentinel = (1 << kRowBits) - 1;  // sorts after every row
constexpr int kBwdMaxK = kSentinel + 1;         // clamped rows <= K - 2
constexpr int kMaxClusterBlocks = 8;
constexpr int kMinRowsPerBlock = 384;
constexpr int kMaxTiles = 256;
constexpr unsigned kFull = 0xffffffffu;

// How a chunk's g is staged: one bulk (TMA) copy of its span when a tile
// is the whole row, 16-byte cp.async of each row's tile (one bulk copy a
// 128-byte row measured slower), or 4-byte cp.async (inputs not 16-byte
// aligned). i0 and w go by bulk copies when aligned.
enum CopyMode { kCopySpan = 0, kCopyRows = 1, kCopyScalar = 2 };

// One counter a column tile; the last cluster of a launch sets it back to
// 0, so it is 0 at every launch.
__device__ unsigned int g_bwd_tickets[kMaxTiles];

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk (TMA) copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Copies rows [q0, q0 + m) of i0 and w, and columns [c0, c0 + wd) of the
// same rows of g, into shared memory (g as m rows of wd floats): bulk
// copies on `bar` (thread 0 arms it with their bytes) and cp.async for the
// rest, committed as one group.
template <int T>
__device__ __forceinline__ void stage_chunk(
    unsigned long long* bar, float* gdst, int* idst, float* wdst,
    const float* __restrict__ g, const int* __restrict__ i0,
    const float* __restrict__ w, int q0, int m, int c, int c0, int wd,
    int mode) {
  const int tid = threadIdx.x;
  const int mi = mode == kCopyScalar ? 0 : m & ~3;
  const int mg = mode == kCopySpan ? (m * c) & ~3 : 0;
  if (tid == 0) {
    mbar_expect_tx(bar, 8u * mi + 4u * mg);
    if (mi > 0) {
      bulk_copy(idst, i0 + q0, 4u * mi, bar);
      bulk_copy(wdst, w + q0, 4u * mi, bar);
    }
    if (mg > 0) {
      bulk_copy(gdst, g + static_cast<size_t>(q0) * c, 4u * mg, bar);
    }
  }
  for (int j = mi + tid; j < m; j += T) {
    cp_async4(idst + j, i0 + q0 + j);
    cp_async4(wdst + j, w + q0 + j);
  }
  if (mode == kCopySpan) {
    const float* const src = g + static_cast<size_t>(q0) * c;
    for (int j = mg + tid; j < m * c; j += T) {
      cp_async4(gdst + j, src + j);
    }
  } else if (mode == kCopyRows) {
    const int per = wd >> 2;
    for (int j = tid; j < m * per; j += T) {
      const int r = j / per;
      const int u = j - r * per;
      cp_async16(gdst + r * wd + 4 * u,
                 g + static_cast<size_t>(q0 + r) * c + c0 + 4 * u);
    }
  } else {
    for (int j = tid; j < m * wd; j += T) {
      const int r = j / wd;
      cp_async4(gdst + j,
                g + static_cast<size_t>(q0 + r) * c + c0 + (j - r * wd));
    }
  }
  cp_async_commit();
}

// One stable pass of the radix sort: the new position of this thread's
// entry, whose 5-bit digit is d, among the block's T entries.
// The warp's five ballots give every lane the peers of any digit: lane x
// writes the count of digit x into cnt[warp][x], and after one barrier each
// warp sums the T / 32 warps' counts itself (no second barrier for a scan).
// The caller's barrier after its scatter ends the pass (cnt is reused).
template <int T>
__device__ __forceinline__ int radix_position(int d, int* cnt) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  unsigned bits[5];
#pragma unroll
  for (int b = 0; b < 5; ++b) bits[b] = __ballot_sync(kFull, (d >> b) & 1);
  unsigned mine = kFull;
  unsigned lanes = kFull;
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    mine &= ((d >> b) & 1) ? bits[b] : ~bits[b];
    lanes &= ((lane >> b) & 1) ? bits[b] : ~bits[b];
  }
  const int rank = __popc(mine & ((1u << lane) - 1u));
  cnt[warp * 32 + lane] = __popc(lanes);
  __syncthreads();
  int before = 0;   // digit `lane` in warps before this one
  int total = 0;    // digit `lane` in the block
#pragma unroll
  for (int v = 0; v < T / 32; ++v) {
    const int x = cnt[v * 32 + lane];
    total += x;
    before += v < warp ? x : 0;
  }
  int incl = total;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  return __shfl_sync(kFull, incl - total + before, d) + rank;
}

__device__ __forceinline__ void add_to(float* cell, float v) {
  *cell = __fadd_rn(*cell, v);
}

template <int T>
__global__ void __launch_bounds__(T, 1024 / T)
dense_interp_backward_kernel(const float* __restrict__ g, int k, int c,
                             const int* __restrict__ i0,
                             const float* __restrict__ w, int n, int ct,
                             int chunk, int rows_per_block, int mode,
                             float* __restrict__ partials,
                             float* __restrict__ grad) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long bars[2];  // one a buffer
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int tile = blockIdx.y;
  const int c0 = tile * ct;
  const int wd = min(ct, c - c0);
  const int buf_floats = chunk * ct;
  float* const table = smem;                                 // [k][wd]
  float* const gbuf = smem + ((k * ct + 3) & ~3);            // [2][chunk][wd]
  int* const ibuf = reinterpret_cast<int*>(gbuf + 2 * buf_floats);
  float* const wbuf = reinterpret_cast<float*>(ibuf + 2 * chunk);
  int* const buf1 = reinterpret_cast<int*>(wbuf + 2 * chunk);   // [T]
  int2* const srt = reinterpret_cast<int2*>(buf1 + T);          // [T]
  int* const cnt = reinterpret_cast<int*>(srt + T);             // [T]
  int* const gstart = cnt + T;                                  // [T + 1]
  float* const carry0 = reinterpret_cast<float*>(gstart + T + 4);  // [T]
  float* const carry1 = carry0 + T;                                // [T]

  for (int j = tid; j < k * wd; j += T) table[j] = 0.0f;
  const long long first = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int row0 = static_cast<int>(min(first, static_cast<long long>(n)));
  const int row_end = static_cast<int>(
      min(first + rows_per_block, static_cast<long long>(n)));
  const int chunks = (row_end - row0 + chunk - 1) / chunk;
  const int groups = T / wd;
  const int grp = tid / wd;
  const int col = tid - grp * wd;
  const bool walker = grp < groups;
  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (chunks > 0) {
    stage_chunk<T>(&bars[0], gbuf, ibuf, wbuf, g, i0, w, row0,
                   min(chunk, row_end - row0), c, c0, wd, mode);
  }
  // A run's w sum that goes into table row defer_row after the next barrier
  // (another thread may add into that cell before it).
  int defer_row = -1;
  float defer_s1 = 0.0f;
  for (int ci = 0; ci < chunks; ++ci) {
    const int b = ci & 1;
    const int q0 = row0 + ci * chunk;
    const int m = min(chunk, row_end - q0);
    cp_async_wait_all();
    mbar_wait(&bars[b], (ci >> 1) & 1);
    __syncthreads();
    if (ci + 1 < chunks) {
      const int q1 = q0 + chunk;
      stage_chunk<T>(&bars[b ^ 1], gbuf + (b ^ 1) * buf_floats,
                     ibuf + (b ^ 1) * chunk, wbuf + (b ^ 1) * chunk, g, i0,
                     w, q1, min(chunk, row_end - q1), c, c0, wd, mode);
    }
    if (defer_row >= 0) {
      add_to(&table[defer_row * wd + col], defer_s1);
      defer_row = -1;
    }
    const float* const gb = gbuf + b * buf_floats;
    const int* const ib = ibuf + b * chunk;
    const float* const wb = wbuf + b * chunk;

    // 2. Sort the chunk by table row (rows past m sort last); each sorted
    //    entry carries its row's w.
    const int key = tid < m ? clamp_row(ib[tid], k) : kSentinel;
    buf1[radix_position<T>(key & 31, cnt)] = (key << kRowBits) | tid;
    for (int j = tid; j <= groups; j += T) gstart[j] = j * m / groups;
    __syncthreads();
    const int e1 = buf1[tid];
    const float w1 = (e1 & kRowMask) < m ? wb[e1 & kRowMask] : 0.0f;
    srt[radix_position<T>(e1 >> (kRowBits + 5), cnt)] =
        make_int2(e1, __float_as_int(w1));
    __syncthreads();

    // 3. Segmented sums over the sorted chunk. Each run's (1 - w) sum goes
    //    into its table row, its w sum into the next: at once where no
    //    other thread adds into that cell before the next barrier.
    const int pb = walker ? gstart[grp] : 0;
    const int pe = walker ? gstart[grp + 1] : 0;
    int cur = -1;
    float s0 = 0.0f;
    float s1 = 0.0f;
    bool pending = false;
    if (pb < pe) {
      bool head = pb > 0 && (srt[pb - 1].x >> kRowBits) ==
                                (srt[pb].x >> kRowBits);
      for (int p = pb; p < pe; ++p) {
        const int2 e = srt[p];
        const int a = e.x >> kRowBits;
        if (a != cur) {
          if (cur >= 0) {
            if (head) {
              carry0[tid] = s0;
              carry1[tid] = s1;
              head = false;
            } else {
              add_to(&table[cur * wd + col], s0);
              add_to(&table[(cur + 1) * wd + col], s1);
            }
          }
          cur = a;
          s0 = 0.0f;
          s1 = 0.0f;
        }
        const float gv = gb[(e.x & kRowMask) * wd + col];
        const float wv = __int_as_float(e.y);
        s0 = __fadd_rn(s0, __fmul_rn(gv, __fsub_rn(1.0f, wv)));
        s1 = __fadd_rn(s1, __fmul_rn(gv, wv));
      }
      const int next = pe < m ? srt[pe].x >> kRowBits : -1;
      if (head) {
        carry0[tid] = s0;
        carry1[tid] = s1;
      } else if (next == cur) {
        pending = true;
      } else {
        add_to(&table[cur * wd + col], s0);
        if (next == cur + 1) {
          defer_row = cur + 1;
          defer_s1 = s1;
        } else {
          add_to(&table[(cur + 1) * wd + col], s1);
        }
      }
    }
    __syncthreads();
    if (pending) {
      // This thread's last run goes on into later ranges: their carries,
      // in range order.
      for (int g2 = grp + 1; g2 < groups; ++g2) {
        const int b2 = gstart[g2];
        if (b2 == gstart[g2 + 1]) continue;
        if ((srt[b2].x >> kRowBits) != cur) break;
        s0 = __fadd_rn(s0, carry0[g2 * wd + col]);
        s1 = __fadd_rn(s1, carry1[g2 * wd + col]);
      }
      add_to(&table[cur * wd + col], s0);
      defer_row = cur + 1;
      defer_s1 = s1;
    }
  }
  __syncthreads();
  if (defer_row >= 0) add_to(&table[defer_row * wd + col], defer_s1);

  // 4. The cluster's tables summed in rank order, a slice of cells a block.
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int nc = gridDim.x / cs;
  const int cl = blockIdx.x / cs;
  const int cells = k * wd;
  const int per = (cells + cs - 1) / cs;
  const int e0 = rank * per;
  const int e1 = min(cells, e0 + per);
  const size_t table_stride = static_cast<size_t>(k) * ct;
  float* const part = partials + (static_cast<size_t>(tile) * nc) *
                                     table_stride;
  cluster.sync();
  for (int e = e0 + tid; e < e1; e += T) {
    float s = cluster.map_shared_rank(table, 0)[e];
    for (int r = 1; r < cs; ++r) {
      s = __fadd_rn(s, cluster.map_shared_rank(table, r)[e]);
    }
    if (nc == 1) {
      const int j = e / wd;
      grad[static_cast<size_t>(j) * c + c0 + (e - j * wd)] = s;
    } else {
      part[cl * table_stride + e] = s;
    }
  }
  if (nc > 1) __threadfence();
  cluster.sync();
  if (nc == 1) return;
  if (rank == 0 && tid == 0) {
    __threadfence();
    s_last = atomicAdd(&g_bwd_tickets[tile], 1u) ==
             static_cast<unsigned>(nc - 1);
  }
  cluster.sync();
  const int last = *cluster.map_shared_rank(&s_last, 0);
  cluster.sync();
  if (!last) return;
  __threadfence();
  for (int e = e0 + tid; e < e1; e += T) {
    const float* const src = part + e;
    float s = __ldcg(src);
    for (int q = 1; q < nc; ++q) {
      s = __fadd_rn(s, __ldcg(src + q * table_stride));
    }
    const int j = e / wd;
    grad[static_cast<size_t>(j) * c + c0 + (e - j * wd)] = s;
  }
  if (rank == 0 && tid == 0) g_bwd_tickets[tile] = 0u;
}

int smem_optin() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess) {
      bytes = 48 * 1024;
    }
  }
  return bytes;
}

int smem_per_sm() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&bytes,
                               cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                               dev) != cudaSuccess) {
      bytes = 64 * 1024;
    }
  }
  return bytes;
}

// Dynamic shared memory of a block of `threads`: its table, two chunks of
// g, i0 and w, and the sort's and the walk's arrays.
size_t backward_smem(int k, int ct, int chunk, int threads) {
  return 4 * (static_cast<size_t>((k * ct + 3) & ~3) +
              2 * static_cast<size_t>(chunk) * ct + 4 * chunk +
              7 * threads + 4);
}

struct BwdPlan {
  int threads;         // threads a block
  int ct;              // columns a tile
  int tiles;           // column tiles (grid.y)
  int chunk;           // rows a chunk
  int rows_per_block;
  int cluster;         // blocks a cluster
  int clusters;        // clusters a tile (grid.x = clusters * cluster)
  int per_sm;          // blocks an SM
  size_t smem;
  bool card_bound;     // as many blocks as the card holds (n is large)
};

template <int T>
bool opt_in_backward() {
  static bool done = false;   // once: the card's whole opt-in size
  if (!done) {
    if (cudaFuncSetAttribute(dense_interp_backward_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_optin() - 1024) != cudaSuccess) {
      return false;
    }
    done = true;
  }
  return true;
}

int round_up(long long v, int to) {
  return static_cast<int>((v + to - 1) / to * to);
}

// Fills `p` for (k, c, n) with blocks of T threads: a function of the shape
// and the card alone, so every launch of one shape sums in one order.
// False if the kernel cannot take the shape.
template <int T>
bool plan_threads(int k, int c, int n, BwdPlan* p) {
  if (k < 2 || k > kBwdMaxK || c < 1 || n < 0 || !opt_in_backward<T>()) {
    return false;
  }
  const size_t block_max = static_cast<size_t>(smem_optin()) - 1024;
  p->threads = T;
  p->ct = c < kBwdMaxCols ? c : kBwdMaxCols;
  while (p->ct > 1 && backward_smem(k, p->ct, 32, T) > block_max) {
    p->ct = (p->ct + 1) / 2;
  }
  if (backward_smem(k, p->ct, 32, T) > block_max) return false;
  p->tiles = (c + p->ct - 1) / p->ct;
  if (p->tiles > kMaxTiles) return false;
  // Rows a chunk (at most one a thread) and blocks an SM: the most rows in
  // flight an SM.
  const size_t fixed = backward_smem(k, p->ct, 0, T);
  const size_t row_bytes = backward_smem(k, p->ct, 1, T) - fixed;
  p->per_sm = 0;
  p->chunk = 0;
  for (int b = 1; b <= 2048 / T; ++b) {
    const size_t room = static_cast<size_t>(smem_per_sm()) / b - 1024 - 128;
    const size_t cap = room < block_max ? room : block_max;
    if (cap < fixed + 32 * row_bytes) break;
    long long rows = static_cast<long long>((cap - fixed) / row_bytes);
    rows = (rows < T ? rows : T) / 32 * 32;
    int occ = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occ, dense_interp_backward_kernel<T>, T,
            backward_smem(k, p->ct, static_cast<int>(rows), T)) !=
            cudaSuccess ||
        occ < b) {
      break;
    }
    if (b * rows > static_cast<long long>(p->per_sm) * p->chunk) {
      p->per_sm = b;
      p->chunk = static_cast<int>(rows);
    }
  }
  if (p->per_sm == 0) return false;
  // Blocks a tile: all the card holds at once, fewer for small n; whole
  // clusters, of the largest size that keeps at least 90% of those blocks
  // on the card at once.
  const int slots = p->per_sm * sm_count() / p->tiles;
  const long long want = (static_cast<long long>(n) + kMinRowsPerBlock - 1) /
                         kMinRowsPerBlock;
  p->card_bound = want >= slots;
  long long blocks = want < slots ? want : slots;
  if (blocks < 1) blocks = 1;
  const size_t smem = backward_smem(k, p->ct, p->chunk, T);
  for (int cs = kMaxClusterBlocks; cs >= 1; cs /= 2) {
    const int size = blocks < cs ? static_cast<int>(blocks) : cs;
    long long grid = round_up(blocks, size);
    if (grid > slots && grid > size) grid -= size;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(grid), p->tiles);
    cfg.blockDim = dim3(T);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = size;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int fit = 0;
    if (cudaOccupancyMaxActiveClusters(&fit, dense_interp_backward_kernel<T>,
                                       &cfg) != cudaSuccess) {
      return false;
    }
    long long resident = static_cast<long long>(fit / p->tiles) * size;
    if (resident < size) resident = size;
    const long long use = grid < resident ? grid : resident;
    if (10 * use >= 9 * blocks || size == 1) {
      p->cluster = size;
      blocks = use;
      break;
    }
  }
  // Rows a block, and chunks of equal size.
  long long rpb = round_up((static_cast<long long>(n) + blocks - 1) / blocks,
                           32);
  if (rpb < 32) rpb = 32;
  const long long per_block = (rpb + p->chunk - 1) / p->chunk;
  p->chunk = round_up((rpb + per_block - 1) / per_block, 32);
  p->rows_per_block = static_cast<int>(rpb);
  long long used = (static_cast<long long>(n) + rpb - 1) / rpb;
  if (used < 1) used = 1;
  p->clusters = static_cast<int>((used + p->cluster - 1) / p->cluster);
  p->smem = backward_smem(k, p->ct, p->chunk, T);
  return true;
}

// Blocks of 256 threads where a tile has at most 16 columns and n fills
// the card (more blocks an SM overlap their barriers; measured faster
// there, slower at 32 columns and for small n: PERF.md), else 512.
bool plan_backward_uncached(int k, int c, int n, BwdPlan* p) {
  if (plan_threads<256>(k, c, n, p) && p->ct <= 16 && p->card_bound) {
    return true;
  }
  return plan_threads<512>(k, c, n, p);
}

// The last plan, so that the scratch query and the launch after it plan
// once (the plan queries the occupancy API).
bool plan_backward(int k, int c, int n, BwdPlan* p) {
  static std::mutex mu;
  static int key[3] = {-1, -1, -1};
  static BwdPlan last;
  std::lock_guard<std::mutex> lock(mu);
  if (key[0] != k || key[1] != c || key[2] != n) {
    if (!plan_backward_uncached(k, c, n, &last)) return false;
    key[0] = k;
    key[1] = c;
    key[2] = n;
  }
  *p = last;
  return true;
}

}  // namespace

// C interface, bound with ctypes. Pointers are device pointers: tables
// (k, c) float32 row-major, i0 (n,) int32, w (n,) float32, out (n, c)
// float32. Needs 2 <= k and 1 <= c and n * c < 2^31. Launches on `stream`
// and returns cudaGetLastError() of the launch (0 on success). Does not
// synchronise.
extern "C" int crt_dense_interp(const float* tables, int k, int c,
                                const int* i0, const float* w, int n,
                                float* out, void* stream) {
  if (k < 2 || c < 1 || n < 0 ||
      static_cast<long long>(n) * c >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  return launch(tables, k, c, i0, w, n, out,
                static_cast<cudaStream_t>(stream));
}


// Floats of scratch crt_dense_interp_backward needs for (k, c, n): the
// cluster partials (0 when one cluster covers the rows). -1 if the kernel
// cannot take the shape (k above 1,024, or no tile fits in shared memory).
extern "C" long long crt_dense_interp_backward_scratch(int k, int c, int n) {
  BwdPlan p;
  if (!plan_backward(k, c, n, &p)) return -1;
  return p.clusters > 1 ? static_cast<long long>(p.tiles) * p.clusters * k *
                              p.ct
                        : 0;
}

// The plan of a shape, for the record: fills out[9] with threads a block,
// columns a tile, tiles, rows a chunk, rows a block, blocks a cluster,
// clusters a tile, blocks an SM and dynamic shared memory bytes. -1 as the
// scratch query.
extern "C" int crt_dense_interp_backward_plan(int k, int c, int n,
                                              long long* out) {
  BwdPlan p;
  if (!plan_backward(k, c, n, &p)) return -1;
  const long long v[9] = {p.threads, p.ct, p.tiles, p.chunk,
                          p.rows_per_block, p.cluster, p.clusters, p.per_sm,
                          static_cast<long long>(p.smem)};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// The table gradient of crt_dense_interp: grad (k, c) float32 from the
// output gradient g (n, c) float32 and the forward's i0 (n,) int32 and w
// (n,) float32 (device pointers, row-major). `scratch` holds
// crt_dense_interp_backward_scratch(k, c, n) floats. Writes every cell of
// grad (zeros where no row lands). Launches one kernel on `stream` and
// returns cudaGetLastError() (0 on success). Does not synchronise. Launches
// on two streams must not overlap in time: they share the ticket counters.
extern "C" int crt_dense_interp_backward(const float* g, int k, int c,
                                         const int* i0, const float* w, int n,
                                         float* grad, float* scratch,
                                         void* stream) {
  BwdPlan p;
  if (k < 2 || c < 1 || n < 0 ||
      static_cast<long long>(n) * c >= (1LL << 31) ||
      !plan_backward(k, c, n, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) {
    return static_cast<int>(cudaMemsetAsync(
        grad, 0, static_cast<size_t>(k) * c * sizeof(float), s));
  }
  // Bulk copies need 16-byte aligned inputs; chunks start at multiples of
  // 32 rows, and a tile's rows at multiples of 4 columns when c is.
  const bool bulk = aligned16(g) && aligned16(i0) && aligned16(w);
  const int mode = !bulk                              ? kCopyScalar
                   : p.tiles == 1                     ? kCopySpan
                   : c % 4 == 0 && p.ct % 4 == 0      ? kCopyRows
                                                      : kCopyScalar;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.clusters * p.cluster),
                     static_cast<unsigned>(p.tiles));
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg,
      p.threads == 256 ? dense_interp_backward_kernel<256>
                       : dense_interp_backward_kernel<512>,
      g, k, c, i0, w, n, p.ct, p.chunk, p.rows_per_block, mode, scratch,
      grad);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
