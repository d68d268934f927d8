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
//   directly and keeps float32 exactly. One thread per output element with a
//   grid-stride loop: neighbouring threads write neighbouring elements of the
//   row-major (n, C) output, so every store is coalesced, and the i0/w loads
//   of one row are shared through L1 by the C threads that need them. The
//   grid is capped at 8 blocks per SM, so each block stages the table in
//   shared memory once (K * C * 4 bytes: 9.4 KB at C = 5) and reuses it for
//   many rows; a table above 48 KB (C = 128 is 241 KB) is read through the
//   read-only cache (__ldg) instead.
//
// Numerics: __fadd_rn(__fmul_rn(v0, __fsub_rn(1, w)), __fmul_rn(v1, w)),
//   which nvcc never contracts into FMA, in the operation order of the plain
//   PyTorch version (interp_kernel.dense_interp_plain), so the two agree bit
//   for bit. Both clamp i0 to [0, K-2], so they compute one function on any
//   index and the kernel never reads outside the table.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxSharedTableBytes = 48 * 1024;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
dense_interp_kernel(const float* __restrict__ tables, int k, int c,
                    const int* __restrict__ i0, const float* __restrict__ w,
                    int n, float* __restrict__ out) {
  extern __shared__ float s_table[];
  const float* table = tables;
  if (kShared) {
    for (int j = threadIdx.x; j < k * c; j += kThreads) {
      s_table[j] = __ldg(&tables[j]);
    }
    __syncthreads();
    table = s_table;
  }
  const unsigned total = static_cast<unsigned>(n) * static_cast<unsigned>(c);
  const unsigned stride = gridDim.x * kThreads;
  for (unsigned e = blockIdx.x * kThreads + threadIdx.x; e < total;
       e += stride) {
    const unsigned r = e / static_cast<unsigned>(c);
    const unsigned col = e - r * static_cast<unsigned>(c);
    const int row = min(max(__ldg(&i0[r]), 0), k - 2);
    const float wr = __ldg(&w[r]);
    const int a = row * c + static_cast<int>(col);
    float v0, v1;
    if (kShared) {
      v0 = table[a];
      v1 = table[a + c];
    } else {
      v0 = __ldg(&table[a]);
      v1 = __ldg(&table[a + c]);
    }
    out[e] = __fadd_rn(__fmul_rn(v0, __fsub_rn(1.0f, wr)), __fmul_rn(v1, wr));
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
  const long long total = static_cast<long long>(n) * c;
  const long long want = (total + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSm;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long table_bytes =
      static_cast<long long>(k) * c * static_cast<long long>(sizeof(float));
  if (table_bytes <= kMaxSharedTableBytes) {
    dense_interp_kernel<true><<<blocks, kThreads,
                                static_cast<size_t>(table_bytes), s>>>(
        tables, k, c, i0, w, n, out);
  } else {
    dense_interp_kernel<false><<<blocks, kThreads, 0, s>>>(
        tables, k, c, i0, w, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
