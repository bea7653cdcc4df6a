// Row-wise Adagrad over the k distinct rows of a sort-dedup push, for
// Hopper (sm_90a). For i < k, with r = rows[i] and g = g_sum[i, :]:
//
//   acc = accum[r] + g * g;   accum[r] = acc;
//   emb[r] = emb[r] + (-lr * g) / (sqrt(acc) + eps)
//
// Replaces no Pallas kernel: the JAX package leaves this update to XLA's
// scatter (minips_tpu/ops/sparse_update.py). It replaces the plain tail of
// the port's sort-dedup Adagrad (minips_tpu_torch/ops/sparse_update.py,
// _row_adagrad_sorted_reference): a gather of the rows' accumulators, five
// elementwise passes and two index_add_ scatters, all issued with the
// push's n entries, because the dedup keeps the JAX package's static
// length. Only the first k entries are rows; the rest add zero onto row 0,
// and on the card their atomics contend on that one row (at the CTR's
// push, n = 3,407,872 entries for k ~ 468,000 rows).
//
// What bounds it: memory. Per row it reads the index (4 or 8 bytes) and D
// floats each of gradient, emb and accum, and writes emb and accum: at
// D = 8 with int32 rows, k x (4 + 3 x 32 + 2 x 32) bytes, 77 MB at the
// CTR's push, 23 us at 3.35 TB/s. The rows lie scattered over a table far
// larger than L2, so each row is an access of its own in each of the two
// tables, read and later written back: their rate, not the bytes, sets
// the time. Measured on an NVIDIA H100 80GB HBM3 at 700 W: 0.086 ms at the
// CTR's push (468,502 rows, 27% of the byte bound), about 5.4 G rows a
// second, and 5.9 G a second at 1.74 M rows (PERF.md section 6).
//
// The design:
// 1. It walks only the k valid rows, and k stays on the card: the kernel
//    reads it from the dedup's 0-d count, so the host never syncs for it
//    and keeps its launch queue full. The grid is sized by n, the static
//    upper bound, capped at kBlocksPerSm blocks of kThreads a SM, and its
//    lane groups walk the rows grid-stride up to k; a grid of n's size
//    would spend most of its blocks reading k and leaving. (The float4
//    kernels take 40 registers, so 6 of the 8 blocks are resident at once;
//    launch bounds that force 8 spill and measured 9% slower.)
// 2. No atomics: after the dedup rows[0:k] are distinct, so one lane group
//    loads, updates and stores each row with plain loads and stores.
// 3. 16-byte accesses (float4) where D % 4 == 0 and the three tables are
//    16-byte aligned, 4-byte otherwise, so that any D works. A lane group
//    of the next power of two >= the row's words (at most a warp) shares a
//    row, neighbouring lanes on neighbouring words; only shifts and masks,
//    no division by a runtime value.
// 4. The same float32 arithmetic in the same order as the plain version,
//    written with round-to-nearest intrinsics so that nvcc fuses no
//    multiply-add: the plain version adds each row's delta once and its
//    tail adds exact zeros, so the result is bitwise the plain version's.
// 5. A row outside [0, S) is left alone, as XLA drops an out-of-range
//    update; hashed slots are always in range.
//
// Plain C interface (built with nvcc into a shared library, bound with
// ctypes): launches on the given stream, allocates nothing, synchronises
// nothing, and returns cudaGetLastError() after the launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ void adagrad(float& w, float& a, float g,
                                        float neg_lr, float eps) {
  const float acc = __fadd_rn(a, __fmul_rn(g, g));
  a = acc;
  w = __fadd_rn(w, __fdiv_rn(__fmul_rn(neg_lr, g),
                             __fadd_rn(__fsqrt_rn(acc), eps)));
}

__device__ __forceinline__ void adagrad(float4& w, float4& a, float4 g,
                                        float neg_lr, float eps) {
  adagrad(w.x, a.x, g.x, neg_lr, eps);
  adagrad(w.y, a.y, g.y, neg_lr, eps);
  adagrad(w.z, a.z, g.z, neg_lr, eps);
  adagrad(w.w, a.w, g.w, neg_lr, eps);
}

// Word is float or float4; a row is `words` Words. A lane group of
// 2^shift lanes takes a row; the grid's groups walk rows [0, k).
template <typename Word, typename Index>
__global__ void __launch_bounds__(kThreads)
row_adagrad_kernel(Word* __restrict__ emb, Word* __restrict__ accum,
                   const Index* __restrict__ rows,
                   const Word* __restrict__ g_sum,
                   const int64_t* __restrict__ k_ptr, int64_t n,
                   int64_t num_rows, int words, int shift, float neg_lr,
                   float eps) {
  const int64_t k_read = *k_ptr;
  const int64_t k = k_read < n ? k_read : n;
  const int width = 1 << shift;
  const int lane = threadIdx.x & (width - 1);
  const int64_t groups = int64_t(kThreads >> shift);
  const int64_t stride = groups * gridDim.x;
  for (int64_t i = groups * blockIdx.x + (threadIdx.x >> shift); i < k;
       i += stride) {
    const int64_t r = rows[i];
    if (r < 0 || r >= num_rows) continue;
    Word* w = emb + r * words;
    Word* a = accum + r * words;
    const Word* g = g_sum + i * words;
    for (int c = lane; c < words; c += width) {
      Word wv = w[c];
      Word av = a[c];
      adagrad(wv, av, __ldcs(g + c), neg_lr, eps);  // g_sum: read once
      a[c] = av;
      w[c] = wv;
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename Word, typename Index>
cudaError_t launch(void* emb, void* accum, const void* rows,
                   const void* g_sum, const void* k, int64_t n,
                   int64_t num_rows, int words, float lr, float eps,
                   cudaStream_t stream) {
  int shift = 0;  // lanes a row: the next power of two, at most a warp
  while (shift < 5 && (1 << shift) < words) ++shift;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return err;
  const int64_t groups = kThreads >> shift;
  const int64_t wave = int64_t(sms) * kBlocksPerSm;
  const int64_t need = (n + groups - 1) / groups;
  row_adagrad_kernel<Word, Index>
      <<<static_cast<unsigned>(need < wave ? need : wave), kThreads, 0,
         stream>>>(static_cast<Word*>(emb), static_cast<Word*>(accum),
                   static_cast<const Index*>(rows),
                   static_cast<const Word*>(g_sum),
                   static_cast<const int64_t*>(k), n, num_rows, words, shift,
                   -lr, eps);
  return cudaGetLastError();
}

template <typename Index>
cudaError_t dispatch(void* emb, void* accum, const void* rows,
                     const void* g_sum, const void* k, int64_t n,
                     int64_t num_rows, int64_t dim, float lr, float eps,
                     cudaStream_t stream) {
  if (dim % 4 == 0 && aligned(emb, 16) && aligned(accum, 16) &&
      aligned(g_sum, 16)) {
    return launch<float4, Index>(emb, accum, rows, g_sum, k, n, num_rows,
                                 static_cast<int>(dim / 4), lr, eps, stream);
  }
  return launch<float, Index>(emb, accum, rows, g_sum, k, n, num_rows,
                              static_cast<int>(dim), lr, eps, stream);
}

}  // namespace

// emb, accum: [num_rows, dim] float32; rows: [n] int32 (index_bytes 4) or
// int64 (8), whose first k entries are distinct; g_sum: [n, dim] float32;
// k: one int64 on the card. All contiguous, on the current device.
extern "C" int row_adagrad_launch(void* emb, void* accum, const void* rows,
                                  int index_bytes, const void* g_sum,
                                  const void* k, long long n,
                                  long long num_rows, long long dim,
                                  float lr, float eps, void* stream) {
  if (n <= 0 || num_rows <= 0 || dim <= 0 || dim >= (1LL << 31) ||
      !aligned(emb, 4) || !aligned(accum, 4) || !aligned(g_sum, 4) ||
      !aligned(k, 8) || (index_bytes != 4 && index_bytes != 8) ||
      !aligned(rows, index_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      index_bytes == 4
          ? dispatch<int32_t>(emb, accum, rows, g_sum, k, n, num_rows, dim,
                              lr, eps, s)
          : dispatch<int64_t>(emb, accum, rows, g_sum, k, n, num_rows, dim,
                              lr, eps, s);
  return static_cast<int>(err);
}
