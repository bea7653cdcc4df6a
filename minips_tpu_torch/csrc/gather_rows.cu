// Row gather for Hopper (sm_90a): out[i, :] = emb[clamp(slots[i], 0, S-1), :].
//
// Replaces minips_tpu/ops/pallas_kernels.py:_gather_kernel, the TPU's
// embedding lookup by scalar-prefetched slot ids and per-row HBM->VMEM DMAs
// in 8-row blocks. That design follows the TPU (a sequential grid, the
// (8, 128) tile, semaphores); none of it carries over. Here every block
// loads its own indices and the copy is a plain coalesced load/store.
//
// What bounds it: memory. For each index it reads 4 bytes of index and
// D * itemsize bytes of row, and writes D * itemsize bytes; there is no
// arithmetic to speak of. The design moves each row as the widest aligned
// words the row allows (16, 8, 4, 2 or 1 bytes), one word per thread, so
// neighbouring threads touch neighbouring addresses of one row and of the
// output, and a row of D = 8 f32 is two 16-byte loads. A copy is bit-exact,
// so the kernel takes any element type by its byte width, at any D and N.
//
// The clamp matches XLA's out-of-range gather; hashed slots are always in
// range, so on the training path it never changes a value.
//
// Plain C interface (built with nvcc into a shared library, bound with
// ctypes): launches on the given stream, allocates nothing, synchronises
// nothing, and returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename Word>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const Word* __restrict__ emb,
                   const int32_t* __restrict__ slots,
                   Word* __restrict__ out,
                   int64_t n_words,       // N * words_per_row
                   int64_t num_rows,      // S
                   int32_t words_per_row) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       t < n_words; t += stride) {
    const int64_t i = t / words_per_row;
    const int32_t c = static_cast<int32_t>(t - i * words_per_row);
    int64_t r = __ldg(slots + i);
    r = r < 0 ? 0 : (r >= num_rows ? num_rows - 1 : r);
    out[t] = __ldg(emb + r * words_per_row + c);
  }
}

template <typename Word>
cudaError_t launch(const void* emb, const int32_t* slots, void* out,
                   int64_t n, int64_t num_rows, int64_t row_bytes,
                   cudaStream_t stream) {
  const int64_t words_per_row = row_bytes / static_cast<int64_t>(sizeof(Word));
  const int64_t n_words = n * words_per_row;
  // enough blocks to fill the card many times over; the loop covers the rest
  const int64_t want = (n_words + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
  gather_rows_kernel<Word><<<blocks, kThreads, 0, stream>>>(
      static_cast<const Word*>(emb), slots, static_cast<Word*>(out), n_words,
      num_rows, static_cast<int32_t>(words_per_row));
  return cudaGetLastError();
}

bool aligned(const void* p, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

}  // namespace

extern "C" int gather_rows_launch(const void* emb, const void* slots,
                                  void* out, long long n, long long num_rows,
                                  long long row_bytes, void* stream) {
  // words_per_row must fit the kernel's int32 column index
  if (n <= 0 || num_rows <= 0 || row_bytes <= 0 || row_bytes >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int32_t* idx = static_cast<const int32_t*>(slots);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (row_bytes % 16 == 0 && aligned(emb, 16) && aligned(out, 16)) {
    err = launch<uint4>(emb, idx, out, n, num_rows, row_bytes, s);
  } else if (row_bytes % 8 == 0 && aligned(emb, 8) && aligned(out, 8)) {
    err = launch<uint2>(emb, idx, out, n, num_rows, row_bytes, s);
  } else if (row_bytes % 4 == 0 && aligned(emb, 4) && aligned(out, 4)) {
    err = launch<uint32_t>(emb, idx, out, n, num_rows, row_bytes, s);
  } else if (row_bytes % 2 == 0 && aligned(emb, 2) && aligned(out, 2)) {
    err = launch<uint16_t>(emb, idx, out, n, num_rows, row_bytes, s);
  } else {
    err = launch<uint8_t>(emb, idx, out, n, num_rows, row_bytes, s);
  }
  return static_cast<int>(err);
}
