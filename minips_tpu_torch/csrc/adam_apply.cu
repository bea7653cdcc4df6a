// The donated Adam update of a dense table's flat vector, in one pass, for
// Hopper (sm_90a). For each i < n, with g = grad[i]:
//
//   m = (1 - b1) g + b1 m;   v = (1 - b2) g g + b2 v
//   p = p + (-lr) ((m / bc1) / (sqrt(v / bc2) + eps))
//
// where bc1 = 1 - b1^t and bc2 = 1 - b2^t are 0-d float32 tensors on the
// card, computed by PyTorch from Adam's int32 step count.
//
// Replaces no Pallas kernel: the JAX package leaves Adam to XLA, which fuses
// optax's update into its step. It replaces the port's plain donated update
// (minips_tpu_torch/tables/updaters.py: scale_by_adam's update_, then
// scale_by_learning_rate's (-lr) * g and DenseTable.make_step's
// params.add_): some fourteen elementwise kernels, each a pass over one to
// three table-sized vectors, about 250 GB of device traffic a step for
// GPT-2 XL's 1,556,920,000 parameters; and, at one shard, make_step's
// zero-filled padded copy of the gradient and its divide by one (adam's
// table has no padding there: the raveled gradient is the params' length).
//
// What bounds it: memory. Per parameter it reads g, p, m and v and writes
// p, m and v once: 28 bytes, 43.6 GB at GPT-2 XL's size, 13.0 ms at 3.35
// TB/s; 70.7 GB and 21.1 ms at LFM2's 2,526,624,512 held parameters.
//
// The design:
// 1. One grid-stride pass over a grid of as many blocks of kThreads as the
//    SMs hold at once (the occupancy the runtime reports, at most a full
//    SM's threads), so that no block waits for a second wave; each thread
//    keeps four 16-byte loads in flight an iteration, far more bytes than
//    the card's latency needs.
// 2. 16-byte accesses (float4) where the four vectors share their offset
//    modulo 16 bytes: a scalar head of up to three elements brings p to a
//    16-byte boundary and a scalar tail ends it. Where the offsets differ,
//    one scalar pass.
// 3. g and p are loaded, and p, m and v stored, with the streaming hint
//    (ld.global.cs, st.global.cs): none of them is read again this step.
// 4. The same float32 arithmetic in the same order as the plain update,
//    with its float32 constants (b1, 1 - b1, b2, 1 - b2, eps and -lr, each
//    rounded from the Python double as PyTorch rounds a scalar), written
//    with round-to-nearest intrinsics so that nvcc contracts no multiply
//    and add into one rounding: the result is bitwise the plain update's.
// 5. The bias corrections are read through device pointers, so that the
//    host reads nothing and a captured CUDA graph replays the kernel with
//    each step's own count.
//
// Plain C interface (built with nvcc into a shared library, bound with
// ctypes): launches on the given stream, allocates nothing, synchronises
// nothing, and returns cudaGetLastError() after the launch.

#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Coeffs {
  float b1, c1, b2, c2, eps, neg_lr;
};

__device__ __forceinline__ void adam(float& p, float& m, float& v, float g,
                                     const Coeffs& k, float bc1, float bc2) {
  m = __fadd_rn(__fmul_rn(g, k.c1), __fmul_rn(m, k.b1));
  v = __fadd_rn(__fmul_rn(__fmul_rn(g, g), k.c2), __fmul_rn(v, k.b2));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), k.eps);
  const float u = __fdiv_rn(__fdiv_rn(m, bc1), den);
  p = __fadd_rn(p, __fmul_rn(k.neg_lr, u));
}

__device__ __forceinline__ void adam_at(const float* __restrict__ g,
                                        float* __restrict__ p,
                                        float* __restrict__ m,
                                        float* __restrict__ v, int64_t i,
                                        const Coeffs& k, float bc1,
                                        float bc2) {
  float pi = __ldcs(p + i), mi = m[i], vi = v[i];
  adam(pi, mi, vi, __ldcs(g + i), k, bc1, bc2);
  __stcs(p + i, pi);
  __stcs(m + i, mi);
  __stcs(v + i, vi);
}

// Elements [0, head) and [head + 4 * quads, n) one at a time, the quads
// between them as float4; head = 0 and quads = 0 is the scalar pass.
__global__ void __launch_bounds__(kThreads)
adam_apply_kernel(const float* __restrict__ g, float* __restrict__ p,
                  float* __restrict__ m, float* __restrict__ v, int64_t n,
                  int64_t head, int64_t quads,
                  const float* __restrict__ bc1_ptr,
                  const float* __restrict__ bc2_ptr, Coeffs k) {
  const float bc1 = *bc1_ptr;
  const float bc2 = *bc2_ptr;
  const int64_t tid = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  const int64_t tail = head + 4 * quads;
  if (tid < head) adam_at(g, p, m, v, tid, k, bc1, bc2);
  for (int64_t i = tail + tid; i < n; i += stride) {
    adam_at(g, p, m, v, i, k, bc1, bc2);
  }
  const float4* g4 = reinterpret_cast<const float4*>(g + head);
  float4* p4 = reinterpret_cast<float4*>(p + head);
  float4* m4 = reinterpret_cast<float4*>(m + head);
  float4* v4 = reinterpret_cast<float4*>(v + head);
  for (int64_t q = tid; q < quads; q += stride) {
    const float4 gq = __ldcs(g4 + q);
    float4 pq = __ldcs(p4 + q);
    float4 mq = m4[q];
    float4 vq = v4[q];
    adam(pq.x, mq.x, vq.x, gq.x, k, bc1, bc2);
    adam(pq.y, mq.y, vq.y, gq.y, k, bc1, bc2);
    adam(pq.z, mq.z, vq.z, gq.z, k, bc1, bc2);
    adam(pq.w, mq.w, vq.w, gq.w, k, bc1, bc2);
    __stcs(p4 + q, pq);
    __stcs(m4 + q, mq);
    __stcs(v4 + q, vq);
  }
}

uintptr_t addr(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr); }

}  // namespace

// g, p, m, v: [n] float32; bc1, bc2: one float32 each on the card. All
// contiguous, on the current device. b1, c1 = 1 - b1, b2, c2 = 1 - b2, eps
// and neg_lr = -lr as float32.
extern "C" int adam_apply_launch(const void* g, void* p, void* m, void* v,
                                 long long n, const void* bc1,
                                 const void* bc2, float b1, float c1,
                                 float b2, float c2, float eps, float neg_lr,
                                 void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  for (const void* ptr : {g, static_cast<const void*>(p),
                          static_cast<const void*>(m),
                          static_cast<const void*>(v), bc1, bc2}) {
    if (addr(ptr) % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, adam_apply_kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t off = addr(p) % 16;
  int64_t head = 0, quads = 0;
  if (addr(g) % 16 == off && addr(m) % 16 == off && addr(v) % 16 == off) {
    head = static_cast<int64_t>((16 - off) % 16 / 4);
    if (head > n) head = n;
    quads = (n - head) / 4;
  }
  const int64_t work = quads + (n - head - 4 * quads);  // items a thread
  const int64_t need = (work + kThreads - 1) / kThreads;
  const int64_t wave = int64_t(sms) * (per_sm < 1 ? 1 : per_sm);
  const unsigned blocks =
      static_cast<unsigned>(need < 1 ? 1 : (need < wave ? need : wave));
  const Coeffs k{b1, c1, b2, c2, eps, neg_lr};
  adam_apply_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<float*>(p),
      static_cast<float*>(m), static_cast<float*>(v), n, head, quads,
      static_cast<const float*>(bc1), static_cast<const float*>(bc2), k);
  return static_cast<int>(cudaGetLastError());
}
