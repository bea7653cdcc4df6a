// Flash attention for Hopper (sm_90a): the forward (K2) and the two
// backward kernels (K3: dQ, K4: dK and dV) of the port's attention.
//
// Replaces, in minips_tpu/ops/flash_attention.py:
//   K2 _flash_kernel          O = softmax(Q K^T * scale) V and lse per row
//   K3 _flash_bwd_dq_kernel   dQ = sum_k ds K
//   K4 _flash_bwd_dkv_kernel  dV = sum p^T dO, dK = sum ds^T Q over the group
// with p = exp(s - lse), ds = p * (dO V^T - dvec) * scale and
// dvec = rowsum(dO * O) - (cotangent of lse), formed by the caller.
//
// The TPU kernels walk a sequential grid and carry the online-softmax state
// (or the dQ / dK / dV sums) in VMEM from one grid step to the next. Here a
// thread block owns one output tile and loops over the other side's tiles
// itself: K2 and K3 one block per (Q tile, q head, batch) looping over K
// tiles; K4 one block per (K tile, kv head, batch) looping over all g * nQ
// (q head of its group, Q tile) pairs, as the TPU grid does. Every output
// element is written once by one block: no atomics, and the sums run in a
// fixed order.
//
// What bounds them on this card: at the LM's shape (T = 1024, head dim 64,
// causal) K2 does 4 D = 256, K3 6 D = 384 and K4 8 D = 512 flops per live
// (query, key) pair against ~4 T D bytes per (batch, head), 68.8, 103.2 and
// 137.6 GFLOP against 270, 340 and 407 MB at B 16 x 32 heads: ~250 to ~340
// flops per byte, at the H100's ridge (989 TFLOP/s over 3.35 TB/s, ~295).
// The bf16 tensor cores bound them, and behind them the special-function
// unit: one exp per pair costs as many SM cycles as the 4 D flops of K2's
// products.
//
// bf16 K2 and K3 (flash_fwd_wgmma_kernel, flash_bwd_dq_wgmma_kernel) are
// built for that:
//   - a block of 288 threads: two consumer warpgroups, each owning 64 rows
//     of a 128-row Q tile, and one producer warp that starts every load;
//   - the Q tile (and K3's dO tile) is loaded once by TMA and stays in shared
//     memory; K and V tiles of 64 rows stream through a ring of stages (3 at
//     D <= 64, 2 at D <= 128), each stage guarded by a "full" mbarrier (TMA
//     byte count) and an "empty" one (one arrival per consumer warp), so the
//     next tiles load while the current one is multiplied;
//   - tiles are 128B-swizzled rows of 64 bf16 (one swizzle atom; D = 128 is
//     two atoms side by side), the layout both TMA and wgmma's B128
//     descriptors use; TMA zero-fills rows past T and columns past D, so a
//     ragged T and a head dim below the atom (D = 40 runs as 64) need no code;
//   - every product is wgmma m64n64k16, bf16 in and f32 accumulated in
//     registers: S = Q K^T (K2, K3) and dP = dO V^T (K3) with both operands
//     K-major in shared memory; O += P V (K2) and dQ += dS K (K3) with the
//     rounded P or dS as the register A operand, straight from the score
//     accumulator's fragment, and V or K read MN-major (transposed) from the
//     same stage;
//   - the online-softmax state (row max, partial row sums) lives in
//     registers: a row's 64 scores sit in one quad of 4 threads, so a row
//     max is two shuffles; exp is ex2.approx with log2(e) folded into the
//     scale (about an ulp from expf, before p's rounding);
//   - K tiles past the causal diagonal are never loaded, the element mask is
//     applied only on tiles that cross the diagonal or the ragged K tail, and
//     Q tiles launch longest first (grid z reversed), so short causal rows
//     fill the tail of the grid.
// bf16 K4 (flash_bwd_dkv_wgmma_kernel) is K3 on the transposed sweep, with
// the same block, ring and helpers: a 128-row K tile per block, K and V
// resident, 64-row Q and dO tiles of each (q head of the group, live Q
// tile) pair streamed through the stages; s^T = K Q^T and dp^T = V dO^T
// with keys as rows, so p^T and ds^T are the register A operands of
// dV += p^T dO and dK += ds^T Q (Q and dO read MN-major), and dK and dV
// stay in registers over the whole sweep. The per-query terms (-lse log2(e)
// and dvec) ride in each stage beside Q and dO, copied by the producer
// warp's lanes. The live Q tiles of a key start at the causal diagonal, so
// the sweep skips its head, not its tail; K tile 0 sees the most and
// launches first. A block that no query sees runs no tile and writes zeros.
// f32 inputs keep the first SIMT kernels (flash_fwd_kernel,
// flash_bwd_dq_kernel, flash_bwd_dkv_kernel): wgmma on f32 would be TF32,
// three decimal digits, which would miss the f32 tolerance of 1e-4 against
// the plain versions; the main path never sends f32 here. They stage
// 64 x 64 tiles in shared memory as f32, 256 threads each owning a 4 x 4
// micro-tile, dots as f32 FMAs, so the FMA pipes and shared-memory loads
// bound them.
//
// Numerics follow the TPU kernels so that the plain PyTorch versions in
// ops/flash_attention.py can be held tight:
//   - inputs are f32 or bf16; every dot sums bf16 x bf16 products (exact in
//     f32) in f32 (the tensor cores' f32 accumulation on the wgmma kernels),
//     and the softmax state and every accumulator are f32;
//   - p is rounded to the input type before P V, ds before dS K and dS^T Q,
//     p^T before P^T dO; the outputs are rounded to the input type once;
//   - the causal mask compares GLOBAL positions, q_off + i >= k_off + j, and
//     sets masked scores to -1e30; a masked entry's p is exactly 0, so a row
//     that sees no key gets O = 0, and ragged tails (rows past Tq, keys
//     past Tk) are masked the same way;
//   - K tiles the causal mask kills entirely are skipped (_block_live).
// Inputs are read in the [B, T, H, D] layout through the strides passed
// in, so no transpose is materialised; q head h reads kv head h / g, so the
// GQA repeat is never materialised (the bf16 kernels read them through TMA
// maps built per launch from the same pointers and strides). Any Tq and Tk;
// any D that is a multiple of 8 up to 128. The K tile is 64 rows everywhere,
// the plain forward's online-softmax tile on the card (KERNEL_BLOCK), so
// both rescale at the same key boundaries.
//
// Plain C interface (built with nvcc into a shared library, bound with
// ctypes): each launcher launches on the given stream, allocates nothing,
// synchronises nothing, and returns cudaGetLastError() after the launch.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kBlock = 64;     // rows of every Q, K and score tile
constexpr int kThreads = 256;  // 16 x 16; each owns a 4 x 4 score micro-tile
constexpr int kLS = kBlock + 1;  // padded row of a score tile in smem
constexpr float kNegInf = -1e30f;

// ints[] layout shared with the Python wrapper (ops/flash_attention.py)
enum {
  kB, kTq, kTk, kH, kHk, kD, kQOff, kKOff, kCausal,
  kStrides,  // 4 strides each of q, k, v and dO, in elements, [B, T, H, D]
  kNumInts = kStrides + 16
};

struct Dims {
  int B, Tq, Tk, H, Hk, D, g, q_off, k_off, causal;
  float scale;
  long long sq[4], sk[4], sv[4], sdo[4];
};

// The SIMT kernels below are written for an input type T but instantiated
// for float alone (bf16 takes the wgmma kernels), so only float converts.
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
// the value x takes once rounded to the input type
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ bool live(const Dims& p, int qi, int kj) {
  return qi < p.Tq && kj < p.Tk && (!p.causal || p.q_off + qi >= p.k_off + kj);
}

// no entry of the tile pair survives the causal mask (_block_live)
__device__ __forceinline__ bool dead(const Dims& p, int q0, int k0) {
  const int q_last = min(q0 + kBlock, p.Tq) - 1;
  return p.causal && p.k_off + k0 > p.q_off + q_last;
}

// rows [row0, row0 + 64) of x[b, :, h, :] into smem [64][DMAX + 1] as f32;
// zero past T and past D
template <typename T, int DMAX>
__device__ void load_tile(float* dst, const T* __restrict__ x,
                          const long long* st, int b, int h, int row0, int T_,
                          int D) {
  const long long base = b * st[0] + h * st[2];
  for (int idx = threadIdx.x; idx < kBlock * DMAX; idx += kThreads) {
    const int r = idx / DMAX, d = idx - r * DMAX;
    const int t = row0 + r;
    float val = 0.f;
    if (t < T_ && d < D) val = to_f(x[base + t * st[1] + d * st[3]]);
    dst[r * (DMAX + 1) + d] = val;
  }
}

// per-row f32 values [B, H, T, 1] of rows [row0, row0 + 64) into smem
__device__ void load_rows(float* dst, const float* __restrict__ x, int b,
                          int h, int H, int row0, int T_) {
  if (threadIdx.x < kBlock) {
    const int t = row0 + threadIdx.x;
    dst[threadIdx.x] =
        t < T_ ? x[(static_cast<long long>(b) * H + h) * T_ + t] : 0.f;
  }
}

// ------------------------------------------------------------------- K2
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Dims p) {
  constexpr int LD = DMAX + 1, NJ = DMAX / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlock * LD;
  float* Vs = Ks + kBlock * LD;
  float* Ss = Vs + kBlock * LD;   // scores, then p rounded to T
  float* m_s = Ss + kBlock * kLS;  // running max per row
  float* l_s = m_s + kBlock;       // running normaliser per row
  float* a_s = l_s + kBlock;       // this tile's rescale per row

  const int q0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.g;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;

  load_tile<T, DMAX>(Qs, q, p.sq, b, h, q0, p.Tq, p.D);
  if (tid < kBlock) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.Tk; k0 += kBlock) {
    if (dead(p, q0, k0)) break;  // and so is every later K tile
    __syncthreads();             // the previous tile's reads are done
    load_tile<T, DMAX>(Ks, k, p.sk, b, hk, k0, p.Tk, p.D);
    load_tile<T, DMAX>(Vs, v, p.sv, b, hk, k0, p.Tk, p.D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < p.D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        Ss[r * kLS + c] = live(p, q0 + r, k0 + c) ? s[i][j] * p.scale : kNegInf;
      }
    __syncthreads();

    // online softmax: warp w owns rows 8w..8w+7, a lane columns lane, lane+32
    for (int rr = 0; rr < 8; ++rr) {
      const int r = warp * 8 + rr;
      const float x0 = Ss[r * kLS + lane], x1 = Ss[r * kLS + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = live(p, q0 + r, k0 + lane) ? expf(x0 - m_new) : 0.f;
      const float p1 =
          live(p, q0 + r, k0 + lane + 32) ? expf(x1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Ss[r * kLS + lane] = round_to<T>(p0);
      Ss[r * kLS + lane + 32] = round_to<T>(p1);
      if (lane == 0) {  // every lane read m_old before the shuffles above
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    for (int c = 0; c < kBlock; ++c) {
      float pp[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pp[i] = Ss[(ty + 16 * i) * kLS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pp[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, t = q0 + r;
    if (t >= p.Tq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    const long long row = (static_cast<long long>(b) * p.Tq + t) * p.H + h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < p.D) o[row * p.D + d] = from_f<T>(acc[i][j] / l);
    }
    if (tx == 0)
      lse[(static_cast<long long>(b) * p.H + h) * p.Tq + t] = m_s[r] + logf(l);
  }
}

// ------------------------------------------------------------------- K3
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dvec, T* __restrict__ dq,
                    Dims p) {
  constexpr int LD = DMAX + 1, NJ = DMAX / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Os = Qs + kBlock * LD;  // dO
  float* Ks = Os + kBlock * LD;
  float* Vs = Ks + kBlock * LD;
  float* DS = Vs + kBlock * LD;  // ds rounded to T
  float* lse_s = DS + kBlock * kLS;
  float* dvec_s = lse_s + kBlock;

  const int q0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.g;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  load_tile<T, DMAX>(Qs, q, p.sq, b, h, q0, p.Tq, p.D);
  load_tile<T, DMAX>(Os, dout, p.sdo, b, h, q0, p.Tq, p.D);
  load_rows(lse_s, lse, b, h, p.H, q0, p.Tq);
  load_rows(dvec_s, dvec, b, h, p.H, q0, p.Tq);
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.Tk; k0 += kBlock) {
    if (dead(p, q0, k0)) break;
    __syncthreads();
    load_tile<T, DMAX>(Ks, k, p.sk, b, hk, k0, p.Tk, p.D);
    load_tile<T, DMAX>(Vs, v, p.sv, b, hk, k0, p.Tk, p.D);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < p.D; ++d) {
      float a[4], c[4], e[4], f[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty + 16 * i) * LD + d];
        e[i] = Os[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = Ks[(tx + 16 * j) * LD + d];
        f[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], c[j], s[i][j]);
          dp[i][j] = fmaf(e[i], f[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float ds = 0.f;
        if (live(p, q0 + r, k0 + c)) {
          const float pij = expf(s[i][j] * p.scale - lse_s[r]);
          ds = pij * (dp[i][j] - dvec_s[r]) * p.scale;
        }
        DS[r * kLS + c] = round_to<T>(ds);
      }
    __syncthreads();

    for (int c = 0; c < kBlock; ++c) {
      float dd[4], kk[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dd[i] = DS[(ty + 16 * i) * kLS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kk[j] = Ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(dd[i], kk[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= p.Tq) continue;
    const long long row = (static_cast<long long>(b) * p.Tq + t) * p.H + h;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < p.D) dq[row * p.D + d] = from_f<T>(acc[i][j]);
    }
  }
}

// ------------------------------------------------------------------- K4
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dvec, T* __restrict__ dk,
                     T* __restrict__ dv, Dims p) {
  constexpr int LD = DMAX + 1, NJ = DMAX / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBlock * LD;
  float* Qs = Vs + kBlock * LD;
  float* Os = Qs + kBlock * LD;  // dO
  float* PT = Os + kBlock * LD;  // p^T rounded to T, [k][q]
  float* DT = PT + kBlock * kLS;  // ds^T rounded to T, [k][q]
  float* lse_s = DT + kBlock * kLS;
  float* dvec_s = lse_s + kBlock;

  const int k0 = blockIdx.x * kBlock, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nq = (p.Tq + kBlock - 1) / kBlock;

  load_tile<T, DMAX>(Ks, k, p.sk, b, hk, k0, p.Tk, p.D);
  load_tile<T, DMAX>(Vs, v, p.sv, b, hk, k0, p.Tk, p.D);
  float ak[4][NJ], av[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) ak[i][j] = av[i][j] = 0.f;

  // the (q head of the group, Q tile) sweep of the TPU kernel's grid
  for (int t = 0; t < p.g * nq; ++t) {
    const int h = hk * p.g + t / nq, q0 = (t % nq) * kBlock;
    if (dead(p, q0, k0)) continue;
    __syncthreads();
    load_tile<T, DMAX>(Qs, q, p.sq, b, h, q0, p.Tq, p.D);
    load_tile<T, DMAX>(Os, dout, p.sdo, b, h, q0, p.Tq, p.D);
    load_rows(lse_s, lse, b, h, p.H, q0, p.Tq);
    load_rows(dvec_s, dvec, b, h, p.H, q0, p.Tq);
    __syncthreads();

    // this thread: key rows ty + 16 i, query columns tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < p.D; ++d) {
      float a[4], c[4], e[4], f[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Ks[(ty + 16 * i) * LD + d];
        e[i] = Vs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = Qs[(tx + 16 * j) * LD + d];
        f[j] = Os[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(c[j], a[i], s[i][j]);
          dp[i][j] = fmaf(f[j], e[i], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kr = ty + 16 * i, qc = tx + 16 * j;
        float pij = 0.f, ds = 0.f;
        if (live(p, q0 + qc, k0 + kr)) {
          pij = expf(s[i][j] * p.scale - lse_s[qc]);
          ds = pij * (dp[i][j] - dvec_s[qc]) * p.scale;
        }
        PT[kr * kLS + qc] = round_to<T>(pij);
        DT[kr * kLS + qc] = round_to<T>(ds);
      }
    __syncthreads();

    for (int c = 0; c < kBlock; ++c) {
      float pt[4], dt[4], qq[NJ], oo[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pt[i] = PT[(ty + 16 * i) * kLS + c];
        dt[i] = DT[(ty + 16 * i) * kLS + c];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        qq[j] = Qs[c * LD + tx + 16 * j];
        oo[j] = Os[c * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          av[i][j] = fmaf(pt[i], oo[j], av[i][j]);
          ak[i][j] = fmaf(dt[i], qq[j], ak[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= p.Tk) continue;
    const long long row = (static_cast<long long>(b) * p.Tk + t) * p.Hk + hk;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < p.D) {
        dk[row * p.D + d] = from_f<T>(ak[i][j]);
        dv[row * p.D + d] = from_f<T>(av[i][j]);
      }
    }
  }
}

// ------------------------------------------ K2, K3 and K4 on bf16: wgmma
namespace wg {

// the resident tile (Q in K2/K3, K and V in K4): two consumer warpgroups of
// 64 rows each
constexpr int kQRows = 128;
// the streamed tiles (K and V in K2/K3, Q and dO in K4): KERNEL_BLOCK rows
constexpr int kKRows = kBlock;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kRow = 128;  // bytes of one swizzled row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

template <int DMAX> struct Cfg {
  static constexpr int kAtoms = DMAX / 64;  // 64-column swizzle atoms
  static constexpr int kStages = DMAX == 64 ? 3 : 2;
  static constexpr int kQBytes = kAtoms * kQRows * kRow;   // a resident tile
  static constexpr int kKBytes = kAtoms * kKRows * kRow;   // a streamed tile
  static constexpr int kStageBytes = 2 * kKBytes;  // K then V, or Q then dO
  // q_tiles resident tiles and the stages, + the barriers, + slack to
  // align the base to 1024 bytes
  static constexpr int smem(int q_tiles) {
    return 1024 + q_tiles * kQBytes + kStages * kStageBytes +
           8 * (1 + 2 * kStages);
  }
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = hopper::smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// K tiles that rows [r0, r0 + 64) see: they end at the causal diagonal
// (dead()), and there are none for rows past Tq
__device__ __forceinline__ int live_tiles(const Dims& p, int r0) {
  if (r0 >= p.Tq) return 0;
  const int nk = (p.Tk + kKRows - 1) / kKRows;
  if (!p.causal) return nk;
  const int last = p.q_off + min(r0 + 63, p.Tq - 1) - p.k_off;
  return last < 0 ? 0 : min(nk, last / kKRows + 1);
}

// whether the tile at key row k0 needs the element mask for rows from r0:
// it crosses the causal diagonal or the ragged end of K
__device__ __forceinline__ bool needs_mask(const Dims& p, int r0, int k0) {
  return k0 + kKRows > p.Tk ||
         (p.causal && p.k_off + k0 + kKRows - 1 > p.q_off + r0);
}

// Accumulator fragment of a 64 x 64 wgmma tile: thread `lane` of warp `wi`
// in the warpgroup holds entry r at row 16 wi + lane / 4 + 8 half(r) and
// column col(r) + 2 (lane % 4)
__device__ __forceinline__ int half_of(int r) { return (r >> 1) & 1; }
__device__ __forceinline__ int col_of(int r) { return 8 * (r >> 2) + (r & 1); }

// the 64 x 64 accumulator as four k16 slices of the register A operand,
// rounded to bf16: slice kk holds columns 16 kk .. 16 kk + 15
__device__ __forceinline__ void to_a_operand(const float (&x)[32],
                                             uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = hopper::pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// acc = the rows [64 w, 64 w + 64) of tile A times tile B^T over DMAX,
// both from shared memory, K-major: A (the block's resident tile) has
// kQRows rows per atom, B (a streamed tile) kKRows
template <int DMAX>
__device__ __forceinline__ void product_ss(float (&acc)[32], const uint8_t* A,
                                           int w, const uint8_t* B) {
  hopper::fence_regs(acc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    const int atom = kk / 4, off = (kk % 4) * 32;
    hopper::wgmma_ss(
        acc, hopper::desc_b128(A + (atom * kQRows + 64 * w) * kRow + off),
        hopper::desc_b128(B + atom * kKRows * kRow + off), kk > 0);
  }
}

// acc[atom] += a (register A operand, 64 columns wide) times the streamed
// tile B read MN-major from shared memory: P V in K2, dS K in K3, P^T dO
// and dS^T Q in K4
template <int DMAX>
__device__ __forceinline__ void product_rs(float (&acc)[DMAX / 64][32],
                                           const uint32_t (&a)[4][4],
                                           const uint8_t* B) {
#pragma unroll
  for (int atom = 0; atom < DMAX / 64; ++atom) hopper::fence_regs(acc[atom]);
  hopper::wgmma_fence();
#pragma unroll
  for (int atom = 0; atom < DMAX / 64; ++atom)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_rs_tn(acc[atom], a[kk],
                          hopper::desc_b128(B + (atom * kKRows + 16 * kk) *
                                                    kRow));
}

// the block's barriers: the resident tiles loaded; stage s full (after
// full_arrivals producer threads arrive and TMA's bytes land); stage s
// released by every consumer warp
template <int S>
__device__ __forceinline__ void init_barriers(uint64_t* q_full,
                                              uint64_t* full,
                                              uint64_t* empty,
                                              int full_arrivals = 1) {
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], full_arrivals);
      hopper::mbar_init(&empty[s], kConsumers / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
}

// half i of this thread's accumulator rows, divided by div, into
// row[0, D) as bf16
template <int NA>
__device__ __forceinline__ void store_row(__nv_bfloat16* row,
                                          const float (&acc)[NA][32], int i,
                                          float div, int col_t, int D) {
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      if (half_of(r) != i) continue;
      const int d = 64 * a + col_of(r) + col_t;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(row + d) =
            __floats2bfloat162_rn(acc[a][r] / div, acc[a][r + 1] / div);
    }
}

// the producer's loop: tile t of K and V into stage t % S once the
// consumers have released it
template <int DMAX>
__device__ __forceinline__ void produce_kv(const CUtensorMap* mk,
                                           const CUtensorMap* mv, uint8_t* KV,
                                           uint64_t* full, uint64_t* empty,
                                           int n_tiles, int hk, int b) {
  using C = Cfg<DMAX>;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % C::kStages;
    if (t >= C::kStages) hopper::mbar_wait(&empty[s], (t / C::kStages - 1) & 1);
    uint8_t* Ks = KV + s * C::kStageBytes;
    uint8_t* Vs = Ks + C::kKBytes;
    hopper::mbar_arrive_expect_tx(&full[s], C::kStageBytes);
#pragma unroll
    for (int a = 0; a < C::kAtoms; ++a) {
      hopper::tma_load_4d(Ks + a * kKRows * kRow, mk, &full[s], 64 * a, hk,
                          t * kKRows, b);
      hopper::tma_load_4d(Vs + a * kKRows * kRow, mv, &full[s], 64 * a, hk,
                          t * kKRows, b);
    }
  }
}

// K4: the first 64-row Q tile that key rows [r0, r0 + 64) see, or nq if
// none does. Under the causal mask the live Q tiles of a key run from the
// diagonal to the end; keys past Tk see nothing (they are never stored).
__device__ __forceinline__ int first_q_tile(const Dims& p, int r0, int nq) {
  if (r0 >= p.Tk) return nq;
  if (!p.causal) return 0;
  const int qi = p.k_off + r0 - p.q_off;  // the first query that sees key r0
  return qi >= p.Tq ? nq : max(qi, 0) / kKRows;
}

// K4's producer loop, run by every lane of the producer warp: tile t of the
// sweep (q head hk g + t / per of the group, Q tile first + t % per) into
// stage t % S once the consumers have released it. Lane 0 starts the TMA
// loads of Q and dO; beside them each lane copies two rows' per-query
// terms, -lse log2(e) and dvec, into `rows` (-inf and 0 past Tq, which makes
// p and ds of a query past Tq exactly 0: TMA zero-fills its Q and dO, but
// exp(0 - lse) is not 0). Every lane arrives on the stage's "full" barrier
// after its stores, lane 0 with the TMA byte count.
template <int DMAX>
__device__ __forceinline__ void produce_qdo(
    const CUtensorMap* mq, const CUtensorMap* mdo, uint8_t* QO, float* rows,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    uint64_t* full, uint64_t* empty, const Dims& p, int n_tiles, int first,
    int per, int hk, int b, int lane) {
  using C = Cfg<DMAX>;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % C::kStages;
    if (t >= C::kStages) hopper::mbar_wait(&empty[s], (t / C::kStages - 1) & 1);
    const int h = hk * p.g + t / per, q0 = (first + t % per) * kKRows;
    float* r = rows + s * 2 * kKRows;
    for (int i = lane; i < kKRows; i += 32) {
      const int qi = q0 + i;
      const long long at = (static_cast<long long>(b) * p.H + h) * p.Tq + qi;
      r[i] = qi < p.Tq ? -lse[at] * kLog2e : -INFINITY;
      r[kKRows + i] = qi < p.Tq ? dvec[at] : 0.f;
    }
    if (lane != 0) {
      hopper::mbar_arrive(&full[s]);
      continue;
    }
    uint8_t* Qs = QO + s * C::kStageBytes;
    uint8_t* Os = Qs + C::kKBytes;
    hopper::mbar_arrive_expect_tx(&full[s], C::kStageBytes);
#pragma unroll
    for (int a = 0; a < C::kAtoms; ++a) {
      hopper::tma_load_4d(Qs + a * kKRows * kRow, mq, &full[s], 64 * a, h, q0,
                          b);
      hopper::tma_load_4d(Os + a * kKRows * kRow, mdo, &full[s], 64 * a, h,
                          q0, b);
    }
  }
}

}  // namespace wg

// ------------------------------------------------------- K2, bf16, wgmma
template <int DMAX>
__global__ void __launch_bounds__(wg::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, Dims p) {
  using C = wg::Cfg<DMAX>;
  constexpr int NA = C::kAtoms, S = C::kStages;
  extern __shared__ uint8_t wg_smem[];
  uint8_t* Qs = wg::align1024(wg_smem);
  uint8_t* KV = Qs + C::kQBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(KV + S * C::kStageBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * wg::kQRows;  // longest first
  const int n_tiles =
      max(wg::live_tiles(p, q0), wg::live_tiles(p, q0 + 64));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  wg::init_barriers<S>(q_full, full, empty);

  if (warp == wg::kConsumers / 32) {  // ---- producer
    if (lane == 0 && n_tiles > 0) {
      hopper::tma_prefetch_map(&mq);
      hopper::tma_prefetch_map(&mk);
      hopper::tma_prefetch_map(&mv);
      hopper::mbar_arrive_expect_tx(q_full, C::kQBytes);
      for (int a = 0; a < NA; ++a)
        hopper::tma_load_4d(Qs + a * wg::kQRows * wg::kRow, &mq, q_full,
                            64 * a, h, q0, b);
      wg::produce_kv<DMAX>(&mk, &mv, KV, full, empty, n_tiles, h / p.g, b);
    }
    return;
  }

  // ---- consumers: warpgroup w owns rows [r0, r0 + 64)
  const int w = warp / 4, wi = warp % 4;
  const int r0 = q0 + 64 * w;
  const int mine = wg::live_tiles(p, r0);
  const int row_a = r0 + 16 * wi + lane / 4;  // and row_a + 8
  const int col_t = 2 * (lane % 4);
  const float sl2 = p.scale * wg::kLog2e;
  float oacc[NA][32], sacc[32];
  float m[2] = {kNegInf, kNegInf}, lp[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    sacc[r] = 0.f;
#pragma unroll
    for (int a = 0; a < NA; ++a) oacc[a][r] = 0.f;
  }
  if (n_tiles > 0) hopper::mbar_wait(q_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % S;
    hopper::mbar_wait(&full[s], (t / S) & 1);
    const uint8_t* Ks = KV + s * C::kStageBytes;
    if (t < mine) {
      wg::product_ss<DMAX>(sacc, Qs, w, Ks);
      hopper::wgmma_commit();
      hopper::wgmma_wait0();
      hopper::fence_regs(sacc);

      const int k0 = t * wg::kKRows;
      if (wg::needs_mask(p, r0, k0)) {
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int qi = row_a + 8 * wg::half_of(r);
          const int kj = k0 + wg::col_of(r) + col_t;
          if (kj >= p.Tk || (p.causal && p.q_off + qi < p.k_off + kj))
            sacc[r] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int r = 0; r < 32; ++r)
        mx[wg::half_of(r)] = fmaxf(mx[wg::half_of(r)], sacc[r]);
      float alpha[2], mneg[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i] * p.scale);
        alpha[i] = hopper::ex2((m[i] - m_new) * wg::kLog2e);
        m[i] = m_new;
        mneg[i] = -m_new * wg::kLog2e;
        lp[i] *= alpha[i];
      }
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int i = wg::half_of(r);
        sacc[r] = hopper::ex2(fmaf(sacc[r], sl2, mneg[i]));
        lp[i] += sacc[r];  // the unrounded p, as the plain version sums
      }
      uint32_t pa[4][4];
      wg::to_a_operand(sacc, pa);
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int r = 0; r < 32; ++r) oacc[a][r] *= alpha[wg::half_of(r)];
      wg::product_rs<DMAX>(oacc, pa, Ks + C::kKBytes);
      hopper::wgmma_commit();
      hopper::wgmma_wait0();
#pragma unroll
      for (int a = 0; a < NA; ++a) hopper::fence_regs(oacc[a]);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  // ---- epilogue: O = acc / l in bf16 and lse, once
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lp[i] += __shfl_xor_sync(0xffffffffu, lp[i], 1);
    lp[i] += __shfl_xor_sync(0xffffffffu, lp[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row_a + 8 * i;
    if (t >= p.Tq) continue;
    const float l = fmaxf(lp[i], 1e-30f);
    const long long row = (static_cast<long long>(b) * p.Tq + t) * p.H + h;
    wg::store_row<NA>(o + row * p.D, oacc, i, l, col_t, p.D);
    if (lane % 4 == 0)
      lse[(static_cast<long long>(b) * p.H + h) * p.Tq + t] = m[i] + logf(l);
  }
}

// ------------------------------------------------------- K3, bf16, wgmma
template <int DMAX>
__global__ void __launch_bounds__(wg::kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const __grid_constant__ CUtensorMap mdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ dvec,
                          __nv_bfloat16* __restrict__ dq, Dims p) {
  using C = wg::Cfg<DMAX>;
  constexpr int NA = C::kAtoms, S = C::kStages;
  extern __shared__ uint8_t wg_smem[];
  uint8_t* Qs = wg::align1024(wg_smem);
  uint8_t* Os = Qs + C::kQBytes;  // dO
  uint8_t* KV = Os + C::kQBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(KV + S * C::kStageBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * wg::kQRows;
  const int n_tiles =
      max(wg::live_tiles(p, q0), wg::live_tiles(p, q0 + 64));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  wg::init_barriers<S>(q_full, full, empty);

  if (warp == wg::kConsumers / 32) {  // ---- producer
    if (lane == 0 && n_tiles > 0) {
      hopper::tma_prefetch_map(&mq);
      hopper::tma_prefetch_map(&mdo);
      hopper::tma_prefetch_map(&mk);
      hopper::tma_prefetch_map(&mv);
      hopper::mbar_arrive_expect_tx(q_full, 2 * C::kQBytes);
      for (int a = 0; a < NA; ++a) {
        hopper::tma_load_4d(Qs + a * wg::kQRows * wg::kRow, &mq, q_full,
                            64 * a, h, q0, b);
        hopper::tma_load_4d(Os + a * wg::kQRows * wg::kRow, &mdo, q_full,
                            64 * a, h, q0, b);
      }
      wg::produce_kv<DMAX>(&mk, &mv, KV, full, empty, n_tiles, h / p.g, b);
    }
    return;
  }

  // ---- consumers: warpgroup w owns rows [r0, r0 + 64)
  const int w = warp / 4, wi = warp % 4;
  const int r0 = q0 + 64 * w;
  const int mine = wg::live_tiles(p, r0);
  const int row_a = r0 + 16 * wi + lane / 4;  // and row_a + 8
  const int col_t = 2 * (lane % 4);
  const float sl2 = p.scale * wg::kLog2e;
  float lneg[2], dv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row_a + 8 * i;
    const long long at = (static_cast<long long>(b) * p.H + h) * p.Tq + t;
    lneg[i] = t < p.Tq ? -lse[at] * wg::kLog2e : 0.f;
    dv[i] = t < p.Tq ? dvec[at] : 0.f;
  }
  float dqacc[NA][32], sacc[32], dpacc[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    sacc[r] = dpacc[r] = 0.f;
#pragma unroll
    for (int a = 0; a < NA; ++a) dqacc[a][r] = 0.f;
  }
  if (n_tiles > 0) hopper::mbar_wait(q_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % S;
    hopper::mbar_wait(&full[s], (t / S) & 1);
    const uint8_t* Ks = KV + s * C::kStageBytes;
    if (t < mine) {
      wg::product_ss<DMAX>(sacc, Qs, w, Ks);
      wg::product_ss<DMAX>(dpacc, Os, w, Ks + C::kKBytes);
      hopper::wgmma_commit();
      hopper::wgmma_wait0();
      hopper::fence_regs(sacc);
      hopper::fence_regs(dpacc);

      const int k0 = t * wg::kKRows;
      const bool masked = wg::needs_mask(p, r0, k0);
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int i = wg::half_of(r);
        const float pr = hopper::ex2(fmaf(sacc[r], sl2, lneg[i]));
        float ds = pr * (dpacc[r] - dv[i]) * p.scale;
        if (masked) {
          const int qi = row_a + 8 * i;
          const int kj = k0 + wg::col_of(r) + col_t;
          if (kj >= p.Tk || (p.causal && p.q_off + qi < p.k_off + kj))
            ds = 0.f;
        }
        sacc[r] = ds;
      }
      uint32_t da[4][4];
      wg::to_a_operand(sacc, da);  // ds rounded to bf16
      wg::product_rs<DMAX>(dqacc, da, Ks);
      hopper::wgmma_commit();
      hopper::wgmma_wait0();
#pragma unroll
      for (int a = 0; a < NA; ++a) hopper::fence_regs(dqacc[a]);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  // ---- epilogue: dQ in bf16, once
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row_a + 8 * i;
    if (t >= p.Tq) continue;
    const long long row = (static_cast<long long>(b) * p.Tq + t) * p.H + h;
    wg::store_row<NA>(dq + row * p.D, dqacc, i, 1.f, col_t, p.D);
  }
}

// ------------------------------------------------------- K4, bf16, wgmma
// K3 transposed: a block owns a 128-row K tile of one kv head (K and V
// resident, in the role Q and dO have in K3) and streams the 64-row Q and
// dO tiles of every (q head of the group, live Q tile) pair through the
// stages. Scores are formed transposed, keys as rows: s^T = K Q^T and
// dp^T = V dO^T, so p^T and ds^T come out of the accumulator as the register
// A operands of dV += p^T dO and dK += ds^T Q, and the per-query terms
// (lse, dvec) belong to the accumulator's columns.
template <int DMAX>
__global__ void __launch_bounds__(wg::kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           const __grid_constant__ CUtensorMap mdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ dvec,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, Dims p) {
  using C = wg::Cfg<DMAX>;
  constexpr int NA = C::kAtoms, S = C::kStages, QR = wg::kKRows;
  extern __shared__ uint8_t wg_smem[];
  uint8_t* Ks = wg::align1024(wg_smem);
  uint8_t* Vs = Ks + C::kQBytes;
  uint8_t* QO = Vs + C::kQBytes;  // stage s: its Q tile, then its dO tile
  float* rows = reinterpret_cast<float*>(QO + S * C::kStageBytes);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(rows + S * 2 * QR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;

  // K tiles in launch order: tile 0, which sees the most Q tiles, first
  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * wg::kQRows;
  const int nq = (p.Tq + QR - 1) / QR;
  const int first = wg::first_q_tile(p, k0, nq), per = nq - first;
  const int n_tiles = p.g * per;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  wg::init_barriers<S>(kv_full, full, empty, 32);

  if (warp == wg::kConsumers / 32) {  // ---- producer
    if (n_tiles == 0) return;
    if (lane == 0) {
      hopper::tma_prefetch_map(&mq);
      hopper::tma_prefetch_map(&mdo);
      hopper::tma_prefetch_map(&mk);
      hopper::tma_prefetch_map(&mv);
      hopper::mbar_arrive_expect_tx(kv_full, 2 * C::kQBytes);
      for (int a = 0; a < NA; ++a) {
        hopper::tma_load_4d(Ks + a * wg::kQRows * wg::kRow, &mk, kv_full,
                            64 * a, hk, k0, b);
        hopper::tma_load_4d(Vs + a * wg::kQRows * wg::kRow, &mv, kv_full,
                            64 * a, hk, k0, b);
      }
    }
    wg::produce_qdo<DMAX>(&mq, &mdo, QO, rows, lse, dvec, full, empty, p,
                          n_tiles, first, per, hk, b, lane);
    return;
  }

  // ---- consumers: warpgroup w owns key rows [r0, r0 + 64). A block with
  // no live tile runs no iteration and still writes its zeros below.
  const int w = warp / 4, wi = warp % 4;
  const int r0 = k0 + 64 * w;
  const int mine = wg::first_q_tile(p, r0, nq);
  const int row_a = r0 + 16 * wi + lane / 4;  // and row_a + 8
  const int col_t = 2 * (lane % 4);
  const float sl2 = p.scale * wg::kLog2e;
  float dkacc[NA][32], dvacc[NA][32], sacc[32], dpacc[32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int r = 0; r < 32; ++r) dkacc[a][r] = dvacc[a][r] = 0.f;
  if (n_tiles > 0) hopper::mbar_wait(kv_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % S, qt = first + t % per;
    hopper::mbar_wait(&full[s], (t / S) & 1);
    if (qt >= mine) {  // warpgroup 1 may start one Q tile later
      const uint8_t* Qs = QO + s * C::kStageBytes;
      const uint8_t* Os = Qs + C::kKBytes;
      wg::product_ss<DMAX>(sacc, Ks, w, Qs);
      wg::product_ss<DMAX>(dpacc, Vs, w, Os);
      hopper::wgmma_commit();
      hopper::wgmma_wait0();
      hopper::fence_regs(sacc);
      hopper::fence_regs(dpacc);

      // the causal mask, only on tiles that cross the diagonal; queries
      // past Tq need none (their -lse is -inf), keys past Tk are not stored
      const int q0 = qt * QR;
      if (p.causal && p.q_off + q0 < p.k_off + r0 + 63) {
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int kj = row_a + 8 * wg::half_of(r);
          const int qi = q0 + wg::col_of(r) + col_t;
          if (p.q_off + qi < p.k_off + kj) sacc[r] = -INFINITY;
        }
      }
      // p and ds for each pair of neighbouring columns, rounded to bf16
      // straight into the A operands (wg::to_a_operand's packing)
      const float* lneg = rows + s * 2 * QR;
      const float* dvr = lneg + QR;
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 8 * kk + 2 * j, c = wg::col_of(r) + col_t;
          const float2 l = *reinterpret_cast<const float2*>(lneg + c);
          const float2 d = *reinterpret_cast<const float2*>(dvr + c);
          const float p0 = hopper::ex2(fmaf(sacc[r], sl2, l.x));
          const float p1 = hopper::ex2(fmaf(sacc[r + 1], sl2, l.y));
          pa[kk][j] = hopper::pack_bf16(p0, p1);
          da[kk][j] = hopper::pack_bf16(p0 * (dpacc[r] - d.x) * p.scale,
                                        p1 * (dpacc[r + 1] - d.y) * p.scale);
        }
      wg::product_rs<DMAX>(dvacc, pa, Os);
      wg::product_rs<DMAX>(dkacc, da, Qs);
      hopper::wgmma_commit();
      hopper::wgmma_wait0();
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        hopper::fence_regs(dkacc[a]);
        hopper::fence_regs(dvacc[a]);
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  // ---- epilogue: dK and dV in bf16, once; zeros where no query looked
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row_a + 8 * i;
    if (t >= p.Tk) continue;
    const long long row = (static_cast<long long>(b) * p.Tk + t) * p.Hk + hk;
    wg::store_row<NA>(dk + row * p.D, dkacc, i, 1.f, col_t, p.D);
    wg::store_row<NA>(dv + row * p.D, dvacc, i, 1.f, col_t, p.D);
  }
}

// ------------------------------------------------------------- launchers
// dynamic shared memory of each kernel, in floats
template <int DMAX> constexpr int fwd_floats() {
  return 3 * kBlock * (DMAX + 1) + kBlock * kLS + 3 * kBlock;
}
template <int DMAX> constexpr int dq_floats() {
  return 4 * kBlock * (DMAX + 1) + kBlock * kLS + 2 * kBlock;
}
template <int DMAX> constexpr int dkv_floats() {
  return 4 * kBlock * (DMAX + 1) + 2 * kBlock * kLS + 2 * kBlock;
}

bool unpack(const long long* ints, float scale, Dims* p) {
  p->B = static_cast<int>(ints[kB]);
  p->Tq = static_cast<int>(ints[kTq]);
  p->Tk = static_cast<int>(ints[kTk]);
  p->H = static_cast<int>(ints[kH]);
  p->Hk = static_cast<int>(ints[kHk]);
  p->D = static_cast<int>(ints[kD]);
  p->q_off = static_cast<int>(ints[kQOff]);
  p->k_off = static_cast<int>(ints[kKOff]);
  p->causal = ints[kCausal] != 0;
  p->scale = scale;
  for (int i = 0; i < 4; ++i) {
    p->sq[i] = ints[kStrides + i];
    p->sk[i] = ints[kStrides + 4 + i];
    p->sv[i] = ints[kStrides + 8 + i];
    p->sdo[i] = ints[kStrides + 12 + i];
  }
  if (p->B <= 0 || p->Tq <= 0 || p->Tk <= 0 || p->H <= 0 || p->Hk <= 0 ||
      p->H % p->Hk || p->B > 65535 || p->H > 65535 || p->D <= 0 ||
      p->D > 128 || p->D % 8) {
    return false;
  }
  p->g = p->H / p->Hk;
  return true;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int floats) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              floats * static_cast<int>(sizeof(float)));
}

template <typename T, int DMAX>
cudaError_t fwd(const Dims& p, const void* q, const void* k, const void* v,
                void* o, void* lse, cudaStream_t s) {
  const int floats = fwd_floats<DMAX>();
  cudaError_t e = prepare(flash_fwd_kernel<T, DMAX>, floats);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Tq + kBlock - 1) / kBlock, p.H, p.B);
  flash_fwd_kernel<T, DMAX><<<grid, kThreads, floats * sizeof(float), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      p);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t bwd_dq(const Dims& p, const void* q, const void* k,
                   const void* v, const void* dout, const void* lse,
                   const void* dvec, void* dq, cudaStream_t s) {
  const int floats = dq_floats<DMAX>();
  cudaError_t e = prepare(flash_bwd_dq_kernel<T, DMAX>, floats);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Tq + kBlock - 1) / kBlock, p.H, p.B);
  flash_bwd_dq_kernel<T, DMAX><<<grid, kThreads, floats * sizeof(float), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<T*>(dq), p);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t bwd_dkv(const Dims& p, const void* q, const void* k,
                    const void* v, const void* dout, const void* lse,
                    const void* dvec, void* dk, void* dv, cudaStream_t s) {
  const int floats = dkv_floats<DMAX>();
  cudaError_t e = prepare(flash_bwd_dkv_kernel<T, DMAX>, floats);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Tk + kBlock - 1) / kBlock, p.Hk, p.B);
  flash_bwd_dkv_kernel<T, DMAX><<<grid, kThreads, floats * sizeof(float),
                                  s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<T*>(dk), static_cast<T*>(dv), p);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, resolved at run time through
// cudaGetDriverEntryPoint so that the library links against the CUDA
// runtime alone (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The TMA map of a bf16 x[B, T, H, D] (element strides st) as the 4-d
// tensor (D, H, T, B), in that order so that the byte strides grow, with a
// box of (64, 1, rows, 1): `rows` rows of one head, 64 columns (one 128-byte
// swizzle atom), 128B swizzle, zero fill outside the tensor. A dim of size 1
// gets the stride of a dense layout (its coordinate is always 0). Which
// tensors TMA can read as they lie is defined once, by tma_ready in
// ops/flash_attention.py, and the wrapper hands over only those; the checks
// below merely assert that rule, failing the launch instead of building a
// wrong map if the two ever disagree.
cudaError_t make_map(CUtensorMap* map, const void* x, const long long* st,
                     int B, int T, int H, int D, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  if (reinterpret_cast<uintptr_t>(x) % 16 || st[3] != 1)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(T),
                              cuuint64_t(B)};
  const long long outer[3] = {st[2], st[1], st[0]};  // H, T, B
  cuuint64_t strides[3];
  cuuint64_t extent = cuuint64_t(D) * 2;  // bytes spanned by the inner dims
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t s = dims[i + 1] == 1
                             ? (extent + 15) / 16 * 16
                             : static_cast<cuuint64_t>(outer[i]) * 2;
    if (s % 16) return cudaErrorInvalidValue;
    strides[i] = s;
    extent = s * dims[i + 1];
  }
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

dim3 wgmma_grid(const Dims& p) {  // (q head, batch, Q tile)
  return dim3(p.H, p.B, (p.Tq + wg::kQRows - 1) / wg::kQRows);
}

template <int DMAX>
cudaError_t fwd_wgmma(const Dims& p, const void* q, const void* k,
                      const void* v, void* o, void* lse, cudaStream_t s) {
  CUtensorMap mq, mk, mv;
  cudaError_t e;
  if ((e = make_map(&mq, q, p.sq, p.B, p.Tq, p.H, p.D, wg::kQRows)) ||
      (e = make_map(&mk, k, p.sk, p.B, p.Tk, p.Hk, p.D, wg::kKRows)) ||
      (e = make_map(&mv, v, p.sv, p.B, p.Tk, p.Hk, p.D, wg::kKRows)))
    return e;
  const int bytes = wg::Cfg<DMAX>::smem(1);
  e = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DMAX>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid = wgmma_grid(p);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  flash_fwd_wgmma_kernel<DMAX><<<grid, wg::kThreads, bytes, s>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      p);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t bwd_dq_wgmma(const Dims& p, const void* q, const void* k,
                         const void* v, const void* dout, const void* lse,
                         const void* dvec, void* dq, cudaStream_t s) {
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e;
  if ((e = make_map(&mq, q, p.sq, p.B, p.Tq, p.H, p.D, wg::kQRows)) ||
      (e = make_map(&mdo, dout, p.sdo, p.B, p.Tq, p.H, p.D, wg::kQRows)) ||
      (e = make_map(&mk, k, p.sk, p.B, p.Tk, p.Hk, p.D, wg::kKRows)) ||
      (e = make_map(&mv, v, p.sv, p.B, p.Tk, p.Hk, p.D, wg::kKRows)))
    return e;
  const int bytes = wg::Cfg<DMAX>::smem(2);
  e = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<DMAX>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid = wgmma_grid(p);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  flash_bwd_dq_wgmma_kernel<DMAX><<<grid, wg::kThreads, bytes, s>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<__nv_bfloat16*>(dq), p);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t bwd_dkv_wgmma(const Dims& p, const void* q, const void* k,
                          const void* v, const void* dout, const void* lse,
                          const void* dvec, void* dk, void* dv,
                          cudaStream_t s) {
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e;
  if ((e = make_map(&mq, q, p.sq, p.B, p.Tq, p.H, p.D, wg::kKRows)) ||
      (e = make_map(&mdo, dout, p.sdo, p.B, p.Tq, p.H, p.D, wg::kKRows)) ||
      (e = make_map(&mk, k, p.sk, p.B, p.Tk, p.Hk, p.D, wg::kQRows)) ||
      (e = make_map(&mv, v, p.sv, p.B, p.Tk, p.Hk, p.D, wg::kQRows)))
    return e;
  // K and V resident, + each stage's per-query terms (2 x 64 floats)
  using C = wg::Cfg<DMAX>;
  const int bytes = C::smem(2) + C::kStages * 2 * wg::kKRows * 4;
  e = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<DMAX>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  // (kv head, batch, K tile)
  const dim3 grid(p.Hk, p.B, (p.Tk + wg::kQRows - 1) / wg::kQRows);
  if (grid.z > 65535) return cudaErrorInvalidValue;
  flash_bwd_dkv_wgmma_kernel<DMAX><<<grid, wg::kThreads, bytes, s>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), p);
  return cudaGetLastError();
}

// dtype code: 0 = float32, 1 = bfloat16; head dims up to 64 take the
// narrower instantiation. Each kernel splits on the type: float32 to the
// SIMT kernels, bfloat16 to the wgmma ones. Not a fallback: each type has
// exactly one kernel.
#define DISPATCH_SPLIT(dtype, D, SIMT, WGMMA, ...)                       \
  ((dtype) == 0                                                         \
       ? ((D) <= 64 ? SIMT<float, 64>(__VA_ARGS__)                      \
                    : SIMT<float, 128>(__VA_ARGS__))                    \
       : ((D) <= 64 ? WGMMA<64>(__VA_ARGS__) : WGMMA<128>(__VA_ARGS__)))

}  // namespace

extern "C" int flash_fwd_launch(int dtype, const long long* ints, float scale,
                                const void* q, const void* k, const void* v,
                                void* o, void* lse, void* stream) {
  Dims p;
  if ((dtype != 0 && dtype != 1) || !unpack(ints, scale, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      DISPATCH_SPLIT(dtype, p.D, fwd, fwd_wgmma, p, q, k, v, o, lse, s));
}

extern "C" int flash_bwd_dq_launch(int dtype, const long long* ints,
                                   float scale, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* dvec,
                                   void* dq, void* stream) {
  Dims p;
  if ((dtype != 0 && dtype != 1) || !unpack(ints, scale, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      DISPATCH_SPLIT(dtype, p.D, bwd_dq, bwd_dq_wgmma, p, q, k, v, dout, lse,
                     dvec, dq, s));
}

extern "C" int flash_bwd_dkv_launch(int dtype, const long long* ints,
                                    float scale, const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* dvec,
                                    void* dk, void* dv, void* stream) {
  Dims p;
  if ((dtype != 0 && dtype != 1) || !unpack(ints, scale, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      DISPATCH_SPLIT(dtype, p.D, bwd_dkv, bwd_dkv_wgmma, p, q, k, v, dout,
                     lse, dvec, dk, dv, s));
}
