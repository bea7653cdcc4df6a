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
// thread block owns one 64-row output tile and loops over the other side's
// tiles itself: K2 and K3 one block per (Q tile, q head, batch) looping over
// K tiles; K4 one block per (K tile, kv head, batch) looping over all
// g * nQ (q head of its group, Q tile) pairs, as the TPU grid does. Every
// output element is written once by one block: no atomics, and the sums run
// in a fixed order.
//
// What bounds it on this card: at the LM's shape (T = 1024, head dim 64)
// attention does ~4 T^2 D flops per (batch, head) causal-halved against
// ~4 T D bytes, far above the H100's ~295 flops per byte, so the tensor
// cores would bound a fast kernel. This first version is the simple one:
// 64 x 64 tiles in shared memory held as float32, 256 threads each owning a
// 4 x 4 micro-tile of the score tile, dots as float32 FMAs (no TF32, no
// tensor cores), so the FMA pipes and shared-memory loads bound it.
// wgmma, TMA and warp specialisation are a later change.
//
// Numerics follow the TPU kernels so that the plain PyTorch versions in
// ops/flash_attention.py can be held tight:
//   - inputs are f32 or bf16; every dot sums bf16 x bf16 products (exact in
//     f32) in f32, and the softmax state and every accumulator are f32;
//   - p is rounded to the input type before P V, ds before dS K and dS^T Q,
//     p^T before P^T dO; the outputs are rounded to the input type once;
//   - the causal mask compares GLOBAL positions, q_off + i >= k_off + j, and
//     sets masked scores to -1e30; a masked entry's p is exactly 0, so a row
//     that sees no key gets O = 0, and ragged tails (rows past Tq, keys
//     past Tk) are masked the same way;
//   - K tiles the causal mask kills entirely are skipped (_block_live).
// Inputs are read in the [B, T, H, D] layout through the strides passed
// in, so no transpose is materialised; q head h reads kv head h / g, so the
// GQA repeat is never materialised. Any Tq and Tk; any D that is a multiple
// of 8 up to 128.
//
// Plain C interface (built with nvcc into a shared library, bound with
// ctypes): each launcher launches on the given stream, allocates nothing,
// synchronises nothing, and returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
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

// dtype code: 0 = float32, 1 = bfloat16; head dims up to 64 take the
// narrower instantiation
#define DISPATCH(dtype, D, FN, ...)                                      \
  ((dtype) == 0                                                         \
       ? ((D) <= 64 ? FN<float, 64>(__VA_ARGS__)                        \
                    : FN<float, 128>(__VA_ARGS__))                      \
       : ((D) <= 64 ? FN<__nv_bfloat16, 64>(__VA_ARGS__)                \
                    : FN<__nv_bfloat16, 128>(__VA_ARGS__)))

}  // namespace

extern "C" int flash_fwd_launch(int dtype, const long long* ints, float scale,
                                const void* q, const void* k, const void* v,
                                void* o, void* lse, void* stream) {
  Dims p;
  if ((dtype != 0 && dtype != 1) || !unpack(ints, scale, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(DISPATCH(dtype, p.D, fwd, p, q, k, v, o, lse, s));
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
      DISPATCH(dtype, p.D, bwd_dq, p, q, k, v, dout, lse, dvec, dq, s));
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
      DISPATCH(dtype, p.D, bwd_dkv, p, q, k, v, dout, lse, dvec, dk, dv, s));
}
