// Row gather for Hopper (sm_90a): out[i, :] = emb[clamp(slots[i], 0, S-1), :].
//
// Replaces minips_tpu/ops/pallas_kernels.py:_gather_kernel, the TPU's
// embedding lookup by scalar-prefetched slot ids and per-row HBM->VMEM DMAs
// in 8-row blocks. That design follows the TPU (a sequential grid, the
// (8, 128) tile, semaphores); none of it carries over. Here every block
// loads its own indices and the copy is plain loads and stores. Tensor
// cores have no work here (there is no arithmetic), and TMA gathers no rows
// by index on sm_90 (the tiled gather arrived with sm_100); a per-row
// cp.async.bulk needs 16-byte multiples and is all issue overhead for rows
// of 4 and 32 bytes.
//
// What bounds it: memory. For each index it reads 4 bytes of index and
// D * itemsize bytes of row, and writes D * itemsize bytes: at the main
// path's D = 1 f32 (N = 1,703,936) 14.5 MB, 4.3 us at 3.35 TB/s. But every
// row is a scattered access of its own, a whole 32-byte sector however few
// bytes it uses, and the card serves about 230 G of them a second on the
// main path's zipf slots (155 G on uniform slots, which L1 catches less
// of): at D = 1 the 1.7 M rows take ~7 us, and the same slots run 7 us
// faster when every slot names one row. At D = 8 a row is one sector and
// the 54.5 MB of output bound it. (Measured on an NVIDIA H100
// 80GB HBM3 at 700 W; PERF.md section 6.)
//
// The first design moved one word per thread through a dependent pair of
// loads (slot, then row), only 4 bytes a thread at D = 1, about 1 MB in
// flight on 132 SMs, where Little's law asks for ~2.3 MB (3.35 TB/s x
// ~0.7 us); and it divided by a runtime int64 (a software routine) for
// every word. Removing both measured 2.5 us faster at D = 1 when the rows
// do not scatter, and no faster on the real slots, where the scattered
// row reads decide.
//
// The design, in order of what it buys:
// 1. Several rows in flight per thread: all of a thread's slot loads, then
//    all its row loads, then all its stores, so its row loads are
//    independent and in flight together. Two kernels:
//    - gather_narrow_kernel, 4-byte rows (D = 1 f32): a unit is 4
//      consecutive rows, one 16-byte slot load, four 4-byte row loads, one
//      16-byte store; a thread owns 2 units (8 rows), strided by the
//      block's width so that each store instruction of a warp covers 512
//      contiguous bytes. gather_rows_kernel's one-word instantiation, with
//      its shared-memory slots and 4-byte stores, measured 13% slower here
//      warm and 9% cold (PERF.md), so 4-byte rows keep their own kernel.
//    - gather_rows_kernel, every other width: a block stages its tile's
//      slots in shared memory with 16-byte loads; a group of lanes splits
//      a row (neighbouring lanes on neighbouring words of the row and of
//      the output); each group owns kRows rows, strided by the block's row
//      groups so that every store instruction of a warp stays coalesced.
// 2. Compile-time row width for the port's widths (1 x 4 bytes: D = 1 f32,
//    8 rows a thread; 2 x 16 bytes: D = 8 f32, 2 rows; 32 x 16 bytes:
//    D = 128 f32, 4 rows) and a runtime-width instantiation for the rest
//    (4 rows), whose lane groups are a power of two: no division by a
//    runtime value anywhere, only shifts and masks. Index arithmetic is
//    32-bit when max(N, S) x words per row < 2^31 (the main path: 3.4 M
//    words at D = 8), 64-bit otherwise.
// 3. Vector loads of the slot stream: 16 bytes of slots at a time,
//    ld.global.nc.L1::no_allocate (read once); the rows through the
//    read-only path (__ldg), since zipf keys repeat hot rows within a block.
//    A slot view may start at any element, so the up-to-3 rows before the
//    first 16-byte aligned slot (the head) go one by one, in block 0, as do
//    the narrow kernel's < 4 rows past its last unit.
// 4. One pass: a block per tile, no loop (a persistent grid of 4 or 8
//    blocks per SM measured slower). gather_rows_kernel stores evict-first
//    (st.global.cs): at D = 8 the output (54.5 MB) is larger than L2
//    anyway, and evict-first measured 9% faster warm and the same cold.
//    The narrow kernel keeps the default policy, so that D = 1's 6.8 MB
//    output stays in L2 for its reader.
//
// The clamp matches XLA's out-of-range gather; hashed slots are always in
// range, so on the training path it never changes a value. A copy is
// bit-exact, so the kernels take any element type by its byte width.
//
// Plain C interface (built with nvcc into a shared library, bound with
// ctypes): launches on the given stream, allocates nothing, synchronises
// nothing, and returns cudaGetLastError() after the launch.

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__host__ __device__ constexpr int log2i(int x) {
  return x <= 1 ? 0 : 1 + log2i(x / 2);
}

// the slot stream is read once: no L1 allocation
__device__ __forceinline__ int4 load_slots4(const int32_t* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ int32_t load_slot(const int32_t* p) {
  int32_t v;
  asm("ld.global.nc.L1::no_allocate.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

template <typename Index>
__device__ __forceinline__ Index clamp_row(int32_t s, Index num_rows) {
  const Index r = s;
  return r < 0 ? Index(0) : (r >= num_rows ? num_rows - 1 : r);
}

// 4-byte rows (D = 1 f32). Units of 4 rows from `head` (slots + head is
// 16-byte aligned): block b takes units [b x kTileUnits, (b + 1) x
// kTileUnits), kRows / 4 of them a thread, strided by the block's width;
// block 0 also copies the head rows and the < 4 rows past the last whole
// unit. vec_store: out + head is 16-byte aligned too.
template <int kRows, typename Index>
__global__ void __launch_bounds__(kThreads)
gather_narrow_kernel(const uint32_t* __restrict__ emb,
                     const int32_t* __restrict__ slots,
                     uint32_t* __restrict__ out, Index n, Index num_rows,
                     int head, int vec_store) {
  static_assert(kRows % 4 == 0, "the narrow kernel moves rows four to a unit");
  constexpr int kUnits = kRows / 4;
  constexpr int kTileUnits = kUnits * kThreads;
  const int tid = threadIdx.x;
  const Index units = (n - head) / 4;
  if (blockIdx.x == 0 && tid < 8) {
    const Index i = tid < 4 ? Index(tid) : head + 4 * units + (tid - 4);
    if (tid < 4 ? tid < head : i < n) {
      out[i] = __ldg(emb + clamp_row(load_slot(slots + i), num_rows));
    }
  }
  const Index u0 = Index(blockIdx.x) * kTileUnits + tid;
  int4 s[kUnits];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const Index u = u0 + k * kThreads;
    if (u < units) s[k] = load_slots4(slots + head + 4 * u);
  }
  uint32_t v[kUnits][4];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    if (u0 + k * kThreads < units) {
      v[k][0] = __ldg(emb + clamp_row(s[k].x, num_rows));
      v[k][1] = __ldg(emb + clamp_row(s[k].y, num_rows));
      v[k][2] = __ldg(emb + clamp_row(s[k].z, num_rows));
      v[k][3] = __ldg(emb + clamp_row(s[k].w, num_rows));
    }
  }
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const Index u = u0 + k * kThreads;
    if (u < units) {
      uint32_t* o = out + head + 4 * u;
      if (vec_store) {
        *reinterpret_cast<uint4*>(o) =
            make_uint4(v[k][0], v[k][1], v[k][2], v[k][3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = v[k][e];
      }
    }
  }
}

// Rows of kWords words (a power of two up to 32), or of `words_per_row`
// words when kWords is 0, with lane groups of 2^group_shift lanes. Block b
// takes the tile of kRows x (row groups per block) rows that starts at
// head + b x (tile rows), stages its slots in shared memory with 16-byte
// loads, and gives each lane group kRows rows strided by the row groups.
// Block 0 also copies the head rows.
template <typename Word, int kWords, int kRows, typename Index>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const Word* __restrict__ emb,
                   const int32_t* __restrict__ slots, Word* __restrict__ out,
                   Index n, Index num_rows, int head, int words_per_row,
                   int group_shift) {
  static_assert(kWords == 0 || (kWords <= 32 && (kWords & (kWords - 1)) == 0),
                "compile-time rows are a power of two words, at most 32");
  static_assert((kRows & (kRows - 1)) == 0, "kRows is a power of two");
  constexpr int kSlots = kRows * (kWords ? kThreads / kWords : kThreads);
  __shared__ __align__(16) int32_t s_slot[kSlots];

  const int wpr = kWords ? kWords : words_per_row;
  const int shift = kWords ? log2i(kWords) : group_shift;
  const int width = 1 << shift;              // lanes per row
  const int groups = kThreads >> shift;      // row groups per block
  const int tile_shift = log2i(kRows) + log2i(kThreads) - shift;
  const int g = threadIdx.x >> shift;
  const int c0 = threadIdx.x & (width - 1);

  if (blockIdx.x == 0 && g < head) {
    const Index r = clamp_row(load_slot(slots + g), num_rows);
    for (int c = c0; c < wpr; c += width) {
      __stcs(out + Index(g) * wpr + c, __ldg(emb + r * wpr + c));
    }
  }
  const Index row0 = head + (Index(blockIdx.x) << tile_shift);
  if (row0 >= n) return;  // N = head: block 0 had only the head
  const Index left = n - row0;
  const int m = left < (Index(1) << tile_shift) ? static_cast<int>(left)
                                                : 1 << tile_shift;
  for (int q = threadIdx.x; 4 * q < m; q += kThreads) {
    if (4 * q + 4 <= m) {
      *reinterpret_cast<int4*>(s_slot + 4 * q) =
          load_slots4(slots + row0 + 4 * q);
    } else {
      for (int e = 4 * q; e < m; ++e) s_slot[e] = load_slot(slots + row0 + e);
    }
  }
  __syncthreads();
  Index r[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int j = k * groups + g;
    r[k] = j < m ? clamp_row(s_slot[j], num_rows) : Index(0);
  }
  for (int c = c0; c < wpr; c += width) {
    Word v[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (k * groups + g < m) v[k] = __ldg(emb + r[k] * wpr + c);
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int j = k * groups + g;
      if (j < m) __stcs(out + (row0 + j) * wpr + c, v[k]);
    }
    if (kWords) break;  // one word per lane: the loop runs once
  }
}

bool aligned(const void* p, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

struct Args {
  const void* emb;
  const int32_t* slots;
  void* out;
  int64_t n, num_rows, words_per_row;
  int head;
  cudaStream_t stream;
};

template <int kRows, typename Index>
cudaError_t launch_narrow(const Args& a) {
  constexpr int64_t tile_units = (kRows / 4) * kThreads;
  const int64_t tiles = ((a.n - a.head) / 4 + tile_units - 1) / tile_units;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  const int vec_store = aligned(static_cast<const uint32_t*>(a.out) + a.head,
                                16);
  // block 0 copies the head and tail rows even where no whole unit is left
  gather_narrow_kernel<kRows, Index>
      <<<static_cast<unsigned>(tiles > 0 ? tiles : 1), kThreads, 0,
         a.stream>>>(static_cast<const uint32_t*>(a.emb), a.slots,
                     static_cast<uint32_t*>(a.out), Index(a.n),
                     Index(a.num_rows), a.head, vec_store);
  return cudaGetLastError();
}

template <typename Word, int kWords, int kRows, typename Index>
cudaError_t launch_rows(const Args& a) {
  int shift = log2i(kWords);
  if (kWords == 0) {  // lane groups: the next power of two, at most a warp
    shift = 0;
    while (shift < 5 && (int64_t(1) << shift) < a.words_per_row) ++shift;
  }
  const int64_t tile_rows = int64_t(kRows) * (kThreads >> shift);
  const int64_t tiles = (a.n - a.head + tile_rows - 1) / tile_rows;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  // block 0 copies the head rows even where no tile follows them
  gather_rows_kernel<Word, kWords, kRows, Index>
      <<<static_cast<unsigned>(tiles > 0 ? tiles : 1), kThreads, 0,
         a.stream>>>(static_cast<const Word*>(a.emb), a.slots,
                     static_cast<Word*>(a.out), Index(a.n),
                     Index(a.num_rows), a.head,
                     static_cast<int>(a.words_per_row), shift);
  return cudaGetLastError();
}

// rows per thread: 8 at D = 1 f32, 2 at D = 8 f32, 4 at D = 128 f32 and at
// every other width
template <typename Word>
cudaError_t dispatch(Args a, int64_t row_bytes) {
  a.words_per_row = row_bytes / static_cast<int64_t>(sizeof(Word));
  const int64_t most = a.n > a.num_rows ? a.n : a.num_rows;
  const bool small = most < (int64_t(1) << 31) / a.words_per_row;
  if constexpr (std::is_same<Word, uint32_t>::value) {
    if (a.words_per_row == 1) {
      return small ? launch_narrow<8, int32_t>(a)
                   : launch_narrow<8, int64_t>(a);
    }
  }
  if constexpr (std::is_same<Word, uint4>::value) {
    if (a.words_per_row == 2) {
      return small ? launch_rows<Word, 2, 2, int32_t>(a)
                   : launch_rows<Word, 2, 2, int64_t>(a);
    }
    if (a.words_per_row == 32) {
      return small ? launch_rows<Word, 32, 4, int32_t>(a)
                   : launch_rows<Word, 32, 4, int64_t>(a);
    }
  }
  return small ? launch_rows<Word, 0, 4, int32_t>(a)
               : launch_rows<Word, 0, 4, int64_t>(a);
}

}  // namespace

extern "C" int gather_rows_launch(const void* emb, const void* slots,
                                  void* out, long long n, long long num_rows,
                                  long long row_bytes, void* stream) {
  // words per row must fit the kernels' int column index; slots are int32
  if (n <= 0 || num_rows <= 0 || row_bytes <= 0 || row_bytes >= (1LL << 31) ||
      !aligned(slots, 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.emb = emb;
  a.slots = static_cast<const int32_t*>(slots);
  a.out = out;
  a.n = n;
  a.num_rows = num_rows;
  a.words_per_row = 0;
  // rows before the first 16-byte aligned slot
  const int64_t to_aligned =
      ((16 - reinterpret_cast<uintptr_t>(slots) % 16) % 16) / 4;
  a.head = static_cast<int>(to_aligned < n ? to_aligned : n);
  a.stream = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (row_bytes % 16 == 0 && aligned(emb, 16) && aligned(out, 16)) {
    err = dispatch<uint4>(a, row_bytes);
  } else if (row_bytes % 8 == 0 && aligned(emb, 8) && aligned(out, 8)) {
    err = dispatch<uint2>(a, row_bytes);
  } else if (row_bytes % 4 == 0 && aligned(emb, 4) && aligned(out, 4)) {
    err = dispatch<uint32_t>(a, row_bytes);
  } else if (row_bytes % 2 == 0 && aligned(emb, 2) && aligned(out, 2)) {
    err = dispatch<uint16_t>(a, row_bytes);
  } else {
    err = dispatch<uint8_t>(a, row_bytes);
  }
  return static_cast<int>(err);
}
