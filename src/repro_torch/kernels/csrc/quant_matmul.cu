// Exact int8 x int8 -> int32 matmul with Theorem-planned K blocks, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py:quant_matmul_pallas
// (body quant_matmul_kernel).  Computes out = x @ w exactly, x (M, K) int8
// row-major, w given K-major as wt (N, K) int8 row-major (the wrapper
// transposes w, and its time counts in the kernel's), out (M, N) int32.
//
// K blocking: the wrapper passes bk = min(plan.block, K) from
// plan_dot_accumulation(K, 8, 8, acc_bits, align=128), the Theorem's bound
// on how many int8 products an acc_bits accumulator sums exactly.  The
// kernel walks K in blocks of bk: each block is summed from zero in its own
// int32 registers, masked at the block's end and at K, and the block
// partials are then added in int32, as the TPU kernel adds each K block's
// product into the revisited output tile.  With int32 accumulators the
// plan is one block for any K up to 131,072.
//
// Design: a block of 256 threads (8 warps, 2 x 4) owns a 128 x 128 output
// tile; each warp a 64 x 32 part of it, 4 x 4 tiles of the tensor cores'
// mma.sync.m16n8k32 s8.s8.s32.  K advances 64 at a time through two
// shared-memory buffers: while the warps multiply one 128 x 64 tile of x
// and of wt, the next pair is already loaded into registers (16 bytes a
// thread per row chunk, one __syncthreads per step).  Rows are padded to 80
// bytes so the fragment reads hit 32 distinct banks.  Ragged M, N and K
// edges read zeros and store nothing.  When K or bk is not a multiple of
// 16, or a pointer is not 16-byte aligned, chunks are read byte by byte.
//
// Bound on this card: operations.  2 M K N int8 operations over 1,979
// TOP/s; the bytes (M K + K N + 4 M N) over 3.35 TB/s take about half as
// long at the training projection shapes.  mma.sync without TMA or wgmma
// reaches only part of that rate; wgmma with a TMA pipeline is the later
// fix.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int LDS = BK + 16;          // padded shared-memory row, bytes
constexpr int THREADS = 256;
constexpr int CHUNKS = BM * BK / 16 / THREADS;   // 16-byte chunks per thread

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of row `row` (of `rows`, leading dimension ld) from column k,
// zero past kend and past the last row.  VEC: k, kend and row * ld are
// multiples of 16 and the base is 16-byte aligned, so a chunk is wholly in
// range or wholly out, and one load.
template <bool VEC>
__device__ __forceinline__ int4 load_chunk(const int8_t* __restrict__ base,
                                           int64_t row, int64_t rows,
                                           int64_t ld, int64_t k,
                                           int64_t kend) {
  if (row >= rows || k >= kend) return make_int4(0, 0, 0, 0);
  const int8_t* p = base + row * ld + k;
  if constexpr (VEC) return __ldg(reinterpret_cast<const int4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (k + j < kend) w[j >> 2] |= (uint32_t)(uint8_t)p[j] << (8 * (j & 3));
  }
  return make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
quant_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                    int32_t* __restrict__ out, int64_t m, int64_t n,
                    int64_t k, int64_t bk) {
  __shared__ __align__(16) int8_t xs[2][BM * LDS];
  __shared__ __align__(16) int8_t ws[2][BN * LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;          // mma group, thread in group
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int64_t m0 = (int64_t)blockIdx.y * BM, n0 = (int64_t)blockIdx.x * BN;

  int32_t acc[4][4][4], part[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = part[i][j][r] = 0;

  // chunk c of a tile: row c / 4, columns (c % 4) * 16 .. + 15
  int4 xr[CHUNKS], wr[CHUNKS];
  auto load = [&](int64_t kt, int64_t kend) {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int ch = tid + c * THREADS, row = ch >> 2, col = (ch & 3) * 16;
      xr[c] = load_chunk<VEC>(x, m0 + row, m, k, kt + col, kend);
      wr[c] = load_chunk<VEC>(wt, n0 + row, n, k, kt + col, kend);
    }
  };

  int64_t kt = 0, kend = bk < k ? bk : k;
  load(kt, kend);
  for (int s = 0;; s ^= 1) {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int ch = tid + c * THREADS, row = ch >> 2, col = (ch & 3) * 16;
      *reinterpret_cast<int4*>(&xs[s][row * LDS + col]) = xr[c];
      *reinterpret_cast<int4*>(&ws[s][row * LDS + col]) = wr[c];
    }
    __syncthreads();
    // the next tile: on in this block, or the first of the next block
    int64_t nkt = kt + BK, nkend = kend;
    const bool block_done = nkt >= kend;
    if (block_done) {
      nkt = kend;
      nkend = kend + bk < k ? kend + bk : k;
    }
    const bool more = nkt < k;
    if (more) load(nkt, nkend);     // in flight while the tensor cores run

#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* r0 = &xs[s][(wm + i * 16 + g) * LDS + kk + t * 4];
        const int8_t* r8 = r0 + 8 * LDS;
        a[i][0] = *reinterpret_cast<const uint32_t*>(r0);
        a[i][1] = *reinterpret_cast<const uint32_t*>(r8);
        a[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* c0 = &ws[s][(wn + j * 8 + g) * LDS + kk + t * 4];
        b[j][0] = *reinterpret_cast<const uint32_t*>(c0);
        b[j][1] = *reinterpret_cast<const uint32_t*>(c0 + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(part[i][j], a[i], b[j][0], b[j][1]);
    }
    if (block_done) {               // add the block partial in int32
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[i][j][r] = (int32_t)((uint32_t)acc[i][j][r] +
                                     (uint32_t)part[i][j][r]);
            part[i][j][r] = 0;
          }
    }
    if (!more) break;
    kt = nkt;
    kend = nkend;
  }

  // D fragment: rows g and g + 8, columns 2 t and 2 t + 1 of each 16 x 8
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int64_t row = m0 + wm + i * 16 + g + (r >> 1) * 8;
        const int64_t col = n0 + wn + j * 8 + t * 2 + (r & 1);
        if (row < m && col < n) out[row * n + col] = acc[i][j][r];
      }
}

}  // namespace

// x: contiguous (m, k) int8; wt: contiguous (n, k) int8 (w transposed);
// out: (m, n) int32; 1 <= bk.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int quant_matmul_launch(const void* x, const void* wt, void* out,
                                   long long m, long long n, long long k,
                                   long long bk, void* stream) {
  if (m < 1 || n < 1 || k < 1 || bk < 1 || (m + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + BN - 1) / BN), (unsigned)((m + BM - 1) / BM));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = k % 16 == 0 && bk % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wt) % 16 == 0;
  if (vec) {
    quant_matmul_kernel<true><<<grid, THREADS, 0, s>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
        static_cast<int32_t*>(out), m, n, k, bk);
  } else {
    quant_matmul_kernel<false><<<grid, THREADS, 0, s>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
        static_cast<int32_t*>(out), m, n, k, bk);
  }
  return (int)cudaGetLastError();
}
