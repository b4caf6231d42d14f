// Exact int8 x int8 -> int32 matmul with Theorem-planned K blocks, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py:quant_matmul_pallas
// (body quant_matmul_kernel).  Computes out = x @ w exactly: x (M, K) int8
// row-major, w (K, N) int8 row-major as the caller gives it, out (M, N)
// int32.  The wrapper picks one of two routes by shape and alignment alone,
// before any launch:
//
//  * qmm_wgmma, when TMA can describe both operands (K and N multiples of
//    16, both bases 16-byte aligned):
//    - Bound on this card: operations.  2 M K N int8 operations over 1,979
//      TOP/s; the bytes (M K + K N + 4 M N) over 3.35 TB/s take about half
//      as long at the training projection shapes, and the int32 result is
//      most of them.
//    - wgmma m64n256k32 s32.s8.s8, the only way to the card's full int8
//      tensor-core rate.  Its 8-bit operands must be K-major (the transpose
//      flags exist for 16-bit types only), and w arrives N-major.  So the
//      kernel swaps the operands and computes out^T = w^T x^T: B is x, read
//      K-major from shared memory straight from its (M, K) rows, and A is
//      w^T, taken into registers from w's own N-major tile.  Rows of A are
//      output columns, so they may be permuted: fragment row r of warp v
//      is column 16 v + 2 (r % 8) + r / 8 of its warpgroup's 64, which
//      gives each thread two adjacent columns.  One u16 load a k then
//      brings both, and four PRMTs turn 4 k x 2 columns into two A
//      registers.  No copy of w is made, by PyTorch or by a kernel.
//    - A block takes 128 output columns x 256 rows: two consumer
//      warpgroups of 64 columns each (setmaxnreg 232; the 128 s32
//      accumulators and two stages of A fragments a thread live in
//      registers) and one producer thread (setmaxnreg 40) that keeps a
//      ring of STAGES = 4 stages in flight by TMA, each a 128 k x 128-byte
//      w tile and a 256 x 128-byte x tile (48 KB), 128-byte swizzled, with
//      full and empty mbarriers.  Four k32 products a stage; a stage's A
//      fragments are loaded while the previous stage's products run.
//    - Persistent: one block per SM walks the output tiles (M fastest, so
//      the blocks in flight share w columns in L2); the producer loads the
//      next tile's stages while the consumers store the last tile.
//    - Epilogue: a thread's two columns are adjacent, so each pair of
//      accumulators is one 8-byte streaming store; a warp writes 64
//      contiguous bytes of 4 rows, whole sectors.  Ragged M, N and K: TMA
//      reads zeros past the edges, rows and columns past M and N are not
//      stored.
//
//  * every other shape (K or N not a multiple of 16, or an unaligned
//    base):
//    - qmm_transpose, the pre-pass: w (K, N) -> wt (N, ldt), ldt = K
//      rounded up to 16 bytes, zeros past K; a bytes-bound kernel.  A block
//      turns a 64 x 64 byte tile through shared memory: 16-byte loads
//      along N, 16-byte stores along K.
//    - qmm_mma_sync: 128 x 128 tiles of mma.sync m16n8k32 s8.s8.s32 on wt,
//      staged by hand through registers and two shared buffers; chunks are
//      read byte by byte where they cannot be read as 16 bytes.
//
// K blocking: the wrapper computes bk = min(plan.block, K) from
// plan_dot_accumulation(K, 8, 8, acc_bits, align=128), the Theorem's bound
// on how many int8 products an acc_bits accumulator sums exactly.  The TPU
// kernel adds each block's int32 partial into its int32 output tile, and
// XLA's integer adds wrap.  qmm_mma_sync walks the same blocks: each summed
// from zero in its own registers, the partials added in int32 with
// wrap-around.  qmm_wgmma keeps one set of accumulators over all of K and
// gives the same bits for every bk: the tensor cores' s32 accumulation
// wraps modulo 2^32 (no .satfinite), every block partial that the plan
// allows fits in int32 (|partial| <= bk * 2^14 < 2^31, except a block of
// 131,072 all -128 products, which is 2^31 and which the plan's bound of
// 2^14 - 1 a product misses), and addition modulo 2^32 does not depend on
// where the blocks end.  The card tests hold this at K = 262,144, two
// blocks whose sum wraps, and with the 8-product blocks of acc_bits = 18.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// qmm_wgmma: TMA ring, swapped-operand wgmma, warp specialisation
// ---------------------------------------------------------------------------

constexpr int BM = 256, BN = 128, BKB = 128;  // output tile; K bytes a stage
constexpr int STAGES = 4;
constexpr int WTILE = BKB * BN;               // 16 KB: 128 k x 128 columns
constexpr int XTILE = BM * BKB;               // 32 KB: 256 rows x 128 k
constexpr int STAGE_BYTES = WTILE + XTILE;    // 48 KB
constexpr int WS_THREADS = 384;               // consumers 0, 1; producer 2
constexpr int WS_SMEM = STAGES * STAGE_BYTES + 1024;   // + 1 KB alignment

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align1k(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Arrive and expect `bytes` of TMA transfers in the barrier's phase.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// One box of a 2-D map: 128 bytes from column `col`, the map's box rows
// from `row`, into shared memory; its bytes complete on `bar`.  Bytes past
// the last column and rows past the last row read as zeros.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets.
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | (uint64_t)1 << 62;
}

// k32 step kk of a tile of 128-byte rows read K-major: 32 bytes a step
// along the swizzled row, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return sdesc(tile + kk * 32, 16, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous products.
__device__ __forceinline__ void keep(int32_t (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// D (64 x 256, s32) = A B (+ D when scale_d), wrapping modulo 2^32: A (64
// x 32 int8) in registers, B (256 x 32 int8) from shared memory, K-major.
__device__ __forceinline__ void wgmma_s8_n256_rs(int32_t (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// Block: 384 threads, 197 KB of dynamic shared memory, one per SM.
__global__ void __launch_bounds__(WS_THREADS, 1)
qmm_wgmma(const __grid_constant__ CUtensorMap tm_x,
          const __grid_constant__ CUtensorMap tm_w,
          int32_t* __restrict__ out, int m, int n, int k) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  unsigned char* ring = align1k(smem_raw);
  const int tiles_m = (m + BM - 1) / BM;
  const int tiles = tiles_m * ((n + BN - 1) / BN);
  const int nk = (k + BKB - 1) / BKB;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: the stages of every tile of the block, in order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % tiles_m) * BM, n0 = (t / tiles_m) * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int st = it % STAGES;
          mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
          mbar_arrive_tx(&full[st], STAGE_BYTES);
          unsigned char* s = ring + st * STAGE_BYTES;
          tma_box(s, &tm_w, n0, kt * BKB, &full[st]);       // 128 k x 128 n
          tma_box(s + WTILE, &tm_x, kt * BKB, m0, &full[st]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, q = lane % 4;
    const int col = wg * 64 + warp * 16 + 2 * g;   // the thread's columns
    // byte offset of (k row 4 q + i, col) in a swizzled w tile; rows
    // 32 kk + 16 hf + 4 q + i have the same swizzle phase (4 q + i) % 8
    uint32_t off[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * q + i;
      off[i] = r * 128 + (((col / 16) ^ (r & 7)) << 4) + col % 16;
    }
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % tiles_m) * BM, n0 = (t / tiles_m) * BN;
      int32_t acc[128];
      uint32_t a0[BKB / 32][4], a1[BKB / 32][4];   // A of alternate stages
      int st = 0;
      // One stage: A from the w tile into registers, then its 4 products.
      // The registers of the stage before stay untouched until its
      // products are done (wait_group 1).
      auto stage = [&](int kt, uint32_t (&a)[BKB / 32][4]) {
        const int prev = st;
        st = it % STAGES;
        mbar_wait(&full[st], (it / STAGES) & 1);
        const unsigned char* ws = ring + st * STAGE_BYTES;
#pragma unroll
        for (int kk = 0; kk < BKB / 32; ++kk) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {   // k 4q..4q+3, then 16 + that
            uint32_t h[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              h[i] = *reinterpret_cast<const uint16_t*>(
                  ws + (kk * 32 + hf * 16) * 128 + off[i]);
            const uint32_t t01 = prmt(h[0], h[1], 0x5410);
            const uint32_t t23 = prmt(h[2], h[3], 0x5410);
            a[kk][2 * hf] = prmt(t01, t23, 0x6420);       // column col
            a[kk][2 * hf + 1] = prmt(t01, t23, 0x7531);   // col + 1
          }
        }
        const uint32_t xb = smem_u32(ws + WTILE);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BKB / 32; ++kk)
          wgmma_s8_n256_rs(acc, a[kk], kmajor(xb, kk), kt > 0 || kk > 0);
        wg_commit();
        wg_wait<1>();               // the previous stage's products are done
        if (kt > 0) mbar_arrive(&empty[prev]);
        ++it;
      };
      int kt = 0;
      for (; kt + 1 < nk; kt += 2) {
        stage(kt, a0);
        stage(kt + 1, a1);
      }
      if (kt < nk) stage(kt, a0);
      wg_wait<0>();
      mbar_arrive(&empty[st]);
      keep(acc);
      // acc[4 j + c] is (row 8 j + 2 q + c, column col), acc[4 j + 2 + c]
      // the same row at col + 1: one 8-byte store (N is even)
      const int64_t cn = (int64_t)n0 + col;
      int32_t* p0 = out + ((int64_t)m0 + 2 * q) * n + cn;
      if ((int64_t)m0 + BM <= m && (int64_t)n0 + BN <= n) {   // a whole tile
#pragma unroll
        for (int j = 0; j < BM / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            __stcs(reinterpret_cast<int2*>(p0 + (8 * j + c) * (int64_t)n),
                   make_int2(acc[4 * j + c], acc[4 * j + 2 + c]));
      } else if (cn < n) {
#pragma unroll
        for (int j = 0; j < BM / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if ((int64_t)m0 + 8 * j + 2 * q + c < m)
              __stcs(reinterpret_cast<int2*>(p0 + (8 * j + c) * (int64_t)n),
                     make_int2(acc[4 * j + c], acc[4 * j + 2 + c]));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// qmm_transpose: w (K, N) -> wt (N, ldt), the mma.sync route's pre-pass
// ---------------------------------------------------------------------------

constexpr int TT = 64;                 // 64 x 64 byte tile, 256 threads

// VEC: N % 16 == 0 and w 16-byte aligned, so a 16-byte chunk of a row is
// wholly in range or wholly out.  Rows of the tile past K are zeros, and so
// is wt past K.
template <bool VEC>
__global__ void __launch_bounds__(256)
qmm_transpose(const int8_t* __restrict__ w, int8_t* __restrict__ wt,
              int64_t k, int64_t n, int64_t ldt) {
  __shared__ __align__(16) uint8_t tile[TT][TT];     // [k][n]
  const int tid = threadIdx.x;
  const int64_t k0 = (int64_t)blockIdx.x * TT, n0 = (int64_t)blockIdx.y * TT;
  {  // row tid / 4 of the tile, 16 bytes of N from (tid % 4) * 16
    const int r = tid >> 2, c = (tid & 3) * 16;
    const int64_t kr = k0 + r, nc = n0 + c;
    int4 v = make_int4(0, 0, 0, 0);
    if (kr < k && nc < n) {
      const int8_t* p = w + kr * n + nc;
      if constexpr (VEC) {
        v = __ldg(reinterpret_cast<const int4*>(p));
      } else {
        uint32_t q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (nc + j < n) q[j >> 2] |= (uint32_t)(uint8_t)p[j] << (8 * (j & 3));
        v = make_int4((int)q[0], (int)q[1], (int)q[2], (int)q[3]);
      }
    }
    *reinterpret_cast<int4*>(&tile[r][c]) = v;
  }
  __syncthreads();
  {  // column tid % 64 of the tile (a row of wt), 16 bytes of K from
     // (tid / 64) * 16: a warp reads 32 adjacent bytes of one tile row
    const int nn = tid & 63, kc = (tid >> 6) * 16;
    const int64_t nr = n0 + nn, kk = k0 + kc;
    if (nr < n && kk < ldt) {
      uint32_t q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        q[i] = (uint32_t)tile[kc + 4 * i][nn] |
               (uint32_t)tile[kc + 4 * i + 1][nn] << 8 |
               (uint32_t)tile[kc + 4 * i + 2][nn] << 16 |
               (uint32_t)tile[kc + 4 * i + 3][nn] << 24;
      *reinterpret_cast<int4*>(wt + nr * ldt + kk) =
          make_int4((int)q[0], (int)q[1], (int)q[2], (int)q[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// qmm_mma_sync: the route for shapes TMA cannot describe
// ---------------------------------------------------------------------------
//
// A block of 256 threads (8 warps, 2 x 4) owns a 128 x 128 output tile;
// each warp a 64 x 32 part of it, 4 x 4 tiles of mma.sync.m16n8k32
// s8.s8.s32.  K advances 64 at a time through two shared-memory buffers:
// while the warps multiply one 128 x 64 tile of x and of wt, the next pair
// is already loaded into registers (16 bytes a thread per row chunk, one
// __syncthreads per step).  Rows are padded to 80 bytes so the fragment
// reads hit 32 distinct banks.

constexpr int MS_BM = 128, MS_BN = 128, MS_BK = 64;
constexpr int LDS = MS_BK + 16;       // padded shared-memory row, bytes
constexpr int MS_THREADS = 256;
constexpr int CHUNKS = MS_BM * MS_BK / 16 / MS_THREADS;  // per thread

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
__global__ void __launch_bounds__(MS_THREADS)
qmm_mma_sync(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
             int64_t ldw, int32_t* __restrict__ out, int64_t m, int64_t n,
             int64_t k, int64_t bk) {
  __shared__ __align__(16) int8_t xs[2][MS_BM * LDS];
  __shared__ __align__(16) int8_t ws[2][MS_BN * LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;          // mma group, thread in group
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int64_t m0 = (int64_t)blockIdx.y * MS_BM;
  const int64_t n0 = (int64_t)blockIdx.x * MS_BN;

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
      const int ch = tid + c * MS_THREADS, row = ch >> 2, col = (ch & 3) * 16;
      xr[c] = load_chunk<VEC>(x, m0 + row, m, k, kt + col, kend);
      wr[c] = load_chunk<VEC>(wt, n0 + row, n, ldw, kt + col, kend);
    }
  };

  int64_t kt = 0, kend = bk < k ? bk : k;
  load(kt, kend);
  for (int s = 0;; s ^= 1) {
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int ch = tid + c * MS_THREADS, row = ch >> 2, col = (ch & 3) * 16;
      *reinterpret_cast<int4*>(&xs[s][row * LDS + col]) = xr[c];
      *reinterpret_cast<int4*>(&ws[s][row * LDS + col]) = wr[c];
    }
    __syncthreads();
    // the next tile: on in this block, or the first of the next block
    int64_t nkt = kt + MS_BK, nkend = kend;
    const bool block_done = nkt >= kend;
    if (block_done) {
      nkt = kend;
      nkend = kend + bk < k ? kend + bk : k;
    }
    const bool more = nkt < k;
    if (more) load(nkt, nkend);     // in flight while the tensor cores run

#pragma unroll
    for (int kk = 0; kk < MS_BK; kk += 32) {
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

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 2-D map (cols, rows) of an int8 matrix with rows of `ld` bytes:
// boxes of 128 columns by `box_rows` rows, 128-byte swizzle, zeros past
// the last column and row.
cudaError_t map_2d(CUtensorMap* map, const void* ptr, long long rows,
                   long long cols, long long ld, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {BKB, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// w: contiguous (k, n) int8; wt: (n, ldt) int8 with ldt = k rounded up to
// a multiple of 16, 16-byte aligned.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int quant_matmul_transpose_launch(const void* w, void* wt,
                                             long long k, long long n,
                                             long long ldt, void* stream) {
  if (k < 1 || n < 1 || ldt < k || ldt % 16 != 0 || !aligned16(wt) ||
      (n + TT - 1) / TT > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((ldt + TT - 1) / TT), (unsigned)((n + TT - 1) / TT));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n % 16 == 0 && aligned16(w)) {
    qmm_transpose<true><<<grid, 256, 0, s>>>(
        static_cast<const int8_t*>(w), static_cast<int8_t*>(wt), k, n, ldt);
  } else {
    qmm_transpose<false><<<grid, 256, 0, s>>>(
        static_cast<const int8_t*>(w), static_cast<int8_t*>(wt), k, n, ldt);
  }
  return (int)cudaGetLastError();
}

// x: contiguous (m, k) int8; w: contiguous (k, n) int8; k % 16 == 0,
// n % 16 == 0, both 16-byte aligned; out: (m, n) int32.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int quant_matmul_wgmma_launch(const void* x, const void* w,
                                         void* out, long long m, long long n,
                                         long long k, void* stream) {
  if (m < 1 || n < 1 || k < 1 || k % 16 != 0 || n % 16 != 0 ||
      !aligned16(x) || !aligned16(w) || m > 0x7fffffffLL ||
      n > 0x7fffffffLL || k > 0x7fffffffLL ||
      ((m + BM - 1) / BM) * ((n + BN - 1) / BN) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_x, tm_w;
  cudaError_t err = map_2d(&tm_x, x, m, k, k, BM);     // x: 256 rows of K
  if (err == cudaSuccess) err = map_2d(&tm_w, w, k, n, n, BKB);  // 128 k x N
  if (err != cudaSuccess) return (int)err;
  static bool configured = false;
  if (!configured) {
    err = cudaFuncSetAttribute(qmm_wgmma,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WS_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  qmm_wgmma<<<grid, WS_THREADS, WS_SMEM, static_cast<cudaStream_t>(stream)>>>(
      tm_x, tm_w, static_cast<int32_t*>(out), (int)m, (int)n, (int)k);
  return (int)cudaGetLastError();
}

// x: contiguous (m, k) int8; wt: (n, ldw) int8 (w transposed, rows of ldw
// >= k bytes); out: (m, n) int32; 1 <= bk.  Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int quant_matmul_mma_sync_launch(const void* x, const void* wt,
                                            long long ldw, void* out,
                                            long long m, long long n,
                                            long long k, long long bk,
                                            void* stream) {
  if (m < 1 || n < 1 || k < 1 || bk < 1 || ldw < k ||
      (m + MS_BM - 1) / MS_BM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + MS_BN - 1) / MS_BN),
                  (unsigned)((m + MS_BM - 1) / MS_BM));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = k % 16 == 0 && bk % 16 == 0 && ldw % 16 == 0 &&
                   aligned16(x) && aligned16(wt);
  if (vec) {
    qmm_mma_sync<true><<<grid, MS_THREADS, 0, s>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt), ldw,
        static_cast<int32_t*>(out), m, n, k, bk);
  } else {
    qmm_mma_sync<false><<<grid, MS_THREADS, 0, s>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt), ldw,
        static_cast<int32_t*>(out), m, n, k, bk);
  }
  return (int)cudaGetLastError();
}
