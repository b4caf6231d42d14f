// Causal / non-causal GQA flash attention for Hopper (sm_90a): the forward
// pass and a FlashAttention-2 style backward pass in two kernels.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (body flash_attention_kernel).  It computes what
// that kernel computes -- softmax(q k^T * scale) v per q head, k/v shared by
// the rep = Hq / Hkv q heads of a group, fp32 inside, masked scores set to
// the finite -1e30 of the reference, the output divided by max(l, 1e-30)
// -- and it also writes the row log-sum-exp lse = m + log(max(l, 1e-30)) in
// fp32, which the backward needs.  The reference has no backward kernel
// (flash_attention_pallas has no VJP), so the backward here follows
// FlashAttention-2:
//   delta = rowsum(dO * O);  P = exp(S * scale - lse);
//   dV = P^T dO;  dP = dO V^T;  dS = P * (dP - delta);
//   dQ = dS K * scale;  dK = dS^T Q * scale.
//
// Layout, as at the public function: q, o, do, dq are (B, S, Hq, HD) and
// k, v, dk, dv are (B, S, Hkv, HD), contiguous; lse and delta are
// (B, Hq, S) fp32.  q rows are folded per KV group as in the TPU wrapper:
// row r of group (b, hkv) is q head hkv * rep + r / S at position r % S.
// HD is a template parameter (16, 32, 64, 80 or 128; the wrapper pads any
// other head dim with zeros).  S need not divide any tile: ragged tiles
// are masked.  fp32 and bf16 inputs; sums and the softmax are fp32.
//
// Design.  The TPU kernel carries (m, l, acc) across a sequential grid
// axis over K blocks; here every block loops over its K/V tiles itself and
// nothing carries between blocks.  Each of the three kernels exists twice:
// fp32 inputs run on the CUDA cores (fp32 FMAs, so fp32 results stay
// within 2e-5 of the plain version), bf16 inputs on the tensor cores
// (mma.sync, below).  The grids are the same.
//
// fp32, CUDA cores:
//  * Four consecutive lanes own one row: each holds HD / 4 of its dims as
//    float4 chunks lane, lane + 4, lane + 8, ... so the four lanes read 64
//    contiguous bytes of a shared-memory row (no bank conflicts, and the
//    eight rows of a warp read the same addresses: broadcast).  A dot
//    product is a partial sum per lane and two xor shuffles.
//  * fa_fwd: one block per (64 folded q rows, b * Hkv + hkv).  K/V tiles of
//    32 rows are staged in shared memory as fp32; the online softmax keeps
//    (m, l, acc) in registers.  Causal: only the tiles up to the block's
//    last q position are read.
//  * fa_bwd_dq: one block per (64 folded q rows, group).  It first forms
//    delta for its rows (written out for fa_bwd_dkv), then loops over the
//    same K/V tiles and accumulates dQ in registers.
//  * fa_bwd_dkv: one block per (32 keys, group).  It loops over the q rows
//    of all rep heads of the group (causal: from the tile holding its first
//    key), staged 32 at a time, so the GQA sum into dK and dV stays in
//    registers of one block.  No atomics anywhere: every output element has
//    one writer, and results repeat bit for bit from run to run.
//
// bf16, tensor cores: the same blocks with 4 warps of 16 rows (keys in
// fa_bwd_dkv); each product is a sequence of mma.sync.m16n8k16 with fp32
// accumulators, probabilities and dS rounded to bf16 as the A operand of
// the next product (FlashAttention-2's choice).  K/V (or Q/dO) tiles are
// staged row-major and, where a product needs them as the k axis,
// transposed.  fa_bwd_dkv keeps 64 keys of K and V plus a 32-row q tile of
// Q and dO in both layouts: 71 KB of dynamic shared memory at HD 128, set
// with cudaFuncSetAttribute.
//
// Bound on this card: operations.  Causal forward does 2 matmuls of
// 2 * HD flops per visible (q, k) pair, the backward 5 (FlashAttention-2
// recomputes S; these two kernels recompute S and dP once each, 7 in all).
// mma.sync reaches only part of the 989 TFLOP/s bf16 peak (wgmma, TMA and
// warp specialisation are later work); fp32 runs at the CUDA cores' 67
// TFLOP/s at best.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;  // the reference's mask value: finite
constexpr int TPR = 4;             // lanes per row

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// Dims of chunk i of a lane: 4 * (lane + TPR * i) .. + 3.
__device__ __forceinline__ int dim_of(int lane, int i) { return 4 * (lane + TPR * i); }

// Sum of a value over the four lanes of a row (all lanes get the sum).
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// Dot of a lane's chunks with the same dims of a shared-memory row, summed
// over the row's four lanes.
template <int NC>
__device__ __forceinline__ float row_dot(const float4 (&a)[NC],
                                         const float* srow, int lane) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const float4 b = *reinterpret_cast<const float4*>(srow + dim_of(lane, i));
    s = fmaf(a[i].x, b.x, s);
    s = fmaf(a[i].y, b.y, s);
    s = fmaf(a[i].z, b.z, s);
    s = fmaf(a[i].w, b.w, s);
  }
  return row_sum(s);
}

// acc += w * srow (this lane's chunks)
template <int NC>
__device__ __forceinline__ void axpy(float4 (&acc)[NC], float w,
                                     const float* srow, int lane) {
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const float4 b = *reinterpret_cast<const float4*>(srow + dim_of(lane, i));
    acc[i].x = fmaf(w, b.x, acc[i].x);
    acc[i].y = fmaf(w, b.y, acc[i].y);
    acc[i].z = fmaf(w, b.z, acc[i].z);
    acc[i].w = fmaf(w, b.w, acc[i].w);
  }
}

template <int NC>
__device__ __forceinline__ void load_row(float4 (&r)[NC], const float* p,
                                         int lane, bool live) {
#pragma unroll
  for (int i = 0; i < NC; ++i) r[i] = live ? ld4(p + dim_of(lane, i)) : zero4();
}

template <int NC>
__device__ __forceinline__ void store_row(float* p, const float4 (&r)[NC],
                                          float mul, int lane) {
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    st4(p + dim_of(lane, i), make_float4(r[i].x * mul, r[i].y * mul,
                                         r[i].z * mul, r[i].w * mul));
  }
}

// dst[r][:] = base[(first + r) * stride + :], zero for rows at or past
// `limit`.  All threads of the block take part.
template <int ROWS, int HD>
__device__ __forceinline__ void stage(float (*dst)[HD], const float* base,
                                      int64_t stride, int first, int limit) {
  constexpr int C4 = HD / 4;
  for (int idx = threadIdx.x; idx < ROWS * C4; idx += blockDim.x) {
    const int r = idx / C4, c = idx % C4;
    const float4 val = first + r < limit
        ? ld4(base + (int64_t)(first + r) * stride + 4 * c) : zero4();
    *reinterpret_cast<float4*>(&dst[r][4 * c]) = val;
  }
}

// Folded q row `row` of the group (b, hkv) = blockIdx.y: q head
// hkv * rep + row / S at position row % S.
struct QRow {
  bool live;      // row < rep * S
  int pos;
  int64_t off;    // element offset of (b, pos, head, 0) in q / o / do / dq
  int64_t stat;   // index of (b, head, pos) in lse / delta

  __device__ QRow(int row, int HD, int S, int Hq, int Hkv) {
    const int rep = Hq / Hkv;
    const int b = blockIdx.y / Hkv, hkv = blockIdx.y % Hkv;
    live = row < rep * S;
    pos = live ? row % S : 0;
    const int head = hkv * rep + (live ? row / S : 0);
    off = (((int64_t)b * S + pos) * Hq + head) * HD;
    stat = ((int64_t)b * Hq + head) * S + pos;
  }
};

// Keys 0 .. end - 1 are what a block of folded q rows row0 .. row0 + rows
// - 1 must visit: all, or (causal) up to the last position among its rows
// (a block that straddles two heads of the group holds position S - 1).
__device__ __forceinline__ int keys_to_visit(int row0, int rows, int S,
                                             int rep, int causal) {
  const int last = min(row0 + rows, rep * S) - 1;
  return !causal ? S : (row0 / S == last / S ? last % S + 1 : S);
}

template <int HD, int BQ, int BK>
__global__ void __launch_bounds__(BQ * TPR)
fa_fwd(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, float* __restrict__ o,
       float* __restrict__ lse, int S, int Hq, int Hkv, float scale,
       int causal) {
  constexpr int NC = HD / (4 * TPR);
  __shared__ __align__(16) float Ks[BK][HD];
  __shared__ __align__(16) float Vs[BK][HD];
  const int lane = threadIdx.x % TPR;
  const QRow r(blockIdx.x * BQ + threadIdx.x / TPR, HD, S, Hq, Hkv);
  const int64_t off = r.off;
  const int kend = keys_to_visit(blockIdx.x * BQ, BQ, S, Hq / Hkv, causal);
  const int b = blockIdx.y / Hkv, hkv = blockIdx.y % Hkv;
  const int64_t kvstride = (int64_t)Hkv * HD;
  const float* kb = k + ((int64_t)b * S * Hkv + hkv) * HD;
  const float* vb = v + ((int64_t)b * S * Hkv + hkv) * HD;

  float4 qv[NC], acc[NC];
  load_row<NC>(qv, q + off, lane, r.live);
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = zero4();
  float m = NEG_INF, l = 0.f;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    stage<BK, HD>(Ks, kb, kvstride, k0, S);
    stage<BK, HD>(Vs, vb, kvstride, k0, S);
    __syncthreads();
    float s[BK];
    float mt = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int key = k0 + j;
      float sj = row_dot<NC>(qv, Ks[j], lane) * scale;
      if (causal && key > r.pos) sj = NEG_INF;
      if (key >= S) sj = -INFINITY;   // past the end: no term at all
      s[j] = sj;
      mt = fmaxf(mt, sj);
    }
    const float corr = expf(m - mt);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      acc[i].x *= corr; acc[i].y *= corr; acc[i].z *= corr; acc[i].w *= corr;
    }
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - mt);
      psum += p;
      axpy<NC>(acc, p, Vs[j], lane);
    }
    l = l * corr + psum;
    m = mt;
  }
  if (r.live) {
    const float lc = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      acc[i].x /= lc; acc[i].y /= lc; acc[i].z /= lc; acc[i].w /= lc;
    }
    store_row<NC>(o + off, acc, 1.f, lane);
    if (lane == 0) lse[r.stat] = m + logf(lc);
  }
}

template <int HD, int BQ, int BK>
__global__ void __launch_bounds__(BQ * TPR)
fa_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ o,
          const float* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, float* __restrict__ dq,
          int S, int Hq, int Hkv, float scale, int causal) {
  constexpr int NC = HD / (4 * TPR);
  __shared__ __align__(16) float Ks[BK][HD];
  __shared__ __align__(16) float Vs[BK][HD];
  const int lane = threadIdx.x % TPR;
  const QRow r(blockIdx.x * BQ + threadIdx.x / TPR, HD, S, Hq, Hkv);
  const int64_t off = r.off;
  const int kend = keys_to_visit(blockIdx.x * BQ, BQ, S, Hq / Hkv, causal);
  const int b = blockIdx.y / Hkv, hkv = blockIdx.y % Hkv;
  const int64_t kvstride = (int64_t)Hkv * HD;
  const float* kb = k + ((int64_t)b * S * Hkv + hkv) * HD;
  const float* vb = v + ((int64_t)b * S * Hkv + hkv) * HD;

  float4 qv[NC], dov[NC], acc[NC];
  load_row<NC>(qv, q + off, lane, r.live);
  load_row<NC>(dov, dout + off, lane, r.live);
  // delta = rowsum(dO * O)
  load_row<NC>(acc, o + off, lane, r.live);
  float dl = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    dl = fmaf(dov[i].x, acc[i].x, dl);
    dl = fmaf(dov[i].y, acc[i].y, dl);
    dl = fmaf(dov[i].z, acc[i].z, dl);
    dl = fmaf(dov[i].w, acc[i].w, dl);
    acc[i] = zero4();
  }
  dl = row_sum(dl);
  const float lr = r.live ? lse[r.stat] : 0.f;
  if (r.live && lane == 0) delta[r.stat] = dl;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    stage<BK, HD>(Ks, kb, kvstride, k0, S);
    stage<BK, HD>(Vs, vb, kvstride, k0, S);
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < BK; ++j) {
      const int key = k0 + j;
      const float sd = row_dot<NC>(qv, Ks[j], lane);
      const float dp = row_dot<NC>(dov, Vs[j], lane);
      const bool vis = key < S && !(causal && key > r.pos);
      const float p = vis ? expf(sd * scale - lr) : 0.f;
      axpy<NC>(acc, p * (dp - dl), Ks[j], lane);
    }
  }
  if (r.live) store_row<NC>(dq + off, acc, scale, lane);
}

template <int HD, int BKK, int BQQ>
__global__ void __launch_bounds__(BKK * TPR)
fa_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dk, float* __restrict__ dv,
           int S, int Hq, int Hkv, float scale, int causal) {
  constexpr int NC = HD / (4 * TPR);
  __shared__ __align__(16) float Qs[BQQ][HD];
  __shared__ __align__(16) float Ds[BQQ][HD];
  __shared__ float Ls[BQQ];
  __shared__ float Dl[BQQ];
  const int lane = threadIdx.x % TPR;
  const int rep = Hq / Hkv;
  const int b = blockIdx.y / Hkv, hkv = blockIdx.y % Hkv;
  const int k0 = blockIdx.x * BKK;
  const int key = k0 + threadIdx.x / TPR;
  const bool live = key < S;
  const int64_t koff = (((int64_t)b * S + key) * Hkv + hkv) * HD;

  float4 kv[NC], vv[NC], dka[NC], dva[NC];
  load_row<NC>(kv, k + koff, lane, live);
  load_row<NC>(vv, v + koff, lane, live);
#pragma unroll
  for (int i = 0; i < NC; ++i) { dka[i] = zero4(); dva[i] = zero4(); }

  const int64_t qstride = (int64_t)Hq * HD;
  for (int g = 0; g < rep; ++g) {
    const int head = hkv * rep + g;
    const float* qb = q + ((int64_t)b * S * Hq + head) * HD;
    const float* db = dout + ((int64_t)b * S * Hq + head) * HD;
    const int64_t sb = ((int64_t)b * Hq + head) * S;
    // causal: q rows before this block's first key see none of its keys
    for (int q0 = causal ? (k0 / BQQ) * BQQ : 0; q0 < S; q0 += BQQ) {
      __syncthreads();
      stage<BQQ, HD>(Qs, qb, qstride, q0, S);
      stage<BQQ, HD>(Ds, db, qstride, q0, S);
      if (threadIdx.x < BQQ) {
        const bool in = q0 + (int)threadIdx.x < S;
        Ls[threadIdx.x] = in ? lse[sb + q0 + threadIdx.x] : 0.f;
        Dl[threadIdx.x] = in ? delta[sb + q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
      const int nq = min(BQQ, S - q0);
#pragma unroll 4
      for (int i = 0; i < nq; ++i) {
        const float sd = row_dot<NC>(kv, Qs[i], lane);
        const float dp = row_dot<NC>(vv, Ds[i], lane);
        const bool vis = live && !(causal && key > q0 + i);
        const float p = vis ? expf(sd * scale - Ls[i]) : 0.f;
        axpy<NC>(dva, p, Ds[i], lane);
        axpy<NC>(dka, p * (dp - Dl[i]), Qs[i], lane);
      }
    }
  }
  if (live) {
    store_row<NC>(dk + koff, dka, scale, lane);
    store_row<NC>(dv + koff, dva, 1.f, lane);
  }
}

// ---------------------------------------------------------------------------
// bf16: the same three kernels on the tensor cores (mma.sync m16n8k16, fp32
// accumulators), FlashAttention-2's register layout.  A warp owns 16 rows;
// with g = lane / 4 and t = lane % 4 a thread holds, of a 16 x 8 fp32
// accumulator tile, rows g and g + 8 at columns 2t and 2t + 1.  Score tiles
// become the A operand of the next product in registers (rounded to bf16,
// as FlashAttention-2 does); every B operand is read from shared memory as
// bf16 pairs, with the layouts padded by 8 elements a row so that the 32
// lanes of a fragment load hit 32 different banks.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld2(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  __nv_bfloat162 v;
  *reinterpret_cast<uint32_t*>(&v) = u;
  return __bfloat1622float2(v);
}

// A fragment (16 x 16, row-major) of rows r0 .. r0 + 15 and columns c0 ..
// c0 + 15 of a bf16 array with row stride ld.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* base,
                                       int ld, int r0, int c0, int g, int t) {
  a[0] = ld2(base + (r0 + g) * ld + c0 + 2 * t);
  a[1] = ld2(base + (r0 + g + 8) * ld + c0 + 2 * t);
  a[2] = ld2(base + (r0 + g) * ld + c0 + 2 * t + 8);
  a[3] = ld2(base + (r0 + g + 8) * ld + c0 + 2 * t + 8);
}

// B fragment (16 x 8) whose column n is row n0 + n of a bf16 array with row
// stride ld, k running along that row from c0.
__device__ __forceinline__ void frag_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* base, int ld, int n0,
                                       int c0, int g, int t) {
  b0 = ld2(base + (n0 + g) * ld + c0 + 2 * t);
  b1 = ld2(base + (n0 + g) * ld + c0 + 2 * t + 8);
}

// Two accumulator tiles (16 x 8 each, adjacent in k) as one A fragment.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack2(lo[0], lo[1]);
  a[1] = pack2(lo[2], lo[3]);
  a[2] = pack2(hi[0], hi[1]);
  a[3] = pack2(hi[2], hi[3]);
}

// dst[r * LD + :HD] = base[(first + r) * stride + :HD], zero for rows at or
// past `limit`; 16-byte copies, all threads of the block.
template <int ROWS, int HD, int LD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* base,
                                           int64_t stride, int first,
                                           int limit) {
  constexpr int C8 = HD / 8;
  for (int idx = threadIdx.x; idx < ROWS * C8; idx += blockDim.x) {
    const int r = idx / C8, c = idx % C8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (first + r < limit)
      val = *reinterpret_cast<const uint4*>(base + (first + r) * stride + 8 * c);
    *reinterpret_cast<uint4*>(dst + r * LD + 8 * c) = val;
  }
}

// The transpose: dst[d * LD + r] = base[(first + r) * stride + d].
template <int ROWS, int HD, int LD>
__device__ __forceinline__ void stage_cols(bf16* dst, const bf16* base,
                                           int64_t stride, int first,
                                           int limit) {
  constexpr int C8 = HD / 8;
  for (int idx = threadIdx.x; idx < ROWS * C8; idx += blockDim.x) {
    const int r = idx % ROWS, c = idx / ROWS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (first + r < limit)
      val = *reinterpret_cast<const uint4*>(base + (first + r) * stride + 8 * c);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(8 * c + i) * LD + r] = e[i];
  }
}

template <int HD, int BK>
__global__ void __launch_bounds__(128)
fa_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o,
           float* __restrict__ lse, int S, int Hq, int Hkv, float scale,
           int causal) {
  constexpr int KS = HD / 16, NT = HD / 8, KT = BK / 8;
  constexpr int LDK = HD + 8, LDV = BK + 8;
  __shared__ __align__(16) bf16 Ks[BK * LDK];
  __shared__ __align__(16) bf16 Vt[HD * LDV];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // this lane's rows of the block's 64: g and g + 8 of the warp's 16
  const int row = blockIdx.x * 64 + warp * 16 + g;
  const QRow r[2] = {QRow(row, HD, S, Hq, Hkv),
                     QRow(row + 8, HD, S, Hq, Hkv)};
  const int kend = keys_to_visit(blockIdx.x * 64, 64, S, Hq / Hkv, causal);
  const int b = blockIdx.y / Hkv, hkv = blockIdx.y % Hkv;
  const int64_t kvstride = (int64_t)Hkv * HD;
  const bf16* kb = k + ((int64_t)b * S * Hkv + hkv) * HD;
  const bf16* vb = v + ((int64_t)b * S * Hkv + hkv) * HD;

  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = r[0].live ? ld2(q + r[0].off + c) : 0u;
    qa[kk][1] = r[1].live ? ld2(q + r[1].off + c) : 0u;
    qa[kk][2] = r[0].live ? ld2(q + r[0].off + c + 8) : 0u;
    qa[kk][3] = r[1].live ? ld2(q + r[1].off + c + 8) : 0u;
  }
  float oacc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    stage_rows<BK, HD, LDK>(Ks, kb, kvstride, k0, S);
    stage_cols<BK, HD, LDV>(Vt, vb, kvstride, k0, S);
    __syncthreads();
    float s[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        uint32_t b0, b1;
        frag_b(b0, b1, Ks, LDK, j * 8, kk * 16, g, t);
        mma16816(s[j], qa[kk], b0, b1);
      }
    }
    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < KT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, key = k0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (causal && key > r[h].pos) x = NEG_INF;
        if (key >= S) x = -INFINITY;   // past the end: no term at all
        s[j][e] = x;
        mt[h] = fmaxf(mt[h], x);
      }
    }
    float corr[2], lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      corr[h] = expf(m[h] - mt[h]);
      m[h] = mt[h];
    }
#pragma unroll
    for (int j = 0; j < KT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - mt[e / 2]);
        s[j][e] = p;
        lsum[e / 2] += p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + lsum[h];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      oacc[n][0] *= corr[0]; oacc[n][1] *= corr[0];
      oacc[n][2] *= corr[1]; oacc[n][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        frag_b(b0, b1, Vt, LDV, n * 8, kk * 16, g, t);
        mma16816(oacc[n], pa, b0, b1);
      }
    }
  }
  // l is a per-lane partial (each lane summed its own columns)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float lc = fmaxf(l[h], 1e-30f);
    if (!r[h].live) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<uint32_t*>(o + r[h].off + n * 8 + 2 * t) =
          pack2(oacc[n][2 * h] / lc, oacc[n][2 * h + 1] / lc);
    }
    if (t == 0) lse[r[h].stat] = m[h] + logf(lc);
  }
}

template <int HD, int BK>
__global__ void __launch_bounds__(128)
fa_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ o,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ delta, bf16* __restrict__ dq, int S,
              int Hq, int Hkv, float scale, int causal) {
  constexpr int KS = HD / 16, NT = HD / 8, KT = BK / 8;
  constexpr int LDK = HD + 8, LDT = BK + 8;
  __shared__ __align__(16) bf16 Ks[BK * LDK];
  __shared__ __align__(16) bf16 Vs[BK * LDK];
  __shared__ __align__(16) bf16 Kt[HD * LDT];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // this lane's rows of the block's 64: g and g + 8 of the warp's 16
  const int row = blockIdx.x * 64 + warp * 16 + g;
  const QRow r[2] = {QRow(row, HD, S, Hq, Hkv),
                     QRow(row + 8, HD, S, Hq, Hkv)};
  const int kend = keys_to_visit(blockIdx.x * 64, 64, S, Hq / Hkv, causal);
  const int b = blockIdx.y / Hkv, hkv = blockIdx.y % Hkv;
  const int64_t kvstride = (int64_t)Hkv * HD;
  const bf16* kb = k + ((int64_t)b * S * Hkv + hkv) * HD;
  const bf16* vb = v + ((int64_t)b * S * Hkv + hkv) * HD;

  uint32_t qa[KS][4], da[KS][4];
  float dl[2] = {0.f, 0.f}, lr[2];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i & 1, c = kk * 16 + 2 * t + (i >> 1) * 8;
      qa[kk][i] = r[h].live ? ld2(q + r[h].off + c) : 0u;
      da[kk][i] = r[h].live ? ld2(dout + r[h].off + c) : 0u;
      // delta = rowsum(dO * O), O as stored
      const float2 ov = unpack2(r[h].live ? ld2(o + r[h].off + c) : 0u);
      const float2 dv = unpack2(da[kk][i]);
      dl[h] = fmaf(ov.x, dv.x, fmaf(ov.y, dv.y, dl[h]));
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    dl[h] += __shfl_xor_sync(0xffffffffu, dl[h], 1);
    dl[h] += __shfl_xor_sync(0xffffffffu, dl[h], 2);
    lr[h] = r[h].live ? lse[r[h].stat] : 0.f;
    if (r[h].live && t == 0) delta[r[h].stat] = dl[h];
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    stage_rows<BK, HD, LDK>(Ks, kb, kvstride, k0, S);
    stage_rows<BK, HD, LDK>(Vs, vb, kvstride, k0, S);
    stage_cols<BK, HD, LDT>(Kt, kb, kvstride, k0, S);
    __syncthreads();
    float s[KT][4], dp[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        uint32_t b0, b1;
        frag_b(b0, b1, Ks, LDK, j * 8, kk * 16, g, t);
        mma16816(s[j], qa[kk], b0, b1);
        frag_b(b0, b1, Vs, LDK, j * 8, kk * 16, g, t);
        mma16816(dp[j], da[kk], b0, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < KT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, key = k0 + j * 8 + 2 * t + (e & 1);
        const bool vis = key < S && !(causal && key > r[h].pos);
        const float p = vis ? expf(s[j][e] * scale - lr[h]) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[h]);   // dS
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        frag_b(b0, b1, Kt, LDT, n * 8, kk * 16, g, t);
        mma16816(acc[n], a, b0, b1);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!r[h].live) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<uint32_t*>(dq + r[h].off + n * 8 + 2 * t) =
          pack2(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
    }
  }
}

// Dynamic shared memory of fa_bwd_dkv_mma: K and V of the block's 64 keys,
// a q tile of Q and dO row-major and transposed, its lse and delta.
template <int HD, int BQ>
constexpr int dkv_mma_smem() {
  return (2 * 64 * (HD + 8) + 2 * BQ * (HD + 8) + 2 * HD * (BQ + 8)) * 2 +
         2 * BQ * 4;
}

template <int HD, int BQ>
__global__ void __launch_bounds__(128)
fa_bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int Hq,
               int Hkv, float scale, int causal) {
  constexpr int KS = HD / 16, NT = HD / 8, QT = BQ / 8;
  constexpr int LDK = HD + 8, LDT = BQ + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Kb = reinterpret_cast<bf16*>(smem);
  bf16* Vb = Kb + 64 * LDK;
  bf16* Qs = Vb + 64 * LDK;
  bf16* Ds = Qs + BQ * LDK;
  bf16* Qt = Ds + BQ * LDK;
  bf16* Dt = Qt + HD * LDT;
  float* Ls = reinterpret_cast<float*>(Dt + HD * LDT);
  float* Dl = Ls + BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rep = Hq / Hkv;
  const int b = blockIdx.y / Hkv, hkv = blockIdx.y % Hkv;
  const int k0 = blockIdx.x * 64;
  const int kw = warp * 16;                 // the warp's keys within the block
  const int64_t kvstride = (int64_t)Hkv * HD;
  const bf16* kb = k + ((int64_t)b * S * Hkv + hkv) * HD;
  const bf16* vb = v + ((int64_t)b * S * Hkv + hkv) * HD;
  stage_rows<64, HD, LDK>(Kb, kb, kvstride, k0, S);
  stage_rows<64, HD, LDK>(Vb, vb, kvstride, k0, S);
  int key[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) key[h] = k0 + kw + g + 8 * h;

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const int64_t qstride = (int64_t)Hq * HD;
  for (int gi = 0; gi < rep; ++gi) {
    const int head = hkv * rep + gi;
    const bf16* qb = q + ((int64_t)b * S * Hq + head) * HD;
    const bf16* db = dout + ((int64_t)b * S * Hq + head) * HD;
    const int64_t sb = ((int64_t)b * Hq + head) * S;
    // causal: q rows before this block's first key see none of its keys
    for (int q0 = causal ? (k0 / BQ) * BQ : 0; q0 < S; q0 += BQ) {
      __syncthreads();
      stage_rows<BQ, HD, LDK>(Qs, qb, qstride, q0, S);
      stage_rows<BQ, HD, LDK>(Ds, db, qstride, q0, S);
      stage_cols<BQ, HD, LDT>(Qt, qb, qstride, q0, S);
      stage_cols<BQ, HD, LDT>(Dt, db, qstride, q0, S);
      if (threadIdx.x < BQ) {
        const bool in = q0 + (int)threadIdx.x < S;
        Ls[threadIdx.x] = in ? lse[sb + q0 + threadIdx.x] : 0.f;
        Dl[threadIdx.x] = in ? delta[sb + q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x BQ q rows
      float s[QT][4], dp[QT][4];
#pragma unroll
      for (int j = 0; j < QT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        frag_a(ka, Kb, LDK, kw, kk * 16, g, t);
        frag_a(va, Vb, LDK, kw, kk * 16, g, t);
#pragma unroll
        for (int j = 0; j < QT; ++j) {
          uint32_t b0, b1;
          frag_b(b0, b1, Qs, LDK, j * 8, kk * 16, g, t);
          mma16816(s[j], ka, b0, b1);
          frag_b(b0, b1, Ds, LDK, j * 8, kk * 16, g, t);
          mma16816(dp[j], va, b0, b1);
        }
      }
      // P^T and dS^T, in place of S^T and dP^T
#pragma unroll
      for (int j = 0; j < QT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * t + (e & 1), qpos = q0 + qi;
          const int kpos = key[e / 2];
          const bool vis = qpos < S && kpos < S && !(causal && kpos > qpos);
          const float p = vis ? expf(s[j][e] * scale - Ls[qi]) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - Dl[qi]);
        }
      }
      // dV += P^T dO and dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], sa[4];
        acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        acc_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t b0, b1;
          frag_b(b0, b1, Dt, LDT, n * 8, kk * 16, g, t);
          mma16816(dva[n], pa, b0, b1);
          frag_b(b0, b1, Qt, LDT, n * 8, kk * 16, g, t);
          mma16816(dka[n], sa, b0, b1);
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= S) continue;
    const int64_t off = (((int64_t)b * S + key[h]) * Hkv + hkv) * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8 + 2 * t) =
          pack2(dka[n][2 * h] * scale, dka[n][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8 + 2 * t) =
          pack2(dva[n][2 * h], dva[n][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// fp32 (CUDA cores)
constexpr int FWD_BQ = 64, FWD_BK = 32;   // 256 threads, 32 KB smem at HD 128
constexpr int DQ_BQ = 64, DQ_BK = 32;
constexpr int DKV_BK = 32, DKV_BQ = 32;   // 128 threads
// bf16 (tensor cores): 4 warps, 64 q rows or 64 keys a block
constexpr int FWD_MMA_BK = 64, DQ_MMA_BK = 32, DKV_MMA_BQ = 32;

struct Args {
  const void *q, *k, *v, *o, *dout, *lse_in, *delta_in;
  void *out0, *out1, *stat_out;
  int B, S, Hq, Hkv;
  float scale;
  int causal;
  cudaStream_t stream;
};

unsigned blocks_for(int n, int per) { return (unsigned)((n + per - 1) / per); }

template <typename T, int HD>
cudaError_t run_fwd(const Args& a) {
  if constexpr (std::is_same<T, bf16>::value) {
    const dim3 grid(blocks_for(a.Hq / a.Hkv * a.S, 64), a.B * a.Hkv);
    fa_fwd_mma<HD, FWD_MMA_BK><<<grid, 128, 0, a.stream>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (bf16*)a.out0,
        (float*)a.stat_out, a.S, a.Hq, a.Hkv, a.scale, a.causal);
  } else {
    const dim3 grid(blocks_for(a.Hq / a.Hkv * a.S, FWD_BQ), a.B * a.Hkv);
    fa_fwd<HD, FWD_BQ, FWD_BK><<<grid, FWD_BQ * TPR, 0, a.stream>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (float*)a.out0, (float*)a.stat_out, a.S, a.Hq, a.Hkv, a.scale,
        a.causal);
  }
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t run_dq(const Args& a) {
  if constexpr (std::is_same<T, bf16>::value) {
    const dim3 grid(blocks_for(a.Hq / a.Hkv * a.S, 64), a.B * a.Hkv);
    fa_bwd_dq_mma<HD, DQ_MMA_BK><<<grid, 128, 0, a.stream>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
        (const bf16*)a.o, (const bf16*)a.dout, (const float*)a.lse_in,
        (float*)a.stat_out, (bf16*)a.out0, a.S, a.Hq, a.Hkv, a.scale,
        a.causal);
  } else {
    const dim3 grid(blocks_for(a.Hq / a.Hkv * a.S, DQ_BQ), a.B * a.Hkv);
    fa_bwd_dq<HD, DQ_BQ, DQ_BK><<<grid, DQ_BQ * TPR, 0, a.stream>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.o, (const float*)a.dout, (const float*)a.lse_in,
        (float*)a.stat_out, (float*)a.out0, a.S, a.Hq, a.Hkv, a.scale,
        a.causal);
  }
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t run_dkv(const Args& a) {
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int smem = dkv_mma_smem<HD, DKV_MMA_BQ>();   // > 48 KB at HD 128
    const cudaError_t err = cudaFuncSetAttribute(
        fa_bwd_dkv_mma<HD, DKV_MMA_BQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(blocks_for(a.S, 64), a.B * a.Hkv);
    fa_bwd_dkv_mma<HD, DKV_MMA_BQ><<<grid, 128, smem, a.stream>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
        (const bf16*)a.dout, (const float*)a.lse_in,
        (const float*)a.delta_in, (bf16*)a.out0, (bf16*)a.out1, a.S, a.Hq,
        a.Hkv, a.scale, a.causal);
  } else {
    const dim3 grid(blocks_for(a.S, DKV_BK), a.B * a.Hkv);
    fa_bwd_dkv<HD, DKV_BK, DKV_BQ><<<grid, DKV_BK * TPR, 0, a.stream>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.dout, (const float*)a.lse_in,
        (const float*)a.delta_in, (float*)a.out0, (float*)a.out1, a.S, a.Hq,
        a.Hkv, a.scale, a.causal);
  }
  return cudaGetLastError();
}

enum Which { FWD, DQ, DKV };

template <typename T, int HD>
cudaError_t run(Which w, const Args& a) {
  switch (w) {
    case FWD: return run_fwd<T, HD>(a);
    case DQ: return run_dq<T, HD>(a);
    default: return run_dkv<T, HD>(a);
  }
}

template <typename T>
cudaError_t run_hd(Which w, int hd, const Args& a) {
  switch (hd) {
    case 16: return run<T, 16>(w, a);
    case 32: return run<T, 32>(w, a);
    case 64: return run<T, 64>(w, a);
    case 80: return run<T, 80>(w, a);
    case 128: return run<T, 128>(w, a);
    default: return cudaErrorInvalidValue;
  }
}

int launch(Which w, int dtype, int hd, const Args& a) {
  if (a.B < 1 || a.S < 1 || a.Hkv < 1 || a.Hq % a.Hkv) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)run_hd<float>(w, hd, a);
    case 1: return (int)run_hd<__nv_bfloat16>(w, hd, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (q, k, v, o, do and the gradients alike; lse
// and delta are fp32).  hd: 16, 32, 64, 80 or 128.  Each returns
// cudaGetLastError() after its launch (0 = launched).

// o = attention(q, k, v); lse = m + log(max(l, 1e-30)).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int S, int Hq,
                                   int Hkv, int hd, float scale, int causal,
                                   int dtype, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, nullptr, o, nullptr, lse,
         B, S, Hq, Hkv, scale, causal, static_cast<cudaStream_t>(stream)};
  return launch(FWD, dtype, hd, a);
}

// dq from (q, k, v, o, do, lse); writes delta = rowsum(do * o) for
// flash_attention_bwd_dkv, which must run after it.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* delta, void* dq, int B, int S,
                                      int Hq, int Hkv, int hd, float scale,
                                      int causal, int dtype, void* stream) {
  Args a{q, k, v, o, dout, lse, nullptr, dq, nullptr, delta,
         B, S, Hq, Hkv, scale, causal, static_cast<cudaStream_t>(stream)};
  return launch(DQ, dtype, hd, a);
}

// dk, dv from (q, k, v, do, lse, delta), summed over the rep q heads of
// each KV head.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int S,
                                       int Hq, int Hkv, int hd, float scale,
                                       int causal, int dtype, void* stream) {
  Args a{q, k, v, nullptr, dout, lse, delta, dk, dv, nullptr,
         B, S, Hq, Hkv, scale, causal, static_cast<cudaStream_t>(stream)};
  return launch(DKV, dtype, hd, a);
}
