// Causal / non-causal GQA flash attention for Hopper (sm_90a): the forward
// pass and a FlashAttention-2 style backward pass in two kernels.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:97,
// flash_attention_pallas (body flash_attention_kernel).  It computes what
// that kernel computes -- softmax(q k^T * scale) v per q head, k/v shared by
// the rep = Hq / Hkv q heads of a group, fp32 inside, masked scores set to
// the finite -1e30 of the reference, the output divided by max(l, 1e-30)
// -- and it also writes the row log-sum-exp lse = m + log(max(l, 1e-30)) in
// fp32, which the backward needs.  The reference has no backward kernel
// (flash_attention_pallas has no VJP, so the backward has no TPU
// counterpart); the backward here follows FlashAttention-2:
//   delta = rowsum(dO * O);  P = exp(S * scale - lse);
//   dV = P^T dO;  dP = dO V^T;  dS = P * (dP - delta);
//   dQ = dS K * scale;  dK = dS^T Q * scale.
//
// Layout, as at the public function: q, o, do, dq are (B, S, Hq, HD) and
// k, v, dk, dv are (B, S, Hkv, HD), contiguous; lse and delta are
// (B, Hq, S) fp32.  S need not divide any tile: ragged tiles are masked (or
// zero-filled by TMA).  fp32 and bf16 inputs; sums and the softmax are
// fp32.
//
// fp32, CUDA cores (fp32 FMAs, so fp32 results stay within 2e-5 of the
// plain version); HD 16, 32, 64, 80 or 128 (the wrapper pads any other head
// dim with zeros).  q rows are folded per KV group as in the TPU wrapper:
// row r of group (b, hkv) is q head hkv * rep + r / S at position r % S.
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
//    registers of one block.
//
// bf16, Hopper (fa_fwd_wgmma, fa_bwd_dq_wgmma, fa_bwd_dkv_wgmma; HD 64 or
// 128, the wrappers zero-pad 16, 32 and 80, which changes neither the
// dots nor delta):
//  * Bound on this card: operations.  The forward needs 2 matmuls of 2 *
//    HD flops per visible (q, k) pair and does 2; the backward needs 5
//    and its two kernels do 7, since both recompute S and dP: the price
//    of having no atomics.  Every output element has one writer, and
//    results repeat bit for bit from run to run.  (FlashAttention-3 adds
//    dQ from the dk/dv pass with atomics; this does not.)  Bytes are far
//    below the operations at the training shapes, so the design is about
//    keeping the tensor cores fed.
//  * wgmma (m64nNk16, fp32 accumulators), the only way to the card's full
//    tensor-core rate: every product reads its shared-memory operands
//    through descriptors, K-major or MN-major (the descriptor's transpose
//    bit), so nothing is ever transposed in shared memory.  P and dS go
//    from the accumulator of one product to the register-A operand of the
//    next (the accumulator's layout is the A layout), rounded to bf16 as
//    FlashAttention-2 and -3 round P.
//  * TMA: 4-D tensor maps (HD, H, S, B) with the 128-byte swizzle wgmma
//    reads, one box of 64 or (the forward's K and V) 128 positions per 64
//    columns; the tiles are per head (b, head, positions), so every tile
//    is one rectangular box and a ragged S reads zeros.  The maps are encoded on the host per call
//    (cuTensorMapEncodeTiled, taken through cudaGetDriverEntryPoint, so
//    nothing links libcuda) and passed as __grid_constant__ parameters.
//  * Warp specialisation: 384 threads, two consumer warpgroups of 64 rows
//    (setmaxnreg 240) and a producer warpgroup (setmaxnreg 24) of which one
//    thread or warp issues the loads, through a ring of STAGES stages
//    with full and empty mbarriers: loads are in flight while the
//    consumers multiply, and the two consumers' softmax and products
//    overlap each other on the tensor cores.
//  * fa_fwd_wgmma: a block takes 128 q rows of one head; Q is loaded once,
//    K and V tiles of FWD_KEYS = 128 keys stream through the ring (a tile
//    of 64 keys left each warpgroup waiting more on its own softmax and
//    barriers per product).  S = Q K^T (m64n128, both K-major), the online
//    softmax in registers in the exp2 domain: each row's max over the raw
//    scores, reduced over the four lanes of a quad, then one FFMA (scale
//    * log2 e folded in) and one ex2.approx a score; O is rescaled by
//    exp2(m_old - m_new) before each O += P V (m64nHD, V MN-major).  The
//    epilogue scales each row by 1 / max(l, 1e-30) and writes lse = m ln 2
//    + log(max(l, 1e-30)).  Causal: the block streams the key tiles up to
//    the one that holds its last row, the diagonal tile of both
//    warpgroups.
//  * fa_bwd_dq_wgmma: a block takes 128 q rows of one head; Q and dO are
//    loaded once, delta = rowsum(dO O) is formed first (written for the
//    dk/dv kernel), K and V tiles of 64 keys stream through the ring.  S =
//    Q K^T and dP = dO V^T (m64n64), dS in registers, dQ += dS K (m64nHD, K
//    MN-major).  Causal: each warpgroup stops at its diagonal tile.
//  * fa_bwd_dkv_wgmma: a block takes 128 keys of one KV head, K and V
//    resident; the 64-row Q and dO tiles of all rep q heads of the group
//    stream through the ring with their lse and delta.  S^T = K Q^T and
//    dP^T = V dO^T (m64n64), P^T and dS^T in registers, dV += P^T dO and
//    dK += dS^T Q (m64nHD, dO and Q MN-major).  Causal: from the q tile
//    that holds the block's first key.
//  * The per-element mask runs only on tiles that cross the diagonal or
//    the end of the sequence; the heaviest causal blocks launch first (the
//    last q rows for the forward and dq, the first keys for dk/dv).

#include <cuda.h>
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

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  __nv_bfloat162 v;
  *reinterpret_cast<uint32_t*>(&v) = u;
  return __bfloat1622float2(v);
}

// ---------------------------------------------------------------------------
// bf16 on Hopper: TMA, mbarriers, wgmma and warp specialisation (see the
// note at the top).  A block is 384 threads: warpgroups 0 and 1 consume
// (64 rows each), warpgroup 2 produces (one thread, or one warp, issues
// the TMA loads; the rest exit).  Shared tiles are 64-row TMA boxes of 64
// bf16 columns (128 bytes a row, 128-byte swizzle), HD / 64 boxes side by
// side for a 64 x HD tile; wgmma reads them through descriptors.
// ---------------------------------------------------------------------------

constexpr int WS_THREADS = 384;     // consumer warpgroups 0, 1; producer 2
constexpr int STAGES = 2;           // depth of the ring of streamed tiles
constexpr int FWD_KEYS = 128;       // keys of the forward's K and V tiles
constexpr int BOX = 64 * 64 * 2;    // one 64 x 64 bf16 box: 8 KB
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// One box of a 4-D (HD, H, S, B) tensor map (64 columns by the map's rows),
// at column `col` of head `head`, from position `pos` of batch row `b`,
// into shared memory; its bytes complete on `bar`.  Positions past S read
// as zeros.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int col, int head, int pos, int b,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(col), "r"(head), "r"(pos), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// A ROWS x HD tile: HD / 64 boxes of ROWS rows side by side.
template <int HD, int ROWS = 64>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map, int head,
                                         int pos, int b, uint64_t* bar) {
#pragma unroll
  for (int c = 0; c < HD / 64; ++c)
    tma_box(dst + c * ROWS * 128, map, c * 64, head, pos, b, bar);
}

// wgmma shared-memory descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets.
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | (uint64_t)1 << 62;
}

// k16 step kk of a ROWS x HD tile read K-major (k along the row: 32 bytes
// a step inside a box, the next box every 4 steps; 8-row groups 1024 bytes
// apart).
template <int ROWS = 64>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return sdesc(tile + (kk / 4) * ROWS * 128 + (kk % 4) * 32, 16, 1024);
}

// k16 step kk of a ROWS x HD tile read MN-major (k down the rows, 16 rows a
// step; N across the boxes, ROWS * 128 bytes apart).
template <int ROWS = 64>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return sdesc(tile + kk * 16 * 128, ROWS * 128, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// 2^x, the hardware approximation (flushes results below 2^-126 to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D (64 x 64, fp32) = A B (+ D when scale_d): A and B from shared memory,
// both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) = A B (+ D when scale_d): A and B from shared memory,
// both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) += A B: A (64 x 16 bf16) in registers, B from shared
// memory MN-major (the descriptor's transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A B: A (64 x 16 bf16) in registers, B from shared
// memory MN-major (the descriptor's transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// The A fragment of k16 step kk from a 64 x N accumulator: a wgmma
// accumulator's layout is its register-A layout.
template <int N>
__device__ __forceinline__ void frag_of(uint32_t (&a)[4], const float (&d)[N],
                                        int kk) {
  a[0] = pack2(d[8 * kk], d[8 * kk + 1]);
  a[1] = pack2(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack2(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack2(d[8 * kk + 6], d[8 * kk + 7]);
}

// This thread's two rows (16 * warp + g and + 8) of a 64 x HD accumulator,
// times mul0 and mul1, to bf16 rows at row0 / row1 (null: past the end).
template <int HD>
__device__ __forceinline__ void store_rows(bf16* row0, bf16* row1,
                                           const float (&d)[HD / 2],
                                           float mul0, float mul1, int t) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (row0)
      *reinterpret_cast<uint32_t*>(row0 + 8 * j + 2 * t) =
          pack2(d[4 * j] * mul0, d[4 * j + 1] * mul0);
    if (row1)
      *reinterpret_cast<uint32_t*>(row1 + 8 * j + 2 * t) =
          pack2(d[4 * j + 2] * mul1, d[4 * j + 3] * mul1);
  }
}

// Dynamic shared memory of either backward kernel: four resident 64 x HD
// tiles and two a ring stage, plus 1 KB to align the swizzled tiles to
// 1024 bytes.
template <int HD>
constexpr int bwd_smem() {
  return (4 + 2 * STAGES) * (HD / 64) * BOX + 1024;
}

// The forward's: two 64-row Q tiles and a ring of K and V tiles of
// FWD_KEYS keys, plus the 1 KB.
template <int HD>
constexpr int fwd_smem() {
  return (HD / 64) * (2 * BOX + STAGES * 2 * FWD_KEYS * 128) + 1024;
}

__device__ __forceinline__ unsigned char* align1k(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// The forward: o and lse.  Block: 128 q rows of one head (b, head) =
// blockIdx.x; the last rows come first (blockIdx.y counts down), the
// heaviest under causal.  Q is loaded once, K and V tiles of FWD_KEYS keys
// stream through the ring; each consumer warpgroup runs the online
// softmax of its 64 rows in registers, in the exp2 domain.
template <int HD>
__global__ void __launch_bounds__(WS_THREADS, 1)
fa_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             bf16* __restrict__ o, float* __restrict__ lse, int S, int Hq,
             int Hkv, float scale, int causal) {
  constexpr int BK = FWD_KEYS;
  static_assert(BK == 128, "S = Q K^T is one m64n128 product a k16 step");
  constexpr int QTILE = (HD / 64) * BOX;             // 64 q rows
  constexpr int KTILE = (HD / 64) * BK * 128;        // BK keys
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, full[STAGES], empty[STAGES];
  unsigned char* Qs = align1k(smem_raw);   // [warpgroup] q rows
  unsigned char* ring = Qs + 2 * QTILE;    // [stage] K tile, V tile
  const int head = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int hkv = head / (Hq / Hkv);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * 128;
  // key tiles of the block: causal, up to the one holding its last row,
  // the diagonal tile of both warpgroups
  const int nkt = causal ? min(m0 + 127, S - 1) / BK + 1 : (S + BK - 1) / BK;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: Q once, then K and V tiles through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_arrive_tx(&bar_q, 2 * QTILE);
      for (int w = 0; w < 2; ++w)
        tma_tile<HD>(Qs + w * QTILE, &tm_q, head, m0 + 64 * w, b, &bar_q);
      for (int j = 0; j < nkt; ++j) {
        const int st = j % STAGES;
        mbar_wait(&empty[st], ((j / STAGES) & 1) ^ 1);
        mbar_arrive_tx(&full[st], 2 * KTILE);
        unsigned char* kv = ring + st * 2 * KTILE;
        tma_tile<HD, BK>(kv, &tm_k, hkv, BK * j, b, &full[st]);
        tma_tile<HD, BK>(kv + KTILE, &tm_v, hkv, BK * j, b, &full[st]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = m0 + 64 * wg;               // the warpgroup's first row
    const int qpos[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
    const float sl2 = scale * LOG2E;
    // per row (g, g + 8): running max (log2 units) and this lane's part
    // of the running sum; the quad's parts are added at the end
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    const uint32_t qa = smem_u32(Qs + wg * QTILE);
    mbar_wait(&bar_q, 0);
    for (int j = 0; j < nkt; ++j) {
      const int st = j % STAGES;
      mbar_wait(&full[st], (j / STAGES) & 1);
      const uint32_t kb = smem_u32(ring + st * 2 * KTILE), vb = kb + KTILE;
      float s[BK / 2];
      // S = Q K^T
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n128(s, kmajor(qa, kk), kmajor<BK>(kb, kk), kk > 0);
      wg_commit();
      wg_wait0();
      keep(s);
      // the mask only where a tile crosses the diagonal or the end:
      // the reference's finite -1e30 (before the scale), -inf past S
      if ((causal && j == nkt - 1) || BK * j + BK > S) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int kpos = BK * j + 8 * (i / 4) + 2 * t + (i % 2);
          if (causal && kpos > qpos[(i % 4) / 2]) s[i] = NEG_INF;
          if (kpos >= S) s[i] = -INFINITY;
        }
      }
      float mt[2] = {NEG_INF, NEG_INF}, corr[2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        mt[(i % 4) / 2] = fmaxf(mt[(i % 4) / 2], s[i]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
        mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
        mt[h] = fmaxf(m[h], mt[h] * sl2);    // scale > 0
        corr[h] = ex2(m[h] - mt[h]);
        m[h] = mt[h];
        l[h] *= corr[h];
      }
      // P = exp2(S scale log2 e - m) in place of S: an FFMA and an EX2
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = (i % 4) / 2;
        s[i] = ex2(fmaf(s[i], sl2, -m[h]));
        l[h] += s[i];
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i % 4) / 2];
      // O += P V, P rounded to bf16, V read MN-major
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        frag_of(a, s, kk);
        wgmma_rs<HD>(acc, a, mnmajor<BK>(vb, kk));
      }
      wg_commit();
      wg_wait0();
      keep(acc);
      mbar_arrive(&empty[st]);
    }
    const int64_t stat0 = ((int64_t)b * Hq + head) * S;
    bf16* rows[2];
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const float lc = fmaxf(l[h], 1e-30f);
      inv[h] = __frcp_rn(lc);
      const bool live = qpos[h] < S;
      rows[h] = live ? o + (((int64_t)b * S + qpos[h]) * Hq + head) * HD
                     : nullptr;
      if (live && t == 0) lse[stat0 + qpos[h]] = m[h] * LN2 + logf(lc);
    }
    store_rows<HD>(rows[0], rows[1], acc, inv[0], inv[1], t);
  }
}

// dQ and delta.  Block: 128 q rows of one head (b, head) = blockIdx.x; the
// last rows come first (blockIdx.y counts down), the heaviest under causal.
template <int HD>
__global__ void __launch_bounds__(WS_THREADS, 1)
fa_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_do,
                const bf16* __restrict__ o, const bf16* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ delta,
                bf16* __restrict__ dq, int S, int Hq, int Hkv, float scale,
                int causal) {
  constexpr int TILE = (HD / 64) * BOX;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, full[STAGES], empty[STAGES];
  __shared__ float delta_s[128];
  unsigned char* Qs = align1k(smem_raw);   // [warpgroup] q rows
  unsigned char* Ds = Qs + 2 * TILE;       // [warpgroup] dO rows
  unsigned char* ring = Ds + 2 * TILE;     // [stage] K tile, V tile
  const int head = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int hkv = head / (Hq / Hkv);
  const int m0 = (gridDim.y - 1 - blockIdx.y) * 128;
  // key tiles of the block: causal, up to the one holding its last row
  const int nkt = causal ? min(m0 + 127, S - 1) / 64 + 1 : (S + 63) / 64;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: Q and dO once, then K and V tiles through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_arrive_tx(&bar_q, 4 * TILE);
      for (int w = 0; w < 2; ++w) {
        tma_tile<HD>(Qs + w * TILE, &tm_q, head, m0 + 64 * w, b, &bar_q);
        tma_tile<HD>(Ds + w * TILE, &tm_do, head, m0 + 64 * w, b, &bar_q);
      }
      for (int j = 0; j < nkt; ++j) {
        const int st = j % STAGES;
        mbar_wait(&empty[st], ((j / STAGES) & 1) ^ 1);
        mbar_arrive_tx(&full[st], 2 * TILE);
        unsigned char* kv = ring + st * 2 * TILE;
        tma_tile<HD>(kv, &tm_k, hkv, 64 * j, b, &full[st]);
        tma_tile<HD>(kv + TILE, &tm_v, hkv, 64 * j, b, &full[st]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = m0 + 64 * wg;               // the warpgroup's first row
    const int64_t stat0 = ((int64_t)b * Hq + head) * S;
    {  // delta = rowsum(dO * O), O as stored, two threads a row
      const int row = tid / 2, pos = r0 + row;
      float acc = 0.f;
      if (pos < S) {
        const int64_t off = (((int64_t)b * S + pos) * Hq + head) * HD +
                            (tid % 2) * (HD / 2);
#pragma unroll
        for (int i = 0; i < HD / 16; ++i) {
          const uint4 ov = *reinterpret_cast<const uint4*>(o + off + 8 * i);
          const uint4 dv = *reinterpret_cast<const uint4*>(dout + off + 8 * i);
          const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
          const uint32_t dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 x = unpack2(ow[e]), y = unpack2(dw[e]);
            acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (tid % 2 == 0) {
        delta_s[64 * wg + row] = acc;
        if (pos < S) delta[stat0 + pos] = acc;
      }
    }
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    int qpos[2];
    float lr[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + g + 8 * h;
      qpos[h] = r0 + row;
      lr[h] = qpos[h] < S ? lse[stat0 + qpos[h]] * LOG2E : 0.f;
      dl[h] = delta_s[64 * wg + row];
    }
    const float sl2 = scale * LOG2E;
    // causal: up to the key tile on the warpgroup's diagonal
    const int jend = causal ? min(nkt, r0 / 64 + 1) : nkt;
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    const uint32_t qa = smem_u32(Qs + wg * TILE), da = smem_u32(Ds + wg * TILE);
    mbar_wait(&bar_q, 0);
    for (int j = 0; j < nkt; ++j) {
      const int st = j % STAGES;
      mbar_wait(&full[st], (j / STAGES) & 1);
      if (j < jend) {
        const uint32_t kb = smem_u32(ring + st * 2 * TILE), vb = kb + TILE;
        float s[32], dp[32];
        // S = Q K^T, dP = dO V^T
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss_n64(s, kmajor(qa, kk), kmajor(kb, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss_n64(dp, kmajor(da, kk), kmajor(vb, kk), kk > 0);
        wg_commit();
        wg_wait0();
        keep(s);
        keep(dp);
        // dS = P (dP - delta), in place of S; the mask only where a tile
        // crosses the diagonal or the end
        const bool edge = (causal && j == jend - 1) || 64 * j + 64 > S;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int h = (i % 4) / 2;
          const int kpos = 64 * j + 8 * (i / 4) + 2 * t + (i % 2);
          float p = exp2f(s[i] * sl2 - lr[h]);
          if (edge && (kpos >= S || (causal && kpos > qpos[h]))) p = 0.f;
          s[i] = p * (dp[i] - dl[h]);
        }
        // dQ += dS K, K read MN-major
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t a[4];
          frag_of(a, s, kk);
          wgmma_rs<HD>(acc, a, mnmajor(kb, kk));
        }
        wg_commit();
        wg_wait0();
        keep(acc);
      }
      mbar_arrive(&empty[st]);
    }
    bf16* rows[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rows[h] = qpos[h] < S
          ? dq + (((int64_t)b * S + qpos[h]) * Hq + head) * HD : nullptr;
    store_rows<HD>(rows[0], rows[1], acc, scale, scale, t);
  }
}

// dK and dV.  Block: 128 keys of one KV head (b, hkv) = blockIdx.x; the
// first keys come first (blockIdx.y counts up), the heaviest under causal.
// It loops over the q tiles of all rep q heads of the group, so the GQA
// sum stays in its registers.
template <int HD>
__global__ void __launch_bounds__(WS_THREADS, 1)
fa_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int S, int Hq, int Hkv, float scale,
                 int causal) {
  constexpr int TILE = (HD / 64) * BOX;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv, full[STAGES], empty[STAGES];
  __shared__ __align__(8) float ls[STAGES][64];   // lse * log2(e)
  __shared__ __align__(8) float ds[STAGES][64];   // delta
  unsigned char* Ks = align1k(smem_raw);   // [warpgroup] keys
  unsigned char* Vs = Ks + 2 * TILE;
  unsigned char* ring = Vs + 2 * TILE;     // [stage] Q tile, dO tile
  const int hkv = blockIdx.x % Hkv, b = blockIdx.x / Hkv;
  const int rep = Hq / Hkv;
  const int k0 = blockIdx.y * 128;
  const int nqt = (S + 63) / 64;
  // causal: q tiles before the block's first key see none of its keys
  const int qt0 = causal ? 2 * blockIdx.y : 0;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(&bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer warp: K and V once, then per q tile its Q and dO by TMA and
    // its lse and delta by the 32 lanes, each lane arriving on the stage
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x < 256 + 32) {
      const int lane = threadIdx.x - 256;
      if (lane == 0) {
        mbar_arrive_tx(&bar_kv, 4 * TILE);
        for (int w = 0; w < 2; ++w) {
          tma_tile<HD>(Ks + w * TILE, &tm_k, hkv, k0 + 64 * w, b, &bar_kv);
          tma_tile<HD>(Vs + w * TILE, &tm_v, hkv, k0 + 64 * w, b, &bar_kv);
        }
      }
      int it = 0;
      for (int gi = 0; gi < rep; ++gi) {
        const int head = hkv * rep + gi;
        const int64_t stat0 = ((int64_t)b * Hq + head) * S;
        for (int i = qt0; i < nqt; ++i, ++it) {
          const int st = it % STAGES;
          mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 2 * lane + e, q = 64 * i + c;
            ls[st][c] = q < S ? lse[stat0 + q] * LOG2E : 0.f;
            ds[st][c] = q < S ? delta[stat0 + q] : 0.f;
          }
          if (lane == 0) {
            mbar_arrive_tx(&full[st], 2 * TILE);
            unsigned char* qd = ring + st * 2 * TILE;
            tma_tile<HD>(qd, &tm_q, head, 64 * i, b, &full[st]);
            tma_tile<HD>(qd + TILE, &tm_do, head, 64 * i, b, &full[st]);
          } else {
            mbar_arrive(&full[st]);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int kw = k0 + 64 * wg;               // the warpgroup's first key
    const int key[2] = {kw + 16 * warp + g, kw + 16 * warp + g + 8};
    const float sl2 = scale * LOG2E;
    float dka[HD / 2], dva[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
    const uint32_t ka = smem_u32(Ks + wg * TILE), va = smem_u32(Vs + wg * TILE);
    mbar_wait(&bar_kv, 0);
    int it = 0;
    for (int gi = 0; gi < rep; ++gi) {
      for (int i = qt0; i < nqt; ++i, ++it) {
        const int st = it % STAGES;
        mbar_wait(&full[st], (it / STAGES) & 1);
        // causal: the tile must hold a row at or past the first key
        if (!causal || i >= kw / 64) {
          const uint32_t qb = smem_u32(ring + st * 2 * TILE), db = qb + TILE;
          float s[32], dp[32];
          // S^T = K Q^T, dP^T = V dO^T
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            wgmma_ss_n64(s, kmajor(ka, kk), kmajor(qb, kk), kk > 0);
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            wgmma_ss_n64(dp, kmajor(va, kk), kmajor(db, kk), kk > 0);
          wg_commit();
          wg_wait0();
          keep(s);
          keep(dp);
          // P^T and dS^T in place; the mask only on the diagonal tile and
          // the last, ragged one
          const bool edge = (causal && i == kw / 64) || 64 * i + 64 > S;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int c = 8 * jj + 2 * t;
            const float2 l2 = *reinterpret_cast<const float2*>(&ls[st][c]);
            const float2 d2 = *reinterpret_cast<const float2*>(&ds[st][c]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int idx = 4 * jj + e, qpos = 64 * i + c + (e & 1);
              const float l = (e & 1) ? l2.y : l2.x;
              const float d = (e & 1) ? d2.y : d2.x;
              float p = exp2f(s[idx] * sl2 - l);
              if (edge && (qpos >= S || (causal && key[e / 2] > qpos))) p = 0.f;
              s[idx] = p;
              dp[idx] = p * (dp[idx] - d);
            }
          }
          // dV += P^T dO, dK += dS^T Q, dO and Q read MN-major
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            uint32_t pa[4], sa[4];
            frag_of(pa, s, kk);
            frag_of(sa, dp, kk);
            wgmma_rs<HD>(dva, pa, mnmajor(db, kk));
            wgmma_rs<HD>(dka, sa, mnmajor(qb, kk));
          }
          wg_commit();
          wg_wait0();
          keep(dka);
          keep(dva);
        }
        mbar_arrive(&empty[st]);
      }
    }
    bf16 *krow[2], *vrow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t off = (((int64_t)b * S + key[h]) * Hkv + hkv) * HD;
      krow[h] = key[h] < S ? dk + off : nullptr;
      vrow[h] = key[h] < S ? dv + off : nullptr;
    }
    store_rows<HD>(krow[0], krow[1], dka, scale, scale, t);
    store_rows<HD>(vrow[0], vrow[1], dva, 1.f, 1.f, t);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// fp32 (CUDA cores)
constexpr int FWD_BQ = 64, FWD_BK = 32;   // 256 threads, 32 KB smem at HD 128
constexpr int DQ_BQ = 64, DQ_BK = 32;
constexpr int DKV_BK = 32, DKV_BQ = 32;   // 128 threads

struct Args {
  const void *q, *k, *v, *o, *dout, *lse_in, *delta_in;
  void *out0, *out1, *stat_out;
  int B, S, Hq, Hkv;
  float scale;
  int causal;
  cudaStream_t stream;
};

unsigned blocks_for(int n, int per) { return (unsigned)((n + per - 1) / per); }

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

// The 4-D map (HD, H, S, B) of a contiguous bf16 (B, S, H, HD) tensor:
// boxes of 64 columns of one head at `rows` positions, 128-byte swizzle,
// positions past S read as zeros.
cudaError_t head_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
                     int hd, int rows = 64) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)H * hd * 2,
                                 (cuuint64_t)S * H * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The maps of q, k, v and do, in that order.
cudaError_t bwd_maps(CUtensorMap (&m)[4], const Args& a, int hd) {
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  const int heads[4] = {a.Hq, a.Hkv, a.Hkv, a.Hq};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = head_map(&m[i], ptrs[i], a.B, a.S, heads[i], hd);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T, int HD>
cudaError_t run_fwd(const Args& a) {
  if constexpr (std::is_same<T, bf16>::value) {
    if constexpr (HD != 64 && HD != 128) {
      return cudaErrorInvalidValue;    // the wrapper pads to 64 or 128
    } else {
      CUtensorMap m[3];
      cudaError_t err = head_map(&m[0], a.q, a.B, a.S, a.Hq, HD);
      if (err == cudaSuccess)
        err = head_map(&m[1], a.k, a.B, a.S, a.Hkv, HD, FWD_KEYS);
      if (err == cudaSuccess)
        err = head_map(&m[2], a.v, a.B, a.S, a.Hkv, HD, FWD_KEYS);
      if (err != cudaSuccess) return err;
      constexpr int smem = fwd_smem<HD>();
      err = cudaFuncSetAttribute(fa_fwd_wgmma<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
      const dim3 grid(a.B * a.Hq, blocks_for(a.S, 128));
      fa_fwd_wgmma<HD><<<grid, WS_THREADS, smem, a.stream>>>(
          m[0], m[1], m[2], (bf16*)a.out0, (float*)a.stat_out, a.S, a.Hq,
          a.Hkv, a.scale, a.causal);
    }
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
    if constexpr (HD != 64 && HD != 128) {
      return cudaErrorInvalidValue;    // the wrapper pads to 64 or 128
    } else {
      CUtensorMap m[4];
      cudaError_t err = bwd_maps(m, a, HD);
      if (err != cudaSuccess) return err;
      constexpr int smem = bwd_smem<HD>();
      err = cudaFuncSetAttribute(fa_bwd_dq_wgmma<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
      const dim3 grid(a.B * a.Hq, blocks_for(a.S, 128));
      fa_bwd_dq_wgmma<HD><<<grid, WS_THREADS, smem, a.stream>>>(
          m[0], m[1], m[2], m[3], (const bf16*)a.o, (const bf16*)a.dout,
          (const float*)a.lse_in, (float*)a.stat_out, (bf16*)a.out0, a.S,
          a.Hq, a.Hkv, a.scale, a.causal);
    }
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
    if constexpr (HD != 64 && HD != 128) {
      return cudaErrorInvalidValue;    // the wrapper pads to 64 or 128
    } else {
      CUtensorMap m[4];
      cudaError_t err = bwd_maps(m, a, HD);
      if (err != cudaSuccess) return err;
      constexpr int smem = bwd_smem<HD>();
      err = cudaFuncSetAttribute(fa_bwd_dkv_wgmma<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
      const dim3 grid(a.B * a.Hkv, blocks_for(a.S, 128));
      fa_bwd_dkv_wgmma<HD><<<grid, WS_THREADS, smem, a.stream>>>(
          m[0], m[1], m[2], m[3], (const float*)a.lse_in,
          (const float*)a.delta_in, (bf16*)a.out0, (bf16*)a.out1, a.S, a.Hq,
          a.Hkv, a.scale, a.causal);
    }
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
// and delta are fp32).  hd: 16, 32, 64, 80 or 128 (bf16: 64 or 128).
// Each returns cudaGetLastError() after its launch (0 = launched).

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
