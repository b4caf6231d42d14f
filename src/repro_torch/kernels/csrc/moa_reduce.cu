// Radix-4 N-operand column reduction for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/moa_reduce.py:moa_reduce_pallas
// (body moa_reduce_kernel).  Computes out[m] = sum_n x[n, m] over a
// contiguous (N, M) operand stack, accumulating fp32 for fp32/bf16 input
// and int32 (wrapping, like the plain version) for int32 input.
//
// Order of the adds: the plain version radix4_tree_sum (and the JAX
// package off the TPU) reduces ONE radix-4 ceil tree over all N operands,
// as make_reduction_plan(N).levels lays it out: each level zero-pads to a
// multiple of 4 and turns every group (a, b, c, d) into (a + b) + (c + d).
// This kernel adds in exactly that order, so it equals the plain version
// bit for bit in fp32 as well as int32.  It does NOT follow the TPU
// kernel's bk operand blocks (a tree per block, blocks chained in the
// revisited output tile): there is no sequential grid axis on the GPU.
//
// Design: the operands split across lanes in the tree's own groups.  The
// plan's ceil tree is the complete 4-ary tree over the N operands padded
// with zeros to 4^L (L = the plan's level count): at every level the plan
// pads with literal zeros exactly the nodes whose operands are all
// padding, and such a node of the complete tree is (0 + 0) + (0 + 0) =
// +0, the same bits.  So the node at level t, index j, covers operands
// [j 4^t, (j + 1) 4^t).  The 4^s aligned subtrees just below the top s
// levels (s = 0, 1 or 2, chosen by the wrapper) go to 4^s adjacent lanes
// of a warp, which own the same VEC adjacent output columns (VEC = 4 when
// M and the base addresses allow 16-byte fp32/int32 loads, else 1).
//
// Each lane reduces its subtree of depth D = L - s.  It reads its operands
// a level-0 group at a time, the group's four loads issued together, and
// turns each group into (a + b) + (c + d), padding a partial group with
// zeros as the plan does.  The group sums go up a register stack of tree
// levels: each level keeps the running pair (a + b) and the pending c, and
// when the fourth element d arrives pushes (a + b) + (c + d) one level up.
// At the end the partial groups are flushed, level by level, with explicit
// zero padding, up to the subtree's root at depth D, even when a level
// holds a single element: a subtree is never the root of the whole tree,
// and the plan pads a lone element x to (x + 0) + (0 + 0), which turns
// -0.0 into +0.0.  A lane whose subtree holds only padding gives +0.  The
// levels are a template recursion (Level<L> holds Level<L + 1>), so every
// access is static and the stack lives in registers; which branch runs
// depends only on the operand count, the same for every lane of a warp
// but the last subtree's.  The kernel is templated on the subtree depth D
// (0 .. MAX_DEPTH = 6), so a lane holds only the levels it needs: at
// N = 16, s = 1, a lane's subtree is one group, its stack is one register
// set, and the kernel needs 32 registers a thread.
//
// The top s levels combine across the lanes of a group by __shfl_xor_sync
// with offsets 1 and 2 (level D + 1), then 4 and 8 (level D + 2): offset 1
// gives lane 0 a + b and lane 1 b + a, offset 2 then (a + b) + (c + d) or
// (c + d) + (a + b).  IEEE addition is commutative, so every lane of the
// group ends with the plan's bits; the group's first lane stores.  The
// kernel equals the plain version bit for bit in fp32 as well as int32.
// MAX_LEVELS = 8 bounds N at 4^8 = 65536; the wrapper raises beyond that.
//
// Bound on this card: bytes.  The kernel moves (N * in_bytes + out_bytes)
// * M bytes and does N - 1 adds per column, far below the add rate, so
// the least time is bytes over 3.35 TB/s.  At the prefill o shape of the
// serve path (N = 16 pages, M = 786432, s = 1) each lane has its four
// 16-byte loads in flight at once, and 786432 lanes fill the card about
// three times over.  At the decode shapes (N = 16, M = 96 or 12288) the
// bound is well under a microsecond and the launch itself dominates;
// fusing the combine into the split-K attention is the later fix.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <array>
#include <utility>

namespace {

constexpr int MAX_LEVELS = 8;
// a lane's subtree: at most 6 levels (N <= 4^8 with s = 2)
constexpr int MAX_DEPTH = MAX_LEVELS - 2;

template <typename T, int VEC>
struct Vec {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> zeros() {
  Vec<T, VEC> r;
#pragma unroll
  for (int j = 0; j < VEC; ++j) r.v[j] = T(0);
  return r;
}

__device__ __forceinline__ float add1(float a, float b) { return a + b; }
// wrap-around like torch's int32 add (signed overflow is undefined in C++)
__device__ __forceinline__ int32_t add1(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> add(const Vec<T, VEC>& a,
                                           const Vec<T, VEC>& b) {
  Vec<T, VEC> r;
#pragma unroll
  for (int j = 0; j < VEC; ++j) r.v[j] = add1(a.v[j], b.v[j]);
  return r;
}

// VEC operands of one row, widened to the accumulator type.
template <int VEC>
__device__ __forceinline__ Vec<float, VEC> load(const float* p) {
  Vec<float, VEC> r;
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = q.x; r.v[1] = q.y; r.v[2] = q.z; r.v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) r.v[j] = __ldg(p + j);
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ Vec<int32_t, VEC> load(const int32_t* p) {
  Vec<int32_t, VEC> r;
  if constexpr (VEC == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    r.v[0] = q.x; r.v[1] = q.y; r.v[2] = q.z; r.v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) r.v[j] = __ldg(p + j);
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ Vec<float, VEC> load(const __nv_bfloat16* p) {
  Vec<float, VEC> r;
  if constexpr (VEC == 4) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    r.v[0] = __low2float(lo); r.v[1] = __high2float(lo);
    r.v[2] = __low2float(hi); r.v[3] = __high2float(hi);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) r.v[j] = __bfloat162float(p[j]);
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const Vec<float, VEC>& r) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = r.v[j];
  }
}

template <int VEC>
__device__ __forceinline__ void store(int32_t* p, const Vec<int32_t, VEC>& r) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = r.v[j];
  }
}

// Level L of a subtree's register stack, counted from the group sums (the
// subtree's level 1) up to its root at TOP: the running pair (a + b) and
// the pending c of the group being filled, and the levels above it.
template <typename A, int L, int TOP>
struct Level {
  A pair, third;
  Level<A, L + 1, TOP> up;

  // v is element `idx` of this level
  __device__ __forceinline__ void push(const A& v, uint32_t idx) {
    const uint32_t pos = idx & 3u;
    if (pos == 0u) pair = v;
    else if (pos == 1u) pair = add(pair, v);
    else if (pos == 2u) third = v;
    else up.push(add(pair, add(third, v)), idx >> 2);    // (a + b) + (c + d)
  }

  // this level holds n >= 1 elements in all: flush its zero-padded partial
  // group into the level above, a lone element too, then finish there;
  // returns the subtree's root
  __device__ __forceinline__ A finish(uint32_t n, const A& zero) {
    const uint32_t groups = (n + 3u) / 4u;
    const uint32_t rem = n & 3u;
    if (rem == 1u) up.push(add(add(pair, zero), add(zero, zero)), groups - 1u);
    else if (rem == 2u) up.push(add(pair, add(zero, zero)), groups - 1u);
    else if (rem == 3u) up.push(add(pair, add(third, zero)), groups - 1u);
    return up.finish(groups, zero);
  }
};

// The subtree's root.
template <typename A, int TOP>
struct Level<A, TOP, TOP> {
  A pair;
  __device__ __forceinline__ void push(const A& v, uint32_t) { pair = v; }
  __device__ __forceinline__ A finish(uint32_t, const A&) { return pair; }
};

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> shfl_xor(unsigned live,
                                                const Vec<T, VEC>& v,
                                                int offset) {
  Vec<T, VEC> r;
#pragma unroll
  for (int j = 0; j < VEC; ++j) r.v[j] = __shfl_xor_sync(live, v.v[j], offset);
  return r;
}

// split = s: 4^s lanes share VEC columns, each reducing the subtree of
// 4^DEPTH operands (DEPTH = L - s) at its index among them.
template <typename In, typename Acc, int VEC, int DEPTH>
__global__ void __launch_bounds__(256)
moa_reduce_kernel(const In* __restrict__ x, Acc* __restrict__ out,
                  uint32_t n, int64_t m, int split) {
  using A = Vec<Acc, VEC>;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t col = (t >> (2 * split)) * VEC;
  // a group's lanes are adjacent and aligned, so they leave together
  const unsigned live = __ballot_sync(0xffffffffu, col < m);
  if (col >= m) return;
  const A zero = zeros<Acc, VEC>();
  const uint32_t sub = (uint32_t)(t & ((1 << (2 * split)) - 1));
  const uint32_t first = sub << (2 * DEPTH);       // the subtree's operands
  const uint32_t cnt = first >= n ? 0u : min(n - first, 1u << (2 * DEPTH));
  const In* p = x + (int64_t)first * m + col;
  A v = zero;
  if constexpr (DEPTH == 0) {         // N = 1: the root is the operand
    if (cnt) v = load<VEC>(p);
  } else if (cnt) {
    Level<A, 0, DEPTH - 1> tree;      // the group sums, up to the root
    uint32_t g = 0;
    for (; 4u * g + 4u <= cnt; ++g, p += 4 * m) {
      const A a = load<VEC>(p), b = load<VEC>(p + m);
      const A c = load<VEC>(p + 2 * m), d = load<VEC>(p + 3 * m);
      tree.push(add(add(a, b), add(c, d)), g);
    }
    const uint32_t rem = cnt - 4u * g;
    if (rem) {                        // a partial group, padded with zeros
      const A a = load<VEC>(p);
      const A b = rem > 1u ? load<VEC>(p + m) : zero;
      const A c = rem > 2u ? load<VEC>(p + 2 * m) : zero;
      tree.push(add(add(a, b), add(c, zero)), g++);
    }
    v = tree.finish(g, zero);
  }
  for (int offset = 1; offset < (1 << (2 * split)); offset <<= 1)
    v = add(v, shfl_xor(live, v, offset));
  if (sub == 0u) store<VEC>(out + col, v);
}

template <typename In, typename Acc, int VEC, int DEPTH>
void launch_depth(const void* x, void* out, int64_t n, int64_t m, int split,
                  int64_t blocks, cudaStream_t stream) {
  moa_reduce_kernel<In, Acc, VEC, DEPTH><<<(unsigned)blocks, 256, 0,
                                           stream>>>(
      static_cast<const In*>(x), static_cast<Acc*>(out), (uint32_t)n, m,
      split);
}

using LaunchDepth = void (*)(const void*, void*, int64_t, int64_t, int,
                             int64_t, cudaStream_t);

template <typename In, typename Acc, int VEC, int... D>
constexpr std::array<LaunchDepth, sizeof...(D)> depth_table(
    std::integer_sequence<int, D...>) {
  return {{&launch_depth<In, Acc, VEC, D>...}};
}

template <typename In, typename Acc>
cudaError_t launch(const void* x, void* out, int64_t n, int64_t m, int split,
                   cudaStream_t stream) {
  int levels = 0;                     // the plan's: 4^levels >= n
  while ((int64_t)1 << (2 * levels) < n) ++levels;
  if (split < 0 || split > 2 || split > levels ||
      levels - split > MAX_DEPTH)
    return cudaErrorInvalidValue;
  const bool vec4 = m % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int vec = vec4 ? 4 : 1;
  const int64_t lanes = (m / vec) << (2 * split);
  const int64_t blocks = (lanes + 255) / 256;
  // DEPTH = levels - split runs from 0 (N = 1) to MAX_DEPTH
  constexpr auto seq = std::make_integer_sequence<int, MAX_DEPTH + 1>{};
  static constexpr auto by_depth4 = depth_table<In, Acc, 4>(seq);
  static constexpr auto by_depth1 = depth_table<In, Acc, 1>(seq);
  (vec4 ? by_depth4 : by_depth1)[levels - split](x, out, n, m, split, blocks,
                                                 stream);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32 in / fp32 out, 1 = bf16 in / fp32 out, 2 = int32 in /
// int32 out.  split: the top tree levels combined across lanes (0, 1 or 2,
// at most the plan's level count L, and at least L - 6).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int moa_reduce_launch(const void* x, void* out, long long n,
                                 long long m, int dtype, int split,
                                 void* stream) {
  if (n < 1 || n > (1ll << (2 * MAX_LEVELS)) || m < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float, float>(x, out, n, m, split, s);
    case 1: return (int)launch<__nv_bfloat16, float>(x, out, n, m, split, s);
    case 2: return (int)launch<int32_t, int32_t>(x, out, n, m, split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
