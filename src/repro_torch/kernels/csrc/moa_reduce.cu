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
// Design: one thread owns VEC adjacent output columns and streams its N
// operands (VEC = 4 when M and the base address allow 16-byte fp32/int32
// loads, else 1), so each operand row is read coalesced, once.  Each tree
// level keeps two registers per column: the running pair (a + b) and the
// pending third operand c.  When the fourth operand d of a group arrives,
// (a + b) + (c + d) is pushed one level up, which may complete a group
// there too.  At the end the partial groups are flushed with explicit
// zero padding, level by level, exactly as the plain version pads.  The
// levels are a template recursion (Level<L> holds Level<L + 1>), so every
// access is static and the stack lives in registers; which branch runs
// depends only on the operand index, the same for every thread.
// MAX_LEVELS = 8 bounds N at 4^8 = 65536; the wrapper raises beyond that.
//
// Bound on this card: bytes.  The kernel moves (N * in_bytes + out_bytes)
// * M bytes and does N - 1 adds per column, far below the add rate, so
// the least time is bytes over 3.35 TB/s.  At the decode shapes of the
// serve path (N = 16, M = 96 or 12288) that bound is well under a
// microsecond and the launch itself dominates; fusing the combine into
// the split-K attention is the later fix.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 8;

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

// Level L of the radix-4 tree: the running pair (a + b) and the pending c
// of the group being filled, and the levels above it.
template <typename A, int L>
struct Level {
  A pair, third;
  Level<A, L + 1> up;

  // v is element `idx` of this level
  __device__ __forceinline__ void push(const A& v, uint32_t idx) {
    const uint32_t pos = idx & 3u;
    if (pos == 0u) pair = v;
    else if (pos == 1u) pair = add(pair, v);
    else if (pos == 2u) third = v;
    else up.push(add(pair, add(third, v)), idx >> 2);    // (a + b) + (c + d)
  }

  // this level holds n elements in all: flush its zero-padded partial
  // group into the level above, then finish there; returns the root
  __device__ __forceinline__ A finish(uint32_t n, const A& zero) {
    if (n <= 1u) return pair;
    const uint32_t groups = (n + 3u) / 4u;
    const uint32_t rem = n & 3u;
    if (rem == 1u) up.push(add(add(pair, zero), add(zero, zero)), groups - 1u);
    else if (rem == 2u) up.push(add(pair, add(zero, zero)), groups - 1u);
    else if (rem == 3u) up.push(add(pair, add(third, zero)), groups - 1u);
    return up.finish(groups, zero);
  }
};

// The top level holds only the root (N <= 4^MAX_LEVELS).
template <typename A>
struct Level<A, MAX_LEVELS> {
  A pair;
  __device__ __forceinline__ void push(const A& v, uint32_t) { pair = v; }
  __device__ __forceinline__ A finish(uint32_t, const A&) { return pair; }
};

template <typename In, typename Acc, int VEC>
__global__ void __launch_bounds__(256)
moa_reduce_kernel(const In* __restrict__ x, Acc* __restrict__ out,
                  uint32_t n, int64_t m) {
  using A = Vec<Acc, VEC>;
  const int64_t col = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (col >= m) return;
  const A zero = zeros<Acc, VEC>();
  Level<A, 0> tree;
  const In* p = x + col;
#pragma unroll 4
  for (uint32_t i = 0; i < n; ++i) {
    tree.push(load<VEC>(p), i);
    p += m;
  }
  store<VEC>(out + col, tree.finish(n, zero));
}

template <typename In, typename Acc>
cudaError_t launch(const void* x, void* out, int64_t n, int64_t m,
                   cudaStream_t stream) {
  const int threads = 256;
  const bool vec4 = m % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int vec = vec4 ? 4 : 1;
  const int64_t blocks = (m / vec + threads - 1) / threads;
  if (vec4) {
    moa_reduce_kernel<In, Acc, 4><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const In*>(x), static_cast<Acc*>(out), (uint32_t)n, m);
  } else {
    moa_reduce_kernel<In, Acc, 1><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const In*>(x), static_cast<Acc*>(out), (uint32_t)n, m);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32 in / fp32 out, 1 = bf16 in / fp32 out, 2 = int32 in / int32 out.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int moa_reduce_launch(const void* x, void* out, long long n,
                                 long long m, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float, float>(x, out, n, m, s);
    case 1: return (int)launch<__nv_bfloat16, float>(x, out, n, m, s);
    case 2: return (int)launch<int32_t, int32_t>(x, out, n, m, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
