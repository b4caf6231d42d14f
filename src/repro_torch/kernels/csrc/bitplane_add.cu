// Bit-serial N-operand column adder (paper Algorithm 2) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bitplane_add.py:bitplane_add_pallas
// (body bitplane_add_kernel, gates _ones_count_gates).  Computes, for each
// of B independent lanes, the sum of the N operands x[0..N-1, lane] of a
// contiguous (N, B) int32 stack, reading only the low M bits of each.
//
// Algorithm 2, as the TPU kernel runs it: for each of the M columns,
// extract the column's bit plane, count its ones with the Fig-4 XOR/AND
// netlist over groups of four operands (zero-padding N to a multiple of
// 4) and add the group counts, add the carry buffer, emit the column bit,
// shift the rest into the carry buffer; a final clock drains the carry.
//
// Design: bit-sliced column counters.  Bit i of an operand word is column
// i's bit plane for that operand, so the Fig-4 netlist run on whole words
// (ones_count_words) counts the ones of all 32 columns of a group of four
// at once: bit i of z0, z1, z2 is the weight-1, -2 and -4 bit of column
// i's group count.  The column counts are held the same way, as K words
// C_0 .. C_{K-1} with K the bit length of N: bit i of C_j is bit j of
// column i's count.  Each group count is added into them by a bit-sliced
// ripple of half and full adders (sum a ^ b ^ c, carry maj(a, b, c): one
// LOP3 each).  Bitwise operations never mix columns, and no count exceeds
// N < 2^K, so the adders drop no carry and every count is exact.
//
// The column pass.  Algorithm 2's carry ripple over the columns (emit
// total & 1, carry total >> 1, drain carry << M) computes the integer
// sum_i count_i 2^i: each clock keeps the invariant result + carry 2^i =
// sum_{i' < i} count_i' 2^i', and no bit is lost since the sum fits 31
// bits (the wrapper's width guard).  With the counts bit-sliced,
// count_i = sum_j bit i of C_j 2^j, so sum_i count_i 2^i =
// sum_j (C_j & mask(M)) << j: the carry-propagate stage of a multi-operand
// adder, K masks and K - 1 shift-adds.  The two are the same integer, so
// the result is the TPU kernel's bit for bit.  Masking each C_j to M bits
// once replaces masking every operand: bits of the operands at or above M
// only reach columns >= M, which the mask drops.
//
// Layout: one thread owns VEC adjacent lanes (VEC = 4, one 16-byte load a
// row, when B % 4 == 0 and the base is 16-byte aligned; else VEC = 1) and
// reads its N operands once, a group of four rows at a time with the
// group's loads issued before its gates.  B is the contiguous axis, so the
// reads of a warp coalesce.  The kernel is templated on K (1..31) so that
// the counters stay in registers; M is a runtime mask.
//
// Bound on this card: bytes, (4 N + 4) B over 3.35 TB/s; the function is
// N - 1 adds per lane.  The source spends per lane, for each group of
// four, the 11 gates of Fig 4 and 2K - 1 adder gates, and 3K - 2
// operations for the column pass (netlist_ops_per_lane in
// bitplane_add.py): 93 at N = M = 16 (K = 5) against 68 bytes a lane, so
// at the INT32 pipes' 64 operations a clock per SM the operations take
// about a quarter of the bytes' time.

#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <utility>

namespace {

template <int VEC>
struct Words {
  uint32_t v[VEC];
};

template <int VEC>
__device__ __forceinline__ Words<VEC> load_row(const int32_t* p) {
  Words<VEC> r;
  if constexpr (VEC == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    r.v[0] = (uint32_t)q.x; r.v[1] = (uint32_t)q.y;
    r.v[2] = (uint32_t)q.z; r.v[3] = (uint32_t)q.w;
  } else {
    r.v[0] = (uint32_t)__ldg(p);
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ Words<VEC> zero_row() {
  Words<VEC> r;
#pragma unroll
  for (int l = 0; l < VEC; ++l) r.v[l] = 0u;
  return r;
}

// majority of three words, bit by bit: the full adder's carry (one LOP3)
__device__ __forceinline__ uint32_t maj(uint32_t a, uint32_t b, uint32_t c) {
  return (a & b) | (c & (a ^ b));
}

// Fig 4: the 4->3 ones-count unit, on 32 columns at once (11 gates).
// Bit i of z0, z1, z2 is the weight-1, -2, -4 bit of column i's count.
__device__ __forceinline__ void ones_count_words(uint32_t w0, uint32_t w1,
                                                 uint32_t w2, uint32_t w3,
                                                 uint32_t& z0, uint32_t& z1,
                                                 uint32_t& z2) {
  const uint32_t s0 = w0 ^ w1, c0 = w0 & w1;     // half-add pairs
  const uint32_t s1 = w2 ^ w3, c1 = w2 & w3;
  const uint32_t m = s0 & s1;                    // merge sums
  z0 = s0 ^ s1;
  const uint32_t t = c0 ^ c1, z2p = c0 & c1;     // merge carries
  const uint32_t k = t & m;                      // weight-2 column
  z1 = t ^ m;
  z2 = z2p | k;                                  // weight 4
}

// C += (z2 z1 z0), bit-sliced: a ripple of K adder stages, 2K - 1 gates.
// Bits of the addend above K - 1 are zero (no count reaches 2^K), and so
// is the carry out of the top stage, which is not formed.
template <int K>
__device__ __forceinline__ void add_count(uint32_t (&c)[K], uint32_t z0,
                                          uint32_t z1, uint32_t z2) {
  uint32_t carry = 0u;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const uint32_t a = j == 0 ? z0 : j == 1 ? z1 : j == 2 ? z2 : 0u;
    const uint32_t cj = c[j];
    if (j == 0) {                        // half adder
      c[j] = cj ^ a;
      if (K > 1) carry = cj & a;
    } else if (j < 3) {                  // full adder
      c[j] = cj ^ a ^ carry;
      if (j + 1 < K) carry = maj(cj, a, carry);
    } else {                             // half adder on the carry
      c[j] = cj ^ carry;
      if (j + 1 < K) carry = cj & carry;
    }
  }
}

template <int K, int VEC>
__device__ __forceinline__ void count_group(uint32_t (&c)[VEC][K],
                                            const Words<VEC>& w0,
                                            const Words<VEC>& w1,
                                            const Words<VEC>& w2,
                                            const Words<VEC>& w3) {
#pragma unroll
  for (int l = 0; l < VEC; ++l) {
    uint32_t z0, z1, z2;
    ones_count_words(w0.v[l], w1.v[l], w2.v[l], w3.v[l], z0, z1, z2);
    add_count<K>(c[l], z0, z1, z2);
  }
}

template <int K, int VEC>
__global__ void __launch_bounds__(256)
bitplane_add_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                    int64_t n, int64_t b, uint32_t mask) {
  const int64_t lane = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (lane >= b) return;
  uint32_t c[VEC][K];                  // bit-sliced column counts per lane
#pragma unroll
  for (int l = 0; l < VEC; ++l)
#pragma unroll
    for (int j = 0; j < K; ++j) c[l][j] = 0u;
  const int32_t* p = x + lane;
  int64_t g = 0;
  for (; g + 4 <= n; g += 4, p += 4 * b) {       // whole groups of four
    const Words<VEC> w0 = load_row<VEC>(p);
    const Words<VEC> w1 = load_row<VEC>(p + b);
    const Words<VEC> w2 = load_row<VEC>(p + 2 * b);
    const Words<VEC> w3 = load_row<VEC>(p + 3 * b);
    count_group<K, VEC>(c, w0, w1, w2, w3);
  }
  if (g < n) {                        // the last group; rows past N are zero
    const Words<VEC> w0 = load_row<VEC>(p);
    const Words<VEC> w1 = g + 1 < n ? load_row<VEC>(p + b) : zero_row<VEC>();
    const Words<VEC> w2 = g + 2 < n ? load_row<VEC>(p + 2 * b)
                                    : zero_row<VEC>();
    count_group<K, VEC>(c, w0, w1, w2, zero_row<VEC>());
  }
  // the column pass: sum_j (C_j & mask) << j
  uint32_t sum[VEC];
#pragma unroll
  for (int l = 0; l < VEC; ++l) {
    sum[l] = c[l][0] & mask;
#pragma unroll
    for (int j = 1; j < K; ++j) sum[l] += (c[l][j] & mask) << j;
  }
  if constexpr (VEC == 4) {
    *reinterpret_cast<int4*>(out + lane) =
        make_int4((int32_t)sum[0], (int32_t)sum[1], (int32_t)sum[2],
                  (int32_t)sum[3]);
  } else {
    out[lane] = (int32_t)sum[0];
  }
}

template <int K>
cudaError_t launch(const int32_t* x, int32_t* out, int64_t n, int64_t b,
                   uint32_t mask, cudaStream_t stream) {
  const int threads = 256;
  const bool vec4 = b % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int vec = vec4 ? 4 : 1;
  const int64_t blocks = (b / vec + threads - 1) / threads;
  if (vec4) {
    bitplane_add_kernel<K, 4><<<(unsigned)blocks, threads, 0, stream>>>(
        x, out, n, b, mask);
  } else {
    bitplane_add_kernel<K, 1><<<(unsigned)blocks, threads, 0, stream>>>(
        x, out, n, b, mask);
  }
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const int32_t*, int32_t*, int64_t, int64_t,
                               uint32_t, cudaStream_t);

template <int... I>
constexpr auto launch_table(std::integer_sequence<int, I...>) {
  return std::array<Launch, sizeof...(I)>{{&launch<I + 1>...}};
}

// LAUNCH[k - 1] runs the instances with K = k counter words
constexpr auto LAUNCH = launch_table(std::make_integer_sequence<int, 31>{});

}  // namespace

// x: contiguous (n, b) int32; out: (b,) int32; 1 <= m <= 31 (the wrapper
// has checked that every sum fits 31 bits).  Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int bitplane_add_launch(const void* x, void* out, long long n,
                                   long long b, int m, void* stream) {
  if (m < 1 || m > 31 || n < 0 || n >= (1ll << 31) || b < 1)
    return (int)cudaErrorInvalidValue;
  int k = 1;                          // counter words: bit length of n
  while (k < 31 && (n >> k) != 0) ++k;
  return (int)LAUNCH[k - 1](static_cast<const int32_t*>(x),
                            static_cast<int32_t*>(out), n, b,
                            (1u << m) - 1u,
                            static_cast<cudaStream_t>(stream));
}
