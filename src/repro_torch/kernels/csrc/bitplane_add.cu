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
// Design: one thread per lane.  B is the contiguous axis, so the reads of
// a warp coalesce.  The TPU kernel holds a whole (N, bb) tile in VMEM and
// loops columns outside groups; a thread here cannot hold N operands in
// registers for any N, so the two loops are interchanged: the thread reads
// each group of four operands once and runs it through the netlist for
// every column, adding into M column counts kept in registers; then the
// column loop of Algorithm 2 runs over those counts with the carry buffer
// in a register.  The column counts are the same integer sums in another
// order, so the result is the TPU kernel's bit for bit.  M is a runtime
// argument of the C interface; it selects one of 31 instances (M = 1..31)
// so that every column index is static and the counts stay in registers.
// Arithmetic is unsigned: a count is at most N and the carry at most N - 1
// (Theorem), so total = count + carry < 2N fits 32 bits for any N the
// width guard admits; the wrapper raises before any launch when the
// result needs more than 31 bits.
//
// Bound on this card: bytes, (4 N + 4) B over 3.35 TB/s; the function is
// N - 1 adds per lane.  The netlist as written is M (24 ceil(N/4) + 5)
// integer operations per lane (netlist_ops_per_lane in bitplane_add.py),
// some 1600 at N = M = 16, which would outlast the bytes on the INT32
// pipes.  The compiler does better: shifts and masks commute with the
// gates, so it evaluates the netlist on whole words and merges gates into
// three-input LOP3s, leaving some 12 instructions per column and group
// (python -m repro_torch.launch.sass_mix bitplane_add prints the mix).
// Bit-slicing the column counts too (carry-save across groups) is the
// later fix.

#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <utility>

namespace {

// Fig 4: the 4->3 ones-count unit on four 1-bit inputs (two-input gates).
__device__ __forceinline__ uint32_t ones_count_gates(uint32_t b0, uint32_t b1,
                                                     uint32_t b2,
                                                     uint32_t b3) {
  const uint32_t s0 = b0 ^ b1, c0 = b0 & b1;     // half-add pairs
  const uint32_t s1 = b2 ^ b3, c1 = b2 & b3;
  const uint32_t z0 = s0 ^ s1, m = s0 & s1;      // merge sums
  const uint32_t t = c0 ^ c1, z2p = c0 & c1;     // merge carries
  const uint32_t z1 = t ^ m, k = t & m;          // weight-2 column
  const uint32_t z2 = z2p | k;                   // weight 4
  return z0 + (z1 << 1) + (z2 << 2);
}

template <int M>
__global__ void __launch_bounds__(256)
bitplane_add_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                    int64_t n, int64_t b) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= b) return;
  uint32_t count[M];                 // ones in each column, over all groups
#pragma unroll
  for (int i = 0; i < M; ++i) count[i] = 0u;
  const int32_t* p = x + lane;
  for (int64_t g = 0; g < n; g += 4, p += 4 * b) {
    // the group's four operands; rows past N are the zero padding
    const uint32_t w0 = (uint32_t)__ldg(p);
    const uint32_t w1 = g + 1 < n ? (uint32_t)__ldg(p + b) : 0u;
    const uint32_t w2 = g + 2 < n ? (uint32_t)__ldg(p + 2 * b) : 0u;
    const uint32_t w3 = g + 3 < n ? (uint32_t)__ldg(p + 3 * b) : 0u;
#pragma unroll
    for (int i = 0; i < M; ++i) {    // bit plane i through the netlist
      count[i] += ones_count_gates((w0 >> i) & 1u, (w1 >> i) & 1u,
                                   (w2 >> i) & 1u, (w3 >> i) & 1u);
    }
  }
  uint32_t carry = 0u, result = 0u;
#pragma unroll
  for (int i = 0; i < M; ++i) {      // one clock per column
    const uint32_t total = count[i] + carry;
    result |= (total & 1u) << i;     // emit the column bit
    carry = total >> 1;              // shift the rest into the buffer
  }
  out[lane] = (int32_t)(result + (carry << M));   // final drain clock
}

using Launch = cudaError_t (*)(const int32_t*, int32_t*, int64_t, int64_t,
                               cudaStream_t);

template <int M>
cudaError_t launch(const int32_t* x, int32_t* out, int64_t n, int64_t b,
                   cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = (b + threads - 1) / threads;
  bitplane_add_kernel<M><<<(unsigned)blocks, threads, 0, stream>>>(x, out, n,
                                                                   b);
  return cudaGetLastError();
}

template <int... I>
constexpr std::array<Launch, sizeof...(I)> launch_table(
    std::integer_sequence<int, I...>) {
  return {{&launch<I + 1>...}};
}

// LAUNCH[m - 1] runs the instance for M = m
constexpr auto LAUNCH = launch_table(std::make_integer_sequence<int, 31>{});

}  // namespace

// x: contiguous (n, b) int32; out: (b,) int32; 1 <= m <= 31 (the wrapper
// has checked that every sum fits 31 bits).  Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int bitplane_add_launch(const void* x, void* out, long long n,
                                   long long b, int m, void* stream) {
  if (m < 1 || m > 31 || n < 0 || b < 1) return (int)cudaErrorInvalidValue;
  return (int)LAUNCH[m - 1](static_cast<const int32_t*>(x),
                            static_cast<int32_t*>(out), n, b,
                            static_cast<cudaStream_t>(stream));
}
