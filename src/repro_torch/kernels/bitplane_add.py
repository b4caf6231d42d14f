"""Bit-serial N-operand addition (paper Algorithm 2) as a Hopper kernel.

Replaces the TPU kernel ``repro/kernels/bitplane_add.py:bitplane_add_pallas``.
The CUDA source is ``csrc/bitplane_add.cu`` (its header note gives the
design): the column counts are bit-sliced.  One thread owns one lane (four
when the layout allows 16-byte loads) and runs each group of four operands
through the Fig-4 XOR/AND netlist on whole words, which counts the ones of
every column at once as three words (bit i of each is a bit of column i's
count), and adds them into K = bit length of N counter words by bit-sliced
half and full adders.  Algorithm 2's column pass (emit the column bit,
carry the rest, drain the carry) computes ``sum_i count_i 2^i``; with the
counts bit-sliced that integer is ``sum_j (C_j & mask(M)) << j``, the same
sum bit for bit, which the kernel forms directly.  Masking each counter
word to M bits drops every bit of the operands at or above M.

Bound on the H100: bytes.  A call reads ``N * B`` int32 operands and
writes ``B`` int32 sums (:func:`bound_bytes`); the sum itself is ``N - 1``
adds per lane.  The kernel's source spends :func:`netlist_ops_per_lane`
integer operations a lane (93 at N = 16); ``chip_smoke.py`` prints both.

* :func:`bitplane_add_plain` — the plain PyTorch version: the column loop
  of Algorithm 2 through the same gates
  (:func:`repro_torch.core.lut.popcount_tree`), which the CPU path and the
  tests use.
* :func:`bitplane_add_cuda` — the kernel's wrapper; it adds one to
  :data:`LAUNCHES` each time it launches the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import carry as carry_theory
from repro_torch.core.lut import popcount_tree
from repro_torch.kernels import _build

__all__ = ["LAUNCHES", "check_width", "bitplane_add_plain",
           "bitplane_add_cuda", "bound_bytes", "netlist_ops_per_lane"]

#: Number of times :func:`bitplane_add_cuda` has launched the kernel.
LAUNCHES = 0


def check_width(n: int, m_bits: int) -> None:
    """Raise ``ValueError`` unless every sum of ``n`` operands of ``m_bits``
    bits fits an int32 (the guard of ``bitplane_add_pallas``)."""
    need = carry_theory.result_digits(n, m_bits, 2)
    if need > 31:
        raise ValueError(
            f"N={n}, M={m_bits} needs {need} result bits > int32 capacity")


def bitplane_add_plain(x: torch.Tensor, m_bits: int) -> torch.Tensor:
    """Algorithm 2 over the ``(N, B)`` lanes of ``x``: for each of the M
    columns extract the bit plane, count its ones with the Fig-4 gates over
    groups of four (zero-padded), add the carry buffer, emit the column bit
    and shift the carry; then drain the carry.  Reads only the low
    ``m_bits`` bits of each operand, as the kernel does."""
    n = x.shape[0]
    check_width(n, m_bits)
    x = x.to(torch.int32)
    carry_buf = torch.zeros(x.shape[1:], dtype=torch.int32, device=x.device)
    result = torch.zeros_like(carry_buf)
    for i in range(m_bits):                          # one clock per column
        lut_out = popcount_tree(((x >> i) & 1).movedim(0, -1))
        total = lut_out + carry_buf
        result |= (total & 1) << i                   # emit the column bit
        carry_buf = total >> 1                       # shift into the buffer
    return result + (carry_buf << m_bits)            # final drain clock


def bound_bytes(n: int, b: int) -> int:
    """Bytes the addition must move: ``N * B`` int32 operands read once and
    ``B`` int32 sums written once."""
    return 4 * (n + 1) * b


def netlist_ops_per_lane(n: int) -> int:
    """Integer operations per lane in the kernel's source, before the
    compiler merges any, for ``n`` operands and K = bit length of ``n``
    counter words: for each group of four, the 11 gates of Fig 4 and
    2K - 1 adder gates (a sum and, below the top stage, a carry per
    counter bit; a full adder's carry is one LOP3); then 3K - 2 for the
    column pass (K masks, K - 1 shifts and adds).  Loads are not
    counted."""
    groups = -(-n // 4)
    k = max(1, n.bit_length())
    return groups * (11 + 2 * k - 1) + 3 * k - 2


def bitplane_add_cuda(x: torch.Tensor, m_bits: int) -> torch.Tensor:
    """Launch the kernel on a contiguous ``(N, B)`` int32 CUDA tensor;
    returns the ``(B,)`` int32 sums.  The width guard runs before any
    launch; raises on what the kernel does not take and when the launch is
    refused."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"bitplane_add_cuda needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dim() != 2 or x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError(f"bitplane_add_cuda needs a contiguous (N, B) int32 "
                         f"tensor, got {x.dtype} shape {tuple(x.shape)} "
                         f"strides {x.stride()}")
    n, b = x.shape
    check_width(n, m_bits)
    out = torch.empty((b,), dtype=torch.int32, device=x.device)
    if b == 0:
        return out
    fn = _build.load("bitplane_add").bitplane_add_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), n, b, m_bits, stream)
    if err:
        raise RuntimeError(f"bitplane_add kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out
