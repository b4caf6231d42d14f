"""Bit-exact multi-operand adders (paper §3-§5, §7, §9).

Copy of ``repro/core/moa.py`` for the PyTorch port, which imports nothing
of the JAX package (``tests/test_torch_core_moa.py`` holds the two equal).

Two layers:

* A pure-Python reference layer working in **any base k** with arbitrary
  precision (used by the property tests and the paper's worked examples,
  which use k = 10 and k = 16).

* A vectorized **tensor layer for k = 2** operating on int32 tensors on any
  device: thousands of independent N-operand additions per call — the
  paper's "massively parallel environment".  These are the oracles that
  :func:`repro_torch.kernels.ops.bitplane_add` implements, and are
  themselves checked against an int32 sum.

Faithfulness notes:
  - Serial Algorithm-2 (Fig 5b/6) keeps a single carry *value* buffer whose
    width is bounded by the Theorem (carry <= N-1); it completes an M-column
    addition in **M + 1 clocks** (we return the structural clock count).
    ``jax.lax.scan`` over the columns becomes an explicit loop here, which
    extracts one column's bit plane per clock.
  - The parallel 4xM adder (Fig 7) evaluates one 4->3 LUT per column in
    parallel and merges the shifted column sums combinatorially.
  - For N = 4 the column ones-count goes through the *actual Fig-3 LUT*
    (a 16-entry gather), not an arithmetic popcount.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from repro_torch.core import carry as carry_theory
from repro_torch.core.lut import lut4_lookup, lut4_netlist, popcount_tree
from repro_torch.dist import plan as dist_plan

__all__ = [
    "SerialTrace",
    "serial_add_py",
    "serial_add",
    "parallel_add_4xm",
    "parallel_add_4xm_sc",
    "reconfigured_add",
    "max_supported_bits",
]


# ---------------------------------------------------------------------------
# Python reference layer (any base k, arbitrary precision)
# ---------------------------------------------------------------------------

@dataclass
class SerialTrace:
    """Per-clock trace of a serial multi-operand addition."""

    column_sums: List[int]      # LUT output per column (ones count / digit sum)
    carries: List[int]          # carry-buffer value after each column
    result_digits: List[int]    # emitted digits, LSB first
    clocks: int                 # structural clock count (M + 1)
    result: int


def serial_add_py(operands: Sequence[int], k: int = 2,
                  m_digits: int | None = None) -> SerialTrace:
    """Algorithm-2 serial addition in base ``k`` (paper §3.2, Fig 5b).

    One column per clock; the LUT output (digit-wise column sum) is added to
    the carry buffer, the LSB digit is emitted, the rest shifts right into
    the carry buffer. A final clock drains the carry buffer.
    """
    if any(x < 0 for x in operands):
        raise ValueError("operands must be non-negative")
    n = len(operands)
    if m_digits is None:
        m_digits = max(1, max(carry_theory.num_digits(x, k) for x in operands))
    if any(x >= k ** m_digits for x in operands):
        raise ValueError("operand wider than m_digits")

    digit_rows = [carry_theory.digits(x, k) + [0] * m_digits for x in operands]
    carry_buf = 0
    col_sums, carries, out = [], [], []
    for i in range(m_digits):
        col = sum(row[i] for row in digit_rows)       # the "LUT" output
        total = col + carry_buf
        out.append(total % k)
        carry_buf = total // k
        col_sums.append(col)
        carries.append(carry_buf)
        # Theorem invariant: the carry value never exceeds N-1.
        assert carry_buf <= carry_theory.carry_upper_bound(n)
    # final clock: copy remaining carry buffer into the result (step (d))
    drain = carry_buf
    while drain:
        out.append(drain % k)
        drain //= k
    result = carry_theory.from_digits(out, k) if out else 0
    return SerialTrace(column_sums=col_sums, carries=carries,
                       result_digits=out, clocks=m_digits + 1, result=result)


# ---------------------------------------------------------------------------
# Tensor layer (k = 2)
# ---------------------------------------------------------------------------

def max_supported_bits(n_operands: int) -> int:
    """Largest operand width the int32 tensor layer supports without
    overflow."""
    budget_bits = 31
    return budget_bits - carry_theory.carry_digits_bound(n_operands, 2) - 1


def _column_bits(ops: torch.Tensor, m_bits: int) -> torch.Tensor:
    """(..., N) integer operands -> (..., M, N) column bit planes."""
    shifts = torch.arange(m_bits, dtype=torch.int32, device=ops.device)
    return (ops[..., None, :] >> shifts[:, None]) & 1


def _ones_count(col_bits: torch.Tensor) -> torch.Tensor:
    """Column ones-count over the last axis. N == 4 uses the Fig-3 LUT."""
    n = col_bits.shape[-1]
    if n == 4:
        weights = torch.tensor([1, 2, 4, 8], dtype=torch.int32,
                               device=col_bits.device)
        packed = torch.sum(col_bits.to(torch.int32) * weights, dim=-1,
                           dtype=torch.int32)
        return lut4_lookup(packed)
    return popcount_tree(col_bits)


def serial_add(ops: torch.Tensor, m_bits: int, return_trace: bool = False):
    """Vectorized Algorithm-2 serial adder (k = 2).

    Args:
      ops: (..., N) int32 non-negative operands, each < 2**m_bits.
      m_bits: word width M.
      return_trace: also return (column_sums, carries) tensors of shape
        (..., M) matching :class:`SerialTrace`.

    Returns:
      (result, clocks[, trace]) — result has shape (...,), clocks == M + 1.
    """
    n = ops.shape[-1]
    if m_bits > max_supported_bits(n):
        raise ValueError(
            f"m_bits={m_bits} with N={n} overflows the int32 tensor layer; "
            f"max is {max_supported_bits(n)} (use the Python layer instead)")
    ops = ops.to(torch.int32)
    carry_buf = torch.zeros(ops.shape[:-1], dtype=torch.int32,
                            device=ops.device)
    result = torch.zeros_like(carry_buf)
    col_sums, carries = [], []
    for i in range(m_bits):                        # one clock per column
        lut_out = _ones_count((ops >> i) & 1)      # (...,)
        total = lut_out + carry_buf
        result |= (total & 1) << i                 # emit the column bit
        carry_buf = total >> 1
        if return_trace:
            col_sums.append(lut_out)
            carries.append(carry_buf)
    result += carry_buf << m_bits                  # final drain clock
    clocks = m_bits + 1
    if return_trace:
        return result, clocks, (torch.stack(col_sums, dim=-1),
                                torch.stack(carries, dim=-1))
    return result, clocks


def parallel_add_4xm(ops: torch.Tensor, m_bits: int) -> torch.Tensor:
    """Fig-7 combinatorial 4xM adder: per-column LUTs in parallel, then a
    shifted merge of the 3-bit column sums. Operates on (..., 4) operands."""
    if ops.shape[-1] != 4:
        raise ValueError("parallel_add_4xm takes exactly 4 operands")
    if m_bits > max_supported_bits(4):
        raise ValueError("word too wide for int32 layer")
    cols = _column_bits(ops.to(torch.int32), m_bits)     # (..., M, 4)
    counts = lut4_netlist(cols)                          # (..., M) in [0,4]
    weights = 1 << torch.arange(m_bits, dtype=torch.int32, device=ops.device)
    return torch.sum(counts * weights, dim=-1, dtype=torch.int32)


def parallel_add_4xm_sc(ops: torch.Tensor, m_bits: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """4xM addition split into (S, C): S = low M bits, C = carry value at
    weight 2^M. Theorem guarantees C <= 3 (2 bits) — asserted in tests."""
    total = parallel_add_4xm(ops, m_bits)
    mask = (1 << m_bits) - 1
    return total & mask, total >> m_bits


def _pad_and_group(values: torch.Tensor, level) -> torch.Tensor:
    """Zero-pad the last axis per the plan level and group radix-wide."""
    if level.pad:
        z = values.new_zeros(values.shape[:-1] + (level.pad,))
        values = torch.cat([values, z], dim=-1)
    return values.reshape(values.shape[:-1] + (level.groups, -1))


def reconfigured_add(ops: torch.Tensor, m_bits: int,
                     return_structure: bool = False,
                     plan: "dist_plan.ReductionPlan | None" = None):
    """§7 reconfiguration: an N-operand adder from 4-operand modules.

    The sum path stays M bits wide at every level (as in Fig 10: U1..U4 feed
    U5); every level's 2-bit carries are collected at weight 2^M and reduced
    by small carry adders (U6/U7). Works for any N >= 1 (zero padding).

    The tree shape (per-level padding/grouping) and the carry-path width
    come from the shared :class:`repro_torch.dist.plan.ReductionPlan` — the
    same plan object that orders the page combine's radix-4 tree.

    Returns ``result`` with shape (...,); with ``return_structure=True`` also
    returns a dict with per-level carry maxima and the module count, so tests
    can check the paper's structural claims (e.g. C5 = C6 = 0 for 16x16).
    """
    n = ops.shape[-1]
    if m_bits > max_supported_bits(n):
        raise ValueError("word too wide for int32 layer")
    plan = plan or dist_plan.make_reduction_plan(n, m_bits=m_bits)
    if plan.n != n:
        raise ValueError(f"plan is for N={plan.n}, got {n} operands")
    if plan.radix != 4:
        raise ValueError(f"the 4-operand modules below require a radix-4 "
                         f"plan, got radix={plan.radix}")
    values = ops.to(torch.int32)
    carries: List[torch.Tensor] = []
    modules = 0
    for level in plan.levels:
        groups = _pad_and_group(values, level)                # (..., G, 4)
        modules += level.groups
        s, c = parallel_add_4xm_sc(groups, m_bits)            # (..., G)
        values = s
        carries.append(c)
    # Carry reduction (U6/U7): all carries live at weight 2^M; their total is
    # bounded by N-1 (Theorem), so the plan's small-adder width suffices.
    if carries:
        carry_total = torch.cat(carries, dim=-1)
        for level in plan.carry_plan().levels:
            g = _pad_and_group(carry_total, level)
            modules += level.groups
            carry_total = parallel_add_4xm(g, plan.carry_adder_bits)
        carry_total = carry_total[..., 0]
    else:
        carry_total = torch.zeros(values.shape[:-1], dtype=torch.int32,
                                  device=values.device)
    result = values[..., 0] + (carry_total << m_bits)
    if return_structure:
        structure = {
            "levels": plan.depth,
            "modules": modules,
            "carry_total": carry_total,
            "carry_value_bound": plan.carry_value_bound,
        }
        return result, structure
    return result
