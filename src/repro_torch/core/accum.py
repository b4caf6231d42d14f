"""Accumulator-width planning — the Theorem applied to TPU integer paths.

Copy of ``repro/core/accum.py`` for the PyTorch port, which imports
nothing of the JAX package (``tests/test_torch_plan.py`` holds the two
equal).

The paper's central question ("exactly how many carry bits does an N-operand
addition need?") is, on a TPU, the question of **accumulator width**:

* int8 x int8 products are <= 15 magnitude bits; summing N of them exactly
  needs 15 + ceil(log2 N) + sign bits. Given an int32 accumulator, the
  Theorem bounds the largest K-block a quantized matmul may reduce without
  overflow — that bound drives the K-blocking of
  :mod:`repro.kernels.quant_matmul`.
* Summing int8-compressed gradients from N_dp data-parallel replicas needs
  8 + ceil(log2 N_dp) bits; int32 is exact up to N_dp = 2^24 replicas — the
  guarantee behind :func:`repro.optim.compression.compressed_allreduce`.

All bounds here are *exact* (they come from :mod:`repro.core.carry`, which is
property-tested against brute force), not heuristic.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core import carry as carry_theory

__all__ = [
    "bits_for_sum",
    "max_operands_exact",
    "AccumPlan",
    "plan_dot_accumulation",
    "plan_gradient_reduction",
]


def bits_for_sum(n_operands: int, operand_bits: int, signed: bool = False) -> int:
    """Exact bits to hold the sum of ``n_operands`` values of
    ``operand_bits`` magnitude bits each (sign bit excluded from
    ``operand_bits``; add 1 output sign bit when ``signed``).

    Equals ``operand_bits + digits(N-1)`` at worst (corollary, k=2); computed
    exactly via the max total N*(2^M - 1)."""
    mag = carry_theory.result_digits(n_operands, operand_bits, 2)
    return mag + (1 if signed else 0)


def max_operands_exact(acc_bits: int, operand_bits: int,
                       signed: bool = False) -> int:
    """Largest N such that an ``acc_bits`` register holds any N-operand sum
    exactly. Closed form: floor((2^acc_mag - 1) / (2^operand_bits - 1));
    verified against :func:`bits_for_sum` in tests."""
    mag = acc_bits - (1 if signed else 0)
    if mag <= operand_bits:
        return 1 if mag == operand_bits else 0
    return (2 ** mag - 1) // (2 ** operand_bits - 1)


@dataclass(frozen=True)
class AccumPlan:
    """K-blocking plan for an exact integer dot-product reduction."""

    k_total: int                # full reduction length
    operand_bits: int           # magnitude bits of each product term
    acc_bits: int               # accumulator register width (incl. sign)
    max_block: int              # Theorem bound on exactly-summable terms
    block: int                  # chosen block (<= max_block, MXU-aligned)
    num_blocks: int
    spill_bits: int             # width needed by the block-partials sum

    @property
    def exact(self) -> bool:
        return self.block <= self.max_block


def plan_dot_accumulation(k_total: int, lhs_bits: int = 8, rhs_bits: int = 8,
                          acc_bits: int = 32, align: int = 128) -> AccumPlan:
    """Plan the K-blocking of an integer matmul so each block sums exactly in
    the accumulator. Product magnitude bits = (lhs-1)+(rhs-1) for signed
    int inputs; blocks are floored to ``align`` (MXU lane quantum) when the
    bound allows at least one aligned block.
    """
    prod_bits = (lhs_bits - 1) + (rhs_bits - 1)
    max_block = max_operands_exact(acc_bits, prod_bits, signed=True)
    block = min(k_total, max_block)
    if block >= align:
        block = (block // align) * align
    block = max(1, block)
    num_blocks = math.ceil(k_total / block)
    spill_bits = bits_for_sum(num_blocks, acc_bits - 1, signed=True)
    return AccumPlan(k_total=k_total, operand_bits=prod_bits,
                     acc_bits=acc_bits, max_block=max_block, block=block,
                     num_blocks=num_blocks, spill_bits=spill_bits)


def plan_gradient_reduction(n_replicas: int, payload_bits: int = 8,
                            acc_bits: int = 32) -> AccumPlan:
    """Width plan for an exact integer gradient tree-reduction across
    ``n_replicas`` (cluster-scale §7). Raises if the accumulator cannot hold
    the sum exactly — the caller must widen or shard the reduction."""
    need = bits_for_sum(n_replicas, payload_bits - 1, signed=True)
    if need > acc_bits:
        raise ValueError(
            f"summing {n_replicas} x int{payload_bits} needs {need} bits; "
            f"acc is {acc_bits}. Shard the reduction or widen the payload.")
    return AccumPlan(k_total=n_replicas, operand_bits=payload_bits - 1,
                     acc_bits=acc_bits,
                     max_block=max_operands_exact(acc_bits, payload_bits - 1,
                                                  signed=True),
                     block=n_replicas, num_blocks=1, spill_bits=need)
