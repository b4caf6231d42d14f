"""The §7 reconfiguration tree as ONE shared plan for every reduction tier.

Copy of ``repro/dist/plan.py`` for the PyTorch port: importing the JAX
package pulls JAX in through its package ``__init__``s, so the port keeps
its own copy of this pure-Python module (``tests/test_torch_plan.py``
holds the two equal).

The paper's result is that an N-operand adder should be a *planned* radix-4
tree of 4-operand modules with an explicit carry budget (Theorem: carry
value <= N-1).  In the port the plan shapes the page combine of split-K
decode attention: the plain tree :func:`repro_torch.kernels.moa_reduce.radix4_tree_sum`
and the CUDA kernel in ``kernels/csrc/moa_reduce.cu`` both add in the order
of ``levels``.

Two tree shapes fall out of one N:

* ``levels`` — the **ceil tree**: each level pads to a multiple of the radix
  and groups; this is the in-register shape, where zero padding is free
  (identity of addition).
* ``stages`` — the **exact factorization** (greedy 4, then 3, then 2): this
  is the mesh-axis shape, where padding is impossible (device counts must
  multiply exactly), e.g. 16 -> (4, 4), 32 -> (4, 4, 2), 6 -> (3, 2).

Only exact integer arithmetic from :mod:`repro_torch.core.carry` /
:mod:`repro_torch.core.accum` is used, so the tree shape and width budgets
are host-computable and property-testable.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.core import carry as carry_theory
from repro_torch.core.accum import AccumPlan, plan_gradient_reduction

__all__ = [
    "TreeLevel",
    "ReductionPlan",
    "factor_radix4",
    "stage_count",
    "tree_levels",
    "make_reduction_plan",
]


def factor_radix4(n: int) -> Tuple[int, ...]:
    """Greedy exact factorization of ``n`` into radix-4 stages.

    Prefers 4-way stages, then 3, then 2; a residual prime factor > 4 becomes
    its own (degenerate, flat) stage.  Examples::

        factor_radix4(16) == (4, 4)
        factor_radix4(32) == (4, 4, 2)
        factor_radix4(8)  == (4, 2)
        factor_radix4(6)  == (3, 2)

    ``factor_radix4(1) == ()`` — a 1-operand reduction has no stages.
    """
    if n < 1:
        raise ValueError(f"need a positive operand/device count, got {n}")
    stages = []
    while n > 1:
        for f in (4, 3, 2):
            if n % f == 0:
                stages.append(f)
                n //= f
                break
        else:
            # n has no factor <= 4 left: smallest prime factor is > 4, take
            # it whole (a flat stage; the Theorem still bounds its carry).
            p = _smallest_prime_factor(n)
            stages.append(p)
            n //= p
    return tuple(stages)


def _smallest_prime_factor(n: int) -> int:
    for p in range(5, int(math.isqrt(n)) + 1, 2):
        if n % p == 0:
            return p
    return n


def stage_count(n: int) -> int:
    """Depth of the radix-4 stage tree over ``n`` operands (0 for n == 1)."""
    return len(factor_radix4(n))


@dataclass(frozen=True)
class TreeLevel:
    """One level of the ceil tree: ``n_in`` operands are zero-padded by
    ``pad`` and reduced by ``groups`` radix-wide modules."""

    n_in: int
    pad: int
    groups: int


def tree_levels(n: int, radix: int = 4) -> Tuple[TreeLevel, ...]:
    """Ceil-tree levels for an ``n``-operand reduction (pad-and-group)."""
    if n < 1:
        raise ValueError(f"need a positive operand count, got {n}")
    levels = []
    r = n
    while r > 1:
        g = math.ceil(r / radix)
        levels.append(TreeLevel(n_in=r, pad=g * radix - r, groups=g))
        r = g
    return tuple(levels)


@dataclass(frozen=True)
class ReductionPlan:
    """Shared shape + width plan for one N-operand reduction.

    Drives all three tiers:

    * in-register (:func:`repro.core.moa.reconfigured_add`) and in-VMEM
      (:mod:`repro.kernels.moa_reduce`) trees via ``levels``;
    * the mesh collective (:func:`repro.dist.collectives.make_tree_mesh` /
      ``tree_psum``) via ``stages`` and :meth:`sub_axis_names`;
    * exactness checks via ``budget`` (bit-level carry widths, when
      ``m_bits`` is known) and ``accum`` (integer accumulator plan, when
      ``payload_bits`` is known).
    """

    n: int
    radix: int
    levels: Tuple[TreeLevel, ...]
    stages: Tuple[int, ...]
    budget: Optional[carry_theory.CarryBudget] = None
    accum: Optional[AccumPlan] = None

    @property
    def depth(self) -> int:
        """Tree depth of the ceil tree (== len(levels))."""
        return len(self.levels)

    @property
    def carries_emitted(self) -> int:
        """Total 2-bit carry terms the sum-path tree emits at weight 2^M
        (one per module; see Fig 10's U6/U7 carry-merge inputs)."""
        return sum(l.groups for l in self.levels)

    @property
    def carry_value_bound(self) -> int:
        """Theorem: the carry value of the whole reduction is <= N-1."""
        return carry_theory.carry_upper_bound(self.n)

    @property
    def carry_adder_bits(self) -> int:
        """Word width of the small carry-merge adders (U6/U7): the collected
        carry total is bounded by N-1, so digits(N-1) bits suffice (>= 2 so
        a lone 2-bit carry still fits)."""
        return max(carry_theory.carry_digits_bound(self.n, 2), 2)

    def sub_axis_names(self, axis: str) -> Tuple[str, ...]:
        """Mesh stage-axis names, mirroring what
        :func:`collectives.make_tree_mesh` returns: the original axis name
        for a single-stage (or empty) factorization — the mesh is left
        unchanged there — and ``axis_t0, axis_t1, ...`` otherwise."""
        if len(self.stages) <= 1:
            return (axis,)
        return tuple(f"{axis}_t{i}" for i in range(len(self.stages)))

    def carry_plan(self) -> "ReductionPlan":
        """Plan for the carry-merge tree over the emitted carry terms."""
        return make_reduction_plan(max(1, self.carries_emitted),
                                   radix=self.radix)


def make_reduction_plan(n: int, m_bits: Optional[int] = None, k: int = 2,
                        radix: int = 4, payload_bits: Optional[int] = None,
                        acc_bits: int = 32) -> ReductionPlan:
    """Build the shared plan for an ``n``-operand reduction.

    Args:
      n: operand count (array rows, microbatches, or mesh-axis size).
      m_bits: operand word width; enables the bit-level ``budget``.
      k: digit base for the budget (2 everywhere on TPU paths).
      radix: module arity of the tree (4 = the paper's Fig-7 module).
      payload_bits: integer payload width; enables the ``accum`` plan
        (e.g. 8 for the int8-compressed gradient reduction).
      acc_bits: accumulator register width for the ``accum`` plan.
    """
    budget = carry_theory.carry_budget(n, m_bits, k) if m_bits else None
    accum = (plan_gradient_reduction(n, payload_bits=payload_bits,
                                     acc_bits=acc_bits)
             if payload_bits else None)
    return ReductionPlan(n=n, radix=radix, levels=tree_levels(n, radix),
                         stages=factor_radix4(n), budget=budget, accum=accum)
