"""§7 generalized reconfiguration planner: N-operand adders from 4xM modules.

Copy of ``repro/core/reconfig.py`` for the PyTorch port, which imports
nothing of the JAX package (``tests/test_torch_core_moa.py`` holds the two
equal).

The paper's Table-4 algorithm places ``Add4x16``/``Add4x4`` modules in a
radix-4 tree with separate sum and carry reduction paths. This module
computes that placement *plan* for any (N, M) — module counts per level,
structural latency and area — so the execution planner (Lemma 3) and the
cluster-scale collective scheduler can reason about it. The bit-exact
execution of the plan lives in
:func:`repro_torch.core.moa.reconfigured_add`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List

from repro_torch.core import carry as carry_theory
from repro_torch.core.lut import GateCost, lut_parallel_adder_cost
from repro_torch.dist import plan as dist_plan

__all__ = ["LevelPlan", "ReconfigPlan", "plan_reconfig", "radix_stages"]


@dataclass(frozen=True)
class LevelPlan:
    level: int
    sum_modules: int        # 4xM units reducing the sum path
    inputs: int             # operands entering this level
    carries_emitted: int    # 2-bit carry terms produced at weight 2^M


@dataclass(frozen=True)
class ReconfigPlan:
    n_operands: int
    m_bits: int
    levels: List[LevelPlan]
    carry_modules: int          # small adders reducing the collected carries
    total_modules: int
    latency_stages: int         # pipeline stages (tree depth + carry merge)
    serial_clocks: int          # same work on ONE serial 4xM unit
    gate_cost: GateCost
    carry_value_bound: int      # Theorem: N-1
    result_bits: int            # exact worst-case result width

    @property
    def speedup_vs_serial(self) -> float:
        return self.serial_clocks / max(1, self.latency_stages)


def radix_stages(n: int, radix: int = 4) -> int:
    """ceil(log_radix(n)) — depth of the reconfigured tree (computed as the
    shared plan's exact level count, not via float log)."""
    if n <= 1:
        return 0
    return len(dist_plan.tree_levels(n, radix))


def plan_reconfig(n_operands: int, m_bits: int,
                  plan: "dist_plan.ReductionPlan | None" = None) -> ReconfigPlan:
    """Compute the §7 module placement for an ``n_operands`` x ``m_bits``
    adder built from 4-operand modules.

    The tree shape comes from the shared
    :class:`repro_torch.dist.plan.ReductionPlan`; this function adds the
    paper-facing structural accounting (module counts, latency, gate cost).
    """
    if n_operands < 1:
        raise ValueError("need at least one operand")
    plan = plan or dist_plan.make_reduction_plan(n_operands, m_bits=m_bits)
    levels: List[LevelPlan] = [
        LevelPlan(level=i + 1, sum_modules=t.groups, inputs=t.n_in,
                  carries_emitted=t.groups)
        for i, t in enumerate(plan.levels)
    ]
    # Carry path: radix-4 tree over all collected 2-bit carries (U6/U7 role).
    carry_modules = sum(t.groups for t in plan.carry_plan().levels)
    sum_modules = sum(l.sum_modules for l in levels)
    total_modules = sum_modules + carry_modules
    latency = len(levels) + (1 if carry_modules else 0) + 1  # + final concat
    # Serial baseline: one 4xM unit iterates columns — (M+1) clocks per
    # 4-operand add, (N-1)/3 four-operand adds to reduce N operands.
    four_op_adds = max(1, math.ceil((n_operands - 1) / 3))
    serial_clocks = four_op_adds * (m_bits + 1)
    return ReconfigPlan(
        n_operands=n_operands,
        m_bits=m_bits,
        levels=levels,
        carry_modules=carry_modules,
        total_modules=total_modules,
        latency_stages=latency,
        serial_clocks=serial_clocks,
        gate_cost=lut_parallel_adder_cost(n_operands, m_bits),
        carry_value_bound=carry_theory.carry_upper_bound(n_operands),
        result_bits=carry_theory.result_digits(n_operands, m_bits, 2),
    )
