"""Lemma 3 — serial-vs-parallel area/throughput planning (paper §6, Fig 9).

Copy of ``repro/core/planner.py`` for the PyTorch port, which imports
nothing of the JAX package (``tests/test_torch_core_moa.py`` holds the two
equal).

Lemma 3: in a massively parallel environment (pending operations exceed
available resources), a set of serial units out-throughputs parallel units
occupying the same area iff the area ratio exceeds the execution-time ratio
(R_A > R_T).

Beyond the faithful model, :func:`plan_training_execution` applies the same
criterion to a question the *framework* faces at cluster scale: given a fixed
chip budget, is it better to run more model replicas each accumulating
gradients serially over microbatches (many "serial units"), or fewer, wider
data-parallel replicas (few "parallel units")? Chips <-> area, step time <->
clocks; the tilt condition is unchanged.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

__all__ = [
    "UnitSpec",
    "serial_beats_parallel",
    "throughput",
    "throughput_curves",
    "TrainingPlan",
    "plan_training_execution",
]


@dataclass(frozen=True)
class UnitSpec:
    """One execution-unit flavor: area (gates / chips) and clocks per op."""

    area: float
    clocks_per_op: float


def serial_beats_parallel(serial: UnitSpec, parallel: UnitSpec) -> bool:
    """Lemma 3 tilt condition: R_A > R_T with R_A = A_p/A_s, R_T = T_s/T_p."""
    r_area = parallel.area / serial.area
    r_time = serial.clocks_per_op / parallel.clocks_per_op
    return r_area > r_time


def throughput(unit: UnitSpec, area_budget: float, clocks: float,
               pending_ops: float = math.inf) -> float:
    """Operations completed in ``clocks`` by as many copies of ``unit`` as fit
    in ``area_budget`` — capped by the pending-op supply (the lemma assumes
    pending ops >> units; the cap lets tests explore the non-massive regime).
    """
    units = math.floor(area_budget / unit.area)
    ops = units * (clocks / unit.clocks_per_op)
    return min(ops, pending_ops)


def throughput_curves(r_area: float, r_time: float, max_clocks: int,
                      ) -> Tuple[List[float], List[float]]:
    """Fig-9 reproduction: throughput of one parallel unit vs the set of
    serial units fitting in the same area, over time. The parallel unit has
    area R_A and 1 clock/op; each serial unit has area 1 and R_T clocks/op."""
    par = UnitSpec(area=r_area, clocks_per_op=1.0)
    ser = UnitSpec(area=1.0, clocks_per_op=r_time)
    budget = par.area
    t = range(1, max_clocks + 1)
    return ([throughput(ser, budget, c) for c in t],
            [throughput(par, budget, c) for c in t])


# ---------------------------------------------------------------------------
# Cluster-scale application: microbatch (serial) vs data-parallel (parallel)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainingPlan:
    dp_replicas: int            # parallel units
    grad_accum_steps: int       # serial clocks per optimizer step
    microbatch_per_replica: int
    tokens_per_step: int
    est_step_clocks: float      # relative step latency
    mode: str                   # "serial-leaning" | "parallel-leaning"


def plan_training_execution(global_batch: int, chips: int,
                            chips_per_replica_parallel: int,
                            chips_per_replica_serial: int,
                            step_time_parallel: float,
                            step_time_serial: float,
                            seq_len: int = 1) -> TrainingPlan:
    """Apply Lemma 3 to the microbatching decision.

    A "parallel" replica spreads the per-replica batch over more chips
    (bigger area, fewer clocks); a "serial" replica uses fewer chips and
    iterates gradient-accumulation microbatches (smaller area, more clocks).
    Chooses the layout with higher modeled throughput under the fixed chip
    budget; ties break toward parallel (lower latency).
    """
    ser = UnitSpec(area=chips_per_replica_serial, clocks_per_op=step_time_serial)
    par = UnitSpec(area=chips_per_replica_parallel,
                   clocks_per_op=step_time_parallel)
    serial_wins = serial_beats_parallel(ser, par)
    if serial_wins:
        replicas = max(1, chips // chips_per_replica_serial)
        accum = max(1, math.ceil(step_time_serial / step_time_parallel))
        mode = "serial-leaning"
        step_clocks = step_time_serial
    else:
        replicas = max(1, chips // chips_per_replica_parallel)
        accum = 1
        mode = "parallel-leaning"
        step_clocks = step_time_parallel
    micro = max(1, global_batch // (replicas * accum))
    return TrainingPlan(
        dp_replicas=replicas,
        grad_accum_steps=accum,
        microbatch_per_replica=micro,
        tokens_per_step=global_batch * seq_len,
        est_step_clocks=step_clocks,
        mode=mode,
    )
