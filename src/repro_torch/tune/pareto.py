"""Multi-objective dominance utilities for the knob-sweep autotuner (the
port's copy of ``repro/tune/pareto.py``, error messages included).

Pure Python over plain dicts — no torch, no numpy — so the Pareto math is
usable from tests, offline analysis scripts, and the sweep runner alike.
A *point* is any mapping from metric name to a number; *objectives* is a
sequence of ``(key, direction)`` pairs where direction is ``"max"``
(bigger is better, e.g. decode tok/s) or ``"min"`` (smaller is better,
e.g. pool bytes or p99 step latency).

Dominance is the standard strict partial order: ``a`` dominates ``b``
when it is at least as good on EVERY objective and strictly better on at
least one.  The Pareto front is the set of points no other point
dominates; because dominance is transitive and irreflexive over a finite
set, every point dropped from the front is dominated by some member of
the front (follow the dominance chain to a maximal element).
"""
from __future__ import annotations

from typing import List, Mapping, Sequence, Tuple

__all__ = ["argbest", "dominates", "pareto_front"]

Objectives = Sequence[Tuple[str, str]]


def _signed(value: float, direction: str) -> float:
    """``value`` oriented so bigger is always better (``direction`` is
    ``"max"`` or ``"min"``; ``"min"`` negates)."""
    if direction == "max":
        return value
    if direction == "min":
        return -value
    raise ValueError(
        f"objective direction must be 'max' or 'min', got {direction!r}")


def dominates(a: Mapping[str, float], b: Mapping[str, float],
              objectives: Objectives) -> bool:
    """True iff point ``a`` dominates point ``b`` under ``objectives``:
    at least as good on every ``(key, direction)`` pair and strictly
    better on at least one."""
    strictly_better = False
    for key, direction in objectives:
        av = _signed(a[key], direction)
        bv = _signed(b[key], direction)
        if av < bv:
            return False
        if av > bv:
            strictly_better = True
    return strictly_better


def pareto_front(points: Sequence[Mapping[str, float]],
                 objectives: Objectives) -> List[int]:
    """Indices (ascending) of the non-dominated members of ``points``
    under ``objectives`` — the Pareto front.  Ties (points identical on
    every objective) are all kept: neither dominates the other."""
    return [i for i, p in enumerate(points)
            if not any(dominates(q, p, objectives)
                       for j, q in enumerate(points) if j != i)]


def argbest(points: Sequence[Mapping[str, float]], key: str,
            direction: str = "max") -> int:
    """Index of the best member of ``points`` on the single objective
    ``key`` (``direction`` ``"max"`` or ``"min"``; first index wins
    ties).  Raises ValueError on an empty sequence."""
    if not points:
        raise ValueError("argbest of an empty point list")
    return max(range(len(points)),
               key=lambda i: (_signed(points[i][key], direction), -i))
