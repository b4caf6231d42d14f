"""Autotune tier of the port: sweep the serve engine's typed knob space
(:class:`~repro_torch.serve.EngineConfig`) over a fixed workload and rank
the outcomes with multi-objective Pareto dominance (see
:mod:`repro_torch.tune.sweep` and :mod:`repro_torch.tune.pareto`), plus
seeded bursty/multi-turn traffic traces and the deterministic
virtual-clock open-loop replay driver behind the overload runs
(:mod:`repro_torch.tune.workloads`).  The counterpart of the JAX
package's ``repro.tune``; it imports no JAX."""
from repro_torch.tune.pareto import argbest, dominates, pareto_front
from repro_torch.tune.sweep import (METRIC_KEYS, SweepSpec, run_sweep,
                                    sweep_workload)
from repro_torch.tune.workloads import (Arrival, VirtualCosts, bursty_trace,
                                        multi_turn_trace, replay_open_loop)

__all__ = [
    "SweepSpec", "run_sweep", "sweep_workload", "METRIC_KEYS",
    "dominates", "pareto_front", "argbest",
    "Arrival", "VirtualCosts", "bursty_trace", "multi_turn_trace",
    "replay_open_loop",
]
