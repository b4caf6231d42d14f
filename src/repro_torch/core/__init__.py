"""Core library of the port: the paper's multi-operand adder theory and
implementations (copies of ``repro.core`` modules; none is imported here).

- carry:    §2 theory (Lemmas 1-2, Theorem C <= N-1, corollary, eqn 20)
- lut:      Fig 3/4 ones-count LUT + §10 gate-cost models
- moa:      bit-exact serial (Alg 2) and parallel (Fig 7) adders on tensors
- reconfig: §7 radix-4 reconfiguration planner
- planner:  Lemma 3 serial-vs-parallel execution planning
- accum:    the Theorem applied to integer accumulator widths
"""
