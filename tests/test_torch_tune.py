"""The port's autotune tier (``repro_torch.tune``) against the JAX package's
``repro.tune``.

The Pareto utilities and the trace builders are host code: on seeded
inputs they must return exactly what the JAX package returns and raise the
same errors.  ``replay_open_loop`` runs the same trace through the port's
engine and the JAX engine (the 1-layer reduced llama of
``test_torch_prefix._model``, the JAX engine's weights carried across) on
the virtual clock: every output, the virtual time, the step count, the SLO
and shed tallies and the shared counters must be equal.  ``run_sweep``
must record the same configs, resolved configs, errors and counted
metrics as the JAX sweep, with finite positive timed metrics, and with
``profile_dir`` a ``torch.profiler`` Chrome trace for every valid point.
The serve CLI's ``--burst-smoke`` prints the trajectory of the port's own
replay."""
import argparse
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

import repro.tune as jtune
from repro.serve import EngineConfig as JConfig
from repro.serve import ServeEngine as JEngine
from repro.tune import pareto as jpareto
from repro.tune import sweep as jsweep
from repro.tune import workloads as jwork
from repro_torch import tune
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models.common import init_params
from repro_torch.models.registry import serve_api
from repro_torch.serve import (EngineConfig, ServeEngine, add_cli_args,
                               config_from_args)
from repro_torch.tune import pareto as tpareto
from repro_torch.tune import sweep as tsweep
from repro_torch.tune import workloads as twork
from test_torch_prefix import SHARED_COUNTERS, _model


def test_exports_the_jax_package_names():
    assert tune.__all__ == jtune.__all__
    assert all(hasattr(tune, name) for name in tune.__all__)
    assert tsweep.METRIC_KEYS == jsweep.METRIC_KEYS


# ---------------------------------------------------------------------------
# pareto: host code, op for op
# ---------------------------------------------------------------------------

def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


def _point_sets(seed):
    """Seeded point sets over three metrics: small integer ranges give
    ties, duplicates and dominance chains; floats give strict orders."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (1, 2, 5, 12):
        ints = rng.integers(0, 4, (n, 3))
        out.append([dict(zip("xyz", map(int, row))) for row in ints])
        out.append([dict(zip("xyz", map(float, row)))
                    for row in rng.standard_normal((n, 3))])
    return out


OBJECTIVE_SETS = [(("x", "max"),), (("x", "min"),),
                  (("x", "max"), ("y", "min")),
                  (("x", "max"), ("y", "min"), ("z", "max")),
                  (("x", "min"), ("y", "min"), ("z", "min"))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pareto_matches_jax(seed):
    for pts in _point_sets(seed):
        for objs in OBJECTIVE_SETS:
            assert tpareto.pareto_front(pts, objs) == \
                jpareto.pareto_front(pts, objs)
            for a in pts[:4]:
                for b in pts[:4]:
                    assert tpareto.dominates(a, b, objs) == \
                        jpareto.dominates(a, b, objs)
        for key in "xyz":
            for d in ("max", "min"):
                assert tpareto.argbest(pts, key, d) == \
                    jpareto.argbest(pts, key, d)
        assert tpareto._signed(3.5, "min") == jpareto._signed(3.5, "min")


def test_pareto_errors_match_jax():
    pts = [{"x": 1}, {"x": 2}]
    for fn, args in ((tpareto.dominates, (pts[0], pts[1], (("x", "up"),))),
                     (tpareto.pareto_front, (pts, (("x", "down"),))),
                     (tpareto.argbest, ([], "x")),
                     (tpareto.argbest, (pts, "x", "most"))):
        got = _outcome(fn, *args)
        want = _outcome(getattr(jpareto, fn.__name__), *args)
        assert got == want and got[0] == "ValueError"


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

BURSTY_KWARGS = [
    dict(n=18, rate=2.0, burst_rate=30.0, mean_prompt=16, mean_gen=8,
         max_prompt=40, max_gen=16, vocab=97, slo_ms=800.0),
    dict(n=40, rate=0.5),
    dict(n=7, rate=3.0, burst_period_s=1.5, burst_duty=1.0, sigma=0.0,
         vocab=151552),
    dict(n=0, rate=1.0),
    dict(n=-3, rate=-1.0),
    dict(n=5, rate=0.0),
    dict(n=5, rate=1.0, burst_duty=0.0),
    dict(n=5, rate=1.0, burst_duty=1.5),
]


def _trace_outcome(fn, **kw):
    try:
        return ("ok", [dataclasses.astuple(a) for a in fn(**kw)])
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("seed", [0, 11, 12345])
@pytest.mark.parametrize("kw", BURSTY_KWARGS, ids=str)
def test_bursty_trace_matches_jax(kw, seed):
    kw = dict(kw)
    n = kw.pop("n")
    got = _trace_outcome(lambda **k: twork.bursty_trace(n, **k), seed=seed,
                         **kw)
    want = _trace_outcome(lambda **k: jwork.bursty_trace(n, **k),
                          seed=seed, **kw)
    assert got == want
    assert twork.Arrival.__dataclass_fields__.keys() == \
        jwork.Arrival.__dataclass_fields__.keys()


@pytest.mark.parametrize("seed", [0, 2, 99])
@pytest.mark.parametrize("kw", [dict(users=2, turns=3, turn_tokens=8, gen=4,
                                     think_s=0.2),
                                dict(users=4, turns=3, slo_ms=500.0,
                                     stagger_s=0.25, vocab=1000),
                                dict(users=0, turns=3),
                                dict(users=3, turns=0)], ids=str)
def test_multi_turn_trace_matches_jax(kw, seed):
    kw = dict(kw)
    users, turns = kw.pop("users"), kw.pop("turns")
    got = _trace_outcome(lambda **k: twork.multi_turn_trace(users, turns,
                                                            **k),
                         seed=seed, **kw)
    want = _trace_outcome(lambda **k: jwork.multi_turn_trace(users, turns,
                                                             **k),
                          seed=seed, **kw)
    assert got == want


def test_virtual_costs_validation_matches_jax():
    assert dataclasses.astuple(twork.VirtualCosts()) == \
        dataclasses.astuple(jwork.VirtualCosts())
    for bad in (dict(step_s=0.0), dict(chunk_s=-1.0),
                dict(spec_step_s=0.0)):
        with pytest.raises(ValueError) as t:
            twork.VirtualCosts(**bad)
        with pytest.raises(ValueError) as j:
            jwork.VirtualCosts(**bad)
        assert str(t.value) == str(j.value) == \
            "virtual costs must be positive"


# ---------------------------------------------------------------------------
# SweepSpec and the workload
# ---------------------------------------------------------------------------

GRID = {"spec_k": [0, 3], "prefill_chunk": [8, 16, 32],
        "kv_dtype": ["fp32", "int8"]}


@pytest.mark.parametrize("samples,seed", [(None, 0), (5, 0), (5, 7),
                                          (100, 1)])
def test_sweep_spec_points_match_jax(samples, seed):
    base = dict(max_slots=2, max_seq=64)
    got = tsweep.SweepSpec(EngineConfig(**base), GRID, samples=samples,
                           seed=seed).points()
    want = jsweep.SweepSpec(JConfig(**base), GRID, samples=samples,
                            seed=seed).points()
    assert [p.to_dict() for p in got] == [p.to_dict() for p in want]
    assert len(got) == min(samples or 12, 12)


def test_sweep_workload_matches_jax():
    for kw in (dict(), dict(requests=3, shared_prefix=40, tail=2, gen=5,
                            seed=4)):
        assert tsweep.sweep_workload(97, **kw) == \
            jsweep.sweep_workload(97, **kw)


# ---------------------------------------------------------------------------
# replay_open_loop, in lockstep with the JAX driver
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model1():
    return _model(n_layers=1)


#: the scalar fields of a replay result held equal to the JAX driver's
REPLAY_KEYS = ("outputs", "elapsed_s", "steps", "served_tokens",
               "goodput_tokens", "slo_met", "slo_missed", "shed")


def _replays(model, trace, costs=None, **knobs):
    """The same trace through the JAX and the port engine; returns both
    engines and both results, held equal field for field."""
    jcfg, tcfg, jp, tp = model
    jeng = JEngine(jcfg, jp, config=JConfig(**knobs))
    teng = ServeEngine(tcfg, tp, config=EngineConfig(**knobs), device="cpu")
    jclock, tclock = jeng.scheduler.clock, teng.scheduler.clock
    want = jwork.replay_open_loop(
        jeng, trace, None if costs is None else jwork.VirtualCosts(*costs))
    got = twork.replay_open_loop(
        teng, trace, None if costs is None else twork.VirtualCosts(*costs))
    assert teng.scheduler.clock is tclock
    assert jeng.scheduler.clock is jclock
    for key in REPLAY_KEYS:
        assert got[key] == want[key], key
    assert got["goodput_tok_s"] == pytest.approx(want["goodput_tok_s"],
                                                 rel=1e-12)
    assert [r.rid for r in got["finished"]] == \
        [r.rid for r in want["finished"]]
    for key in SHARED_COUNTERS:
        assert got["stats"][key] == want["stats"][key], key
    return jeng, teng, want, got


@pytest.mark.parametrize("degrade", [False, True])
def test_burst_replay_matches_jax(model1, degrade):
    """``tests/test_overload.py``'s canned burst (18 arrivals, seed 11,
    spec_k 3): with the ladder it sheds and the spec_off level reprices
    the clock; without it every request is served."""
    trace = twork.bursty_trace(18, rate=2.0, burst_rate=30.0,
                               mean_prompt=16, mean_gen=8, max_prompt=40,
                               max_gen=16, vocab=model1[0].vocab,
                               slo_ms=800.0, seed=11)
    _, _, _, got = _replays(model1, trace, max_slots=2, max_seq=96,
                            prefill_chunk=16, spec_k=3, degrade=degrade)
    st = got["stats"]
    assert st["spec_steps"] > 0 and got["slo_missed"] > 0
    if degrade:
        assert got["shed"] >= 1 and st["degrade_transitions"] >= 1
        assert got["shed"] == sum(r.shed_reason is not None
                                  for r in got["finished"])
    else:
        assert got["shed"] == 0
        assert all(len(o) == a.max_new for o, a in zip(got["outputs"],
                                                       trace))


def test_multi_turn_replay_matches_jax(model1):
    """Two conversations of three turns: causal gating, a session hit per
    returning turn; then ``max_steps`` raises the same error on both
    drivers and leaves the clock as it was."""
    trace = twork.multi_turn_trace(2, 3, turn_tokens=8, gen=4, think_s=0.2,
                                   vocab=model1[0].vocab, seed=2)
    jeng, teng, _, got = _replays(model1, trace, (0.01, 0.02, 0.03),
                                  max_slots=2, max_seq=96, prefill_chunk=16,
                                  spec_k=0)
    assert all(len(o) == 4 for o in got["outputs"])
    assert got["stats"]["session_turns"] == 6
    assert got["stats"]["session_hits"] == 4
    burst = twork.bursty_trace(6, rate=5.0, vocab=model1[0].vocab, seed=1)
    errors = []
    for eng, fn in ((jeng, jwork.replay_open_loop),
                    (teng, twork.replay_open_loop)):
        clock = eng.scheduler.clock
        with pytest.raises(RuntimeError) as e:
            fn(eng, burst, max_steps=2)
        assert eng.scheduler.clock is clock
        errors.append(str(e.value))
    assert errors[0] == errors[1] == \
        "replay exceeded max_steps=2 with work outstanding"


# ---------------------------------------------------------------------------
# run_sweep against the JAX sweep
# ---------------------------------------------------------------------------

#: metrics a sweep counts (equal to the JAX sweep's) and those it times
COUNTED = ("pool_bytes", "kv_bytes_per_slot", "tokens_per_step",
           "mean_occupancy")
TIMED = ("decode_tok_s", "prefill_tok_s", "decode_step_p50_s",
         "decode_step_p99_s")


def test_run_sweep_matches_jax(model1, tmp_path):
    """Two valid points (spec_k 0 and 3) and one ``resolve`` rejects (a
    page that does not divide max_seq): equal configs, resolved configs,
    errors and counted metrics; the port's timed metrics finite and
    positive; with ``profile_dir`` a Chrome trace for each valid point."""
    jcfg, tcfg, jp, tp = model1
    base = dict(max_slots=2, max_seq=64, prefill_chunk=16)
    grid = {"spec_k": [0, 3]}
    jpts = jsweep.SweepSpec(JConfig(**base), grid).points() + \
        [JConfig(page_size=24, **base)]
    tpts = tsweep.SweepSpec(EngineConfig(**base), grid).points() + \
        [EngineConfig(page_size=24, **base)]
    prompts, gens = tsweep.sweep_workload(tcfg.vocab, requests=3,
                                          shared_prefix=16, tail=4, gen=6)
    want = jsweep.run_sweep(jcfg, jp, jpts, prompts, gens)
    seen = []
    got = tsweep.run_sweep(tcfg, tp, tpts, prompts, gens,
                           profile_dir=str(tmp_path), device="cpu",
                           progress=lambda i, r: seen.append(i))
    assert seen == [0, 1, 2] and len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["config"] == w["config"]
        assert ("error" in g) == ("error" in w)
        if "error" in w:
            assert g["error"] == w["error"] and "metrics" not in g
            assert "page_size=24 must divide max_seq=64" in g["error"]
            continue
        assert "profile_error" not in g
        assert g["resolved"] == w["resolved"]
        for key in COUNTED:
            assert g["metrics"][key] == w["metrics"][key], key
        for key in TIMED:
            v = g["metrics"][key]
            assert math.isfinite(v) and v > 0, key
        path = os.path.join(g["trace_dir"], tsweep.TRACE_FILE)
        assert g["trace_dir"] == os.path.join(str(tmp_path), f"point{i:03d}")
        assert os.path.getsize(path) > 0
    assert got[1]["metrics"]["tokens_per_step"] >= 1.0


# ---------------------------------------------------------------------------
# the serve CLI's --burst-smoke
# ---------------------------------------------------------------------------

def test_burst_smoke_cli_prints_the_ports_replay(capsys):
    """``--burst-smoke --reduced --device cpu`` returns 0 and prints the
    trajectory the port's own ``replay_open_loop`` gives on the same
    trace and weights (the CLI's defaults: spec_k 4, degrade forced on,
    max_seq 128, SLO 900 ms)."""
    n, seed = 12, 3
    assert serve_cli.main(["--burst-smoke", "--reduced", "--device", "cpu",
                           "--requests", str(n), "--seed", str(seed)]) == 0
    out = capsys.readouterr().out.splitlines()
    cfg = get_config("llama3.2-3b").reduced(dtype=torch.float32)
    params = init_params(serve_api(cfg).param_specs(cfg),
                         torch.Generator().manual_seed(seed),
                         torch.device("cpu"), cfg.dtype)
    ap = argparse.ArgumentParser()
    add_cli_args(ap)
    ecfg = config_from_args(ap.parse_args([])).replace(max_seq=128,
                                                       degrade=True)
    trace = twork.bursty_trace(n, rate=2.0, burst_rate=30.0,
                               mean_prompt=16.0, mean_gen=32.0,
                               max_prompt=64, max_gen=32, vocab=cfg.vocab,
                               slo_ms=900.0, seed=seed)
    res = twork.replay_open_loop(ServeEngine(cfg, params, config=ecfg,
                                             device="cpu"), trace)
    st = res["stats"]
    assert st["spec_k"] == 4
    assert out[0] == (f"[burst] arch=llama3.2-3b device=cpu arrivals={n} "
                      f"slots={ecfg.max_slots} virtual "
                      f"{res['elapsed_s']:.2f}s in {res['steps']} engine "
                      f"steps")
    assert out[1] == (f"goodput {res['goodput_tok_s']:.1f} tok/s (virtual)"
                      f"  SLO {res['slo_met']} met / {res['slo_missed']} "
                      f"missed  shed {res['shed']}  degrade transitions "
                      f"{st['degrade_transitions']:.0f} (final level "
                      f"{st['degrade_level']:.0f})")
    shed = [r for r in res["finished"] if r.shed_reason is not None]
    assert len(out) == 2 + bool(shed)
    if shed:
        assert out[2] == f"first shed reason: {shed[0].shed_reason!r}"
