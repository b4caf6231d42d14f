"""The port's serve engine on the MoE decoders, in lockstep with the JAX
engine.

1-layer reduced fp32 ``phi3.5-moe`` (4 experts, top-2) and
``llama4-scout`` (top-1, a shared expert) with the JAX weights
(``params_from_numpy``), drop-free (the reduced capacity) and at capacity
factor 1.0.  Capacity is sized from a dispatch's whole token count, so at
1.0 the rows of a dispatch compete for expert places: an idle lane's row,
a prefill piece's padding and a verify block's masked rows route too, and
change which live assignments are dropped.  The engines therefore only
agree if the port feeds every such row what the JAX engine feeds it; the
runs at 1.0 assert that assignments were dropped.  Four slots serve three
requests (a lane idles from the start, and more as requests retire),
prompts are not multiples of the prefill chunk, and the scenarios are
paged, contiguous (``paged_kv=False``), a prefix hit, chain and tree
speculative decode, an int8 pool and sampled requests.  After every step
the generated tokens, every shared counter, and the page tables and
refcounts (paged) or the dense states (contiguous, within 1e-4) are
equal; decode logits agree within 1e-4.  A verify's scatter to the
scratch page writes one value a target, whatever order the device
applies duplicate targets in.  The serve CLI runs both MoE models at
their reduced configs on the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.serve import EngineConfig as JConfig
from repro.serve import SamplingParams as JSampling
from repro.serve import ServeEngine as JEngine
from repro_torch.models import moe as tmoe
from repro_torch.models import paging as tpaging
from repro_torch.serve import EngineConfig, SamplingParams, ServeEngine
from test_torch_prefix import SHARED_COUNTERS, _conserved, _model
from test_torch_sampling import KV_KEYS
from test_torch_spec_engine import MODES, SPEC_KEYS

ARCHS = ["phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e"]
CAPS = {"drop-free": {}, "capacity 1.0": dict(capacity_factor=1.0)}
GEOMETRY = dict(max_slots=4, max_seq=64, prefill_chunk=8, page_size=16)

#: scenario -> engine knobs over GEOMETRY
SCENARIOS = {
    "paged": dict(prefix_cache=False),
    "contiguous": dict(paged_kv=False, prefix_cache=False),
    "prefix hit": dict(min_prefix=8),
    "chain": dict(MODES["chain"], prefix_cache=False),
    "tree": dict(MODES["tree"], prefix_cache=False),
    "int8": dict(kv_dtype="int8", prefix_cache=False),
    "sampled": dict(prefix_cache=False),
}
_MODELS = {}


def _moe(arch, cap):
    if (arch, cap) not in _MODELS:
        _MODELS[arch, cap] = _model(arch=arch, n_layers=1, **CAPS[cap])
    return _MODELS[arch, cap]


def _traffic(vocab, scenario):
    """Three prompts (lengths off the chunk of 8) and their budgets; a
    prefix hit shares a 16-token system prompt, the others repeat
    n-grams where prompt lookup drafts."""
    rng = np.random.default_rng(51)

    def toks(n):
        return rng.integers(0, vocab, n).tolist()
    if scenario == "prefix hit":
        system = toks(16)
        return [system + toks(n) for n in (5, 3, 9)], [6, 9, 5]
    pat = toks(5)
    return [pat * 4 + [3], toks(13), pat * 3 + [1]], [10, 6, 12]


def _sampling(scenario, n):
    if scenario != "sampled":
        return [None] * n
    out = [SamplingParams(temperature=0.8, top_k=40, top_p=0.9, seed=i)
           for i in range(n)]
    out[1] = None                       # a greedy request rides along
    return out


def _same_state(jeng, teng):
    if teng.paged:
        assert (teng.table == np.asarray(jeng.table)).all()
        assert (np.asarray(teng.pool.refcount)
                == np.asarray(jeng.pool.refcount)).all()
        _conserved(teng)
        return
    for k, v in teng.state.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jeng.state[k]),
                                   atol=1e-4, rtol=1e-4)


def _counting_drops(monkeypatch):
    """Wrap the port's ``_dispatch_indices``: a list that collects the
    number of dropped assignments of every dispatch of every layer."""
    drops = []
    inner = tmoe._dispatch_indices

    def wrapped(idx, e, cap):
        out = inner(idx, e, cap)
        drops.append(int((~out[2]).sum()))
        return out

    monkeypatch.setattr(tmoe, "_dispatch_indices", wrapped)
    return drops


def lockstep(model, scenario):
    jcfg, tcfg, jp, tp = model
    knobs = dict(GEOMETRY, **SCENARIOS[scenario])
    jeng = JEngine(jcfg, jp, config=JConfig(**dict(dict(paged_kv=True),
                                                   **knobs)))
    teng = ServeEngine(tcfg, tp, config=EngineConfig(**knobs), device="cpu")
    assert teng.config.to_dict() == jeng.config.to_dict()
    for eng in (jeng, teng):
        eng.trace_logits = True
    prompts, gens = _traffic(jcfg.vocab, scenario)
    sampling = _sampling(scenario, len(prompts))
    jreqs = [jeng.submit(p, g, sampling=None if sp is None else JSampling(
        sp.temperature, sp.top_k, sp.top_p, sp.seed))
        for p, g, sp in zip(prompts, gens, sampling)]
    treqs = [teng.submit(p, g, sampling=sp)
             for p, g, sp in zip(prompts, gens, sampling)]
    keys = SHARED_COUNTERS + SPEC_KEYS + KV_KEYS
    steps = 0
    while jeng.scheduler.has_work or teng.scheduler.has_work:
        jeng.step()
        teng.step()
        steps += 1
        assert [r.generated for r in treqs] == [r.generated for r in jreqs]
        js, ts = jeng.stats_summary(), teng.stats_summary()
        bad = [(k, ts[k], js[k]) for k in keys if ts[k] != js[k]]
        assert not bad, (steps, bad)
        _same_state(jeng, teng)
        assert steps < 200
    assert all(len(r.generated) == g for r, g in zip(treqs, gens))
    assert len(teng.logit_trace) == len(jeng.logit_trace) > 0
    for t, j in zip(teng.logit_trace, jeng.logit_trace):
        np.testing.assert_allclose(t, np.asarray(j), atol=1e-4)
    return teng


#: (arch, capacity, scenario): every scenario for phi3.5-moe at both
#: capacities and for llama4-scout at 1.0; drop-free, no row takes another's
#: place, so llama4-scout takes only the paged and chain runs there
CASES = ([(a, c, sc) for a in ARCHS for c in sorted(CAPS)
          for sc in sorted(SCENARIOS)
          if a == ARCHS[0] or c == "capacity 1.0"]
         + [(ARCHS[1], "drop-free", sc) for sc in ("chain", "paged")])


@pytest.mark.parametrize("arch,cap,scenario", CASES)
def test_moe_engine_matches_jax(monkeypatch, arch, cap, scenario):
    drops = _counting_drops(monkeypatch)
    teng = lockstep(_moe(arch, cap), scenario)
    st = teng.stats_summary()
    assert drops and (sum(drops) > 0) == (cap == "capacity 1.0")
    if scenario == "prefix hit":
        assert st["prefix_hits"] >= 1
    if scenario in ("chain", "tree"):
        assert st["spec_drafted"] > 0
    if scenario == "int8":
        assert st["kv_dtype"] == "int8"
    if scenario != "prefix hit":       # the trie keeps its pages
        assert st["pages_in_use"] == 0


def test_verify_scatter_writes_each_scratch_target_once():
    """A verify's masked rows share scratch targets; every duplicate
    writes the last row's value, so the pool's bytes do not depend on the
    order a device applies duplicate targets in (CPU: in order, the last
    one wins)."""
    rng = np.random.default_rng(3)
    pages = torch.tensor([[3, 1], [0, 0], [2, 4]])
    pos = torch.tensor([[5, 6, 7, 8], [0, 1, 2, 3], [30, 31, 32, 33]])
    nvalid = torch.tensor([2, 0, 3])
    rows = torch.from_numpy(rng.standard_normal((3, 4, 2)).astype(
        np.float32))
    plan = tpaging.scatter_plan(pages, pos, 16, 3, nvalid)
    got = tpaging.plan_rows(rows, plan)
    dest = (plan[0] * 16 + plan[1]).reshape(-1).tolist()
    flat = rows.reshape(12, 2)
    for r, d in enumerate(dest):
        last = max(s for s, e in enumerate(dest) if e == d)
        assert torch.equal(got.reshape(12, 2)[r], flat[last])
    assert len(set(dest)) < len(dest)          # duplicates were there
    fwd = torch.zeros((5, 16, 2))
    rev = torch.zeros((5, 16, 2))
    tpaging.scatter_token_rows(fwd, pages, rows, pos, nvalid)
    for r in reversed(range(12)):              # the other order
        rev[dest[r] // 16, dest[r] % 16] = got.reshape(12, 2)[r]
    assert torch.equal(fwd, rev)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_a_moe_model(arch):
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--reduced", "--device", "cpu", "--requests", "3", "--gen", "8"],
        capture_output=True, text=True, env=env, cwd=root, timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"arch={arch}" in out.stdout
    first = out.stdout.strip().splitlines()[-1]
    assert first.startswith("first request:")
    assert len(first.split("->")[1].strip().strip("[]").split(",")) == 8
