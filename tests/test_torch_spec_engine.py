"""The port's speculative serve engine against the JAX serve engine.

The reduced ``llama3.2-3b`` config (fp32, ``n_kv_heads=2``, 1 layer) with
the JAX engine's weights (``params_from_numpy``): chain (``spec_k=4``),
tree, auto and tree with trained draft heads (fitted in JAX and carried
across) run in lockstep with a JAX ``ServeEngine`` on the same knobs and
prompts, built so prompt lookup hits (repeated n-grams, as in
``tests/test_spec.py:104-131``).  After every step the page tables and
refcounts are equal, and so are, at the end, the greedy tokens, every
shared counter, every ``spec_*`` counter and the reconfigurator's decision
trace; decode logits agree within ``atol=1e-4``.  Each spec run's tokens
also equal the port's own sequential run's.  Invariants held after every
step: refcounts equal the table (chain: after ``_rollback_pages``); a live
slot's write page has refcount 1; a tree step changes no pool row outside
its slots' chain-part positions, scratch page 0 aside.  The degrade
ladder's ``SPEC_OFF`` level, sessions under tree decode, and EOS and
budget truncation are held against the JAX engine too.  The reduced MLA
config (``minicpm3-4b``, 1 layer) runs chain and tree decode over its
latent pools in the same lockstep."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.serve import EngineConfig as JConfig
from repro.serve import ServeEngine as JEngine
from repro.tune.workloads import bursty_trace
from repro_torch.convert import params_from_numpy
from repro_torch.serve import EngineConfig, ServeEngine
from test_torch_overload import replay
from test_torch_prefix import SHARED_COUNTERS, _conserved, _model

#: speculative counters and derived keys the two engines share
SPEC_KEYS = (
    "spec_drafted", "spec_accepted", "spec_lanes_drafted", "spec_lanes_hit",
    "spec_pages_rolled_back", "spec_steps", "spec_tree_steps",
    "spec_shape_chain", "spec_shape_tree", "spec_accept_rate",
    "spec_draft_hit_rate", "spec_k", "spec_mode", "spec_tree_nodes",
    "spec_branch", "spec_drafter", "spec_accept_p50", "spec_accept_p99",
    "spec_decision_trace")

GEOMETRY = dict(max_slots=2, max_seq=64, prefill_chunk=8, page_size=16)

MODES = {
    "chain": dict(spec_k=4),
    "tree": dict(spec_k=4, spec_mode="tree", spec_tree_nodes=6,
                 spec_branch=2),
    "auto": dict(spec_k=4, spec_mode="auto", spec_tree_nodes=6,
                 spec_branch=2),
    "heads": dict(spec_k=4, spec_mode="tree", spec_drafter="heads",
                  spec_tree_nodes=6, spec_branch=2),
}


@pytest.fixture(scope="module")
def model():
    return _model(n_layers=1)


def _prompts(vocab, seed=31):
    rng = np.random.default_rng(seed)
    pat = rng.integers(0, vocab, (5,)).tolist()
    return ([pat * 4, rng.integers(0, vocab, (13,)).tolist(), pat * 3 + [1],
             rng.integers(0, vocab, (8,)).tolist(), pat[::-1] * 3],
            [10, 8, 12, 9, 11])


@pytest.fixture(scope="module")
def heads_model(model):
    """The model with draft heads fitted in JAX on sequential trajectories
    of the test's prompts."""
    jcfg, tcfg, jp, tp = model
    prompts, gens = _prompts(jcfg.vocab)
    eng = ServeEngine(tcfg, tp, config=EngineConfig(**GEOMETRY),
                      device="cpu")
    reqs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
    eng.run()
    heads = jlm.fit_draft_heads(jcfg, jp, [r.context for r in reqs],
                                n_heads=3, head_dim=16, steps=40, seed=1)
    jp2 = dict(jp, draft_heads=heads)
    tp2 = dict(tp, draft_heads=params_from_numpy(
        jax.tree.map(np.asarray, heads), "cpu", torch.float32))
    return jcfg, tcfg, jp2, tp2


def _write_pages_single_owner(eng):
    """A live slot's next write page, where allocated, has refcount 1."""
    for slot, req in eng.scheduler.active.items():
        u = eng._spec_unwritten.get(slot, 1)
        p = int(eng.table[slot, (req.pos + 1 - u) // eng.page_size])
        assert p == 0 or int(eng.pool.refcount[p]) == 1, (slot, p)


def _watch_tree_writes(eng):
    """Wrap the port's tree verify: the pool rows a dispatch changes,
    scratch page 0 aside, lie at its slots' chain-part positions
    (``index .. index + nchain - 1`` through the dispatch's page table)."""
    inner = eng.api.verify_tree

    def verify(params, state, batch, cfg, **kw):
        allowed = set()
        for slot in range(batch["pages"].shape[0]):
            index = int(batch["index"][slot])
            for q in range(index, index + int(batch["nchain"][slot])):
                allowed.add((int(batch["pages"][slot, q // eng.page_size]),
                             q % eng.page_size))
        before = {k: v.clone() for k, v in state.items()}
        out = inner(params, state, batch, cfg, **kw)
        for k, v in state.items():
            diff = (v != before[k]).flatten(3).any(-1).any(0)   # (pages, ps)
            changed = {(int(p), int(o)) for p, o in diff.nonzero().tolist()
                       if p != 0}
            assert changed <= allowed, sorted(changed - allowed)
        eng.tree_writes_checked = getattr(eng, "tree_writes_checked", 0) + 1
        return out

    eng.api = dataclasses.replace(eng.api, verify_tree=verify)


def lockstep(model, prompts, gens, eos=None, **knobs):
    """Serve ``prompts`` on both engines step by step; after every step the
    tables and refcounts are equal and the port's invariants hold.
    Returns (jax engine, port engine, jax requests, port requests)."""
    jcfg, tcfg, jp, tp = model
    jeng = JEngine(jcfg, jp, config=JConfig(paged_kv=True, **GEOMETRY,
                                            **knobs))
    teng = ServeEngine(tcfg, tp, config=EngineConfig(**GEOMETRY, **knobs),
                       device="cpu")
    for eng in (jeng, teng):
        eng.trace_logits = True
    if teng.spec_mode != "chain":
        _watch_tree_writes(teng)
    jreqs = [jeng.submit(p, g, eos_id=eos) for p, g in zip(prompts, gens)]
    treqs = [teng.submit(p, g, eos_id=eos) for p, g in zip(prompts, gens)]
    while jeng.scheduler.has_work or teng.scheduler.has_work:
        jeng.step()
        teng.step()
        assert (teng.table == np.asarray(jeng.table)).all()
        assert (np.asarray(teng.pool.refcount)
                == np.asarray(jeng.pool.refcount)).all()
        _conserved(teng)
        _write_pages_single_owner(teng)
    return jeng, teng, jreqs, treqs


def assert_same(jeng, teng, jreqs, treqs):
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    js, ts = jeng.stats_summary(), teng.stats_summary()
    for key in SHARED_COUNTERS + SPEC_KEYS:
        assert ts[key] == js[key], (key, ts[key], js[key])
    assert len(teng.logit_trace) == len(jeng.logit_trace)
    for t, j in zip(teng.logit_trace, jeng.logit_trace):
        np.testing.assert_allclose(t, np.asarray(j), atol=1e-4)


def _sequential(model, prompts, gens, eos=None):
    _, tcfg, _, tp = model
    eng = ServeEngine(tcfg, tp, config=EngineConfig(**GEOMETRY),
                      device="cpu")
    reqs = [eng.submit(p, g, eos_id=eos) for p, g in zip(prompts, gens)]
    eng.run()
    return [r.generated for r in reqs]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_spec_engine_matches_jax_and_sequential(model, heads_model, mode):
    m = heads_model if mode == "heads" else model
    prompts, gens = _prompts(m[0].vocab)
    jeng, teng, jreqs, treqs = lockstep(m, prompts, gens, **MODES[mode])
    assert_same(jeng, teng, jreqs, treqs)
    assert [r.generated for r in treqs] == _sequential(model, prompts, gens)
    st = teng.stats_summary()
    assert st["spec_accepted"] > 0 and st["tokens_per_step"] > 1.0
    assert st["decode_steps"] < sum(gens)
    if mode == "chain":
        assert st["spec_tree_steps"] == 0
    else:
        assert st["spec_tree_steps"] == st["decode_steps"]
        assert st["spec_pages_rolled_back"] == 0
        assert teng.tree_writes_checked == st["decode_steps"]
    if mode == "auto":
        assert st["spec_decision_trace"]
        assert st["spec_shape_chain"] + st["spec_shape_tree"] > 0
    if mode == "heads":
        assert teng.head_drafter is not None and teng._head_preds == {}


@pytest.fixture(scope="module")
def mla_model():
    return _model(arch="minicpm3-4b", n_layers=1)


@pytest.mark.parametrize("mode", ["chain", "tree"])
def test_mla_spec_engine_matches_jax_and_sequential(mla_model, mode):
    """Chain and tree verify over the latent ckv / kr pools: tokens, every
    counter, the tables and refcounts after every step (a tree commits
    only its chain rows), and the logits equal the JAX engine's; the
    tokens equal the sequential run's."""
    prompts, gens = _prompts(mla_model[0].vocab)
    jeng, teng, jreqs, treqs = lockstep(mla_model, prompts, gens,
                                        **MODES[mode])
    assert_same(jeng, teng, jreqs, treqs)
    assert [r.generated for r in treqs] == _sequential(mla_model, prompts,
                                                       gens)
    st = teng.stats_summary()
    assert st["spec_accepted"] > 0 and st["decode_steps"] < sum(gens)
    assert st["moa_reduce_launches"] == 0
    if mode == "tree":
        assert st["spec_tree_steps"] == st["decode_steps"]
        assert teng.tree_writes_checked == st["decode_steps"]


def test_chain_rollback_releases_pages(model):
    """A page boundary crossed by rejected drafts: the rollback counter
    moves and refcounts stay equal to the table (held after every step)."""
    jcfg = model[0]
    rng = np.random.default_rng(7)
    pat = rng.integers(0, jcfg.vocab, (3,)).tolist()
    prompts = [pat * 5, rng.integers(0, jcfg.vocab, (14,)).tolist(),
               pat * 4 + [2, 2]]
    gens = [30, 33, 28]
    jeng, teng, jreqs, treqs = lockstep(model, prompts, gens, spec_k=4)
    assert_same(jeng, teng, jreqs, treqs)
    assert teng.stats["spec_pages_rolled_back"] > 0
    assert [r.generated for r in treqs] == _sequential(model, prompts, gens)


@pytest.mark.parametrize("mode", ["chain", "tree"])
def test_eos_and_budget_truncate_like_sequential(model, mode):
    """An EOS inside an accepted draft, and budgets of 1 to 3 tokens:
    speculative output stops at the token sequential decode stops at."""
    jcfg = model[0]
    prompts, _ = _prompts(jcfg.vocab)
    seq = _sequential(model, prompts, [12] * len(prompts))
    eos = seq[0][4]
    gens = [12, 1, 12, 2, 3]
    jeng, teng, jreqs, treqs = lockstep(model, prompts, gens, eos=eos,
                                        **MODES[mode])
    assert_same(jeng, teng, jreqs, treqs)
    assert [r.generated for r in treqs] == _sequential(model, prompts, gens,
                                                       eos=eos)
    assert treqs[0].generated[-1] == eos and len(treqs[0].generated) <= 5


@pytest.mark.parametrize("mode", ["chain", "tree"])
def test_spec_off_under_a_burst_matches_jax(model, mode):
    """A seeded SLO'd burst on one virtual-clock loop with the ladder on:
    it reaches ``spec_off``, where chain mode decodes sequentially and
    tree mode verifies with no drafted node; everything equals the JAX
    engine."""
    jcfg = model[0]
    trace = bursty_trace(18, rate=2.0, burst_rate=30.0, mean_prompt=16,
                         mean_gen=8, max_prompt=40, max_gen=16,
                         vocab=jcfg.vocab, slo_ms=300.0, seed=11)
    knobs = dict(max_slots=2, max_seq=96, prefill_chunk=16, degrade=True,
                 **MODES[mode])
    jcfg, tcfg, jp, tp = model
    jeng = JEngine(jcfg, jp, config=JConfig(paged_kv=True, **knobs))
    teng = ServeEngine(tcfg, tp, config=EngineConfig(**knobs), device="cpu")
    off = {"sequential": 0, "undrafted": 0}
    seq, tree = teng._decode_once, teng._tree_decode_once

    def counted_seq():
        off["sequential"] += 1
        return seq()

    def counted_tree(draft=True):
        off["undrafted"] += not draft
        return tree(draft)

    teng._decode_once, teng._tree_decode_once = counted_seq, counted_tree
    jreqs, treqs = replay(jeng, trace), replay(teng, trace)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    js, ts = jeng.stats_summary(), teng.stats_summary()
    for key in SHARED_COUNTERS + SPEC_KEYS:
        assert ts[key] == js[key], (key, ts[key], js[key])
    assert (teng.table == np.asarray(jeng.table)).all()
    assert (np.asarray(teng.pool.refcount)
            == np.asarray(jeng.pool.refcount)).all()
    assert ts["degrade_steps"] >= 1 and ts["spec_steps"] >= 1
    assert off["sequential" if mode == "chain" else "undrafted"] >= 1
    assert all(len(r.generated) == r.max_new for r in treqs
               if r.shed_reason is None)


def test_sessions_under_tree_decode_match_jax(model):
    """Two conversations x 3 turns on one slot under tree decode: a turn
    retires with its last accepted path unwritten, so the snapshot covers
    ``pos + 1 - unwritten`` positions; the next turn reuses exactly that."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(9)
    pat = rng.integers(0, jcfg.vocab, (4,)).tolist()
    turns = [[pat * 3, pat[:2] * 2, pat * 2], [rng.integers(
        0, jcfg.vocab, (10,)).tolist(), pat * 2, rng.integers(
        0, jcfg.vocab, (5,)).tolist()]]
    knobs = dict(max_slots=1, max_seq=96, prefill_chunk=8, page_size=16,
                 **MODES["tree"])
    jeng = JEngine(jcfg, jp, config=JConfig(paged_kv=True, **knobs))
    teng = ServeEngine(tcfg, tp, config=EngineConfig(**knobs), device="cpu")
    out = {}
    for name, eng in (("jax", jeng), ("torch", teng)):
        reqs, covered = [], []
        for k in range(3):
            for c in range(2):
                reqs.append(eng.submit_turn(c, turns[c][k], 7))
            eng.run()
            covered.append([eng.sessions.get(c).covered for c in range(2)])
        out[name] = ([r.generated for r in reqs], covered,
                     eng.stats["session_hits"],
                     eng.stats["session_reused_tokens"],
                     eng.stats["spec_tree_steps"])
    assert out["torch"] == out["jax"]
    assert out["torch"][2] > 0
    _conserved(teng)


@pytest.mark.parametrize("flags,spec", [([], True), (["--no-spec"], False),
                                        (["--spec-mode", "tree"], True)])
def test_cli_serves_speculatively_by_default(flags, spec):
    """The serve CLI drafts by default (``--spec-k 4``), as the JAX CLI
    does, and prints the speculative report; ``--no-spec`` decodes
    sequentially."""
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--requests", "3", "--gen", "8"] + flags,
        capture_output=True, text=True, env=env, cwd=root, timeout=300)
    assert out.returncode == 0, out.stderr
    assert ("speculative decode (k=4)" in out.stdout) == spec
    assert ("tree speculation (mode=tree" in out.stdout) == \
        ("tree" in flags)


@pytest.mark.parametrize("bad", [
    dict(spec_k=-1), dict(spec_ngram=0), dict(spec_mode="wide"),
    dict(spec_tree_nodes=0), dict(spec_branch=0), dict(spec_drafter="lm")],
    ids=lambda d: next(iter(d)))
def test_spec_knob_validation_matches_jax(bad):
    """The spec knobs are refused with the JAX config's messages."""
    msgs = []
    for cls in (EngineConfig, JConfig):
        with pytest.raises(ValueError) as e:
            cls(**bad).validate()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_spec_knob_resolution_matches_jax(model):
    """``spec_mode`` falls back to chain when ``spec_k`` is 0, as in the
    JAX config; with ``spec_k`` it stays."""
    jcfg, tcfg, _, _ = model
    for knobs in (dict(spec_k=0, spec_mode="tree"),
                  dict(spec_k=3, spec_mode="auto"),
                  dict(spec_k=2, spec_mode="tree", spec_drafter="heads")):
        t = EngineConfig(max_seq=64, **knobs).resolve(tcfg)
        j = JConfig(max_seq=64, **knobs).resolve(jcfg)
        assert (t.spec_k, t.spec_mode, t.spec_drafter) == \
            (j.spec_k, j.spec_mode, j.spec_drafter)
