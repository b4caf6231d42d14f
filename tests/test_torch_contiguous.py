"""The port's contiguous slots (``paged_kv=False``) against the JAX package.

Slot operations (``slot_slice``, ``slot_update``, ``reset_slot``,
``copy_slot``) and ``pageable`` must equal the JAX package's exactly.  The
dense-cache decode functions (``gqa_decode``, ``gqa_decode_paged``,
``mla_decode``) run the reduced fp32 configs on the JAX weights
(``params_from_numpy``) and caches made from the same numpy arrays, with a
0-d index (lockstep), a (B,) index, a row count ``nvalid`` and a token
tree: outputs and caches within ``atol=rtol=1e-5``.  The dense ``lm`` entry
points (``decode_step``, ``prefill_chunk``, ``verify_chunk``,
``verify_tree``), at ``decode_page_size`` 0 (one softmax) and 16 (split-K
over the slot rows), within ``1e-4``.  The ``paged_kv=False`` engine runs
in lockstep with the JAX ``paged_kv=False`` engine on the reduced llama
config and a 1-layer MLA config: after every step the dense states agree
within ``1e-4``; at the end the tokens, every shared counter (the
``spec_*`` ones too) and the decode logits (``1e-4``) agree, through
prefix hits by ``copy_slot``, idle-lane writes after a retirement, a full
row dropped from the trie, eviction, sessions, and chain and tree
speculative decode.  The port's contiguous tokens equal its paged tokens,
and ``warmup`` changes no token, counter or state byte (a paged engine's
scratch page aside, which it re-zeroes)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import mla as jmla
from repro.serve import EngineConfig as JConfig
from repro.serve import ServeEngine as JEngine
from repro.serve import cache as jcache
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models import mla as tmla
from repro_torch.serve import EngineConfig, ServeEngine
from repro_torch.serve import cache as tcache
from test_torch_prefix import SHARED_COUNTERS, _model
from test_torch_spec_engine import SPEC_KEYS

SMAX = 32


@pytest.fixture(scope="module")
def gqa():
    return _model()


@pytest.fixture(scope="module")
def gqa1():
    return _model(n_layers=1)


@pytest.fixture(scope="module")
def mla1():
    return _model(arch="minicpm3-4b", n_layers=1)


@pytest.fixture(scope="module")
def mla2():
    return _model(arch="minicpm3-4b")


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=tol, rtol=tol)


def _tstate(state):
    return {k: torch.from_numpy(v.copy()) for k, v in state.items()}


def _jstate(state):
    return {k: jnp.asarray(v) for k, v in state.items()}


# ---------------------------------------------------------------------------
# slot operations, exactly
# ---------------------------------------------------------------------------

def _slot_specs(cfg, jax_side):
    return (jlm if jax_side else tlm).decode_state_specs(cfg, 3, 8)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "minicpm3-4b"])
def test_slot_ops_match_jax(gqa, mla1, arch):
    jcfg, tcfg = (gqa if arch == "llama3.2-3b" else mla1)[:2]
    jspecs, tspecs = _slot_specs(jcfg, True), _slot_specs(tcfg, False)
    rng = np.random.default_rng(1)
    base = {k: rng.standard_normal(s.shape).astype(np.float32)
            for k, s in tspecs.items()}
    upd = {k: rng.standard_normal((v.shape[0], 1) + v.shape[2:])
           .astype(np.float32) for k, v in base.items()}
    ops = [
        (lambda s, sp: jcache.reset_slot(s, sp, 1),
         lambda s, sp: tcache.reset_slot(s, sp, 1)),
        (lambda s, sp: jcache.copy_slot(s, sp, 2, 0),
         lambda s, sp: tcache.copy_slot(s, sp, 2, 0)),
        (lambda s, sp: jcache.copy_slot(s, sp, 1, 1),
         lambda s, sp: tcache.copy_slot(s, sp, 1, 1)),
        (lambda s, sp: jcache.slot_update(s, sp, 2, _jstate(upd)),
         lambda s, sp: tcache.slot_update(s, sp, 2, _tstate(upd)))]
    jst, tst = _jstate(base), _tstate(base)
    for jop, top in ops:
        jst = jop(jst, jspecs)
        out = top(tst, tspecs)
        assert out is tst
        for k in base:
            np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]))
    for slot in range(3):
        jsl = jcache.slot_slice(jst, jspecs, slot)
        tsl = tcache.slot_slice(tst, tspecs, slot)
        for k in base:
            np.testing.assert_array_equal(tsl[k].numpy(), np.asarray(jsl[k]))
    # a slice is a view: writing through it writes the state
    next(iter(tsl.values())).fill_(7.0)
    assert (next(iter(tst.values()))[:, 2] == 7.0).all()
    assert tcache.batch_axis(tspecs["k" if "k" in tspecs else "ckv"]) == 1


@pytest.mark.parametrize("page", [0, 8, 16, 24, 3])
def test_pageable_matches_jax(gqa, mla1, page):
    for jcfg, tcfg in (gqa[:2], mla1[:2]):
        for smax in (48, 64):
            want = jcache.pageable(jlm.decode_state_specs(jcfg, 2, smax),
                                   page)
            got = tcache.pageable(tlm.decode_state_specs(tcfg, 2, smax),
                                  page)
            assert got == want
    assert not tcache.pageable({}, 16)


# ---------------------------------------------------------------------------
# dense-cache decode functions
# ---------------------------------------------------------------------------

#: (batch, rows, index, nvalid); index an int is a 0-d (lockstep) index
FN_CASES = {
    "scalar prefill": (1, 8, 4, None),
    "scalar lockstep": (2, 1, 6, None),
    "vector": (2, 1, [3, 20], None),
    "vector chunk": (2, 4, [5, 28], None),
    "clamped": (2, 4, [5, 30], None),
    "nvalid": (3, 5, [3, 29, 10], [5, 3, 0]),
    "nvalid scalar": (2, 4, 7, [4, 2]),
    "tree": (2, 5, [5, 9], [5, 3]),
}

#: the tree case: slot 0 has 2 chain rows and 3 nodes, slot 1 one chain
#: row, 2 nodes and 2 padding rows (which parent themselves)
TREE = (np.array([[-1, 0, 1, 1, 2], [-1, 0, 0, 3, 4]]),
        np.array([[0, 1, 2, 2, 3], [0, 1, 1, 0, 0]]), np.array([2, 1]))


def _fn_inputs(case, width, caches, seed=3):
    b, c, cur, nvalid = FN_CASES[case]
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((b, c, width))).astype(np.float32)
    cs = [(0.5 * rng.standard_normal((b, SMAX) + tail)).astype(np.float32)
          for tail in caches]
    cur = np.asarray(cur, np.int64)
    nv = None if nvalid is None else np.asarray(nvalid, np.int64)
    tree = TREE if case == "tree" else None
    jargs = (jnp.asarray(x), *map(jnp.asarray, cs),
             jnp.asarray(cur, jnp.int32),
             None if nv is None else jnp.asarray(nv, jnp.int32))
    targs = (torch.from_numpy(x), *(torch.from_numpy(a.copy()) for a in cs),
             torch.from_numpy(cur), None if nv is None else
             torch.from_numpy(nv))
    jtree = None if tree is None else tuple(jnp.asarray(a, jnp.int32)
                                            for a in tree)
    ttree = None if tree is None else tuple(torch.from_numpy(a)
                                            for a in tree)
    return jargs, targs, jtree, ttree


def _layer0(model):
    jcfg, tcfg, jp, tp = model
    return (jax.tree.map(lambda a: a[0], jp["blocks"]["attn"]),
            {k: v[0] for k, v in tp["blocks"]["attn"].items()})


@pytest.mark.parametrize("case", sorted(FN_CASES))
@pytest.mark.parametrize("fn", ["gqa_decode", "gqa_decode_paged"])
def test_gqa_dense_decode_matches_jax(gqa, fn, case):
    jcfg, tcfg = gqa[:2]
    jl, tl = _layer0(gqa)
    tail = (tcfg.n_kv_heads, tcfg.hd)
    jargs, targs, jtree, ttree = _fn_inputs(case, tcfg.d_model, (tail, tail))
    x, ck, cv, cur, nv = jargs
    page = (8,) if fn == "gqa_decode_paged" else ()
    want = getattr(jattn, fn)(x, jl, jcfg, ck, cv, cur, *page, nv, jtree)
    x, ck, cv, cur, nv = targs
    got = getattr(tattn, fn)(x, tl, tcfg, ck, cv, cur, *page, nv, ttree)
    assert got[1] is ck and got[2] is cv          # written in place
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("case", sorted(FN_CASES))
def test_mla_dense_decode_matches_jax(mla1, case):
    jcfg, tcfg = mla1[:2]
    jl, tl = _layer0(mla1)
    jargs, targs, jtree, ttree = _fn_inputs(
        case, tcfg.d_model, ((tcfg.kv_lora_rank,), (tcfg.qk_rope_dim,)))
    want = jmla.mla_decode(*jargs[:1], jl, jcfg, *jargs[1:], jtree)
    got = tmla.mla_decode(*targs[:1], tl, tcfg, *targs[1:], ttree)
    assert got[1] is targs[1] and got[2] is targs[2]
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_gqa_decode_paged_refuses_a_page_that_does_not_divide(gqa):
    tcfg = gqa[1]
    _, tl = _layer0(gqa)
    _, targs, _, _ = _fn_inputs("vector", tcfg.d_model,
                                ((tcfg.n_kv_heads, tcfg.hd),) * 2)
    with pytest.raises(ValueError, match="must divide max_seq=32"):
        tattn.gqa_decode_paged(*targs[:1], tl, tcfg, *targs[1:4], 12)


# ---------------------------------------------------------------------------
# the dense lm entry points
# ---------------------------------------------------------------------------

def _dense_state(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return {k: (0.5 * rng.standard_normal(s.shape)).astype(np.float32)
            for k, s in tlm.decode_state_specs(cfg, b, SMAX).items()}


def _batch(kind, vocab, rng):
    """A dense batch of ``kind`` as numpy arrays (and the entry point)."""
    if kind == "decode vector":
        return "decode_step", {"tokens": rng.integers(0, vocab, (2, 1)),
                               "index": np.array([3, 17])}
    if kind == "decode scalar":
        return "decode_step", {"tokens": rng.integers(0, vocab, (2, 1)),
                               "index": np.array(9)}
    if kind == "prefill":
        return "prefill_chunk", {"tokens": rng.integers(0, vocab, (2, 8)),
                                 "index": np.array(4), "nvalid": 6}
    if kind == "verify chunk":
        return "verify_chunk", {"tokens": rng.integers(0, vocab, (2, 5)),
                                "index": np.array([6, 27]),
                                "nspec": np.array([5, 2])}
    return "verify_tree", {"tokens": rng.integers(0, vocab, (2, 5)),
                           "index": np.array([5, 9]),
                           "parents": TREE[0], "pos_off": TREE[1],
                           "nchain": TREE[2], "nspec": np.array([5, 3])}


@pytest.mark.parametrize("kind", ["decode vector", "decode scalar",
                                  "prefill", "verify chunk", "verify tree"])
@pytest.mark.parametrize("arch_page", ["gqa 0", "gqa 16", "mla"])
def test_dense_lm_entry_points_match_jax(gqa, mla2, arch_page, kind):
    model = mla2 if arch_page == "mla" else gqa
    jcfg, tcfg, jp, tp = model
    page = int(arch_page.split()[1]) if arch_page != "mla" else 0
    jcfg = dataclasses.replace(jcfg, decode_page_size=page)
    tcfg = dataclasses.replace(tcfg, decode_page_size=page)
    rng = np.random.default_rng(5)
    name, batch = _batch(kind, tcfg.vocab, rng)
    state = _dense_state(tcfg, 2, 6)
    jb = {k: (v if k == "nvalid" else jnp.asarray(v, jnp.int32))
          for k, v in batch.items()}
    tb = {k: (v if k == "nvalid" else torch.as_tensor(v, dtype=torch.int64))
          for k, v in batch.items()}
    want = getattr(jlm, name)(jp, _jstate(state), jb, jcfg)
    tstate = _tstate(state)
    got = getattr(tlm, name)(tp, tstate, tb, tcfg)
    _close(got[0], want[0], 1e-4)
    for k in state:
        _close(tstate[k], want[-1][k], 1e-4)


def test_dense_quantized_state_keeps_the_reference_error(gqa):
    tcfg, tp = gqa[1], gqa[3]
    state = {k: torch.zeros(s.shape, dtype=torch.int8) for k, s in
             tlm.decode_state_specs(tcfg, 1, SMAX).items()}
    state.update({k + "_scale": torch.zeros(state[k].shape[:-1])
                  for k in ("k", "v")})
    batch = {"tokens": torch.zeros((1, 1), dtype=torch.int64),
             "index": torch.tensor([0])}
    with pytest.raises(ValueError) as e:
        tlm.decode_step(tp, state, batch, tcfg)
    assert str(e.value) == ("quantized KV state requires a page table "
                            "(kv_dtype != 'fp32' is paged-only)")


# ---------------------------------------------------------------------------
# the paged_kv=False engine, in lockstep with the JAX engine
# ---------------------------------------------------------------------------

def _prompts(vocab, scenario):
    rng = np.random.default_rng(41)

    def toks(n):
        return rng.integers(0, vocab, n).tolist()
    if scenario == "prefix":
        system = toks(12)
        return [system + toks(n) for n in (4, 9, 2, 6)], [5, 4, 6, 3]
    if scenario == "idle":
        a, b = toks(16), toks(16)
        c = a[:12] + toks(4)
        return [a, b, c], [2, 20, 6]
    if scenario == "full row":
        # the first request fills its 32-position row (24 + 8 written)
        a, b = toks(24), toks(4)
        return [a, b, a[:12] + toks(4)], [9, 20, 6]
    if scenario == "evict":
        return [toks(n) for n in (14, 9, 20)], [10, 12, 6]
    pat = toks(5)                                   # drafting pays here
    return ([pat * 4, toks(13), pat * 3 + [1], toks(8), pat[::-1] * 3],
            [10, 8, 12, 9, 11])


#: scenario -> engine knobs (over max_slots 2, prefill chunk 8, page 16)
SCENARIOS = {
    "prefix": dict(max_seq=48, min_prefix=8),
    "idle": dict(max_seq=48, min_prefix=8),
    "full row": dict(max_seq=32, min_prefix=8),
    "evict": dict(max_seq=48),
    "chain": dict(max_seq=64, spec_k=4),
    "tree": dict(max_seq=64, spec_k=4, spec_mode="tree",
                 spec_tree_nodes=6, spec_branch=2),
    "auto": dict(max_seq=64, spec_k=4, spec_mode="auto",
                 spec_tree_nodes=6, spec_branch=2),
    "dense": dict(max_seq=48, page_size=0, min_prefix=8),
}


def _submit_all(eng, scenario, prompts, gens):
    """Submit ``scenario``'s requests; in "idle" and "full row" the third
    (the one reusing the first's prefix) waits until the first retired and
    its slot idled for 6 steps while the second kept decoding."""
    reqs = [eng.submit(p, g) for p, g in zip(prompts[:2], gens[:2])]
    if scenario in ("idle", "full row"):
        return reqs
    return reqs + [eng.submit(p, g) for p, g in zip(prompts[2:], gens[2:])]


def lockstep(model, scenario):
    """Serve ``scenario`` on both engines step by step, the dense states
    agreeing after every step; returns (jax engine, port engine, jax
    requests, port requests)."""
    jcfg, tcfg, jp, tp = model
    knobs = dict(dict(max_slots=2, prefill_chunk=8, page_size=16),
                 **SCENARIOS[scenario])
    jeng = JEngine(jcfg, jp, config=JConfig(paged_kv=False, **knobs))
    teng = ServeEngine(tcfg, tp, config=EngineConfig(paged_kv=False,
                                                     **knobs), device="cpu")
    assert not jeng.paged and not teng.paged
    assert teng.config.to_dict() == jeng.config.to_dict()
    prompts, gens = _prompts(jcfg.vocab, scenario)
    for eng in (jeng, teng):
        eng.trace_logits = True
    jreqs = _submit_all(jeng, scenario, prompts, gens)
    treqs = _submit_all(teng, scenario, prompts, gens)
    steps, idle = 0, None
    while jeng.scheduler.has_work or teng.scheduler.has_work:
        if scenario == "evict" and steps == 4:
            for eng in (jeng, teng):
                eng.evict(min(eng.scheduler.active))
        jeng.step()
        teng.step()
        steps += 1
        for k in teng.state:
            _close(teng.state[k], jeng.state[k], 1e-4)
        if scenario in ("idle", "full row") and idle is None \
                and jreqs[0].generated and jreqs[0].slot is None:
            idle = steps
        if idle is not None and steps == idle + 6 and len(jreqs) == 2:
            jreqs.append(jeng.submit(prompts[2], gens[2]))
            treqs.append(teng.submit(prompts[2], gens[2]))
        assert steps < 500
    return jeng, teng, jreqs, treqs


def assert_same(jeng, teng, jreqs, treqs):
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert all(r.generated and r.slot is None for r in treqs)
    js, ts = jeng.stats_summary(), teng.stats_summary()
    for key in SHARED_COUNTERS + SPEC_KEYS + ("kv_bytes_per_slot",
                                             "kv_dtype"):
        assert ts[key] == js[key], (key, ts[key], js[key])
    assert len(teng.logit_trace) == len(jeng.logit_trace) > 0
    for t, j in zip(teng.logit_trace, jeng.logit_trace):
        np.testing.assert_allclose(t, j, atol=1e-4)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_contiguous_engine_matches_jax(gqa, scenario):
    jeng, teng, jreqs, treqs = lockstep(gqa, scenario)
    assert_same(jeng, teng, jreqs, treqs)
    st = teng.stats_summary()
    assert st["pages_in_use"] == st["pool_pages"] == 0
    if scenario in ("prefix", "idle"):
        assert st["prefix_hits"] >= 1
    if scenario == "prefix":
        # each hit from another slot copies that whole slot
        assert st["prefix_bytes_copied"] == teng.slot_bytes * (
            st["prefix_bytes_copied"] // teng.slot_bytes) > 0
    if scenario == "full row":
        # the retired row holds max_seq positions: an idle write has no
        # safe place, so the entry is dropped and the later prompt misses
        assert st["prefix_evictions"] >= 1 and st["prefix_hits"] == 0
    if scenario == "evict":
        assert st["evictions"] == 1
    if scenario in ("chain", "tree", "auto"):
        assert st["spec_accepted"] > 0
    if scenario == "tree":
        assert st["spec_tree_steps"] == st["decode_steps"]


@pytest.mark.parametrize("scenario", ["prefix", "idle", "tree"])
def test_mla_contiguous_engine_matches_jax(mla1, scenario):
    jeng, teng, jreqs, treqs = lockstep(mla1, scenario)
    assert_same(jeng, teng, jreqs, treqs)
    assert sorted(teng.state) == ["ckv", "kr"]
    assert teng.stats["moa_reduce_launches"] == 0


def test_idle_lane_writes_keep_a_retired_prefix(gqa1):
    """The mirror of the JAX engine's idle-decode test: a retired slot's
    prefix stays matchable while the other slot decodes, so the hit's
    tokens equal a cold engine's."""
    jcfg, tcfg, _, tp = gqa1
    prompts, gens = _prompts(tcfg.vocab, "idle")

    def run(prefix_cache):
        eng = ServeEngine(tcfg, tp, config=EngineConfig(
            max_slots=2, max_seq=48, prefill_chunk=8, min_prefix=8,
            paged_kv=False, prefix_cache=prefix_cache), device="cpu")
        ra = eng.submit(prompts[0], gens[0])
        eng.submit(prompts[1], gens[1])
        while not ra.done:
            eng.step()
        for _ in range(6):
            eng.step()
        rc = eng.submit(prompts[2], gens[2])
        eng.run()
        return rc.generated, eng

    cold, _ = run(False)
    warm, eng = run(True)
    assert eng.stats["prefix_hits"] >= 1
    assert warm == cold


def test_contiguous_sessions_keep_history_without_snapshots(gqa1):
    jcfg, tcfg, jp, tp = gqa1
    knobs = dict(max_slots=2, max_seq=64, prefill_chunk=8, paged_kv=False)
    jeng = JEngine(jcfg, jp, config=JConfig(**knobs))
    teng = ServeEngine(tcfg, tp, config=EngineConfig(**knobs), device="cpu")
    rng = np.random.default_rng(43)
    turns = [rng.integers(0, tcfg.vocab, n).tolist() for n in (10, 6, 5)]
    out = []
    for eng in (jeng, teng):
        reqs = []
        for t in turns:
            reqs.append(eng.submit_turn("c", t, 4))
            eng.run()
        out.append([r.generated for r in reqs])
        assert eng.sessions.get("c").row is None
    assert out[0] == out[1]
    js, ts = jeng.stats_summary(), teng.stats_summary()
    for key in SHARED_COUNTERS:
        assert ts[key] == js[key], key
    assert ts["session_turns"] == 3 and ts["session_hits"] == 0
    assert teng.end_session("c") and not teng.end_session("c")


@pytest.mark.parametrize("arch", ["llama3.2-3b", "minicpm3-4b"])
def test_contiguous_tokens_equal_paged_tokens(gqa, mla2, arch):
    """The mirror of the JAX package's paged-vs-contiguous test: a
    staggered workload with slot refill decodes the same greedy tokens
    on contiguous slots as on pages."""
    tcfg, tp = (gqa if arch == "llama3.2-3b" else mla2)[1::2]
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, tcfg.vocab, n).tolist() for n in (7, 12, 3, 9)]
    gens = [5, 4, 8, 6]
    toks = {}
    for paged in (False, True):
        eng = ServeEngine(tcfg, tp, config=EngineConfig(
            max_slots=2, max_seq=32, prefill_chunk=8, min_prefix=8,
            paged_kv=paged), device="cpu")
        reqs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
        eng.run()
        assert eng.paged == paged
        toks[paged] = [r.generated for r in reqs]
    assert toks[False] == toks[True]


@pytest.mark.parametrize("knobs", [
    dict(), dict(paged_kv=False), dict(page_size=0),
    dict(paged_kv=False, spec_k=4),
    dict(spec_k=4, spec_mode="tree", spec_tree_nodes=6, spec_branch=2),
    dict(paged_kv=False, spec_k=4, spec_mode="auto", spec_tree_nodes=6,
         spec_branch=2)], ids=str)
def test_warmup_changes_no_token_counter_or_state(gqa1, knobs):
    tcfg, tp = gqa1[1], gqa1[3]
    prompts, gens = _prompts(tcfg.vocab, "chain")
    runs = []
    for warm in (False, True):
        eng = ServeEngine(tcfg, tp, config=EngineConfig(
            max_slots=2, max_seq=64, prefill_chunk=8, **knobs), device="cpu")
        reqs = [eng.submit(p, g) for p, g in zip(prompts[:2], gens[:2])]
        eng.step()                   # live slots and resident state
        if warm:
            before = {k: v.clone() for k, v in eng.state.items()}
            stats = dict(eng.stats)
            eng.warmup()
            assert eng.stats == stats and not eng.logit_trace
            # a paged engine re-zeroes its scratch page 0 (idle lanes'
            # discarded writes land there)
            lo = 1 if eng.paged else 0
            for k, v in eng.state.items():
                assert torch.equal(v[:, lo:], before[k][:, lo:]), k
        reqs += [eng.submit(p, g) for p, g in zip(prompts[2:], gens[2:])]
        eng.run()
        st = eng.stats_summary()
        runs.append(([r.generated for r in reqs],
                     {k: st[k] for k in SHARED_COUNTERS + SPEC_KEYS}))
    assert runs[0] == runs[1]
