"""The port's mesh-sharded serving against the JAX package.

The host layout pieces are held in lockstep with the JAX objects, which
need no device mesh: ``MeshPlan``'s arithmetic (the JAX plan built from
its fields, since this process has one JAX device), ``PagePool(shards)``
op for op, the ``Scheduler``'s shard functions, and ``EngineConfig``
validation and resolution.  The JAX sharded engine is no oracle (its
``shard_map`` prefill fails under jax 0.9, ``ROADMAP.md`` queue 3), so
the port's 2-shard engine, on devices ``["cpu"] * 2``, is held to the
contract the JAX package states for it: greedy tokens equal those of the JAX
single-device engine serving the same requests, and of the port's own
one-shard engine, on the reduced fp32 ``llama3.2-3b`` and
``minicpm3-4b``.  A seeded 40-op churn walk holds every allocator
invariant of a sharded pool after every op, at 2 shards and at 4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import EngineConfig as JConfig
from repro.serve import SamplingParams as JSampling
from repro.serve import ServeEngine as JEngine
from repro.serve.cache import PagePool as JPool
from repro.serve.mesh import MeshPlan as JPlan
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import Scheduler as JScheduler
from repro.configs.registry import get_config as jget
from repro_torch.configs.registry import get_config as tget
from repro_torch.serve import (EngineConfig, PagePool, Request,
                               SamplingParams, Scheduler, ServeEngine)
from repro_torch.serve.mesh import MeshPlan
from test_torch_prefix import _model

CPU2 = ["cpu", "cpu"]


@pytest.fixture(scope="module")
def llama():
    return _model()


# ---------------------------------------------------------------------------
# the layout pieces, in lockstep with the JAX objects
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards,knobs", [
    (2, dict(max_slots=4, max_seq=64)),
    (4, dict(max_slots=8, max_seq=64, page_size=16, pool_pages=12)),
    (2, dict(max_slots=2, max_seq=32, page_size=8, pool_pages=12))],
    ids=str)
def test_mesh_plan_equals_jax(llama, shards, knobs):
    jcfg, tcfg = llama[:2]
    tres = EngineConfig(mesh_shards=shards, **knobs).resolve(tcfg)
    jres = JConfig(mesh_shards=shards, **knobs).resolve(jcfg)
    plan = MeshPlan.build(tres, devices=["cpu"] * shards)
    jplan = JPlan(shards=jres.mesh_shards,
                  slots_per_shard=jres.max_slots // jres.mesh_shards,
                  block=jres.pool_pages // jres.mesh_shards + 1, mesh=None)
    assert (plan.shards, plan.slots_per_shard, plan.block) == \
        (jplan.shards, jplan.slots_per_shard, jplan.block)
    assert plan.devices == (torch.device("cpu"),) * shards
    assert [plan.shard_of_slot(s) for s in range(tres.max_slots)] == \
        [jplan.shard_of_slot(s) for s in range(tres.max_slots)]
    pages = plan.shards * plan.block
    assert [plan.shard_of_page(p) for p in range(pages)] == \
        [jplan.shard_of_page(p) for p in range(pages)]
    table = np.random.default_rng(shards).integers(0, pages, (6, 5))
    assert (plan.local_pages(table) == jplan.local_pages(table)).all()


def _pool_state(pool):
    return ([list(f) for f in pool._free], pool.refcount.tolist(),
            [pool.free_count_in(s) for s in range(pool.shards)],
            pool.free_count, pool.used_count, pool.allocs, pool.oom_events)


def _pool_op(pool, op, arg, shard):
    """One op on ``pool``: its return value, or the error's type and
    message."""
    try:
        if op == "alloc":
            out = pool.alloc(shard)
        elif op == "alloc_many":
            out = pool.alloc_many(arg, shard)
        elif op == "ref":
            out = pool.ref(arg)
        elif op == "ref_many":
            out = pool.ref_many(np.asarray(arg))
        elif op == "deref":
            out = pool.deref(arg)
        else:
            out = pool.deref_many(np.asarray(arg))
    except ValueError as e:
        return ("ValueError", str(e))
    if isinstance(out, np.ndarray):
        return ("array", out.tolist())
    return out


@pytest.mark.parametrize("shards", [2, 4])
def test_page_pool_shards_equal_jax(shards):
    """The same seeded alloc / ref / deref walk (scratch pages and
    underflows included) on both pools: every return value or error, the
    free lists, refcounts and per-shard free counts after every op."""
    num_pages = shards * 5
    jpool, tpool = JPool(num_pages, shards=shards), PagePool(num_pages,
                                                               shards=shards)
    assert [tpool.shard_of(p) for p in range(num_pages)] == \
        [jpool.shard_of(p) for p in range(num_pages)]
    assert [bool(tpool.is_scratch(p)) for p in range(num_pages)] == \
        [bool(jpool._is_scratch(p)) for p in range(num_pages)]
    rng = np.random.default_rng(shards)
    ops = ("alloc", "alloc_many", "ref", "ref_many", "deref", "deref_many")
    for _ in range(300):
        op = ops[int(rng.integers(0, len(ops)))]
        shard = int(rng.integers(0, shards))
        if op == "alloc_many":
            arg = int(rng.integers(0, 4))
        elif op in ("ref", "deref"):
            arg = int(rng.integers(0, num_pages))
        else:
            arg = rng.integers(0, num_pages,
                               int(rng.integers(0, 4))).tolist()
        assert _pool_op(tpool, op, arg, shard) == \
            _pool_op(jpool, op, arg, shard), (op, arg, shard)
        assert _pool_state(tpool) == _pool_state(jpool)
    assert jpool.allocs > 10 and jpool.oom_events > 0


@pytest.mark.parametrize("shards", [2, 4])
def test_scheduler_shard_functions_equal_jax(shards):
    """Admissions, decodes that retire, and evictions on both schedulers:
    ``free_slots``, ``shard_loads`` and every slot's shard after every op,
    and ``from_config`` passing ``mesh_shards``."""
    scheds = [m.from_config(c(max_slots=8, max_seq=64, mesh_shards=shards))
              for m, c in ((Scheduler, EngineConfig),
                           (JScheduler, JConfig))]
    reqs = (Request, JRequest)
    assert [s.mesh_shards for s in scheds] == [shards] * 2
    assert [[s.shard_of_slot(i) for i in range(8)] for s in scheds] == \
        [[i // (8 // shards) for i in range(8)]] * 2
    rng = np.random.default_rng(shards)
    for _ in range(120):
        op = int(rng.integers(0, 4))
        if op == 0:
            n = int(rng.integers(1, 6))
            for s, r in zip(scheds, reqs):
                s.submit(r(prompt=[1, 2, 3], max_new=n))
        elif op == 1:
            for s in scheds:
                for _slot, req in s.admissions():
                    s.on_prefill(req, 5)
        elif op == 2:
            for s in scheds:
                s.on_decode({slot: 7 for slot in s.active})
        elif scheds[0].active:
            slots = sorted(scheds[0].active)
            victim = slots[int(rng.integers(0, len(slots)))]
            for s in scheds:
                s.evict(victim)
        assert scheds[0].free_slots() == scheds[1].free_slots()
        assert scheds[0].shard_loads() == scheds[1].shard_loads()
        assert sorted(scheds[0].active) == sorted(scheds[1].active)
    assert scheds[0].finished


@pytest.mark.parametrize("shards", [2, 4])
def test_engine_config_mesh_equals_jax(llama, shards):
    """Validation and resolution of a sharded config: the same values,
    and a contiguous family refused with the JAX class and message."""
    jcfg, tcfg = llama[:2]
    for knobs in (dict(), dict(max_seq=64, spec_k=3, kv_dtype="int8"),
                  dict(max_seq=48, page_size=16, pool_pages=12,
                       page_dedup=True)):
        knobs = dict(knobs, mesh_shards=shards)
        t, j = EngineConfig(**knobs), JConfig(**knobs)
        assert t.validate().to_dict() == j.validate().to_dict()
        assert t.resolve(tcfg).to_dict() == j.resolve(jcfg).to_dict()
    for arch in ("falcon-mamba-7b", "llama3.2-3b"):
        over = {} if arch != "llama3.2-3b" else dict(paged_kv=False)
        errs = []
        for cls, get, dt in ((EngineConfig, tget, torch.float32),
                             (JConfig, jget, jnp.float32)):
            with pytest.raises(Exception) as e:
                cls(mesh_shards=shards, max_seq=64, **over).resolve(
                    get(arch).reduced(dtype=dt))
            errs.append((type(e.value).__name__, str(e.value)))
        assert errs[0] == errs[1]
        assert errs[0][0] == "ValueError" and "paged engine" in errs[0][1]


def test_build_raises_without_enough_devices(llama):
    """No list and fewer CUDA devices than shards: ``MeshPlan.build`` and
    the engine raise, naming ``devices=``; nothing folds onto fewer
    devices on its own."""
    _, tcfg, _, tp = llama
    ecfg = EngineConfig(mesh_shards=2, max_seq=64)
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="devices="):
            MeshPlan.build(ecfg.resolve(tcfg))
        with pytest.raises(RuntimeError, match="devices="):
            ServeEngine(tcfg, tp, config=ecfg, device="cpu")
    with pytest.raises(ValueError, match="mesh_shards >= 2"):
        MeshPlan.build(EngineConfig().resolve(tcfg), devices=CPU2)
    with pytest.raises(ValueError, match="RESOLVED"):
        MeshPlan.build(ecfg, devices=CPU2)
    with pytest.raises(ValueError, match="one device a shard"):
        MeshPlan.build(ecfg.resolve(tcfg), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="devices="):
        ServeEngine(tcfg, tp, config=EngineConfig(max_seq=64),
                    device="cpu", devices=["cpu"])


# ---------------------------------------------------------------------------
# the 2-shard engine: greedy tokens of the JAX single-device engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["llama3.2-3b", "minicpm3-4b"])
def model(request):
    return _model(arch=request.param)


def _passages(rng, vocab, n, passage=12, reps=3, tail=5):
    """Prompts of a repeated passage (speculative drafts hit) plus a
    random tail."""
    out = []
    for _ in range(n):
        p = rng.integers(0, vocab, (passage,)).tolist()
        out.append(p * reps + rng.integers(0, vocab, (tail,)).tolist())
    return out


def _drive_batch(prompts, new, sampling=None):
    def drive(eng, sp_cls):
        sp = None if sampling is None else sp_cls(**sampling)
        reqs = [eng.submit(p, new, sampling=sp) for p in prompts]
        eng.run()
        return [r.generated for r in reqs]
    return drive


def _drive_prefix(shared, tails, new):
    """Two cold requests holding ``shared``, then the rest, which hit it
    (on a mesh, on the shard that holds their slot)."""
    def drive(eng, _sp):
        first = [eng.submit(shared + t, new) for t in tails[:2]]
        eng.run()
        rest = [eng.submit(shared + t, new) for t in tails[2:]]
        eng.run()
        return [r.generated for r in first + rest]
    return drive


def _drive_sessions(turns, new):
    def drive(eng, _sp):
        out = []
        for turn in turns:
            reqs = [eng.submit_turn(c, toks, new) for c, toks in turn]
            eng.run()
            out += [r.generated for r in reqs]
        return out
    return drive


def _cases(vocab):
    rng = np.random.default_rng(7)
    lens = (20, 5, 33, 12, 9, 27)
    plain = [rng.integers(0, vocab, (n,)).tolist() for n in lens]
    shared = rng.integers(0, vocab, (24,)).tolist()
    tails = [rng.integers(0, vocab, (n,)).tolist() for n in (3, 6, 4, 9, 2)]
    # A, B, A', B': the admission order puts A and A' on one shard
    a, b = (rng.integers(0, vocab, (36,)).tolist() for _ in range(2))
    twins = [a, b, a[:32] + [1, 2], b[:32] + [3]]
    turns = [[("c0", rng.integers(0, vocab, (18,)).tolist()),
              ("c1", rng.integers(0, vocab, (11,)).tolist())],
             [("c1", rng.integers(0, vocab, (4,)).tolist()),
              ("c0", rng.integers(0, vocab, (5,)).tolist())]]
    spec = _passages(rng, vocab, 4)
    return {
        "plain": (dict(prefix_cache=False), _drive_batch(plain, 8)),
        "prefix": ({}, _drive_prefix(shared, tails, 6)),
        "dedup": (dict(prefix_cache=False, page_dedup=True),
                  _drive_batch(twins, 6)),
        "session": ({}, _drive_sessions(turns, 5)),
        "chain": (dict(spec_k=3), _drive_batch(spec, 10)),
        "tree": (dict(spec_k=3, spec_mode="tree", spec_tree_nodes=6,
                      spec_branch=2), _drive_batch(spec, 10)),
        "int8": (dict(kv_dtype="int8"), _drive_batch(plain, 8)),
        "sampled": ({}, _drive_batch(plain, 8, dict(
            temperature=0.8, top_k=20, seed=3))),
    }


CASES = ("plain", "prefix", "dedup", "session", "chain", "tree", "int8",
         "sampled")


@pytest.mark.parametrize("case", CASES)
def test_two_shard_tokens_equal_jax_single_device(model, case):
    jcfg, tcfg, jp, tp = model
    knobs, drive = _cases(tcfg.vocab)[case]
    knobs = dict(dict(max_slots=4, max_seq=64, prefill_chunk=16), **knobs)
    want = drive(JEngine(jcfg, jp, config=JConfig(**knobs)), JSampling)
    one = ServeEngine(tcfg, tp, config=EngineConfig(**knobs), device="cpu")
    two = ServeEngine(tcfg, tp, config=EngineConfig(mesh_shards=2, **knobs),
                      device="cpu", devices=CPU2)
    assert drive(one, SamplingParams) == want
    assert drive(two, SamplingParams) == want
    _assert_shard_invariants(two)
    st = two.stats_summary()
    assert st["mesh_shards"] == 2 and two.mesh_plan.block == \
        two.pool.block and len(two.states) == 2
    assert min(st["shard_lane_steps"]) > 0
    assert st["decode_dispatches"] > st["decode_steps"]
    assert st["pool_pages"] == one.stats_summary()["pool_pages"]
    if case == "prefix":
        assert st["prefix_hits"] >= 2
    if case == "dedup":
        assert st["dedup_pages_shared"] >= 2
    if case == "session":
        assert st["session_turns"] == 4


# ---------------------------------------------------------------------------
# the allocator invariants under churn
# ---------------------------------------------------------------------------

def _assert_shard_invariants(eng):
    """Refcounts equal the table + snapshot ground truth; every shard's
    scratch page pinned and mapped by nothing; free lists sized right,
    free and inside their own block; no row maps a page outside its
    slot's block; no dedup entry on a freed page."""
    pool = eng.pool
    counts = np.zeros(pool.num_pages, np.int64)
    np.add.at(counts, eng.table[eng.table != 0], 1)
    for p in eng.sessions.snapshot_pages():
        counts[p] += 1
    scratch = [s * pool.block for s in range(pool.shards)]
    for p in scratch:
        assert int(pool.refcount[p]) == 1 and counts[p] == 0, p
    others = np.setdiff1d(np.arange(pool.num_pages), scratch)
    bad = others[pool.refcount[others] != counts[others]]
    assert not bad.size, f"refcount != table + snapshot count on {bad}"
    free = [p for block in pool._free for p in block]
    assert len(free) == len(set(free)) == pool.free_count
    assert all(int(pool.refcount[p]) == 0 for p in free)
    for sh, block in enumerate(pool._free):
        assert all(pool.shard_of(p) == sh for p in block), (sh, block)
    for slot in range(eng.max_slots):
        row = eng.table[slot]
        assert all(pool.shard_of(p) == eng._slot_shard(slot)
                   for p in row[row != 0]), (slot, row)
    if eng.dedup is not None:
        assert all(int(pool.refcount[p]) > 0 for p in eng.dedup.pages())


@pytest.mark.parametrize("shards", [2, 4])
def test_churn_walk_holds_shard_invariants(llama, shards):
    """``prog_shard_churn.py``'s walk on the port: admit (half on a shared
    prefix), session turns, steps, evictions, session ends and drains,
    with the invariants after every op."""
    _, cfg, _, params = llama
    eng = ServeEngine(cfg, params, config=EngineConfig(
        max_slots=shards, max_seq=32, prefill_chunk=8, page_size=8,
        paged_kv=True, pool_pages=4 * shards if shards > 2 else 12,
        spec_k=3, min_prefix=8, trie_capacity=3, page_dedup=True,
        mesh_shards=shards), device="cpu", devices=["cpu"] * shards)
    assert eng.mesh_plan is not None and eng.pool.shards == shards
    _assert_shard_invariants(eng)
    rng = np.random.default_rng(99)
    shared = [int(t) for t in rng.integers(0, cfg.vocab, (12,))]
    convs = ("conv-a", "conv-b")
    for _ in range(40):
        op = int(rng.integers(0, 6))
        if op == 0 and len(eng.scheduler.pending) < 4:
            if int(rng.integers(0, 2)):
                prompt = shared + [int(t) for t in
                                   rng.integers(0, cfg.vocab, (3,))]
            else:
                prompt = [int(t) for t in rng.integers(0, cfg.vocab, (10,))]
            eng.submit(prompt, int(rng.integers(2, 7)))
        elif op == 1 and len(eng.scheduler.pending) < 4:
            conv = convs[int(rng.integers(0, 2))]
            sess = eng.sessions.get(conv)
            if sess is not None and len(sess.history) > 20:
                eng.end_session(conv)
            eng.submit_turn(conv, [int(t) for t in
                                   rng.integers(0, cfg.vocab, (4,))], 2)
        elif op == 2:
            eng.step()
        elif op == 3 and eng.scheduler.active:
            slots = sorted(eng.scheduler.active)
            eng.evict(slots[int(rng.integers(0, len(slots)))])
        elif op == 4:
            eng.end_session(convs[int(rng.integers(0, 2))])
        else:
            eng.run(max_steps=6)
        _assert_shard_invariants(eng)
    assert eng.stats["admissions"] > 0 and eng.scheduler.finished
    st = eng.stats_summary()
    assert st["mesh_shards"] == shards
    assert len(st["shard_lane_steps"]) == shards
    assert sum(st["shard_lane_steps"]) == st["decode_lane_steps"]
