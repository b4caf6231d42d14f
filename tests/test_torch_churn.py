"""Serve-churn invariants of the port's engine: a fresh engine per seed.

Each seed drives a numpy-seeded random walk of ``submit`` (prompts with a
shared head, a shared span after one page, or none; some with a tight
SLO), ``submit_turn``, ``end_session``, ``evict`` and ``step`` through a
new engine with the prefix cache, page dedup, sessions and the degrade
ladder on, a small pool and a virtual clock, and checks after every
operation that:

* each page's refcount equals its occurrences across table rows and
  session snapshots, and scratch stays pinned and unmapped;
* the free list and the used pages partition the allocatable pool;
* every dedup-indexed page is resident and re-hashes to its digest;
* every live slot's write page (where mapped) has refcount 1;
* every shed request was retired with a reason and counted as a miss.

The speculative walks repeat it with chain and tree decode on (prompts
with repeated n-grams, so drafts are accepted and rolled back).

No engine is shared between seeds or examples: every walk starts from a
fresh engine, so a failure reproduces from its seed alone."""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.models.common import init_params
from repro_torch.models.registry import get_api
from repro_torch.serve import EngineConfig, ServeEngine

SEEDS = [0, 1, 2, 3, 4, 5]
OPS = 150


@pytest.fixture(scope="module")
def model():
    cfg = get_config("llama3.2-3b").reduced(dtype=torch.float32,
                                            n_kv_heads=2, n_layers=1)
    params = init_params(get_api(cfg).param_specs(cfg),
                         torch.Generator().manual_seed(0),
                         torch.device("cpu"), torch.float32)
    return cfg, params


def _assert_invariants(eng):
    pool = eng.pool
    counts = np.zeros(pool.num_pages, np.int64)
    for p in eng.table.ravel():
        counts[int(p)] += 1
    for p in eng.sessions.snapshot_pages():
        counts[p] += 1
    assert int(pool.refcount[0]) == 1
    assert 0 not in eng.sessions.snapshot_pages()
    bad = np.flatnonzero(np.asarray(pool.refcount[1:]) != counts[1:]) + 1
    assert not bad.size, f"refcount != table + snapshot count on {bad}"
    free = [p for block in pool._free for p in block]
    used = set(np.flatnonzero(counts[1:]) + 1)
    assert len(free) == len(set(free)) == pool.free_count
    assert set(free).isdisjoint(used)
    assert set(free) | used == set(range(1, pool.num_pages))
    assert pool.used_count == len(used)
    if eng.dedup is not None:
        for p in eng.dedup.pages():
            assert int(pool.refcount[p]) > 0, f"dedup indexes freed {p}"
            assert eng._digest_fn(eng._page_bytes_of(p)) == \
                eng.dedup.digest_of(p), f"stale digest on page {p}"
    for slot, req in eng.scheduler.active.items():
        # the next write position: req.pos, or the first of a tree step's
        # unwritten chain part
        nxt = req.pos + 1 - eng._spec_unwritten.get(slot, 1)
        p = int(eng.table[slot, nxt // eng.page_size])
        assert p == 0 or int(pool.refcount[p]) == 1, (
            f"slot {slot} would write through shared page {p}")
    shed = [r for r in eng.scheduler.finished if r.shed_reason is not None]
    assert len(shed) == eng.scheduler.shed_count
    assert all(r.slo_met is False for r in shed)


def _walk(model, seed, **knobs):
    """The random walk of ``seed`` on a fresh engine (``knobs`` added to
    its config), invariants checked after every operation; returns the
    engine's summary."""
    cfg, params = model
    eng = ServeEngine(cfg, params, config=EngineConfig(
        max_slots=2, max_seq=48, prefill_chunk=8, page_size=8,
        pool_pages=12, trie_capacity=3, page_dedup=True, degrade=True,
        **knobs), device="cpu")
    clock = [0.0]
    eng.scheduler.clock = lambda: clock[0]
    rng = np.random.default_rng(seed)
    vocab = cfg.vocab
    shared = rng.integers(0, vocab, (16,)).tolist()
    convs = ("conv-a", "conv-b", "conv-c")

    def busy(conv):
        return any(getattr(r, "_conv_id", None) == conv for r in
                   list(eng.scheduler.pending)
                   + list(eng.scheduler.active.values()))

    def step(dt):
        eng.scheduler.update_cost_model(chunk_s=0.01, step_s=0.02,
                                        tokens_per_step=1.0)
        clock[0] += dt
        eng.step()

    for _ in range(OPS):
        op = int(rng.integers(0, 7))
        if op == 0 and len(eng.scheduler.pending) < 4:
            kind = int(rng.integers(0, 3))
            if kind == 0:            # the trie's case: a shared head
                prompt = shared + rng.integers(0, vocab, (
                    int(rng.integers(1, 9)),)).tolist()
            elif kind == 1:          # dedup's: a shared span after one page
                prompt = rng.integers(0, vocab, (8,)).tolist() + shared
            elif knobs:              # drafts hit: a repeated n-gram
                prompt = rng.integers(0, vocab, (3,)).tolist() * int(
                    rng.integers(2, 6))
            else:
                prompt = rng.integers(0, vocab, (
                    int(rng.integers(4, 20)),)).tolist()
            slo = [None, 60.0, 5000.0][int(rng.integers(0, 3))]
            eng.submit(prompt, int(rng.integers(1, 8)), slo_ms=slo)
        elif op == 1 and len(eng.scheduler.pending) < 4:
            conv = convs[int(rng.integers(0, len(convs)))]
            if not busy(conv):
                sess = eng.sessions.get(conv)
                if sess is not None and len(sess.history) > 28:
                    eng.end_session(conv)
                eng.submit_turn(conv, rng.integers(0, vocab, (
                    int(rng.integers(2, 7)),)).tolist(), 3)
        elif op == 2 and eng.scheduler.active:
            slots = sorted(eng.scheduler.active)
            eng.evict(slots[int(rng.integers(0, len(slots)))])
        elif op == 3:
            conv = convs[int(rng.integers(0, len(convs)))]
            if not busy(conv):
                eng.end_session(conv)
        elif op == 4:
            step(1.0)                    # tight-SLO pending work goes hopeless
        else:
            step(0.03)
        _assert_invariants(eng)
    while eng.scheduler.has_work:
        step(0.03)
        _assert_invariants(eng)
    for conv in convs:
        eng.end_session(conv)
    _assert_invariants(eng)
    assert all(len(r.generated) == r.max_new or r.shed_reason is not None
               for r in eng.scheduler.finished)
    return eng.stats_summary()


@pytest.mark.parametrize("seed", SEEDS)
def test_churn_conserves_every_serve_invariant(model, seed):
    st = _walk(model, seed)
    assert st["admissions"] > 0 and st["decode_steps"] > 0


def test_churn_walks_exercise_the_sharing_paths(model):
    """Over all seeds the walks hit the trie, copy-on-write, dedup,
    session snapshots, reclaim drops, evictions and shedding, so the
    invariants were checked where they can break."""
    totals = {}
    for seed in SEEDS:
        for key, v in _walk(model, seed).items():
            if isinstance(v, (int, float)):     # counters, not the knobs
                totals[key] = totals.get(key, 0) + v
    for key in ("prefix_hits", "pages_shared", "pages_cow", "session_hits",
                "session_snapshot_drops", "dedup_pages_shared", "evictions",
                "shed_requests", "prefix_evictions"):
        assert totals[key] > 0, key


SPEC_KNOBS = {"chain": dict(spec_k=3),
              "tree": dict(spec_k=3, spec_mode="tree", spec_tree_nodes=4,
                           spec_branch=2)}


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("mode", sorted(SPEC_KNOBS))
def test_spec_churn_conserves_every_serve_invariant(model, mode, seed):
    """The walk with speculative decode: chain steps roll pages back, tree
    steps leave an accepted path unwritten across evictions, sessions and
    the ladder's spec_off level."""
    st = _walk(model, seed, **SPEC_KNOBS[mode])
    assert st["spec_steps"] > 0
    assert st["spec_tree_steps"] == (0 if mode == "chain"
                                     else st["spec_steps"])


@pytest.mark.parametrize("mode", sorted(SPEC_KNOBS))
def test_spec_churn_walks_draft_and_roll_back(model, mode):
    """Over the speculative walks' seeds drafts were proposed, accepted and
    (chain) rolled back, so the invariants were checked there."""
    totals = {}
    for seed in SEEDS[:3]:
        for key, v in _walk(model, seed, **SPEC_KNOBS[mode]).items():
            if isinstance(v, (int, float)):
                totals[key] = totals.get(key, 0) + v
    assert totals["spec_drafted"] > 0 and totals["spec_accepted"] > 0
    if mode == "chain":
        assert totals["spec_pages_rolled_back"] > 0
