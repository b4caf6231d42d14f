"""The port's prefix cache and page dedup against the JAX package.

Host classes (``PagePool``, ``PrefixTrie``, ``PageDedupIndex``) run the op
sequences of the JAX package's own tests on both implementations and must
give the same return values and raise the same errors.  The engine runs
the reduced ``llama3.2-3b`` config (fp32, ``n_kv_heads=2``; 1 layer for the
dedup cases, where a page's bytes are a function of its tokens and
positions) with the weights carried across by ``params_from_numpy``, on the
same knobs and the same traffic as the JAX engine: greedy tokens must be
equal request for request, and so must every counter the two engines
share, the page tables and the refcounts (both pools are fp32, so byte
counters need no element-size factor).  The reduced MLA config
(``minicpm3-4b``, 1 layer) runs a prefix hit, a copy-on-write boundary
page and content dedup over its latent pools the same way."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.models import lm as jlm
from repro.models.common import init_params as jinit
from repro.serve import EngineConfig as JConfig
from repro.serve import ServeEngine as JEngine
from repro.serve import cache as jcache
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models.common import ParamSpec
from repro_torch.models.registry import get_api
from repro_torch.serve import EngineConfig, ServeEngine
from repro_torch.serve import cache as tcache

#: counters of ``stats_summary`` the port shares with the JAX engine
SHARED_COUNTERS = (
    "prefill_tokens", "decode_tokens", "decode_steps", "decode_lane_steps",
    "occupancy_sum", "admissions", "evictions", "preemptions",
    "prefix_hits", "prefix_misses", "prefix_reused_tokens",
    "prefix_evictions", "prefix_bytes_copied", "pages_shared", "pages_cow",
    "oom_deferred", "dedup_hits", "dedup_pages_shared",
    "dedup_hash_collisions", "session_turns", "session_hits",
    "session_reused_tokens", "session_snapshot_drops", "degrade_steps",
    "prefill_dispatches", "prefix_hit_rate", "tokens_per_step",
    "mean_occupancy", "trie_evictions", "pages_in_use", "pool_pages",
    "pool_bytes", "slo_met", "slo_missed", "shed_requests",
    "goodput_tokens", "degrade_level", "degrade_transitions",
    "dedup_hit_rate", "dedup_pages_per_hit", "dedup_indexed_pages",
    "sessions_live")


def _model(seed=0, arch="llama3.2-3b", **over):
    """(JAX config, port config, JAX params, port params) of the reduced
    fp32 ``arch``: llama with ``n_kv_heads=2``, MLA (``minicpm3-4b``) as
    ``reduced()`` makes it."""
    if arch == "llama3.2-3b":
        over = dict(over, n_kv_heads=2)
    jcfg = jget(arch).reduced(dtype=jnp.float32, **over)
    tcfg = tget(arch).reduced(dtype=torch.float32, **over)
    jp = jinit(jlm.param_specs(jcfg), jax.random.key(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           torch.float32)
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.fixture(scope="module")
def model1():
    """1 layer: layer-0 KV rows are a pure function of (token, position),
    so equal interior content at equal positions is byte-identical."""
    return _model(n_layers=1)


def _engines(model, **knobs):
    jcfg, tcfg, jp, tp = model
    jeng = JEngine(jcfg, jp, config=JConfig(spec_k=0, paged_kv=True,
                                            **knobs))
    teng = ServeEngine(tcfg, tp, config=EngineConfig(**knobs), device="cpu")
    return jeng, teng


def _conserved(eng):
    """Refcounts equal table + snapshot occurrences; scratch pinned; no
    dedup entry on a freed page."""
    counts = np.zeros(eng.pool.num_pages, np.int64)
    for p in eng.table.ravel():
        counts[int(p)] += 1
    for p in eng.sessions.snapshot_pages():
        counts[p] += 1
    assert (np.asarray(eng.pool.refcount[1:]) == counts[1:]).all()
    assert int(eng.pool.refcount[0]) == 1
    if eng.dedup is not None:
        assert all(int(eng.pool.refcount[p]) > 0 for p in eng.dedup.pages())


def assert_same(jeng, teng, jreqs, treqs):
    """Tokens, shared counters, page tables and refcounts equal."""
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    js, ts = jeng.stats_summary(), teng.stats_summary()
    for key in SHARED_COUNTERS:
        assert ts[key] == js[key], (key, ts[key], js[key])
    assert (teng.table == np.asarray(jeng.table)).all()
    assert (np.asarray(teng.pool.refcount)
            == np.asarray(jeng.pool.refcount)).all()
    _conserved(jeng)
    _conserved(teng)


def _both(model, drive, **knobs):
    """Run ``drive(eng)`` (returns its requests) on both engines."""
    jeng, teng = _engines(model, **knobs)
    jreqs, treqs = drive(jeng), drive(teng)
    assert_same(jeng, teng, jreqs, treqs)
    return jeng, teng, jreqs, treqs


def _toks(rng, vocab, n):
    return rng.integers(0, vocab, (n,)).tolist()


# ---------------------------------------------------------------------------
# host classes, op for op
# ---------------------------------------------------------------------------

def _norm(x):
    if isinstance(x, np.ndarray):
        return ("array", x.tolist())
    if isinstance(x, (np.integer, np.bool_)):
        return x.item()
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(v) for v in x)
    return x


def _trace(make, ops):
    """Apply ``ops`` (callables of the object) in turn; record each return
    value or the type and message of each error (only the type for the
    constructor's: the JAX pool's message also names its shard blocks)."""
    try:
        obj = make()
    except Exception as e:                  # noqa: BLE001 - compared below
        return [("raise", type(e).__name__)]
    out = []
    for op in ops:
        try:
            out.append(("ok", _norm(op(obj))))
        except Exception as e:              # noqa: BLE001 - compared below
            out.append(("raise", type(e).__name__, str(e)))
    return out


POOL_CASES = {
    # tests/test_paged.py:35-75
    "alloc_ref_deref": (4, [
        lambda p: p.free_count, lambda p: p.used_count, lambda p: p.alloc(),
        lambda p: p.alloc(), lambda p: p.used_count, lambda p: p.ref(1),
        lambda p: p.deref(1), lambda p: p.deref(1), lambda p: p.free_count,
        lambda p: p.alloc(), lambda p: p.refcount.tolist()]),
    "never_negative": (3, [
        lambda p: p.alloc(), lambda p: p.deref(1), lambda p: p.deref(1),
        lambda p: p.deref(0), lambda p: p.ref(0), lambda p: p.ref(2),
        lambda p: p.deref(7), lambda p: p.ref(-1)]),
    "exhaustion": (2, [
        lambda p: p.alloc(), lambda p: p.alloc(), lambda p: p.oom_events,
        lambda p: p.alloc_many(1), lambda p: p.oom_events,
        lambda p: p.allocs]),
    "scratch_only": (1, []),
    "vectorized": (6, [
        lambda p: p.alloc_many(3), lambda p: p.ref_many(np.array([1, 1, 3])),
        lambda p: p.refcount.tolist(),
        lambda p: p.ref_many(np.array([2, 4])),
        lambda p: p.ref_many(np.array([0])),
        lambda p: p.refcount.tolist(),
        lambda p: p.deref_many(np.array([1, 1, 3])),
        lambda p: p.deref_many(np.array([2, 2])),
        lambda p: p.refcount.tolist(), lambda p: p.deref_many([]),
        lambda p: p.deref_many(np.array([1, 2, 3])), lambda p: p.free_count,
        lambda p: p.alloc_many(5), lambda p: p.alloc_many(0),
        lambda p: p.alloc_many(6), lambda p: p.deref_many(np.array([0])),
        lambda p: p.allocs, lambda p: p.oom_events]),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_page_pool_matches_reference(case):
    n, ops = POOL_CASES[case]
    want = _trace(lambda: jcache.PagePool(n), ops)
    got = _trace(lambda: tcache.PagePool(n), ops)
    assert got == want


TRIE_CASES = {
    # tests/test_serve.py:414-436
    "insert_extend_match_remove": (None, [
        lambda t: t.longest_match([1, 2, 3]),
        lambda t: t.insert(0, [1, 2, 3, 4]), lambda t: t.insert(1, [1, 2, 9]),
        lambda t: t.longest_match([1, 2, 3, 4, 5]),
        lambda t: t.longest_match([1, 2, 9, 9]),
        lambda t: t.longest_match([1, 2]), lambda t: t.extend(1, 7),
        lambda t: t.tokens(1), lambda t: t.longest_match([1, 2, 9, 7]),
        lambda t: t.remove(0), lambda t: t.remove(0),
        lambda t: t.longest_match([1, 2, 3, 4]), lambda t: t.remove(1),
        lambda t: len(t), lambda t: t.longest_match([1]),
        lambda t: t.insert(2, [5]), lambda t: t.longest_match([5, 6]),
        lambda t: t.extend(9, 1), lambda t: t.length(2),
        lambda t: t.length(9), lambda t: t.tokens(9)]),
    # tests/test_paged.py:323-339
    "lru_capacity": (2, [
        lambda t: t.insert(0, [1, 2, 3]), lambda t: t.insert(1, [4, 5]),
        lambda t: t.longest_match([1, 2]), lambda t: t.insert(2, [6, 7]),
        lambda t: t.evictions, lambda t: t.tokens(1), lambda t: t.tokens(0),
        lambda t: t.longest_match([1, 2], touch=False),
        lambda t: t.insert(3, [8]), lambda t: t.tokens(0),
        lambda t: t.evictions, lambda t: t.lru_slots(),
        lambda t: t.longest_match([6, 7, 1], allowed=lambda s: s != 2),
        lambda t: t.insert(3, [6, 7, 7]),
        lambda t: t.longest_match([6, 7, 7], allowed=lambda s: s == 3),
        lambda t: t.lru_slots()]),
    "zero_capacity": (0, []),
}


@pytest.mark.parametrize("case", sorted(TRIE_CASES))
def test_prefix_trie_matches_reference(case):
    cap, ops = TRIE_CASES[case]
    want = _trace(lambda: jcache.PrefixTrie(capacity=cap), ops)
    got = _trace(lambda: tcache.PrefixTrie(capacity=cap), ops)
    assert got == want


DEDUP_CASES = {
    # tests/test_paged.py:559-577
    "lru_capacity_and_discard": (2, [
        lambda d: d.insert(1, b"a"), lambda d: d.insert(2, b"a"),
        lambda d: d.candidates(b"a"), lambda d: len(d),
        lambda d: d.insert(3, b"b"), lambda d: d.evictions,
        lambda d: len(d), lambda d: 3 in d.pages(), lambda d: d.discard(3),
        lambda d: d.discard(3), lambda d: d.candidates(b"b"),
        lambda d: d.insert(2, b"c"), lambda d: d.digest_of(2),
        lambda d: d.candidates(b"a"), lambda d: d.digest_of(9)]),
    "unbounded": (None, [
        lambda d: d.insert(5, b"x"), lambda d: d.insert(6, b"x"),
        lambda d: d.insert(7, b"y"),
        lambda d: d.discard_many(np.array([5, 7, 8])),
        lambda d: sorted(d.pages()), lambda d: d.candidates(b"x"),
        lambda d: d.evictions]),
    "zero_capacity": (0, []),
}


@pytest.mark.parametrize("case", sorted(DEDUP_CASES))
def test_dedup_index_matches_reference(case):
    cap, ops = DEDUP_CASES[case]
    want = _trace(lambda: jcache.PageDedupIndex(capacity=cap), ops)
    got = _trace(lambda: tcache.PageDedupIndex(capacity=cap), ops)
    assert got == want


def test_supports_prefix_and_config_gate(model):
    jcfg, tcfg, _, _ = model
    tspecs = get_api(tcfg).decode_state_specs(tcfg, 2, 32)
    jspecs = jlm.decode_state_specs(jcfg, 2, 32)
    assert tcache.supports_prefix(tspecs) == jcache.supports_prefix(jspecs)
    assert tcache.supports_prefix(tspecs)
    assert not tcache.supports_prefix({})
    ecfg = EngineConfig(max_seq=32).resolve(tcfg)
    assert ecfg.prefix_cache and ecfg.min_prefix == 8
    assert not EngineConfig(max_seq=32, prefix_cache=False).resolve(
        tcfg).prefix_cache
    for bad, msg in ((dict(trie_capacity=0), "trie_capacity must be >= 1"),
                     (dict(max_slots=0), "need at least one slot")):
        with pytest.raises(ValueError, match=msg):
            EngineConfig(**bad).validate()
        with pytest.raises(ValueError, match=msg):
            JConfig(**bad).validate()


def test_copy_page_and_page_bytes_on_cpu():
    """copy_page moves one page in every leaf and nothing else; page_bytes
    reads a strided page as raw bytes, bf16 included, telling -0.0 from
    +0.0."""
    specs = {name: ParamSpec((3, 2, 8, 2, 4),
                             ("layers", "batch", "kv_seq", None, None),
                             dtype=torch.bfloat16)
             for name in ("k", "v")}
    pspecs = tcache.paged_state_specs(specs, 4, 5)
    gen = torch.Generator().manual_seed(0)
    state = {k: torch.randn(s.shape, generator=gen).to(s.dtype)
             for k, s in pspecs.items()}
    before = {k: v.clone() for k, v in state.items()}
    tcache.copy_page(state, pspecs, 2, 4)
    for k in state:
        assert torch.equal(state[k][:, 4], before[k][:, 2])
        assert torch.equal(state[k][:, :4], before[k][:, :4])
    views = tcache.page_bytes(state, pspecs, 4)
    assert [v.dtype for v in views] == [torch.uint8] * 2
    assert all(v.numel() == 3 * 4 * 2 * 4 * 2 for v in views)
    assert all(torch.equal(a, b) for a, b in
               zip(views, tcache.page_bytes(state, pspecs, 2)))
    state["k"][:, 1] = 0.0
    state["k"][:, 3] = -0.0
    assert torch.equal(state["k"][:, 1], state["k"][:, 3])
    assert not torch.equal(tcache.page_bytes(state, pspecs, 1)[0],
                           tcache.page_bytes(state, pspecs, 3)[0])


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def test_prefix_hit_shares_pages_and_matches_reference(model):
    """A page-aligned shared prefix: hits share full pages by reference,
    no byte is copied, and the tokens equal a cold engine's."""
    vocab = model[0].vocab
    rng = np.random.default_rng(22)
    system = _toks(rng, vocab, 16)
    prompts = [system + _toks(rng, vocab, 4) for _ in range(3)]

    def drive(eng):
        reqs = [eng.submit(p, 4) for p in prompts]
        eng.run()
        return reqs

    knobs = dict(max_slots=2, max_seq=48, prefill_chunk=8, page_size=16)
    _, teng, _, treqs = _both(model, drive, **knobs)
    st = teng.stats_summary()
    assert st["prefix_hits"] >= 2 and st["pages_shared"] >= 1
    assert st["pages_cow"] == 0 and st["prefix_bytes_copied"] == 0
    _, cold, _, creqs = _both(model, drive, prefix_cache=False, **knobs)
    assert [r.generated for r in treqs] == [r.generated for r in creqs]
    assert cold.prefix is None and cold.stats["prefix_hits"] == 0


def test_prefix_reuse_after_retire_same_slot(model):
    """Recently-retired reuse on one slot (the in-place path) and an
    unrelated prompt that overwrites the row (a prefix eviction)."""
    vocab = model[0].vocab
    rng = np.random.default_rng(9)
    base = _toks(rng, vocab, 10)
    tail = _toks(rng, vocab, 3)
    other = _toks(rng, vocab, 9)

    def drive(eng):
        reqs = []
        for p in (base, base + tail, other):
            reqs.append(eng.submit(p, 3))
            eng.run()
        return reqs

    _, teng, _, _ = _both(model, drive, max_slots=1, max_seq=32,
                          prefill_chunk=8)
    st = teng.stats_summary()
    assert st["prefix_hits"] == 1 and st["prefix_reused_tokens"] >= 10
    assert st["prefix_evictions"] == 1
    assert teng.prefix.longest_match(base)[0] < 8


def test_cow_isolates_boundary_page(model):
    """A sharer writes into its own copy of the boundary page: the live
    source keeps decoding into the original."""
    vocab = model[0].vocab
    rng = np.random.default_rng(23)
    system = _toks(rng, vocab, 12)
    tail_a, tail_b = _toks(rng, vocab, 4), _toks(rng, vocab, 4)

    def drive(eng):
        r1 = eng.submit(system, 20)
        eng.step()
        eng.step()
        r2 = eng.submit(system + tail_a, 6)
        while not r2.done:
            eng.step()
        r3 = eng.submit(system + tail_b, 6)
        eng.run()
        return [r1, r2, r3]

    knobs = dict(max_slots=2, max_seq=48, prefill_chunk=8, page_size=16)
    _, teng, _, treqs = _both(model, drive, **knobs)
    assert teng.stats["pages_cow"] == 2 and teng.stats["pages_shared"] == 0
    assert teng.stats["prefix_bytes_copied"] == 2 * teng.page_bytes
    cold = ServeEngine(model[1], model[3], config=EngineConfig(
        prefix_cache=False, **knobs), device="cpu")
    creqs = [cold.submit(list(r.prompt), r.max_new) for r in treqs]
    cold.run()
    assert [r.generated for r in creqs] == [r.generated for r in treqs]


def test_evicting_source_slot_preserves_sharer(model):
    vocab = model[0].vocab
    rng = np.random.default_rng(24)
    system = _toks(rng, vocab, 20)
    tail, other = _toks(rng, vocab, 4), _toks(rng, vocab, 9)
    seen = []

    def drive(eng):
        r1 = eng.submit(system, 10)
        eng.step()
        eng.step()
        page = int(eng.table[0, 0])
        r2 = eng.submit(system + tail, 16)
        eng.step()
        rc = [int(eng.pool.refcount[page])]
        while not r1.done:
            eng.step()
        rc.append(int(eng.pool.refcount[page]))
        r3 = eng.submit(other, 2)
        eng.step()
        rc.append(int(eng.pool.refcount[page]))
        eng.run()
        seen.append(rc)
        return [r1, r2, r3]

    _both(model, drive, max_slots=2, max_seq=48, prefill_chunk=8,
          page_size=16)
    assert seen[0] == seen[1] == [2, 2, 1]


def test_oom_admissions_deferred_not_dropped(model):
    vocab = model[0].vocab
    rng = np.random.default_rng(26)
    prompts = [_toks(rng, vocab, 18) for _ in range(2)]

    def drive(eng):
        reqs = [eng.submit(p, 4) for p in prompts]
        eng.run(max_steps=200)
        return reqs

    for prefix_cache in (True, False):
        _, teng, _, treqs = _both(model, drive, max_slots=2, max_seq=32,
                                  prefill_chunk=8, pool_pages=2,
                                  prefix_cache=prefix_cache)
        assert all(len(r.generated) == 4 for r in treqs)
        assert teng.stats["oom_deferred"] >= 1


def test_trie_capacity_reports_evictions(model):
    vocab = model[0].vocab
    rng = np.random.default_rng(27)
    prompts = [_toks(rng, vocab, 10) for _ in range(3)]

    def drive(eng):
        reqs = [eng.submit(p, 2) for p in prompts]
        eng.run()
        return reqs

    _, teng, _, _ = _both(model, drive, max_slots=3, max_seq=32,
                          prefill_chunk=8, trie_capacity=1)
    assert teng.stats_summary()["trie_evictions"] >= 2
    assert len(teng.prefix) <= 1


def test_live_slot_trie_eviction_strands_no_pages(model):
    vocab = model[0].vocab
    rng = np.random.default_rng(28)
    p1, p2 = _toks(rng, vocab, 18), _toks(rng, vocab, 18)
    seen = []

    def drive(eng):
        r1 = eng.submit(p1, 12)
        eng.step()
        eng.step()
        r2 = eng.submit(p2, 2)
        eng.step()
        seen.append((eng.prefix.length(0), 0 in eng.scheduler.active,
                     int(eng.table[0, 0]) > 0))
        eng.run()
        seen.append((bool(eng.table[0].any()), eng.prefix.length(1)))
        return [r1, r2]

    _both(model, drive, max_slots=2, max_seq=32, prefill_chunk=8,
          trie_capacity=1)
    assert seen[0] == seen[2] == (None, True, True)
    assert seen[1] == seen[3] and seen[3][0] is False


def _dedup_prompts(vocab, rng, n=3, head=16, span=32):
    """``n`` prompts: a page of unique tokens (distinct first token: the
    trie matches nothing across them), then one shared ``span``."""
    shared = _toks(rng, vocab, span)
    prompts = []
    for i in range(n):
        h = _toks(rng, vocab, head)
        h[0] = i
        prompts.append(h + shared)
    return prompts


DEDUP_KNOBS = dict(max_slots=2, max_seq=64, prefill_chunk=16, page_size=16,
                   pool_pages=24)


def test_dedup_interior_span_shared_and_exact(model1):
    rng = np.random.default_rng(41)
    prompts = _dedup_prompts(model1[0].vocab, rng)

    def drive(eng):
        reqs = [eng.submit(p, 4) for p in prompts]
        eng.run()
        return reqs

    _, off, _, offreqs = _both(model1, drive, **DEDUP_KNOBS)
    _, on, _, onreqs = _both(model1, drive, page_dedup=True, **DEDUP_KNOBS)
    assert [r.generated for r in onreqs] == [r.generated for r in offreqs]
    st = on.stats_summary()
    assert st["prefix_hits"] == 0
    assert st["dedup_hits"] >= len(prompts) - 1
    assert st["dedup_hash_collisions"] == 0
    assert on.pool.used_count < off.pool.used_count
    for p in on.dedup.pages():
        assert on._digest_fn(on._page_bytes_of(p)) == on.dedup.digest_of(p)


def test_dedup_forced_collision_falls_back_to_byte_compare(model1):
    """A constant digest makes every page a candidate of every other: the
    byte compare refutes the false ones, counts them, and still shares the
    true twins."""
    rng = np.random.default_rng(43)
    prompts = _dedup_prompts(model1[0].vocab, rng)

    def drive(eng):
        eng._digest_fn = lambda b: b"\x00" * 16
        reqs = [eng.submit(p, 4) for p in prompts]
        eng.run()
        return reqs

    _, teng, _, treqs = _both(model1, drive, page_dedup=True, **DEDUP_KNOBS)
    st = teng.stats_summary()
    assert st["dedup_hash_collisions"] > 0
    assert st["dedup_hits"] >= len(prompts) - 1
    cold = ServeEngine(model1[1], model1[3], config=EngineConfig(
        **DEDUP_KNOBS), device="cpu")
    creqs = [cold.submit(p, 4) for p in prompts]
    cold.run()
    assert [r.generated for r in creqs] == [r.generated for r in treqs]


def test_in_place_readmission_detaches_shared_pages(model1):
    """Re-admission through a retired slot's own row whose overwrite span
    crosses dedup-shared pages: they are detached (boundary copy-on-write,
    rewritten pages fresh) and the sharer's bytes stay intact."""
    vocab = model1[0].vocab
    rng = np.random.default_rng(44)
    prompts = _dedup_prompts(vocab, rng, n=2)
    follow = prompts[0][:24] + _toks(rng, vocab, 12)

    def drive(eng):
        reqs = [eng.submit(p, 4) for p in prompts]
        eng.run()
        assert eng.stats["dedup_hits"] >= 1
        reqs.append(eng.submit(follow, 4))
        eng.run()
        return reqs

    _, teng, _, treqs = _both(model1, drive, page_dedup=True, **DEDUP_KNOBS)
    assert teng.stats["pages_cow"] >= 1
    cold = ServeEngine(model1[1], model1[3], config=EngineConfig(
        prefix_cache=False, **DEDUP_KNOBS), device="cpu")
    c3 = cold.submit(list(follow), 4)
    cold.run()
    assert treqs[-1].generated == c3.generated


# ---------------------------------------------------------------------------
# MLA: the latent ckv / kr pools
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla_model1():
    return _model(arch="minicpm3-4b", n_layers=1)


def test_mla_prefix_hit_and_copy_on_write_match_jax(mla_model1):
    """A live source's 12-token prefix shared by two followers: each copies
    the boundary page (both latent leaves) and writes its own rows; a
    page-aligned 16-token prefix is then shared by reference.  Tokens equal
    a cold engine's where the prefill cut is the same."""
    vocab = mla_model1[0].vocab
    rng = np.random.default_rng(23)
    system = _toks(rng, vocab, 12)
    tail_a, tail_b = _toks(rng, vocab, 4), _toks(rng, vocab, 4)
    aligned = _toks(rng, vocab, 16)

    def drive(eng):
        r1 = eng.submit(system, 20)
        eng.step()
        eng.step()
        r2 = eng.submit(system + tail_a, 6)
        while not r2.done:
            eng.step()
        r3 = eng.submit(system + tail_b, 6)
        eng.run()
        r4 = eng.submit(aligned + tail_a, 4)
        r5 = eng.submit(aligned + tail_b, 4)
        r6 = eng.submit(aligned + tail_a[:2], 4)
        eng.run()
        return [r1, r2, r3, r4, r5, r6]

    knobs = dict(max_slots=2, max_seq=48, prefill_chunk=8, page_size=16)
    _, teng, _, treqs = _both(mla_model1, drive, **knobs)
    st = teng.stats_summary()
    assert st["pages_cow"] >= 2 and st["pages_shared"] >= 1
    assert st["prefix_bytes_copied"] == st["pages_cow"] * teng.page_bytes
    assert sorted(teng.state) == ["ckv", "kr"]
    cold = ServeEngine(mla_model1[1], mla_model1[3], config=EngineConfig(
        prefix_cache=False, **knobs), device="cpu")
    c1 = cold.submit(system, 20)
    cold.run()
    assert c1.generated == treqs[0].generated


def test_mla_dedup_interior_span_shared_and_exact(mla_model1):
    rng = np.random.default_rng(41)
    prompts = _dedup_prompts(mla_model1[0].vocab, rng)

    def drive(eng):
        reqs = [eng.submit(p, 4) for p in prompts]
        eng.run()
        return reqs

    _, off, _, offreqs = _both(mla_model1, drive, **DEDUP_KNOBS)
    _, on, _, onreqs = _both(mla_model1, drive, page_dedup=True,
                             **DEDUP_KNOBS)
    assert [r.generated for r in onreqs] == [r.generated for r in offreqs]
    st = on.stats_summary()
    assert st["prefix_hits"] == 0 and st["dedup_hash_collisions"] == 0
    assert st["dedup_hits"] >= len(prompts) - 1
    assert on.pool.used_count < off.pool.used_count
