"""The port's threefry PRNG and token sampling against JAX.

The integer part is exact: ``prng.threefry_2x32`` against
``jax._src.prng``'s cipher on seeded key and counter words (edge words 0
and 0xFFFFFFFF among them), the keys of ``PRNGKey`` / ``fold_in``, and the
bits and uniforms of ``jax.random.bits`` / ``jax.random.uniform(minval =
tiny)`` over a vocabulary that is not a power of two, one key per row of a
batch.  The Gumbel noise is torch's ``log`` of those uniforms: within
2e-6 of ``jax.random.gumbel`` (the largest gap measured over 2M draws was
9.5e-7).  ``sample_tokens`` must give the JAX package's tokens on a seeded
grid of temperatures, top-k, top-p, seeds and sample indices.

The engine samples in lockstep with the JAX engine on the reduced
``llama3.2-3b`` config (fp32, ``n_kv_heads=2``, 1 layer): sequential,
chain, tree and auto, over fp32 and int8 pages, with tokens, every shared
counter, page tables and refcounts equal; sampled speculative streams
equal the sampled sequential ones; a stream repeats across engine
restarts and survives preemption and re-admission.  The reduced MLA
config (``minicpm3-4b``, 1 layer) samples in the same lockstep."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from repro.serve import EngineConfig as JConfig
from repro.serve import SamplingParams as JSampling
from repro.serve import ServeEngine as JEngine
from repro.serve import sampling as jsampling
from repro_torch.serve import EngineConfig, SamplingParams, ServeEngine
from repro_torch.serve import prng
from repro_torch.serve import sampling as tsampling
from test_torch_prefix import SHARED_COUNTERS, _conserved, _model
from test_torch_spec_engine import GEOMETRY, MODES, SPEC_KEYS, _prompts

TINY = float(np.finfo(np.float32).tiny)

#: a vocabulary that is not a power of two (nor even)
VOCAB = 4099

#: stats keys both engines report for the KV pool
KV_KEYS = ("kv_dtype", "kv_bytes_per_slot", "pool_bytes")


def _words(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def _jkeys(seeds, idxs):
    return [jax.random.fold_in(jax.random.PRNGKey(s), i)
            for s, i in zip(seeds, idxs)]


# ---------------------------------------------------------------------------
# the PRNG, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_threefry_2x32_matches_jax(seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 2 ** 32, (2, 64), dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2 ** 32, (2, 64), dtype=np.uint64).astype(np.uint32)
    k[:, :4] = [[0, 0, 0xFFFFFFFF, 0xFFFFFFFF], [0, 0xFFFFFFFF, 0,
                                                  0xFFFFFFFF]]
    x[:, 4:8] = [[0, 0xFFFFFFFF, 0, 0xFFFFFFFF], [0, 0, 0xFFFFFFFF,
                                                  0xFFFFFFFF]]
    want = jprng.threefry2x32_p.bind(*(jnp.asarray(a) for a in
                                       (k[0], k[1], x[0], x[1])))
    got = prng.threefry_2x32(*(_words(a) for a in (k[0], k[1], x[0], x[1])))
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.int64))


SEEDS = [0, 7, 123456, -5, 2 ** 31 - 1, -2 ** 31]
IDXS = [0, 1, 3, 1000, 2 ** 31 - 1]


def test_prng_key_and_fold_in_match_jax():
    pairs = list(itertools.product(SEEDS, IDXS))
    seeds = torch.tensor([s for s, _ in pairs])
    idxs = torch.tensor([i for _, i in pairs])
    base = prng.prng_key(seeds)
    k1, k2 = prng.fold_in(base, idxs)
    for r, (s, i) in enumerate(pairs):
        want_base = np.asarray(jax.random.PRNGKey(s), np.int64)
        assert [int(base[0][r]), int(base[1][r])] == want_base.tolist()
        want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(s), i),
                          np.int64)
        assert [int(k1[r]), int(k2[r])] == want.tolist(), (s, i)


def test_random_bits_and_uniform_match_jax_per_row():
    """One (R, V) pass with one key a row equals R separate JAX draws."""
    pairs = list(itertools.product(SEEDS, IDXS))
    key = prng.fold_in(prng.prng_key(torch.tensor([s for s, _ in pairs])),
                       torch.tensor([i for _, i in pairs]))
    bits = prng.random_bits(key, VOCAB)
    uni = prng.uniform(key, VOCAB, TINY)
    assert bits.shape == uni.shape == (len(pairs), VOCAB)
    assert uni.dtype == torch.float32
    for r, jk in enumerate(_jkeys(*zip(*pairs))):
        want_bits = np.asarray(jax.random.bits(jk, (VOCAB,), jnp.uint32))
        np.testing.assert_array_equal(bits[r].numpy(),
                                      want_bits.astype(np.int64))
        want_u = np.asarray(jax.random.uniform(jk, (VOCAB,), jnp.float32,
                                               minval=TINY))
        np.testing.assert_array_equal(uni[r].numpy().view(np.int32),
                                      want_u.view(np.int32))
    plain = prng.uniform(key, VOCAB)
    jk = _jkeys([SEEDS[0]], [IDXS[0]])[0]
    np.testing.assert_array_equal(
        plain[0].numpy(), np.asarray(jax.random.uniform(jk, (VOCAB,))))


def test_gumbel_within_two_ulps_of_jax():
    """torch's log is not XLA's: the noise agrees within 2e-6 (9.5e-7 was
    the largest gap over 2M draws); the uniforms under it are exact."""
    seeds = torch.arange(16)
    key = prng.fold_in(prng.prng_key(seeds), seeds * 3)
    got = prng.gumbel(key, VOCAB).numpy()
    for r, jk in enumerate(_jkeys(range(16), [3 * s for s in range(16)])):
        want = np.asarray(jax.random.gumbel(jk, (VOCAB,), jnp.float32))
        np.testing.assert_allclose(got[r], want, rtol=0, atol=2e-6)


def test_categorical_matches_jax():
    rng = np.random.default_rng(5)
    logits = (2.0 * rng.standard_normal((24, VOCAB))).astype(np.float32)
    key = prng.fold_in(prng.prng_key(torch.arange(24)), torch.arange(24))
    got = prng.categorical(key, torch.from_numpy(logits)).numpy()
    want = [int(jax.random.categorical(jk, jnp.asarray(logits[r])))
            for r, jk in enumerate(_jkeys(range(24), range(24)))]
    assert got.tolist() == want


# ---------------------------------------------------------------------------
# sample_tokens
# ---------------------------------------------------------------------------

GRID = list(itertools.product((0.0, 0.5, 0.8, 1.5), (0, 1, 40),
                              (0.05, 0.9, 1.0), (0, 7, 123456), (0, 5, 77)))


def _lanes_np(grid):
    t, k, p, s, i = (np.array(c) for c in zip(*grid))
    return (t.astype(np.float32), k.astype(np.int64), p.astype(np.float32),
            s.astype(np.int64), i.astype(np.int64))


@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_sample_tokens_match_jax_on_the_grid(scale):
    """324 rows, one per grid point; logits of two spreads (flat and
    peaked distributions reach different nucleus sizes)."""
    rng = np.random.default_rng(int(scale))
    logits = (scale * rng.standard_normal((len(GRID), VOCAB))
              ).astype(np.float32)
    t, k, p, s, i = _lanes_np(GRID)
    want = jsampling.sample_tokens(
        jnp.asarray(logits), jnp.asarray(t), jnp.asarray(k, jnp.int32),
        jnp.asarray(p), jnp.asarray(s, jnp.int32), jnp.asarray(i, jnp.int32))
    got = tsampling.sample_tokens(torch.from_numpy(logits),
                                  *(torch.from_numpy(a) for a in
                                    (t, k, p, s, i)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    greedy = logits.argmax(-1)
    np.testing.assert_array_equal(got.numpy()[t == 0], greedy[t == 0])
    np.testing.assert_array_equal(got.numpy()[k == 1], greedy[k == 1])


def test_sample_tokens_on_engine_shaped_lanes_match_jax():
    """The lanes as the engine packs them (``sampling_lanes``), with tied
    logits (a small integer range): the stable sort keeps JAX's order."""
    rng = np.random.default_rng(11)
    logits = rng.integers(-3, 4, (6, 300)).astype(np.float32)
    sps = [SamplingParams(), SamplingParams(0.8, 40, 1.0, 7),
           SamplingParams(1.0, 0, 0.9, 3), SamplingParams(0.5, 5, 0.5, 9),
           SamplingParams(2.0, 0, 1.0, 1), SamplingParams(0.8, 2, 1.0, 7)]
    idxs = [0, 3, 8, 1, 2, 3]
    lanes = tsampling.sampling_lanes(sps, idxs)
    assert [a.dtype for a in lanes] == [torch.float32, torch.int64,
                                        torch.float32, torch.int64,
                                        torch.int64]
    jlanes = jsampling.sampling_lanes(
        [JSampling(p.temperature, p.top_k, p.top_p, p.seed) for p in sps],
        idxs)
    want = jsampling.sample_tokens(jnp.asarray(logits), *jlanes)
    got = tsampling.sample_tokens(torch.from_numpy(logits), *lanes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bad", [dict(temperature=-0.1), dict(top_k=-1),
                                 dict(top_p=1.5), dict(top_p=-0.1)],
                         ids=lambda d: next(iter(d)))
def test_sampling_params_validation_matches_jax(bad):
    msgs = []
    for cls in (SamplingParams, JSampling):
        with pytest.raises(ValueError) as e:
            cls(**bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_sampling_params_accept_temperature():
    sp = SamplingParams(temperature=0.8, top_k=40, top_p=0.9, seed=7)
    assert not sp.is_greedy and SamplingParams().is_greedy
    assert hash(sp) == hash(SamplingParams(0.8, 40, 0.9, 7))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

#: bench_serve's stochastic pair, plus a nucleus
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.9)


@pytest.fixture(scope="module")
def model():
    return _model(n_layers=1)


def lockstep(model, prompts, gens, sampling=None, **knobs):
    """Serve ``prompts`` on the JAX and the port engine step by step, each
    request with ``sampling[i]`` (None: greedy); after every step the
    tables and refcounts are equal.  Returns (jax engine, port engine, jax
    requests, port requests)."""
    jcfg, tcfg, jp, tp = model
    sampling = sampling or [None] * len(prompts)
    jeng = JEngine(jcfg, jp, config=JConfig(paged_kv=True, **knobs))
    teng = ServeEngine(tcfg, tp, config=EngineConfig(**knobs), device="cpu")
    jreqs = [jeng.submit(p, g, sampling=None if sp is None else JSampling(
        sp.temperature, sp.top_k, sp.top_p, sp.seed))
        for p, g, sp in zip(prompts, gens, sampling)]
    treqs = [teng.submit(p, g, sampling=sp)
             for p, g, sp in zip(prompts, gens, sampling)]
    while jeng.scheduler.has_work or teng.scheduler.has_work:
        jeng.step()
        teng.step()
        assert (teng.table == np.asarray(jeng.table)).all()
        assert (np.asarray(teng.pool.refcount)
                == np.asarray(jeng.pool.refcount)).all()
        _conserved(teng)
    return jeng, teng, jreqs, treqs


def assert_same(jeng, teng, jreqs, treqs):
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    js, ts = jeng.stats_summary(), teng.stats_summary()
    for key in SHARED_COUNTERS + SPEC_KEYS + KV_KEYS:
        assert ts[key] == js[key], (key, ts[key], js[key])


def _sampled(n, **over):
    return [SamplingParams(seed=i, **dict(SAMPLED, **over))
            for i in range(n)]


def _sequential(model, prompts, gens, sampling, **knobs):
    _, tcfg, _, tp = model
    eng = ServeEngine(tcfg, tp, config=EngineConfig(**GEOMETRY, **knobs),
                      device="cpu")
    reqs = [eng.submit(p, g, sampling=sp)
            for p, g, sp in zip(prompts, gens, sampling)]
    eng.run()
    return [r.generated for r in reqs]


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("mode", ["sequential", "chain", "tree", "auto"])
def test_sampled_engine_matches_jax(model, mode, kv_dtype):
    """Each request samples with its own seed; one greedy request rides
    in the same dispatches.  Speculative streams equal the sequential
    one: every row draws at the sequential index it stands for."""
    prompts, gens = _prompts(model[0].vocab)
    sampling = _sampled(len(prompts))
    sampling[1] = None
    knobs = dict(GEOMETRY, kv_dtype=kv_dtype, **MODES.get(mode, {}))
    jeng, teng, jreqs, treqs = lockstep(model, prompts, gens, sampling,
                                        **knobs)
    assert_same(jeng, teng, jreqs, treqs)
    assert all(len(r.generated) == g for r, g in zip(treqs, gens))
    seq = _sequential(model, prompts, gens, sampling, kv_dtype=kv_dtype)
    assert [r.generated for r in treqs] == seq
    # a sampled stream is not the argmax stream
    greedy = _sequential(model, prompts, gens, [None] * len(prompts),
                         kv_dtype=kv_dtype)
    assert seq[1] == greedy[1] and seq != greedy


@pytest.fixture(scope="module")
def mla_model():
    return _model(arch="minicpm3-4b", n_layers=1)


@pytest.mark.parametrize("mode,kv_dtype", [("sequential", "fp32"),
                                           ("chain", "fp32"),
                                           ("tree", "int8")])
def test_mla_sampled_engine_matches_jax(mla_model, mode, kv_dtype):
    prompts, gens = _prompts(mla_model[0].vocab)
    sampling = _sampled(len(prompts))
    sampling[1] = None
    knobs = dict(GEOMETRY, kv_dtype=kv_dtype, **MODES.get(mode, {}))
    jeng, teng, jreqs, treqs = lockstep(mla_model, prompts, gens, sampling,
                                        **knobs)
    assert_same(jeng, teng, jreqs, treqs)
    assert all(len(r.generated) == g for r, g in zip(treqs, gens))
    assert [r.generated for r in treqs] == _sequential(
        mla_model, prompts, gens, sampling, kv_dtype=kv_dtype)


@pytest.mark.parametrize("mode", ["chain", "tree"])
def test_low_temperature_spec_accepts_and_matches_jax(model, mode):
    """Near-greedy sampling (temperature 0.05, top-k 2): the streams fall
    into the loops prompt lookup drafts, so drafts are accepted, and the
    accept counters still equal the JAX engine's."""
    prompts, gens = _prompts(model[0].vocab)
    sampling = _sampled(len(prompts), temperature=0.05, top_k=2, top_p=1.0)
    jeng, teng, jreqs, treqs = lockstep(model, prompts, gens, sampling,
                                        **GEOMETRY, **MODES[mode])
    assert_same(jeng, teng, jreqs, treqs)
    assert teng.stats["spec_accepted"] > 0
    assert [r.generated for r in treqs] == _sequential(model, prompts, gens,
                                                       sampling)


def _run_one(model, prompt, gen, sp, **knobs):
    _, tcfg, _, tp = model
    eng = ServeEngine(tcfg, tp, config=EngineConfig(
        max_slots=2, max_seq=32, prefill_chunk=8, **knobs), device="cpu")
    req = eng.submit(prompt, gen, sampling=sp)
    eng.run()
    return req.generated


def test_sampled_tokens_identical_across_engine_restarts(model):
    """The stream is a function of (seed, index): a rebuilt engine repeats
    it, another seed changes it, and an explicit greedy policy equals
    ``sampling=None``."""
    prompt = np.random.default_rng(4).integers(0, model[0].vocab,
                                               (7,)).tolist()
    sp = SamplingParams(temperature=0.8, top_k=20, top_p=0.95, seed=123)
    first = _run_one(model, prompt, 8, sp)
    assert _run_one(model, prompt, 8, sp) == first
    assert _run_one(model, prompt, 8, SamplingParams(
        temperature=0.8, top_k=20, top_p=0.95, seed=124)) != first
    assert _run_one(model, prompt, 6, SamplingParams()) == \
        _run_one(model, prompt, 6, None)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_sampled_stream_survives_preemption(model, kv_dtype):
    """Eviction and re-admission re-prefill the generated tokens without
    resampling them; the continuation draws at the same indices, so the
    stream equals an uninterrupted run's, and the JAX engine's under the
    same eviction."""
    jcfg, tcfg, jp, tp = model
    prompt = np.random.default_rng(6).integers(0, jcfg.vocab,
                                               (6,)).tolist()
    sp = SamplingParams(temperature=0.9, seed=77)
    knobs = dict(max_slots=1, max_seq=32, prefill_chunk=8,
                 kv_dtype=kv_dtype)
    out = []
    for eng in (ServeEngine(tcfg, tp, config=EngineConfig(**knobs),
                            device="cpu"),
                JEngine(jcfg, jp, config=JConfig(paged_kv=True, **knobs))):
        req = eng.submit(prompt, 6, sampling=sp if isinstance(
            eng, ServeEngine) else JSampling(0.9, 0, 1.0, 77))
        eng.step()
        eng.step()
        before = list(req.generated)
        eng.evict(0)
        eng.run()
        assert req.generated[:len(before)] == before
        out.append(req.generated)
    assert out[0] == out[1]
    assert out[0] == _run_one(model, prompt, 6, sp, kv_dtype=kv_dtype)
