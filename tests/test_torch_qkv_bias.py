"""The QKV-bias archs ``glm4-9b`` and ``qwen2.5-14b`` in the port against the
JAX package.

Both archs differ from llama only by the bias added to the q, k and v
projections.  Their params come from ``init="zeros"``, so the JAX
package's own ``init_params`` would hide a dropped or misplaced bias: here
``bq``, ``bk`` and ``bv`` are set to seeded N(0, 0.5) values in the JAX
numpy params before ``params_from_numpy``.  Reduced fp32 configs at the
archs' GQA groups: glm4 with 32 query heads over 2 KV heads (group 16),
qwen with 20 over 4 (group 5).  Param specs are equal; ``forward`` logits
agree within 1e-5, ``train_loss`` within 1e-6 and its gradients (the
biases' included) within 1e-5 of ``jax.value_and_grad``; the paged and
contiguous ``prefill_chunk`` / ``decode_step`` logits and states within
1e-4.  On 1-layer glm4 the port's engine runs in lockstep with the JAX
engine (sequential, prefix-warm, chain ``spec_k=3``): tokens, shared
counters, page tables and refcounts equal.  A guard case shows that
zeroing the biases moves the logits by far more than the tolerance."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.models import lm as jlm
from repro.models.common import ParamSpec as JSpec
from repro.models.common import init_params as jinit
from repro.serve import EngineConfig as JConfig
from repro.serve import ServeEngine as JEngine
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import lm as tlm
from repro_torch.optim.grad_accum import value_and_grad
from repro_torch.serve import EngineConfig, ServeEngine
from test_torch_prefix import assert_same

#: the reduced heads of each arch: its published GQA group, narrow
HEADS = {"glm4-9b": dict(n_heads=32, n_kv_heads=2),
         "qwen2.5-14b": dict(n_heads=20, n_kv_heads=4)}
BIASES = ("bq", "bk", "bv")
B, S = 2, 24
PAGE, NUM_PAGES, SMAX = 16, 10, 32


@functools.cache
def _biased(arch, n_layers=2, seed=0):
    """(JAX config, port config, JAX params, port params) of the reduced
    fp32 ``arch`` with nonzero biases drawn from ``seed``."""
    over = dict(HEADS[arch], n_layers=n_layers)
    jcfg = jget(arch).reduced(dtype=jnp.float32, **over)
    tcfg = tget(arch).reduced(dtype=torch.float32, **over)
    assert jcfg.qkv_bias and tcfg.qkv_bias
    jp = jax.tree.map(np.asarray, jinit(jlm.param_specs(jcfg),
                                        jax.random.key(seed)))
    rng = np.random.default_rng(seed + 100)
    attn = jp["blocks"]["attn"]
    for k in BIASES:
        attn[k] = (0.5 * rng.standard_normal(attn[k].shape)
                   ).astype(np.float32)
    tp = params_from_numpy(jp, "cpu", torch.float32)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), tp


@pytest.fixture(scope="module", params=sorted(HEADS))
def model(request):
    return _biased(request.param)


@pytest.fixture(scope="module")
def glm1():
    return _biased("glm4-9b", n_layers=1, seed=3)


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _t(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _get(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("arch", sorted(HEADS))
def test_param_specs_match_jax(arch):
    jcfg, tcfg = (get(arch).reduced(**HEADS[arch]) for get in (jget, tget))
    jflat = jax.tree_util.tree_flatten_with_path(
        jlm.param_specs(jcfg), is_leaf=lambda x: isinstance(x, JSpec))[0]
    tspecs = tlm.param_specs(tcfg)
    assert {p[-1].key for p, _ in jflat if p[0].key == "blocks"} >= \
        set(BIASES)
    for path, js in jflat:
        ts = _get(tspecs, path)
        assert (tuple(ts.shape), tuple(ts.axes), ts.init) == \
            (tuple(js.shape), tuple(js.axes), js.init), path


def test_forward_and_loss_match_jax(model):
    jcfg, tcfg, jp, tp = model
    batch = _batch(jcfg.vocab)
    jlogits, _ = jlm.forward(jp, _j(batch), jcfg)
    with torch.no_grad():
        tlogits, _ = tlm.forward(tp, _t(batch), tcfg)
    _close(tlogits, jlogits, 1e-5)
    jloss, jgrads = jax.value_and_grad(jlm.train_loss)(jp, _j(batch), jcfg)
    tloss, tgrads = value_and_grad(
        lambda p, b: tlm.train_loss(p, b, tcfg))(tp, _t(batch))
    assert abs(float(tloss) - float(jloss)) <= 1e-6
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for path, jg in flat:
        np.testing.assert_allclose(_get(tgrads, path).numpy(),
                                   np.asarray(jg), atol=1e-5, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
    for k in BIASES:
        assert float(np.abs(np.asarray(jgrads["blocks"]["attn"][k])).max()) \
            > 1e-4, k


def test_zeroed_biases_move_the_logits(model):
    """The guard: a port that dropped the bias add would miss the 1e-5
    forward tolerance above by orders of magnitude."""
    _, tcfg, _, tp = model
    batch = _t(_batch(tcfg.vocab))
    attn = tp["blocks"]["attn"]
    zeroed = dict(tp, blocks=dict(tp["blocks"], attn=dict(
        attn, **{k: torch.zeros_like(attn[k]) for k in BIASES})))
    with torch.no_grad():
        a = tlm.forward(tp, batch, tcfg)[0]
        b = tlm.forward(zeroed, batch, tcfg)[0]
    assert float((a - b).abs().max()) > 1e-2


def test_paged_prefill_and_decode_match_jax(model):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(1)
    shape = (jcfg.n_layers, NUM_PAGES, PAGE, jcfg.n_kv_heads, jcfg.hd)
    pools = {k: (0.5 * rng.standard_normal(shape)).astype(np.float32)
             for k in ("k", "v")}
    jstate = {k: jnp.asarray(v) for k, v in pools.items()}
    tstate = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    table = np.array([[4, 7, 2, 9]])
    toks = rng.integers(0, jcfg.vocab, (1, 27))
    for start, nvalid in ((0, 16), (16, 11)):
        chunk = np.zeros((1, 16), np.int64)
        chunk[0, :nvalid] = toks[0, start:start + nvalid]
        jl, jstate = jlm.prefill_chunk(
            jp, jstate, {"tokens": jnp.asarray(chunk, jnp.int32),
                         "index": jnp.int32(start),
                         "nvalid": jnp.int32(nvalid),
                         "pages": jnp.asarray(table, jnp.int32)}, jcfg)
        tl, tstate = tlm.prefill_chunk(
            tp, tstate, {"tokens": torch.from_numpy(chunk),
                         "index": torch.tensor(start), "nvalid": nvalid,
                         "pages": torch.from_numpy(table)}, tcfg)
        _close(tl, jl, 1e-4)
    tables = np.array([[4, 7, 2, 9], [1, 3, 0, 0], [5, 6, 8, 0]])
    index = np.array([27, 18, 40])
    for _ in range(2):
        tok = rng.integers(0, jcfg.vocab, (3, 1))
        jl, jstate = jlm.decode_step(
            jp, jstate, {"tokens": jnp.asarray(tok, jnp.int32),
                         "index": jnp.asarray(index, jnp.int32),
                         "pages": jnp.asarray(tables, jnp.int32)}, jcfg)
        tl, tstate = tlm.decode_step(
            tp, tstate, {"tokens": torch.from_numpy(tok),
                         "index": torch.from_numpy(index),
                         "pages": torch.from_numpy(tables)}, tcfg)
        _close(tl, jl, 1e-4)
        index = index + 1
    for k in ("k", "v"):
        _close(tstate[k], jstate[k], 1e-4)


@pytest.mark.parametrize("arch,page", [("glm4-9b", 16), ("qwen2.5-14b", 0)])
def test_contiguous_prefill_and_decode_match_jax(arch, page):
    """Dense slot rows: split-K over rows read as pages of 16 (glm4), one
    softmax at page 0 (qwen)."""
    jcfg, tcfg, jp, tp = _biased(arch)
    jcfg = dataclasses.replace(jcfg, decode_page_size=page)
    tcfg = dataclasses.replace(tcfg, decode_page_size=page)
    rng = np.random.default_rng(2)
    state = {k: (0.5 * rng.standard_normal(s.shape)).astype(np.float32)
             for k, s in tlm.decode_state_specs(tcfg, 2, SMAX).items()}
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    tstate = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    chunk = rng.integers(0, jcfg.vocab, (2, 8))
    jl, jstate = jlm.prefill_chunk(
        jp, jstate, {"tokens": jnp.asarray(chunk, jnp.int32),
                     "index": jnp.int32(4), "nvalid": 6}, jcfg)
    tl, tstate = tlm.prefill_chunk(
        tp, tstate, {"tokens": torch.from_numpy(chunk),
                     "index": torch.tensor(4), "nvalid": 6}, tcfg)
    _close(tl, jl, 1e-4)
    index = np.array([10, 3])
    for _ in range(2):
        tok = rng.integers(0, jcfg.vocab, (2, 1))
        jl, jstate = jlm.decode_step(
            jp, jstate, {"tokens": jnp.asarray(tok, jnp.int32),
                         "index": jnp.asarray(index, jnp.int32)}, jcfg)
        tl, tstate = tlm.decode_step(
            tp, tstate, {"tokens": torch.from_numpy(tok),
                         "index": torch.from_numpy(index)}, tcfg)
        _close(tl, jl, 1e-4)
        index = index + 1
    for k in state:
        _close(tstate[k], jstate[k], 1e-4)


# ---------------------------------------------------------------------------
# the engine on glm4, in lockstep with the JAX engine
# ---------------------------------------------------------------------------

GEOMETRY = dict(max_slots=2, max_seq=64, prefill_chunk=16, page_size=16)


def _prompts(vocab, run):
    rng = np.random.default_rng(17)
    if run == "prefix warm":
        system = rng.integers(0, vocab, (24,)).tolist()
        return [system + rng.integers(0, vocab, (n,)).tolist()
                for n in (5, 9, 3, 12)]
    pat = rng.integers(0, vocab, (5,)).tolist()
    return [pat * 4, rng.integers(0, vocab, (19,)).tolist(),
            pat * 3 + [1], rng.integers(0, vocab, (7,)).tolist()]


RUNS = {"sequential": dict(prefix_cache=False),
        "prefix warm": dict(),
        "chain": dict(spec_k=3)}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_glm4_engine_matches_jax(glm1, run):
    jcfg, tcfg, jp, tp = glm1
    knobs = dict(GEOMETRY, **RUNS[run])
    jeng = JEngine(jcfg, jp, config=JConfig(**dict(dict(spec_k=0), **knobs)))
    teng = ServeEngine(tcfg, tp, config=EngineConfig(**knobs), device="cpu")
    prompts = _prompts(jcfg.vocab, run)
    reqs = []
    for eng in (jeng, teng):
        reqs.append([eng.submit(p, 10) for p in prompts])
        eng.run()
    assert_same(jeng, teng, *reqs)
    st = teng.stats_summary()
    assert all(len(r.generated) == 10 for r in reqs[1])
    if run == "prefix warm":
        assert st["prefix_hits"] >= 3
    if run == "chain":
        assert st["spec_steps"] > 0 and st["spec_drafted"] > 0
        js = jeng.stats_summary()
        for k in ("spec_drafted", "spec_accepted", "spec_steps"):
            assert st[k] == js[k], k
