"""Decoder LM decode surface of the port against the JAX package.

JAX ``init_params`` weights go through ``params_from_numpy``; both packages
run a chunked prefill of one slot and then continuous-batching decode
steps over paged pools made from the same numpy arrays.  Logits agree
within ``atol=1e-4`` at every call (fp32, 2 layers), and so do the pools.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.models import lm as jlm
from repro.models.common import init_params as jinit
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention
from repro_torch.models import lm as tlm
from repro_torch.models.common import init_params as tinit
from repro_torch.models.registry import get_api

PAGE, NUM_PAGES = 16, 10


def _models():
    jcfg = jget("llama3.2-3b").reduced(dtype=jnp.float32, n_kv_heads=2)
    tcfg = tget("llama3.2-3b").reduced(dtype=torch.float32, n_kv_heads=2)
    jp = jinit(jlm.param_specs(jcfg), jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           torch.float32)
    return jcfg, tcfg, jp, tp


def _pools(cfg, rng):
    shape = (cfg.n_layers, NUM_PAGES, PAGE, cfg.n_kv_heads, cfg.hd)
    return {k: (0.5 * rng.standard_normal(shape)).astype(np.float32)
            for k in ("k", "v")}


def _tstate(pools):
    return {k: torch.from_numpy(v.copy()) for k, v in pools.items()}


def _close_pools(tstate, jstate):
    for k in ("k", "v"):
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]),
                                   atol=1e-5, rtol=1e-5)


def test_param_layout_matches_jax():
    jcfg, tcfg, jp, tp = _models()
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape
    specs = tlm.param_specs(tcfg)
    init = tinit(specs, torch.Generator().manual_seed(0),
                 torch.device("cpu"), torch.bfloat16)
    assert init["blocks"]["attn"]["wq"].shape == tp["blocks"]["attn"]["wq"].shape
    assert init["blocks"]["attn_norm"].dtype == torch.bfloat16
    assert bool((init["final_norm"] == 1).all())


def test_prefill_then_decode_logits_match_jax():
    jcfg, tcfg, jp, tp = _models()
    rng = np.random.default_rng(0)
    pools = _pools(jcfg, rng)
    jstate = {k: jnp.asarray(v) for k, v in pools.items()}
    tstate = _tstate(pools)

    # prefill: one slot, a 16-bucket with 11 real tokens, then a tail piece
    table = np.array([[4, 7, 2, 9]], np.int64)
    toks = rng.integers(0, jcfg.vocab, (1, 27))
    for start, nvalid, cb in ((0, 16, 16), (16, 11, 16)):
        chunk = np.zeros((1, cb), np.int64)
        chunk[0, :nvalid] = toks[0, start:start + nvalid]
        jl, jstate = jlm.prefill_chunk(
            jp, jstate, {"tokens": jnp.asarray(chunk, jnp.int32),
                         "index": jnp.int32(start),
                         "nvalid": jnp.int32(nvalid),
                         "pages": jnp.asarray(table, jnp.int32)}, jcfg)
        tl, tstate = get_api(tcfg).prefill_chunk(
            tp, tstate, {"tokens": torch.from_numpy(chunk),
                         "index": torch.tensor(start), "nvalid": nvalid,
                         "pages": torch.from_numpy(table)}, tcfg)
        assert tl.dtype == torch.float32 and tuple(tl.shape) == (1, 97)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    _close_pools(tstate, jstate)

    # decode: three slots at their own positions, one idle lane
    tables = np.array([[4, 7, 2, 9], [1, 3, 0, 0], [0, 0, 0, 0],
                       [5, 6, 8, 0]], np.int64)
    index = np.array([27, 18, 0, 40])
    for _ in range(3):
        tok = rng.integers(0, jcfg.vocab, (4, 1))
        jl, jstate = jlm.decode_step(
            jp, jstate, {"tokens": jnp.asarray(tok, jnp.int32),
                         "index": jnp.asarray(index, jnp.int32),
                         "pages": jnp.asarray(tables, jnp.int32)}, jcfg)
        tl, tstate = tlm.decode_step(
            tp, tstate, {"tokens": torch.from_numpy(tok),
                         "index": torch.from_numpy(index),
                         "pages": torch.from_numpy(tables)}, tcfg)
        assert tl.dtype == torch.float32 and tuple(tl.shape) == (4, 97)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        index = index + np.array([1, 1, 0, 1])
    _close_pools(tstate, jstate)


def _serve_calls(tp, cfg, pools, rng_seed=1):
    """A prefill chunk then a decode step over bf16 pools; returns every
    call's logits, the final pools and the dtypes attention saw."""
    rng = np.random.default_rng(rng_seed)
    state = {k: torch.from_numpy(v.copy()).to(cfg.dtype)
             for k, v in pools.items()}
    table = np.array([[4, 7], [1, 3]], np.int64)
    seen, logits = [], []
    real = attention.gqa_decode_pages

    def spy(x, *args):
        seen.append(x.dtype)
        return real(x, *args)

    attention.gqa_decode_pages = spy
    try:
        chunk = rng.integers(0, cfg.vocab, (2, 16))
        tl, state = tlm.prefill_chunk(
            tp, state, {"tokens": torch.from_numpy(chunk),
                        "index": torch.tensor(0), "nvalid": 13,
                        "pages": torch.from_numpy(table)}, cfg)
        logits.append(tl)
        tok = rng.integers(0, cfg.vocab, (2, 1))
        tl, state = tlm.decode_step(
            tp, state, {"tokens": torch.from_numpy(tok),
                        "index": torch.tensor([13, 9]),
                        "pages": torch.from_numpy(table)}, cfg)
        logits.append(tl)
    finally:
        attention.gqa_decode_pages = real
    return logits, state, set(seen)


def test_decode_casts_params_to_the_config_dtype():
    """fp32 params (a trained state's masters) under a bf16 config serve
    exactly as the same params cast to bf16, as the JAX package's casts
    at every use make it: logits and pools torch.equal, attention in bf16."""
    _, _, jp, _ = _models()                  # the JAX package's fp32 init
    jp = jax.tree.map(np.asarray, jp)
    tcfg = tget("llama3.2-3b").reduced(dtype=torch.bfloat16, n_kv_heads=2)
    pools = _pools(tcfg, np.random.default_rng(0))
    runs = [_serve_calls(params_from_numpy(jp, "cpu", dt), tcfg, pools)
            for dt in (torch.float32, torch.bfloat16)]
    (l32, s32, seen32), (l16, s16, seen16) = runs
    assert seen32 == seen16 == {torch.bfloat16}
    for a, b in zip(l32, l16):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    for k in ("k", "v"):
        assert s32[k].dtype == torch.bfloat16 and torch.equal(s32[k], s16[k])


def _jax_serve_calls(jp, cfg, pools, rng_seed=1):
    """The JAX package's prefill chunk and decode step on the calls
    :func:`_serve_calls` makes."""
    rng = np.random.default_rng(rng_seed)
    state = {k: jnp.asarray(v, cfg.dtype) for k, v in pools.items()}
    table = jnp.asarray([[4, 7], [1, 3]], jnp.int32)
    chunk = rng.integers(0, cfg.vocab, (2, 16))
    jl0, state = jlm.prefill_chunk(
        jp, state, {"tokens": jnp.asarray(chunk, jnp.int32),
                    "index": jnp.int32(0), "nvalid": jnp.int32(13),
                    "pages": table}, cfg)
    tok = rng.integers(0, cfg.vocab, (2, 1))
    jl1, state = jlm.decode_step(
        jp, state, {"tokens": jnp.asarray(tok, jnp.int32),
                    "index": jnp.asarray([13, 9], jnp.int32),
                    "pages": table}, cfg)
    return [jl0, jl1], state


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_decode_with_fp32_params_under_bf16_matches_jax():
    """fp32 params under a bf16 config against the JAX package's own
    prefill_chunk / decode_step on the same params, config and pools.
    The reference serves fp32 params exactly as their bf16 cast; the
    layer-0 K/V rows both write (embedding cast to bf16, norm, projection,
    rope) are equal bit for bit, which a missing or wrong embedding cast
    breaks; logits and pools agree within a relative L2 error of 2e-2,
    2.5 bf16 epsilons (2^-7), after two bf16 layers."""
    _, _, jp, _ = _models()
    jp = jax.tree.map(np.asarray, jp)
    jcfg = jget("llama3.2-3b").reduced(dtype=jnp.bfloat16, n_kv_heads=2)
    tcfg = tget("llama3.2-3b").reduced(dtype=torch.bfloat16, n_kv_heads=2)
    pools = _pools(tcfg, np.random.default_rng(0))
    jl, jstate = _jax_serve_calls(jax.tree.map(jnp.asarray, jp), jcfg, pools)
    jl16, jstate16 = _jax_serve_calls(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jp), jcfg, pools)
    for a, b in zip(jl, jl16):
        assert bool(jnp.array_equal(a, b))
    for k in ("k", "v"):
        assert bool(jnp.array_equal(jstate[k], jstate16[k]))
    tl, tstate, _ = _serve_calls(params_from_numpy(jp, "cpu", torch.float32),
                                 tcfg, pools)
    for t, j in zip(tl, jl):
        assert t.dtype == torch.float32 and j.dtype == jnp.float32
        assert _rel_l2(t.numpy(), j) <= 2e-2
    for k in ("k", "v"):
        j = torch.from_numpy(np.asarray(jstate[k], np.float32))
        assert tstate[k].dtype == torch.bfloat16 and jstate[k].dtype == jnp.bfloat16
        assert torch.equal(tstate[k][0], j[0].to(torch.bfloat16))
        assert _rel_l2(tstate[k].float().numpy(), j.numpy()) <= 2e-2


@pytest.mark.parametrize("arch,item", [
    ("minicpm3-4b", "item 6"), ("falcon-mamba-7b", "item 10"),
    ("zamba2-1.2b", "item 10"), ("phi3.5-moe-42b-a6.6b", "item 11")])
def test_unserved_families_raise_with_roadmap_item(arch, item):
    with pytest.raises(NotImplementedError, match=item):
        get_api(tget(arch))


def test_encoder_only_has_no_decode_path():
    with pytest.raises(ValueError, match="encoder-only"):
        get_api(tget("hubert-xlarge"))
