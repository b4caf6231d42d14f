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


@pytest.mark.parametrize("arch,item", [
    ("minicpm3-4b", "item 6"), ("falcon-mamba-7b", "item 10"),
    ("zamba2-1.2b", "item 10"), ("phi3.5-moe-42b-a6.6b", "item 11")])
def test_unserved_families_raise_with_roadmap_item(arch, item):
    with pytest.raises(NotImplementedError, match=item):
        get_api(tget(arch))


def test_encoder_only_has_no_decode_path():
    with pytest.raises(ValueError, match="encoder-only"):
        get_api(tget("hubert-xlarge"))
