"""Paged split-K decode attention of the port against the JAX package.

Same params (JAX ``init_params`` through ``params_from_numpy``), same
random pools and page tables (made with numpy), on the reduced
``llama3.2-3b`` config with ``n_kv_heads=2`` so the GQA repeat is
exercised.  Tables include the scratch page 0 (unallocated entries, an
idle lane) and pages shared by two rows.  Outputs agree within
``atol=rtol=1e-5`` (fp32; matmul blocking differs between XLA and
PyTorch), and so do the updated pools."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.models import attention as jattn
from repro.models.common import init_params as jinit
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as tattn

PAGE, NUM_PAGES, N_PAGES = 16, 12, 4          # smax = 64 per slot


def _setup(seed):
    jcfg = jget("llama3.2-3b").reduced(dtype=jnp.float32, n_kv_heads=2)
    tcfg = tget("llama3.2-3b").reduced(dtype=torch.float32, n_kv_heads=2)
    jp = jinit(jattn.gqa_param_specs(jcfg), jax.random.key(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           torch.float32)
    rng = np.random.default_rng(seed)
    shape = (NUM_PAGES, PAGE, jcfg.n_kv_heads, jcfg.hd)
    pool_k = rng.standard_normal(shape).astype(np.float32)
    pool_v = rng.standard_normal(shape).astype(np.float32)
    return jcfg, tcfg, jp, tp, rng, pool_k, pool_v


def _run_both(jcfg, tcfg, jp, tp, x, pool_k, pool_v, cur, pages):
    jout, jk, jv = jattn.gqa_decode_pages(
        jnp.asarray(x), jp, jcfg, jnp.asarray(pool_k), jnp.asarray(pool_v),
        jnp.asarray(cur, jnp.int32), jnp.asarray(pages, jnp.int32))
    tk, tv = torch.from_numpy(pool_k.copy()), torch.from_numpy(pool_v.copy())
    tout, tk2, tv2 = tattn.gqa_decode_pages(
        torch.from_numpy(x), tp, tcfg, tk, tv,
        torch.as_tensor(np.asarray(cur, np.int64)),
        torch.from_numpy(pages.astype(np.int64)))
    assert tk2 is tk and tv2 is tv                # written in place
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5,
                               rtol=1e-5)
    return tk.numpy(), np.asarray(jk)


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_c1_per_slot_positions(seed):
    """C=1 continuous-batching decode: per-slot ``cur``; slots 0 and 1
    share their first page; slot 2 is idle (whole row on scratch)."""
    jcfg, tcfg, jp, tp, rng, pool_k, pool_v = _setup(seed)
    pages = np.array([[3, 5, 7, 0],
                      [3, 6, 0, 0],
                      [0, 0, 0, 0],
                      [9, 10, 11, 4]], np.int64)
    cur = np.array([37, 20, 0, 63])
    x = rng.standard_normal((4, 1, jcfg.d_model)).astype(np.float32)
    tk, _ = _run_both(jcfg, tcfg, jp, tp, x, pool_k, pool_v, cur, pages)
    # the shared page is untouched; each live write landed in its own page
    np.testing.assert_array_equal(tk[3], pool_k[3])
    assert not np.array_equal(tk[7][37 % PAGE], pool_k[7][37 % PAGE])
    assert not np.array_equal(tk[0][0], pool_k[0][0])      # idle -> scratch


@pytest.mark.parametrize("start,nvalid", [(0, 11), (16, 16), (35, 9)])
def test_prefill_c16_with_bucket_padding(start, nvalid):
    """C=16 prefill piece of one slot at a shared start; rows past
    ``nvalid`` are bucket padding (their positions are masked for the
    valid rows)."""
    jcfg, tcfg, jp, tp, rng, pool_k, pool_v = _setup(start)
    pages = np.array([[2, 8, 1, 11]], np.int64)
    x = rng.standard_normal((1, 16, jcfg.d_model)).astype(np.float32)
    x[:, nvalid:] = 0.0
    _run_both(jcfg, tcfg, jp, tp, x, pool_k, pool_v, np.int64(start), pages)


def test_prefill_near_capacity_clamps_like_dynamic_update_slice():
    """A 16-row block at 56 hangs 8 rows past smax=64: the view write
    shifts left to 48 (clamped start) and the out-of-table rows go to
    scratch, in both packages."""
    jcfg, tcfg, jp, tp, rng, pool_k, pool_v = _setup(5)
    pages = np.array([[2, 8, 1, 11]], np.int64)
    x = rng.standard_normal((1, 16, jcfg.d_model)).astype(np.float32)
    tk, _ = _run_both(jcfg, tcfg, jp, tp, x, pool_k, pool_v, np.int64(56),
                      pages)
    assert not np.array_equal(tk[0][:8], pool_k[0][:8])


def test_cache_write_clamps_per_slot():
    cache = torch.zeros(2, 8, 1)
    new = torch.ones(2, 3, 1)
    tattn.batched_cache_write(cache, new, torch.tensor([6, 2]))
    assert cache[0, :, 0].tolist() == [0, 0, 0, 0, 0, 1, 1, 1]
    assert cache[1, :, 0].tolist() == [0, 0, 1, 1, 1, 0, 0, 0]
