"""The port's routed MoE FFN against ``repro.models.moe`` (no mesh).

Both MoE architectures (``phi3.5-moe``: 16 experts, top-2;
``llama4-scout``: top-1 and a shared expert), at their reduced configs
(4 experts) unless stated, fp32, on the JAX weights carried across by
``params_from_numpy`` and inputs made from a numpy seed:

* ``moe_param_specs``: names, shapes, axes and init equal, full and
  reduced;
* ``_router``: expert ids equal (also with two equal router columns, an
  exact tie, which ``jax.lax.top_k`` breaks lower index first), weights
  and aux loss within 1e-6;
* ``_capacity`` and ``_dispatch_indices`` exactly, overflow included;
* ``moe_ffn`` within 1e-5 drop-free (the reduced config's capacity), at
  capacity factor 1.0 and 0.5 (assignments dropped), and in bf16 within a
  relative L2 error of 2e-2;
* ``use_moa_reduce`` on and off give equal losses (the port of
  ``tests/test_system.py::test_moe_moa_reduce_combine_equivalence``);
* ``_topk_combine`` equals the reference's with ``torch.equal``: the
  reference sums with ``jnp.sum`` in fp32 off the TPU, the port's CPU path
  with the radix-4 tree, and the two agree bit for bit (up to the sign of
  a zero) only for N <= 3 operands, as at top_k 1 and 2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.configs.registry import get_config as jget
from repro.launch.inputs import make_batch
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models.common import init_params as jinit
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe

ARCHS = ["phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e"]
#: capacity factors: the reduced config's drop-free one, 1.0, 0.5
CAPACITIES = [None, 1.0, 0.5]


def _cfgs(arch, dtype="float32", **over):
    return (jget(arch).reduced(dtype=getattr(jnp, dtype), **over),
            tget(arch).reduced(dtype=getattr(torch, dtype), **over))


def _ffn_params(jcfg, seed=0):
    jp = jinit(jmoe.moe_param_specs(jcfg), jax.random.key(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                                 torch.float32)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _over(cf):
    return {} if cf is None else dict(capacity_factor=cf)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_param_specs_match_jax(arch, reduced):
    jcfg, tcfg = jget(arch), tget(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    js, ts = jmoe.moe_param_specs(jcfg), tmoe.moe_param_specs(tcfg)
    assert sorted(ts) == sorted(js)
    for k, s in ts.items():
        assert (s.shape, s.axes, s.init, s.scale) == (
            js[k].shape, js[k].axes, js[k].init, js[k].scale), k
    shared = {"shared_w1", "shared_w2", "shared_w3"}
    assert (shared <= set(ts)) == bool(tcfg.n_shared_experts)
    # the block takes them as its ffn
    assert tlm.block_specs(tcfg)["ffn"].keys() == ts.keys()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("arch", ARCHS)
def test_router_matches_jax(arch, seed):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _ffn_params(jcfg, seed)
    x = _x((24, jcfg.d_model), seed)
    jw, ji, ja = jmoe._router(jnp.asarray(x), jp["router"], jcfg)
    tw, ti, ta = tmoe._router(torch.from_numpy(x), tp["router"], tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6)
    assert tw.dtype == torch.float32 and ta.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_router_breaks_an_exact_tie_like_jax(arch):
    """Router columns 1 and 3 equal: every token's probs tie there, and
    both packages rank expert 1 first."""
    jcfg, tcfg = _cfgs(arch)
    router = _x((jcfg.d_model, jcfg.n_experts), 4) * 0.02
    router[:, 1] += 0.5                     # the tied pair is the top pick
    router[:, 3] = router[:, 1]
    x = np.abs(_x((16, jcfg.d_model), 5))
    jw, ji, ja = jmoe._router(jnp.asarray(x), jnp.asarray(router), jcfg)
    tw, ti, ta = tmoe._router(torch.from_numpy(x), torch.from_numpy(router),
                              tcfg)
    assert (np.asarray(ji)[:, 0] == 1).all()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_jax(arch):
    for cf in (0.25, 0.5, 1.0, 1.25, 4.0):
        jcfg, tcfg = _cfgs(arch, capacity_factor=cf)
        for t in (1, 2, 3, 4, 7, 16, 20, 256, 1000):
            assert tmoe._capacity(t, tcfg) == jmoe._capacity(t, jcfg), (cf, t)
    full = tget("phi3.5-moe-42b-a6.6b")
    # a 4-slot decode step and a 256-token prefill piece at 1.25
    assert tmoe._capacity(4, full) == 1 and tmoe._capacity(256, full) == 40


@pytest.mark.parametrize("cap", [1, 2, 3, 8])
@pytest.mark.parametrize("k", [1, 2])
def test_dispatch_indices_match_jax(k, cap):
    e = 4
    idx = np.random.default_rng(cap * 10 + k).integers(0, e, (9, k))
    jf, jpos, jkeep = jmoe._dispatch_indices(jnp.asarray(idx, jnp.int32), e,
                                             cap)
    tf, tpos, tkeep = tmoe._dispatch_indices(torch.from_numpy(idx), e, cap)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    if cap < 3:
        assert not tkeep.all()             # overflow: assignments dropped


def _drops(tcfg, t, x, router):
    _, idx, _ = tmoe._router(x.reshape(-1, x.shape[-1]), router, tcfg)
    _, _, keep = tmoe._dispatch_indices(idx, tcfg.n_experts,
                                        tmoe._capacity(t, tcfg))
    return int((~keep).sum())


@pytest.mark.parametrize("cf", CAPACITIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, cf):
    jcfg, tcfg = _cfgs(arch, **_over(cf))
    jp, tp = _ffn_params(jcfg)
    x = _x((2, 8, jcfg.d_model))
    jy, ja = jmoe.moe_ffn(jnp.asarray(x), jp, jcfg)
    ty, ta = tmoe.moe_ffn(torch.from_numpy(x), tp, tcfg)
    assert ty.shape == (2, 8, tcfg.d_model) and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6)
    drops = _drops(tcfg, 16, torch.from_numpy(x), tp["router"])
    if cf is None:
        assert drops == 0
    if cf == 0.5:
        assert drops > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_bf16_within_rel_l2(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jp, tp = _ffn_params(jcfg)
    x = _x((2, 8, jcfg.d_model))
    jy, _ = jmoe.moe_ffn(jnp.asarray(x, jnp.bfloat16), jp, jcfg)
    ty, _ = tmoe.moe_ffn(torch.from_numpy(x).to(torch.bfloat16), tp, tcfg)
    assert ty.dtype == torch.bfloat16
    want = np.asarray(jy, np.float32)
    got = ty.float().numpy()
    assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_moa_reduce_combine_equals_plain_sum(arch):
    """``use_moa_reduce`` on and off: the training loss is the same (the
    port of ``test_system.py::test_moe_moa_reduce_combine_equivalence``),
    and so is the FFN's output."""
    base = jget(arch).reduced(dtype=jnp.float32)
    batch = make_batch(base, JShape("moa", 16, 2, "train"), seed=3)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    jp = jinit(jlm.param_specs(base), jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           torch.float32)
    losses = {}
    for flag in (True, False):
        tcfg = tget(arch).reduced(dtype=torch.float32, use_moa_reduce=flag)
        losses[flag] = float(tlm.train_loss(tp, tb, tcfg))
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-6)
    want = float(jlm.train_loss(jp, batch, base))
    np.testing.assert_allclose(losses[True], want, rtol=1e-5)


@pytest.mark.parametrize("use_moa", [True, False])
@pytest.mark.parametrize("top_k", [1, 2])
def test_topk_combine_equals_reference_exactly(top_k, use_moa):
    """N = top_k <= 3: the radix-4 tree's (a + b) + (0 + 0) is the fp32
    sum, so the combine is equal, not just close (torch.equal counts
    -0 == +0, the one place the two may differ)."""
    jcfg = dataclasses.replace(jget("phi3.5-moe-42b-a6.6b").reduced(
        dtype=jnp.float32), top_k=top_k, use_moa_reduce=use_moa)
    tcfg = dataclasses.replace(tget("phi3.5-moe-42b-a6.6b").reduced(
        dtype=torch.float32), top_k=top_k, use_moa_reduce=use_moa)
    t, d = 33, jcfg.d_model
    gathered = _x((t * top_k, d), 7)
    weights = np.abs(_x((t, top_k), 8))
    gathered[:5] = -0.0
    want = jmoe._topk_combine(jnp.asarray(gathered), jnp.asarray(weights),
                              t, d, jcfg)
    got = tmoe._topk_combine(torch.from_numpy(gathered),
                             torch.from_numpy(weights), t, d, tcfg)
    assert torch.equal(got, torch.from_numpy(np.asarray(want)))
