"""The port's MoE decoders through every ``lm`` entry point against the JAX
package.

The reduced fp32 ``phi3.5-moe`` (4 experts, top-2) and ``llama4-scout``
(top-1, a shared expert) with the JAX weights (``params_from_numpy``),
drop-free (the reduced capacity) and at capacity factor 1.0, where a
dispatch's rows compete for places:

* ``forward``'s logits and its summed router aux loss within 1e-4, with
  remat too (each layer under ``torch.utils.checkpoint``);
* ``train_loss`` and every gradient leaf within 1e-4 of
  ``jax.value_and_grad``;
* ``decode_step``, ``prefill_chunk``, ``verify_chunk`` and ``verify_tree``
  over paged fp32 pools (an idle lane among the slots), over an int8
  pool, and over dense slot rows, and ``hidden_states``: logits and states
  within 1e-4 (an int8 pool within one code step);
* the port's decode equals its own teacher-forced forward within 2e-3
  (the port of ``tests/test_system.py::test_decode_matches_teacher_forcing``
  for ``phi3.5-moe``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.launch.inputs import make_batch
from repro.models import lm as jlm
from repro_torch.models import lm as tlm
from repro_torch.models.registry import get_api
from test_torch_contiguous import _batch, _dense_state
from test_torch_lm import _pools
from test_torch_prefix import _model
from test_torch_quant_kv import _batches, _close_quant_pools, _quant_pools

ARCHS = ["phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e"]
CAPS = {"drop-free": {}, "capacity 1.0": dict(capacity_factor=1.0)}
_MODELS = {}


def _moe(arch, cap="drop-free", **over):
    key = (arch, cap, tuple(sorted(over.items())))
    if key not in _MODELS:
        _MODELS[key] = _model(arch=arch, **CAPS[cap], **over)
    return _MODELS[key]


def _close(t, j, tol=1e-4):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol,
                               rtol=tol)


def _train_batch(jcfg, seed=3):
    batch = make_batch(jcfg, JShape("moe", 16, 2, "train"), seed=seed)
    return batch, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("cap", sorted(CAPS))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_jax(arch, cap, remat):
    jcfg, tcfg, jp, tp = _moe(arch, cap)
    jcfg = dataclasses.replace(jcfg, remat=remat)
    tcfg = dataclasses.replace(tcfg, remat=remat)
    jb, tb = _train_batch(jcfg)
    jl, ja = jlm.forward(jp, jb, jcfg)
    with torch.enable_grad():
        tl, ta = tlm.forward(tp, tb, tcfg)
    _close(tl, jl)
    assert ta.dtype == torch.float32 and float(ta) > 0
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6, rtol=1e-5)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("cap", sorted(CAPS))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_jax(arch, cap):
    jcfg, tcfg, jp, tp = _moe(arch, cap)
    jb, tb = _train_batch(jcfg, seed=4)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jlm.train_loss(p, jb, jcfg))(jp)
    leaves = dict(_flat(tp))
    ws = {k: v.detach().clone().requires_grad_(True)
          for k, v in leaves.items()}
    params = {}
    for path, w in ws.items():
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = w
    loss = tlm.train_loss(params, tb, tcfg)
    grads = dict(zip(ws, torch.autograd.grad(loss, list(ws.values()))))
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-4)
    jflat = dict(_flat(jgrads))
    assert sorted(grads) == sorted(jflat)
    for path, g in grads.items():
        _close(g, jflat[path])
    # the experts and the router both learn
    ffn = {p[-1] for p, g in grads.items() if "ffn" in p and g.abs().sum()}
    assert {"router", "w1", "w2", "w3"} <= ffn


#: an entry point's live logits rows (the paged batches' idle lane aside)
LIVE = {"decode_step": slice(0, 2), "prefill_chunk": slice(0, 1),
        "verify_chunk": slice(0, 2), "verify_tree": slice(0, 2)}


def _call(name, jcfg, tcfg, jp, tp, batch, jstate, tstate):
    jb = {k: (v if k == "nvalid" else jnp.asarray(v, jnp.int32))
          for k, v in batch.items()}
    tb = {k: (v if k == "nvalid" else torch.as_tensor(v, dtype=torch.int64))
          for k, v in batch.items()}
    jout = getattr(jlm, name)(jp, jstate, jb, jcfg)
    tout = getattr(tlm, name)(tp, tstate, tb, tcfg)
    return jout[0], jout[-1], tout[0], tout[-1]


@pytest.mark.parametrize("name", sorted(LIVE))
@pytest.mark.parametrize("cap", sorted(CAPS))
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_entry_points_match_jax(arch, cap, name):
    """Paged fp32 pools, three slots with the third idle: every row routes,
    so the idle lane takes expert places too, in both packages."""
    jcfg, tcfg, jp, tp = _moe(arch, cap)
    pools = _pools(jcfg, np.random.default_rng(2))
    batch = _batches(np.random.default_rng(3), jcfg.vocab)[name]
    jl, jstate, tl, tstate = _call(
        name, jcfg, tcfg, jp, tp, batch,
        {k: jnp.asarray(v) for k, v in pools.items()},
        {k: torch.from_numpy(v.copy()) for k, v in pools.items()})
    assert tl.dtype == torch.float32
    _close(tl[LIVE[name]], np.asarray(jl)[LIVE[name]])
    for k in pools:
        _close(tstate[k], jstate[k], 1e-5)


@pytest.mark.parametrize("name", sorted(LIVE))
def test_int8_pool_entry_points_match_jax(name):
    jcfg, tcfg, jp, tp = _moe(ARCHS[0], "capacity 1.0")
    pools = _quant_pools(jcfg, "int8", 2)
    batch = _batches(np.random.default_rng(3), jcfg.vocab)[name]
    jl, jstate, tl, tstate = _call(
        name, jcfg, tcfg, jp, tp, batch,
        {k: jnp.asarray(v) for k, v in pools.items()},
        {k: torch.from_numpy(v.copy()) for k, v in pools.items()})
    _close(tl[LIVE[name]], np.asarray(jl)[LIVE[name]])
    _close_quant_pools(tstate, jstate)


@pytest.mark.parametrize("kind", ["decode vector", "decode scalar",
                                  "prefill", "verify chunk", "verify tree"])
@pytest.mark.parametrize("cap", sorted(CAPS))
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_entry_points_match_jax(arch, cap, kind):
    """Dense slot rows at ``decode_page_size`` 16 (split-K over the rows)."""
    jcfg, tcfg, jp, tp = _moe(arch, cap)
    jcfg = dataclasses.replace(jcfg, decode_page_size=16)
    tcfg = dataclasses.replace(tcfg, decode_page_size=16)
    name, batch = _batch(kind, tcfg.vocab, np.random.default_rng(5))
    state = _dense_state(tcfg, 2, 6)
    jl, jstate, tl, tstate = _call(
        name, jcfg, tcfg, jp, tp, batch,
        {k: jnp.asarray(v) for k, v in state.items()},
        {k: torch.from_numpy(v.copy()) for k, v in state.items()})
    _close(tl, jl)
    for k in state:
        _close(tstate[k], jstate[k])


@pytest.mark.parametrize("cap", sorted(CAPS))
@pytest.mark.parametrize("arch", ARCHS)
def test_hidden_states_match_jax(arch, cap):
    jcfg, tcfg, jp, tp = _moe(arch, cap)
    toks = np.random.default_rng(8).integers(0, jcfg.vocab, (2, 11))
    want = jlm.hidden_states(jp, jcfg, jnp.asarray(toks, jnp.int32))
    got = tlm.hidden_states(tp, tcfg, torch.from_numpy(toks))
    assert got.shape == (2, 11, tcfg.d_model)
    _close(got, want)


def test_decode_matches_teacher_forcing():
    """Greedy replay through ``decode_step`` (a 0-d index, B = 2 rows a
    dispatch) reproduces the forward's logits at every position: the
    reduced capacity is drop-free, so the routing of T = 2 and T = 24
    tokens agrees."""
    _, cfg, _, params = _moe(ARCHS[0])
    api = get_api(cfg)
    b, s = 2, 12
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (b, s)))
    fwd, _ = api.forward(params, {"tokens": tokens}, cfg)
    state = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
             api.decode_state_specs(cfg, b, s).items()}
    for i in range(s):
        logits, state = api.decode_step(
            params, state, {"tokens": tokens[:, i:i + 1],
                            "index": torch.tensor(i)}, cfg)
        np.testing.assert_allclose(logits.numpy(), fwd[:, i].numpy(),
                                   rtol=2e-3, atol=2e-3,
                                   err_msg=f"position {i}")
