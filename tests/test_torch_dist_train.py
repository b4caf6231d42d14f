"""The port's sharded train steps, split-K decode and head-padded tensor
parallelism against the JAX package, on 8 gloo CPU ranks (one spawn for
the file, ``tests/_torch_dist.py``), at ``tests/dist_progs``' sizes.

On ``make_test_mesh(multi_pod=True)`` (pod 2 x data 2 x model 2), the
reduced llama3.2-3b of ``prog_train_step.py`` (d_model 64, 4 heads, 2 KV
heads, vocab 96, fp32), batch 8 x 16 from a numpy seed, the JAX
``init_train_state`` carried across:

* the standard step: each rank's gradient of its rows (heads split over
  ``model``), meaned over pod x data, equals ``jax.grad`` of the
  single-device loss within 1e-5; the step's loss and grad norm equal the
  JAX single-device step's within 1e-5 and its params within 1e-5 where
  the gradient is above 1e-6 (elsewhere AdamW's first step, lr * g / (|g|
  + eps), turns a reassociation into up to 2 * lr);
* the pod-compressed step: loss within rtol 1e-3 of the single-device
  step (``prog_train_step.py``'s check), the residual the same on every
  rank of a pod, nonzero, and a second step runs on it; against a JAX
  oracle: each pod's gradient (its rows, meaned over data) equals
  ``jax.grad`` of that pod's loss within 1e-5; from the two pods'
  gradients as the ranks computed them, JAX's ``quantize_int8`` /
  ``dequantize_int8`` at one shared scale and an int32 sum give the mean
  the step hands AdamW and each pod's residual within 1e-6, and one JAX
  ``adamw_update`` with that mean gives the step's grad norm and params
  within 1e-5;
* split-K decode (each rank 2 rows and 16 of 32 cache positions, a 0-d
  index at 20 owned by ``model`` rank 1, random caches): logits within
  1e-5 of the unsharded JAX ``decode_step``, the cache blocks equal to its
  new state's within 1e-5, the bytes a max and two sums a layer; the same
  for reduced zamba2's shared attention in ``hybrid_decode_step``, with
  its Mamba state rows;
* a vector index on a model axis, and pod compression without a pod axis,
  raise.

On ``make_test_mesh()`` (data 2 x model 4), ``prog_head_pad.py``'s case:
6 q heads over 4 ranks pad to 8; logits within 1e-4 of the unsharded
JAX forward, the loss within 1e-5 and every gradient within 5e-4.
Without a spawn: ``tp_head_pad``, the padded head layout and
``splitk_ok`` against the JAX functions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from repro.configs.registry import get_config as jget
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models.common import init_params as jinit
from repro.models.registry import get_api as jget_api
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.optim.adamw import adamw_init, adamw_update
from repro.train import state as jstate
from repro_torch.configs.registry import get_config as tget
from repro_torch.models import attention as tattn
from test_torch_collectives import _jax_compressed

TRAIN = ("llama3.2-3b", {"n_kv_heads": 2, "vocab": 96, "d_model": 64,
                         "n_heads": 4})
HEAD_PAD = ("llama3.2-3b", {"n_heads": 6, "n_kv_heads": 2, "d_model": 96,
                            "vocab": 64})
HYBRID = ("zamba2-1.2b", {})
B, S, SMAX, INDEX = 8, 16, 32, 20


def _jcfg(arch, over):
    return jget(arch).reduced(dtype=jnp.float32, **over)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _decode_case(arch, over, seed):
    cfg = _jcfg(arch, over)
    api = jget_api(cfg)
    params = _np(jinit(api.param_specs(cfg), jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    specs = api.decode_state_specs(cfg, B, SMAX)
    state = {k: (0.5 * rng.standard_normal(s.shape)).astype(np.float32)
             for k, s in specs.items()}
    tokens = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int64)
    logits, new = api.decode_step(params, state, {
        "tokens": jnp.asarray(tokens, jnp.int32),
        "index": jnp.asarray(INDEX, jnp.int32)}, cfg)
    case = {"arch": arch, "over": over, "params": params, "state": state,
            "tokens": tokens, "index": INDEX}
    return case, (cfg, np.asarray(logits), _np(new))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = _jcfg(*TRAIN)
    state = _np(jstate.init_train_state(cfg, jax.random.key(0)))
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int64),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int64)}
    jbatch = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    api = jget_api(cfg)
    loss, grads = jax.value_and_grad(
        lambda p: api.train_loss(p, jbatch, cfg))(state["params"])
    step = jax.jit(jstate.build_train_step(cfg, JAdamW(lr=1e-2,
                                                       grad_clip=1.0)))
    s1, m1 = step(state, jbatch)
    # each pod's gradient: pod-major ranks, so pod p holds rows p*B/2...
    pod_grads = [_np(jax.grad(lambda p: api.train_loss(p, {
        k: v[i * B // 2:(i + 1) * B // 2] for k, v in jbatch.items()},
        cfg))(state["params"])) for i in range(2)]
    train = {"loss": float(loss), "grads": _np(grads),
             "metrics": _np(m1), "params": _np(s1["params"]),
             "params0": state["params"], "pod_grads": pod_grads}

    hcfg = _jcfg(*HEAD_PAD)
    hapi = jget_api(hcfg)
    hparams = _np(jinit(hapi.param_specs(hcfg), jax.random.key(0)))
    hrng = np.random.default_rng(0)
    hbatch = {k: hrng.integers(0, hcfg.vocab, (4, 16)).astype(np.int64)
              for k in ("tokens", "labels")}
    jh = {k: jnp.asarray(v, jnp.int32) for k, v in hbatch.items()}
    hloss, hgrads = jax.value_and_grad(
        lambda p: hapi.train_loss(p, jh, hcfg))(hparams)
    head_pad = {"logits": np.asarray(hapi.forward(hparams, jh, hcfg)[0]),
                "loss": float(hloss), "grads": _np(hgrads)}

    decode, decode_ref = _decode_case(*TRAIN, seed=1)
    hybrid, hybrid_ref = _decode_case(*HYBRID, seed=2)
    payload = {
        "train": {"arch": TRAIN[0], "over": TRAIN[1], "state": state,
                  "batch": batch},
        "head_pad": {"arch": HEAD_PAD[0], "over": HEAD_PAD[1],
                     "params": hparams, "batch": hbatch},
        "decode": decode, "hybrid": hybrid}
    ranks = _torch_dist.run_ranks(8, "dist_train_program", payload,
                                  tmp_path_factory.mktemp("dist_train"))
    return {"train": train, "head_pad": head_pad, "decode": decode_ref,
            "hybrid": hybrid_ref, "ranks": ranks}


def _ok(ranks, case):
    out = []
    for r, res in enumerate(ranks):
        status, value = res[case]
        assert status == "ok", f"rank {r}:\n{value}"
        out.append(value)
    return out


def _close(got, want, tol, rtol=None):
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=tol if rtol is None else rtol,
                                   atol=tol)


def test_standard_mesh_step_equals_the_single_device_step(setup):
    want = setup["train"]
    for loss, grads, metrics, params in _ok(setup["ranks"], "standard_step"):
        np.testing.assert_allclose(float(loss), want["loss"], rtol=1e-5)
        _close(grads, want["grads"], 1e-5)
        np.testing.assert_allclose(float(metrics["loss"]), want["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(want["metrics"]["grad_norm"]),
                                   rtol=1e-5)
        # AdamW's first step moves a param by lr * g / (|g| + eps): where
        # |g| is near eps, a reassociated sum moves it by up to 2 * lr
        for a, b, g in zip(jax.tree.leaves(params),
                           jax.tree.leaves(want["params"]),
                           jax.tree.leaves(want["grads"])):
            firm = np.abs(g) > 1e-6
            np.testing.assert_allclose(a[firm], b[firm], rtol=1e-5,
                                       atol=1e-5)
            assert np.all(np.abs(a - b) <= 2e-2)


def test_pod_compressed_step_tracks_the_single_device_step(setup):
    want = setup["train"]
    outs = _ok(setup["ranks"], "compressed_step")
    for r, (first, second) in enumerate(outs):
        metrics, params, err = first[:3]
        np.testing.assert_allclose(float(metrics["loss"]), want["loss"],
                                   rtol=1e-3)
        assert np.isfinite(float(second[0]["loss"]))
        for e in jax.tree.leaves(err):
            assert e.shape[0] == 1 and np.all(np.isfinite(e))
        assert any(np.any(e != 0) for e in jax.tree.leaves(err))
        # every rank of a pod (pod-major: ranks 0-3, 4-7) holds one residual
        mate = outs[r - r % 4][0][2]
        for a, b in zip(jax.tree.leaves(err), jax.tree.leaves(mate)):
            np.testing.assert_array_equal(a, b)
    other = jax.tree.leaves(outs[4][0][2])
    assert any(np.any(a != b) for a, b in
               zip(jax.tree.leaves(outs[0][0][2]), other))


def test_pod_compressed_step_equals_the_jax_oracle(setup):
    want = setup["train"]
    outs = [first for first, _ in _ok(setup["ranks"], "compressed_step")]
    opt = JAdamW(lr=1e-2, grad_clip=1.0)
    for r, (metrics, params, err, pod_grads, adam_grads) in enumerate(outs):
        pod = r // 4
        _close(pod_grads, want["pod_grads"][pod], 1e-5)
        # the two pods' gradients the rank and its pod peer computed,
        # through JAX's quantizer with one shared scale and an int32 sum
        ga, gb = outs[r % 4][3], outs[r % 4 + 4][3]
        pairs = jax.tree.map(lambda a, b: _jax_compressed(
            np.stack([a, b]), np.zeros((2,) + a.shape, np.float32)), ga, gb)
        mean = jax.tree.map(lambda _, pr: pr[0], ga, pairs)
        _close(adam_grads, mean, 1e-6)
        _close(err, jax.tree.map(lambda _, pr: pr[1][pod:pod + 1], ga,
                                 pairs), 1e-6)
        new, _, jm = adamw_update(opt, want["params0"], mean,
                                  adamw_init(want["params0"]))
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        _close(params, _np(new), 1e-5)


@pytest.mark.parametrize("case", ["decode", "hybrid"])
def test_splitk_decode_equals_the_unsharded_step(setup, case):
    cfg, logits, new = setup[case]
    name = "decode" if case == "decode" else "hybrid_decode"
    n_attn = (cfg.n_layers if case == "decode"
              else cfg.n_layers // cfg.shared_attn_period)
    hd, rep = cfg.hd, cfg.n_heads // cfg.n_kv_heads
    # per layer: the row max and the sum-exp (b, g, r, 1), PV (.., hd)
    per_layer = 2 * cfg.n_kv_heads * rep * (2 + hd) * 4
    for i, (got_logits, state, nbytes) in enumerate(_ok(setup["ranks"],
                                                        name)):
        rows, m = slice(2 * (i // 2), 2 * (i // 2) + 2), i % 2
        np.testing.assert_allclose(got_logits, logits[rows], rtol=1e-5,
                                   atol=1e-5)
        for k, v in state.items():
            want = new[k][:, rows]
            if k in ("k", "v"):
                want = want[:, :, m * SMAX // 2:(m + 1) * SMAX // 2]
            np.testing.assert_allclose(v, want, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        assert nbytes == {"all_reduce": n_attn * per_layer}


def test_mesh_refusals(setup):
    for compress, vector in _ok(setup["ranks"], "refusals"):
        assert "needs a mesh with a 'pod' axis" in compress
        assert "runs split-K only" in vector


def test_head_padded_forward_and_gradients(setup):
    want = setup["head_pad"]
    for i, (pad, logits, loss, grads) in enumerate(_ok(setup["ranks"],
                                                       "head_pad")):
        assert pad == 2
        rows = slice(2 * (i // 4), 2 * (i // 4) + 2)
        np.testing.assert_allclose(logits, want["logits"][rows], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(float(loss), want["loss"], rtol=1e-5)
        _close(grads, want["grads"], 5e-4)


class _FakeMesh:
    """What the JAX functions read of a mesh: its shape and axis names."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.empty = False


@pytest.mark.parametrize("heads,kv,tp", [(6, 2, 4), (40, 8, 16), (40, 8, 3),
                                         (32, 8, 16), (24, 8, 3), (7, 7, 2),
                                         (14, 2, 4), (6, 2, 1)])
def test_tp_head_pad_and_layout_match_jax(monkeypatch, heads, kv, tp):
    over = {"n_heads": heads, "n_kv_heads": kv, "d_model": heads * 16}
    jcfg = jget("llama3.2-3b").reduced(**over)
    tcfg = tget("llama3.2-3b").reduced(**over)
    monkeypatch.setattr(jcommon, "_current_mesh",
                        lambda: _FakeMesh({"data": 2, "model": tp}))
    pad = jattn.tp_head_pad(jcfg)
    assert tattn.tp_head_pad(tcfg, {"data": 2, "model": tp}) == pad
    ids = jnp.arange(1, heads + 1, dtype=jnp.float32).reshape(1, 1, heads, 1)
    want = np.asarray(jattn._pad_heads(ids, pad, kv))[0, 0, :, 0] - 1
    np.testing.assert_array_equal(tattn.padded_heads(tcfg, pad).numpy(),
                                  want.astype(np.int64))


@pytest.mark.parametrize("shape,batch,smax", [
    ({"data": 2, "model": 4}, 8, 32), ({"data": 2, "model": 4}, 8, 30),
    ({"data": 2, "model": 4}, 3, 32), ({"pod": 2, "data": 2, "model": 2},
                                       8, 32),
    ({"data": 8, "model": 1}, 8, 32), ({"data": 8}, 8, 32)])
def test_splitk_ok_matches_jax(shape, batch, smax):
    jcfg = _jcfg(*TRAIN)
    tcfg = tget(TRAIN[0]).reduced(dtype=torch.float32, **TRAIN[1])
    assert tattn.splitk_ok(tcfg, shape, batch, smax) == jattn.splitk_ok(
        jcfg, _FakeMesh(shape), batch, smax)
    assert not tattn.splitk_ok(tcfg, None, batch, smax)
