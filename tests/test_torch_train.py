"""The port's training path against the JAX package, on the CPU.

The reduced ``llama3.2-3b`` config in fp32 with ``n_kv_heads=2`` (so the
GQA repeat is exercised).  Params and train states come from the JAX
package's ``init_params`` / ``init_train_state`` and cross through numpy
(``params_from_numpy``, ``train_state_from_numpy``); batches, gradients
and optimizer states are made with numpy from a seed and fed to both.
On the CPU ``gqa_train`` takes the chunked path, as the JAX package does
off the TPU.  Tolerances: activations, logits and losses 1e-5; gradients
rtol 1e-4, atol 1e-6 (an embedding-gradient entry near 3e-4 is a sum of
terms near 0.3 that cancel, so fp32 summation order alone moves it by
~8e-7); AdamW 1e-6; three loop steps 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.configs.registry import get_config as jget
from repro.data import pipeline as jpipe
from repro.ft import failures as jft
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models.common import init_params as jinit
from repro.optim import adamw as jadamw
from repro.optim import schedule as jsched
from repro.optim.grad_accum import accumulated_value_and_grad as jaccum
from repro.train import loop as jloop
from repro.train import state as jstate
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy, train_state_from_numpy
from repro_torch.data import pipeline as tpipe
from repro_torch.ft import failures as tft
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models.registry import get_api
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedule as tsched
from repro_torch.optim.grad_accum import (accumulated_value_and_grad,
                                          value_and_grad)
from repro_torch.train import loop as tloop
from repro_torch.train import state as tstate
from repro_torch.tree import leaves

B, S = 2, 32
GRAD_ATOL = 1e-6


def _cfgs(**over):
    jcfg = jget("llama3.2-3b").reduced(dtype=jnp.float32, n_kv_heads=2,
                                       **over)
    tcfg = tget("llama3.2-3b").reduced(dtype=torch.float32, n_kv_heads=2,
                                       **over)
    return jcfg, tcfg


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(seed=0, **over):
    jcfg, tcfg = _cfgs(**over)
    jp = jinit(jlm.param_specs(jcfg), jax.random.key(seed))
    return jcfg, tcfg, jp, params_from_numpy(_np(jp), "cpu", torch.float32)


def _batch(vocab, b=B, s=S, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (b, s)).astype(np.int32)
            for k in ("tokens", "labels")}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _stacked(tgrads):
    """Per-layer grads (split_layers form) stacked back to the JAX layout."""
    blocks = tgrads["blocks"]
    if isinstance(blocks, list):
        blocks = jax.tree.map(lambda *xs: torch.stack(xs), *blocks)
    return {**tgrads, "blocks": blocks}


def _assert_tree_close(ttree, jtree, **tol):
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert len(flat) == len(leaves(ttree))
    for path, jleaf in flat:
        t = ttree
        for key in path:
            t = t[key.key]
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(jleaf),
                                   err_msg=jax.tree_util.keystr(path), **tol)


@pytest.mark.parametrize("s", [32, 24])
def test_gqa_train_matches_jax(s):
    """S=32: two 16-row query chunks; S=24: unchunked (24 % 16 != 0)."""
    jcfg, tcfg = _cfgs()
    jp = jinit(jattn.gqa_param_specs(jcfg), jax.random.key(3))
    tp = params_from_numpy(_np(jp), "cpu", torch.float32)
    x = np.random.default_rng(s).standard_normal(
        (B, s, jcfg.d_model)).astype(np.float32)
    want = jattn.gqa_train(jnp.asarray(x), jp, jcfg)
    got = tattn.gqa_train(torch.from_numpy(x), tp, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_forward_and_train_loss_match_jax():
    jcfg, tcfg, jp, tp = _models()
    batch = _batch(jcfg.vocab)
    jlogits, _ = jlm.forward(jp, _jbatch(batch), jcfg)
    api = get_api(tcfg)
    with torch.no_grad():
        tlogits, aux = api.forward(tp, _tbatch(batch), tcfg)
        tloss = api.train_loss(tp, _tbatch(batch), tcfg)
    assert tuple(tlogits.shape) == (B, S, jcfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=1e-5)
    jloss = jlm.train_loss(jp, _jbatch(batch), jcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5,
                               rtol=1e-5)


def test_train_loss_with_mask_matches_jax():
    jcfg, tcfg, jp, tp = _models(seed=4)
    batch = _batch(jcfg.vocab, seed=4)
    batch["loss_mask"] = (np.random.default_rng(5).random((B, S)) < 0.6
                          ).astype(np.float32)
    jloss = jlm.train_loss(jp, _jbatch(batch), jcfg)
    with torch.no_grad():
        tloss = tlm.train_loss(tp, _tbatch(batch), tcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("remat,split", [(False, False), (False, True),
                                         (True, True)])
def test_train_loss_gradient_matches_jax(remat, split):
    """value_and_grad on the stacked params and on per-layer views, with
    and without per-layer rematerialisation, against jax.value_and_grad."""
    jcfg, tcfg, jp, tp = _models(seed=1, remat=remat)
    batch = _batch(jcfg.vocab, seed=1)
    jloss, jgrads = jax.value_and_grad(jlm.train_loss)(jp, _jbatch(batch),
                                                       jcfg)
    params = tstate.split_layers(tp) if split else tp
    tloss, tgrads = value_and_grad(
        lambda p, b: tlm.train_loss(p, b, tcfg))(params, _tbatch(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5,
                               rtol=1e-5)
    _assert_tree_close(_stacked(tgrads), jgrads, rtol=1e-4, atol=GRAD_ATOL)


def _opt_inputs(seed):
    jcfg, _ = _cfgs()
    rng = np.random.default_rng(seed)
    specs = jlm.param_specs(jcfg)
    shapes = jax.tree.map(lambda s: s.shape, specs,
                          is_leaf=lambda x: hasattr(x, "axes"))
    draw = lambda scale: jax.tree.map(
        lambda sh: (scale * rng.standard_normal(sh)).astype(np.float32),
        shapes, is_leaf=lambda x: isinstance(x, tuple))
    return draw(0.1), draw(1.0), draw(0.01), jax.tree.map(np.abs, draw(1e-3))


def _torch_tree(tree):
    return params_from_numpy(tree, "cpu", torch.float32)


@pytest.mark.parametrize("grad_clip,step,lr", [(1.0, 0, None),
                                               (0.0, 6, None),
                                               (1.0, 3, 1.5e-4)])
def test_adamw_update_matches_jax(grad_clip, step, lr):
    params, grads, m, v = _opt_inputs(seed=step)
    cfg_kw = dict(lr=3e-4, grad_clip=grad_clip)
    jp, jst, jm = jadamw.adamw_update(
        jadamw.AdamWConfig(**cfg_kw), jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, grads),
        jadamw.AdamWState(jnp.int32(step), jax.tree.map(jnp.asarray, m),
                          jax.tree.map(jnp.asarray, v)),
        None if lr is None else jnp.float32(lr))
    tp, tg, tm, tv = (_torch_tree(t) for t in (params, grads, m, v))
    tlr = None if lr is None else torch.tensor(lr, dtype=torch.float32)
    out_p, tst, tmet = tadamw.adamw_update(
        tadamw.AdamWConfig(**cfg_kw), tp, tg,
        tadamw.AdamWState(torch.tensor(step, dtype=torch.int32), tm, tv), tlr)
    assert out_p is tp and tst.m is tm and tst.v is tv   # in place
    assert int(tst.step) == step + 1
    for got, want in ((out_p, jp), (tst.m, jst.m), (tst.v, jst.v)):
        _assert_tree_close(got, want, atol=1e-6, rtol=1e-6)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[k]), float(jm[k]), rtol=1e-6)


def test_adamw_init_and_clip_match_jax():
    params, grads, _, _ = _opt_inputs(seed=9)
    st = tadamw.adamw_init(_torch_tree(params))
    assert int(st.step) == 0 and st.step.dtype == torch.int32
    assert all(bool((x == 0).all()) and x.dtype == torch.float32
               for x in leaves(st.m) + leaves(st.v))
    jclip, jnorm = jadamw.clip_by_global_norm(
        jax.tree.map(jnp.asarray, grads), 0.5)
    tclip, tnorm = tadamw.clip_by_global_norm(_torch_tree(grads), 0.5)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    _assert_tree_close(tclip, jclip, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("warmup,total", [(10, 50), (0, 20), (5, 5)])
def test_warmup_cosine_matches_jax(warmup, total):
    jf = jsched.warmup_cosine(3e-4, warmup, total)
    tf = tsched.warmup_cosine(3e-4, warmup, total)
    for step in range(total + 3):
        want = float(jf(jnp.int32(step)))
        np.testing.assert_allclose(
            float(tf(torch.tensor(step, dtype=torch.int32))), want,
            rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(float(tf(step)), want, rtol=1e-6,
                                   atol=1e-12)
    assert float(tsched.constant(1e-3)(torch.tensor(4))) == \
        float(jsched.constant(1e-3)(jnp.int32(4)))


def test_accumulated_value_and_grad_matches_jax():
    jcfg, tcfg, jp, tp = _models(seed=2)
    micros = [_batch(jcfg.vocab, seed=20 + g) for g in range(2)]
    stacked = {k: np.stack([m[k] for m in micros]) for k in micros[0]}
    jl, jg = jaccum(lambda p, b: jlm.train_loss(p, b, jcfg), 2)(
        jp, _jbatch(stacked))
    tl, tg = accumulated_value_and_grad(
        lambda p, b: tlm.train_loss(p, b, tcfg), 2)(
        tstate.split_layers(tp), _tbatch(stacked))
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-5, rtol=1e-5)
    _assert_tree_close(_stacked(tg), jg, rtol=1e-4, atol=GRAD_ATOL)


@pytest.mark.parametrize("seed,step,hosts", [(17, 0, 1), (17, 5, 1),
                                             (3, 2, 2)])
def test_host_batch_is_exactly_jax(seed, step, hosts):
    jcfg, tcfg = _cfgs()
    for host in range(hosts):
        want = jpipe.host_batch(jcfg, JShape("t", 48, 4, "train"),
                                jpipe.HostDataConfig(seed, hosts, host), step)
        got = tpipe.host_batch(tcfg, TShape("t", 48, 4, "train"),
                               tpipe.HostDataConfig(seed, hosts, host), step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_failure_monitors_match_jax():
    now = [0.0]
    clock = lambda: now[0]
    jhb, thb = (m.HeartbeatMonitor(3, 10.0, clock) for m in (jft, tft))
    jst, tst = (m.StragglerDetector(window=8, min_samples=2)
                for m in (jft, tft))
    for step in range(6):
        now[0] += 4.0
        for hb in (jhb, thb):
            hb.beat(0)
            hb.beat(1)
        for det in (jst, tst):
            det.record(0, 1.0)
            det.record(1, 1.1)
            det.record(2, 3.0)
        assert [dataclasses.astuple(e) for e in thb.check(step)] == \
            [dataclasses.astuple(e) for e in jhb.check(step)]
        assert [dataclasses.astuple(e) for e in tst.check(step)] == \
            [dataclasses.astuple(e) for e in jst.check(step)]
    assert thb.alive == jhb.alive == [0, 1]


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_loop_losses_match_jax(grad_accum):
    """Three steps of TrainLoop, same initial state and data: the port's
    losses within 1e-4 of the JAX loop's."""
    jcfg, tcfg = _cfgs()
    steps, seq, batch = 3, 32, 4
    j0 = jstate.init_train_state(jcfg, jax.random.key(0))
    t0 = train_state_from_numpy(_np(j0), "cpu")
    opt = dict(lr=1e-3, grad_clip=1.0)
    jstep = jax.jit(jstate.build_train_step(
        jcfg, jadamw.AdamWConfig(**opt),
        lr_schedule=jsched.warmup_cosine(1e-3, 1, steps),
        grad_accum=grad_accum))
    tstep = tstate.build_train_step(
        tcfg, tadamw.AdamWConfig(**opt),
        lr_schedule=tsched.warmup_cosine(1e-3, 1, steps),
        grad_accum=grad_accum)
    logs = []
    for mod, cfg, shp, step_fn, st in (
            (jloop, jcfg, JShape("t", seq, batch, "train"), jstep, j0),
            (tloop, tcfg, TShape("t", seq, batch, "train"), tstep, t0)):
        loop = mod.TrainLoop(cfg, shp, mod.LoopConfig(
            total_steps=steps, log_every=1, grad_accum=grad_accum, seed=5),
            step_fn, st)
        loop.run()
        logs.append(loop.metrics_log)
    jlog, tlog = logs
    assert [m["step"] for m in tlog] == [1, 2, 3]
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose([m[key] for m in tlog],
                                   [m[key] for m in jlog], rtol=1e-4,
                                   atol=1e-4)
    assert int(loop.state["step"]) == steps


def test_train_state_specs_and_init():
    _, tcfg = _cfgs()
    st = tstate.init_train_state(tcfg, torch.Generator().manual_seed(0))
    assert set(st) == {"params", "m", "v", "step"}
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    assert all(p.dtype == torch.float32 for p in leaves(st["params"]))
    assert [tuple(p.shape) for p in leaves(st["params"])] == \
        [tuple(m.shape) for m in leaves(st["m"])]
    split = tstate.split_layers(st["params"])
    assert len(split["blocks"]) == tcfg.n_layers
    wq = split["blocks"][1]["attn"]["wq"]
    assert wq.data_ptr() == st["params"]["blocks"]["attn"]["wq"][1].data_ptr()


def test_unported_modes_raise_with_roadmap_item():
    """Pod compression without a pod mesh is refused, as in the JAX
    package: the step builder (JAX: an assertion) and, on one process, the
    CLI with the JAX CLI's own exit message."""
    jcfg, tcfg = _cfgs()
    with pytest.raises(AssertionError):
        jstate.build_train_step(jcfg, jadamw.AdamWConfig(),
                                pod_compressed=True)
    with pytest.raises(ValueError, match="needs a mesh with a 'pod' axis"):
        tstate.build_train_step(tcfg, tadamw.AdamWConfig(),
                                pod_compressed=True)
    from repro.launch import train as jlaunch
    with pytest.raises(SystemExit) as jexit:
        jlaunch.main(["--reduced", "--steps", "1", "--pod-compressed"])
    with pytest.raises(SystemExit) as texit:
        tlaunch.main(["--reduced", "--device", "cpu", "--steps", "1",
                      "--pod-compressed"])
    assert str(texit.value) == str(jexit.value) == \
        "--pod-compressed needs a multi-pod device mesh"


def test_train_cli_on_cpu(capsys):
    assert tlaunch.main(["--reduced", "--device", "cpu", "--steps", "2",
                         "--seq", "16", "--batch", "2"]) == 0
    out = capsys.readouterr().out
    assert "step     2" in out and "tok/s" in out
