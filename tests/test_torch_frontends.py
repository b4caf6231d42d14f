"""The modality frontends of the port against the JAX package, on the CPU.

Reduced fp32 ``internvl2-26b`` (a vision stub: 8 projected patch
embeddings before the text, the loss on the text positions only) and
``hubert-xlarge`` (an audio stub: projected frames, no token embedding,
non-causal attention, encoder-only), params from the JAX package's
``init_params`` through ``params_from_numpy``, batches from numpy.
``embed_inputs``, ``forward``, ``train_loss`` and every gradient agree with
the JAX package's within 1e-5.  The encoder-only model trains through the
CLI, checkpoints and resumes, and the serve entry points refuse it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.configs.registry import get_config as jget
from repro.data import pipeline as jpipe
from repro.launch.inputs import batch_spec_shapes as jspec
from repro.models import lm as jlm
from repro.models.common import init_params as jinit
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.launch.inputs import batch_spec_shapes as tspec
from repro_torch.models import lm as tlm
from repro_torch.models.registry import get_api
from repro_torch.optim.grad_accum import value_and_grad
from repro_torch.serve import ServeEngine
from repro_torch.train.state import split_layers

ARCHS = ["internvl2-26b", "hubert-xlarge"]
B, S = 2, 24
TOL = dict(rtol=1e-5, atol=1e-5)


def _models(arch, seed=0):
    jcfg = jget(arch).reduced(dtype=jnp.float32)
    tcfg = tget(arch).reduced(dtype=torch.float32)
    jp = jinit(jlm.param_specs(jcfg), jax.random.key(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           torch.float32)
    return jcfg, tcfg, jp, tp


def _batch(cfg, seed=0):
    """A train batch of ``cfg``'s frontend, from numpy."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_stub":
        return {"frames": rng.standard_normal(
                    (B, S, cfg.frontend_dim)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    text = S - cfg.n_frontend_tokens
    return {"vision_embeds": rng.standard_normal(
                (B, cfg.n_frontend_tokens, cfg.frontend_dim)
            ).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab, (B, text)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, text)).astype(np.int32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_reduced_frontend_configs():
    v = tget("internvl2-26b").reduced(dtype=torch.float32)
    a = tget("hubert-xlarge").reduced(dtype=torch.float32)
    assert (v.frontend, v.n_frontend_tokens, v.frontend_dim) == \
        ("vision_stub", 8, 32)
    assert (a.frontend, a.causal, a.encoder_only) == ("audio_stub", False,
                                                      True)


@pytest.mark.parametrize("arch", ARCHS)
def test_embed_inputs_matches_jax(arch):
    jcfg, tcfg, jp, tp = _models(arch)
    batch = _batch(jcfg)
    want = jlm.embed_inputs(jp, _j(batch), jcfg, None)
    got = tlm.embed_inputs(tp, _t(batch), tcfg)
    assert tuple(got.shape) == (B, S, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_vision_embeds_come_first():
    _, tcfg, _, tp = _models("internvl2-26b")
    batch = _t(_batch(tcfg))
    x = tlm.embed_inputs(tp, batch, tcfg)
    nft = tcfg.n_frontend_tokens
    assert torch.equal(x[:, :nft],
                       batch["vision_embeds"] @ tp["frontend_proj"])
    assert torch.equal(x[:, nft:], tp["embed"][batch["tokens"].long()])
    # without vision embeds the model is the text decoder
    text = tlm.embed_inputs(tp, {"tokens": batch["tokens"]}, tcfg)
    assert torch.equal(text, x[:, nft:])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_train_loss_match_jax(arch):
    jcfg, tcfg, jp, tp = _models(arch, seed=1)
    batch = _batch(jcfg, seed=1)
    jlogits, jaux = jlm.forward(jp, _j(batch), jcfg)
    with torch.no_grad():
        tlogits, taux = tlm.forward(tp, _t(batch), tcfg)
        tloss = tlm.train_loss(tp, _t(batch), tcfg)
    assert tuple(tlogits.shape) == (B, S, tcfg.vocab)
    assert float(taux) == float(jaux) == 0.0
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    jloss = jlm.train_loss(jp, _j(batch), jcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)


def test_vlm_loss_is_on_the_text_positions():
    _, tcfg, _, tp = _models("internvl2-26b", seed=2)
    batch = _t(_batch(tcfg, seed=2))
    nft = tcfg.n_frontend_tokens
    with torch.no_grad():
        logits, _ = tlm.forward(tp, batch, tcfg)
        loss = tlm.train_loss(tp, batch, tcfg)
        want = torch.nn.functional.cross_entropy(
            logits[:, nft:].reshape(-1, tcfg.vocab),
            batch["labels"].long().reshape(-1))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)


def test_audio_encoder_attends_both_ways():
    """Non-causal: the first position's logits move with the last frame."""
    _, tcfg, _, tp = _models("hubert-xlarge", seed=3)
    batch = _t(_batch(tcfg, seed=3))
    moved = dict(batch, frames=batch["frames"].clone())
    moved["frames"][:, -1] += 1.0
    with torch.no_grad():
        a, _ = tlm.forward(tp, batch, tcfg)
        b, _ = tlm.forward(tp, moved, tcfg)
    assert not torch.allclose(a[:, 0], b[:, 0])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("split", [False, True])
def test_train_loss_gradient_matches_jax(arch, split):
    jcfg, tcfg, jp, tp = _models(arch, seed=4)
    batch = _batch(jcfg, seed=4)
    jloss, jgrads = jax.value_and_grad(jlm.train_loss)(jp, _j(batch), jcfg)
    params = split_layers(tp) if split else tp
    tloss, tgrads = value_and_grad(
        lambda p, b: tlm.train_loss(p, b, tcfg))(params, _t(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    if split:
        blocks = tgrads["blocks"]
        tgrads = {**tgrads, "blocks": jax.tree.map(
            lambda *xs: torch.stack(xs), *blocks)}
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    got = dict(tckpt.flatten_with_paths(tgrads))
    assert len(flat) == len(got)
    for path, g in flat:
        key = jax.tree_util.keystr(path)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(g),
                                   err_msg=key, **TOL)
    if arch == "hubert-xlarge":
        # no token embedding: its gradient is zero, as in JAX
        assert not got["['embed']"].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_and_host_batches_equal_jax(arch):
    jcfg = jget(arch).reduced(dtype=jnp.float32)
    tcfg = tget(arch).reduced(dtype=torch.float32)
    for kind in ("train", "prefill"):
        js = jspec(jcfg, JShape("t", S, B, kind))
        ts = tspec(tcfg, TShape("t", S, B, kind))
        assert list(js) == list(ts)
        for k in js:
            assert js[k][0] == ts[k][0]
            assert str(jnp.dtype(js[k][1])) == \
                str(ts[k][1]).removeprefix("torch.")
    for step in (0, 3):
        want = jpipe.host_batch(jcfg, JShape("t", S, B, "train"),
                                jpipe.HostDataConfig(5, 2, 1), step)
        got = tpipe.host_batch(tcfg, TShape("t", S, B, "train"),
                               tpipe.HostDataConfig(5, 2, 1), step)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and \
                got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k])


def test_get_api_of_the_frontend_families():
    audio = get_api(tget("hubert-xlarge"))
    assert (audio.decode_state_specs, audio.decode_step,
            audio.prefill_chunk, audio.verify_chunk, audio.verify_tree,
            audio.draft_head_specs) == (None,) * 6
    vision = get_api(tget("internvl2-26b"))
    assert vision.decode_step is tlm.decode_step
    assert vision.train_loss is audio.train_loss is tlm.train_loss


def test_serve_entry_points_refuse_the_encoder():
    cfg = tget("hubert-xlarge").reduced(dtype=torch.float32)
    _, _, _, params = _models("hubert-xlarge")
    with pytest.raises(ValueError, match="encoder-only"):
        ServeEngine(cfg, params, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        tserve.generate(cfg, params, np.zeros((1, 4), np.int64), 2,
                        device="cpu")
    with pytest.raises(SystemExit, match="encoder-only"):
        tserve.main(["--arch", "hubert-xlarge", "--reduced", "--device",
                     "cpu"])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_checkpoints_and_resumes(arch, tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--seq", "16",
            "--batch", "2", "--ckpt-dir", d, "--ckpt-every", "2"]
    assert tlaunch.main(argv + ["--steps", "3"]) == 0
    first = capsys.readouterr().out
    assert "step     3" in first and "resumed" not in first
    assert tckpt.latest_step(d) == 3
    assert tlaunch.main(argv + ["--steps", "5"]) == 0
    second = capsys.readouterr().out
    assert "resumed from step 3" in second
    assert "step     4" in second and "step     3 " not in second
    assert "trained 2 steps" in second
    assert tckpt.latest_step(d) == 5
