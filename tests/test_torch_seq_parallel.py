"""The sequence-parallel layout's pieces, without a spawn.

* ``model_split_dim`` against the JAX package's ``logical_to_pspec``: the
  residual stream's (``("batch", "seq_sp", None)``) and the logits'
  (``LOGIT_AXES``) ``model`` dim over a grid of sequence lengths, vocab
  sizes and ``model`` sizes, on (data, model) and (pod, data, model)
  meshes; the stream's sequence splits exactly where the logits' does.
* ``vocab_parallel_cross_entropy`` on 2 and 3 ranks (threads of one
  process joined by an in-memory transport, ``_torch_dist.ThreadMesh``),
  each holding its columns of the logits: the loss equals
  ``cross_entropy_loss`` of the whole logits, with and without a loss
  mask, and each rank's gradient is its columns of the whole gradient.
* Under expert parallelism an MoE layer's expert leaves reach the layer
  as the rank's experts: a ``ShardedLayer`` with the train step's ``keep``
  hands ``all_gather`` the blocks' bytes once (over ``data``) where the
  whole leaves cost the blocks' bytes times (1 + data), as the shapes
  reckon it, counted by the ``Transport``.
* ``rope_angles`` does not go through ``torch.sin`` / ``torch.cos``: on
  the CPU those are MKL's ``vmsSin`` / ``vmsCos`` over parallel chunks,
  and a process's first such call, raced by two threads, returned one
  chunk with errors up to 1.5e-4 (phase X5's wrong logits).  The test
  makes those functions return that fault on every call; the tables stay
  within an ulp of float64's.
"""
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.registry import get_config as jget
from repro.models.common import logical_to_pspec as jpspec
from repro_torch.configs.registry import get_config as tget
from repro_torch.models import moe
from repro_torch.models.common import (LOGIT_AXES, ShardedLayer,
                                       cross_entropy_loss, init_params,
                                       make_shardings, model_split_dim,
                                       rope_angles, shard_block,
                                       vocab_parallel_cross_entropy)
from repro_torch.train.state import _ep_keep

from _torch_dist import run_threads as _run_threads


@pytest.mark.parametrize("names", [("data", "model"),
                                   ("pod", "data", "model")])
@pytest.mark.parametrize("tp", [1, 2, 3, 4, 8])
def test_model_split_dim_matches_logical_to_pspec(tp, names):
    sizes = (2,) * (len(names) - 1) + (tp,)
    jmesh = AbstractMesh(sizes, names)
    tmesh = dict(zip(names, sizes))
    rows = int(np.prod(sizes[:-1]))
    stream = ("batch", "seq_sp", None)
    for s in (1, 2, 3, 5, 6, 8, 12, 15, 16, 24, 2047, 2048):
        for v in (96, 97, 98, 128256, 152064):
            assert ((model_split_dim(stream, (rows, s, 64), tmesh) == 1)
                    == (model_split_dim(LOGIT_AXES, (rows, s, v), tmesh)
                        == 1))
            for axes in (stream, LOGIT_AXES):
                shape = (rows, s, v if axes == LOGIT_AXES else 64)
                spec = jpspec(axes, jmesh, shape=shape)
                want = next((i for i, e in enumerate(spec)
                             if e == "model" or (isinstance(e, tuple)
                                                 and "model" in e)), None)
                if tp == 1:
                    want = None
                assert model_split_dim(axes, shape, tmesh) == want, (
                    axes, s, v, spec)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("tp", [2, 3])
def test_vocab_parallel_cross_entropy_and_its_gradient(tp, masked):
    rng = np.random.default_rng(tp)
    b, s, v = 2, 5, 12 * tp
    logits = torch.from_numpy(3 * rng.standard_normal((b, s, v))
                              .astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, v, (b, s)))
    mask = (torch.from_numpy((rng.random((b, s)) > 0.4).astype(np.float32))
            if masked else None)
    leaf = logits.clone().requires_grad_(True)
    want = cross_entropy_loss(leaf, labels, mask)
    grad, = torch.autograd.grad(want, leaf)

    def rank(mesh):
        mine = logits.chunk(tp, -1)[mesh.index("model")].clone()
        mine.requires_grad_(True)
        loss = vocab_parallel_cross_entropy(mine, labels, mask, mesh)
        g, = torch.autograd.grad(loss, mine)
        return loss.detach(), g

    for r, (loss, g) in enumerate(_run_threads({"model": tp}, rank)):
        torch.testing.assert_close(loss, want.detach(), rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(g, grad.chunk(tp, -1)[r], rtol=1e-6,
                                   atol=1e-7)


def test_ep_expert_leaves_are_gathered_over_the_batch_axes_only():
    cfg = tget("phi3.5-moe-42b-a6.6b").reduced(dtype=torch.float32,
                                                n_experts=4, use_ep=True)
    shape = {"data": 2, "model": 2}
    specs = moe.moe_param_specs(cfg)
    pspecs = make_shardings(specs, shape)
    full = init_params(specs, torch.Generator().manual_seed(0),
                       torch.device("cpu"))

    def rank(mesh):
        blocks = {k: shard_block(t, pspecs[k], mesh).clone()
                  for k, t in full.items()}
        keep = _ep_keep({"ffn": blocks}, cfg, mesh, 1)["ffn"]
        out = {}
        for name, kp in (("whole", None), ("ep", keep)):
            mesh.transport.reset()
            got = ShardedLayer(blocks, pspecs, mesh, kp).gather()
            out[name] = (dict(mesh.transport.bytes),
                         {k: tuple(t.shape) for k, t in got.items()})
        return blocks, out

    for blocks, out in _run_threads(shape, rank):
        block_bytes = sum(t.numel() * 4 for t in blocks.values())
        # whole: each leaf gathered over data, then the result over model
        assert out["whole"][0] == {"all_gather": 3 * block_bytes}
        # EP: over data alone; the experts stay the rank's two of four
        assert out["ep"][0] == {"all_gather": block_bytes}
        assert out["ep"][1] == {
            "router": (cfg.d_model, 2), "w1": (2, cfg.d_model, cfg.d_ff),
            "w3": (2, cfg.d_model, cfg.d_ff),
            "w2": (2, cfg.d_ff, cfg.d_model)}
        assert out["whole"][1] == {k: tuple(t.shape)
                                   for k, t in full.items()}


def test_rope_tables_do_not_go_through_torch_sin_and_cos(monkeypatch):
    pos = torch.arange(512)
    theta, dim = jget("qwen2.5-14b").rope_theta, 16
    # the float32 angles rope_angles takes the sine and cosine of
    inv = 1.0 / torch.pow(theta, torch.arange(0, dim, 2,
                                              dtype=torch.float32) / dim)
    ang = (pos.float()[:, None] * inv).double()
    real_sin, real_cos = torch.sin, torch.cos

    def raced(fn):
        # what the raced first call of MKL's vmsSin returned: the first
        # parallel chunk's values off by up to 1.5e-4
        def bad(x, *a, **k):
            out = fn(x, *a, **k)
            if out.dtype == torch.float32 and out.numel() > 1:
                out = out.clone()
                out.view(-1)[:out.numel() // 2] += 1.5e-4
            return out
        return bad
    monkeypatch.setattr(torch, "sin", raced(real_sin))
    monkeypatch.setattr(torch, "cos", raced(real_cos))
    sin, cos = rope_angles(pos, dim, theta)
    monkeypatch.undo()
    for got, want in ((sin, real_sin(ang)), (cos, real_cos(ang))):
        ulp = torch.finfo(torch.float32).eps * want.abs().clamp_min(1e-30)
        assert bool(((got.double() - want).abs() <= ulp).all()), float(
            (got.double() - want).abs().max())
