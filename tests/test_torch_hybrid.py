"""The port's zamba2 hybrid (Mamba-2 groups + a weight-shared attention and
MLP block with a per-group LoRA delta on ``wq``) against the JAX package.

Two reduced fp32 configs: ``reduced()`` (8 layers in 4 groups of 2, no
tail) and ``reduced(n_layers=5)`` (2 groups and a tail of 1, as the
published 38 = 6 x 6 + 2 has a tail), with ``lora_b`` drawn random so the
delta matters.  ``hybrid_layout`` and every spec equal the JAX ones
exactly; ``hybrid_forward`` and ``hybrid_train_loss`` at S = 13 and 32
within 2e-5 and every gradient within 1e-4 of ``jax.grad``;
``hybrid_decode_step`` with a 0-d and a (B,) index and ``prefill_chunk``
with ``nvalid`` < C within 1e-5 (``h``, ``conv``, ``k``, ``v``); the
port's prefill ``torch.equal`` to its per-token loop; bucket padding
inert; the shared parameters never written."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.models import hybrid as jhybrid
from repro_torch.configs.registry import get_config as tget
from repro_torch.models import hybrid as thybrid
from repro_torch.tree import leaves, map_tree
from test_torch_ssm import (assert_grads_close, assert_same_specs,
                            bucket_padding_inert, close, decode_steps,
                            lm_batch, loss_and_grads, prefill_equals_loop,
                            prefill_vs_jax, ssm_model, tbatch)

ARCH = "zamba2-1.2b"
#: the two layouts: no tail (8 = 4 x 2) and a tail (5 = 2 x 2 + 1)
LAYOUTS = {"no tail": {}, "tail": {"n_layers": 5}}


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def hyb(request):
    return ssm_model(ARCH, **LAYOUTS[request.param])


@pytest.mark.parametrize("over", [None, {}, {"n_layers": 5},
                                  {"n_layers": 7}], ids=str)
def test_layout_and_specs_equal_jax(over):
    jcfg, tcfg = jget(ARCH), tget(ARCH)
    if over is not None:
        jcfg = jcfg.reduced(dtype=jnp.float32, **over)
        tcfg = tcfg.reduced(dtype=torch.float32, **over)
    assert thybrid.hybrid_layout(tcfg) == jhybrid.hybrid_layout(jcfg)
    if over is None:
        assert thybrid.hybrid_layout(tcfg) == (6, 2)
    assert_same_specs(thybrid.hybrid_param_specs(tcfg),
                      jhybrid.hybrid_param_specs(jcfg))
    assert_same_specs(thybrid.hybrid_decode_state_specs(tcfg, 3, 64),
                      jhybrid.hybrid_decode_state_specs(jcfg, 3, 64))


def test_published_state_bytes():
    """141,472,256 B a slot at max_seq 2048: 38 layers of fp32 h (64 x 64
    x 64) and bf16 conv (3 x 4224), and 6 groups of bf16 k and v (2048 x
    32 x 64)."""
    from repro_torch.serve.cache import state_bytes
    cfg = tget(ARCH)
    assert state_bytes(thybrid.hybrid_decode_state_specs(cfg, 1, 2048)) \
        == 141_472_256


@pytest.mark.parametrize("s", [13, 32])
def test_hybrid_forward_within_2e5(hyb, s):
    jcfg, tcfg, jp, tp = hyb
    batch = lm_batch(jcfg, s, 1)
    j = jax.jit(lambda p, b: jhybrid.hybrid_forward(p, b, jcfg))(
        jp, {"tokens": jnp.asarray(batch["tokens"])})
    t, aux = thybrid.hybrid_forward(tp, tbatch(batch), tcfg)
    close(t, j, 2e-5)
    assert aux.shape == () and float(aux) == 0.0


@pytest.mark.parametrize("s", [13, 32])
def test_hybrid_train_loss_and_grads_match_jax(hyb, s):
    jl, jg, tl, tg = loss_and_grads(hyb, s)
    close(tl, jl, 2e-5)
    assert_grads_close(tg, jg, 1e-4)
    # the LoRA factors and the shared block get gradients
    assert tg["lora_a"].abs().sum() > 0 and tg["lora_b"].abs().sum() > 0


def test_hybrid_remat_keeps_loss_and_grads(hyb):
    _, tcfg, _, tp = hyb
    batch = tbatch(lm_batch(tcfg, 16, 2))
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        p = map_tree(lambda a: a.clone().requires_grad_(True), tp)
        loss = thybrid.hybrid_train_loss(p, batch, cfg)
        loss.backward()
        out.append((loss.detach(), leaves(map_tree(lambda a: a.grad, p))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("index_kind", ["scalar", "vector"])
def test_hybrid_decode_step_within_1e5(hyb, index_kind):
    decode_steps(hyb, index_kind)


@pytest.mark.parametrize("nvalid", [3, 8])
def test_hybrid_prefill_chunk_within_1e5(hyb, nvalid):
    prefill_vs_jax(hyb, nvalid=nvalid)


def test_hybrid_prefill_equals_per_token_loop(hyb):
    prefill_equals_loop(hyb)


def test_hybrid_bucket_padding_is_inert(hyb):
    bucket_padding_inert(hyb)


def test_lora_delta_never_touches_the_shared_weights(hyb):
    """Every group's delta is a new tensor: after a forward, a backward and
    decode steps the shared parameters are as they were, and a group's
    ``wq`` differs from the shared one by its own delta."""
    _, tcfg, _, tp = hyb
    before = map_tree(lambda a: a.clone(), tp)
    p = map_tree(lambda a: a.clone().requires_grad_(True), tp)
    thybrid.hybrid_train_loss(p, tbatch(lm_batch(tcfg, 13, 0)), tcfg).backward()
    state = map_tree(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                     thybrid.hybrid_decode_state_specs(tcfg, 2, 8))
    for i in range(3):
        thybrid.hybrid_decode_step(
            tp, state, {"tokens": torch.tensor([[1], [2]]),
                        "index": torch.tensor(i)}, tcfg)
    for a, b in zip(leaves(tp), leaves(before)):
        assert torch.equal(a, b)
    for a, b in zip(leaves(p), leaves(before)):
        assert torch.equal(a.detach(), b)
    for g in range(thybrid.hybrid_layout(tcfg)[0]):
        wq = thybrid._lora_attn(tp, g)["wq"]
        assert wq is not tp["shared"]["attn"]["wq"]
        torch.testing.assert_close(
            wq - tp["shared"]["attn"]["wq"],
            tp["lora_a"][g] @ tp["lora_b"][g], rtol=1e-5, atol=1e-6)
