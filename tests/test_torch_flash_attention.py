"""Flash attention of the port (plain versions and their autograd) against
the JAX package.

Inputs are made with numpy from a seed and fed to both packages.  The
forward is held against the Pallas kernel run as the JAX package's own
tests run it on the CPU (``interpret=True``) and against the materialised
oracle ``flash_attention_ref``, at the shapes of ``tests/test_kernels.py``
and its non-causal block case; tolerances are the reference's own (2e-5
fp32, 2e-2 bf16).

``flash_attention_pallas`` has no VJP (``jax.grad`` through it in
interpret mode raises), so the gradients are held against ``jax.vjp`` of
``flash_attention_ref``, the function the kernel computes, with rtol 1e-4
and atol 1e-5 (entries that are exactly 0 in JAX, such as dq of a causal
row that sees one key, come out near 1e-7 here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ref import flash_attention_ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref as tref

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# (b, s, hq, hkv, hd, dtype): tests/test_kernels.py:124-129
KERNEL_SHAPES = [
    (2, 256, 4, 2, 64, "float32"),      # GQA rep=2
    (1, 128, 8, 8, 128, "float32"),     # MHA, aligned head dim
    (2, 256, 6, 2, 80, "bfloat16"),     # rep=3, head dim 80
    (1, 512, 4, 1, 128, "float32"),     # MQA, multi-block q and k
]
# gradient shapes: fp32, incl. a ragged length and the reduced model's hd
GRAD_SHAPES = [
    (2, 256, 4, 2, 64, True),
    (1, 128, 8, 8, 128, True),
    (2, 64, 6, 2, 80, True),
    (2, 37, 4, 2, 16, True),
    (1, 96, 2, 2, 64, False),
]


def _inputs(b, s, hq, hkv, hd, seed, n=3):
    rng = np.random.default_rng(seed)
    shapes = [(b, s, hq, hd), (b, s, hkv, hd), (b, s, hkv, hd),
              (b, s, hq, hd)][:n]
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes]


def _both(arrs, dtype):
    jdt, tdt = DT[dtype]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,s,hq,hkv,hd,dtype", KERNEL_SHAPES)
def test_plain_forward_matches_pallas_and_ref(b, s, hq, hkv, hd, dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(b, s, hq, hkv, hd, s + hd),
                                       dtype)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    o, lse = tfa.flash_attention_plain(tq, tk, tv, causal=True)
    assert o.dtype == tq.dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == (b, hq, s)
    pallas = flash_attention_pallas(jq, jk, jv, causal=True, interpret=True)
    for want in (pallas, jref(jq, jk, jv, causal=True)):
        np.testing.assert_allclose(_f32(o), _f32(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(tref(tq, tk, tv, causal=True)),
                               _f32(jref(jq, jk, jv, causal=True)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("block_q,block_k", [(64, 128), (128, 64),
                                             (256, 256)])
def test_plain_forward_non_causal_matches_pallas_blocks(block_q, block_k):
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(1, 256, 2, 2, 64, 7),
                                       "float32")
    o, _ = tfa.flash_attention_plain(tq, tk, tv, causal=False)
    pallas = flash_attention_pallas(jq, jk, jv, causal=False,
                                    block_q=block_q, block_k=block_k,
                                    interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(pallas), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(o.numpy(),
                               np.asarray(jref(jq, jk, jv, causal=False)),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_lse_is_the_row_logsumexp(causal):
    b, s, hq, hkv, hd = 2, 48, 4, 2, 16
    (jq, jk, _), (tq, tk, tv) = _both(_inputs(b, s, hq, hkv, hd, 3),
                                      "float32")
    _, lse = tfa.flash_attention_plain(tq, tk, tv, causal=causal)
    kk = jnp.repeat(jk, hq // hkv, axis=2)
    sc = jnp.einsum("bqhd,bkhd->bhqk", jq, kk) / np.sqrt(hd)
    if causal:
        sc = jnp.where(jnp.tril(jnp.ones((s, s), bool)), sc, -1e30)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jax.nn.logsumexp(sc, axis=-1)),
                               rtol=1e-5, atol=1e-5)


def _jax_grads(arrs, causal):
    jq, jk, jv, jdo = (jnp.asarray(a) for a in arrs)
    _, vjp = jax.vjp(lambda q, k, v: jref(q, k, v, causal=causal),
                     jq, jk, jv)
    return [np.asarray(g) for g in vjp(jdo)]


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal", GRAD_SHAPES)
def test_plain_backward_matches_jax_grad_of_ref(b, s, hq, hkv, hd, causal):
    arrs = _inputs(b, s, hq, hkv, hd, 11 + s, n=4)
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    o, lse = tfa.flash_attention_plain(q, k, v, causal=causal)
    got = tfa.flash_attention_plain_bwd(q, k, v, o, lse, do, causal=causal)
    for g, want in zip(got, _jax_grads(arrs, causal)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b,s,hq,hkv,hd,causal", GRAD_SHAPES[:2] +
                         GRAD_SHAPES[3:])
def test_ops_flash_attention_autograd_on_cpu(b, s, hq, hkv, hd, causal):
    """ops.flash_attention on CPU tensors: the plain forward and the plain
    backward through autograd, equal to JAX's forward and vjp."""
    arrs = _inputs(b, s, hq, hkv, hd, 5 + hd, n=4)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs[:3])
    before = (tfa.LAUNCHES_FWD, tfa.LAUNCHES_BWD_DQ, tfa.LAUNCHES_BWD_DKV)
    out = ops.flash_attention(q, k, v, causal=causal)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(arrs[3]))
    assert (tfa.LAUNCHES_FWD, tfa.LAUNCHES_BWD_DQ,
            tfa.LAUNCHES_BWD_DKV) == before
    jq, jk, jv = (jnp.asarray(a) for a in arrs[:3])
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jref(jq, jk, jv, causal=causal)),
                               rtol=2e-5, atol=2e-5)
    for g, want in zip(grads, _jax_grads(arrs, causal)):
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-5)


def test_bound_counts():
    b, s, hq, hkv, hd = 2, 2048, 24, 8, 128
    fwd = tfa.bound_flops(b, s, hq, hd, causal=True)
    assert fwd == 2 * 2 * hd * b * hq * s * (s + 1) // 2
    assert tfa.bound_flops(b, s, hq, hd, part="bwd") == 2.5 * fwd
    assert (tfa.bound_flops(b, s, hq, hd, part="bwd_dq") +
            tfa.bound_flops(b, s, hq, hd, part="bwd_dkv")) == 2.5 * fwd
    assert tfa.bound_flops(b, s, hq, hd, causal=False) == \
        4 * hd * b * hq * s * s
    q_bytes = b * s * hq * hd * 2
    kv_bytes = b * s * hkv * hd * 2
    assert tfa.bound_bytes(b, s, hq, hkv, hd, torch.bfloat16) == \
        2 * q_bytes + 2 * kv_bytes + b * hq * s * 4
    assert (tfa.bound_bytes(b, s, hq, hkv, hd, torch.bfloat16, "bwd_dq") +
            tfa.bound_bytes(b, s, hq, hkv, hd, torch.bfloat16, "bwd_dkv")) \
        == tfa.bound_bytes(b, s, hq, hkv, hd, torch.bfloat16, "bwd")


@pytest.mark.parametrize("hd,to", [(16, 64), (32, 64), (64, 64), (80, 128),
                                   (128, 128)])
def test_bf16_backward_head_dim_padding(hd, to):
    """The bf16 backward kernels are built for head dims 64 and 128, and
    their wrappers zero-pad the others (fp32 is not padded).  The zeros
    change neither the gradients (cut back to hd) nor delta: the plain
    backward on the padded tensors, with the unpadded scale, gives the
    unpadded gradients."""
    arrs = _inputs(2, 40, 4, 2, hd, 3 + hd, n=4)
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    assert all(t is u for t, u in zip(tfa._pad_bf16(q, k), (q, k)))
    padded = tfa._pad_bf16(*(t.bfloat16() for t in (q, k, v, do)))
    assert all(t.shape[-1] == to and not t[..., hd:].any() for t in padded)
    scale = tfa.default_scale(hd)
    o, lse = tfa.flash_attention_plain(q, k, v, True, scale)
    want = tfa.flash_attention_plain_bwd(q, k, v, o, lse, do, True, scale)
    qp, kp, vp, op, dop = (tfa._pad_hd(t, tfa.BF16_HD)
                           for t in (q, k, v, o, do))
    got = tfa.flash_attention_plain_bwd(qp, kp, vp, op, lse, dop, True,
                                        scale)
    for g, w in zip(got, want):
        assert not g[..., hd:].any()
        np.testing.assert_allclose(g[..., :hd].numpy(), w.numpy(),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose((dop * op).sum(-1).numpy(),
                               (do * o).sum(-1).numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("hd,to", [(16, 64), (32, 64), (64, 64), (80, 128),
                                   (128, 128)])
def test_bf16_forward_head_dim_padding(hd, to):
    """The bf16 forward kernel is built for head dims 64 and 128, and its
    wrapper zero-pads the others (fp32 is not padded), resolving the scale
    from the unpadded head dim.  The plain forward on the padded tensors,
    with the unpadded scale, gives the unpadded ``o`` (cut back) and the
    same ``lse``; with the padded head dim's scale it would not."""
    arrs = _inputs(2, 40, 4, 2, hd, 7 + hd)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    assert all(t is u for t, u in zip(tfa._pad_bf16(q, k, v), (q, k, v)))
    q, k, v = (t.bfloat16().float() for t in (q, k, v))
    padded = tfa._pad_bf16(*(t.bfloat16() for t in (q, k, v)))
    assert all(t.shape[-1] == to and not t[..., hd:].any() for t in padded)
    qp, kp, vp = (t.float() for t in padded)
    scale = tfa.default_scale(hd)
    o, lse = tfa.flash_attention_plain(q, k, v, True, scale)
    op, lsep = tfa.flash_attention_plain(qp, kp, vp, True, scale)
    assert not op[..., hd:].any()
    np.testing.assert_allclose(tfa._unpad(op, hd).numpy(), o.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lsep.numpy(), lse.numpy(), rtol=1e-5,
                               atol=1e-6)
    if to != hd:
        _, wrong = tfa.flash_attention_plain(qp, kp, vp, True)
        assert not np.allclose(wrong.numpy(), lse.numpy(), rtol=1e-3)
