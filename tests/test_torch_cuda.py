"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Tests marked ``cuda`` skip without a CUDA device (a CUDA kernel has no CPU
mode); on the card run ``python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports no JAX, so it runs where only PyTorch is installed."""
import dataclasses
from pathlib import Path

import pytest
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import HostDataConfig, host_batch
from repro_torch.kernels import bitplane_add as bpa
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moa_reduce as moa
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as qmm
from repro_torch.launch import sass_mix
from repro_torch.models import attention, lm, moe, quant_kv
from repro_torch.models.common import ParamSpec, init_params
from repro_torch.models.registry import get_api
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serve import (EngineConfig, SamplingParams, ServeEngine,
                                cache, prng, sampling)
from repro_torch.train.loop import LoopConfig, TrainLoop
from repro_torch.train.state import build_train_step, init_train_state
from repro_torch.tree import leaves, map_tree
from repro_torch.tune import (VirtualCosts, bursty_trace, multi_turn_trace,
                              replay_open_loop, run_sweep, sweep_workload)
from repro_torch.tune.sweep import TRACE_FILE

DTYPES = {"float32": (torch.float32, torch.float32),
          "bfloat16": (torch.bfloat16, torch.float32),
          "int32": (torch.int32, torch.int32)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _operands(n, m, dtype, device):
    gen = torch.Generator(device=device).manual_seed(n * 7919 + m)
    in_dt, acc = DTYPES[dtype]
    if in_dt == torch.int32:
        return torch.randint(-1000, 1000, (n, m), generator=gen,
                             device=device, dtype=torch.int32), acc
    return torch.randn((n, m), generator=gen, device=device).to(in_dt), acc


def test_cuda_wrapper_refuses_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        moa.moa_reduce_cuda(torch.zeros(4, 8))


@pytest.mark.cuda
# N = 3, 4 (s = 0), 5, 17, 52, 63, 64 (s = 1), 65, 244, 257 (s = 2): ragged
# top groups, lanes whose subtree holds only padding or one whole group
@pytest.mark.parametrize("n,m", [(1, 64), (2, 1024), (5, 3), (7, 8227),
                                 (16, 96), (16, 12288), (16, 6144),
                                 (33, 2080), (16, 786432), (300, 640),
                                 (3, 516), (4, 1000), (5, 4096), (17, 260),
                                 (52, 1024), (63, 333), (64, 2048),
                                 (65, 1028), (244, 96), (257, 130)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_equals_plain_bit_for_bit(cuda_device, n, m, dtype):
    x, acc = _operands(n, m, dtype, cuda_device)
    before = moa.LAUNCHES
    got = moa.moa_reduce_cuda(x, acc)
    torch.cuda.synchronize()
    assert moa.LAUNCHES == before + 1
    assert torch.equal(got, moa.moa_reduce_plain(x, acc, acc))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4, 16, 20, 52, 64, 65, 244, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_keeps_the_sign_of_zero(cuda_device, n, dtype):
    """-0.0 operands: the plan pads a lone -0.0 to (-0 + 0) + (0 + 0) =
    +0 but keeps -0 where no padding reaches it; the kernel's bits,
    sign bits included, are the plain version's."""
    in_dt, acc = DTYPES[dtype]
    x, _ = _operands(n, 1024, "float32", cuda_device)
    x[:, :256] = -0.0
    x[:n // 2, 256:512] = -0.0
    x[:, 512:768] = torch.where(x[:, 512:768] < 0, -0.0, 0.0)
    x = x.to(in_dt)
    got = moa.moa_reduce_cuda(x, acc)
    want = moa.moa_reduce_plain(x, acc, acc)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_kernel_unaligned_view_takes_scalar_path(cuda_device):
    """A view offset by one element cannot take 16-byte loads; the kernel
    must still be exact."""
    base, acc = _operands(16, 4097, "float32", cuda_device)
    x = base.reshape(-1)[1:1 + 16 * 4096].reshape(16, 4096)
    assert x.is_contiguous() and x.data_ptr() % 16
    assert torch.equal(moa.moa_reduce_cuda(x, acc),
                       moa.moa_reduce_plain(x, acc, acc))


@pytest.mark.cuda
def test_ops_dispatches_cuda_tensors_to_the_kernel(cuda_device):
    x, _ = _operands(16, 4 * 24 * 128, "float32", cuda_device)
    x = x.reshape(16, 4, 24 * 128)
    before = moa.LAUNCHES
    got = ops.moa_reduce(x)
    assert moa.LAUNCHES == before + 1
    assert got.shape == (4, 24 * 128)
    assert torch.equal(got, moa.moa_reduce_plain(x))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    with pytest.raises(ValueError, match="operands"):
        moa.moa_reduce_cuda(torch.zeros(moa.MAX_OPERANDS + 1, 4,
                                        device=cuda_device))
    with pytest.raises(ValueError, match="dtypes"):
        moa.moa_reduce_cuda(torch.zeros(4, 4, device=cuda_device,
                                        dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        moa.moa_reduce_cuda(torch.zeros(4, 8, device=cuda_device)[:, ::2])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 16])
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)], ids=str)
def test_ops_moa_reduce_gradient_equals_plain(cuda_device, n, dtype,
                                              out_dtype):
    """``ops.moa_reduce`` on the card launches the kernel under
    ``MoaReduce``: its gradient is the plain version's, bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn((n, 3, 257), generator=gen, device=cuda_device).to(dtype)
    w = torch.randn((3, 257), generator=gen, device=cuda_device)
    xk = x.clone().requires_grad_(True)
    xp = x.clone().requires_grad_(True)
    before = moa.LAUNCHES
    out = ops.moa_reduce(xk, torch.float32, out_dtype=out_dtype)
    assert moa.LAUNCHES == before + 1 and out.grad_fn is not None
    (gk,) = torch.autograd.grad((out.float() * w).sum(), xk)
    plain = moa.moa_reduce_plain(xp, torch.float32, out_dtype)
    (gp,) = torch.autograd.grad((plain.float() * w).sum(), xp)
    assert moa.LAUNCHES == before + 1          # the backward launches none
    assert gk.dtype == dtype and torch.equal(gk, gp)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
# the MoE top-k combine's columns: phi3.5-moe decode (4 slots), a 256-token
# prefill piece, a chain verify (4 x 5 rows); llama4-scout decode
@pytest.mark.parametrize("m", [4 * 4096, 256 * 4096, 4 * 5 * 4096,
                               4 * 5120])
def test_kernel_at_the_moe_combine_shapes(cuda_device, n, m):
    x, acc = _operands(n, m, "bfloat16", cuda_device)
    got = ops.moa_reduce(x, acc, out_dtype=acc)
    assert torch.equal(got, moa.moa_reduce_plain(x, acc, acc))


@pytest.mark.cuda
@pytest.mark.parametrize("cf", [None, 1.0])
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "llama4-scout-17b-a16e"])
def test_moe_ffn_cuda_matches_cpu(cuda_device, arch, cf):
    """The reduced fp32 MoE FFN, drop-free and at capacity 1.0: the card's
    output, aux loss and expert gradients equal the CPU's within 1e-5,
    with one combine launch."""
    over = {} if cf is None else dict(capacity_factor=cf)
    cfg = get_config(arch).reduced(dtype=torch.float32, **over)
    params = init_params(moe.moe_param_specs(cfg),
                         torch.Generator().manual_seed(0),
                         torch.device("cpu"), torch.float32)
    x = torch.randn((2, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", cuda_device):
        p = map_tree(lambda t: t.to(dev).requires_grad_(True), params)
        before = moa.LAUNCHES
        y, aux = moe.moe_ffn(x.to(dev), p, cfg)
        launched = moa.LAUNCHES - before
        grads = torch.autograd.grad((y * y).sum() + aux,
                                    [p["w1"], p["w2"], p["router"]])
        out[str(dev)] = (y, aux, grads, launched)
    (y, aux, grads, _), (gy, gaux, ggrads, launched) = out.values()
    assert launched == 1
    torch.testing.assert_close(gy.cpu(), y, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(gaux.cpu(), aux, atol=1e-6, rtol=1e-5)
    for g, gg in zip(grads, ggrads):
        assert bool(gg.abs().sum() > 0)
        torch.testing.assert_close(gg.cpu(), g, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- flash attention
# (b, s, hq, hkv, hd): the shapes of tests/test_kernels.py:124-153, a ragged
# length, the reduced model's head dim, and the training path's shape
FLASH_SHAPES = [(2, 256, 4, 2, 64), (1, 128, 8, 8, 128), (2, 256, 6, 2, 80),
                (1, 512, 4, 1, 128), (1, 256, 2, 2, 64), (2, 37, 6, 2, 16),
                (1, 100, 4, 2, 16)]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _flash_inputs(b, s, hq, hkv, hd, dtype, device, grad=False):
    gen = torch.Generator(device=device).manual_seed(b * 1000 + s + hd)
    shapes = [(b, s, hq, hd), (b, s, hkv, hd), (b, s, hkv, hd),
              (b, s, hq, hd)]
    out = [torch.randn(sh, generator=gen, device=device).to(dtype)
           for sh in shapes]
    if grad:
        for t in out[:3]:
            t.requires_grad_(True)
    return out


def _rel(a, b):
    return float((a.float() - b.float()).norm() /
                 b.float().norm().clamp_min(1e-30))


def test_flash_wrappers_refuse_cpu_tensors():
    q, k, v, do = _flash_inputs(1, 8, 2, 1, 16, torch.float32, "cpu")
    o, lse = fa.flash_attention_plain(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_fwd_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_bwd_dq_cuda(q, k, v, o, lse, do)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_bwd_dkv_cuda(q, k, v, lse, lse, do)


# bf16 (the wgmma kernels): ragged S (37, 65, 100, 129, 200: no multiple
# of a 64-row tile), rep 1, 3 and 4, head dims 64, 80 (padded to 128) and
# 128
BF16_BWD_SHAPES = [(2, 37, 4, 4, 64), (1, 100, 6, 2, 128),
                   (2, 200, 8, 2, 80), (1, 200, 3, 1, 64),
                   (2, 100, 4, 1, 80), (1, 37, 2, 2, 128),
                   (1, 129, 8, 2, 128), (1, 65, 2, 1, 64)]
FLASH_CASES = ([(sh, dt) for sh in FLASH_SHAPES
                for dt in (torch.float32, torch.bfloat16)] +
               [(sh, torch.bfloat16) for sh in BF16_BWD_SHAPES])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", FLASH_CASES, ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_kernel_matches_plain(cuda_device, shape, dtype,
                                            causal):
    """o within 2e-5 (fp32) or 2e-2 (bf16) of flash_attention_plain, bf16
    also within 1e-2 relative norm error; lse within 1e-5."""
    q, k, v, _ = _flash_inputs(*shape, dtype, cuda_device)
    before = fa.LAUNCHES_FWD
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES_FWD == before + 1
    assert o.dtype == dtype and o.shape == q.shape
    po, plse = fa.flash_attention_plain(q, k, v, causal)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), po.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        assert _rel(o, po) <= 1e-2
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_flash_forward_repeats_bit_for_bit(cuda_device):
    q, k, v, _ = _flash_inputs(2, 300, 8, 2, 128, torch.bfloat16,
                               cuda_device)
    runs = [fa.flash_attention_fwd_cuda(q, k, v, True) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", FLASH_CASES, ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_kernels_match_plain(cuda_device, shape, dtype,
                                            causal):
    """dq, dk, dv against flash_attention_plain_bwd on the same (q, k, v,
    o, lse, do), and against autograd through flash_attention_plain.
    fp32: rtol 1e-4, atol 1e-5; bf16: relative norm error <= 1e-2."""
    q, k, v, do = _flash_inputs(*shape, dtype, cuda_device, grad=True)
    with torch.no_grad():
        o, lse = fa.flash_attention_fwd_cuda(q, k, v, causal)
    before = (fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV)
    dq, delta = fa.flash_attention_bwd_dq_cuda(q.detach(), k.detach(),
                                               v.detach(), o, lse, do,
                                               causal)
    dk, dv = fa.flash_attention_bwd_dkv_cuda(q.detach(), k.detach(),
                                             v.detach(), lse, delta, do,
                                             causal)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV) == \
        (before[0] + 1, before[1] + 1)
    plain = fa.flash_attention_plain_bwd(q.detach(), k.detach(), v.detach(),
                                         o, lse, do, causal)
    auto = torch.autograd.grad(fa.flash_attention_plain(q, k, v, causal)[0],
                               (q, k, v), do)
    for got, want, ref in zip((dq, dk, dv), plain, auto):
        assert got.dtype == dtype and got.shape == want.shape
        for w in (want, ref):
            if dtype == torch.float32:
                torch.testing.assert_close(got, w, rtol=1e-4, atol=1e-5)
            else:
                assert _rel(got, w) <= 1e-2


@pytest.mark.cuda
def test_flash_backward_repeats_bit_for_bit(cuda_device):
    """No atomics: two backward calls on the same inputs give equal dq,
    dk and dv."""
    q, k, v, do = _flash_inputs(2, 300, 8, 2, 128, torch.bfloat16,
                                cuda_device)
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, True)
    runs = []
    for _ in range(2):
        dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, o, lse, do, True)
        runs.append((dq, delta) + fa.flash_attention_bwd_dkv_cuda(
            q, k, v, lse, delta, do, True))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fa_fwd_wgmma", "fa_bwd_dq_wgmma",
                                    "fa_bwd_dkv_wgmma"])
def test_flash_sass_uses_wgmma_and_tma(cuda_device, kernel):
    """Each bf16 kernel, at HD 64 and 128, issues HGMMA and UTMALDG inside
    its loops; no flash attention kernel issues HMMA (mma.sync)."""
    if sass_mix.cuobjdump() is None:
        pytest.skip("needs cuobjdump (CUDA toolkit)")
    mixes = sass_mix.kernel_mixes("flash_attention")
    found = [m for fn, m in mixes.items() if kernel in fn]
    assert len(found) == 2, f"{kernel}: {list(mixes)}"   # HD 64, 128
    for inner, rest in found:
        assert inner["HGMMA"] > 0 and inner["UTMALDG"] > 0, kernel
    assert all(inner["HMMA"] == 0 and rest["HMMA"] == 0
               for inner, rest in mixes.values())


@pytest.mark.cuda
def test_flash_kernels_refuse_what_they_do_not_take(cuda_device):
    q, k, v, do = _flash_inputs(1, 64, 4, 2, 64, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        fa.flash_attention_fwd_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="one dtype"):
        fa.flash_attention_fwd_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_fwd_cuda(q[..., :48].contiguous(),
                                    k[..., :48].contiguous(),
                                    v[..., :48].contiguous())
    with pytest.raises(ValueError, match="Hq % Hkv"):
        fa.flash_attention_fwd_cuda(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd_cuda(q.transpose(1, 2), k, v)
    o, lse = fa.flash_attention_fwd_cuda(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_dq_cuda(q, k, v, o, lse[:, :, :8], do)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_attention_default_scale_of_unpadded_head_dim(cuda_device,
                                                            dtype):
    """FlashAttention pads head dim 40 to 64; with scale None it must still
    use 1 / sqrt(40), for o and the three gradients."""
    q, k, v, do = _flash_inputs(2, 96, 6, 2, 40, dtype, cuda_device,
                                grad=True)
    out = fa.FlashAttention.apply(q, k, v, True, None)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, True, fa.default_scale(40))[0]
    wgrads = torch.autograd.grad(want, (q, k, v), do)
    assert out.shape == q.shape
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    for g, w in zip(grads, wgrads):
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
        else:
            assert _rel(g, w) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 48])
def test_ops_flash_attention_launches_the_kernels(cuda_device, hd):
    """ops.flash_attention on CUDA tensors: one forward launch, and one
    launch of each backward kernel under autograd; head dim 48 is padded
    to 64 inside and agrees with the plain version."""
    q, k, v, do = _flash_inputs(2, 96, 6, 2, hd, torch.float32, cuda_device,
                                grad=True)
    before = (fa.LAUNCHES_FWD, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV)
    out = ops.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES_FWD, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV) == \
        tuple(x + 1 for x in before)
    assert out.shape == q.shape
    want = fa.flash_attention_plain(q, k, v, True)[0]
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
    for g, w in zip(grads, torch.autograd.grad(want, (q, k, v), do)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_gqa_train_on_cuda_goes_through_the_kernel(cuda_device):
    cfg = get_config("llama3.2-3b").reduced(dtype=torch.float32,
                                            n_kv_heads=2)
    p = init_params(attention.gqa_param_specs(cfg),
                    torch.Generator().manual_seed(0), torch.device("cpu"),
                    torch.float32)
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    want = attention.gqa_train(x, p, cfg)
    pc = {k: t.to(cuda_device) for k, t in p.items()}
    before = fa.LAUNCHES_FWD
    got = attention.gqa_train(x.to(cuda_device), pc, cfg)
    assert fa.LAUNCHES_FWD == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [64, 100])
def test_train_step_on_cuda_goes_through_the_kernels(cuda_device, seq):
    """A train step on the card runs every layer's attention through the
    kernels at any sequence length (100 is no multiple of a tile or of the
    config's attn_chunk) and gives the CPU step's loss."""
    cfg = get_config("llama3.2-3b").reduced(dtype=torch.float32,
                                            n_kv_heads=2)
    state = init_train_state(cfg, torch.Generator().manual_seed(0))
    batch = host_batch(cfg, ShapeConfig("t", seq_len=seq, global_batch=2,
                                        kind="train"),
                       HostDataConfig(0, 1, 0), 0)
    losses = {}
    for dev in ("cpu", "cuda"):
        st = map_tree(lambda t: t.to(dev, copy=True), state)
        step = build_train_step(cfg, AdamWConfig(lr=1e-3))
        before = (fa.LAUNCHES_FWD, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV)
        _, metrics = step(st, batch)
        losses[dev] = float(metrics["loss"])
        launched = tuple(a - b for a, b in zip(
            (fa.LAUNCHES_FWD, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV),
            before))
    fwd = cfg.n_layers * (2 if cfg.remat else 1)
    assert launched == (fwd, cfg.n_layers, cfg.n_layers)
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4


@pytest.mark.cuda
def test_train_step_with_flash_off_takes_chunked_attention(cuda_device):
    """use_flash_attn=False, as in the JAX package, selects
    chunked_attention on the card too: a train step launches no flash
    kernel and gives the CPU step's loss (chunked_attention on both)."""
    cfg = dataclasses.replace(
        get_config("llama3.2-3b").reduced(dtype=torch.float32, n_kv_heads=2),
        use_flash_attn=False)
    state = init_train_state(cfg, torch.Generator().manual_seed(0))
    batch = host_batch(cfg, ShapeConfig("t", seq_len=64, global_batch=2,
                                        kind="train"),
                       HostDataConfig(0, 1, 0), 0)
    losses = {}
    for dev in ("cpu", "cuda"):
        st = map_tree(lambda t: t.to(dev, copy=True), state)
        step = build_train_step(cfg, AdamWConfig(lr=1e-3))
        before = (fa.LAUNCHES_FWD, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV)
        _, metrics = step(st, batch)
        losses[dev] = float(metrics["loss"])
        assert (fa.LAUNCHES_FWD, fa.LAUNCHES_BWD_DQ,
                fa.LAUNCHES_BWD_DKV) == before
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4


# ------------------------------------------------------------ bitplane_add
# (N, M, B): the shapes of tests/test_kernels.py:60-82 and the Fig-15
# 16 x 16 adder over one llama3.2-3b activation tensor (4096 tokens x d_model)
_LLAMA = get_config("llama3.2-3b")
_TOKENS = 2 * 2048
# ... plus B % 4 != 0 (the 1-lane instance), N = 1, 2, 5, 17 and 64, M = 1
# and 31, and K = bit length of N from 1 to 7 counter words
BITPLANE_SHAPES = [(4, 4, 64), (4, 16, 256), (16, 16, 128), (3, 8, 33),
                   (64, 20, 512), (1, 31, 100),
                   (16, 16, _TOKENS * _LLAMA.d_model),
                   (2, 30, 1000), (5, 12, 4099), (17, 8, 4096), (9, 1, 1026),
                   (40, 24, 2048), (64, 1, 260), (8, 16, 4096),
                   (1, 31, 4096), (33, 16, 12345)]


def _lanes(n, m_bits, b, device, low=0):
    gen = torch.Generator(device=device).manual_seed(n * 31 + m_bits)
    return torch.randint(low, 2 ** m_bits, (n, b), generator=gen,
                         device=device, dtype=torch.int32)


def test_bitplane_wrapper_refuses_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        bpa.bitplane_add_cuda(torch.zeros(4, 8, dtype=torch.int32), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m_bits,b", BITPLANE_SHAPES, ids=str)
def test_bitplane_kernel_equals_plain(cuda_device, n, m_bits, b):
    x = _lanes(n, m_bits, b, cuda_device)
    before = bpa.LAUNCHES
    got = bpa.bitplane_add_cuda(x, m_bits)
    torch.cuda.synchronize()
    assert bpa.LAUNCHES == before + 1
    assert torch.equal(got, bpa.bitplane_add_plain(x, m_bits))
    assert torch.equal(got, x.sum(0, dtype=torch.int32))
    mask = (1 << m_bits) - 1
    assert torch.equal(got, (x & mask).sum(0, dtype=torch.int32))


@pytest.mark.cuda
def test_bitplane_kernel_unaligned_view(cuda_device):
    """An offset view is not 16-byte aligned: the 1-lane instance runs
    and is exact."""
    base = _lanes(16, 16, 4097, cuda_device)
    x = base.reshape(-1)[1:1 + 16 * 4096].reshape(16, 4096)
    assert x.is_contiguous() and x.data_ptr() % 16
    got = bpa.bitplane_add_cuda(x, 16)
    assert torch.equal(got, bpa.bitplane_add_plain(x, 16))
    assert torch.equal(got, x.sum(0, dtype=torch.int32))


@pytest.mark.cuda
def test_bitplane_kernel_reads_only_the_low_bits(cuda_device):
    """Operands wider than M (negative ones too): kernel and plain version
    both add only the low M bits."""
    x = _lanes(7, 31, 4096, cuda_device, low=-2 ** 31)
    got = bpa.bitplane_add_cuda(x, 12)
    assert torch.equal(got, bpa.bitplane_add_plain(x, 12))
    assert torch.equal(got, (x & 0xFFF).sum(0, dtype=torch.int32))


@pytest.mark.cuda
def test_bitplane_width_guard_raises_before_launch(cuda_device):
    before = bpa.LAUNCHES
    with pytest.raises(ValueError, match="int32 capacity"):
        ops.bitplane_add(torch.zeros(8, 4, dtype=torch.int32,
                                     device=cuda_device), 30)
    assert bpa.LAUNCHES == before


@pytest.mark.cuda
def test_ops_bitplane_add_launches_the_kernel(cuda_device):
    x = torch.tensor([[0xA], [0xF], [0x1], [0x2]], dtype=torch.int32,
                     device=cuda_device).repeat(1, 256)
    before = bpa.LAUNCHES
    got = ops.bitplane_add(x, 4)
    assert bpa.LAUNCHES == before + 1
    assert bool((got == 0x1C).all())


# ------------------------------------------------------------ quant_matmul
# (M, K, N): the shapes of tests/test_kernels.py:86-116, unaligned K, and
# the q/o projection of one llama3.2-3b training step's tokens
QMM_SHAPES = [(8, 128, 128), (32, 384, 256), (130, 257, 65),
              (256, 1024, 512), (17, 40, 9), (_TOKENS, _LLAMA.d_model,
                                             _LLAMA.n_heads * _LLAMA.hd)]


def _int8(shape, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-128, 128, shape, generator=gen, device=device,
                         dtype=torch.int8)


def test_quant_matmul_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        qmm.quant_matmul_cuda(torch.zeros(4, 8, dtype=torch.int8),
                              torch.zeros(8, 4, dtype=torch.int8))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", QMM_SHAPES, ids=str)
@pytest.mark.parametrize("acc_bits", [32, 18])
def test_quant_matmul_kernel_equals_plain(cuda_device, m, k, n, acc_bits):
    """acc_bits 18 makes the plan binding: blocks of 8 products."""
    if acc_bits == 18 and m * n * k > 2 ** 27:
        k = 520                     # keep the 8-wide blocks' plain loop short
    x, w = _int8((m, k), m + k, cuda_device), _int8((k, n), k + n,
                                                    cuda_device)
    before = qmm.LAUNCHES
    got = qmm.quant_matmul_cuda(x, w, acc_bits)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES == before + 1
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, qmm.quant_matmul_plain(x, w, acc_bits))


# (M, K, N) that the wgmma kernel takes: K and N multiples of 16.  Ragged
# M, N and K that do not fill its 256 x 128 x 128 tiles, and the gate/up,
# down and q/o projections of one llama3.2-3b training step
QMM_WGMMA_SHAPES = [(130, 272, 208), (1, 16, 16), (300, 4112, 272),
                    (17, 32, 16), (64, 96, 48),
                    (_TOKENS, _LLAMA.d_model, _LLAMA.d_ff),
                    (_TOKENS, _LLAMA.d_ff, _LLAMA.d_model),
                    (_TOKENS, _LLAMA.d_model, _LLAMA.n_heads * _LLAMA.hd)]
# (M, K, N, base 1 byte past alignment): K or N not a multiple of 16, or an
# unaligned base, which the pre-pass and the mma.sync kernel take
QMM_MMA_SYNC_CASES = [(130, 257, 65, None), (17, 40, 9, None),
                      (130, 520, 64, None), (130, 272, 200, None),
                      (1, 16, 8, None), (300, 4112, 264, None),
                      (130, 256, 64, "x"), (130, 256, 64, "w")]


def _unaligned_int8(shape, seed, device):
    """A contiguous int8 tensor whose base is 1 byte past 16-byte aligned."""
    flat = _int8((shape[0] * shape[1] + 16,), seed, device)
    out = flat[1:1 + shape[0] * shape[1]].view(shape)
    assert out.data_ptr() % 16 != 0 and out.is_contiguous()
    return out


def _route_counts():
    return (qmm.LAUNCHES, qmm.WGMMA_LAUNCHES, qmm.MMA_SYNC_LAUNCHES,
            qmm.TRANSPOSE_LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", QMM_WGMMA_SHAPES, ids=str)
@pytest.mark.parametrize("acc_bits", [32, 18])
def test_quant_matmul_wgmma_route_equals_plain(cuda_device, m, k, n,
                                               acc_bits):
    """The wgmma kernel (one accumulator over K) gives the plain version's
    bits, with the plan's 8-product blocks of acc_bits 18 too; one launch
    a call, no pre-pass."""
    x, w = _int8((m, k), m + k, cuda_device), _int8((k, n), k + n,
                                                    cuda_device)
    before = _route_counts()
    got = qmm.quant_matmul_cuda(x, w, acc_bits)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_route_counts(), before)] == [1, 1, 0, 0]
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, qmm.quant_matmul_plain(x, w, acc_bits))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,unaligned", QMM_MMA_SYNC_CASES, ids=str)
def test_quant_matmul_mma_sync_route(cuda_device, m, k, n, unaligned):
    """K or N not a multiple of 16, or a base TMA cannot take, reaches the
    pre-pass and the mma.sync kernel, and they give the plain version's
    bits."""
    x = (_unaligned_int8 if unaligned == "x" else _int8)(
        (m, k), m + k, cuda_device)
    w = (_unaligned_int8 if unaligned == "w" else _int8)(
        (k, n), k + n, cuda_device)
    assert qmm.route(k, n, x.data_ptr(), w.data_ptr()) == "mma_sync"
    before = _route_counts()
    got = qmm.quant_matmul_cuda(x, w)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_route_counts(), before)] == [1, 0, 1, 1]
    assert torch.equal(got, qmm.quant_matmul_plain(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(300, 4112, 272), (4096, 3072, 8192),
                                   (300, 4112, 264)], ids=str)
def test_quant_matmul_repeats_bit_for_bit(cuda_device, m, k, n):
    x, w = _int8((m, k), 3, cuda_device), _int8((k, n), 4, cuda_device)
    runs = [qmm.quant_matmul_cuda(x, w) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 4])
def test_quant_matmul_two_plan_blocks_wrap(cuda_device, n):
    """x all -128, w all 127 at K = 262144: two plan blocks, partials of
    -2,130,706,432 each, whose int32 sum wraps to 33,554,432.  At N = 16 the
    wgmma kernel's single accumulator wraps the same way (no saturation);
    at N = 4 the mma.sync kernel adds the two partials."""
    k = 262144
    assert qmm.k_plan(k).num_blocks == 2
    x = torch.full((4, k), -128, dtype=torch.int8, device=cuda_device)
    w = torch.full((k, n), 127, dtype=torch.int8, device=cuda_device)
    before = qmm.WGMMA_LAUNCHES
    got = qmm.quant_matmul_cuda(x, w)
    torch.cuda.synchronize()
    assert qmm.WGMMA_LAUNCHES == before + (n % 16 == 0)
    assert torch.equal(got, qmm.quant_matmul_plain(x, w))
    assert bool((got == 33554432).all())


@pytest.mark.cuda
def test_quant_matmul_transpose_prepass(cuda_device):
    """The mma.sync route's pre-pass writes w K-major, rows padded to 16
    bytes with zeros."""
    for k, n in [(40, 9), (3072, 8192), (257, 65)]:
        w = _int8((k, n), k, cuda_device)
        wt = qmm.transpose_w_cuda(w)
        torch.cuda.synchronize()
        ldt = -(-k // 16) * 16
        assert wt.shape == (n, ldt)
        assert torch.equal(wt[:, :k], w.t())
        assert not bool(wt[:, k:].any())


@pytest.mark.cuda
def test_quant_matmul_sass_uses_wgmma_and_tma(cuda_device):
    """qmm_wgmma issues the warpgroup MMA and UTMALDG in its loops and no
    IMMA (mma.sync); qmm_mma_sync is the one that issues IMMA."""
    if sass_mix.cuobjdump() is None:
        pytest.skip("needs cuobjdump (CUDA toolkit)")
    mixes = sass_mix.kernel_mixes("quant_matmul", "qmm_wgmma")
    assert len(mixes) == 1, list(mixes)
    (inner, rest), = mixes.values()
    assert sum(c for op, c in inner.items() if op.endswith("GMMA")) > 0
    assert inner["UTMALDG"] > 0
    assert inner["IMMA"] == 0 and rest["IMMA"] == 0
    sync = sass_mix.kernel_mixes("quant_matmul", "qmm_mma_sync")
    assert sync and all(inner["IMMA"] > 0 for inner, _ in sync.values())


@pytest.mark.cuda
def test_quant_matmul_worst_case_is_exact(cuda_device):
    """All -128 at K = 8192: every sum is exactly 8192 * 2^14."""
    k = 8192
    x = torch.full((4, k), -128, dtype=torch.int8, device=cuda_device)
    w = torch.full((k, 4), -128, dtype=torch.int8, device=cuda_device)
    got = ops.quant_matmul(x, w)
    assert bool((got == k * 128 * 128).all())


@pytest.mark.cuda
def test_quant_matmul_kernel_refuses_what_it_does_not_take(cuda_device):
    x = torch.zeros(4, 8, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="int8"):
        qmm.quant_matmul_cuda(x.int(), x.t().contiguous().int())
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        qmm.quant_matmul_cuda(x, x)
    with pytest.raises(ValueError, match="contiguous"):
        qmm.quant_matmul_cuda(x, x.t())


@pytest.mark.cuda
def test_ops_quant_matmul_launches_the_kernel(cuda_device):
    x, w = _int8((64, 96), 1, cuda_device), _int8((96, 48), 2, cuda_device)
    before = qmm.LAUNCHES
    got = ops.quant_matmul(x, w)
    assert qmm.LAUNCHES == before + 1
    assert torch.equal(got, qmm.quant_matmul_plain(x, w))


# ------------------------------------------------- serve: shared KV pages
def _bf16_pool(device):
    specs = {name: ParamSpec((28, 2, 256, 8, 128),
                             ("layers", "batch", "kv_seq", None, None),
                             dtype=torch.bfloat16) for name in ("k", "v")}
    pspecs = cache.paged_state_specs(specs, 128, 6)
    gen = torch.Generator(device=device).manual_seed(0)
    state = {k: torch.randn(s.shape, generator=gen, device=device)
             .to(s.dtype) for k, s in pspecs.items()}
    return pspecs, state


@pytest.mark.cuda
def test_copy_page_and_page_bytes_on_a_bf16_device_pool(cuda_device):
    """copy_page moves one page of every leaf (the page axis sits behind
    the layer axis: a strided view) and touches nothing else; page_bytes
    reads it as uint8 on the card, tells -0.0 from +0.0, and goes to the
    host as bytes (numpy has no bfloat16)."""
    pspecs, state = _bf16_pool(cuda_device)
    before = {k: v.clone() for k, v in state.items()}
    cache.copy_page(state, pspecs, 2, 5)
    for k in state:
        assert torch.equal(state[k][:, 5], before[k][:, 2])
        assert torch.equal(state[k][:, :5], before[k][:, :5])
    views = cache.page_bytes(state, pspecs, 5)
    assert all(v.device.type == "cuda" and v.dtype == torch.uint8
               and v.numel() == 28 * 128 * 8 * 128 * 2 for v in views)
    assert all(torch.equal(a, b) for a, b in
               zip(views, cache.page_bytes(state, pspecs, 2)))
    host = b"".join(v.cpu().numpy().tobytes() for v in views)
    assert len(host) == 2 * 28 * 128 * 8 * 128 * 2     # 14.7 MB a page
    state["k"][:, 1] = 0.0
    state["k"][:, 3] = -0.0
    assert torch.equal(state["k"][:, 1], state["k"][:, 3])
    assert not torch.equal(cache.page_bytes(state, pspecs, 1)[0],
                           cache.page_bytes(state, pspecs, 3)[0])


def _serve_engine(device, **knobs):
    cfg = get_config("llama3.2-3b").reduced(dtype=torch.bfloat16,
                                            n_kv_heads=2)
    params = init_params(get_api(cfg).param_specs(cfg),
                         torch.Generator().manual_seed(0),
                         torch.device("cpu"), torch.float32)
    params = map_tree(lambda t: t.to(device, torch.bfloat16), params)
    eng = ServeEngine(cfg, params, config=EngineConfig(
        max_slots=2, max_seq=64, prefill_chunk=16, page_size=16, **knobs),
        device=device)
    return cfg, eng


@pytest.mark.cuda
def test_copy_on_write_isolation_on_the_card(cuda_device):
    """A sharer of a live request's 12-token prefix writes into its own
    copy of the boundary page: the source page's 12 shared positions keep
    their bytes, the copy starts from them, and both requests give a cold
    engine's tokens."""
    cfg, eng = _serve_engine(cuda_device)
    gen = torch.Generator().manual_seed(1)
    system = torch.randint(0, cfg.vocab, (12,), generator=gen).tolist()
    tail = torch.randint(0, cfg.vocab, (4,), generator=gen).tolist()
    r1 = eng.submit(system, 20)
    eng.step()
    eng.step()
    src = int(eng.table[0, 0])
    shared = {k: v[:, src, :12].clone() for k, v in eng.state.items()}
    r2 = eng.submit(system + tail, 6)
    eng.step()
    dst = int(eng.table[1, 0])
    assert eng.stats["pages_cow"] == 1 and dst not in (0, src)
    assert int(eng.pool.refcount[src]) == 1 == int(eng.pool.refcount[dst])
    for k, v in eng.state.items():
        assert torch.equal(v[:, src, :12].view(torch.int16),
                           shared[k].view(torch.int16))
        assert torch.equal(v[:, dst, :12].view(torch.int16),
                           shared[k].view(torch.int16))
        assert not torch.equal(v[:, dst, 12:16], v[:, src, 12:16])
    eng.run()
    assert len(r2.generated) == 6
    # r2 prefilled from position 12, a cold engine from 0: another cut, so
    # only the source is compared token for token
    _, cold = _serve_engine(cuda_device, prefix_cache=False)
    c1 = cold.submit(system, 20)
    cold.run()
    assert r1.generated == c1.generated


@pytest.mark.cuda
def test_warm_tokens_equal_cold_on_a_reduced_bf16_config(cuda_device):
    """Shared 32-token prefix (two pages, two whole prefill chunks): the
    warm engine shares the pages by reference, copies none and gives the
    cold engine's tokens exactly, launching moa_reduce on every
    dispatch."""
    gen = torch.Generator().manual_seed(2)
    cfg, warm = _serve_engine(cuda_device)
    system = torch.randint(0, cfg.vocab, (32,), generator=gen).tolist()
    prompts = [system + torch.randint(0, cfg.vocab, (n,),
                                      generator=gen).tolist()
               for n in (5, 9, 3, 12)]
    _, cold = _serve_engine(cuda_device, prefix_cache=False)
    out = {}
    for name, eng in (("cold", cold), ("warm", warm)):
        before = moa.LAUNCHES
        reqs = [eng.submit(p, 8) for p in prompts]
        eng.run()
        st = eng.stats
        assert moa.LAUNCHES - before == 2 * cfg.n_layers * (
            st["prefill_dispatches"] + st["decode_steps"])
        out[name] = [r.generated for r in reqs]
    assert out["warm"] == out["cold"]
    st = warm.stats_summary()
    assert st["prefix_hits"] == 3 and st["pages_cow"] == 0
    assert st["pages_shared"] > 0 and st["prefix_bytes_copied"] == 0


#: moa_reduce's verify shapes at full width (4 slots, 24 heads, hd 128,
#: 16 pages of 128): l and o of a chain block (C = 5) and a tree block at
#: the default knobs (C = 17)
VERIFY_SHAPES = [(16, 4 * 24 * c * w) for c in (5, 17) for w in (1, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", VERIFY_SHAPES, ids=str)
def test_moa_reduce_at_the_verify_shapes(cuda_device, n, m):
    x, acc = _operands(n, m, "float32", cuda_device)
    x[:, :8] = -0.0
    before = moa.LAUNCHES
    got = ops.moa_reduce(x, acc, out_dtype=acc)
    want = moa.moa_reduce_plain(x, acc, acc)
    torch.cuda.synchronize()
    assert moa.LAUNCHES == before + 1
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))


@pytest.mark.cuda
def test_speculative_masks_on_the_card_equal_cpu(cuda_device):
    """The row-masked view write, the ancestor mask and the masked pool
    scatter give the CPU's results on CUDA tensors."""
    gen = torch.Generator().manual_seed(5)
    cache_ = torch.randn((3, 12, 2, 4), generator=gen)
    new = torch.randn((3, 5, 2, 4), generator=gen)
    pos = torch.tensor([[3], [10], [0]]) + torch.arange(5)[None]
    nvalid = torch.tensor([5, 5, 0])
    parents = torch.tensor([[-1, 0, 1, 1, 3], [-1, 0, 1, 3, 4],
                            [0, 1, 2, 3, 4]])
    pool = torch.randn((6, 16, 2, 4), generator=gen)
    pages = torch.tensor([[1, 2], [3, 4], [0, 0]])
    cpu = (attention.masked_cache_write(cache_.clone(), new, pos, nvalid),
           attention.tree_valid(torch.tensor([3, 10, 0]), parents, nvalid,
                                24),
           attention.paging.scatter_token_rows(pool.clone(), pages, new,
                                               pos, nvalid))
    dev = [t.to(cuda_device) for t in (cache_, new, pos, nvalid, parents,
                                       pool, pages)]
    gpu = (attention.masked_cache_write(dev[0].clone(), dev[1], dev[2],
                                        dev[3]),
           attention.tree_valid(torch.tensor([3, 10, 0], device=cuda_device),
                                dev[4], dev[3], 24),
           attention.paging.scatter_token_rows(dev[5].clone(), dev[6],
                                               dev[1], dev[2], dev[3]))
    assert torch.equal(gpu[0].cpu(), cpu[0])
    assert torch.equal(gpu[1].cpu(), cpu[1])
    assert torch.equal(gpu[2].cpu()[1:], cpu[2][1:])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["chain", "tree", "auto", "heads"])
def test_spec_engine_on_the_card_equals_cpu(cuda_device, mode):
    """Reduced fp32 config, TF32 off: chain (``spec_k=4``), tree, auto and
    draft-head speculative engines on CUDA give the CPU engine's tokens
    and spec counters, launching moa_reduce twice a layer on every
    prefill and verify dispatch."""
    knobs = {"chain": dict(spec_k=4),
             "tree": dict(spec_k=4, spec_mode="tree"),
             "auto": dict(spec_k=4, spec_mode="auto"),
             "heads": dict(spec_k=4, spec_mode="tree",
                           spec_drafter="heads")}[mode]
    cfg = get_config("llama3.2-3b").reduced(dtype=torch.float32,
                                            n_kv_heads=2)
    params = init_params(get_api(cfg).param_specs(cfg),
                         torch.Generator().manual_seed(0),
                         torch.device("cpu"), torch.float32)
    if mode == "heads":
        params["draft_heads"] = init_params(
            lm.draft_head_specs(cfg, 3, 16), torch.Generator().manual_seed(9),
            torch.device("cpu"), torch.float32)
    gen = torch.Generator().manual_seed(3)
    pat = torch.randint(0, cfg.vocab, (5,), generator=gen).tolist()
    prompts = [pat * 4, torch.randint(0, cfg.vocab, (13,),
                                      generator=gen).tolist(),
               pat * 3 + [1], pat[::-1] * 3]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for dev in ("cpu", "cuda"):
            p = map_tree(lambda t: t.to(dev), params)
            eng = ServeEngine(cfg, p, config=EngineConfig(
                max_slots=2, max_seq=64, prefill_chunk=16, page_size=16,
                **knobs), device=dev)
            before = moa.LAUNCHES
            reqs = [eng.submit(q, 12) for q in prompts]
            eng.run()
            st = eng.stats_summary()
            out[dev] = ([r.generated for r in reqs],
                        {k: v for k, v in st.items() if k.startswith("spec_")},
                        moa.LAUNCHES - before, st)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert out["cuda"][0] == out["cpu"][0]
    assert out["cuda"][1] == out["cpu"][1]
    st = out["cuda"][3]
    assert st["spec_steps"] == st["decode_steps"] > 0
    assert out["cpu"][2] == 0
    assert out["cuda"][2] == 2 * cfg.n_layers * (st["prefill_dispatches"]
                                                 + st["decode_steps"])


@pytest.mark.cuda
def test_prng_bits_on_the_card_equal_cpu(cuda_device):
    """Threefry is integer arithmetic: keys, bits and uniforms are the
    same bits on CUDA as on the CPU (the CPU ones equal JAX's,
    tests/test_torch_sampling.py)."""
    seeds = torch.tensor([0, 7, -5, 2 ** 31 - 1, 123456])
    idxs = torch.tensor([0, 1, 1000, 3, 2 ** 31 - 1])
    out = {}
    for dev in ("cpu", "cuda"):
        key = prng.fold_in(prng.prng_key(seeds.to(dev)), idxs.to(dev))
        out[dev] = (key, prng.random_bits(key, 128257),
                    prng.uniform(key, 128257, torch.finfo(torch.float32).tiny))
    for a, b in zip(out["cpu"][0], out["cuda"][0]):
        assert torch.equal(a, b.cpu())
    assert torch.equal(out["cpu"][1], out["cuda"][1].cpu())
    assert torch.equal(out["cpu"][2].view(torch.int32),
                       out["cuda"][2].cpu().view(torch.int32))


@pytest.mark.cuda
def test_sample_tokens_on_the_card_equal_cpu(cuda_device):
    """Seeded (64, 128256) fp32 logits, the engine's lanes: CUDA draws the
    CPU's tokens."""
    gen = torch.Generator().manual_seed(0)
    logits = 3 * torch.randn((64, 128256), generator=gen)
    sps = [SamplingParams(temperature=(0.0, 0.5, 0.8, 1.5)[i % 4],
                          top_k=(0, 1, 40)[i % 3],
                          top_p=(0.05, 0.9, 1.0)[(i // 3) % 3], seed=i)
           for i in range(64)]
    idxs = list(range(0, 640, 10))
    cpu = sampling.sample_tokens(logits, *sampling.sampling_lanes(sps, idxs))
    gpu = sampling.sample_tokens(logits.to(cuda_device),
                                 *sampling.sampling_lanes(sps, idxs,
                                                          cuda_device))
    assert torch.equal(gpu.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_rows_on_the_card_equal_cpu(cuda_device, bits):
    gen = torch.Generator().manual_seed(bits)
    x = 2 * torch.randn((4, 128, 8, 128), generator=gen)
    x[0, 0] = 0.0
    codes, scale = quant_kv.quantize_rows(x, bits)
    gcodes, gscale = quant_kv.quantize_rows(x.to(cuda_device), bits)
    assert torch.equal(gcodes.cpu(), codes)
    assert torch.equal(gscale.cpu().view(torch.int32),
                       scale.view(torch.int32))
    for dt in (torch.float32, torch.bfloat16):
        want = quant_kv.dequantize_rows(codes, scale, dt)
        got = quant_kv.dequantize_rows(gcodes, gscale, dt)
        assert torch.equal(got.cpu(), want)


def _kernel_launches():
    """Every kernel's launch counter, in one tuple."""
    return (moa.LAUNCHES, fa.LAUNCHES_FWD, fa.LAUNCHES_BWD_DQ,
            fa.LAUNCHES_BWD_DKV, bpa.LAUNCHES, qmm.LAUNCHES)


#: the QKV-bias archs at their published GQA groups (16 and 5), narrow
QKV_BIAS_HEADS = {"glm4-9b": dict(n_heads=32, n_kv_heads=2),
                  "qwen2.5-14b": dict(n_heads=20, n_kv_heads=4)}


def _reduced_params(cfg):
    """Seed-0 params of the reduced ``cfg`` on the CPU; with a QKV bias,
    ``bq``, ``bk`` and ``bv`` drawn N(0, 0.5) (their init is zeros, which
    would hide a dropped bias)."""
    params = init_params(get_api(cfg).param_specs(cfg),
                         torch.Generator().manual_seed(0),
                         torch.device("cpu"), torch.float32)
    if cfg.qkv_bias:
        gen = torch.Generator().manual_seed(1)
        attn = params["blocks"]["attn"]
        for k in ("bq", "bk", "bv"):
            attn[k] = 0.5 * torch.randn(attn[k].shape, generator=gen)
    return params


def _reduced_engine_runs(knobs, sps=None, arch="llama3.2-3b"):
    """The reduced fp32 ``arch`` (TF32 off; llama with ``n_kv_heads=2``,
    the QKV-bias archs at ``QKV_BIAS_HEADS`` with nonzero biases) on the
    CPU and on CUDA with ``knobs``: (tokens, stats, moa_reduce launches,
    every kernel's launches) by device."""
    over = ({"n_kv_heads": 2} if arch == "llama3.2-3b"
            else QKV_BIAS_HEADS.get(arch, {}))
    cfg = get_config(arch).reduced(dtype=torch.float32, **over)
    params = _reduced_params(cfg)
    gen = torch.Generator().manual_seed(3)
    pat = torch.randint(0, cfg.vocab, (5,), generator=gen).tolist()
    prompts = [pat * 4, torch.randint(0, cfg.vocab, (13,),
                                      generator=gen).tolist(),
               pat * 3 + [1], pat[::-1] * 3]
    sps = sps or [None] * len(prompts)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for dev in ("cpu", "cuda"):
            p = map_tree(lambda t: t.to(dev), params)
            eng = ServeEngine(cfg, p, config=EngineConfig(**dict(dict(
                max_slots=2, max_seq=64, prefill_chunk=16, page_size=16),
                **knobs)), device=dev)
            before = moa.LAUNCHES
            counts = _kernel_launches()
            reqs = [eng.submit(q, 12, sampling=sp)
                    for q, sp in zip(prompts, sps)]
            eng.run()
            out[dev] = ([r.generated for r in reqs], eng.stats_summary(),
                        moa.LAUNCHES - before,
                        tuple(a - b for a, b in zip(_kernel_launches(),
                                                    counts)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return cfg, out


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_quantized_engine_on_the_card_equals_cpu(cuda_device, kv_dtype):
    """int8 and int4 pools: the CUDA engine gives the CPU engine's tokens
    and pool accounting, launching moa_reduce twice a layer a dispatch."""
    cfg, out = _reduced_engine_runs(dict(kv_dtype=kv_dtype))
    assert out["cuda"][0] == out["cpu"][0]
    st, cst = out["cuda"][1], out["cpu"][1]
    for k in ("kv_dtype", "kv_bytes_per_slot", "pool_bytes",
              "decode_steps", "prefill_dispatches"):
        assert st[k] == cst[k], k
    assert out["cpu"][2] == 0
    assert out["cuda"][2] == 2 * cfg.n_layers * (st["prefill_dispatches"]
                                                 + st["decode_steps"]) > 0


@pytest.mark.cuda
def test_two_shard_engine_on_the_card(cuda_device):
    """Two shards on one card (``devices=["cuda:0"] * 2``), greedy and
    with chain drafts: the tokens of the one-shard engine on the card and
    of the two-shard engine on the CPU; moa_reduce launched twice a layer
    a dispatch the shards ran; every row inside its shard's block."""
    cfg = get_config("llama3.2-3b").reduced(dtype=torch.float32,
                                            n_kv_heads=2)
    params = _reduced_params(cfg)
    gen = torch.Generator().manual_seed(5)
    pat = torch.randint(0, cfg.vocab, (6,), generator=gen).tolist()
    prompts = [pat * 3, torch.randint(0, cfg.vocab, (21,),
                                      generator=gen).tolist(),
               pat * 2 + [2], torch.randint(0, cfg.vocab, (9,),
                                            generator=gen).tolist(),
               pat[::-1] * 3]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for knobs in (dict(prefix_cache=False), dict(spec_k=3)):
            toks = {}
            for dev, shards in (("cuda", 1), ("cuda", 2), ("cpu", 2)):
                p = map_tree(lambda t: t.to(dev), params)
                eng = ServeEngine(cfg, p, config=EngineConfig(
                    max_slots=4, max_seq=64, prefill_chunk=16, page_size=16,
                    mesh_shards=shards, **knobs), device=dev,
                    devices=[f"{dev}:0" if dev == "cuda" else dev] * shards
                    if shards > 1 else None)
                eng.warmup()
                before = moa.LAUNCHES
                reqs = [eng.submit(q, 10) for q in prompts]
                eng.run()
                torch.cuda.synchronize()
                st = eng.stats_summary()
                toks[dev, shards] = [r.generated for r in reqs]
                if shards > 1:
                    pool = eng.pool
                    assert all(pool.shard_of(q) == eng._slot_shard(slot)
                               for slot in range(eng.max_slots)
                               for q in eng.table[slot] if q)
                    assert min(st["shard_lane_steps"]) > 0
                if dev == "cuda":
                    assert moa.LAUNCHES - before == 2 * cfg.n_layers * (
                        st["prefill_dispatches"]
                        + st["decode_dispatches"]) > 0
            assert toks["cuda", 2] == toks["cuda", 1] == toks["cpu", 2]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
def test_sampled_chain_engine_on_the_card_equals_cpu(cuda_device):
    """Sampled requests (temperature 0.8, top-k 40, top-p 0.9, one seed
    each) under chain speculative decode: CUDA draws the CPU's tokens and
    accepts as many drafts."""
    sps = [SamplingParams(temperature=0.8, top_k=40, top_p=0.9, seed=i)
           for i in range(4)]
    cfg, out = _reduced_engine_runs(dict(spec_k=4), sps)
    assert out["cuda"][0] == out["cpu"][0]
    for k in ("spec_drafted", "spec_accepted", "decode_steps"):
        assert out["cuda"][1][k] == out["cpu"][1][k], k
    st = out["cuda"][1]
    assert out["cuda"][2] == 2 * cfg.n_layers * (st["prefill_dispatches"]
                                                 + st["decode_steps"])


@pytest.mark.cuda
@pytest.mark.parametrize("run", ["split-K", "split-K chain", "dense"])
def test_contiguous_engine_on_the_card_equals_cpu(cuda_device, run):
    """Contiguous slots (``paged_kv=False``) on the reduced fp32 config:
    CUDA gives the CPU engine's tokens and counters; split-K over the slot
    rows read as pages launches moa_reduce twice a layer a dispatch, the
    page-0 engine (one softmax) never; and the split-K tokens equal the
    paged engine's on the card."""
    knobs = {"split-K": dict(paged_kv=False),
             "split-K chain": dict(paged_kv=False, spec_k=4),
             "dense": dict(page_size=0)}[run]
    cfg, out = _reduced_engine_runs(knobs)
    assert out["cuda"][0] == out["cpu"][0]
    st, cst = out["cuda"][1], out["cpu"][1]
    for k in ("decode_steps", "prefill_dispatches", "prefix_hits",
              "prefix_bytes_copied", "spec_drafted", "spec_accepted",
              "kv_bytes_per_slot", "pool_bytes", "pages_in_use"):
        assert st[k] == cst[k], k
    per = 0 if run == "dense" else 2 * cfg.n_layers
    assert out["cuda"][2] == st["moa_reduce_launches"] == per * (
        st["prefill_dispatches"] + st["decode_steps"])
    assert out["cuda"][2] > 0 or run == "dense"
    if run != "dense":
        _, paged = _reduced_engine_runs(
            {k: v for k, v in knobs.items() if k != "paged_kv"})
        assert paged["cuda"][0] == out["cuda"][0]


#: the MLA engine runs held CUDA against CPU: (knobs, sampled?)
MLA_RUNS = {"cold": (dict(prefix_cache=False), False),
            "prefix": ({}, False),
            "chain": (dict(spec_k=4), False),
            "tree": (dict(spec_k=4, spec_mode="tree"), False),
            "int8": (dict(kv_dtype="int8"), False),
            "int4 chain": (dict(kv_dtype="int4", spec_k=4), False),
            "sampled": ({}, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("run", sorted(MLA_RUNS))
def test_mla_engine_on_the_card_equals_cpu(cuda_device, run):
    """The reduced fp32 MLA config: CUDA gives the CPU engine's tokens and
    counters over latent pools, and launches no hand-written kernel (the
    absorbed attention has no split-K page combine)."""
    knobs, sampled = MLA_RUNS[run]
    sps = ([SamplingParams(temperature=0.8, top_k=40, seed=i)
            for i in range(4)] if sampled else None)
    _, out = _reduced_engine_runs(knobs, sps, arch="minicpm3-4b")
    assert out["cuda"][0] == out["cpu"][0]
    st, cst = out["cuda"][1], out["cpu"][1]
    for k in ("decode_steps", "prefill_dispatches", "prefix_hits",
              "pages_shared", "pages_cow", "spec_drafted", "spec_accepted",
              "spec_tree_steps", "kv_dtype", "kv_bytes_per_slot",
              "pool_bytes", "moa_reduce_launches"):
        assert st[k] == cst[k], k
    assert st["decode_steps"] > 0
    assert out["cuda"][3] == (0,) * 6 == out["cpu"][3]


@pytest.mark.cuda
def test_mla_train_loss_on_the_card_equals_cpu(cuda_device):
    """mla_train is chunked attention (v_head_dim differs from the qk
    dim), so the flash kernels never launch; the loss and gradient norm
    equal the CPU's."""
    cfg = get_config("minicpm3-4b").reduced(dtype=torch.float32)
    params = init_params(get_api(cfg).param_specs(cfg),
                         torch.Generator().manual_seed(0),
                         torch.device("cpu"), torch.float32)
    toks = torch.randint(0, cfg.vocab, (2, 32),
                         generator=torch.Generator().manual_seed(1))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for dev in ("cpu", "cuda"):
            p = map_tree(lambda t: t.detach().to(dev).requires_grad_(),
                         params)
            counts = _kernel_launches()
            loss = lm.train_loss(p, {"tokens": toks.to(dev),
                                     "labels": toks.to(dev)}, cfg)
            grads = torch.autograd.grad(loss, [p["blocks"]["attn"]["wq_a"],
                                               p["blocks"]["attn"]["wkv_a"]])
            out[dev] = (float(loss.detach()),
                        [float(g.norm()) for g in grads],
                        tuple(a - b for a, b in zip(_kernel_launches(),
                                                    counts)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert abs(a - b) <= 1e-4 * max(1.0, b)
    assert out["cuda"][2] == (0,) * 6


#: the SSM and hybrid families at their reduced fp32 configs
SSM_ARCHS = ["falcon-mamba-7b", "zamba2-1.2b"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("sampled", [False, True])
def test_ssm_engine_on_the_card_equals_cpu(cuda_device, arch, sampled):
    """The reduced SSM and hybrid configs on contiguous slots: CUDA gives
    the CPU engine's tokens and counters, and launches no hand-written
    kernel (no page combine; the hybrid decodes through the dense
    ``gqa_decode``)."""
    sps = ([SamplingParams(temperature=0.8, top_k=40, seed=i)
            for i in range(4)] if sampled else None)
    _, out = _reduced_engine_runs({}, sps, arch=arch)
    assert out["cuda"][0] == out["cpu"][0]
    st, cst = out["cuda"][1], out["cpu"][1]
    assert st["pool_pages"] == 0 and st["spec_k"] == 0
    for k in ("decode_steps", "prefill_dispatches", "prefill_tokens",
              "admissions", "kv_bytes_per_slot", "pool_bytes",
              "moa_reduce_launches"):
        assert st[k] == cst[k], k
    assert st["decode_steps"] > 0
    assert out["cuda"][3] == (0,) * 6 == out["cpu"][3]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_train_loss_on_the_card_equals_cpu(cuda_device, arch):
    """The reduced SSM and hybrid losses and gradients, CUDA against CPU
    within 1e-4; the hybrid's shared attention runs the flash kernels,
    forward, dq and dk/dv once a group each."""
    cfg = get_config(arch).reduced(dtype=torch.float32)
    api = get_api(cfg)
    params = init_params(api.param_specs(cfg),
                         torch.Generator().manual_seed(0),
                         torch.device("cpu"), torch.float32)
    toks = torch.randint(0, cfg.vocab, (2, 33),
                         generator=torch.Generator().manual_seed(1))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for dev in ("cpu", "cuda"):
            p = map_tree(lambda t: t.detach().to(dev).requires_grad_(),
                         params)
            flat = leaves(p)
            counts = _kernel_launches()
            loss = api.train_loss(p, {"tokens": toks[:, :-1].to(dev),
                                      "labels": toks[:, 1:].to(dev)}, cfg)
            grads = torch.autograd.grad(loss, flat)
            torch.cuda.synchronize()
            out[dev] = (float(loss.detach()), [g.cpu() for g in grads],
                        tuple(a - b for a, b in zip(_kernel_launches(),
                                                    counts)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    groups = (cfg.n_layers // cfg.shared_attn_period
              if cfg.family == "hybrid" else 0)
    assert out["cuda"][2] == (0, groups, groups, groups, 0, 0)
    assert out["cpu"][2] == (0,) * 6


# ------------------------------------------------ modality frontends, ckpt
# the frontend families' heads at a short S: hubert-xlarge 16/16 heads of
# 80, non-causal; internvl2-26b 48/8 heads of 128 over 8 stub + 256 text
# positions, causal
FRONTEND_FLASH = [((2, 256, 16, 16, 80), False), ((1, 264, 48, 8, 128), True)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", FRONTEND_FLASH, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_at_the_frontend_shapes(cuda_device, shape, causal, dtype):
    """Forward and backward kernels against the plain versions, at the
    tolerances of the flash tests above."""
    q, k, v, do = _flash_inputs(*shape, dtype, cuda_device)
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, causal)
    dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, o, lse, do, causal)
    dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, lse, delta, do, causal)
    torch.cuda.synchronize()
    po, plse = fa.flash_attention_plain(q, k, v, causal)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(o.float(), po.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
    for got, want in zip((dq, dk, dv), fa.flash_attention_plain_bwd(
            q, k, v, o, lse, do, causal)):
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        else:
            assert _rel(got, want) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-26b"])
def test_frontend_train_step_cuda_matches_cpu(cuda_device, arch):
    """One train step of the reduced fp32 frontend model: the attention
    (non-causal for hubert) through the kernels, the CPU step's loss."""
    cfg = get_config(arch).reduced(dtype=torch.float32)
    state = init_train_state(cfg, torch.Generator().manual_seed(0))
    batch = host_batch(cfg, ShapeConfig("t", seq_len=64, global_batch=2,
                                        kind="train"),
                       HostDataConfig(0, 1, 0), 0)
    losses = {}
    for dev in ("cpu", "cuda"):
        st = map_tree(lambda t: t.to(dev, copy=True), state)
        step = build_train_step(cfg, AdamWConfig(lr=1e-3))
        before = (fa.LAUNCHES_FWD, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV)
        _, metrics = step(st, batch)
        losses[dev] = float(metrics["loss"])
        launched = tuple(a - b for a, b in zip(
            (fa.LAUNCHES_FWD, fa.LAUNCHES_BWD_DQ, fa.LAUNCHES_BWD_DKV),
            before))
    assert launched == (cfg.n_layers,) * 3
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4


@pytest.mark.cuda
def test_checkpoint_round_trip_on_cuda(cuda_device, tmp_path):
    """A CUDA train state with a bf16 leaf saves and restores onto cuda,
    equal leaf for leaf; a CPU target restores onto cuda with device=."""
    cfg = get_config("hubert-xlarge").reduced(dtype=torch.float32)
    state = init_train_state(cfg, torch.Generator(device=cuda_device)
                             .manual_seed(0))
    state["params"]["frontend_proj"] = \
        state["params"]["frontend_proj"].to(torch.bfloat16)
    ckpt.save_checkpoint(str(tmp_path), 4, state)
    target = map_tree(torch.zeros_like, state)
    got = ckpt.restore_checkpoint(str(tmp_path), 4, target)
    cpu_target = map_tree(lambda t: t.cpu(), target)
    moved = ckpt.restore_checkpoint(str(tmp_path), 4, cpu_target,
                                    device=cuda_device)
    for tree in (got, moved):
        for (_, a), (_, b) in zip(ckpt.flatten_with_paths(tree),
                                  ckpt.flatten_with_paths(state)):
            assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_async_checkpointer_refills_its_pinned_buffer(cuda_device, tmp_path):
    """A CUDA state is copied into a pinned host buffer, which the next
    save refills once the first save's files are written; each step on
    disk holds the values of its save."""
    ck = ckpt.AsyncCheckpointer(str(tmp_path), keep=3)
    state = {"a": torch.arange(6, dtype=torch.float32, device=cuda_device),
             "b": torch.ones((2, 3), dtype=torch.bfloat16,
                             device=cuda_device)}
    ck.save(1, state)
    ck.wait()
    first, = ck._free
    assert first.is_pinned()
    with torch.no_grad():
        for t in state.values():
            t.add_(1)
    ck.save(2, state)
    assert not ck._free
    ck.wait()
    assert ck._free[0] is first
    ck.close()
    for step in (1, 2):
        got = ckpt.restore_checkpoint(str(tmp_path), step,
                                      map_tree(torch.zeros_like, state))
        for name, t in state.items():
            assert torch.equal(got[name], t - (2 - step)), (step, name)


@pytest.mark.cuda
def test_train_loop_restart_is_exact_on_cuda(cuda_device, tmp_path):
    """4 straight steps of the reduced hubert on the card == 2 steps +
    restore (onto a state from another seed) + 2, bit for bit."""
    cfg = get_config("hubert-xlarge").reduced(dtype=torch.float32)
    shape = ShapeConfig("t", seq_len=64, global_batch=2, kind="train")
    step = build_train_step(cfg, AdamWConfig(lr=1e-3))

    def loop(seed, total, d):
        st = init_train_state(cfg, torch.Generator(device=cuda_device)
                              .manual_seed(seed))
        return TrainLoop(cfg, shape, LoopConfig(
            total_steps=total, ckpt_dir=str(d), ckpt_every=2, log_every=1,
            seed=3), step, st)

    straight = loop(0, 4, tmp_path / "a")
    final_a = straight.run()
    loop(0, 2, tmp_path / "b").run()
    resumed = loop(1, 4, tmp_path / "b")
    final_b = resumed.run()
    assert [m["step"] for m in resumed.metrics_log] == [3, 4]
    assert [m["loss"] for m in resumed.metrics_log] == \
        [m["loss"] for m in straight.metrics_log[2:]]
    for (_, a), (_, b) in zip(ckpt.flatten_with_paths(final_a),
                              ckpt.flatten_with_paths(final_b)):
        assert torch.equal(a, b)


# ------------------------------------- the QKV-bias archs, the autotune tier
@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(QKV_BIAS_HEADS))
@pytest.mark.parametrize("run", ["sequential", "chain", "contiguous"])
def test_qkv_bias_engine_on_the_card_equals_cpu(cuda_device, arch, run):
    """The reduced glm4-9b (group 16) and qwen2.5-14b (group 5) with
    nonzero biases: CUDA gives the CPU engine's tokens and counters and
    launches moa_reduce twice a layer a dispatch."""
    knobs = {"sequential": dict(prefix_cache=False),
             "chain": dict(spec_k=4),
             "contiguous": dict(paged_kv=False)}[run]
    cfg, out = _reduced_engine_runs(knobs, arch=arch)
    assert out["cuda"][0] == out["cpu"][0]
    st, cst = out["cuda"][1], out["cpu"][1]
    for k in ("decode_steps", "prefill_dispatches", "prefix_hits",
              "spec_drafted", "spec_accepted", "kv_bytes_per_slot",
              "pool_bytes", "pages_in_use"):
        assert st[k] == cst[k], k
    assert out["cuda"][2] == st["moa_reduce_launches"] == \
        2 * cfg.n_layers * (st["prefill_dispatches"] + st["decode_steps"]) > 0


@pytest.mark.cuda
def test_qkv_bias_train_loss_on_the_card_equals_cpu(cuda_device):
    """The reduced glm4-9b's loss and its bias gradients, CUDA (the flash
    kernels, once a layer each) against CPU within 1e-4."""
    cfg = get_config("glm4-9b").reduced(dtype=torch.float32,
                                        **QKV_BIAS_HEADS["glm4-9b"])
    params = _reduced_params(cfg)
    toks = torch.randint(0, cfg.vocab, (2, 33),
                         generator=torch.Generator().manual_seed(1))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for dev in ("cpu", "cuda"):
            p = map_tree(lambda t: t.detach().to(dev).requires_grad_(),
                         params)
            counts = _kernel_launches()
            loss = lm.train_loss(p, {"tokens": toks[:, :-1].to(dev),
                                     "labels": toks[:, 1:].to(dev)}, cfg)
            grads = torch.autograd.grad(
                loss, [p["blocks"]["attn"][k] for k in ("bq", "bk", "bv")])
            torch.cuda.synchronize()
            out[dev] = (float(loss.detach()), [g.cpu() for g in grads],
                        tuple(a - b for a, b in zip(_kernel_launches(),
                                                    counts)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    n = cfg.n_layers
    assert out["cuda"][2] == (0, n, n, n, 0, 0)


def _llama1(device):
    cfg = get_config("llama3.2-3b").reduced(dtype=torch.float32,
                                            n_kv_heads=2, n_layers=1)
    return cfg, map_tree(lambda t: t.to(device), _reduced_params(cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("traffic", ["burst", "multi-turn"])
def test_replay_open_loop_on_the_card_equals_cpu(cuda_device, traffic):
    """The virtual-clock replay (the ladder on a burst, or sessions over
    conversations): the CUDA engine's outputs and whole trajectory equal
    the CPU engine's, and the scheduler's clock is restored."""
    knobs = dict(max_slots=2, max_seq=96, prefill_chunk=16)
    if traffic == "burst":
        knobs.update(spec_k=3, degrade=True)
        trace = bursty_trace(18, rate=2.0, burst_rate=30.0, mean_prompt=16,
                             mean_gen=8, max_prompt=40, max_gen=16,
                             vocab=97, slo_ms=800.0, seed=11)
    else:
        trace = multi_turn_trace(2, 3, turn_tokens=8, gen=4, think_s=0.2,
                                 seed=2)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for dev in ("cpu", "cuda"):
            cfg, params = _llama1(dev)
            eng = ServeEngine(cfg, params, config=EngineConfig(**knobs),
                              device=dev)
            clock = eng.scheduler.clock
            out[dev] = replay_open_loop(eng, trace,
                                        VirtualCosts(0.01, 0.02, 0.03))
            assert eng.scheduler.clock is clock
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    got, want = out["cuda"], out["cpu"]
    for key in ("outputs", "elapsed_s", "steps", "served_tokens",
                "goodput_tokens", "slo_met", "slo_missed", "shed"):
        assert got[key] == want[key], key
    for key in ("decode_steps", "prefill_dispatches", "spec_steps",
                "preemptions", "degrade_transitions", "session_hits"):
        assert got["stats"][key] == want["stats"][key], key
    assert got["stats"]["moa_reduce_launches"] > 0


@pytest.mark.cuda
def test_run_sweep_profiles_the_card(cuda_device, tmp_path):
    """run_sweep on the card with profile_dir: every valid point carries
    metrics and a non-empty Chrome trace with CUDA kernel events, the
    rejected point its error."""
    cfg, params = _llama1("cuda")
    base = EngineConfig(max_slots=2, max_seq=64, prefill_chunk=16)
    points = [base, base.replace(spec_k=3), base.replace(page_size=24)]
    prompts, gens = sweep_workload(cfg.vocab, requests=3, shared_prefix=16,
                                   tail=4, gen=6)
    recs = run_sweep(cfg, params, points, prompts, gens,
                     profile_dir=str(tmp_path))
    assert "error" in recs[2] and "metrics" not in recs[2]
    for rec in recs[:2]:
        assert "profile_error" not in rec and rec["metrics"]["pool_bytes"]
        text = (Path(rec["trace_dir"]) / TRACE_FILE).read_text()
        assert '"cat": "kernel"' in text
