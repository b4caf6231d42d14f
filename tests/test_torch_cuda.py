"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Tests marked ``cuda`` skip without a CUDA device (a CUDA kernel has no CPU
mode); on the card run ``python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports no JAX, so it runs where only PyTorch is installed."""
import pytest
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import HostDataConfig, host_batch
from repro_torch.kernels import bitplane_add as bpa
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moa_reduce as moa
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as qmm
from repro_torch.launch import sass_mix
from repro_torch.models import attention
from repro_torch.models.common import init_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.state import build_train_step, init_train_state
from repro_torch.tree import map_tree

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
@pytest.mark.parametrize("n,m", [(1, 64), (2, 1024), (5, 3), (7, 8227),
                                 (16, 96), (16, 12288), (16, 6144),
                                 (33, 2080), (16, 786432), (300, 640)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_equals_plain_bit_for_bit(cuda_device, n, m, dtype):
    x, acc = _operands(n, m, dtype, cuda_device)
    before = moa.LAUNCHES
    got = moa.moa_reduce_cuda(x, acc)
    torch.cuda.synchronize()
    assert moa.LAUNCHES == before + 1
    assert torch.equal(got, moa.moa_reduce_plain(x, acc, acc))


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


# ------------------------------------------------------------ bitplane_add
# (N, M, B): the shapes of tests/test_kernels.py:60-82 and the Fig-15
# 16 x 16 adder over one llama3.2-3b activation tensor (4096 tokens x d_model)
_LLAMA = get_config("llama3.2-3b")
_TOKENS = 2 * 2048
BITPLANE_SHAPES = [(4, 4, 64), (4, 16, 256), (16, 16, 128), (3, 8, 33),
                   (64, 20, 512), (1, 31, 100),
                   (16, 16, _TOKENS * _LLAMA.d_model)]


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
