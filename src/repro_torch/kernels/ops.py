"""Public entry points of the kernel layer, dispatched on the tensor's device.

The counterpart of ``repro/kernels/ops.py``, which dispatched on
``on_tpu()``: here a CUDA tensor goes to the hand-written kernel and a CPU
tensor to its plain PyTorch version.  A meta tensor (the dry run's: a
shape with no storage, never on the card) takes the plain version too,
which then only propagates shapes; it reaches no build, no launch counter
and no kernel wrapper.  There is no fallback: a CUDA call launches the
kernel or raises, and any other device raises."""
from __future__ import annotations

from typing import Optional

import torch

#: devices whose tensors take the plain versions
_PLAIN = ("cpu", "meta")

from repro_torch.kernels import bitplane_add as _bpa
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moa_reduce as _moa
from repro_torch.kernels import quant_matmul as _qmm

__all__ = ["moa_reduce", "bitplane_add", "quant_matmul", "flash_attention"]


def moa_reduce(x: torch.Tensor, acc_dtype: torch.dtype = torch.float32,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Fused multi-operand sum over axis 0 of ``(N, ...)`` operands.

    Trailing dims are flattened into the kernel's ``(N, M)`` column space
    and restored afterwards; the sum runs in ``acc_dtype`` and is cast to
    ``out_dtype`` (default: the input dtype).  Differentiable on both
    devices (:class:`~repro_torch.kernels.moa_reduce.MoaReduce` on the
    card)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type in _PLAIN:
        return _moa.moa_reduce_plain(x, acc_dtype, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"moa_reduce runs on cuda, cpu or meta, got "
                         f"{x.device}")
    n = x.shape[0]
    out = _moa.MoaReduce.apply(x.reshape(n, -1).contiguous(), acc_dtype)
    return out.reshape(x.shape[1:]).to(out_dtype)


def bitplane_add(x: torch.Tensor, m_bits: int) -> torch.Tensor:
    """Exact N-operand integer addition per lane, bit-serially (paper
    Algorithm 2): ``x`` is ``(N, B)`` with each value < 2**m_bits; returns
    the ``(B,)`` int32 sums.  Raises ``ValueError`` when a sum could need
    more than 31 bits."""
    x = x.to(torch.int32)
    if x.device.type in _PLAIN:
        return _bpa.bitplane_add_plain(x, m_bits)
    if x.device.type != "cuda":
        raise ValueError(f"bitplane_add runs on cuda, cpu or meta, got "
                         f"{x.device}")
    return _bpa.bitplane_add_cuda(x.contiguous(), m_bits)


def quant_matmul(x: torch.Tensor, w: torch.Tensor, acc_bits: int = 32
                 ) -> torch.Tensor:
    """Exact ``x @ w`` of int8 operands (cast like the reference's
    ``astype(int8)``) as int32, with the K blocking that the Theorem plans
    for an ``acc_bits`` accumulator."""
    x, w = x.to(torch.int8), w.to(torch.int8)
    if x.device.type in _PLAIN:
        return _qmm.quant_matmul_plain(x, w, acc_bits)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cuda, cpu or meta, got "
                         f"{x.device}")
    return _qmm.quant_matmul_cuda(x.contiguous(), w.contiguous(), acc_bits)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Streaming-softmax causal GQA attention, differentiable.

    q: (B, S, Hq, hd); k/v: (B, S, Hkv, hd); returns (B, S, Hq, hd) in
    q.dtype.  CUDA tensors run the forward kernel and, under autograd, the
    backward kernels (:class:`~repro_torch.kernels.flash_attention.FlashAttention`);
    CPU tensors run the plain versions through the same autograd shape."""
    if scale is None:
        scale = _fa.default_scale(q.shape[-1])
    if q.device.type in _PLAIN:
        return _fa.FlashAttentionPlain.apply(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda, cpu or meta, got "
                         f"{q.device}")
    return _fa.FlashAttention.apply(q, k, v, causal, scale)
