"""Public entry points of the kernel layer, dispatched on the tensor's device.

The counterpart of ``repro/kernels/ops.py``, which dispatched on
``on_tpu()``: here a CUDA tensor goes to the hand-written kernel and a CPU
tensor to its plain PyTorch version.  There is no fallback: a CUDA call
launches the kernel or raises."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moa_reduce as _moa

__all__ = ["moa_reduce", "flash_attention"]


def moa_reduce(x: torch.Tensor, acc_dtype: torch.dtype = torch.float32,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Fused multi-operand sum over axis 0 of ``(N, ...)`` operands.

    Trailing dims are flattened into the kernel's ``(N, M)`` column space
    and restored afterwards; the sum runs in ``acc_dtype`` and is cast to
    ``out_dtype`` (default: the input dtype)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return _moa.moa_reduce_plain(x, acc_dtype, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"moa_reduce runs on cuda or cpu, got {x.device}")
    n = x.shape[0]
    out = _moa.moa_reduce_cuda(x.reshape(n, -1).contiguous(), acc_dtype)
    return out.reshape(x.shape[1:]).to(out_dtype)


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
    if q.device.type == "cpu":
        return _fa.FlashAttentionPlain.apply(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    return _fa.FlashAttention.apply(q, k, v, causal, scale)
