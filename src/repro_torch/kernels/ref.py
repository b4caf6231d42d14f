"""Plain PyTorch oracles of the kernels (counterpart of ``repro/kernels/ref.py``).

``moa_reduce_ref`` and ``flash_attention_ref`` so far: the other two
oracles arrive with their kernels (``ROADMAP.md``, queue 2)."""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["moa_reduce_ref", "flash_attention_ref"]


def moa_reduce_ref(x: torch.Tensor, acc_dtype: torch.dtype = torch.float32,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Sum of stacked operands over axis 0, accumulated in ``acc_dtype``."""
    out_dtype = out_dtype or x.dtype
    return torch.sum(x.to(acc_dtype), dim=0).to(out_dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None
                        ) -> torch.Tensor:
    """Materialised-softmax causal GQA attention. q: (B,S,Hq,hd);
    k/v: (B,S,Hkv,hd). fp32 softmax with -1e30 masking, output in q.dtype."""
    s, hq, hd = q.shape[1], q.shape[2], q.shape[3]
    rep = hq // k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask[None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)
