"""Plain PyTorch oracles of the kernels (counterpart of ``repro/kernels/ref.py``).

Only ``moa_reduce_ref`` so far: the other three oracles arrive with their
kernels (``ROADMAP.md``, queue 2)."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["moa_reduce_ref"]


def moa_reduce_ref(x: torch.Tensor, acc_dtype: torch.dtype = torch.float32,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Sum of stacked operands over axis 0, accumulated in ``acc_dtype``."""
    out_dtype = out_dtype or x.dtype
    return torch.sum(x.to(acc_dtype), dim=0).to(out_dtype)
