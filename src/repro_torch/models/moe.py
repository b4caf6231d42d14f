"""Feed-forward layer: the dense SwiGLU FFN (counterpart of the dense half of
``repro/models/moe.py``).  The routed MoE FFN and its ``moa_reduce`` top-k
combine arrive with ROADMAP.md queue 1 item 11."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec

__all__ = ["dense_ffn_specs", "dense_ffn"]


def dense_ffn_specs(cfg: ModelConfig) -> dict:
    """Per-layer SwiGLU params (leading layer axis added by the caller)."""
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w1": ParamSpec((d, f), ("embed", "mlp")),
        "w3": ParamSpec((d, f), ("embed", "mlp")),
        "w2": ParamSpec((f, d), ("mlp", "embed")),
    }


def dense_ffn(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """``(silu(x @ w1) * (x @ w3)) @ w2``."""
    return (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]
