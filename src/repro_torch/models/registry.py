"""Model API dispatch (counterpart of ``repro/models/registry.py``).

The port serves and trains the dense GQA decoder: ``family`` dense or vlm
(the vision stub only feeds training, and raises there until its ROADMAP
item), ``attn_kind == "gqa"``, no experts.  Every other family raises
``NotImplementedError`` naming the ROADMAP.md item that brings it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm

__all__ = ["ModelAPI", "get_api"]


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    """Entry points of one family's training and decode paths."""

    param_specs: Callable[[ModelConfig], Any]
    #: scalar loss of (params, batch {tokens, labels[, loss_mask]}, cfg)
    train_loss: Callable[..., Any]
    #: (params, batch, cfg) -> (logits (B, S, V), aux_loss)
    forward: Callable[..., Any]
    decode_state_specs: Callable[..., Any]
    #: one token per slot: batch {tokens (B, 1), index (B,), pages}
    decode_step: Callable[..., Any]
    #: a (B, C) prompt chunk in one dispatch: batch {tokens, index, nvalid,
    #: pages}; returns the logits at the last valid row
    prefill_chunk: Callable[..., Any]


def get_api(cfg: ModelConfig) -> ModelAPI:
    """The API for ``cfg``; raises for families the port does not run
    yet."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.arch_id} is encoder-only: it has no decode "
                         f"path")
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.arch_id}: SSM/hybrid families arrive with ROADMAP.md "
            f"queue 1 item 10")
    if cfg.attn_kind == "mla":
        raise NotImplementedError(
            f"{cfg.arch_id}: MLA decode arrives with ROADMAP.md queue 1 "
            f"item 6")
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.arch_id}: MoE FFNs arrive with ROADMAP.md queue 1 item 11")
    if cfg.attn_kind != "gqa":
        raise NotImplementedError(
            f"{cfg.arch_id}: attn_kind={cfg.attn_kind!r} is not served by "
            f"the port")
    return ModelAPI(param_specs=lm.param_specs, train_loss=lm.train_loss,
                    forward=lm.forward,
                    decode_state_specs=lm.decode_state_specs,
                    decode_step=lm.decode_step,
                    prefill_chunk=lm.prefill_chunk)
