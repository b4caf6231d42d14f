"""Model API dispatch (counterpart of ``repro/models/registry.py``).

The port serves and trains every decoder family of the JAX package:
``family`` dense, moe or vlm (the vision stub only feeds training),
``attn_kind`` ``"gqa"`` or ``"mla"``, with a dense or a routed MoE FFN,
through :mod:`repro_torch.models.lm`; and ``family`` ssm
(``falcon-mamba-7b``) and hybrid (``zamba2-1.2b``) through
:mod:`repro_torch.models.hybrid`, whose O(1) recurrent state cannot be
rewound position by position, so they have no speculative verification and
no draft heads.  An encoder-only config (``hubert-xlarge``) gets the train
API with every decode entry ``None``; :func:`serve_api` refuses it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid, lm

__all__ = ["ModelAPI", "get_api", "serve_api"]


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    """Entry points of one family's training and decode paths."""

    param_specs: Callable[[ModelConfig], Any]
    #: scalar loss of (params, batch {tokens, labels[, loss_mask]}, cfg,
    #: mesh=None); on a device mesh, of the rank's rows
    train_loss: Callable[..., Any]
    #: (params, batch, cfg, mesh=None) -> (logits (B, S, V), aux_loss)
    forward: Callable[..., Any]
    #: the decode entries are None for an encoder-only config
    decode_state_specs: Optional[Callable[..., Any]]
    #: one token per slot: batch {tokens (B, 1), index (B,), pages}
    decode_step: Optional[Callable[..., Any]]
    #: a (B, C) prompt chunk in one dispatch: batch {tokens, index, nvalid,
    #: pages}; returns the logits at the last valid row
    prefill_chunk: Optional[Callable[..., Any]]
    #: speculative verification of a (B, K+1) drafted block in one
    #: dispatch: batch {tokens, index, nspec, pages}; returns the logits at
    #: every fed row.  None keeps speculative decode off for a family.
    verify_chunk: Optional[Callable[..., Any]] = None
    #: tree verification under the ancestor mask: batch {tokens, index,
    #: parents, pos_off, nchain, nspec, pages}; returns (logits at every
    #: row, draft-head candidates or None, state).  None keeps the tree and
    #: auto modes off.
    verify_tree: Optional[Callable[..., Any]] = None
    #: draft-head parameter declaration (cfg, n_heads) -> specs
    draft_head_specs: Optional[Callable[..., Any]] = None


def get_api(cfg: ModelConfig) -> ModelAPI:
    """The API for ``cfg``; raises for an attention kind the port does not
    run."""
    if cfg.family == "ssm":
        return ModelAPI(param_specs=hybrid.ssm_param_specs,
                        train_loss=hybrid.ssm_train_loss,
                        forward=hybrid.ssm_forward,
                        decode_state_specs=hybrid.ssm_decode_state_specs,
                        decode_step=hybrid.ssm_decode_step,
                        prefill_chunk=hybrid.ssm_prefill_chunk)
    if cfg.family == "hybrid":
        return ModelAPI(param_specs=hybrid.hybrid_param_specs,
                        train_loss=hybrid.hybrid_train_loss,
                        forward=hybrid.hybrid_forward,
                        decode_state_specs=hybrid.hybrid_decode_state_specs,
                        decode_step=hybrid.hybrid_decode_step,
                        prefill_chunk=hybrid.hybrid_prefill_chunk)
    if cfg.attn_kind not in ("gqa", "mla"):
        raise NotImplementedError(
            f"{cfg.arch_id}: attn_kind={cfg.attn_kind!r} is not served by "
            f"the port")
    if cfg.encoder_only:
        return ModelAPI(param_specs=lm.param_specs, train_loss=lm.train_loss,
                        forward=lm.forward, decode_state_specs=None,
                        decode_step=None, prefill_chunk=None)
    return ModelAPI(param_specs=lm.param_specs, train_loss=lm.train_loss,
                    forward=lm.forward,
                    decode_state_specs=lm.decode_state_specs,
                    decode_step=lm.decode_step,
                    prefill_chunk=lm.prefill_chunk,
                    verify_chunk=lm.verify_chunk,
                    verify_tree=lm.verify_tree,
                    draft_head_specs=lm.draft_head_specs)


def serve_api(cfg: ModelConfig) -> ModelAPI:
    """:func:`get_api` for the serve entry points: raises ``ValueError`` for
    an encoder-only config, which has no decode step."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.arch_id} is encoder-only: it has no decode "
                         f"step, so it cannot be served")
    return get_api(cfg)
