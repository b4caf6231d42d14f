"""Decoder LM: parameter layout, the training forward and loss, paged decode.

The counterpart of ``repro/models/lm.py`` for the dense GQA decoder.
Parameters are a plain dict of tensors in the JAX tree's layout, with
``blocks`` stacked on a leading layers axis (or, as the train step passes
them, a list of per-layer dicts of views: see
:func:`repro_torch.train.state.split_layers`); the block stack runs as a
Python loop over layers (``lax.scan`` in JAX).  For decode, the state
leaves are physical page pools ``(layers, num_pages, page_size, Hkv, hd)``
(see :func:`repro_torch.serve.cache.paged_state_specs`), updated in place.

Not in these slices: dense (unpaged) decode caches, MLA, MoE, the vision
and audio frontend stubs, speculative and tree verification, draft heads
(``ROADMAP.md``, queue 1).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, moe
from repro_torch.models.common import ParamSpec, cross_entropy_loss, rms_norm
from repro_torch.tree import index_tree, map_tree

__all__ = ["param_specs", "block_specs", "stack_specs", "forward",
           "train_loss", "embed_inputs", "decode_state_specs",
           "decode_step", "prefill_chunk"]


def stack_specs(per_layer: Any, n: int) -> Any:
    """Add a leading (n, ...) 'layers' axis to every spec in a tree."""
    return map_tree(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                            dtype=s.dtype, init=s.init, scale=s.scale),
        per_layer)


def block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """One decoder block: pre-norm attention + pre-norm FFN."""
    d = cfg.d_model
    return {
        "attn_norm": ParamSpec((d,), ("embed",), init="ones"),
        "ffn_norm": ParamSpec((d,), ("embed",), init="ones"),
        "attn": attention.gqa_param_specs(cfg),
        "ffn": moe.dense_ffn_specs(cfg),
    }


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The whole model's parameter declaration, in the JAX tree's layout."""
    d = cfg.d_model
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"), scale=0.02),
        "blocks": stack_specs(block_specs(cfg), cfg.n_layers),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
        "lm_head": ParamSpec((d, cfg.vocab), ("embed", "vocab")),
    }
    if cfg.frontend:
        specs["frontend_proj"] = ParamSpec((cfg.frontend_dim, d),
                                           (None, "embed"))
    return specs


def decode_state_specs(cfg: ModelConfig, batch: int, max_seq: int
                       ) -> Dict[str, ParamSpec]:
    """Contiguous KV-cache layout; the serve tier rewrites its adjacent
    ``(batch, kv_seq)`` axis pair into a page pool."""
    l, hd = cfg.n_layers, cfg.hd
    return {
        name: ParamSpec((l, batch, max_seq, cfg.n_kv_heads, hd),
                        ("layers", "batch", "kv_seq", None, None),
                        dtype=cfg.dtype, init="zeros")
        for name in ("k", "v")
    }


def _layer(blocks: Any, i: int) -> dict:
    """Layer ``i``'s params from the stacked dict or the per-layer list."""
    return blocks[i] if isinstance(blocks, list) else index_tree(blocks, i)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _block_train(x: torch.Tensor, bp: dict, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, bp["attn_norm"], cfg.norm_eps)
    x = x + attention.gqa_train(h, bp["attn"], cfg)
    h = rms_norm(x, bp["ffn_norm"], cfg.norm_eps)
    return x + moe.dense_ffn(h, bp["ffn"], cfg)


def embed_inputs(params: dict, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig) -> torch.Tensor:
    """Token embedding (B, S) -> (B, S, D) in the compute dtype."""
    if cfg.frontend:
        raise NotImplementedError(
            f"{cfg.arch_id}: the {cfg.frontend} frontend arrives with "
            f"ROADMAP.md queue 1 item 12")
    return params["embed"][batch["tokens"].long()].to(cfg.dtype)


def forward(params: dict, batch: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V) in the compute dtype, aux_loss).

    With ``cfg.remat`` and grad enabled, each layer runs under
    ``torch.utils.checkpoint`` (the counterpart of ``jax.checkpoint`` with
    ``nothing_saveable``): only its input is kept, and the backward runs
    the layer's forward again."""
    x = embed_inputs(params, batch, cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        bp = _layer(params["blocks"], i)
        if remat:
            x = checkpoint(_block_train, x, bp, cfg, use_reentrant=False)
        else:
            x = _block_train(x, bp, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ params["lm_head"].to(x.dtype)
    # dense FFNs have no router loss (MoE arrives with queue 1 item 11)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def train_loss(params: dict, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token NLL of ``batch["labels"]`` (+ the aux loss)."""
    logits, aux = forward(params, batch, cfg)
    return cross_entropy_loss(logits, batch["labels"],
                              batch.get("loss_mask")) + aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _decode_blocks(params: dict, state: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor], cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the block stack over C new tokens against paged KV pools.

    batch: {"tokens": (B, C) int64, "index": 0-d chunk start or (B,)
    per-slot lengths, "pages": (B, n_pages) int64 page table}.  Every layer
    attends over its gathered pages and scatters its new rows into its
    pool, in place.  Returns the final hidden states (B, C, D) and the
    state (the same dict)."""
    cur = batch["index"]
    pages = batch["pages"]
    blocks = params["blocks"]
    x = params["embed"][batch["tokens"]].to(cfg.dtype)
    for i in range(cfg.n_layers):
        bp = _layer(blocks, i)
        h = rms_norm(x, bp["attn_norm"], cfg.norm_eps)
        h, _, _ = attention.gqa_decode_pages(
            h, bp["attn"], cfg, state["k"][i], state["v"][i], cur, pages)
        x = x + h
        h = rms_norm(x, bp["ffn_norm"], cfg.norm_eps)
        x = x + moe.dense_ffn(h, bp["ffn"], cfg)
    return x, state


def decode_step(params: dict, state: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor], cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One new token for every slot. batch: {"tokens": (B, 1), "index":
    (B,) per-slot lengths, "pages": (B, n_pages)}.  Returns (logits (B, V)
    float32, state)."""
    x, state = _decode_blocks(params, state, batch, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"].to(x.dtype))[:, -1]
    return logits.float(), state


def prefill_chunk(params: dict, state: Dict[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor], cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Ingest a prompt chunk in one dispatch. batch: {"tokens": (B, C),
    "index": 0-d chunk start, "nvalid": count of real tokens in the chunk
    (trailing bucket padding only writes masked-off positions), "pages":
    (B, n_pages)}.  Returns (logits (B, V) float32 at row ``nvalid - 1``,
    state)."""
    x, state = _decode_blocks(params, state, batch, cfg)
    c = x.shape[1]
    last = min(max(int(batch.get("nvalid", c)) - 1, 0), c - 1)
    x_last = rms_norm(x[:, last:last + 1], params["final_norm"],
                      cfg.norm_eps)
    logits = (x_last @ params["lm_head"].to(x_last.dtype))[:, 0]
    return logits.float(), state
