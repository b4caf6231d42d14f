"""Decoder LM, decode side: parameter layout, paged decode and chunked prefill.

The counterpart of ``repro/models/lm.py`` for the dense GQA decoder the
serve engine runs.  Parameters are a plain dict of tensors in the JAX
tree's layout, with ``blocks`` stacked on a leading layers axis; the block
stack runs as a Python loop over layers (``lax.scan`` in JAX).  The state
leaves are physical page pools ``(layers, num_pages, page_size, Hkv, hd)``
(see :func:`repro_torch.serve.cache.paged_state_specs`), updated in place.

Not in this slice: training and the full forward, dense (unpaged) decode
caches, MLA, MoE, speculative and tree verification, draft heads
(``ROADMAP.md``, queue 1).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, moe
from repro_torch.models.common import ParamSpec, map_specs, rms_norm

__all__ = ["param_specs", "block_specs", "stack_specs", "decode_state_specs",
           "decode_step", "prefill_chunk"]


def stack_specs(per_layer: Any, n: int) -> Any:
    """Add a leading (n, ...) 'layers' axis to every spec in a tree."""
    return map_specs(
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
    x = params["embed"][batch["tokens"]]
    for i in range(cfg.n_layers):
        bp = {k: (v[i] if isinstance(v, torch.Tensor)
                  else {kk: vv[i] for kk, vv in v.items()})
              for k, v in blocks.items()}
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
    logits = (x @ params["lm_head"])[:, -1]
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
    logits = (x_last @ params["lm_head"])[:, 0]
    return logits.float(), state
