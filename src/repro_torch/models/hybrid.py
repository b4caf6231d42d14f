"""SSM LM (falcon-mamba) and the Mamba-2 + shared-attention hybrid (zamba2).

The counterpart of ``repro/models/hybrid.py`` on one card.

* **SSM LM** (``family="ssm"``): pre-norm residual Mamba blocks
  (:mod:`repro_torch.models.ssm`, Mamba-1 or Mamba-2 by
  ``cfg.ssm_variant``), ``blocks`` stacked on a leading layers axis (or, as
  the train step passes them, a list of per-layer dicts).
* **zamba2 hybrid** (``family="hybrid"``): groups of
  ``shared_attn_period`` Mamba-2 layers, each group followed by ONE call of
  a weight-shared attention + SwiGLU block whose query projection gets
  that group's LoRA delta, ``wq + lora_a[g] @ lora_b[g]``, built as a new
  tensor at every call (the shared weights are never written).  Layers
  past the last full group form a tail (``hybrid_layout``).  The shared
  block trains through :func:`repro_torch.models.attention.gqa_train`, so
  on the card through the flash attention kernels.

Decode state is O(1) in the sequence for the Mamba layers: per layer an
fp32 ``h`` and a ``conv`` window (:func:`ssm_decode_state_specs`); the
hybrid adds one dense ``k`` / ``v`` cache per group, attended with one
softmax (:func:`repro_torch.models.attention.gqa_decode`).  The decode
steps write the new state into the given tensors in place (a contiguous
engine passes its slot rows as views) and return the same dict.  Chunked
prefill (:func:`_scan_prefill`) is the decode step repeated over the
chunk's valid tokens, so it equals the per-token loop exactly.  These
families cannot rewind state position by position, so they have no
speculative verification, and their state is neither paged nor shared by
prefix (``EngineConfig.resolve``).

On a device mesh (:class:`repro_torch.launch.mesh.Mesh`) each rank runs
its own batch rows; the Mamba layers run whole on every ``model`` rank
(the JAX package shards their inner axis by sharding constraints alone),
the shared attention trains with its heads split over ``model``
(:func:`repro_torch.models.attention.gqa_train`) and decodes with split-K
for a 0-d index (:func:`repro_torch.models.attention.gqa_decode_splitk`,
each rank holding its stretch of the ``k`` / ``v`` cache).  Where
``model`` divides the sequence the residual stream between layers is
each rank's stretch of it, as the JAX package constrains it: a Mamba
layer gathers the sequence for its scan and keeps the rank's stretch,
the shared block's attention gathers it and reduce-scatters its heads'
outputs, and the logits and loss are the stretch's
(:func:`repro_torch.models.lm.lm_loss`).  Decode and chunked prefill take
params laid out as the sharded train step holds them
(:func:`repro_torch.train.state.mesh_params`).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, moe, ssm
from repro_torch.models.common import (ParamSpec, ShardedLayer, rms_norm,
                                       whole, whole_sequence)
from repro_torch.models.lm import (_layer, _splitk, embed_inputs,
                                   gather_logits, head_logits, lm_loss,
                                   logits_split, stack_specs,
                                   vocab_parallel_embed)
from repro_torch.tree import index_tree

__all__ = [
    "ssm_param_specs", "ssm_train_loss", "ssm_decode_state_specs",
    "ssm_decode_step", "ssm_forward", "ssm_prefill_chunk",
    "hybrid_param_specs", "hybrid_train_loss", "hybrid_decode_state_specs",
    "hybrid_decode_step", "hybrid_forward", "hybrid_layout",
    "hybrid_prefill_chunk",
]


# ---------------------------------------------------------------------------
# pure SSM LM (mamba1 / mamba2 backbone)
# ---------------------------------------------------------------------------

def _ssm_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    sp = (ssm.mamba1_param_specs if cfg.ssm_variant == "mamba1"
          else ssm.mamba2_param_specs)(cfg)
    return {"norm": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
            "ssm": sp}


def ssm_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                           scale=0.02),
        "blocks": stack_specs(_ssm_block_specs(cfg), cfg.n_layers),
        "final_norm": ParamSpec((cfg.d_model,), ("embed",), init="ones"),
        "lm_head": ParamSpec((cfg.d_model, cfg.vocab), ("embed", "vocab")),
    }


def _ssm_apply(x: torch.Tensor, bp: dict, cfg: ModelConfig, mesh=None,
               sp: bool = False) -> torch.Tensor:
    """One residual Mamba block with whole params ``bp``; with ``sp`` on
    this rank's stretch of the stream, the scan run on the gathered
    sequence (:func:`~repro_torch.models.common.whole_sequence`)."""
    train = (ssm.mamba1_train if cfg.ssm_variant == "mamba1"
             else ssm.mamba2_train)
    layer = lambda x: x + train(rms_norm(x, bp["norm"], cfg.norm_eps),
                                bp["ssm"], cfg)
    return whole_sequence(layer, x, mesh) if sp else layer(x)


def _maybe_remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` under ``torch.utils.checkpoint`` when ``cfg.remat`` and grad
    are on (``jax.checkpoint`` with ``nothing_saveable``: only the input is
    kept, the backward runs ``fn`` again), else ``fn``."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def _ssm_stack(params: dict, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, mesh, sp: bool) -> torch.Tensor:
    x = embed_inputs(params, batch, cfg, mesh, sp)
    sp_mesh = mesh if sp else None
    layer = _maybe_remat(lambda x, bp: _ssm_apply(x, whole(bp, sp_mesh), cfg,
                                                  mesh, sp), cfg)
    for i in range(cfg.n_layers):
        x = layer(x, _layer(params["blocks"], i))
    return x


def ssm_forward(params: dict, batch: Dict[str, torch.Tensor],
                cfg: ModelConfig, mesh=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V) in the compute dtype, a zero aux loss).
    On a ``mesh`` every rank runs its rows whole (no collective but the
    embedding's and, for params given as blocks, their gathers), or where
    ``model`` divides the sequence, its stretch of them between layers
    (the logits returned gathered whole)."""
    split = logits_split(batch, cfg, mesh)
    x = _ssm_stack(params, batch, cfg, mesh, split == 1)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return gather_logits(head_logits(x, params, cfg, mesh, split), cfg,
                         mesh, split), aux


def ssm_train_loss(params: dict, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig, mesh=None) -> torch.Tensor:
    split = logits_split(batch, cfg, mesh)
    x = _ssm_stack(params, batch, cfg, mesh, split == 1)
    return lm_loss(x, params, batch, cfg, mesh, split)


def ssm_decode_state_specs(cfg: ModelConfig, batch: int, max_seq: int
                           ) -> Dict[str, ParamSpec]:
    """O(1)-in-sequence decode state: an SSM's "KV cache" is a fixed
    (d_inner, N) summary and a (K-1)-row conv window a layer, whatever the
    context length."""
    del max_seq
    l = cfg.n_layers
    if cfg.ssm_variant == "mamba1":
        return {
            "h": ParamSpec((l, batch, cfg.d_inner, cfg.ssm_state),
                           ("layers", "batch", "ssm_inner", "ssm_state"),
                           dtype=torch.float32, init="zeros"),
            "conv": ParamSpec((l, batch, cfg.ssm_conv - 1, cfg.d_inner),
                              ("layers", "batch", None, "ssm_inner"),
                              dtype=cfg.dtype, init="zeros"),
        }
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "h": ParamSpec((l, batch, cfg.ssm_heads, cfg.ssm_state,
                        cfg.ssm_head_dim),
                       ("layers", "batch", "ssm_heads", "ssm_state", None),
                       dtype=torch.float32, init="zeros"),
        "conv": ParamSpec((l, batch, cfg.ssm_conv - 1, conv_dim),
                          ("layers", "batch", None, "ssm_inner"),
                          dtype=cfg.dtype, init="zeros"),
    }


def _mamba_decode_layer(x: torch.Tensor, bp: dict, cfg: ModelConfig,
                        state: Dict[str, torch.Tensor], i: int
                        ) -> torch.Tensor:
    """One residual Mamba block at layer ``i`` of ``state``; the layer's
    new ``h`` and ``conv`` are written into ``state`` in place."""
    step = (ssm.mamba1_decode if cfg.ssm_variant == "mamba1"
            else ssm.mamba2_decode)
    hin = rms_norm(x, bp["norm"], cfg.norm_eps)
    out, new = step(hin, bp["ssm"], cfg,
                    {"h": state["h"][i], "conv": state["conv"][i]})
    state["h"][i].copy_(new["h"])
    state["conv"][i].copy_(new["conv"])
    return x + out


def _decode_logits(x: torch.Tensor, params: dict, cfg: ModelConfig
                   ) -> torch.Tensor:
    return head_logits(x, params, cfg)[:, 0].float()


def ssm_decode_step(params: dict, state: Dict[str, torch.Tensor],
                    batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                    mesh=None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token a slot: batch {"tokens": (B, 1), "index": 0-d or (B,)
    (unused: the state carries the position)}.  Returns (logits (B, V)
    float32, state updated in place).  On a ``mesh`` the state and the
    tokens are this rank's rows, the embedding vocab-parallel and each
    layer gathered where it runs if given as a
    :class:`~repro_torch.models.common.ShardedLayer`."""
    x = vocab_parallel_embed(batch["tokens"], params["embed"], mesh,
                             cfg.vocab, cfg.use_tp_shardmap).to(cfg.dtype)
    for i in range(cfg.n_layers):
        x = _mamba_decode_layer(x, whole(_layer(params["blocks"], i)), cfg,
                                state, i)
    return _decode_logits(x, params, cfg), state


def _scan_prefill(decode_step_fn: Callable, params: dict,
                  state: Dict[str, torch.Tensor],
                  batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                  mesh=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Chunked prefill for recurrent-state families: the single-token
    decode step over the chunk's first ``nvalid`` tokens, so it equals the
    per-token loop exactly; bucket padding past ``nvalid`` is never fed
    (the reference masks it out of the state and the logits).

    batch: {"tokens": (B, C), "index": 0-d chunk start, "nvalid": count of
    real tokens (<= C)}.  Returns (logits (B, V) float32 at row ``nvalid -
    1``, zeros when ``nvalid`` is 0; state, updated in place).  ``mesh`` is
    handed to every step."""
    tokens = batch["tokens"]
    b, c = tokens.shape
    start = torch.as_tensor(batch["index"], device=tokens.device)
    nvalid = min(int(batch.get("nvalid", c)), c)
    logits = torch.zeros((b, cfg.vocab), dtype=torch.float32,
                         device=tokens.device)
    for t in range(nvalid):
        logits, state = decode_step_fn(
            params, state, {"tokens": tokens[:, t:t + 1], "index": start + t},
            cfg, mesh)
    return logits, state


def ssm_prefill_chunk(params: dict, state: Dict[str, torch.Tensor],
                      batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                      mesh=None):
    return _scan_prefill(ssm_decode_step, params, state, batch, cfg, mesh)


# ---------------------------------------------------------------------------
# zamba2 hybrid
# ---------------------------------------------------------------------------

def hybrid_layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_groups, tail): full groups of `period` mamba layers + tail."""
    period = cfg.shared_attn_period
    return cfg.n_layers // period, cfg.n_layers % period


def hybrid_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    groups, tail = hybrid_layout(cfg)
    period = cfg.shared_attn_period
    mamba = _ssm_block_specs(cfg)
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"), scale=0.02),
        "mamba_groups": stack_specs(stack_specs(mamba, period), groups),
        "shared": {
            "attn_norm": ParamSpec((d,), ("embed",), init="ones"),
            "attn": attention.gqa_param_specs(cfg),
            "ffn_norm": ParamSpec((d,), ("embed",), init="ones"),
            "ffn": moe.dense_ffn_specs(cfg),
        },
        "lora_a": ParamSpec((groups, d, cfg.shared_lora_rank),
                            ("layers", "embed", None), scale=0.02),
        "lora_b": ParamSpec((groups, cfg.shared_lora_rank,
                             cfg.n_heads * cfg.hd),
                            ("layers", None, "q_heads"), init="zeros"),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
        "lm_head": ParamSpec((d, cfg.vocab), ("embed", "vocab")),
    }
    if tail:
        specs["mamba_tail"] = stack_specs(mamba, tail)
    return specs


def _lora_attn(params: dict, g: int) -> dict:
    """The shared attention's params for group ``g``: ``wq`` plus the
    group's LoRA delta, a new tensor (fp32 sum, stored in ``wq``'s dtype,
    as the reference adds it to its fp32 masters)."""
    ap = dict(params["shared"]["attn"])
    wq = ap["wq"]
    delta = params["lora_a"][g].float() @ params["lora_b"][g].float()
    ap["wq"] = (wq.float() + delta).to(wq.dtype)
    return ap


def _shared_ffn(x: torch.Tensor, sp: dict, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, sp["ffn_norm"], cfg.norm_eps)
    return x + moe.dense_ffn(h, sp["ffn"], cfg)


def _shared_block_train(x: torch.Tensor, params: dict, g: int,
                        cfg: ModelConfig, mesh=None, sp: bool = False
                        ) -> torch.Tensor:
    shared = params["shared"]
    h = rms_norm(x, shared["attn_norm"], cfg.norm_eps)
    x = x + attention.gqa_train(h, _lora_attn(params, g), cfg, mesh=mesh,
                                sp=sp)
    return _shared_ffn(x, shared, cfg)


def _hybrid_stack(params: dict, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig, mesh, sp: bool) -> torch.Tensor:
    groups, tail = hybrid_layout(cfg)
    period = cfg.shared_attn_period
    sp_mesh = mesh if sp else None
    x = embed_inputs(params, batch, cfg, mesh, sp)
    if sp:
        # the shared block and the LoRA factors run on every rank's
        # stretch: their gradients summed over model, once a step
        params = {**params, **whole({k: params[k] for k in
                                     ("shared", "lora_a", "lora_b")}, mesh)}

    def group(x, g):
        gp = whole(_layer(params["mamba_groups"], g), sp_mesh)
        for j in range(period):
            x = _ssm_apply(x, index_tree(gp, j), cfg, mesh, sp)
        return _shared_block_train(x, params, g, cfg, mesh, sp)

    group = _maybe_remat(group, cfg)
    sharded_tail = _maybe_remat(lambda x, t: _ssm_apply(
        x, whole(_layer(params["mamba_tail"], t), sp_mesh), cfg, mesh, sp),
        cfg)
    for g in range(groups):
        x = group(x, g)
    for t in range(tail):
        bp = _layer(params["mamba_tail"], t)
        # as the JAX forward, the tail keeps its activations; a layer
        # given as blocks is gathered inside a checkpoint region of its own
        x = (sharded_tail(x, t) if isinstance(bp, ShardedLayer)
             else _ssm_apply(x, whole(bp, sp_mesh), cfg, mesh, sp))
    return x


def hybrid_forward(params: dict, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig, mesh=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V) in the compute dtype, a zero aux loss).
    On a ``mesh``, the shared attention's heads split over ``model``; a
    group's Mamba layers given as a
    :class:`~repro_torch.models.common.ShardedLayer` (the train step's
    blocks) are gathered once inside the group's checkpoint region, a
    tail layer's inside its own (the train step on a mesh runs under
    remat; with whole params the tail, as the JAX forward's, runs without
    it).  Where ``model`` divides the sequence the stream is each rank's
    stretch between layers, and the logits returned are gathered whole."""
    split = logits_split(batch, cfg, mesh)
    x = _hybrid_stack(params, batch, cfg, mesh, split == 1)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return gather_logits(head_logits(x, params, cfg, mesh, split), cfg,
                         mesh, split), aux


def hybrid_train_loss(params: dict, batch: Dict[str, torch.Tensor],
                      cfg: ModelConfig, mesh=None) -> torch.Tensor:
    split = logits_split(batch, cfg, mesh)
    x = _hybrid_stack(params, batch, cfg, mesh, split == 1)
    return lm_loss(x, params, batch, cfg, mesh, split)


def hybrid_decode_state_specs(cfg: ModelConfig, batch: int, max_seq: int
                              ) -> Dict[str, ParamSpec]:
    """Per-layer Mamba-2 ``h`` / ``conv`` (``n_layers``, tail included) and
    one dense KV cache per group for the shared attention."""
    groups, _ = hybrid_layout(cfg)
    specs = ssm_decode_state_specs(cfg, batch, max_seq)
    for name in ("k", "v"):
        specs[name] = ParamSpec(
            (groups, batch, max_seq, cfg.n_kv_heads, cfg.hd),
            ("layers", "batch", "kv_seq", None, None),
            dtype=cfg.dtype, init="zeros")
    return specs


def hybrid_decode_step(params: dict, state: Dict[str, torch.Tensor],
                       batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                       mesh=None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token a slot: batch {"tokens": (B, 1), "index": 0-d lockstep
    position or (B,) per-slot lengths (the shared attention's write
    position)}.  Returns (logits (B, V) float32, state updated in place:
    layer ``l``'s ``h`` / ``conv`` at row ``l``, group ``g``'s ``k`` / ``v``
    at row ``g``).

    On a ``mesh`` the state holds this rank's rows, and with a ``model``
    axis of 2 or more ranks its stretch of the ``k`` / ``v`` cache: the
    shared attention takes split-K, which needs a 0-d index (it raises
    otherwise, as :func:`repro_torch.models.lm.decode_step` does).  The
    embedding is vocab-parallel, and Mamba groups and tail layers given as
    :class:`~repro_torch.models.common.ShardedLayer` s are gathered where
    they run."""
    cur = batch["index"]
    b, smax = state["k"].shape[1], state["k"].shape[2]
    if _splitk(cfg, mesh, False, cur, b, smax):
        attend = lambda h, ap, ck, cv: attention.gqa_decode_splitk(
            h, ap, cfg, ck, cv, cur, mesh)
    else:
        attend = lambda h, ap, ck, cv: attention.gqa_decode(
            h, ap, cfg, ck, cv, cur)
    groups, tail = hybrid_layout(cfg)
    period = cfg.shared_attn_period
    shared = params["shared"]
    x = vocab_parallel_embed(batch["tokens"], params["embed"], mesh,
                             cfg.vocab, cfg.use_tp_shardmap).to(cfg.dtype)
    for g in range(groups):
        gp = whole(_layer(params["mamba_groups"], g))
        for j in range(period):
            x = _mamba_decode_layer(x, index_tree(gp, j), cfg, state,
                                    g * period + j)
        hin = rms_norm(x, shared["attn_norm"], cfg.norm_eps)
        out, _, _ = attend(hin, _lora_attn(params, g), state["k"][g],
                           state["v"][g])
        x = _shared_ffn(x + out, shared, cfg)
    for t in range(tail):
        x = _mamba_decode_layer(x, whole(_layer(params["mamba_tail"], t)),
                                cfg, state, groups * period + t)
    return _decode_logits(x, params, cfg), state


def hybrid_prefill_chunk(params: dict, state: Dict[str, torch.Tensor],
                         batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                         mesh=None):
    return _scan_prefill(hybrid_decode_step, params, state, batch, cfg, mesh)
