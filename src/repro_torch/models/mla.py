"""Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style).

The counterpart of ``repro/models/mla.py``.  Training expands K and V from
the latent and attends chunked over queries (:func:`mla_train`).  Decode
uses the *absorbed* formulation (:func:`mla_decode_pages` over page pools,
:func:`mla_decode` over a contiguous engine's dense slot rows,
:func:`mla_decode_splitk` over a rank's stretch of them on a ``model``
axis): the caches
hold only the latent ``c_kv`` rows and the one shared rope key, ``wk_b`` is
folded into the queries and ``wv_b`` into the output, so a decode step
reads ``S * (kv_lora_rank + qk_rope_dim)`` values a slot instead of ``S *
H * hd``.  The attention is a plain softmax over the latent view: no
split-K page combine, so no hand-written kernel runs on this path.

Layouts match the JAX functions: pools ``(num_pages, page, rkv)`` and
``(num_pages, page, dr)``, dense caches ``(B, Smax, rkv)`` and ``(B, Smax,
dr)``; a quantized pool is a ``(codes, scales)`` pair
with one fp32 scale per (page, position) row.  Weights are cast to the
activations' dtype at use.  The helpers shared with GQA decode (positions,
masks, the row-masked view write, the gather and the quantizing scatter)
are :mod:`repro_torch.models.attention`'s.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, paging
from repro_torch.models.attention import NEG_INF, Pool
from repro_torch.models.common import (ParamSpec, apply_rope, rms_norm,
                                       rope_angles)

__all__ = ["mla_param_specs", "mla_train", "mla_decode", "mla_decode_pages",
           "mla_decode_splitk"]


def mla_param_specs(cfg: ModelConfig) -> dict:
    """Per-layer MLA params (leading layer axis added by the caller)."""
    d, h = cfg.d_model, cfg.n_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": ParamSpec((d, rq), ("embed", "latent")),
        "q_norm": ParamSpec((rq,), ("latent",), init="ones"),
        "wq_b": ParamSpec((rq, h * (dn + dr)), ("latent", "q_heads")),
        "wkv_a": ParamSpec((d, rkv + dr), ("embed", "latent")),
        "kv_norm": ParamSpec((rkv,), ("latent",), init="ones"),
        "wk_b": ParamSpec((rkv, h * dn), ("latent", "q_heads")),
        "wv_b": ParamSpec((rkv, h * dv), ("latent", "q_heads")),
        "wo": ParamSpec((h * dv, d), ("q_heads", "embed")),
    }


def _mla_rope_tables(positions: torch.Tensor, dr: int, theta: float):
    """(sin, cos) for ``positions``: per-slot (B, S) positions get an
    explicit head axis, so the tables broadcast against (B, S, H, dr)
    instead of colliding with H."""
    sin, cos = rope_angles(positions, dr, theta)
    if positions.dim() == 2:
        sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    return sin, cos


def _queries(x: torch.Tensor, p: dict, cfg: ModelConfig,
             positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_nope (B, S, H, dn), roped q_rope (B, S, H, dr))."""
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    ql = rms_norm(x @ p["wq_a"].to(x.dtype), p["q_norm"], cfg.norm_eps)
    q = (ql @ p["wq_b"].to(x.dtype)).reshape(b, s, h, dn + dr)
    sin, cos = _mla_rope_tables(positions, dr, cfg.rope_theta)
    return q[..., :dn], apply_rope(q[..., dn:], sin, cos)


def _latent_kv(x: torch.Tensor, p: dict, cfg: ModelConfig,
               positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(c_kv (B, S, rkv), roped k_rope (B, S, dr)): the one rope head is
    shared by every query head."""
    rkv, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    kv = x @ p["wkv_a"].to(x.dtype)                     # (B, S, rkv + dr)
    c_kv = rms_norm(kv[..., :rkv], p["kv_norm"], cfg.norm_eps)
    k_rope = kv[..., rkv:][..., None, :]
    sin, cos = _mla_rope_tables(positions, dr, cfg.rope_theta)
    return c_kv, apply_rope(k_rope, sin, cos)[..., 0, :]


def _train_scale(d: int, dtype: torch.dtype) -> float:
    """``1 / sqrt(d)`` as the JAX training path forms it: the fp32 root
    rounded to ``dtype``, its reciprocal rounded to ``dtype``."""
    root = torch.tensor(float(d)).sqrt().to(dtype)
    return float(1.0 / root)


def mla_train(x: torch.Tensor, p: dict, cfg: ModelConfig,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence causal MLA. x: (B, S, D) -> (B, S, D).  K and V are
    expanded from the latent; the softmax runs over query chunks of
    ``attn_chunk`` (unchunked when the chunk does not divide S), with the
    scores scaled in ``x.dtype`` before the fp32 cast, as in JAX."""
    b, s, _ = x.shape
    h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q_nope, q_rope = _queries(x, p, cfg, positions)
    c_kv, k_rope = _latent_kv(x, p, cfg, positions)
    k_nope = (c_kv @ p["wk_b"].to(x.dtype)).reshape(b, s, h, dn)
    v = (c_kv @ p["wv_b"].to(x.dtype)).reshape(b, s, h, dv)
    scale = _train_scale(dn + dr, x.dtype)
    chunk = min(cfg.attn_chunk, s)
    if s % chunk:
        chunk = s
    k_pos = torch.arange(s, device=x.device)[None, :]
    outs = []
    for off in range(0, s, chunk):
        qn, qr = q_nope[:, off:off + chunk], q_rope[:, off:off + chunk]
        scores = (torch.einsum("bchd,bshd->bhcs", qn, k_nope)
                  + torch.einsum("bchd,bsd->bhcs", qr, k_rope)) * scale
        q_pos = off + torch.arange(chunk, device=x.device)[:, None]
        scores = torch.where((k_pos <= q_pos)[None, None], scores.float(),
                             NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        outs.append(torch.einsum("bhcs,bshd->bchd", probs, v))
    out = torch.cat(outs, dim=1).reshape(b, s, h * dv)
    return out @ p["wo"].to(x.dtype)


def _latent_scores(p: dict, cfg: ModelConfig, q_nope: torch.Tensor,
                   q_rope: torch.Tensor, ckv: torch.Tensor,
                   kr_view: torch.Tensor, valid: torch.Tensor
                   ) -> torch.Tensor:
    """The absorbed fp32 scores (B, H, C, Smax) of q_nope/q_rope (B, C, H,
    dn/dr) against ckv (B, Smax, rkv) in their dtype and kr_view (B,
    Smax, dr), divided by ``sqrt(dn + dr)``, ``-inf`` where not
    ``valid``."""
    dt = q_nope.dtype
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    wk_b = p["wk_b"].to(dt).reshape(cfg.kv_lora_rank, h, dn)
    q_lat = torch.einsum("bchd,rhd->bchr", q_nope, wk_b)      # (B,C,H,rkv)
    scores = (torch.einsum("bchr,bsr->bhcs", q_lat, ckv)
              + torch.einsum("bchd,bsd->bhcs", q_rope, kr_view.to(dt)))
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, an ulp off the CPU's (and XLA's) division
    root = scores.new_full((1,), math.sqrt(float(dn + dr)),
                           dtype=torch.float32)
    return torch.where(valid, scores.float() / root, NEG_INF)


def _latent_out(p: dict, cfg: ModelConfig, ctx_lat: torch.Tensor
                ) -> torch.Tensor:
    """ctx_lat (B, C, H, rkv) through ``wv_b``: (B, C, H * dv)."""
    b, c, h = ctx_lat.shape[:3]
    wv_b = p["wv_b"].to(ctx_lat.dtype).reshape(cfg.kv_lora_rank, h,
                                              cfg.v_head_dim)
    ctx = torch.einsum("bchr,rhd->bchd", ctx_lat, wv_b)
    return ctx.reshape(b, c, h * cfg.v_head_dim)


def _absorbed_attend(p: dict, cfg: ModelConfig, q_nope: torch.Tensor,
                     q_rope: torch.Tensor, ckv_view: torch.Tensor,
                     kr_view: torch.Tensor, valid: torch.Tensor
                     ) -> torch.Tensor:
    """Absorbed attention over latent views: q_nope/q_rope (B, C, H,
    dn/dr), ckv_view (B, Smax, rkv), kr_view (B, Smax, dr), ``valid``
    broadcastable against (B, H, C, Smax).  Scores and PV contract in
    latent space; the fp32 scores are divided by ``sqrt(dn + dr)``.
    Returns (B, C, H * dv)."""
    dt = q_nope.dtype
    ckv = ckv_view.to(dt)
    scores = _latent_scores(p, cfg, q_nope, q_rope, ckv, kr_view, valid)
    probs = torch.softmax(scores, dim=-1).to(dt)
    ctx_lat = torch.einsum("bhcs,bsr->bchr", probs, ckv)       # (B,C,H,rkv)
    return _latent_out(p, cfg, ctx_lat)


def _decode_latent_cache(x: torch.Tensor, p: dict, cfg: ModelConfig,
                         ckv_cache: torch.Tensor, kr_cache: torch.Tensor,
                         cur_index: torch.Tensor,
                         nvalid: Optional[torch.Tensor] = None,
                         tree: Optional[tuple] = None,
                         valid: Optional[torch.Tensor] = None,
                         write_plan: Optional[Tuple[torch.Tensor, ...]] = None):
    """The front end both MLA decode paths share: queries and the new
    latent rows of the ``C`` tokens (roped at ``index + pos_off`` under a
    ``tree``), written into ``ckv_cache`` (B, Smax, rkv) and ``kr_cache``
    (B, Smax, dr) in place, a slot's dense rows or its gathered view, as
    :func:`repro_torch.models.attention._decode_qkv_cache` writes GQA's;
    then the mask.  Returns ``(q_nope, q_rope, c_new, kr_new, pos,
    valid)``."""
    smax = ckv_cache.shape[1]
    pos = attention.decode_positions(cur_index, x.shape[1])
    rope_pos = pos if tree is None else cur_index[:, None] + tree[1]
    q_nope, q_rope = _queries(x, p, cfg, rope_pos)
    c_new, kr_new = _latent_kv(x, p, cfg, rope_pos)
    if nvalid is None:
        attention.batched_cache_write(ckv_cache, c_new, cur_index)
        attention.batched_cache_write(kr_cache, kr_new, cur_index)
    else:
        if write_plan is None:
            write_plan = attention.masked_write_plan(pos, nvalid, smax,
                                                     x.shape[0])
        attention.masked_cache_write(ckv_cache, c_new, plan=write_plan)
        attention.masked_cache_write(kr_cache, kr_new, plan=write_plan)
    if valid is None:
        valid = attention.attend_mask(cur_index, x.shape[1], smax, nvalid,
                                      tree)
    return q_nope, q_rope, c_new, kr_new, pos, valid


def mla_decode(x: torch.Tensor, p: dict, cfg: ModelConfig,
               cache_ckv: torch.Tensor, cache_kr: torch.Tensor,
               cur_index: torch.Tensor,
               nvalid: Optional[torch.Tensor] = None,
               tree: Optional[Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]] = None,
               valid: Optional[torch.Tensor] = None,
               write_plan: Optional[Tuple[torch.Tensor, ...]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorbed decode or chunked prefill over a slot's *dense* latent
    rows (a contiguous engine).  x: (B, C, D); cache_ckv (B, Smax, rkv)
    and cache_kr (B, Smax, dr), written in place; ``cur_index`` a 0-d
    index (lockstep) or (B,) per-slot lengths; ``nvalid``, ``tree``,
    ``valid`` and ``write_plan`` as in :func:`mla_decode_pages`.  Returns
    (out (B, C, D), cache_ckv, cache_kr)."""
    q_nope, q_rope, _, _, _, valid = _decode_latent_cache(
        x, p, cfg, cache_ckv, cache_kr, cur_index, nvalid, tree, valid,
        write_plan)
    out = _absorbed_attend(p, cfg, q_nope, q_rope, cache_ckv, cache_kr,
                           valid)
    return out @ p["wo"].to(out.dtype), cache_ckv, cache_kr


def mla_decode_pages(x: torch.Tensor, p: dict, cfg: ModelConfig,
                     pool_ckv: Pool, pool_kr: Pool,
                     cur_index: torch.Tensor, pages: torch.Tensor,
                     nvalid: Optional[torch.Tensor] = None,
                     tree: Optional[Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]] = None,
                     valid: Optional[torch.Tensor] = None,
                     write_plan: Optional[Tuple[torch.Tensor, ...]] = None,
                     scatter: Optional[paging.ScatterPlan] = None
                     ) -> Tuple[torch.Tensor, Pool, Pool]:
    """Paged absorbed decode of ``C`` new tokens per slot (the JAX
    package's ``mla_decode_paged``).

    x: (B, C, D); pool_ckv ``(num_pages, page, rkv)`` and pool_kr
    ``(num_pages, page, dr)`` (this layer's); ``cur_index``: scalar chunk
    start (prefill) or (B,) per-slot lengths; ``pages``: (B, n_pages) page
    table.  The latent views are gathered, the new latent rows written into
    them, the absorbed attention runs over the views, and the new rows are
    scattered into the pools in place.  Returns (out (B, C, D), pool_ckv,
    pool_kr).

    ``nvalid``, ``tree``, ``valid``, ``write_plan`` and ``scatter`` as in
    :func:`repro_torch.models.attention.gqa_decode_pages`: rows at or past
    ``nvalid`` are dropped from the view and sent to scratch; a tree ropes
    at ``index + pos_off``, attends under the ancestor mask and scatters
    only its ``nchain`` chain rows.  Either pool may be a quantized
    ``(codes, scales)`` pair: the view is dequantized into ``x.dtype``, the
    new rows attend unquantized, and they are quantized on the scatter."""
    ckv_view = attention._gather_view(pool_ckv, pages, x.dtype)
    kr_view = attention._gather_view(pool_kr, pages, x.dtype)
    q_nope, q_rope, c_new, kr_new, pos, valid = _decode_latent_cache(
        x, p, cfg, ckv_view, kr_view, cur_index, nvalid, tree, valid,
        write_plan)
    out = _absorbed_attend(p, cfg, q_nope, q_rope, ckv_view, kr_view, valid)
    if scatter is None:
        page = ckv_view.shape[1] // pages.shape[1]
        scatter = paging.scatter_plan(pages, pos, page, x.shape[0],
                                      nvalid if tree is None else tree[2])
    attention._scatter_rows(pool_ckv, c_new, scatter)
    attention._scatter_rows(pool_kr, kr_new, scatter)
    return out @ p["wo"].to(out.dtype), pool_ckv, pool_kr


def mla_decode_splitk(x: torch.Tensor, p: dict, cfg: ModelConfig,
                      cache_ckv: torch.Tensor, cache_kr: torch.Tensor,
                      cur_index: torch.Tensor, mesh
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split-K absorbed decode of C new tokens a sequence on one rank of
    ``mesh``, the latent-space twin of
    :func:`repro_torch.models.attention.gqa_decode_splitk`; the latent
    cache never moves (the JAX package shards it ``(batch, kv_seq)`` with
    ``kv_seq`` over ``model`` and lets the partitioner split the softmax).

    ``x`` (B / dp, C, D) are this rank's batch rows: one token a sequence
    for a decode step, or a prefill chunk at positions ``cur_index + j``;
    ``cache_ckv`` (B / dp, Smax / tp, rkv) and ``cache_kr`` (B / dp, Smax /
    tp, dr) its block of the latent caches, positions ``[i * Smax / tp,
    (i + 1) * Smax / tp)`` on ``model`` rank ``i``; ``cur_index`` a 0-d
    position shared by every sequence.  The rank that owns a row's
    position writes its new latent rows, in place (a chunk may straddle
    stretches); every rank scores the absorbed queries against its
    stretch; one ``max`` all-reduce of the row maxima, then the partial
    sum-exp ``l`` and latent context summed over ``model`` through the
    ``Transport``, then ``wv_b`` and ``wo``.  No ``moa_reduce``, as on one
    device.  Returns (out (B / dp, C, D), cache_ckv, cache_kr)."""
    dt = x.dtype
    pos = attention.decode_positions(cur_index, x.shape[1])
    q_nope, q_rope = _queries(x, p, cfg, pos)
    c_new, kr_new = _latent_kv(x, p, cfg, pos)
    valid = attention.splitk_write(((cache_ckv, c_new), (cache_kr, kr_new)),
                                   cur_index, pos, mesh)
    ckv = cache_ckv.to(dt)
    scores = _latent_scores(p, cfg, q_nope, q_rope, ckv, cache_kr, valid)
    t, group = mesh.transport, mesh.group("model")
    m = t.all_reduce(torch.amax(scores, dim=-1), group, op="max")
    p_ = torch.exp(scores - m[..., None])                    # (B, H, C, S)
    l = t.all_reduce(p_.sum(-1), group)                      # (B, H, C)
    ctx_lat = torch.einsum("bhcs,bsr->bchr", p_.to(dt), ckv)
    ctx_lat = t.all_reduce(ctx_lat.float(), group)           # (B, C, H, rkv)
    ctx_lat = (ctx_lat / l.transpose(1, 2)[..., None]).to(dt)
    out = _latent_out(p, cfg, ctx_lat)
    return out @ p["wo"].to(dt), cache_ckv, cache_kr
