"""GQA attention: the full-sequence training path and paged split-K decode.

The counterpart of ``repro/models/attention.py`` for the paths the port
runs.

* Training (:func:`gqa_train`): on CUDA tensors the streaming-softmax
  flash attention kernels (:func:`repro_torch.kernels.ops.flash_attention`,
  forward and backward); on CPU tensors the query-chunked softmax of
  :func:`chunked_attention`, exactly the path the JAX package takes off the
  TPU.
* Decode (:func:`gqa_decode_pages`): project + rope the ``C`` new tokens,
  write them into the gathered page view, attend with split-K over pages,
  and combine the per-page partial accumulators through
  :func:`repro_torch.kernels.ops.moa_reduce` — the hand-written Hopper
  kernel on CUDA tensors, its plain radix-4 tree on CPU tensors.

Layouts match the JAX functions: activations ``(B, S, H, hd)``, pools
``(num_pages, page, Hkv, hd)``.  Weights are cast to the activations'
dtype at use, as in the JAX package (fp32 masters, bf16 compute).

Not in these slices: the dense-cache decode variants, speculative row
masks (``nvalid``) and tree verification, quantized pools and
tensor-parallel head padding (``ROADMAP.md``, queue 1).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import paging
from repro_torch.models.common import ParamSpec, apply_rope, rope_angles

__all__ = ["gqa_param_specs", "gqa_train", "chunked_attention",
           "gqa_decode_pages", "decode_positions", "batched_cache_write",
           "causal_valid", "NEG_INF"]

#: Mask value of the scores; finite, so a masked key enters the split-K sum
#: as ``exp(NEG_INF - m) * v == 0 * v`` (pools must hold finite values).
NEG_INF = -1e30


def decode_positions(cur_index: torch.Tensor, chunk: int) -> torch.Tensor:
    """Query positions: ``(C,)`` for a scalar ``cur_index`` (a prefill
    chunk's start), ``(B, C)`` for a per-slot ``(B,)`` vector."""
    offs = torch.arange(chunk, dtype=torch.int64, device=cur_index.device)
    if cur_index.dim() == 0:
        return cur_index[None] + offs
    return cur_index[:, None] + offs[None, :]


def _rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """(sin, cos) shaped to broadcast against (B, C, H, dim) queries:
    ``(C, 1, dim/2)`` for shared positions, ``(B, C, 1, dim/2)`` per slot."""
    sin, cos = rope_angles(positions, dim, theta)
    return sin[..., None, :], cos[..., None, :]


def causal_valid(pos: torch.Tensor, smax: int) -> torch.Tensor:
    """Key position s is visible to query c of sequence b iff s <=
    position(b, c).  ``pos`` (C,) or (B, C); returns (1, 1, C, S) or
    (B, 1, C, S), broadcastable against (B, H, C, S) scores."""
    k_pos = torch.arange(smax, dtype=torch.int64, device=pos.device)
    if pos.dim() == 1:
        return (k_pos[None, :] <= pos[:, None])[None, None]
    return (k_pos[None, None, :] <= pos[:, :, None])[:, None]


def batched_cache_write(cache: torch.Tensor, new: torch.Tensor,
                        cur_index: torch.Tensor) -> torch.Tensor:
    """Write ``new`` (B, C, ...) into ``cache`` (B, S, ...) at offset
    ``cur_index`` (scalar, or one per slot), in place; returns ``cache``.

    Like ``jax.lax.dynamic_update_slice``, the start is clamped to
    ``[0, S - C]``: a block that would hang past the end shifts left over
    earlier positions instead of being dropped or truncated."""
    b, c = new.shape[0], new.shape[1]
    smax = cache.shape[1]
    start = torch.clamp(cur_index, 0, smax - c)
    if start.dim() == 0:
        start = start.expand(b)
    rows = start[:, None] + torch.arange(c, device=start.device)[None]
    bidx = torch.arange(b, device=start.device)[:, None].expand(b, c)
    cache[bidx, rows] = new.to(cache.dtype)
    return cache


def gqa_param_specs(cfg: ModelConfig) -> dict:
    """Per-layer attention params (leading layer axis added by the caller)."""
    hd, hq, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    d = cfg.d_model
    specs = {
        "wq": ParamSpec((d, hq * hd), ("embed", "q_heads")),
        "wk": ParamSpec((d, hkv * hd), ("embed", "kv_heads")),
        "wv": ParamSpec((d, hkv * hd), ("embed", "kv_heads")),
        "wo": ParamSpec((hq * hd, d), ("q_heads", "embed")),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((hq * hd,), ("q_heads",), init="zeros")
        specs["bk"] = ParamSpec((hkv * hd,), ("kv_heads",), init="zeros")
        specs["bv"] = ParamSpec((hkv * hd,), ("kv_heads",), init="zeros")
    return specs


def _project_qkv(x: torch.Tensor, p: dict, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    hd, hq, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return (q.reshape(b, s, hq, hd), k.reshape(b, s, hkv, hd),
            v.reshape(b, s, hkv, hd))


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Broadcast KV heads to the query-head count (head ``h`` reads KV head
    ``h // n_rep``, as ``jnp.repeat`` lays them out)."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _sqrt_hd(hd: int, dtype: torch.dtype) -> float:
    """sqrt(hd) in fp32, rounded to the compute dtype, as the JAX code
    divides the scores by it."""
    return torch.tensor(float(hd)).sqrt().to(dtype).item()


def _chunk_attend(q_chunk: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_offset: int, causal: bool) -> torch.Tensor:
    """Attend one query chunk against the full K/V. Shapes:
    q_chunk (B, C, H, hd); k/v (B, S, H, hd) -> (B, C, H, hd)."""
    scores = torch.einsum("bchd,bshd->bhcs", q_chunk, k) / _sqrt_hd(
        q_chunk.shape[-1], q_chunk.dtype)
    scores = scores.float()
    if causal:
        s, c = k.shape[1], q_chunk.shape[1]
        q_pos = q_offset + torch.arange(c, device=k.device)[:, None]
        k_pos = torch.arange(s, device=k.device)[None, :]
        scores = torch.where((k_pos <= q_pos)[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q_chunk.dtype)
    return torch.einsum("bhcs,bshd->bchd", probs, v)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """Softmax attention chunked over queries, the JAX package's path off
    the TPU.  q (B, S, Hq, hd), k/v (B, S, Hkv, hd) -> (B, S, Hq, hd)."""
    # The JAX package pads the q heads to a multiple of the model-axis size
    # (tp_head_pad) so tensor parallelism can shard them; on one card that
    # size is 1 and the pad is 0, so the port has no padding.
    s = q.shape[1]
    n_rep = cfg.n_heads // cfg.n_kv_heads
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    chunk = min(cfg.attn_chunk, s)
    if s % chunk:
        chunk = s  # unchunked for odd smoke shapes, as in the JAX package
    return torch.cat([_chunk_attend(q[:, i:i + chunk], k, v, i, cfg.causal)
                      for i in range(0, s, chunk)], dim=1)


def gqa_train(x: torch.Tensor, p: dict, cfg: ModelConfig,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention. x: (B, S, D) -> (B, S, D).

    On a CUDA tensor the flash attention kernels, at every sequence length
    (they mask a ragged last tile; the JAX gate's ``S % min(attn_chunk,
    128)`` was the TPU tiling's); on the CPU :func:`chunked_attention`."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    sin, cos = rope_angles(positions, cfg.hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    if x.is_cuda:
        out = kops.flash_attention(q, k, v, causal=cfg.causal)
    else:
        out = chunked_attention(q, k, v, cfg)
    return out.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"].to(x.dtype)


def _decode_qkv_new(x: torch.Tensor, p: dict, cfg: ModelConfig,
                    cur: torch.Tensor):
    """Project + rope the C new tokens; returns ``(q, k_new, v_new, pos)``
    with ``pos`` the per-row write positions ((C,) or (B, C))."""
    c = x.shape[1]
    q, k_new, v_new = _project_qkv(x, p, cfg)
    pos = decode_positions(cur, c)
    sin, cos = _rope_tables(pos, cfg.hd, cfg.rope_theta)
    return apply_rope(q, sin, cos), apply_rope(k_new, sin, cos), v_new, pos


def _splitk_attend(q: torch.Tensor, k_view: torch.Tensor,
                   v_view: torch.Tensor, valid: torch.Tensor,
                   cfg: ModelConfig, page: int) -> torch.Tensor:
    """Split-K attention over fixed-size KV pages.

    q: (B, C, H, hd) roped queries; k_view/v_view: (B, Smax, Hkv, hd)
    gathered views; ``valid`` masks attendable positions.  Each page gives
    a partial (sum-exp, PV) accumulator under the global row max; the
    page-axis combine is ONE :func:`~repro_torch.kernels.ops.moa_reduce`
    call for ``l`` and one for ``o`` (the radix-4 tree of
    ``make_reduction_plan(n_pages)``).  Returns (B, C, n_heads * hd)."""
    b, c = q.shape[0], q.shape[1]
    smax = k_view.shape[1]
    n_pages = smax // page
    hq = cfg.n_heads
    n_rep = hq // cfg.n_kv_heads
    k = _repeat_kv(k_view.to(q.dtype), n_rep)
    v = _repeat_kv(v_view.to(q.dtype), n_rep)
    scores = torch.einsum("bchd,bshd->bhcs", q, k) / _sqrt_hd(cfg.hd, q.dtype)
    scores = torch.where(valid, scores.float(), NEG_INF)

    m = torch.amax(scores, dim=-1, keepdim=True)             # (b,h,C,1)
    p_ = torch.exp(scores - m)                               # (b,h,C,S)
    pp = p_.reshape(*p_.shape[:-1], n_pages, page)
    l_pages = torch.movedim(pp.sum(dim=-1), -1, 0)           # (n,b,h,C)
    vp = torch.movedim(v.reshape(b, n_pages, page, hq, cfg.hd), 1, 0)
    o_pages = torch.einsum("bhcns,nbshd->nbhcd", pp.to(q.dtype), vp)

    def combine(t: torch.Tensor) -> torch.Tensor:
        flat = t.reshape(n_pages, t.shape[1], -1)
        return kops.moa_reduce(flat).reshape(t.shape[1:])

    l = combine(l_pages)
    o = combine(o_pages.float())
    out = (o / l[..., None]).to(q.dtype)                     # (b,h,C,hd)
    out = torch.movedim(out, 1, 2)                           # (b,C,h,hd)
    return out.reshape(b, c, hq * cfg.hd)


def gqa_decode_pages(x: torch.Tensor, p: dict, cfg: ModelConfig,
                     pool_k: torch.Tensor, pool_v: torch.Tensor,
                     cur_index: torch.Tensor, pages: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Paged split-K decode of ``C`` new tokens per slot.

    x: (B, C, D); pool_k/pool_v: ``(num_pages, page, Hkv, hd)`` physical
    page pools (this layer's); ``cur_index``: scalar chunk start (prefill)
    or (B,) per-slot lengths (decode); ``pages``: (B, n_pages) int64 page
    table.  The slot views are gathered from the pool, the new rows are
    written into the views (clamped like ``dynamic_update_slice``), the
    split-K attention runs over the views, and the new rows are scattered
    into the pools in place.  Returns (out (B, C, D), pool_k, pool_v)."""
    page = pool_k.shape[1]
    k_view = paging.gather_pages(pool_k, pages)
    v_view = paging.gather_pages(pool_v, pages)
    smax = pages.shape[1] * page
    q, k_new, v_new, pos = _decode_qkv_new(x, p, cfg, cur_index)
    k_view = batched_cache_write(k_view, k_new, cur_index)
    v_view = batched_cache_write(v_view, v_new, cur_index)
    out = _splitk_attend(q, k_view, v_view, causal_valid(pos, smax), cfg,
                         page)
    paging.scatter_token_rows(pool_k, pages, k_new, pos)
    paging.scatter_token_rows(pool_v, pages, v_new, pos)
    return out @ p["wo"], pool_k, pool_v
