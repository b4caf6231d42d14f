"""GQA attention: the full-sequence training path and cache-attend decode.

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
* Dense slots (a contiguous engine, ``paged_kv=False``): the same front
  end over a slot's own rows, then split-K over them read as pages
  (:func:`gqa_decode_paged`, the same combine and kernel) or, without a
  decode page, one softmax over the whole cache (:func:`gqa_decode`).
* Speculative verification: the same call with a per-slot row count
  ``nvalid`` (a chain of drafts: rows past it are dropped from the view
  write and sent to scratch by the pool scatter) or a token tree
  (``tree``: rope at each row's depth, the ancestor mask of
  :func:`tree_valid`, only the chain rows committed to the pool).

* Quantized pools (``kv_dtype`` int8 or int4): each pool is a ``(codes,
  scales)`` pair; the view is gathered and dequantized into the
  activations' dtype, the new rows enter it at full precision, and they
  are quantized on their way into the pool.

Layouts match the JAX functions: activations ``(B, S, H, hd)``, pools
``(num_pages, page, Hkv, hd)``.  Weights are cast to the activations'
dtype at use, as in the JAX package (fp32 masters, bf16 compute).

* On a device mesh (:class:`repro_torch.launch.mesh.Mesh`) with a
  ``model`` axis: :func:`gqa_train` shards the q heads over the ``model``
  ranks, padded within each KV group to a multiple of the axis
  (:func:`tp_head_pad`), each rank projecting and attending only its own
  heads (the flash kernel on the card) and the output projection summed
  over ``model``; :func:`gqa_decode_splitk` attends a cache split over
  ``model`` along the sequence, the owning rank writing the new row, the
  partial (max, sum-exp, PV) accumulators combined by a max and two sums
  over ``model`` (:func:`splitk_ok` says when it applies).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import transport as tx
from repro_torch.kernels import ops as kops
from repro_torch.models import paging, quant_kv
from repro_torch.models.common import (ParamSpec, apply_rope, rope_angles,
                                       whole_sequence)

__all__ = ["gqa_param_specs", "gqa_train", "chunked_attention",
           "gqa_decode", "gqa_decode_paged", "gqa_decode_pages",
           "decode_positions", "batched_cache_write",
           "masked_cache_write", "masked_write_plan", "causal_valid",
           "ancestor_matrix", "tree_valid", "attend_mask", "NEG_INF",
           "tp_head_pad", "splitk_write", "gqa_decode_splitk",
           "splitk_ok"]

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


def ancestor_matrix(parents: torch.Tensor) -> torch.Tensor:
    """Ancestor-or-self reachability of a flattened token tree.

    ``parents`` (B, C): row ``j``'s parent row in the fed block (``-1`` =
    none: the block root attends only the committed cache; padding rows
    point at themselves, so they are never another row's ancestor).
    Returns (B, C, C) bool, ``anc[b, q, r]`` iff row ``r`` is on row
    ``q``'s root path (``r == q`` included), by ``C - 1`` pointer hops."""
    b, c = parents.shape
    rows = torch.arange(c, device=parents.device)
    anc = torch.eye(c, dtype=torch.bool,
                    device=parents.device)[None].expand(b, c, c)
    ptr = rows[None].expand(b, c)
    for _ in range(c - 1):
        hop = torch.gather(parents, 1, torch.clamp(ptr, 0, c - 1))
        ptr = torch.where(ptr >= 0, hop, torch.full_like(hop, -1))
        anc = anc | (ptr[:, :, None] == rows[None, None, :])
    return anc


def tree_valid(index: torch.Tensor, parents: torch.Tensor,
               nvalid: torch.Tensor, smax: int) -> torch.Tensor:
    """The attendable-key mask of tree verification: key ``s`` is visible
    to block row ``q`` of slot ``b`` iff ``s < index[b]`` (the committed
    cache), or ``s = index[b] + r`` for a valid row ``r < nvalid[b]`` that
    is an ancestor-or-self of ``q`` (:func:`ancestor_matrix`).  Rows are
    written at the row-unique view positions ``index[b] + j``, so the mask,
    not the write position, carries the topology.  Returns (B, 1, C, smax),
    broadcastable against (B, H, C, S) scores."""
    b, c = parents.shape
    s = torch.arange(smax, device=parents.device)
    committed = s[None, :] < index[:, None]                     # (B, S)
    kr = s[None, :] - index[:, None]                            # (B, S)
    in_block = (kr >= 0) & (kr < nvalid[:, None])               # (B, S)
    anc = ancestor_matrix(parents)                              # (B, C, C)
    krc = torch.clamp(kr, 0, c - 1)
    anc_qs = torch.gather(anc, 2, krc[:, None, :].expand(b, c, smax))
    valid = committed[:, None, :] | (anc_qs & in_block[:, None, :])
    return valid[:, None]


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


def attend_mask(cur_index: torch.Tensor, chunk: int, smax: int,
                nvalid: Optional[torch.Tensor] = None,
                tree: Optional[tuple] = None) -> torch.Tensor:
    """The mask :func:`gqa_decode_pages` attends under for a block of
    ``chunk`` rows: :func:`causal_valid`, or :func:`tree_valid` under a
    ``tree`` triple.  The same for every layer of a dispatch, so the
    decode stack builds it once (the tree mask's pointer walk is ``chunk -
    1`` small kernels)."""
    if tree is None:
        return causal_valid(decode_positions(cur_index, chunk), smax)
    return tree_valid(cur_index, tree[0], nvalid, smax)


def masked_write_plan(pos: torch.Tensor, nvalid: torch.Tensor, smax: int,
                      batch: int) -> Tuple[torch.Tensor, ...]:
    """The layer-independent indices of :func:`masked_cache_write` for a
    block at ``pos`` ((B, C), or (C,) for every slot) with ``nvalid`` (B,)
    valid rows, in a cache of ``smax`` positions: ``(bi, tgt, src, has)``.
    Row ``j`` of slot ``b`` writes ``new[b, src[b, j]]`` at ``tgt[b, j]``: a
    kept row (``j < nvalid[b]``, position below ``smax``) its own value at
    its position, a dropped row the first kept row's value at that row's
    position (the same write twice), and in a slot with no kept row
    (``has`` false) position 0's own value at position 0.  No boolean index,
    so no host sync."""
    if pos.dim() == 1:
        pos = pos[None].expand(batch, pos.shape[0])
    c = pos.shape[1]
    rows = torch.arange(c, device=pos.device)
    keep = (rows[None] < nvalid[:, None]) & (pos < smax)
    bi = torch.arange(batch, device=pos.device)[:, None]
    first = keep.to(torch.int8).argmax(1, keepdim=True)   # first kept, or 0
    src = torch.where(keep, rows[None], first)
    tgt = torch.gather(pos, 1, src)
    has = keep.any(1)
    tgt = torch.where(has[:, None], tgt, torch.zeros_like(tgt))
    return bi, tgt, src, has


def masked_cache_write(cache: torch.Tensor, new: torch.Tensor,
                       pos: Optional[torch.Tensor] = None,
                       nvalid: Optional[torch.Tensor] = None,
                       plan: Optional[Tuple[torch.Tensor, ...]] = None
                       ) -> torch.Tensor:
    """Row-masked :func:`batched_cache_write` of speculative verification,
    in place; returns ``cache``: row ``j`` of slot ``b`` goes to position
    ``pos[b, j]`` (``pos`` (B, C), or (C,) for every slot) only when ``j <
    nvalid[b]`` and the position is below ``S``.  Other rows (draft
    padding, idle lanes with ``nvalid == 0``, positions at or past
    capacity) are dropped, as ``.at[].set(mode="drop")`` drops them; a
    clamped start would shift them over earlier valid positions.  ``plan``
    (:func:`masked_write_plan`, the same for every layer of a dispatch)
    replaces ``pos`` and ``nvalid``."""
    if plan is None:
        plan = masked_write_plan(pos, nvalid, cache.shape[1], new.shape[0])
    bi, tgt, src, has = plan
    new = new.to(cache.dtype)
    tail = (1,) * (new.dim() - 2)
    vals = torch.where(has.view(has.shape + (1,) + tail), new[bi, src],
                       cache[bi[:, 0], :1])
    cache[bi, tgt] = vals
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
    s = q.shape[1]
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    chunk = min(cfg.attn_chunk, s)
    if s % chunk:
        chunk = s  # unchunked for odd smoke shapes, as in the JAX package
    return torch.cat([_chunk_attend(q[:, i:i + chunk], k, v, i, cfg.causal)
                      for i in range(0, s, chunk)], dim=1)


def _model_size(mesh) -> int:
    """The ``model`` axis's size of a :class:`~repro_torch.launch.mesh.Mesh`
    or of an axis-size mapping (1 without one)."""
    if mesh is None:
        return 1
    return dict(getattr(mesh, "shape", mesh)).get("model", 1)


def tp_head_pad(cfg: ModelConfig, mesh=None) -> int:
    """Heads to ADD so the q-head axis divides the ``model`` axis of
    ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh` or a mapping of axis
    sizes).

    40 heads on a 16-way model axis would otherwise fall back to fully
    replicated attention.  Padding 40 -> 48 costs 20% extra attention
    FLOPs but shards them 16 ways; padded q heads see zero queries and are
    sliced off before the output projection, so the math is exact.  The
    pad goes WITHIN each kv group (rep -> rep_pad), so the real heads keep
    their kv heads; 0 when the axis is 1, already divides, or no rep_pad
    below rep + tp does."""
    tp = _model_size(mesh)
    if tp <= 1 or cfg.n_heads % tp == 0:
        return 0
    hkv = cfg.n_kv_heads
    rep = cfg.n_heads // hkv
    rep_pad = rep
    while (hkv * rep_pad) % tp and rep_pad < rep + tp:
        rep_pad += 1
    if (hkv * rep_pad) % tp:
        return 0
    return hkv * rep_pad - cfg.n_heads


def padded_heads(cfg: ModelConfig, pad: int) -> torch.Tensor:
    """The padded q-head layout: for each of the ``n_heads + pad`` padded
    heads, group-major (``hkv`` groups of ``rep_pad``), the real head it
    holds, or -1 for a pad head (the zeros ``_pad_heads`` appends inside
    each group in the JAX package)."""
    hkv = cfg.n_kv_heads
    rep = cfg.n_heads // hkv
    rep_pad = (cfg.n_heads + pad) // hkv
    j = torch.arange(hkv * rep_pad)
    g, r = j // rep_pad, j % rep_pad
    return torch.where(r < rep, g * rep + r, -1)


def _heads_of(w: torch.Tensor, heads: torch.Tensor, hd: int, dim: int
              ) -> torch.Tensor:
    """The columns (``dim`` -1) or rows (``dim`` 0) of ``w`` that belong
    to ``heads``, in that order."""
    if dim == 0:
        return w.reshape(-1, hd, w.shape[-1]).index_select(0, heads).reshape(
            -1, w.shape[-1])
    lead = w.shape[:-1]
    return w.reshape(*lead, -1, hd).index_select(len(lead), heads).reshape(
        *lead, -1)


def _gqa_train_tp(x: torch.Tensor, p: dict, cfg: ModelConfig,
                  positions: torch.Tensor, mesh, sp: bool = False
                  ) -> torch.Tensor:
    """:func:`gqa_train` with the padded q heads split over ``model``.

    This rank takes padded heads ``[i * n_loc, (i + 1) * n_loc)`` of
    :func:`padded_heads`: it projects the real ones among them (a pad head
    is a zero query), the KV heads their groups read, attends them (KV
    repeated to one a head), drops the pad heads and multiplies by its
    heads' rows of ``wo``; the partial outputs are summed over ``model``.
    ``x`` and the weights are the same on every rank, and so are the
    gradients this returns (:func:`~repro_torch.dist.transport.copy_to` /
    :func:`~repro_torch.dist.transport.reduce_from`).

    With ``sp`` (the sequence-parallel layout) ``x`` is this rank's
    stretch of the sequence: it is all-gathered over ``model`` first
    (backward: reduce-scatter), and the partial outputs are
    reduce-scattered along the sequence (backward: all-gather), so this
    returns the rank's stretch; the weights' gradients are this rank's
    heads', which the caller sums over ``model`` (:func:`~repro_torch.
    models.common.whole`)."""
    if sp:
        x = tx.all_gather(x, mesh, "model", 1)
    b, s, _ = x.shape
    hd, hkv = cfg.hd, cfg.n_kv_heads
    tp, i = mesh.shape["model"], mesh.index("model")
    pad = tp_head_pad(cfg, mesh)
    table = padded_heads(cfg, pad)
    n_loc = table.numel() // tp
    rep_pad = table.numel() // hkv
    mine = torch.arange(i * n_loc, (i + 1) * n_loc)
    real = table[mine] >= 0
    q_heads = table[mine][real].to(x.device)            # real heads, in order
    slots = torch.nonzero(real)[:, 0].to(x.device)       # their local slots
    first = int(mine[0]) // rep_pad
    groups = torch.arange(first, int(mine[-1]) // rep_pad + 1,
                          device=x.device)
    head_group = (mine // rep_pad - first).to(x.device)  # slot -> groups[.]
    if sp:
        w = p
    else:
        x = tx.copy_to(x, mesh, "model")
        w = {k: tx.copy_to(v, mesh, "model") for k, v in p.items()}
    dt = x.dtype
    q = x @ _heads_of(w["wq"], q_heads, hd, -1).to(dt)
    k = x @ _heads_of(w["wk"], groups, hd, -1).to(dt)
    v = x @ _heads_of(w["wv"], groups, hd, -1).to(dt)
    if cfg.qkv_bias:
        q = q + _heads_of(w["bq"], q_heads, hd, -1).to(dt)
        k = k + _heads_of(w["bk"], groups, hd, -1).to(dt)
        v = v + _heads_of(w["bv"], groups, hd, -1).to(dt)
    sin, cos = rope_angles(positions, cfg.hd, cfg.rope_theta)
    q = apply_rope(q.reshape(b, s, -1, hd), sin, cos)
    k = apply_rope(k.reshape(b, s, -1, hd), sin, cos)
    v = v.reshape(b, s, -1, hd)
    q = q.new_zeros(b, s, n_loc, hd).index_copy(2, slots, q)
    k = k.index_select(2, head_group)
    v = v.index_select(2, head_group)
    if cfg.use_flash_attn and x.is_cuda:
        out = kops.flash_attention(q, k, v, causal=cfg.causal)
    else:
        out = chunked_attention(q, k, v, cfg)
    out = out.index_select(2, slots).reshape(b, s, -1)
    part = out @ _heads_of(w["wo"], q_heads, hd, 0).to(dt)
    if sp:
        return tx.reduce_scatter(part, mesh, "model", 1)
    return tx.reduce_from(part, mesh, "model")


def _attend_whole(x: torch.Tensor, p: dict, cfg: ModelConfig,
                  positions: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg)
    sin, cos = rope_angles(positions, cfg.hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    if cfg.use_flash_attn and x.is_cuda:
        out = kops.flash_attention(q, k, v, causal=cfg.causal)
    else:
        out = chunked_attention(q, k, v, cfg)
    return out.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"].to(x.dtype)


def gqa_train(x: torch.Tensor, p: dict, cfg: ModelConfig,
              positions: Optional[torch.Tensor] = None, mesh=None,
              sp: bool = False) -> torch.Tensor:
    """Full-sequence attention. x: (B, S, D) -> (B, S, D).

    With ``cfg.use_flash_attn`` on a CUDA tensor, the flash attention
    kernels, at every sequence length (they mask a ragged last tile; the
    JAX gate's ``S % min(attn_chunk, 128)`` was the TPU tiling's); else
    :func:`chunked_attention`.  On a ``mesh`` whose ``model`` axis has 2
    or more ranks and divides the (padded) q heads, the heads are split
    over it (:func:`_gqa_train_tp`).  With ``sp`` ``x`` is this rank's
    stretch (B, S / tp, D) of the sequence-parallel stream and so is the
    result: the heads split as above, or where they do not, the whole
    attention on every rank (:func:`~repro_torch.models.common.whole_sequence`)."""
    s = x.shape[1] * (mesh.shape["model"] if sp else 1)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    tp = _model_size(mesh)
    if tp > 1 and (cfg.n_heads + tp_head_pad(cfg, mesh)) % tp == 0:
        return _gqa_train_tp(x, p, cfg, positions, mesh, sp)
    if sp:
        return whole_sequence(
            lambda xw: _attend_whole(xw, p, cfg, positions), x, mesh)
    return _attend_whole(x, p, cfg, positions)


def _decode_qkv_new(x: torch.Tensor, p: dict, cfg: ModelConfig,
                    cur: torch.Tensor,
                    rope_pos: Optional[torch.Tensor] = None):
    """Project + rope the C new tokens; returns ``(q, k_new, v_new, pos)``
    with ``pos`` the per-row write positions ((C,) or (B, C)).  q and k are
    roped at ``pos`` unless ``rope_pos`` is given (tree verification:
    siblings share a token position but write at distinct view positions;
    rope follows the token, the write follows the row)."""
    c = x.shape[1]
    q, k_new, v_new = _project_qkv(x, p, cfg)
    pos = decode_positions(cur, c)
    sin, cos = _rope_tables(pos if rope_pos is None else rope_pos, cfg.hd,
                            cfg.rope_theta)
    return apply_rope(q, sin, cos), apply_rope(k_new, sin, cos), v_new, pos


def _splitk_attend(q: torch.Tensor, k_view: torch.Tensor,
                   v_view: torch.Tensor, valid: torch.Tensor,
                   cfg: ModelConfig, page: int) -> torch.Tensor:
    """Split-K attention over fixed-size KV pages.

    q: (B, C, H, hd) roped queries; k_view/v_view: (B, Smax, Hkv, hd)
    views of the cache (a slot's dense rows or its gathered pages: the
    same math either way); ``valid`` masks attendable positions.  Each page gives
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


#: one layer's pool: a tensor, or a quantized ``(codes, scales)`` pair
Pool = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def _gather_view(pool: Pool, pages: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """The slot view of ``pool``: gathered, and dequantized into ``dtype``
    when the pool is a ``(codes, scales)`` pair."""
    if isinstance(pool, tuple):
        return paging.gather_pages_dequant(pool[0], pool[1], pages, dtype)
    return paging.gather_pages(pool, pages)


def _scatter_rows(pool: Pool, rows: torch.Tensor,
                  plan: paging.ScatterPlan) -> None:
    """Write ``rows`` into ``pool`` in place where ``plan``
    (:func:`~repro_torch.models.paging.scatter_plan`) puts them; a
    quantized pair takes the rows' codes and scales to the same
    coordinates."""
    rows = paging.plan_rows(rows, plan)
    if isinstance(pool, tuple):
        codes, scales = quant_kv.quantize_rows(rows,
                                               quant_kv.kv_bits(pool[0]))
        pool[0].index_put_(plan[:2], codes)
        pool[1].index_put_(plan[:2], scales)
    else:
        pool.index_put_(plan[:2], rows.to(pool.dtype))


def _decode_qkv_cache(x: torch.Tensor, p: dict, cfg: ModelConfig,
                      cache_k: torch.Tensor, cache_v: torch.Tensor,
                      cur_index: torch.Tensor,
                      nvalid: Optional[torch.Tensor] = None,
                      tree: Optional[tuple] = None,
                      valid: Optional[torch.Tensor] = None,
                      write_plan: Optional[Tuple[torch.Tensor, ...]] = None):
    """The decode front end every GQA decode path shares: project and rope
    the ``C`` new tokens, write them into ``cache_k`` / ``cache_v`` ((B,
    Smax, Hkv, hd): a slot's dense rows or its gathered page view) in
    place, and build the attention mask.  Without ``nvalid`` the write is
    :func:`batched_cache_write` (clamped like ``dynamic_update_slice``);
    with it, :func:`masked_cache_write` (near capacity a clamped block
    would shift over valid positions).  A ``tree`` ropes at ``index +
    pos_off`` and masks with :func:`tree_valid`.  ``valid`` and
    ``write_plan``, when the caller built them once for every layer,
    replace the mask and the row-masked write's indices.  Returns ``(q,
    k_new, v_new, pos, valid)``."""
    smax = cache_k.shape[1]
    rope_pos = None if tree is None else cur_index[:, None] + tree[1]
    q, k_new, v_new, pos = _decode_qkv_new(x, p, cfg, cur_index, rope_pos)
    if nvalid is None:
        batched_cache_write(cache_k, k_new, cur_index)
        batched_cache_write(cache_v, v_new, cur_index)
    else:
        if write_plan is None:
            write_plan = masked_write_plan(pos, nvalid, smax, x.shape[0])
        masked_cache_write(cache_k, k_new, plan=write_plan)
        masked_cache_write(cache_v, v_new, plan=write_plan)
    if valid is None:
        valid = attend_mask(cur_index, x.shape[1], smax, nvalid, tree)
    return q, k_new, v_new, pos, valid


def gqa_decode(x: torch.Tensor, p: dict, cfg: ModelConfig,
               cache_k: torch.Tensor, cache_v: torch.Tensor,
               cur_index: torch.Tensor,
               nvalid: Optional[torch.Tensor] = None,
               tree: Optional[Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]] = None,
               valid: Optional[torch.Tensor] = None,
               write_plan: Optional[Tuple[torch.Tensor, ...]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense-cache decode or chunked prefill of ``C`` new tokens per slot
    with one softmax over the whole cache (no page combine, no kernel).

    x: (B, C, D); cache_k/cache_v: (B, Smax, Hkv, hd), this layer's
    contiguous slot rows, written in place; ``cur_index``: a 0-d index
    (lockstep: every slot, or one slot's prefill chunk, at one offset) or
    (B,) per-slot lengths.  ``nvalid``, ``tree``, ``valid`` and
    ``write_plan`` as in :func:`_decode_qkv_cache`.  Returns (out (B, C,
    D), cache_k, cache_v)."""
    b, c, _ = x.shape
    q, _, _, _, valid = _decode_qkv_cache(x, p, cfg, cache_k, cache_v,
                                          cur_index, nvalid, tree, valid,
                                          write_plan)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    k = _repeat_kv(cache_k.to(x.dtype), n_rep)
    v = _repeat_kv(cache_v.to(x.dtype), n_rep)
    scores = torch.einsum("bchd,bshd->bhcs", q, k) / _sqrt_hd(cfg.hd, x.dtype)
    scores = torch.where(valid, scores.float(), NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhcs,bshd->bchd", probs, v)
    out = out.reshape(b, c, cfg.n_heads * cfg.hd)
    return out @ p["wo"].to(x.dtype), cache_k, cache_v


def gqa_decode_paged(x: torch.Tensor, p: dict, cfg: ModelConfig,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     cur_index: torch.Tensor, page: int,
                     nvalid: Optional[torch.Tensor] = None,
                     tree: Optional[Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]] = None,
                     valid: Optional[torch.Tensor] = None,
                     write_plan: Optional[Tuple[torch.Tensor, ...]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split-K decode over a *dense* per-slot cache: :func:`gqa_decode`'s
    arguments, with the cache's rows read as pages of ``page`` positions
    and combined by :func:`_splitk_attend` (the page combine is
    :func:`~repro_torch.kernels.ops.moa_reduce`, the hand-written kernel
    on CUDA tensors).  The same math as :func:`gqa_decode_pages` over the
    same rows, so a contiguous engine's tokens equal a paged one's."""
    smax = cache_k.shape[1]
    if smax % page:
        raise ValueError(f"page={page} must divide max_seq={smax}")
    q, _, _, _, valid = _decode_qkv_cache(x, p, cfg, cache_k, cache_v,
                                          cur_index, nvalid, tree, valid,
                                          write_plan)
    out = _splitk_attend(q, cache_k, cache_v, valid, cfg, page)
    return out @ p["wo"].to(out.dtype), cache_k, cache_v


def gqa_decode_pages(x: torch.Tensor, p: dict, cfg: ModelConfig,
                     pool_k: Pool, pool_v: Pool,
                     cur_index: torch.Tensor, pages: torch.Tensor,
                     nvalid: Optional[torch.Tensor] = None,
                     tree: Optional[Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]] = None,
                     valid: Optional[torch.Tensor] = None,
                     write_plan: Optional[Tuple[torch.Tensor, ...]] = None,
                     scatter: Optional[paging.ScatterPlan] = None
                     ) -> Tuple[torch.Tensor, Pool, Pool]:
    """Paged split-K decode of ``C`` new tokens per slot.

    x: (B, C, D); pool_k/pool_v: ``(num_pages, page, Hkv, hd)`` physical
    page pools (this layer's); ``cur_index``: scalar chunk start (prefill)
    or (B,) per-slot lengths (decode); ``pages``: (B, n_pages) int64 page
    table.  The slot views are gathered from the pool, the new rows are
    written into the views (clamped like ``dynamic_update_slice``), the
    split-K attention runs over the views, and the new rows are scattered
    into the pools in place.  Returns (out (B, C, D), pool_k, pool_v).

    ``nvalid`` (B,): speculative verification's per-slot count of valid
    rows.  The view write drops rows at or past it
    (:func:`masked_cache_write`: near capacity a clamped block would shift
    over valid positions), and the pool scatter sends them to scratch.

    ``tree = (parents, pos_off, nchain)`` (each (B, C), (B, C), (B,)): tree
    verification.  The block is ``nchain[b]`` chain rows (tokens already
    emitted, committed at ``index + j``) and then drafted tree rows.  Every
    valid row is written into the view at ``index + j``, roped at ``index +
    pos_off``, and masked by :func:`tree_valid`; the pool scatter counts
    ``nchain`` rows, so drafted rows land on scratch and a rejected branch
    needs no rollback.

    ``valid``, ``write_plan`` and ``scatter``: the attention mask, with
    ``nvalid`` the row-masked write's indices, and the pool scatter's
    coordinates, when the caller built them once for every layer
    (:func:`attend_mask`, :func:`masked_write_plan`,
    :func:`~repro_torch.models.paging.scatter_plan`); else they are built
    here.

    Quantized pages: ``pool_k`` and ``pool_v`` may each be a ``(codes,
    scales)`` pair (:func:`repro_torch.serve.cache.quant_state_specs`).
    The view is dequantized into ``x.dtype``
    (:func:`~repro_torch.models.paging.gather_pages_dequant`), the new
    rows are written into it unquantized, and
    :func:`~repro_torch.models.quant_kv.quantize_rows` runs on the scatter:
    codes and scales through the same table with the same row count."""
    page = (pool_k[0] if isinstance(pool_k, tuple) else pool_k).shape[1]
    k_view = _gather_view(pool_k, pages, x.dtype)
    v_view = _gather_view(pool_v, pages, x.dtype)
    q, k_new, v_new, pos, valid = _decode_qkv_cache(
        x, p, cfg, k_view, v_view, cur_index, nvalid, tree, valid,
        write_plan)
    out = _splitk_attend(q, k_view, v_view, valid, cfg, page)
    if scatter is None:
        scatter = paging.scatter_plan(pages, pos, page, x.shape[0],
                                      nvalid if tree is None else tree[2])
    _scatter_rows(pool_k, k_new, scatter)
    _scatter_rows(pool_v, v_new, scatter)
    return out @ p["wo"].to(out.dtype), pool_k, pool_v


def _dp_size(mesh) -> int:
    shape = dict(getattr(mesh, "shape", mesh))
    return math.prod(n for a, n in shape.items() if a != "model")


def splitk_ok(cfg: ModelConfig, mesh, batch: int, smax: int) -> bool:
    """Whether :func:`gqa_decode_splitk` applies: a ``model`` axis of 2 or
    more ranks that divides the cache length ``smax``, and data axes that
    divide ``batch`` (the whole batch and cache, not a rank's block)."""
    tp = _model_size(mesh)
    if tp <= 1:
        return False
    return smax % tp == 0 and batch % _dp_size(mesh) == 0


def splitk_write(pairs, cur_index: torch.Tensor, pos: torch.Tensor, mesh
                 ) -> torch.Tensor:
    """The split-K cache write, in place, and this rank's mask.  ``pairs``
    are ``(cache, new)``: a cache block (B / dp, Smax / tp, ...) holding
    positions ``[i * Smax / tp, (i + 1) * Smax / tp)`` on ``model`` rank
    ``i``, and its C new rows (B / dp, C, ...) at positions ``pos`` =
    ``cur_index + j``.  Only the rank that owns a row's position writes
    it.  Returns ``valid`` (C, Smax / tp): which of the block's positions
    each row attends to."""
    c = pos.shape[0]
    s_loc = pairs[0][0].shape[1]
    lo = mesh.index("model") * s_loc
    if c == 1:
        # shard-local conditional write: only the owner updates its block
        at_pos = cur_index - lo
        write = (at_pos >= 0) & (at_pos < s_loc)
        # int64 for index_copy_: the dry run's and JAX's index is int32
        at = torch.clamp(at_pos, 0, s_loc - 1).reshape(1).long()
        for cache, new in pairs:
            old = cache.index_select(1, at)
            cache.index_copy_(1, at, torch.where(write, new.to(cache.dtype),
                                                 old))
    else:
        # a chunk's rows j at cur + j: this rank writes rows [j0, j1)
        first = int(cur_index) - lo
        j0, j1 = min(max(-first, 0), c), min(max(s_loc - first, 0), c)
        if j1 > j0:
            for cache, new in pairs:
                cache[:, first + j0:first + j1] = new[:, j0:j1].to(
                    cache.dtype)
    return ((lo + torch.arange(s_loc, device=pos.device))[None, :]
            <= pos[:, None])


def gqa_decode_splitk(x: torch.Tensor, p: dict, cfg: ModelConfig,
                      cache_k: torch.Tensor, cache_v: torch.Tensor,
                      cur_index: torch.Tensor, mesh
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split-K decode of C new tokens a sequence on one rank of ``mesh``;
    the KV cache never moves.

    ``x`` (B / dp, C, D) are this rank's batch rows (split over the data
    axes, the same on every ``model`` rank): one token a sequence for a
    decode step, or a prefill chunk at positions ``cur_index + j``;
    ``cache_k`` / ``cache_v`` (B / dp, Smax / tp, Hkv, hd) its block of
    the cache, positions ``[i * Smax / tp, (i + 1) * Smax / tp)`` on
    ``model`` rank ``i``; ``cur_index`` a 0-d position shared by every
    sequence.  The rank that owns a row's position writes its new K/V row
    into its block, in place; every rank scores the queries against its
    block with the grouped heads (no repeat of the KV heads), each row up
    to its own position; the partial accumulators combine with a max of
    the row maxima and sums of the sum-exp and PV partials over ``model``
    — the paper's reconfigured multi-operand combine applied to
    attention.  Returns (out (B / dp, C, D), cache_k, cache_v)."""
    b, c = x.shape[:2]
    hkv, rep, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    q, k_new, v_new, pos = _decode_qkv_new(x, p, cfg, cur_index)
    valid = splitk_write(((cache_k, k_new), (cache_v, v_new)), cur_index,
                         pos, mesh)
    qg = q.reshape(b, c, hkv, rep, hd)
    scores = torch.einsum("bqgrh,bsgh->bgrqs", qg, cache_k.to(q.dtype))
    scores = scores.float() / math.sqrt(hd)
    scores = torch.where(valid, scores, NEG_INF)
    t, group = mesh.transport, mesh.group("model")
    m = t.all_reduce(torch.amax(scores, dim=-1), group, op="max")
    p_ = torch.exp(scores - m[..., None])
    o_loc = torch.einsum("bgrqs,bsgh->bgrqh", p_.to(q.dtype),
                         cache_v.to(q.dtype))
    # the multi-operand combine: partial (l, o) accumulators summed
    l = t.all_reduce(p_.sum(-1), group)
    o = t.all_reduce(o_loc.float(), group)
    out = (o / l[..., None]).to(q.dtype)                 # (b, g, r, C, hd)
    out = out.movedim(3, 1).reshape(b, c, cfg.n_heads * hd)
    return out @ p["wo"].to(x.dtype), cache_k, cache_v
