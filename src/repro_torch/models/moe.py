"""Feed-forward layers: the dense SwiGLU FFN and the routed MoE FFN.

The counterpart of ``repro/models/moe.py`` on one card: the MoE FFN takes
the reference's dense dispatch (``moe_ffn_dense_dispatch``, what it runs
with no mesh).  Each token's router picks its ``top_k`` experts (ties:
lower expert first, as ``jax.lax.top_k`` ranks them); every (token, k)
assignment queues, in token-major, k-minor order, into its expert's buffer
of ``ceil(T * top_k * capacity_factor / n_experts)`` places, and those past
capacity are dropped (GShard).  Capacity depends on the dispatch's whole
token count T, so the rows of a dispatch share it: which rows an engine
feeds, padding and idle lanes included, changes the drops.  Every expert
runs on its whole buffer, and each token's ``top_k`` weighted outputs are
summed by :func:`repro_torch.kernels.ops.moa_reduce`, the paper's
k-operand accumulation (on the card, the hand-written kernel).

On a device mesh (:class:`repro_torch.launch.mesh.Mesh`) the experts are
split over the ``model`` ranks.  :func:`moe_ffn_ep` is the production
layout: each rank routes its own tokens (its batch rows and its stretch of
the sequence), packs a capacity buffer a destination sized on ITS token
count, exchanges them in one all-to-all, runs its local experts and
reverses the exchange; the expert weights arrive split over the data axes
too and are all-gathered there first (ZeRO-3), but where they are whole
on every rank, as :func:`moe_ffn` has them, they are split over
``model`` only and nothing is gathered.  :func:`moe_ffn_ep_psum`,
the decode shape, keeps the tokens on every ``model`` rank: each rank
runs only the assignments to its own experts and the partial outputs are
summed over ``model``.  Either way the top-k combine is the same
:func:`~repro_torch.kernels.ops.moa_reduce` on every rank.
:func:`moe_ffn` picks the path as the JAX function does.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import transport as tx
from repro_torch.kernels import ops as kops
from repro_torch.models.common import ParamSpec, topk_low_index_first

__all__ = ["dense_ffn_specs", "dense_ffn", "moe_param_specs", "moe_ffn",
           "moe_ffn_dense_dispatch", "moe_ffn_ep", "moe_ffn_ep_psum"]


def dense_ffn_specs(cfg: ModelConfig) -> dict:
    """Per-layer SwiGLU params (leading layer axis added by the caller)."""
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w1": ParamSpec((d, f), ("embed", "mlp")),
        "w3": ParamSpec((d, f), ("embed", "mlp")),
        "w2": ParamSpec((f, d), ("mlp", "embed")),
    }


def moe_param_specs(cfg: ModelConfig) -> dict:
    """Per-layer MoE params: the (d, E) router, the stacked experts and,
    with ``n_shared_experts``, one SwiGLU of width ``d_ff * n_shared``
    that every token takes (Llama-4)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    specs = {
        "router": ParamSpec((d, e), ("embed", "experts"), scale=0.02),
        "w1": ParamSpec((e, d, f), ("experts", "embed", "moe_mlp")),
        "w3": ParamSpec((e, d, f), ("experts", "embed", "moe_mlp")),
        "w2": ParamSpec((e, f, d), ("experts", "moe_mlp", "embed")),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        specs["shared_w1"] = ParamSpec((d, fs), ("embed", "mlp"))
        specs["shared_w3"] = ParamSpec((d, fs), ("embed", "mlp"))
        specs["shared_w2"] = ParamSpec((fs, d), ("mlp", "embed"))
    return specs


def dense_ffn(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """``(silu(x @ w1) * (x @ w3)) @ w2``, weights cast to ``x.dtype`` at
    use (fp32 masters, bf16 compute; a no-op when they already match)."""
    dt = x.dtype
    return (F.silu(x @ p["w1"].to(dt)) * (x @ p["w3"].to(dt))) @ p["w2"].to(dt)


def _topk_combine(gathered: torch.Tensor, weights: torch.Tensor, t: int,
                  d: int, cfg: ModelConfig) -> torch.Tensor:
    """Each token's ``top_k`` weighted expert outputs summed: ``gathered``
    (T * k, D), ``weights`` (T, k) -> (T, D).  With ``use_moa_reduce`` the
    sum is one multi-operand reduce in fp32 over the k operands."""
    parts = gathered.reshape(t, cfg.top_k, d) * weights[..., None]
    if cfg.use_moa_reduce:
        return kops.moa_reduce(parts.movedim(1, 0), acc_dtype=torch.float32,
                               out_dtype=gathered.dtype)
    return parts.sum(1)


def _router(xt: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig,
            mesh=None, gather_axis: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(weights (T, k) in ``xt.dtype``, expert ids (T, k), aux loss).

    Logits in ``xt.dtype``, softmax in fp32; the top-k weights are taken
    by gather, so their gradient reaches the probs as ``lax.top_k``'s
    does, renormalised over the k, then cast.  The aux loss is the
    Switch load-balancing term ``E * sum_e f_e * P_e`` over the top-1
    picks.

    ``gather_axis``: on a mesh, ``router_w`` is this rank's (d, e_local)
    block of experts; the weight (small: d x E) is all-gathered over that
    axis before the matmul, since the ranks hold different tokens."""
    if gather_axis is not None:
        router_w = tx.all_gather(router_w, mesh, gather_axis, -1)
    logits = (xt @ router_w.to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    idx = topk_low_index_first(probs, cfg.top_k)
    weights = probs.gather(-1, idx)
    if cfg.renorm_topk and cfg.top_k > 1:
        weights = weights / weights.sum(-1, keepdim=True)
    e = cfg.n_experts
    f_e = F.one_hot(idx[:, 0], e).float().mean(0)
    p_e = probs.mean(0)
    aux = e * torch.sum(f_e * p_e) * cfg.router_aux_coef
    return weights.to(xt.dtype), idx, aux


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    return max(1, math.ceil(tokens * cfg.top_k * cfg.capacity_factor
                            / cfg.n_experts))


def _dispatch_indices(idx: torch.Tensor, e: int, cap: int):
    """Queue place of each (token, k) assignment in its expert, counted
    over ``idx.reshape(-1)``: (expert (T*k,), place clipped to
    ``cap - 1``, kept = place < cap)."""
    flat_e = idx.reshape(-1)
    pos = F.one_hot(flat_e, e).cumsum(0) - 1
    pos = pos.gather(1, flat_e[:, None])[:, 0]
    keep = pos < cap
    return flat_e, torch.where(keep, pos, cap - 1), keep


def _local_expert_ffn(tokens: torch.Tensor, w1, w3, w2, dtype
                      ) -> torch.Tensor:
    """tokens (E, C, D) -> (E, C, D), each buffer through its expert."""
    h = torch.bmm(tokens, w1.to(dtype))
    g = torch.bmm(tokens, w3.to(dtype))
    return torch.bmm(F.silu(h) * g, w2.to(dtype))


def _dispatch(xt: torch.Tensor, flat_e: torch.Tensor, pos: torch.Tensor,
              kept: torch.Tensor, e: int, cap: int, k: int) -> torch.Tensor:
    """The (e, cap, D) capacity buffers: each kept (token, k) assignment
    added at (expert, place); a dropped one adds ``x * 0``."""
    xk = xt.repeat_interleave(k, dim=0)                    # (T*k, D)
    buf = torch.zeros((e, cap, xt.shape[1]), dtype=xt.dtype,
                      device=xt.device)
    return buf.index_put((flat_e, pos), xk * kept, accumulate=True)


def moe_ffn_dense_dispatch(x: torch.Tensor, p: dict, cfg: ModelConfig
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-buffered dispatch of all B * S tokens of ``x`` (B, S, D):
    returns (y (B, S, D), aux).  A dropped assignment adds ``x * 0`` at
    place ``cap - 1`` and gathers zero, as in the reference."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    weights, idx, aux = _router(xt, p["router"], cfg)
    cap = _capacity(t, cfg)
    e = cfg.n_experts
    flat_e, pos, keep = _dispatch_indices(idx, e, cap)
    kept = keep[:, None].to(x.dtype)
    buf = _dispatch(xt, flat_e, pos, kept, e, cap, cfg.top_k)
    out_buf = _local_expert_ffn(buf, p["w1"], p["w3"], p["w2"], x.dtype)
    gathered = out_buf[flat_e, pos] * kept
    combined = _topk_combine(gathered, weights, t, d, cfg)
    return combined.reshape(b, s, d), aux


def moe_ffn_ep(x: torch.Tensor, p: dict, cfg: ModelConfig, mesh,
               ep_axis: str = "model") -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE FFN on one rank of ``mesh`` (all-to-all).

    Takes this rank's blocks, as the JAX ``shard_map`` splits them: ``x``
    (B / dp, S / ep, D), its batch rows over the data axes (every axis but
    ``ep_axis``, row-major) and its stretch of the sequence over
    ``ep_axis``; ``router`` (D / dp, E / ep); ``w1`` / ``w3`` (E / ep,
    D / dp, F); ``w2`` (E / ep, F, D / dp).  The weights are all-gathered
    over the data axes in-region (their gradients reduce-scattered back),
    then :func:`_moe_ep_local` runs the layer.  Returns (y (B / dp, S / ep,
    D), aux: the mean of the ranks' router losses).  Gradients are those
    of the sum of the ranks' losses."""
    dp_axes = tuple(a for a in mesh.axis_names if a != ep_axis)
    router_w, w1, w3, w2 = p["router"], p["w1"], p["w3"], p["w2"]
    if dp_axes:
        # in-region FSDP: gather the embed dim of the expert weights
        router_w = tx.all_gather(router_w, mesh, dp_axes, 0)
        w1 = tx.all_gather(w1, mesh, dp_axes, 1)
        w3 = tx.all_gather(w3, mesh, dp_axes, 1)
        w2 = tx.all_gather(w2, mesh, dp_axes, 2)
    return _moe_ep_local(x, router_w, w1, w3, w2, cfg, mesh, ep_axis)


def _moe_ep_local(x: torch.Tensor, router_w: torch.Tensor, w1, w3, w2,
                  cfg: ModelConfig, mesh, ep_axis: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_ffn_ep` on this rank's experts, their embed dim whole:
    ``router_w`` (D, E / ep), ``w1`` / ``w3`` (E / ep, D, F), ``w2``
    (E / ep, F, D).  The router's block is all-gathered over ``ep_axis``;
    capacity is sized on this rank's token count; the (ep, e_local * cap,
    D) buffers go out and back in one all-to-all each."""
    ep = mesh.shape[ep_axis]
    e = cfg.n_experts
    if e % ep:
        raise ValueError(f"{e} experts do not split over {ep} {ep_axis!r} "
                         f"ranks")
    e_local = e // ep
    dp_axes = tuple(a for a in mesh.axis_names if a != ep_axis)
    bl, sl, d = x.shape
    xt = x.reshape(-1, d)
    t = xt.shape[0]                                        # this rank's
    weights, idx, aux = _router(xt, router_w, cfg, mesh, ep_axis)
    cap = _capacity(t, cfg)
    flat_e, pos, keep = _dispatch_indices(idx, e, cap)
    kept = keep[:, None].to(x.dtype)
    send = _dispatch(xt, flat_e, pos, kept, e, cap, cfg.top_k)
    # (E, cap, D) -> (ep, e_local*cap, D) -> exchange -> per-source rows
    recv = tx.all_to_all(send.reshape(ep, e_local * cap, d), mesh, ep_axis)
    tokens = recv.reshape(ep, e_local, cap, d).movedim(1, 0)
    out = _local_expert_ffn(tokens.reshape(e_local, ep * cap, d), w1, w3, w2,
                            x.dtype)
    out = out.reshape(e_local, ep, cap, d).movedim(0, 1)
    back = tx.all_to_all(out.reshape(ep, e_local * cap, d), mesh, ep_axis)
    gathered = back.reshape(e, cap, d)[flat_e, pos] * kept
    combined = _topk_combine(gathered, weights, t, d, cfg)
    aux = tx.all_reduce(aux, mesh, (ep_axis,) + dp_axes) / mesh.size(
        mesh.axis_names)
    return combined.reshape(bl, sl, d), aux


def moe_ffn_ep_psum(x: torch.Tensor, p: dict, cfg: ModelConfig, mesh,
                    ep_axis: str = "model"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode-shape expert parallelism on one rank of ``mesh``.

    ``x`` (B, S, D) is the same on every ``ep_axis`` rank; ``router`` (D,
    E / ep) and ``w1`` / ``w3`` / ``w2`` (E / ep, ...) are this rank's
    experts.  Each rank buffers and runs only the kept assignments to its
    own experts (the ``mine`` mask) and the partial top-k combines are
    summed over ``ep_axis`` — a multi-operand reduction over the model
    axis.  Returns (y (B, S, D), aux), the same on every rank, with every
    rank's gradients the whole gradient of the one loss."""
    ep = mesh.shape[ep_axis]
    e = cfg.n_experts
    e_local = e // ep
    x = tx.copy_to(x, mesh, ep_axis)
    bl, sl, d = x.shape
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    weights, idx, aux = _router(xt, p["router"], cfg, mesh, ep_axis)
    lo = mesh.index(ep_axis) * e_local
    cap = _capacity(t, cfg)
    flat_e, pos, keep = _dispatch_indices(idx, e, cap)
    mine = ((flat_e >= lo) & (flat_e < lo + e_local) & keep)[:, None]
    mine = mine.to(x.dtype)
    local_idx = torch.clamp(flat_e - lo, 0, e_local - 1)
    buf = _dispatch(xt, local_idx, pos, mine, e_local, cap, cfg.top_k)
    out_buf = _local_expert_ffn(buf, p["w1"], p["w3"], p["w2"], x.dtype)
    gathered = out_buf[local_idx, pos] * mine
    partial = _topk_combine(gathered, weights, t, d, cfg)
    y = tx.reduce_from(partial, mesh, ep_axis)
    # the tokens are the same on every rank, so is aux: the mean only
    # splits its gradient between the ranks' copies of the router
    aux = tx.reduce_from(aux, mesh, ep_axis) / ep
    return y.reshape(bl, sl, d), aux


def moe_ffn(x: torch.Tensor, p: dict, cfg: ModelConfig, mesh=None,
            sp: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN with the optional shared expert: (y, aux).

    Without a mesh, or where the JAX function would not take expert
    parallelism (``use_ep`` off, no ``model`` axis of 2 or more ranks, the
    experts not divisible over it, or the sequence not), the dense
    dispatch.  Else expert parallelism: ``x`` here is this rank's batch
    rows (B / dp, S, D), the same on every ``model`` rank, and ``p`` the
    whole weights, the same on every rank (the sharded train step gathers
    the layer's blocks before the layer runs); each rank takes its stretch of
    the sequence and its experts (split over ``model`` only: the weights
    are whole already, so nothing is gathered over the data axes, and the
    train step's mean over them gives the mean gradient), and the outputs
    are gathered back over ``model``.  The model ranks hold one loss
    between them, so every rank's gradients are the whole ones, and aux's
    is split between them (its forward value is unchanged).

    With ``sp`` (the sequence-parallel layout) ``x`` is already this
    rank's stretch (B / dp, S / tp, D) and so is ``y``: expert parallelism
    routes it as it stands, its weights whole or, as the sharded train
    step hands them under EP, this rank's experts already (``router`` (D,
    E / tp), ``w1`` / ``w3`` / ``w2`` (E / tp, ...)); the dense dispatch
    gathers the rank's whole sequence first, since its capacity and its
    token-major drops are those of the whole dispatch, and keeps the
    rank's stretch.
    Each rank's weight gradients are then its stretch's part, summed over
    ``model`` by the caller (:func:`~repro_torch.models.common.whole`)."""
    ep = mesh.shape.get("model", 1) if mesh is not None else 1
    s = x.shape[1] * (ep if sp else 1)
    if (cfg.use_ep and ep > 1 and cfg.n_experts % ep == 0
            and s % ep == 0):
        m = mesh.index("model")
        if sp:
            w = {k: (p[k] if p[k].shape[1 if k == "router" else 0]
                     != cfg.n_experts
                     else p[k].chunk(ep, 1 if k == "router" else 0)[m])
                 for k in ("router", "w1", "w3", "w2")}
            x_blk = x
        else:
            w = {k: tx.copy_to(p[k], mesh, "model").chunk(
                ep, 1 if k == "router" else 0)[m]
                for k in ("router", "w1", "w3", "w2")}
            x_blk = tx.copy_to(x, mesh, "model").chunk(ep, 1)[m]
        y, aux = _moe_ep_local(x_blk, w["router"], w["w1"], w["w3"],
                               w["w2"], cfg, mesh, "model")
        if not sp:
            y = tx.gather_from(y, mesh, "model", 1)
        aux = aux.detach() + (aux - aux.detach()) / ep
    elif sp:
        # as whole_sequence does: the rank's stretch of the dispatch of the
        # whole sequence; every rank's aux is the same one, over its rows'
        # whole sequence, so its gradient is split between the ranks
        y, aux = moe_ffn_dense_dispatch(tx.all_gather(x, mesh, "model", 1),
                                        p, cfg)
        y = y.chunk(ep, 1)[mesh.index("model")]
        aux = aux.detach() + (aux - aux.detach()) / ep
    else:
        y, aux = moe_ffn_dense_dispatch(x, p, cfg)
    if cfg.n_shared_experts:
        dt = x.dtype
        h = F.silu(x @ p["shared_w1"].to(dt)) * (x @ p["shared_w3"].to(dt))
        y = y + h @ p["shared_w2"].to(dt)
    return y, aux
