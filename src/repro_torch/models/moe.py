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

Not here: the expert-parallel paths ``moe_ffn_ep`` and ``moe_ffn_ep_psum``
(``ROADMAP.md`` queue 1 step 6b).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.common import ParamSpec, topk_low_index_first

__all__ = ["dense_ffn_specs", "dense_ffn", "moe_param_specs", "moe_ffn",
           "moe_ffn_dense_dispatch"]


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


def _router(xt: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(weights (T, k) in ``xt.dtype``, expert ids (T, k), aux loss).

    Logits in ``xt.dtype``, softmax in fp32; the top-k weights are taken
    by gather, so their gradient reaches the probs as ``lax.top_k``'s
    does, renormalised over the k, then cast.  The aux loss is the
    Switch load-balancing term ``E * sum_e f_e * P_e`` over the top-1
    picks."""
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
    xk = xt.repeat_interleave(cfg.top_k, dim=0)            # (T*k, D)
    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((flat_e, pos), xk * kept, accumulate=True)
    out_buf = _local_expert_ffn(buf, p["w1"], p["w3"], p["w2"], x.dtype)
    gathered = out_buf[flat_e, pos] * kept
    combined = _topk_combine(gathered, weights, t, d, cfg)
    return combined.reshape(b, s, d), aux


def moe_ffn(x: torch.Tensor, p: dict, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN with the optional shared expert: (y, aux)."""
    y, aux = moe_ffn_dense_dispatch(x, p, cfg)
    if cfg.n_shared_experts:
        dt = x.dtype
        h = F.silu(x @ p["shared_w1"].to(dt)) * (x @ p["shared_w3"].to(dt))
        y = y + h @ p["shared_w2"].to(dt)
    return y, aux
