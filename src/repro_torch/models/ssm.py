"""State-space layers: Mamba-1 (selective scan) and Mamba-2 (SSD).

The counterpart of ``repro/models/ssm.py`` on one card, in its dtype
order: Mamba-1 takes the softplus of ``dt`` in the activations' dtype and
only then goes to fp32 (:func:`_mamba1_bcdt`), Mamba-2 takes it in fp32;
the recurrent state ``h`` is always fp32, the conv window is in the
activations' dtype, and both convs (:func:`_causal_conv1d` over a sequence,
:func:`_conv_step` over the rolling window) sum their ``K`` taps in the
same order, so a prefill that steps the decode function agrees with the
training forward.

* Mamba-1 (:func:`mamba1_train`): a loop over sequence chunks carries the
  ``(B, d_inner, N)`` state; inside a chunk the recurrence
  ``h_t = a_t * h_{t-1} + b_t`` runs as an associative scan of
  :func:`_ssm_assoc_op` (:func:`_assoc_scan`, ``jax.lax.associative_scan``'s
  odd/even recursion: products only, no division, so no underflowing
  ``exp(dt * A)`` is ever divided by).
* Mamba-2 / SSD (:func:`mamba2_train`): the chunked form, an intra-chunk
  attention-like term plus the inter-chunk state recurrence.
* Decode (:func:`mamba1_decode`, :func:`mamba2_decode`): one token against
  an O(1) state ``{"h", "conv"}``; both return the new state as new
  tensors (the callers write them into the engine's slots).

Plain PyTorch: the reference runs no Pallas kernel here.  On a device
mesh every rank runs its own batch rows whole: the JAX package shards
``d_inner`` / the heads over ``model`` through sharding constraints alone
(no collective of its own), which the port has no partitioner for.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec, rms_norm

__all__ = [
    "mamba1_param_specs", "mamba1_train", "mamba1_decode",
    "mamba1_init_state",
    "mamba2_param_specs", "mamba2_train", "mamba2_decode",
    "mamba2_init_state",
]

Pair = Tuple[torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _tap_sum(taps: Sequence[torch.Tensor]) -> torch.Tensor:
    """``taps[0] + taps[1] + ...`` left to right (the reference's
    ``sum(...)`` from a Python 0, without the add of the 0)."""
    y = taps[0]
    for t in taps[1:]:
        y = y + t
    return y


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                   ) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C); w: (C, K); b: (C,)."""
    k, s = w.shape[-1], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    w = w.to(x.dtype)
    y = _tap_sum([xp[:, i:i + s] * w[:, i] for i in range(k)])
    return y + b.to(x.dtype)


def _conv_step(x_new: torch.Tensor, conv_cache: torch.Tensor,
               w: torch.Tensor, b: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token conv using a (B, K-1, C) rolling cache; returns (y (B, 1,
    C), the new cache)."""
    window = torch.cat([conv_cache, x_new.to(conv_cache.dtype)], dim=1)
    k = window.shape[1]
    w = w.to(window.dtype)
    y = _tap_sum([window[:, i] * w[:, i] for i in range(k)])
    y = y + b.to(x_new.dtype)
    return y[:, None], window[:, 1:]


def _ssm_assoc_op(l: Pair, r: Pair) -> Pair:
    """Compose h = a*h_prev + b segments (diagonal A)."""
    al, bl = l
    ar, br = r
    return ar * al, ar * bl + br


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    """a0, b0, a1, b1, ... along ``axis`` (``a`` one longer or as long)."""
    n = b.shape[axis]
    head = torch.stack([a.narrow(axis, 0, n), b], dim=axis + 1)
    head = head.flatten(axis, axis + 1)
    if a.shape[axis] == n:
        return head
    return torch.cat([head, a.narrow(axis, n, 1)], dim=axis)


def _assoc_scan(elems: List[torch.Tensor], axis: int) -> List[torch.Tensor]:
    """Inclusive scan of :func:`_ssm_assoc_op` along ``axis``, by the odd /
    even recursion of ``jax.lax.associative_scan`` (the same association
    order)."""
    n = elems[0].shape[axis]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.dim()
        idx[axis] = slice(start, stop, step)
        return t[tuple(idx)]

    reduced = _ssm_assoc_op(tuple(sl(e, 0, -1, 2) for e in elems),
                            tuple(sl(e, 1, None, 2) for e in elems))
    odd = _assoc_scan(list(reduced), axis)
    if n % 2 == 0:
        even = _ssm_assoc_op(tuple(sl(e, 0, -1) for e in odd),
                             tuple(sl(e, 2, None, 2) for e in elems))
    else:
        even = _ssm_assoc_op(tuple(odd), tuple(sl(e, 2, None, 2)
                                               for e in elems))
    even = [torch.cat([sl(e, 0, 1), r], dim=axis)
            for e, r in zip(elems, even)]
    return [_interleave(e, o, axis) for e, o in zip(even, odd)]


def _chunking(s: int, chunk: int) -> Tuple[int, int]:
    """(chunk, n_chunks) of a length-``s`` sequence: one chunk when
    ``chunk`` does not divide ``s``, as in the reference."""
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s
    return chunk, s // chunk


# ---------------------------------------------------------------------------
# Mamba-1 (falcon-mamba)
# ---------------------------------------------------------------------------

def mamba1_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, di, n, k, dtr = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                        cfg.ssm_conv, cfg.dt_rank)
    return {
        "in_proj": ParamSpec((d, 2 * di), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((di, k), ("ssm_inner", "conv"), scale=0.2),
        "conv_b": ParamSpec((di,), ("ssm_inner",), init="zeros"),
        "x2dt": ParamSpec((di, dtr), ("ssm_inner", None)),
        "dt_proj": ParamSpec((dtr, di), (None, "ssm_inner")),
        "dt_bias": ParamSpec((di,), ("ssm_inner",), init="ssm_dt"),
        "wB": ParamSpec((di, n), ("ssm_inner", "ssm_state")),
        "wC": ParamSpec((di, n), ("ssm_inner", "ssm_state")),
        "A_log": ParamSpec((di, n), ("ssm_inner", "ssm_state"), init="ssm_a"),
        "D": ParamSpec((di,), ("ssm_inner",), init="ones"),
        "out_proj": ParamSpec((di, d), ("ssm_inner", "embed")),
    }


def mamba1_init_state(cfg: ModelConfig, batch: int,
                      dtype: torch.dtype = torch.float32,
                      device=None) -> Dict[str, torch.Tensor]:
    return {
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
    }


def _mamba1_bcdt(x1: torch.Tensor, p: dict):
    """Data-dependent (dt, B, C) from the conv'd activation; the softplus
    runs in ``x1``'s dtype, then fp32."""
    dt_ = x1.dtype
    dt = F.softplus((x1 @ p["x2dt"].to(dt_)) @ p["dt_proj"].to(dt_)
                    + p["dt_bias"].to(dt_)).float()
    bb = (x1 @ p["wB"].to(dt_)).float()
    cc = (x1 @ p["wC"].to(dt_)).float()
    return dt, bb, cc


def mamba1_train(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    b, s, _ = x.shape
    x1, z = (x @ p["in_proj"].to(x.dtype)).chunk(2, dim=-1)
    x1 = F.silu(_causal_conv1d(x1, p["conv_w"], p["conv_b"]))
    dt, bb, cc = _mamba1_bcdt(x1, p)
    a = -torch.exp(p["A_log"].float())                      # (di, N)
    x1f = x1.float()
    chunk, nc = _chunking(s, cfg.ssm_chunk)
    h = torch.zeros((b, x1.shape[-1], cfg.ssm_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for i in range(nc):
        sl = slice(i * chunk, (i + 1) * chunk)
        dt_c, x_c, b_c, c_c = dt[:, sl], x1f[:, sl], bb[:, sl], cc[:, sl]
        da = torch.exp(dt_c[..., None] * a)                 # (B, c, di, N)
        dbx = (dt_c * x_c)[..., None] * b_c[:, :, None, :]
        acum, bcum = _assoc_scan([da, dbx], axis=1)
        h_t = acum * h[:, None] + bcum                      # (B, c, di, N)
        ys.append(torch.einsum("bcdn,bcn->bcd", h_t, c_c))
        h = h_t[:, -1]
    y = torch.cat(ys, dim=1)
    y = y + p["D"].float() * x1f
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["out_proj"].to(x.dtype)


def mamba1_decode(x: torch.Tensor, p: dict, cfg: ModelConfig,
                  state: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, D); O(1)-state single-token step.  Returns (out (B, 1, D),
    the new state {"h", "conv"} as new tensors)."""
    x1, z = (x @ p["in_proj"].to(x.dtype)).chunk(2, dim=-1)
    x1c, conv_cache = _conv_step(x1, state["conv"], p["conv_w"], p["conv_b"])
    x1c = F.silu(x1c)
    dt, bb, cc = _mamba1_bcdt(x1c, p)
    a = -torch.exp(p["A_log"].float())
    x0 = x1c[:, 0].float()
    da = torch.exp(dt[:, 0, :, None] * a)                   # (B, di, N)
    dbx = (dt[:, 0] * x0)[..., None] * bb[:, 0, None, :]
    h = da * state["h"] + dbx
    y = torch.einsum("bdn,bn->bd", h, cc[:, 0])
    y = y + p["D"].float() * x0
    y = y[:, None].to(x.dtype) * F.silu(z)
    out = y @ p["out_proj"].to(x.dtype)
    return out, {"h": h, "conv": conv_cache}


# ---------------------------------------------------------------------------
# Mamba-2 / SSD (zamba2)
# ---------------------------------------------------------------------------

def mamba2_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, di, n, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    h = cfg.ssm_heads
    conv_dim = di + 2 * n
    return {
        "in_proj": ParamSpec((d, 2 * di + 2 * n + h), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((conv_dim, k), ("ssm_inner", "conv"), scale=0.2),
        "conv_b": ParamSpec((conv_dim,), ("ssm_inner",), init="zeros"),
        # the reference draws A_log with the dt initialiser; kept as is
        "A_log": ParamSpec((h,), ("ssm_heads",), init="ssm_dt"),
        "dt_bias": ParamSpec((h,), ("ssm_heads",), init="ssm_dt"),
        "D": ParamSpec((h,), ("ssm_heads",), init="ones"),
        "norm_w": ParamSpec((di,), ("ssm_inner",), init="ones"),
        "out_proj": ParamSpec((di, d), ("ssm_inner", "embed")),
    }


def mamba2_init_state(cfg: ModelConfig, batch: int,
                      dtype: torch.dtype = torch.float32,
                      device=None) -> Dict[str, torch.Tensor]:
    return {
        "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                          cfg.ssm_head_dim), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1,
                             cfg.d_inner + 2 * cfg.ssm_state), dtype=dtype,
                            device=device),
    }


def _mamba2_split(xbc: torch.Tensor, cfg: ModelConfig):
    """(x, B, C) columns of the conv'd ``xBC`` block."""
    di, n = cfg.d_inner, cfg.ssm_state
    return xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:di + 2 * n]


def _mamba2_proj(x: torch.Tensor, p: dict, cfg: ModelConfig):
    """(z, xBC, raw dt) columns of the input projection."""
    di, n = cfg.d_inner, cfg.ssm_state
    proj = x @ p["in_proj"].to(x.dtype)
    return (proj[..., :di], proj[..., di:2 * di + 2 * n],
            proj[..., 2 * di + 2 * n:])


def mamba2_train(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """SSD chunked form. x: (B, S, D) -> (B, S, D)."""
    b, s, _ = x.shape
    di, n, hn, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt_raw = _mamba2_proj(x, p, cfg)
    xbc = F.silu(_causal_conv1d(xbc, p["conv_w"], p["conv_b"]))
    xc, bc, cc = _mamba2_split(xbc, cfg)
    xh = xc.reshape(b, s, hn, hp).float()                   # (B,S,H,P)
    bcf, ccf = bc.float(), cc.float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())  # (B,S,H)
    a = -torch.exp(p["A_log"].float())                      # (H,)
    dta = dt * a
    chunk, nc = _chunking(s, cfg.ssm_chunk)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    h = torch.zeros((b, hn, n, hp), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(nc):
        sl = slice(i * chunk, (i + 1) * chunk)
        dta_c, dt_c, x_c, b_c, c_c = (dta[:, sl], dt[:, sl], xh[:, sl],
                                      bcf[:, sl], ccf[:, sl])
        cum = torch.cumsum(dta_c, dim=1)                    # (B,c,H)
        # intra-chunk: L[i,j] = exp(cum_i - cum_j), i >= j
        li = cum[:, :, None, :] - cum[:, None, :, :]        # (B,c,c,H)
        lmat = torch.where(tri[None, :, :, None], torch.exp(li),
                           torch.zeros((), device=x.device))
        scores = torch.einsum("bin,bjn->bij", c_c, b_c)     # (B,c,c)
        w = scores[..., None] * lmat * dt_c[:, None]        # (B,c,c,H)
        y_intra = torch.einsum("bijh,bjhp->bihp", w, x_c)
        # chunk state: decay-to-end weighted sum of B x^T
        decay_end = torch.exp(cum[:, -1:, :] - cum)         # (B,c,H)
        s_chunk = torch.einsum("bch,bcn,bchp->bhnp", decay_end * dt_c, b_c,
                               x_c)                         # (B,H,N,P)
        # inter-chunk contribution from the carried state
        decay_in = torch.exp(cum)                           # (B,c,H)
        y_inter = torch.einsum("bcn,bhnp,bch->bchp", c_c, h, decay_in)
        h = torch.exp(cum[:, -1])[..., None, None] * h + s_chunk
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)                                # (B,S,H,P)
    y = y + p["D"].float()[:, None] * xh
    y = y.reshape(b, s, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"].to(x.dtype)


def mamba2_decode(x: torch.Tensor, p: dict, cfg: ModelConfig,
                  state: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, D); returns (out (B, 1, D), the new state {"h", "conv"}
    as new tensors)."""
    b = x.shape[0]
    di, hn, hp = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt_raw = _mamba2_proj(x, p, cfg)
    xbc, conv_cache = _conv_step(xbc, state["conv"], p["conv_w"],
                                 p["conv_b"])
    xbc = F.silu(xbc)
    xc, bc, cc = _mamba2_split(xbc, cfg)
    xh = xc[:, 0].reshape(b, hn, hp).float()
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"].float())  # (B,H)
    a = -torch.exp(p["A_log"].float())
    da = torch.exp(dt * a)                                  # (B,H)
    h = da[..., None, None] * state["h"] + torch.einsum(
        "bh,bn,bhp->bhnp", dt, bc[:, 0].float(), xh)
    y = torch.einsum("bn,bhnp->bhp", cc[:, 0].float(), h)
    y = y + p["D"].float()[:, None] * xh
    y = y.reshape(b, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"].to(x.dtype), {"h": h, "conv": conv_cache}
