"""Model substrate: parameter specs and the shared layer math.

The counterpart of ``repro/models/common.py`` for the slices the port
runs: :class:`ParamSpec` declarations, :func:`init_params` from a
``torch.Generator``, ``rms_norm`` / ``rope_angles`` / ``apply_rope`` with
the JAX package's dtype order and its interleaved (even, odd) RoPE pairs,
and ``cross_entropy_loss``.  Sharding rules have no counterpart yet (one
card).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.tree import map_tree

__all__ = ["ParamSpec", "init_params", "rms_norm", "rope_angles",
           "apply_rope", "cross_entropy_loss"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative parameter: shape, dtype, logical axes, init scale."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"        # "normal" | "zeros" | "ones"
    scale: Optional[float] = None  # override fan-in scale

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


def _init_leaf(spec: ParamSpec, generator: torch.Generator,
               device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init != "normal":
        raise NotImplementedError(
            f"init {spec.init!r} belongs to the SSM families, which arrive "
            f"with ROADMAP.md queue 1 item 10")
    scale = spec.scale
    if scale is None:
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = 1.0 / math.sqrt(max(1, fan_in))
    w = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return w.mul_(scale).to(dtype)


def init_params(specs: Any, generator: torch.Generator,
                device: torch.device, dtype: Optional[torch.dtype] = None
                ) -> Any:
    """Initialize a nested dict of tensors from a :class:`ParamSpec` tree:
    fan-in scaled normals (drawn in fp32 from ``generator``, which must
    live on ``device``), zeros or ones.  Every leaf is stored in ``dtype``
    when given (the model's compute dtype: the JAX package keeps fp32
    params and casts them at every use, which gives the same values), else
    in its spec's dtype.  The JAX package draws from ``jax.random``, so the
    two packages' weights differ for one seed; parity tests convert the JAX
    weights with :func:`repro_torch.convert.params_from_numpy`."""
    return map_tree(
        lambda s: _init_leaf(s, generator, device, dtype or s.dtype), specs)


# ---------------------------------------------------------------------------
# Shared layer math
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """RMS norm computed in fp32, cast back, then scaled in ``x.dtype``."""
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * weight.to(dt)


def rope_angles(positions: torch.Tensor, dim: int, theta: float = 10000.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) tables for rotary embedding; positions (...,) int."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    # a Python scalar base: no host-to-device copy (which would wait for
    # the stream) on every layer of every dispatch
    inv = 1.0 / torch.pow(theta, exps)
    ang = positions.float()[..., None] * inv                 # (..., dim/2)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """Rotate pairs (even, odd) of the last axis. x: (..., S, H, D);
    sin/cos: (S, D/2) or broadcastable.  Interleaved pairs, as the JAX
    package rotates them (not the half-split layout)."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    while sin.dim() < x1.dim() - 1:
        sin = sin[..., None, :]
        cos = cos[..., None, :]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL; logits (..., V) fp32-promoted, labels (...) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
