"""Model substrate: parameter specs and the shared layer math.

The counterpart of ``repro/models/common.py`` for the slices the port
runs: :class:`ParamSpec` declarations, :func:`init_params` from a
``torch.Generator``, ``rms_norm`` / ``rope_angles`` / ``apply_rope`` with
the JAX package's dtype order and its interleaved (even, odd) RoPE pairs,
``cross_entropy_loss`` and ``topk_low_index_first`` (``jax.lax.top_k``'s
order among ties).  The dry run's pieces: :func:`param_count`,
:func:`shape_structs` (meta tensors, no allocation) and the logical-axis
sharding rules (:data:`DEFAULT_RULES`, :func:`logical_to_pspec`,
:func:`make_shardings`), which map a spec onto a mesh given as an ordered
mapping of axis name to size and return plain tuples where the JAX
package returns ``PartitionSpec``s.  ``constrain`` and ``shardmap_mesh``
have no counterpart: on the port's device mesh
(:class:`repro_torch.launch.mesh.Mesh`) each rank holds its own block and
the functions that split work (``gqa_train``, ``gqa_decode_splitk``,
``moe_ffn_ep``) cut it and issue their collectives themselves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.tree import leaves, map_tree

__all__ = ["ParamSpec", "init_params", "shape_structs", "param_count",
           "DEFAULT_RULES", "logical_to_pspec", "make_shardings",
           "rms_norm", "rope_angles", "apply_rope", "cross_entropy_loss",
           "topk_low_index_first"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative parameter: shape, dtype, logical axes, init scale."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"        # "normal" | "zeros" | "ones" | "ssm_dt" | "ssm_a"
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
    if spec.init == "ssm_a":
        # Mamba A init: -[1..state] broadcast, stored as log (taken in
        # float64, so every entry is log(n) correctly rounded, on any
        # device)
        a = torch.arange(1, spec.shape[-1] + 1, dtype=torch.float64,
                         device=device)
        return torch.log(a).float().expand(spec.shape).contiguous().to(dtype)
    if spec.init == "ssm_dt":
        # dt bias ~ log-uniform in [1e-3, 1e-1]
        lo, hi = math.log(1e-3), math.log(1e-1)
        u = torch.rand(spec.shape, generator=generator, dtype=torch.float32,
                       device=device)
        return torch.exp(u * (hi - lo) + lo).to(dtype)
    if spec.init != "normal":
        raise ValueError(f"unknown init {spec.init!r}")
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
    live on ``device``), zeros, ones, the Mamba ``A_log`` table
    (``"ssm_a"``: ``log(1..state)`` on the last axis) or log-uniform ``dt``
    biases in [1e-3, 1e-1] (``"ssm_dt"``).  Every leaf is stored in ``dtype``
    when given (the model's compute dtype: the JAX package keeps fp32
    params and casts them at every use, which gives the same values), else
    in its spec's dtype.  The JAX package draws from ``jax.random``, so the
    two packages' weights differ for one seed; parity tests convert the JAX
    weights with :func:`repro_torch.convert.params_from_numpy`."""
    return map_tree(
        lambda s: _init_leaf(s, generator, device, dtype or s.dtype), specs)


def shape_structs(specs: Any, dtype: Optional[torch.dtype] = None) -> Any:
    """A tree of meta tensors (shapes and dtypes, no storage) for a
    :class:`ParamSpec` tree; every leaf in ``dtype`` when given, else in
    its spec's dtype."""
    return map_tree(lambda s: torch.empty(s.shape, dtype=dtype or s.dtype,
                                          device="meta"), specs)


def param_count(specs: Any) -> int:
    """Total elements of a :class:`ParamSpec` tree."""
    return int(sum(math.prod(s.shape) for s in leaves(specs)))


#: Default logical-axis -> mesh-axis rules, as in the JAX package.
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),       # ZeRO-3 weight shard axis
    "embed": "fsdp",               # indirection: embed dims shard via fsdp
    "vocab": "model",
    "q_heads": "model",
    "kv_heads": "model",
    "heads": "model",
    "mlp": "model",
    "experts": "model",
    "ssm_inner": "model",
    "ssm_heads": "model",
    "seq_sp": "model",             # sequence parallelism for activations
    "kv_seq": "model",             # decode KV-cache sequence shard
    "layers": None,
    "head_dim": None,
    "ssm_state": None,
    "conv": None,
    "latent": None,
    "moe_mlp": None,               # expert-internal dim (EP already shards)
}


def _resolve_axis(rule_val, rules):
    """Follow one level of indirection (e.g. embed -> fsdp -> (pod, data))."""
    if isinstance(rule_val, str) and rule_val in rules:
        return rules[rule_val]
    return rule_val


def _mesh_axis_size(mesh: Mapping[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh[a] for a in axis)
    return mesh[axis]


def logical_to_pspec(axes: Sequence[Optional[str]], mesh: Mapping[str, int],
                     rules: Optional[Dict[str, Any]] = None,
                     shape: Optional[Sequence[int]] = None,
                     exclude: Optional[set] = None) -> Tuple[Any, ...]:
    """Translate logical axis names to a partition spec under ``mesh``
    (axis name -> size): one entry a dim, ``None`` (replicated), a mesh
    axis name, or a tuple of them.

    Rules whose mesh axes are absent from the mesh, or whose mesh size does
    not divide the dim, fall back to replication.  A mesh axis is never
    assigned twice in one spec (first dim wins); ``exclude`` drops mesh
    axes.  Trailing ``None``s are dropped, as ``PartitionSpec`` prints."""
    rules = rules or DEFAULT_RULES
    used: set = set(exclude or ())
    out = []
    for i, name in enumerate(axes):
        assignment = None
        if name is not None and name in rules:
            cand = _resolve_axis(rules[name], rules)
            if cand is not None:
                cand_t = cand if isinstance(cand, tuple) else (cand,)
                # keep only axes present in this mesh (e.g. "pod" is absent
                # on the single-pod mesh) and not already used in this spec
                cand_t = tuple(a for a in cand_t
                               if a in mesh and a not in used)
                if cand_t:
                    size = _mesh_axis_size(mesh, cand_t)
                    if shape is None or shape[i] % size == 0:
                        assignment = cand_t if len(cand_t) > 1 else cand_t[0]
                        used.update(cand_t)
        out.append(assignment)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def make_shardings(specs: Any, mesh: Mapping[str, int],
                   rules: Optional[Dict[str, Any]] = None) -> Any:
    """A tree of partition specs (:func:`logical_to_pspec`) for a
    :class:`ParamSpec` tree."""
    return map_tree(lambda s: logical_to_pspec(s.axes, mesh, rules, s.shape),
                    specs)


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


def topk_low_index_first(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries along the last axis, ranked by
    value and, among equal values, lower index first (``jax.lax.top_k``'s
    order; ``torch.topk`` promises none).  fp32 values map to int32 keys
    of the same order (-0 counted as +0), each made unique by its reversed
    index in the low 32 bits of an int64 key."""
    bits = (x.float() + 0.0).contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    n = x.shape[-1]
    rev = (n - 1) - torch.arange(n, device=x.device, dtype=torch.int64)
    key64 = key.to(torch.int64) * (1 << 32) + rev
    top = torch.topk(key64, k, dim=-1).values
    return (n - 1) - (top & 0xFFFFFFFF)
