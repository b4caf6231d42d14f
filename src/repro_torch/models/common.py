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
package returns ``PartitionSpec``s.  On a live device mesh
(:class:`repro_torch.launch.mesh.Mesh`) those specs place tensors:
:func:`block_slices` / :func:`shard_block` give the rank's block of a
leaf (JAX's ``NamedSharding.shard_shape`` and layout), and
:func:`gather_block` gathers a block back to the whole leaf with the
gradient of the train step's layout; a :class:`ShardedLayer` holds one
layer's blocks until the layer runs (:func:`whole`).  ``constrain`` and
``shardmap_mesh`` have no counterpart: the functions that split work
(``gqa_train``, ``gqa_decode_splitk``, ``moe_ffn_ep``) cut their operands
and issue their collectives themselves.  :func:`model_split_dim` reads
where the JAX package's constraints put the ``model`` axis on the logits
(:data:`LOGIT_AXES`: the sequence, the sequence-parallel layout, when
``model`` divides it, else the vocab), and
:func:`vocab_parallel_cross_entropy` is the loss of vocab-split logits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.dist import transport as tx
from repro_torch.tree import leaves, map_tree

__all__ = ["ParamSpec", "init_params", "shape_structs", "param_count",
           "DEFAULT_RULES", "logical_to_pspec", "make_shardings",
           "pspec_axes", "split_axes", "block_slices", "shard_block",
           "block_owner",
           "gather_block", "ShardedLayer", "whole",
           "LOGIT_AXES", "model_split_dim", "whole_sequence",
           "rms_norm", "rope_angles", "apply_rope", "token_nll",
           "cross_entropy_loss",
           "vocab_parallel_cross_entropy", "topk_low_index_first"]


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


#: the logical axes the JAX package constrains the logits to
#: (``repro/models/lm.py:172``, ``hybrid.py:77,245``); the residual stream
#: takes ``("batch", "seq_sp", None)`` after the embedding and after each
#: half-block, Mamba layer and shared block (``lm.py:124-151``,
#: ``hybrid.py:60-66,218-225``), so its sequence splits where the logits'
#: does
LOGIT_AXES = ("batch", "seq_sp", "vocab")


def model_split_dim(axes: Sequence[Optional[str]], shape: Sequence[int],
                    mesh) -> Optional[int]:
    """The dim of a tensor of logical ``axes`` and ``shape`` that the
    ``model`` axis of ``mesh`` (a device mesh or a mapping of axis sizes)
    splits under :func:`logical_to_pspec`, or ``None``: no mesh, a
    ``model`` axis of one rank, or no dim that ``model`` divides.  The
    first dim that can take ``model`` wins, so for :data:`LOGIT_AXES` the
    sequence (dim 1) where ``model`` divides it, else the vocab (dim 2)
    where ``model`` divides that; for the residual stream's axes the
    sequence or nothing (the stream then whole on every ``model``
    rank)."""
    if mesh is None:
        return None
    sizes = dict(getattr(mesh, "shape", mesh))
    if sizes.get("model", 1) < 2:
        return None
    spec = logical_to_pspec(axes, sizes, shape=shape)
    for i in range(len(spec)):
        if "model" in pspec_axes(spec, i):
            return i
    return None


def whole_sequence(fn, x: torch.Tensor, mesh) -> torch.Tensor:
    """``fn`` of the whole sequence from this rank's stretch ``x`` (B, S /
    tp, ...) of the sequence-parallel stream: the stretches all-gathered
    over ``model`` (backward: reduce-scatter), ``fn`` run on every rank
    alike, and the rank's stretch of its output kept (the backward puts
    the stretch's cotangent in place and zeros elsewhere, so each rank's
    gradient of ``fn``'s weights is its stretch's part, which
    :func:`whole` sums over ``model``).  For the layers that split no work
    over ``model``: a Mamba layer, MLA, attention heads ``model`` does not
    divide, the dense MoE dispatch."""
    tp, r = mesh.shape["model"], mesh.index("model")
    return fn(tx.all_gather(x, mesh, "model", 1)).chunk(tp, 1)[r]


def make_shardings(specs: Any, mesh: Mapping[str, int],
                   rules: Optional[Dict[str, Any]] = None) -> Any:
    """A tree of partition specs (:func:`logical_to_pspec`) for a
    :class:`ParamSpec` tree."""
    return map_tree(lambda s: logical_to_pspec(s.axes, mesh, rules, s.shape),
                    specs)


def pspec_axes(pspec: Sequence[Any], dim: int) -> Tuple[str, ...]:
    """The mesh axes that split dim ``dim`` under ``pspec`` (a
    :func:`logical_to_pspec` result), outermost first; ``()`` when the dim
    is whole."""
    entry = pspec[dim] if dim < len(pspec) else None
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def split_axes(pspec: Sequence[Any], mesh) -> Tuple[str, ...]:
    """The axes of ``mesh`` with 2 or more ranks that ``pspec`` splits a
    leaf over (on any dim)."""
    return tuple(a for i in range(len(pspec)) for a in pspec_axes(pspec, i)
                 if mesh.shape[a] > 1)


def block_slices(shape: Sequence[int], pspec: Sequence[Any], mesh
                 ) -> Tuple[slice, ...]:
    """This rank's block of a leaf of ``shape`` under ``pspec`` on the
    device mesh ``mesh``: a slice a dim.  A dim split over several axes
    takes the rank's row-major coordinate over them, as JAX lays out a
    ``NamedSharding``; ``pspec`` comes from :func:`logical_to_pspec`, so
    the split divides the dim."""
    out = []
    for i, n in enumerate(shape):
        axes = pspec_axes(pspec, i)
        k = mesh.size(axes)
        if n % k:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"over {axes} ({k} ranks)")
        r, b = mesh.flat_index(axes), n // k
        out.append(slice(r * b, (r + 1) * b))
    return tuple(out)


def shard_block(x: torch.Tensor, pspec: Sequence[Any], mesh
                ) -> torch.Tensor:
    """This rank's block of ``x`` under ``pspec`` (a view)."""
    return x[block_slices(x.shape, pspec, mesh)]


def block_owner(pspec: Sequence[Any], mesh) -> bool:
    """Whether this rank is the first of the ranks that hold its block:
    coordinate 0 on every mesh axis ``pspec`` does not split over."""
    used = split_axes(pspec, mesh)
    return all(mesh.index(a) == 0 for a in mesh.axis_names if a not in used)


def gather_block(x: torch.Tensor, pspec: Sequence[Any], mesh,
                 keep: Sequence[str] = (), sum_model: bool = False
                 ) -> torch.Tensor:
    """The whole leaf from this rank's block ``x``, gathered over every
    axis ``pspec`` splits it on but those in ``keep`` (an axis of one
    rank costs nothing).

    The backward is the train step's: over ``model`` every rank's
    gradient of the whole leaf is already the whole gradient (the tensor
    parallel code pairs ``copy_to`` with ``reduce_from``), so the rank
    keeps its block of it and sums nothing
    (:func:`~repro_torch.dist.transport.gather_from`); over the batch axes
    (``pod``, ``data``) the ranks' losses differ, so their gradients are
    reduce-scattered, summed into the rank's block
    (:func:`~repro_torch.dist.transport.all_gather`).  With ``sum_model``
    (a layer of the sequence-parallel step, where each ``model`` rank's
    gradient is the part of its stretch of the sequence) the gradient is
    summed over ``model`` too: reduce-scattered where the leaf is split
    over it, all-reduced (:func:`~repro_torch.dist.transport.copy_to`)
    where it is not; a leaf kept split over ``model`` sums nothing."""
    for i in range(x.dim()):
        for ax in reversed(pspec_axes(pspec, i)):
            if ax in keep or mesh.shape[ax] == 1:
                continue
            x = (tx.gather_from(x, mesh, ax, i)
                 if ax == "model" and not sum_model
                 else tx.all_gather(x, mesh, ax, i))
    if (sum_model and mesh.shape.get("model", 1) > 1 and "model" not in keep
            and "model" not in split_axes(pspec, mesh)):
        x = tx.copy_to(x, mesh, "model")
    return x


class ShardedLayer:
    """One layer's params as this rank's blocks (``blocks``, a dict tree,
    and ``pspecs``, their partition specs), gathered whole where the layer
    runs: the model's layer functions call :func:`whole` inside their
    ``torch.utils.checkpoint`` region, so the backward gathers again and no
    rank holds more than one layer's whole params.  ``keep`` (a tree like
    ``blocks`` of axis tuples, or ``None``) names the axes a leaf stays
    split over: the experts under expert parallelism arrive as the rank's
    experts, gathered over the batch axes alone."""

    def __init__(self, blocks: Any, pspecs: Any, mesh, keep: Any = None):
        self.blocks, self.pspecs, self.mesh = blocks, pspecs, mesh
        self.keep = keep if keep is not None else map_tree(lambda _: (),
                                                           blocks)

    def gather(self, sum_model: bool = False) -> Any:
        return map_tree(lambda b, ps, k: gather_block(b, ps, self.mesh, k,
                                                      sum_model),
                        self.blocks, self.pspecs, self.keep)


def whole(p: Any, sp_mesh=None) -> Any:
    """``p`` gathered if it is a :class:`ShardedLayer`, else ``p``.  With
    ``sp_mesh`` (the sequence-parallel layout, where each ``model`` rank
    computes with ``p`` on its own stretch of the sequence) the backward
    also sums every leaf's gradient over ``model``: through the gather
    (``gather_block(sum_model=True)``), or for whole params through
    :func:`~repro_torch.dist.transport.copy_to`; so every rank's gradient
    is the whole one, as in the rest of the mesh code."""
    if isinstance(p, ShardedLayer):
        return p.gather(sum_model=sp_mesh is not None)
    if sp_mesh is not None:
        return map_tree(lambda t: tx.copy_to(t, sp_mesh, "model"), p)
    return p


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
    # one elementwise sin and cos a value (torch.polar), not torch.sin /
    # torch.cos: on the CPU those call MKL's vmsSin / vmsCos over parallel
    # chunks, and a process's first such call, raced by two threads, can
    # return one chunk with errors up to 1.5e-4 (the same values each time)
    rot = torch.polar(torch.ones_like(ang), ang)
    return rot.imag, rot.real


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


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's NLL; logits (..., V) fp32-promoted, labels (...) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    return logz - torch.gather(logits, -1, labels.long()[..., None])[..., 0]


def _mean_nll(nll: torch.Tensor, mask: Optional[torch.Tensor]
              ) -> torch.Tensor:
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL; logits (..., V) fp32-promoted, labels (...) int."""
    return _mean_nll(token_nll(logits, labels), mask)


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 mask: Optional[torch.Tensor], mesh
                                 ) -> torch.Tensor:
    """:func:`cross_entropy_loss` of logits split over ``model`` along the
    vocab: ``logits`` (..., V / tp) are this rank's columns, block
    ``mesh.index("model")`` of the vocab (Megatron's vocab-parallel
    cross-entropy).  The row max and the sum of exponentials are reduced
    over ``model``, and the target logit comes from the rank that holds
    its column; every rank returns the same loss, and its gradient
    reaches each rank's columns alone."""
    logits = logits.float()
    v_loc = logits.shape[-1]
    lo = mesh.index("model") * v_loc
    group = mesh.group("model")
    top = mesh.transport.all_reduce(torch.amax(logits.detach(), dim=-1),
                                    group, op="max")
    z = logits - top[..., None]
    sum_exp = tx.reduce_from(torch.exp(z).sum(-1), mesh, "model")
    lab = labels.long() - lo
    own = (lab >= 0) & (lab < v_loc)
    gold = torch.gather(z, -1, lab.clamp(0, v_loc - 1)[..., None])[..., 0]
    gold = tx.reduce_from(gold * own, mesh, "model")
    return _mean_nll(torch.log(sum_exp) - gold, mask)


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
