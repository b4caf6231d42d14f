"""AdamW, leaf by leaf and in place (counterpart of ``repro/optim/adamw.py``).

The arithmetic is the JAX package's: fp32 ``m`` and ``v``, bias
correction by ``1 - b ** step``, decoupled weight decay, optional clipping
by the global gradient norm.  To fit a full-width model's fp32 params,
grads, ``m`` and ``v`` on one card, :func:`adamw_update` updates params,
``m`` and ``v`` IN PLACE, one leaf at a time, and folds the clip scale into
each leaf's update instead of building a clipped copy of the gradient tree:
the largest temporary is one leaf's.  It returns the same tensors it was
given.  ``torch.optim`` (and its ``_foreach`` kernels, which hold a
full-tree temporary) is not used.

On a device mesh the trees hold each rank's blocks (the train step's
sharded state); :func:`global_norm` then sums each leaf's squares over the
mesh axes that leaf is split on, and the update itself is elementwise on
the blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.models.common import split_axes
from repro_torch.tree import leaves, map_tree, sorted_leaves

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor         # () int32
    m: Any                     # tree like params, fp32
    v: Any


def adamw_init(params: Any) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    device = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=map_tree(zeros, params), v=map_tree(zeros, params))


def global_norm(tree: Any, mesh=None, shardings: Any = None
                ) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares (fp32),
    summed in the JAX package's leaf order (dict keys sorted), so the norm
    does not depend on the order in which a tree's dicts were built.

    With ``shardings`` (a tree of partition specs matching ``tree``, whose
    leaves are this rank's blocks on ``mesh``) each leaf's partial sum is
    first summed over exactly the mesh axes that leaf is split on (one
    all-reduce for all the leaves split on the same axes), never over an
    axis it is replicated on; every rank then adds the same numbers in the
    same order, so the norm is the same on every rank."""
    flat = sorted_leaves(tree)
    parts = [torch.sum(torch.square(g.float())) for g in flat]
    if shardings is not None:
        # a frozenset is a leaf of the tree walk (a tuple would not be)
        split = sorted_leaves(map_tree(
            lambda g, ps: frozenset(split_axes(ps, mesh)), tree, shardings))
        for axes in sorted({tuple(sorted(a)) for a in split if a}):
            idx = [i for i, a in enumerate(split) if tuple(sorted(a)) == axes]
            summed = torch.stack([parts[i] for i in idx])
            for ax in axes:
                summed = mesh.transport.all_reduce(summed, mesh.group(ax))
            for i, v in zip(idx, summed):
                parts[i] = v
    return torch.sqrt(torch.sum(torch.stack(parts)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / (norm + 1e-9), 1.0)


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """A clipped fp32 copy of ``grads`` and their global norm (the train
    step does not build this copy: :func:`adamw_update` scales per leaf)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return map_tree(lambda g: g.float() * scale, grads), norm


def adamw_update(cfg: AdamWConfig, params: Any, grads: Any,
                 state: AdamWState,
                 lr: Optional[Union[float, torch.Tensor]] = None,
                 mesh=None, shardings: Any = None
                 ) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step, in place.  ``lr`` overrides cfg.lr (for schedules).

    Updates every leaf of ``params``, ``state.m`` and ``state.v`` in place
    and returns ``(params, AdamWState(step + 1, m, v), metrics)`` with the
    same trees; metrics are ``grad_norm`` (before clipping) and ``lr``.
    ``mesh`` and ``shardings``: the trees hold this rank's blocks under
    those partition specs (:func:`global_norm`)."""
    gnorm = global_norm(grads, mesh, shardings)
    scale = _clip_scale(gnorm, cfg.grad_clip) if cfg.grad_clip else None
    step = state.step + 1
    lr_t = cfg.lr if lr is None else lr
    stepf = step.float()
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    flat = zip(leaves(params), leaves(grads), leaves(state.m),
               leaves(state.v))
    with torch.no_grad():
        for p, g, m, v in flat:
            g = g.float() if scale is None else g.float() * scale
            m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
            v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            p32 = p.float()
            p.copy_(p32 - lr_t * (delta + cfg.weight_decay * p32))
    metrics = {"grad_norm": gnorm,
               "lr": torch.as_tensor(lr_t, dtype=torch.float32,
                                     device=gnorm.device)}
    return params, AdamWState(step=step, m=state.m, v=state.v), metrics
