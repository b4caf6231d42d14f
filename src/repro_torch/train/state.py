"""Train state: params + AdamW moments, and the train step.

The counterpart of ``repro/train/state.py``.  The state is a dict
``{"params", "m", "v", "step"}``: fp32 master params in the JAX tree's
layout (``blocks`` stacked on a leading layers axis), fp32 AdamW moments
of the same layout, and an int32 step.

:func:`build_train_step` returns ``step(state, batch) -> (state,
metrics)``.  It hands the loss each layer's params as views
(:func:`split_layers`), so every layer gets its own gradient tensor and no
full-size stacked gradient is built per layer, then updates params, ``m``
and ``v`` in place (:func:`repro_torch.optim.adamw.adamw_update`).  The
gradients are dropped when the step returns.  Modes: standard, and
``grad_accum > 1`` (serial fp32 accumulation over a leading microbatch
axis of the batch).

On a device mesh (:class:`repro_torch.launch.mesh.Mesh`) the state is
sharded as the JAX launcher places it: :func:`train_state_shardings`
gives each leaf's partition spec (ZeRO-3: ``embed`` dims over ``pod`` x
``data``; ``vocab``, heads, ``mlp``, experts and ``ssm_inner`` over
``model``) and every rank holds only its block of each leaf of
``params``, ``m``, ``v`` (and ``err``) (:func:`shard_train_state`, or
:func:`init_train_state` given the mesh).  The step takes the rank's rows
of the batch (split over ``pod`` and ``data``) and gathers one layer's
params at a time inside the layer's checkpoint region, so the backward
gathers them again and no rank holds more than one layer whole.  The
gathers' backward hands each rank the gradient of its blocks: summed over
the batch ranks the leaf is split across; the step all-reduces it over
those it is replicated on, then means.  AdamW updates the blocks, the
grad norm summing each leaf over the axes it is split on.  The model
splits its attention heads and experts over ``model`` and embeds
vocab-parallel (:func:`repro_torch.models.lm.forward`); where ``model``
divides the sequence the residual stream is sequence-parallel and the
logits and loss are each rank's stretch's, else the logits are split
over the vocab, ``lm_head`` staying the rank's columns
(:func:`repro_torch.models.lm.logits_split`).  Under expert parallelism
the experts stay the rank's own, gathered over the batch axes alone.
:func:`mesh_params` lays the rank's blocks out for the decode and
prefill entry points.

The pod-compressed step (on ``train_state_shardings(pod_compressed=
True)``: params replicated over ``pod`` and split over ``data``, ``err``
the rank's pod's block of 1) means the gradients over ``data`` only, then
across pods through :func:`repro_torch.optim.compression.
compressed_psum_mean` (int8 payloads, an exact int32 radix-4 tree sum,
error feedback in ``err``): a stacked layer leaf is one payload with one
scale over its layers and its blocks, as the JAX step compresses it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.collectives import make_tree_mesh, tree_pmean
from repro_torch.models.common import (DEFAULT_RULES, ParamSpec,
                                       ShardedLayer, _init_leaf,
                                       gather_block, init_params,
                                       make_shardings, shard_block,
                                       split_axes)
from repro_torch.models.lm import logits_split
from repro_torch.models.registry import get_api
from repro_torch.optim import compression
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_update
from repro_torch.optim.grad_accum import (accumulated_value_and_grad,
                                          value_and_grad)
from repro_torch.tree import index_tree, leaves, map_tree

__all__ = ["train_state_specs", "train_state_shardings", "init_train_state",
           "shard_train_state", "gather_train_state", "build_train_step",
           "split_layers", "mesh_params", "LAYER_KEYS"]

#: the stacked entries a param tree splits per layer (or per group): the
#: decoders' and SSM LMs' ``blocks``, the hybrid's Mamba groups and tail
LAYER_KEYS = ("blocks", "mamba_groups", "mamba_tail")


def train_state_specs(cfg: ModelConfig, pod_compressed: bool = False,
                      n_pods: int = 1) -> Dict[str, Any]:
    """ParamSpec trees for the full train state; with ``pod_compressed``
    also ``err``, each param's fp32 error-feedback residual with a leading
    ``(n_pods,)`` axis (split over ``pod``)."""
    pspecs = get_api(cfg).param_specs(cfg)
    opt = lambda s: ParamSpec(s.shape, s.axes, dtype=torch.float32,
                              init="zeros")
    out = {
        "params": pspecs,
        "m": map_tree(opt, pspecs),
        "v": map_tree(opt, pspecs),
        "step": ParamSpec((), (), dtype=torch.int32, init="zeros"),
    }
    if pod_compressed:
        out["err"] = map_tree(
            lambda s: ParamSpec((n_pods,) + tuple(s.shape),
                                ("err_pod",) + tuple(s.axes),
                                dtype=torch.float32, init="zeros"), pspecs)
    return out


def train_state_shardings(cfg: ModelConfig, mesh,
                          pod_compressed: bool = False,
                          n_pods: int = 1) -> Dict[str, Any]:
    """A partition spec a leaf of the train state (``repro/train/state.py:
    train_state_shardings``): :data:`~repro_torch.models.common.
    DEFAULT_RULES`, ``err_pod`` over ``pod``, and with
    ``pod_compressed`` the params replicated over ``pod`` (``fsdp`` over
    ``data`` alone, ``batch`` over ``pod`` x ``data``).  ``mesh`` is a
    device mesh or a mapping of axis name to size.  The specs are tuples
    (:func:`~repro_torch.models.common.logical_to_pspec`), so walk them
    with a state tree first: ``map_tree(fn, state, shardings)``."""
    specs = train_state_specs(cfg, pod_compressed, n_pods)
    base = dict(DEFAULT_RULES, err_pod="pod")
    if pod_compressed:
        base["fsdp"] = ("data",)
        base["batch"] = ("pod", "data")
    return make_shardings(specs, getattr(mesh, "shape", mesh), base)


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     pod_compressed: bool = False, n_pods: int = 1,
                     mesh=None) -> Dict[str, Any]:
    """Random fp32 params (fan-in scaled normals from ``generator``), zero
    moments and step, on the generator's device; with ``pod_compressed``
    zero ``err`` leaves of ``n_pods`` blocks.  The base state is drawn
    first, so the params do not depend on ``pod_compressed``.  The JAX
    package draws from ``jax.random``, so the two packages' states differ
    for one seed; parity tests convert the JAX state with
    :func:`repro_torch.convert.train_state_from_numpy`.

    Given a device ``mesh``: this rank's blocks under
    :func:`train_state_shardings` (``n_pods`` is then the mesh's ``pod``
    size), each leaf drawn whole in the one-device order and cut at once,
    so a rank holds one whole leaf at a time and its blocks are those of
    the one-device state of the seed."""
    if mesh is None:
        out = init_params(train_state_specs(cfg), generator,
                          generator.device)
        if pod_compressed:
            full = train_state_specs(cfg, True, n_pods)
            out["err"] = init_params(full["err"], generator,
                                     generator.device)
        return out
    n_pods = mesh.shape.get("pod", 1)
    specs = train_state_specs(cfg, pod_compressed, n_pods)
    shardings = train_state_shardings(cfg, mesh, pod_compressed, n_pods)
    dev = generator.device
    return {k: map_tree(lambda s, ps: shard_block(
        _init_leaf(s, generator, dev, s.dtype), ps, mesh).clone(),
        specs[k], shardings[k]) for k in specs}


def shard_train_state(state: Dict[str, Any], shardings: Dict[str, Any],
                      mesh) -> Dict[str, Any]:
    """This rank's blocks of a whole ``state`` (as
    :func:`repro_torch.convert.train_state_from_numpy` or
    :func:`init_train_state` build it), each a tensor of its own; a whole
    ``err`` tree of ``n_pods`` blocks gives the rank its pod's one."""
    return map_tree(lambda t, ps: shard_block(t, ps, mesh).clone(), state,
                    shardings)


def gather_train_state(state: Dict[str, Any], shardings: Dict[str, Any],
                       mesh) -> Dict[str, Any]:
    """The whole state from every rank's blocks, on every rank.  It holds
    every leaf whole at once: for tests and checks, not a full-size
    state."""
    with torch.no_grad():
        return map_tree(lambda t, ps: gather_block(t, ps, mesh), state,
                        shardings)


def split_layers(tree: Dict[str, Any]) -> Dict[str, Any]:
    """``tree`` with each stacked entry of :data:`LAYER_KEYS` replaced by a
    list of per-layer (per-group for ``mamba_groups``) dicts of views, the
    other entries as they are."""
    out = dict(tree)
    for k in LAYER_KEYS:
        if k in tree:
            n = leaves(tree[k])[0].shape[0]
            out[k] = [index_tree(tree[k], i) for i in range(n)]
    return out


def _split_pspecs(pspecs: Dict[str, Any], split: Dict[str, Any]
                  ) -> Dict[str, Any]:
    """The partition specs of :func:`split_layers`' ``split`` tree: a
    layer's spec is its stacked leaf's without the (whole) layers dim."""
    out = dict(pspecs)
    for k in LAYER_KEYS:
        if k in pspecs:
            layer = map_tree(lambda _, ps: tuple(ps[1:]), split[k][0],
                             pspecs[k])
            out[k] = [layer] * len(split[k])
    return out


#: the MoE leaves the expert-parallel FFN splits over ``model``
#: (``repro/models/moe.py:moe_ffn_ep``'s in_specs)
EP_LEAVES = ("router", "w1", "w3", "w2")


def _ep_keep(layer: Dict[str, Any], cfg: ModelConfig, mesh, split) -> Any:
    """A layer's ``keep`` tree (:class:`~repro_torch.models.common.
    ShardedLayer`): under expert parallelism (the sequence-parallel layout,
    ``use_ep``, ``model`` dividing the experts) the experts and their
    router columns stay split over ``model``, else nothing stays split."""
    tp = mesh.shape.get("model", 1)
    ep = (split == 1 and cfg.use_ep and cfg.n_experts
          and cfg.n_experts % tp == 0 and isinstance(layer.get("ffn"), dict))
    keep = {k: (map_tree(lambda _: (), v) if isinstance(v, (dict, list))
                else ()) for k, v in layer.items()}
    if ep:
        keep["ffn"] = {k: (("model",) if k in EP_LEAVES else ())
                       for k in layer["ffn"]}
    return keep


def _loss_params(params: Dict[str, Any], pspecs: Dict[str, Any], mesh,
                 cfg: ModelConfig, split=None) -> Dict[str, Any]:
    """What the loss reads on a mesh, from the rank's blocks: each layer a
    :class:`~repro_torch.models.common.ShardedLayer` (gathered where it
    runs; under expert parallelism its experts kept the rank's),
    ``embed`` gathered over the batch axes alone (its vocab rows stay
    split over ``model`` for the vocab-parallel embedding), ``lm_head``
    likewise where the logits are split over the vocab (``split`` 2,
    :func:`repro_torch.models.lm.logits_split`), every other leaf gathered
    whole now."""
    out = {}
    for k, v in params.items():
        if k in LAYER_KEYS:
            out[k] = [ShardedLayer(b, ps, mesh,
                                   _ep_keep(b, cfg, mesh, split)
                                   if k == "blocks" else None)
                      for b, ps in zip(v, pspecs[k])]
        elif ((k == "embed" and cfg.use_tp_shardmap)
              or (k == "lm_head" and split == 2)):
            out[k] = gather_block(v, pspecs[k], mesh, keep=("model",))
        else:
            out[k] = map_tree(lambda b, ps: gather_block(b, ps, mesh), v,
                              pspecs[k])
    return out


def mesh_params(params: Dict[str, Any], cfg: ModelConfig, mesh
                ) -> Dict[str, Any]:
    """The params the decode and prefill entry points read on ``mesh``
    (``decode_step``, ``prefill_chunk``, ``ssm_decode_step``, ...) from
    this rank's blocks of them, laid out as the train step holds them
    (``state["params"]`` under :func:`train_state_shardings`): each layer
    (a hybrid's Mamba group) a
    :class:`~repro_torch.models.common.ShardedLayer` gathered where it
    runs, ``embed`` the rank's vocab rows for the vocab-parallel
    embedding, the rest (``lm_head``, the norms, the shared block)
    gathered whole now, once for every step that reuses the result."""
    shardings = train_state_shardings(cfg, mesh)["params"]
    split = split_layers(params)
    return _loss_params(split, _split_pspecs(shardings, split), mesh, cfg)


def _rank_rows(batch: Dict[str, Any], mesh, axes, row_dim: int
               ) -> Dict[str, Any]:
    """This rank's block of every batch leaf along ``row_dim``, split
    row-major over ``axes``."""
    n, r = mesh.size(axes), mesh.flat_index(axes)
    return {k: v.chunk(n, row_dim)[r] for k, v in batch.items()}


def build_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     lr_schedule: Optional[Callable] = None,
                     grad_accum: int = 1, pod_compressed: bool = False,
                     mesh=None) -> Callable:
    """Return ``step(state, batch) -> (state, metrics)``.

    ``batch`` maps names to numpy arrays or tensors (with a leading
    microbatch axis when ``grad_accum > 1``); they are moved to the state's
    device.  The returned state is the same dict, its tensors updated in
    place and its ``step`` advanced; metrics are 0-d device tensors
    ``loss``, ``grad_norm`` and ``lr``.

    On a ``mesh`` the state is this rank's blocks under
    ``train_state_shardings(cfg, mesh, pod_compressed, n_pods)``
    (:func:`shard_train_state`); every rank calls the step with the whole
    batch and takes its rows; ``loss`` is the mean over the ranks; the
    layers run under remat whatever ``cfg.remat`` says, so that each
    gathers its params inside its checkpoint region.  ``pod_compressed``
    needs a mesh with a ``pod`` axis (raises ``ValueError`` otherwise) and
    a state with ``err`` leaves; there the MoE FFN takes the dense
    dispatch, as the JAX step turns ``use_ep`` off."""
    if pod_compressed and (mesh is None or "pod" not in mesh.shape):
        raise ValueError("pod_compressed needs a mesh with a 'pod' axis "
                         "(a multi-pod device mesh)")
    if pod_compressed:
        cfg = dataclasses.replace(cfg, use_ep=False)
    shardings = None
    if mesh is not None:
        shardings = train_state_shardings(cfg, mesh, pod_compressed,
                                          mesh.shape.get("pod", 1))
        cfg = dataclasses.replace(cfg, remat=True)
    api = get_api(cfg)
    layout = {}     # the split params' specs, set at the first step

    def loss_fn(params, batch):
        if shardings is not None:
            params = _loss_params(params, layout["params"], mesh, cfg,
                                  logits_split(batch, cfg, mesh))
        return api.train_loss(params, batch, cfg, mesh)

    vg = (accumulated_value_and_grad(loss_fn, grad_accum) if grad_accum > 1
          else value_and_grad(loss_fn))
    batch_axes = () if mesh is None else tuple(
        a for a in ("pod", "data") if a in mesh.shape)
    if pod_compressed:
        tree, sub_axes = make_tree_mesh(mesh, "pod")
        n_pods = mesh.shape["pod"]
    mean_axes = tuple(a for a in batch_axes
                      if not (pod_compressed and a == "pod"))

    def batch_mean(g, ps):
        # the gathers' backward summed g over the batch axes the leaf is
        # split on; sum it over the others, then mean
        split = split_axes(ps, mesh)
        for a in mean_axes:
            if a not in split and mesh.shape[a] > 1:
                g = mesh.transport.all_reduce(g, mesh.group(a))
        return g.div_(mesh.size(mean_axes))

    def step(state: Dict[str, Any], batch: Dict[str, Any]):
        device = state["step"].device
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        if batch_axes:
            batch = _rank_rows(batch, mesh, batch_axes,
                               1 if grad_accum > 1 else 0)
        params = split_layers(state["params"])
        if shardings is not None and not layout:
            layout["params"] = _split_pspecs(shardings["params"], params)
        loss, grads = vg(params, batch)
        if mean_axes:
            grads = map_tree(batch_mean, grads, layout["params"])
            loss = tree_pmean(loss, mean_axes, mesh=mesh)
        if pod_compressed:
            # leaf by leaf, into the gradient and the residual in place:
            # whole new trees of means and residuals would hold two more
            # copies of the params' bytes at once
            def reduce(g, e, ps):
                mean, new_e = compression.compressed_psum_mean(
                    g, e, sub_axes, n_pods, mesh=tree,
                    shard_axes=split_axes(ps, mesh))
                e.copy_(new_e)
                return mean

            def reduce_layers(e, ps, *layers):
                # the stacked leaf is one payload: one scale over its layers
                for g, mean in zip(layers, reduce(torch.stack(layers), e,
                                                  ps)):
                    g.copy_(mean)

            err = map_tree(lambda e: e[0], state["err"])
            for k, g in grads.items():
                if k in LAYER_KEYS:
                    # a layer's spec is its stacked leaf's without the
                    # (whole) layers dim, which the stack puts back
                    map_tree(lambda e, ps, *ls: reduce_layers(
                        e, (None,) + tuple(ps), *ls), err[k],
                        layout["params"][k][0], *g)
                else:
                    map_tree(lambda gl, e, ps: gl.copy_(reduce(gl, e, ps)),
                             g, err[k], layout["params"][k])
            loss = tree_pmean(loss, sub_axes, mesh=tree)
        lr = lr_schedule(state["step"]) if lr_schedule else None
        opt = AdamWState(step=state["step"], m=split_layers(state["m"]),
                         v=split_layers(state["v"]))
        _, opt, metrics = adamw_update(
            opt_cfg, params, grads, opt, lr, mesh=mesh,
            shardings=layout.get("params"))
        metrics["loss"] = loss
        return {**state, "step": opt.step}, metrics

    return step
