"""Dry run: trace each (arch x shape) cell on meta tensors and report its
roofline against an H100.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh card --isolate
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --isolate
    PYTHONPATH=src python -m repro_torch.roofline.report results/dryrun_torch

The counterpart of ``repro/launch/dryrun.py``.  Each cell's step (the
train step with AdamW, the prefill forward or one decode step against a
``seq_len``-deep cache) runs once on meta tensors, which hold shapes and
no data: nothing is allocated and nothing runs on any device, so a
full-width cell traces on a laptop's CPU.  :func:`count_cost` counts its
FLOPs and bytes; per-device counts are the global ones over the mesh's
chips.  The meshes are ``card`` (one H100, every leaf whole), ``single``
(16x16) and ``multi`` (2x16x16).

On a production mesh the collective term and the resident bytes come
from one rank's program (:func:`count_collectives`; the resident bytes
are what the rank holds of the step's arguments but the batch,
:func:`held_bytes`), traced on meta tensors by the port's own
mesh code on a :class:`~repro_torch.launch.mesh.MeshView`, whose
:class:`~repro_torch.dist.transport.MetaTransport` counts each collective
the step hands its ``Transport`` and moves nothing: the same counts, to
the byte, that the live step's ``Transport`` makes on that rank.  A train
cell's state is the rank's blocks under ``train_state_shardings``, a
serve cell's params come through ``mesh_params`` (once, outside the
counted step, as a server holds them across steps) and a decode state is
the rank's block (its rows over ``pod`` x ``data``, its stretch of the
cache over ``model``; a Mamba layer's state whole, as the port runs the
layer whole on every ``model`` rank).  The batch is the rank's rows, or
whole on every data rank where the data axes do not divide it.  The port
lays its mesh out by hand (ZeRO-3 gathers of a layer at a time,
reduce-scattered gradients, sequence parallelism), not as XLA's
partitioner does, so the kinds and sizes differ from the JAX record's.

The record keeps the JAX record's keys where the port has a
counterpart.  Where it differs:

- ``trace_s``, the meta traces' seconds, replaces ``lower_s``,
  ``compile_s`` and ``cost_pass_s``;
- ``memory_analysis`` has every size ``None`` (no compiler plans a
  buffer), ``temp_size`` included;
- there is no ``cost_pass_unrolled``: an eager trace counts every layer
  and every chunk, so ``unrolled_scans`` has no counterpart;
- ``collectives`` is ``{kind: {"bytes", "wire_bytes", "count"}}`` under
  the JAX kind names (``all-gather``, ``reduce-scatter``, ``all-reduce``,
  ``all-to-all``), ``bytes`` the counted payload (an all-gather's shard,
  a reduce-scatter's whole input, an all-reduce's and an all-to-all's
  input) and ``wire_bytes`` the JAX ring model with ``g`` the axis's
  ranks; ``collective_bytes_per_device`` is the sum of ``bytes`` (``{}``
  and 0 on the card); ``collectives_by_axis`` (port only) splits them by
  mesh axis; a cell whose mesh path raises keeps ``None`` for all three
  (the CLI prints why), and its dominant term is then taken over compute
  and memory;
- ``resident_bytes_per_device`` on a mesh is the port's layout, not the
  JAX rules': a serve cell holds ``lm_head``, the norms and a shared
  block whole (``mesh_params``) and a Mamba layer's decode state whole
  over ``model``; it and ``fits_hbm`` are ``None`` where the rank's
  cell cannot be built;
- ``param_dtype`` names the dtype a serve cell's params are held in when
  the caller sets one (the JAX cells keep the specs' fp32), and
  ``cost_analysis`` adds ``aten_ops``, the ops the trace dispatched.

FLOPs count matmul-class ops only (``FlopCounterMode``); bytes are per
aten op, not per fused kernel.  The SSM and hybrid prefill and train cells
dispatch one op at a time through the chunked scan, so they take minutes.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                     cells_for)
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.launch.inputs import (batch_logical_axes,
                                       decode_state_structs, input_specs)
from repro_torch.launch.mesh import (MeshView, card_mesh,
                                     make_production_mesh, mesh_summary)
from repro_torch.models.common import (DEFAULT_RULES, ShardedLayer,
                                      logical_to_pspec, make_shardings,
                                      param_count, shape_structs,
                                      shard_block)
from repro_torch.models.registry import get_api
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.roofline.analysis import (H100, HW, count_cost, fmt_seconds,
                                           model_flops, roofline_report)
from repro_torch.train.state import (build_train_step, mesh_params,
                                     train_state_shardings,
                                     train_state_specs)
from repro_torch.tree import leaves, map_tree

__all__ = ["MESHES", "KINDS", "build_cell", "count_collectives",
           "held_bytes", "collective_record", "run_cell", "main"]

#: the dry run's meshes by name (axis name -> size)
MESHES = {"card": card_mesh(),
          "single": make_production_mesh(multi_pod=False),
          "multi": make_production_mesh(multi_pod=True)}


def _active_params(cfg: ModelConfig, n_params: int) -> int:
    """Activated parameter count (MoE: top_k of n_experts expert params)."""
    if not cfg.n_experts:
        return n_params
    expert, rest = 0, 0
    for s in leaves(get_api(cfg).param_specs(cfg)):
        n = math.prod(s.shape)
        if "experts" in s.axes:
            expert += n
        else:
            rest += n
    return rest + expert * cfg.top_k // cfg.n_experts


#: a decode state's rules on a mesh: a Mamba layer's ``h`` and ``conv``
#: stay whole on every ``model`` rank, which runs the layer whole (the JAX
#: package splits the inner axis by sharding constraints alone)
_STATE_RULES = dict(DEFAULT_RULES, ssm_inner=None, ssm_heads=None)

#: the :class:`~repro_torch.dist.transport.Transport` ops under the JAX
#: record's kind names
KINDS = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
         "all_reduce": "all-reduce", "all_to_all": "all-to-all"}


def _blocks(tree: Any, shardings: Any, mesh) -> Any:
    return map_tree(lambda t, ps: shard_block(t, ps, mesh), tree, shardings)


def build_cell(cfg: ModelConfig, shape: ShapeConfig,
               param_dtype: Optional[torch.dtype] = None, mesh=None):
    """(step, meta argument tuple) for one (arch x shape) cell.  Serve
    cells run without autograd; ``param_dtype`` holds their params in
    that dtype (None: the specs' fp32).

    Given a ``mesh`` (a :class:`~repro_torch.launch.mesh.MeshView` or a
    :class:`~repro_torch.launch.mesh.Mesh`), one rank's program: the train
    step on the rank's blocks of the state under
    ``train_state_shardings`` (the step takes the rank's rows of the whole
    batch); the serve params through ``mesh_params``, whose gathers the
    mesh's transport counts before the step runs; the rank's rows of a
    serve batch (whole on every data rank where the data axes do not
    divide it) and its block of a decode state."""
    api = get_api(cfg)
    batch = input_specs(cfg, shape)
    if shape.kind == "train":
        state = shape_structs(train_state_specs(cfg))
        if mesh is not None:
            state = _blocks(state, train_state_shardings(cfg, mesh), mesh)
        step = build_train_step(cfg, AdamWConfig(lr=1e-4, grad_clip=1.0),
                                mesh=mesh)
        return step, (state, batch)
    params = shape_structs(api.param_specs(cfg), param_dtype)
    if mesh is not None:
        params = mesh_params(_blocks(params, train_state_shardings(
            cfg, mesh)["params"], mesh), cfg, mesh)
        axes = batch_logical_axes(cfg, shape)
        batch = {k: shard_block(t, logical_to_pspec(
            axes[k], mesh.shape, shape=t.shape), mesh)
            for k, t in batch.items()}
    if shape.kind == "prefill":
        def prefill(params, batch):
            with torch.no_grad():
                out = api.forward(params, batch, cfg, mesh)
            return out[0] if isinstance(out, tuple) else out
        return prefill, (params, batch)

    # decode: one new token against a seq_len-deep cache
    def serve_step(params, state, batch):
        with torch.no_grad():
            return api.decode_step(params, state, batch, cfg, mesh)
    state, sspecs = decode_state_structs(cfg, shape)
    if mesh is not None:
        state = _blocks(state, make_shardings(sspecs, mesh.shape,
                                              _STATE_RULES), mesh)
    return serve_step, (params, state, batch)


def _rank_cell(cfg: ModelConfig, shape: ShapeConfig,
               mesh: Mapping[str, int], coord: Optional[Sequence[int]],
               param_dtype: Optional[torch.dtype]):
    """(view, step, meta argument tuple) of the rank at ``coord`` of a
    mesh of ``mesh``: :func:`build_cell` on a
    :class:`~repro_torch.launch.mesh.MeshView`."""
    view = MeshView(mesh, coord)
    return (view,) + build_cell(cfg, shape, param_dtype, view)


def _run_counted(view, fn, args):
    view.transport.reset()
    fn(*args)
    return view.transport


def count_collectives(cfg: ModelConfig, shape: ShapeConfig,
                      mesh: Mapping[str, int],
                      coord: Optional[Sequence[int]] = None,
                      param_dtype: Optional[torch.dtype] = None):
    """The :class:`~repro_torch.dist.transport.MetaTransport` of one step
    of the rank at ``coord`` (default the first) of a mesh of ``mesh``
    (axis name -> size), traced on meta tensors: its ``bytes`` /
    ``calls`` by op and ``axis_bytes`` / ``axis_calls`` by op and axis.
    Raises where the port's mesh path does (``ValueError``)."""
    return _run_counted(*_rank_cell(cfg, shape, mesh, coord, param_dtype))


def held_bytes(tree: Any) -> int:
    """Bytes of the distinct tensors of ``tree``, a
    :class:`~repro_torch.models.common.ShardedLayer` counted by its
    blocks: what a rank holds of a step's arguments."""
    seen = {}
    for t in leaves(tree):
        for x in leaves(t.blocks) if isinstance(t, ShardedLayer) else [t]:
            if isinstance(x, torch.Tensor):
                seen[id(x)] = x.numel() * x.element_size()
    return sum(seen.values())


def _wire_bytes(op: str, nbytes: float, g: int) -> float:
    """On-wire bytes of an op's ``nbytes`` payload over ``g`` ranks, the
    JAX package's ring model (``repro/roofline/analysis.py``)."""
    if op == "all_gather":
        return nbytes * (g - 1)                 # result * (g - 1) / g
    if op == "all_reduce":
        return 2.0 * nbytes * (g - 1) / g
    return nbytes * (g - 1) / g


def collective_record(transport, mesh: Mapping[str, int]
                      ) -> Tuple[Dict[str, Dict[str, float]],
                                 Dict[str, Dict[str, Dict[str, float]]]]:
    """``(collectives, collectives_by_axis)`` of a transport's counts:
    ``{kind: {"bytes", "wire_bytes", "count"}}`` and the same a mesh
    axis."""
    coll: Dict[str, Dict[str, float]] = {}
    by_axis: Dict[str, Dict[str, Dict[str, float]]] = {}
    for (op, axis), n in sorted(transport.axis_bytes.items()):
        kind, calls = KINDS[op], transport.axis_calls[op, axis]
        for rec in (coll.setdefault(kind, {}),
                    by_axis.setdefault(axis, {}).setdefault(kind, {})):
            rec["bytes"] = rec.get("bytes", 0) + n
            rec["wire_bytes"] = (rec.get("wire_bytes", 0.0)
                                 + _wire_bytes(op, n, mesh[axis]))
            rec["count"] = rec.get("count", 0) + calls
    return coll, by_axis


def _sharded_bytes(structs: Any, shardings: Any, mesh: Dict[str, int]
                   ) -> float:
    """Per-device resident bytes of a meta-tensor tree under a tree of
    partition specs of the same layout."""
    total = 0.0

    def add(t, spec):
        nonlocal total
        div = 1
        for entry in spec:
            if entry is None:
                continue
            for a in entry if isinstance(entry, tuple) else (entry,):
                div *= mesh[a]
        total += t.numel() * t.element_size() / div

    map_tree(add, structs, shardings)
    return total


def _resident_bytes(cfg: ModelConfig, shape: ShapeConfig,
                    mesh: Dict[str, int],
                    param_dtype: Optional[torch.dtype]) -> float:
    """Params (train: params, AdamW moments and step) and, for decode, the
    cache, each under its sharding by the JAX package's rules: the
    record's figure on one card, where every leaf is whole."""
    if shape.kind == "train":
        specs = train_state_specs(cfg)
        return _sharded_bytes(shape_structs(specs),
                              make_shardings(specs, mesh), mesh)
    pspecs = get_api(cfg).param_specs(cfg)
    res = _sharded_bytes(shape_structs(pspecs, param_dtype),
                         make_shardings(pspecs, mesh), mesh)
    if shape.kind == "decode":
        state, sspecs = decode_state_structs(cfg, shape)
        res += _sharded_bytes(state, make_shardings(sspecs, mesh), mesh)
    return res


def run_cell(arch_id: str, shape: Union[str, ShapeConfig], *,
             mesh: Union[str, Mapping[str, int]] = "card", hw: HW = H100,
             verbose: bool = True, cfg: Optional[ModelConfig] = None,
             param_dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Trace one cell on meta tensors and return its record.  ``shape`` is
    a name in :data:`SHAPES` or a :class:`ShapeConfig`; ``mesh`` a name in
    :data:`MESHES` or a mapping of axis name to size; ``cfg`` replaces
    the arch's published config (e.g. with fewer layers).  On a mesh of
    2 or more chips the collectives are those of the first rank's step
    (:func:`count_collectives`)."""
    cfg = cfg if cfg is not None else get_config(arch_id)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mesh_axes = MESHES[mesh] if isinstance(mesh, str) else dict(mesh)
    chips = math.prod(mesh_axes.values())
    t0 = time.monotonic()
    fn, args = build_cell(cfg, shape, param_dtype)
    counted = count_cost(fn, *args)
    del fn, args
    cost = {"flops": counted["flops"] / chips,
            "bytes": counted["bytes"] / chips,
            "flops_global": counted["flops"],
            "bytes_global": counted["bytes"],
            "aten_ops": counted["ops"]}
    coll, by_axis, coll_bytes, error = {}, {}, 0.0, None
    if chips > 1:
        res_bytes = None
        try:
            view, fn, args = _rank_cell(cfg, shape, mesh_axes, None,
                                        param_dtype)
            res_bytes = held_bytes(args[:-1])           # all but the batch
            coll, by_axis = collective_record(
                _run_counted(view, fn, args), mesh_axes)
            coll_bytes = sum(v["bytes"] for v in coll.values())
        except (ValueError, NotImplementedError) as e:
            coll = by_axis = coll_bytes = None
            error = f"{type(e).__name__}: {e}"
    else:
        res_bytes = _resident_bytes(cfg, shape, mesh_axes, param_dtype)
    t_trace = time.monotonic() - t0

    n_params = param_count(get_api(cfg).param_specs(cfg))
    n_active = _active_params(cfg, n_params)
    n_tokens = (shape.global_batch * shape.seq_len
                if shape.kind in ("train", "prefill") else shape.global_batch)
    mf = model_flops(n_params, n_tokens, shape.kind, n_active)
    roof = roofline_report(
        flops_per_device=cost["flops"], bytes_per_device=cost["bytes"],
        coll_bytes_per_device=coll_bytes, chips=chips, hw=hw,
        model_flops_total=mf)

    rec = {
        "arch": arch_id, "shape": shape.name, "kind": shape.kind,
        "mesh": mesh_summary(mesh_axes), "chips": chips,
        "multi_pod": mesh_axes.get("pod", 1) > 1,
        "n_params": n_params, "n_active_params": n_active,
        "tokens_per_step": n_tokens,
        "trace_s": round(t_trace, 2),
        "cost_analysis": cost,
        "collectives": coll,
        "collective_bytes_per_device": coll_bytes,
        "collectives_by_axis": by_axis,
        "memory_analysis": {"argument_size": None, "output_size": None,
                            "temp_size": None, "generated_code_size": None},
        "resident_bytes_per_device": res_bytes,
        "fits_hbm": (None if res_bytes is None
                     else res_bytes < hw.hbm_per_chip),
        "roofline": roof,
        "param_dtype": None if param_dtype is None else str(param_dtype),
    }
    if verbose:
        coll_txt = "n/a" if coll_bytes is None else f"{coll_bytes:.3e}B"
        res_txt = "n/a" if res_bytes is None else f"{res_bytes / 1e9:.2f}GB"
        print(f"[dryrun] {arch_id:24s} {shape.name:12s} "
              f"mesh={rec['mesh']:28s} trace={t_trace:6.1f}s"
              f" flops/dev={cost['flops']:.3e}"
              f" coll/dev={coll_txt}"
              f" resident/dev={res_txt}"
              f" dominant={roof['dominant']}"
              f" bound={fmt_seconds(roof['bound_s'])}")
        if error is not None:
            print(f"[dryrun]   no collective term: {error}")
        sys.stdout.flush()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="meta-tensor dry run and "
                                             "H100 roofline")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["card", "single", "multi", "both"],
                    default="card")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--isolate", action="store_true",
                    help="run each cell in a subprocess")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else [args.arch]
    os.makedirs(args.out, exist_ok=True)
    meshes = {"card": ["card"], "single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    failures = []
    for arch_id in archs:
        cfg = get_config(arch_id)
        shapes = (cells_for(arch_id, cfg.encoder_only)
                  if args.shape == "all" else [args.shape])
        for shape_name in shapes:
            tag = f"{arch_id}__{shape_name}"
            for mesh in meshes:
                fname = os.path.join(args.out, f"{tag}__{mesh}.json")
                if os.path.exists(fname) and not args.force:
                    print(f"[dryrun] skip (cached) {fname}")
                    continue
                if args.isolate:
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch_id, "--shape", shape_name,
                           "--mesh", mesh, "--out", args.out, "--force"]
                    r = subprocess.run(cmd, capture_output=True, text=True,
                                       timeout=3600)
                    sys.stdout.write(
                        "\n".join(l for l in r.stdout.splitlines()
                                  if l.startswith("[dryrun]")) + "\n")
                    sys.stdout.flush()
                    if r.returncode != 0:
                        failures.append((tag, mesh,
                                         (r.stderr or r.stdout)[-400:]))
                        print(f"[dryrun] FAIL (subprocess) {tag} "
                              f"mesh={mesh}")
                    continue
                try:
                    rec = run_cell(arch_id, shape_name, mesh=mesh, cfg=cfg)
                    with open(fname, "w") as f:
                        json.dump(rec, f, indent=1)
                except Exception as e:
                    failures.append((tag, mesh, repr(e)[:500]))
                    print(f"[dryrun] FAIL {tag} mesh={mesh}: "
                          f"{repr(e)[:300]}")
                    sys.stdout.flush()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, mesh, err in failures:
            print(f"  {tag} mesh={mesh}: {err}")
        return 1
    print("\nAll dry-run cells traced.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
