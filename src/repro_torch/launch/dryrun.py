"""Dry run: trace each (arch x shape) cell on meta tensors and report its
roofline against an H100.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh card --isolate
    PYTHONPATH=src python -m repro_torch.roofline.report results/dryrun_torch

The counterpart of ``repro/launch/dryrun.py``.  Each cell's step (the
train step with AdamW, the prefill forward or one decode step against a
``seq_len``-deep cache) runs once on meta tensors, which hold shapes and
no data: nothing is allocated and nothing runs on any device, so a
full-width cell traces on a laptop's CPU.  :func:`count_cost` counts its
FLOPs and bytes; per-device counts are the global ones over the mesh's
chips.  Resident bytes per device come from the JAX package's sharding
rules (:func:`make_shardings`) on the chosen mesh: ``card`` (one H100,
every rule replicated), ``single`` (16x16) or ``multi`` (2x16x16).

The record keeps the JAX record's keys where the port has a
counterpart.  Where it differs:

- ``trace_s``, the meta trace's seconds, replaces ``lower_s``,
  ``compile_s`` and ``cost_pass_s``;
- ``memory_analysis`` has every size ``None`` (no compiler plans a
  buffer), ``temp_size`` included;
- there is no ``cost_pass_unrolled``: an eager trace counts every layer
  and every chunk, so ``unrolled_scans`` has no counterpart;
- ``collectives`` and ``collective_bytes_per_device`` are ``{}`` and 0 on
  the card and ``None`` on a production mesh, where the JAX package reads
  them from the partitioned HLO; the port runs its mesh over
  ``torch.distributed`` with no partitioner, so the term waits for a
  transport that counts the bytes a traced step would move (``ROADMAP.md``
  step 6c); the dominant term is then taken over compute and memory;
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
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                     cells_for)
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.launch.inputs import decode_state_structs, input_specs
from repro_torch.launch.mesh import (card_mesh, make_production_mesh,
                                     mesh_summary)
from repro_torch.models.common import (make_shardings, param_count,
                                      shape_structs)
from repro_torch.models.registry import get_api
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.roofline.analysis import (H100, HW, count_cost, fmt_seconds,
                                           model_flops, roofline_report)
from repro_torch.train.state import build_train_step, train_state_specs
from repro_torch.tree import leaves, map_tree

__all__ = ["MESHES", "build_cell", "run_cell", "main"]

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


def build_cell(cfg: ModelConfig, shape: ShapeConfig,
               param_dtype: Optional[torch.dtype] = None):
    """(step, meta argument tuple) for one (arch x shape) cell.  Serve
    cells run without autograd; ``param_dtype`` holds their params in
    that dtype (None: the specs' fp32)."""
    api = get_api(cfg)
    batch = input_specs(cfg, shape)
    if shape.kind == "train":
        step = build_train_step(cfg, AdamWConfig(lr=1e-4, grad_clip=1.0))
        return step, (shape_structs(train_state_specs(cfg)), batch)
    params = shape_structs(api.param_specs(cfg), param_dtype)
    if shape.kind == "prefill":
        def prefill(params, batch):
            with torch.no_grad():
                out = api.forward(params, batch, cfg)
            return out[0] if isinstance(out, tuple) else out
        return prefill, (params, batch)

    # decode: one new token against a seq_len-deep cache
    def serve_step(params, state, batch):
        with torch.no_grad():
            return api.decode_step(params, state, batch, cfg)
    state, _ = decode_state_structs(cfg, shape)
    return serve_step, (params, state, batch)


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
    cache, each under its sharding."""
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
             mesh: str = "card", hw: HW = H100, verbose: bool = True,
             cfg: Optional[ModelConfig] = None,
             param_dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Trace one cell on meta tensors and return its record.  ``shape`` is
    a name in :data:`SHAPES` or a :class:`ShapeConfig`; ``cfg`` replaces
    the arch's published config (e.g. with fewer layers)."""
    cfg = cfg if cfg is not None else get_config(arch_id)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mesh_axes = MESHES[mesh]
    chips = math.prod(mesh_axes.values())
    t0 = time.monotonic()
    fn, args = build_cell(cfg, shape, param_dtype)
    counted = count_cost(fn, *args)
    t_trace = time.monotonic() - t0
    cost = {"flops": counted["flops"] / chips,
            "bytes": counted["bytes"] / chips,
            "flops_global": counted["flops"],
            "bytes_global": counted["bytes"],
            "aten_ops": counted["ops"]}
    on_card = mesh == "card"
    coll = {} if on_card else None
    coll_bytes = 0.0 if on_card else None

    res_bytes = _resident_bytes(cfg, shape, mesh_axes, param_dtype)
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
        "multi_pod": mesh == "multi",
        "n_params": n_params, "n_active_params": n_active,
        "tokens_per_step": n_tokens,
        "trace_s": round(t_trace, 2),
        "cost_analysis": cost,
        "collectives": coll,
        "collective_bytes_per_device": coll_bytes,
        "memory_analysis": {"argument_size": None, "output_size": None,
                            "temp_size": None, "generated_code_size": None},
        "resident_bytes_per_device": res_bytes,
        "fits_hbm": res_bytes < hw.hbm_per_chip,
        "roofline": roof,
        "param_dtype": None if param_dtype is None else str(param_dtype),
    }
    if verbose:
        coll_txt = "n/a" if coll_bytes is None else f"{coll_bytes:.3e}B"
        print(f"[dryrun] {arch_id:24s} {shape.name:12s} "
              f"mesh={rec['mesh']:28s} trace={t_trace:6.1f}s"
              f" flops/dev={cost['flops']:.3e}"
              f" coll/dev={coll_txt}"
              f" resident/dev={res_bytes / 1e9:.2f}GB"
              f" dominant={roof['dominant']}"
              f" bound={fmt_seconds(roof['bound_s'])}")
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
