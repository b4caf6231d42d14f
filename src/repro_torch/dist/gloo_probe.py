"""Which gloo collectives take CUDA tensors on this torch.

    PYTHONPATH=src python -m repro_torch.dist.gloo_probe [--ranks 2]

NCCL refuses two ranks of one communicator on the same device, so ranks
that share one card talk through gloo.  This starts ``--ranks`` processes
on ``cuda:0`` joined by gloo (a ``file://`` rendezvous in a temporary
directory), runs each collective the mesh code uses once on a CUDA tensor
and once on a CPU tensor, and prints one JSON object: for each op, whether
it ran and gave the right values on each device, with the error text where
it did not.  It is the one place that catches a collective's error: it
exists to find out.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
from typing import Callable, Dict

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["main"]


def _cases(rank: int, world: int) -> Dict[str, Callable]:
    def all_reduce_sum(dev):
        x = torch.full((5,), float(rank + 1), device=dev)
        dist.all_reduce(x)
        return torch.equal(x.cpu(), torch.full((5,), world * (world + 1) / 2))

    def all_reduce_max(dev):
        x = torch.full((5,), float(rank), device=dev)
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return torch.equal(x.cpu(), torch.full((5,), float(world - 1)))

    def all_gather_into_tensor(dev):
        out = torch.empty(world * 3, device=dev)
        dist.all_gather_into_tensor(out, torch.full((3,), float(rank),
                                                    device=dev))
        want = torch.arange(world).float().repeat_interleave(3)
        return torch.equal(out.cpu(), want)

    def reduce_scatter_tensor(dev):
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, torch.arange(world * 2, device=dev,
                                                     dtype=torch.float32))
        want = torch.arange(rank * 2, rank * 2 + 2).float() * world
        return torch.equal(out.cpu(), want)

    def all_to_all_single(dev):
        src = torch.arange(world, device=dev, dtype=torch.float32) + 10 * rank
        out = torch.empty(world, device=dev)
        dist.all_to_all_single(out, src)
        want = torch.arange(world).float() * 10 + rank
        return torch.equal(out.cpu(), want)

    def all_reduce_int32(dev):
        x = torch.full((4,), rank + 1, dtype=torch.int32, device=dev)
        dist.all_reduce(x)
        return torch.equal(x.cpu(), torch.full((4,), world * (world + 1) // 2,
                                               dtype=torch.int32))

    return {f.__name__: f for f in (
        all_reduce_sum, all_reduce_max, all_reduce_int32,
        all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single)}


def _rank(rank: int, world: int, store: str, out_dir: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    found = {}
    devices = ["cpu"] + (["cuda:0"] if torch.cuda.is_available() else [])
    for name, fn in _cases(rank, world).items():
        found[name] = {}
        for dev in devices:
            try:
                ok = bool(fn(torch.device(dev)))
                found[name][dev] = "ok" if ok else "wrong values"
            except Exception as exc:  # the probe's purpose: record it
                found[name][dev] = f"{type(exc).__name__}: {exc}"[:300]
            dist.barrier()
    if torch.cuda.is_available():
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("model",))
        x = torch.ones(3, device="cuda:0")
        dist.all_reduce(x, group=mesh.get_group("model"))
        found["device_mesh_cuda"] = {"cuda:0": "ok" if torch.equal(
            x.cpu(), torch.full((3,), float(world))) else "wrong values"}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(found, f)
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args(argv)
    tmp = tempfile.mkdtemp(prefix="gloo_probe_")
    try:
        mp.spawn(_rank, args=(args.ranks, os.path.join(tmp, "store"), tmp),
                 nprocs=args.ranks)
        with open(os.path.join(tmp, "rank0.json")) as f:
            found = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"torch": torch.__version__,
                      "cuda": torch.version.cuda, "ops": found}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
