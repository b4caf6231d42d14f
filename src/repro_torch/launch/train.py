"""Training entry point of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --reduced --steps 20 --seq 64 --batch 8 --device cpu \\
        --ckpt-dir /path/to/ckpt --ckpt-every 5

Builds a random fp32-master train state from ``--seed``, then runs AdamW
steps with a warm-up + cosine schedule on deterministic synthetic batches
keyed by ``(seed, step)``, printing per-step loss and milliseconds and the
train tokens per second.  Runs on the card unless ``--device cpu`` is
given; without a CUDA device it raises.  ``--reduced`` trains the tiny
same-family config in fp32 (as the JAX CLI does); the full config keeps
fp32 masters and computes in bf16 with per-layer rematerialisation.
Every architecture trains, the encoder-only ``hubert-xlarge`` (audio
frames) and ``internvl2-26b`` (vision embeddings before the text) too.
With ``--ckpt-dir`` the loop saves the train state every ``--ckpt-every``
steps and at the end, and a second run with the same directory resumes
from its newest committed step.

Under ``torchrun`` the ranks form a device mesh
(:func:`repro_torch.launch.mesh.build_mesh`) and the train state is
sharded over it as ``train_state_shardings`` lays it out: each rank holds
its block of every leaf, takes its rows of every batch, gathers a layer's
params where the layer runs, and the attention heads and experts split
over ``model``; ``--pod-compressed`` adds a ``pod`` axis of 2 and reduces
across it in int8 through the radix-4 tree
(:mod:`repro_torch.optim.compression`)::

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --reduced --device cpu --steps 4 --seq 32 --batch 4 --pod-compressed

With ``--ckpt-dir`` on a mesh each rank writes its blocks into the one
checkpoint, and a resume reads each rank's blocks, on whatever mesh the
new run has.  Ranks that share a card (more ranks than cards), and CPU
ranks, talk through gloo; only rank 0 prints.  Without a pod mesh (one
process) ``--pod-compressed`` exits with the JAX CLI's message.
"""
from __future__ import annotations

import argparse
import time

import torch

import torch.distributed as dist

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.data.pipeline import HostDataConfig
from repro_torch.launch.mesh import build_mesh, maybe_init_distributed
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.loop import LoopConfig, TrainLoop
from repro_torch.train.state import (build_train_step, init_train_state,
                                     train_state_shardings)

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3.2-3b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config in fp32 (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--pod-compressed", action="store_true",
                    help="int8 radix-4 tree gradient reduction over the "
                         "pod axis (needs a multi-pod device mesh: run "
                         "under torchrun with an even number of ranks)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory; resumes from its newest "
                         "committed step")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--d-model", type=int, default=None,
                    help="override width (with --reduced)")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = maybe_init_distributed(args.device)
    mesh = build_mesh(pods=2 if args.pod_compressed else 1, devices=device)
    if args.pod_compressed and (mesh is None or "pod" not in mesh.shape):
        raise SystemExit("--pod-compressed needs a multi-pod device mesh")
    lead = not dist.is_initialized() or dist.get_rank() == 0
    cfg = get_config(args.arch)
    if args.reduced:
        over = {}
        if args.d_model:
            over["d_model"] = args.d_model
        if args.n_layers:
            over["n_layers"] = args.n_layers
        cfg = cfg.reduced(dtype=torch.float32, **over)
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    state = init_train_state(
        cfg, torch.Generator(device=device).manual_seed(args.seed),
        pod_compressed=args.pod_compressed, mesh=mesh)
    shardings = None if mesh is None else train_state_shardings(
        cfg, mesh, pod_compressed=args.pod_compressed,
        n_pods=mesh.shape.get("pod", 1))
    step_fn = build_train_step(
        cfg, AdamWConfig(lr=args.lr, grad_clip=1.0),
        lr_schedule=warmup_cosine(args.lr, args.warmup, args.steps),
        grad_accum=args.grad_accum, pod_compressed=args.pod_compressed,
        mesh=mesh)
    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every,
                          log_every=args.log_every,
                          grad_accum=args.grad_accum, seed=args.seed)
    loop = TrainLoop(cfg, shape, loop_cfg, step_fn, state,
                     data_cfg=HostDataConfig(args.seed, 1, 0),
                     state_shardings=shardings, mesh=mesh)
    start = loop.maybe_restore()
    if start and lead:
        print(f"resumed from step {start} in {args.ckpt_dir}")
    t0 = time.monotonic()
    loop.run(start_step=start)
    dt = time.monotonic() - t0
    if lead:
        for m in loop.metrics_log:
            print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
                  f"{m['time_s'] * 1e3:9.2f} ms/step")
        steps = max(0, args.steps - start)
        toks = steps * args.batch * args.seq * args.grad_accum
        where = (device if mesh is None
                 else f"{mesh!r} over {dist.get_backend()}")
        print(f"\ntrained {steps} steps ({toks} tokens) on {where} in "
              f"{dt:.2f}s ({toks / max(dt, 1e-9):.1f} tok/s); events: "
              f"{len(loop.events)}")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
