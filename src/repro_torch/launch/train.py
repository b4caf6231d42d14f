"""Training entry point of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --reduced --steps 20 --seq 64 --batch 8 --device cpu

Builds a random fp32-master train state from ``--seed``, then runs AdamW
steps with a warm-up + cosine schedule on deterministic synthetic batches
keyed by ``(seed, step)``, printing per-step loss and milliseconds and the
train tokens per second.  Runs on the card unless ``--device cpu`` is
given; without a CUDA device it raises.  ``--reduced`` trains the tiny
same-family config in fp32 (as the JAX CLI does); the full config keeps
fp32 masters and computes in bf16 with per-layer rematerialisation.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.data.pipeline import HostDataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.loop import LoopConfig, TrainLoop
from repro_torch.train.state import build_train_step, init_train_state

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
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--d-model", type=int, default=None,
                    help="override width (with --reduced)")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
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
        cfg, torch.Generator(device=device).manual_seed(args.seed))
    step_fn = build_train_step(
        cfg, AdamWConfig(lr=args.lr, grad_clip=1.0),
        lr_schedule=warmup_cosine(args.lr, args.warmup, args.steps),
        grad_accum=args.grad_accum)
    loop_cfg = LoopConfig(total_steps=args.steps, log_every=args.log_every,
                          grad_accum=args.grad_accum, seed=args.seed)
    loop = TrainLoop(cfg, shape, loop_cfg, step_fn, state,
                     data_cfg=HostDataConfig(args.seed, 1, 0))
    t0 = time.monotonic()
    loop.run()
    dt = time.monotonic() - t0
    for m in loop.metrics_log:
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"{m['time_s'] * 1e3:9.2f} ms/step")
    toks = args.steps * args.batch * args.seq * args.grad_accum
    print(f"\ntrained {args.steps} steps ({toks} tokens) on {device} in "
          f"{dt:.2f}s ({toks / dt:.1f} tok/s); events: {len(loop.events)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
