"""Where the serve engine's time goes on the card: a ``torch.profiler`` trace.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve

Builds ``llama3.2-3b`` at full width (random bf16 weights from ``--seed``),
engine knobs as in ``chip_smoke.py`` (4 slots, max_seq 2048, prefill chunk
256, page 128), and traces two windows after a warm-up:

* decode: ``--steps`` engine steps with all 4 slots live and nothing to
  admit (pure batched decode);
* prefill: the admission of one ``--prompt-len``-token prompt (its chunked
  prefill pieces, nothing decoding).

For each window it prints the wall time (host clock, ending in a
synchronize), the device busy time (union of kernel intervals), the idle
share, the kernel launches, and the kernels with the most device time.
The profiler's own per-op bookkeeping lengthens the host side, so the idle
share under the trace is an upper bound of the untraced one.
"""
from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.registry import get_config
from repro_torch.models.common import init_params
from repro_torch.models.registry import get_api
from repro_torch.serve import EngineConfig, ServeEngine

__all__ = ["main"]


def _kernel_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _busy_us(events) -> float:
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _report(name: str, prof, wall_s: float, units: int, unit: str,
            top: int) -> None:
    events = _kernel_events(prof)
    busy_ms = _busy_us(events) / 1e3
    wall_ms = wall_s * 1e3
    by_name = defaultdict(lambda: [0, 0.0])
    for e in events:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    print(f"[{name}] {units} {unit}(s): wall {wall_ms:.3f} ms "
          f"({wall_ms / units:.3f} ms per {unit}), device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}, "
          f"{len(events)} kernels ({len(events) / units:.1f} per {unit})")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for kname, (count, us) in ranked[:top]:
        print(f"[{name}]   {us / 1e3:9.3f} ms  {100 * us / 1e3 / busy_ms:5.1f}%"
              f"  x{count:<6d} {kname[:110]}")
    moa = [(c, us) for k, (c, us) in by_name.items() if "moa_reduce" in k]
    if moa:
        count = sum(c for c, _ in moa)
        us = sum(u for _, u in moa)
        print(f"[{name}]   moa_reduce: {count} launches, {us / 1e3:.3f} ms "
              f"device ({100 * us / 1e3 / busy_ms:.2f}% of busy)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(f"[card] {card.splitlines()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = get_config("llama3.2-3b")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(get_api(cfg).param_specs(cfg), gen, dev, cfg.dtype)
    eng = ServeEngine(cfg, params, config=EngineConfig(
        max_slots=4, max_seq=2048, prefill_chunk=256))
    rng = np.random.default_rng(args.seed)

    def prompt(n):
        return rng.integers(0, cfg.vocab, n).tolist()

    eng.submit(prompt(300), 4)                        # warm-up, untraced
    eng.run()

    # decode window: 4 live slots, nothing pending
    for _ in range(eng.max_slots):
        eng.submit(prompt(512), args.steps + 8)
    eng.step()                                        # admits all four
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report("decode", prof, wall, args.steps, "step", args.top)
    eng.run()

    # prefill window: one admission, retired on its first token
    eng.submit(prompt(args.prompt_len), 1)
    before = eng.stats["prefill_dispatches"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    pieces = eng.stats["prefill_dispatches"] - before
    _report("prefill", prof, wall, pieces, "dispatch", args.top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
