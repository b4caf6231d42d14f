"""Where the serve engine's time goes on the card: a ``torch.profiler`` trace.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve

Builds ``--arch`` (default ``llama3.2-3b``; ``minicpm3-4b`` serves through
MLA's latent pools, ``phi3.5-moe-42b-a6.6b`` through the routed MoE FFN,
``falcon-mamba-7b`` and ``zamba2-1.2b`` through their recurrent state on
contiguous slots, whose prefill is one decode step a token: give them a
short ``--context`` and ``--prompt-len``)
at full width (random bf16 weights from ``--seed``; ``--layers N`` cuts the
depth to N layers, for a model whose published depth does not fit the
card: ``phi3.5-moe-42b-a6.6b --layers 16`` is ``chip_smoke.py``'s phase M),
engine knobs as in ``chip_smoke.py``'s phase 6 (4 slots, max_seq 2048,
prefill chunk 256, page 128, prefix cache off; every
:class:`~repro_torch.serve.EngineConfig` knob has the serve CLI's flag,
e.g. ``--no-paged-kv`` for contiguous slots), and traces two windows
after a warm-up:

* decode: ``--steps`` engine steps with all 4 slots live (admitted with
  ``--context``-token prompts, untraced) and nothing to admit (pure batched decode; with ``--spec-k`` and the other speculative
  flags of the serve CLI, each step is one verify dispatch instead — the
  default stays sequential, as in phase 6);
* prefill: the admission of one ``--prompt-len``-token prompt (its chunked
  prefill pieces, nothing decoding).

``--kv-dtype int8`` (or ``int4``) traces a quantized pool, whose gathers
dequantize and whose writes quantize; ``--temperature`` samples every
request (top-k 40, seeds 0-4) instead of taking the argmax, so the trace
counts the sampling kernels a step adds.

For each window it prints the wall time (host clock, ending in a
synchronize), the device busy time (union of kernel intervals), the idle
share, the kernel launches, and the kernels with the most device time.
The profiler's own per-op bookkeeping lengthens the host side, so the idle
share under the trace is an upper bound of the untraced one; the decode
window therefore runs ``--steps`` steps untraced first and prints their
wall time per step and the engine's dispatch p50 (``decode_step_p50_s``:
the dispatch and the read of its tokens, without drafting).
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.registry import get_config, list_archs
from repro_torch.models.common import init_params
from repro_torch.models.registry import get_api
from repro_torch.serve import (SamplingParams, ServeEngine, add_cli_args,
                               config_from_args)

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
    ap.add_argument("--arch", default="llama3.2-3b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--prompt-len", type=int, default=1024,
                    help="the traced admission's prompt tokens")
    ap.add_argument("--context", type=int, default=512,
                    help="prompt tokens of the decode window's requests")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "published depth)")
    # every engine knob, at phase 6's geometry unless given
    add_cli_args(ap, spec_k_default=0)
    ap.set_defaults(prefill_chunk=256, prefix_cache=False)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sample every request at this temperature with "
                         "top-k 40 (0 = greedy)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(f"[card] {card.splitlines()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(get_api(cfg).param_specs(cfg), gen, dev, cfg.dtype)
    ecfg = config_from_args(args)
    eng = ServeEngine(cfg, params, config=ecfg.replace(
        max_seq=args.max_seq or 2048))
    print(f"[engine] arch {cfg.arch_id}, layers {cfg.n_layers}, spec_k "
          f"{eng.spec_k}, spec_mode "
          f"{eng.spec_mode}, kv_dtype {eng.kv_dtype}, paged_kv {eng.paged}, "
          f"page {eng.page_size}, temperature {args.temperature}")
    rng = np.random.default_rng(args.seed)
    seeds = iter(range(1 << 30))

    def sampling():
        return SamplingParams(temperature=args.temperature,
                              top_k=40 if args.temperature else 0,
                              seed=next(seeds))

    def prompt(n):
        return rng.integers(0, cfg.vocab, n).tolist()

    eng.submit(prompt(300), 4, sampling=sampling())   # warm-up, untraced
    eng.run()

    # decode window: 4 live slots, nothing pending
    for _ in range(eng.max_slots):
        eng.submit(prompt(args.context), 2 * args.steps + 8,
                   sampling=sampling())
    eng.step()                                        # admits all four
    eng.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats_summary()
    print(f"[decode] untraced: {args.steps} step(s), wall "
          f"{1e3 * wall / args.steps:.3f} ms per step, dispatch p50 "
          f"{1e3 * st['decode_step_p50_s']:.3f} ms, "
          f"{st['tokens_per_step']:.3f} tokens a slot per step")
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
    eng.submit(prompt(args.prompt_len), 1, sampling=sampling())
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
