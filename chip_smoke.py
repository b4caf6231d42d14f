#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every kernel of the serve path from the sources in the checkout,
holds each against its plain PyTorch version on the card, drives the
port's serve engine at the full width of ``llama3.2-3b`` (random bf16
weights from a seed), and times each kernel beside its bound, its plain
version and a library call.  Raises at the first failed check, so any
failure exits non-zero; with no CUDA device, or outside a checkout of the
repository, it exits non-zero before printing any result.

Phases:
  1. the card (nvidia-smi name and power limit) and versions; TF32 off
  2. build the kernels (one nvcc per source, started together)
  3. moa_reduce against moa_reduce_plain, torch.equal, at the kernel-test
     shapes and dtypes and at the serve path's own shapes
  4. reduced-config parity: the engine on CUDA against the engine on CPU,
     same weights: greedy tokens equal, decode logits within 1e-3
  5. full width: llama3.2-3b, 28 layers, bf16, 8 greedy requests of 128 to
     1024 prompt tokens and 32 new tokens on 4 slots; every request
     retires with 32 tokens, no logit is NaN, and the kernel ran exactly
     2 * layers times per dispatch
  6. kernel timings at the path shapes (CUDA events, median of 50)
  7. the kernels line, then the card line, then the result line
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM memory rate (NVIDIA data sheet) for the bytes bound
HBM_BYTES_PER_S = 3.35e12

#: kernels of the serve path: name -> (CUDA source, TPU kernel it replaces)
KERNELS = {
    "moa_reduce": ("src/repro_torch/kernels/csrc/moa_reduce.cu",
                   "src/repro/kernels/moa_reduce.py:93"),
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_build(build_mod) -> None:
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as ex:
        logs = dict(zip(KERNELS, ex.map(build_mod.build, KERNELS)))
    for name in KERNELS:
        build_mod.load(name)
        for line in logs[name].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] {len(KERNELS)} kernel(s) built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")


def path_shapes(cfg, ecfg):
    """(label, N, M) of the two moa_reduce calls per layer per dispatch:
    decode over all slots (C = 1) and a full prefill piece (B = 1), for a
    resolved engine config."""
    n = ecfg.max_seq // ecfg.page_size
    h, hd = cfg.n_heads, cfg.hd
    b, c = ecfg.max_slots, ecfg.prefill_chunk
    return [("decode_l", n, b * h), ("decode_o", n, b * h * hd),
            ("prefill_l", n, c * h), ("prefill_o", n, c * h * hd)]


def phase_kernel_check(moa, ops, shapes) -> float:
    """moa_reduce (through ops, as the path calls it) against the plain
    version on the same CUDA inputs, bit for bit.  Returns the max |diff|."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    err = 0.0
    cases = []
    for n, rows, cols in [(2, 8, 128), (4, 64, 128), (7, 33, 257),
                          (16, 128, 384), (33, 16, 130), (24, 32, 256)]:
        for dt in (torch.float32, torch.bfloat16, torch.int32):
            cases.append((n, (rows, cols), dt))
    cases += [(n, (m,), torch.float32) for _, n, m in shapes]
    for n, tail, dt in cases:
        if dt == torch.int32:
            x = torch.randint(-1000, 1000, (n, *tail), generator=gen,
                              device=dev, dtype=torch.int32)
            acc = torch.int32
        else:
            x = torch.randn((n, *tail), generator=gen, device=dev).to(dt)
            acc = torch.float32
        got = ops.moa_reduce(x, acc, out_dtype=acc)
        want = moa.moa_reduce_plain(x, acc, acc)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"moa_reduce != moa_reduce_plain at N={n} {tail} {dt}")
        err = max(err, float((got.double() - want.double()).abs().max()))
    # bf16 operands, fp32 accumulator: the small terms must survive
    n = 256
    x = torch.cat([torch.full((1, 8, 128), 1024.0, device=dev),
                   torch.full((n - 1, 8, 128), 0.25, device=dev)]
                  ).to(torch.bfloat16)
    got = ops.moa_reduce(x, torch.float32, out_dtype=torch.float32)
    check(bool((got == 1024.0 + 0.25 * (n - 1)).all()),
          "bf16 operands lost small terms in the fp32 accumulator")
    print(f"[check] moa_reduce == moa_reduce_plain (torch.equal) on "
          f"{len(cases) + 1} shape/dtype cases, max |diff| {err}")
    return err


def make_prompts(lens, vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def phase_reduced_parity(moa, get_config, init_params, get_api,
                         ServeEngine, EngineConfig) -> None:
    cfg = get_config("llama3.2-3b").reduced(dtype=torch.float32,
                                            n_kv_heads=2)
    gen = torch.Generator().manual_seed(0)
    cpu_params = init_params(get_api(cfg).param_specs(cfg), gen,
                             torch.device("cpu"), cfg.dtype)
    ecfg = EngineConfig(max_slots=2, max_seq=64, prefill_chunk=16,
                        page_size=16)
    prompts = make_prompts((5, 19, 33, 12), cfg.vocab, seed=0)
    runs = {}
    for dev in ("cpu", "cuda"):
        params = cpu_params if dev == "cpu" else _to(cpu_params, dev)
        eng = ServeEngine(cfg, params, config=ecfg, device=dev)
        eng.trace_logits = True
        before = moa.LAUNCHES
        reqs = [eng.submit(p, 8) for p in prompts]
        eng.run()
        runs[dev] = (reqs, eng, moa.LAUNCHES - before)
    (creqs, ceng, _), (greqs, geng, launched) = runs["cpu"], runs["cuda"]
    check([r.generated for r in creqs] == [r.generated for r in greqs],
          "reduced config: CUDA greedy tokens differ from CPU")
    diff = max(float(np.abs(a - b).max())
               for a, b in zip(ceng.logit_trace, geng.logit_trace))
    check(len(ceng.logit_trace) == len(geng.logit_trace) and diff <= 1e-3,
          f"reduced config: decode logits differ by {diff} (> 1e-3)")
    check(launched > 0 and launched == geng.stats["moa_reduce_launches"],
          "reduced config: the CUDA engine did not launch moa_reduce")
    print(f"[parity] reduced llama3.2-3b (fp32, kv_heads=2): tokens equal "
          f"CPU vs CUDA over {len(prompts)} requests, max |logit diff| "
          f"{diff:.3e} (tol 1e-3), moa_reduce launches {launched}")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def phase_full_width(moa, get_config, init_params, get_api, ServeEngine,
                     EngineConfig):
    """Returns the moa_reduce launches of the measured run."""
    cfg = get_config("llama3.2-3b")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(get_api(cfg).param_specs(cfg), gen, dev, cfg.dtype)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"[full] llama3.2-3b params: {nbytes / 1e9:.3f} GB {cfg.dtype}, "
          f"initialized in {time.perf_counter() - t0:.2f} s")
    ecfg = EngineConfig(max_slots=4, max_seq=2048, prefill_chunk=256)
    eng = ServeEngine(cfg, params, config=ecfg)
    print(f"[full] engine: slots {ecfg.max_slots}, max_seq {ecfg.max_seq}, "
          f"prefill_chunk {ecfg.prefill_chunk}, page {eng.page_size}, pool "
          f"{eng.pool.num_pages} pages "
          f"({eng.stats_summary()['pool_bytes'] / 1e9:.3f} GB KV)")
    # warm-up request (cuBLAS handles, allocator), untimed
    eng.submit(make_prompts((64,), cfg.vocab, seed=1)[0], 2)
    eng.run()
    eng.reset_stats()

    lens = (1024, 128, 768, 256, 896, 384, 640, 512)
    prompts = make_prompts(lens, cfg.vocab, seed=2)
    eng.trace_logits = True
    reqs = [eng.submit(p, 32) for p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    moa.LAUNCHES = 0
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = moa.LAUNCHES
    st = eng.stats_summary()
    check(all(r.slot is None and len(r.generated) == 32 for r in reqs),
          "full width: a request did not retire with 32 tokens")
    check(all(np.isfinite(t).all() for t in eng.logit_trace),
          "full width: a decode logit is not finite")
    dispatches = st["prefill_dispatches"] + st["decode_steps"]
    check(launches == 2 * cfg.n_layers * dispatches,
          f"full width: moa_reduce launched {launches} times, expected "
          f"2 * {cfg.n_layers} * {dispatches}")
    check(st["pages_in_use"] == 0, "full width: pages left allocated")
    print(f"[full] {len(reqs)} requests, prompt lens {list(lens)}, 32 new "
          f"tokens each: all retired; wall {wall:.3f} s")
    print(f"[full] prefill {st['prefill_tokens']} tok in "
          f"{st['prefill_dispatches']} dispatches, {st['prefill_s']:.4f} s "
          f"= {st['prefill_tok_s']:.1f} tok/s; decode {st['decode_tokens']} "
          f"tok in {st['decode_steps']} steps, {st['decode_s']:.4f} s = "
          f"{st['decode_tok_s']:.1f} tok/s "
          f"({1e3 * st['decode_s'] / st['decode_steps']:.3f} ms/step)")
    print(f"[full] moa_reduce launches {launches} = 2 * {cfg.n_layers} * "
          f"({st['prefill_dispatches']} + {st['decode_steps']}); "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.3f}"
          f" GB")
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def device_ms(fn, reps: int = 50) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, by CUDA events.
    A sleep kernel queued ahead keeps the card busy while the host enqueues
    the events and ``fn``, so the interval holds device work only."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_timing(moa, shapes):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for label, n, m in shapes:
        x = torch.randn((n, m), generator=gen, device=dev)
        kernel = device_ms(lambda: moa.moa_reduce_cuda(x, torch.float32))
        plain = device_ms(lambda: moa.moa_reduce_plain(x, torch.float32))
        library = device_ms(lambda: torch.sum(x.float(), 0))
        nbytes = moa.bound_bytes(n, m, torch.float32, torch.float32)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({"label": label, "shape": [n, m], "ms": kernel,
                     "plain_ms": plain, "library_ms": library,
                     "bound_ms": bound, "bytes": nbytes})
        print(f"[time] moa_reduce {label} N={n} M={m} fp32: kernel_ms "
              f"{kernel:.5f} bound_ms {bound:.5f} ({nbytes} B / 3.35 TB/s) "
              f"library_ms {library:.5f} (torch.sum) plain_ms {plain:.5f} "
              f"kernel/bound {kernel / bound:.2f}")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import moa_reduce as moa
    from repro_torch.models.common import init_params
    from repro_torch.models.registry import get_api
    from repro_torch.serve import EngineConfig, ServeEngine

    card = card_line()
    print(f"[card] {card}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build(_build)
    full_cfg = get_config("llama3.2-3b")
    full_ecfg = EngineConfig(max_slots=4, max_seq=2048,
                             prefill_chunk=256).resolve()
    shapes = path_shapes(full_cfg, full_ecfg)
    err = phase_kernel_check(moa, ops, shapes)
    phase_reduced_parity(moa, get_config, init_params, get_api, ServeEngine,
                         EngineConfig)
    launches = phase_full_width(moa, get_config, init_params,
                                         get_api, ServeEngine, EngineConfig)
    rows = phase_timing(moa, shapes)

    main_row = next(r for r in rows if r["label"] == "prefill_o")
    source, replaces = KERNELS["moa_reduce"]
    print(json.dumps({"kernels": [{
        "name": "moa_reduce", "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": "bytes",
        "library_ms": main_row["library_ms"], "shape": main_row["shape"],
        "checked": "torch.equal vs moa_reduce_plain", "shapes": rows}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
