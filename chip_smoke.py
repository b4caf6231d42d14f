#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every kernel of the serve and training paths from the sources in
the checkout, holds each against its plain PyTorch version on the card,
drives the port's serve engine and its trainer at the full width of
``llama3.2-3b`` (random weights from a seed), and times each kernel beside
its bound, its plain version and a library call.  Raises at the first
failed check, so any failure exits non-zero; with no CUDA device, or
outside a checkout of the repository, it exits non-zero before printing
any result.

Phases:
  1. the card (nvidia-smi name and power limit) and versions; TF32 off
  2. build the kernels (one nvcc per source, started together; each
     source's build time)
  3. moa_reduce against moa_reduce_plain, torch.equal, at the kernel-test
     shapes and dtypes and at the serve path's own shapes
  4. flash attention: the forward kernel against flash_attention_plain
     (2e-5 fp32; bf16 2e-2 and relative norm error 1e-2) and the dq and
     dk/dv kernels against flash_attention_plain_bwd and against autograd
     through the plain forward (fp32 rtol 1e-4 atol 1e-5; bf16 relative
     norm error 1e-2), causal and not, at the kernel-test shapes, bf16
     shapes with a ragged S, and the training path's; two forward calls
     at the path shape give torch.equal o and lse, two backward calls
     torch.equal dq, delta, dk and dv
  5. serve, reduced-config parity: the engine on CUDA against the engine
     on CPU, same weights: greedy tokens equal, decode logits within 1e-3
  6. serve, full width: llama3.2-3b, 28 layers, bf16, 8 greedy requests
     of 128 to 1024 prompt tokens and 32 new tokens on 4 slots; every
     request retires with 32 tokens, no logit is NaN, and moa_reduce ran
     exactly 2 * layers times per dispatch
  7. moa_reduce timings at the serve path shapes (CUDA events, median of 50)
  8. train, reduced-config parity: 3 AdamW steps of the reduced fp32
     config from one state on the CPU (chunked attention) and on CUDA (the
     kernels): losses within 1e-4, kernels launched layers * steps times
  9. train, full width: llama3.2-3b, fp32 masters, bf16 compute, remat,
     batch 2 x seq 2048: loss and gradient norm through the kernels
     against the chunked attention on one state and batch (loss within
     2e-3, norm within 0.1%), then 1 warm-up and 3 timed AdamW steps (peak
     lr 3e-4, 100-step warm-up): finite losses and grad norms, the first
     loss within 1.0 of ln(vocab), the forward kernel launched 2 * layers
     * steps times (remat runs each layer's forward again in the backward)
     and each backward kernel layers * steps times
 10. flash attention timings at the training path shape (median of 20)
     beside the bound, the plain version and PyTorch's
     scaled_dot_product_attention; the forward's and the backward's
     TFLOP/s and share of the bf16 peak beside SDPA's
 11. bitplane_add and quant_matmul against bitplane_add_plain and
     quant_matmul_plain, torch.equal, at the kernel-test shapes (Fig 12
     lanes, the all -128 K = 8192 case, a binding 18-bit plan) and at the
     adder path's shapes; the width guard raises before any launch
 12. the adder path, taken from llama3.2-3b's training step (4096 tokens):
     bitplane_add over one activation tensor (B = 4096 x d_model lanes) as
     the 16 x 16, 4 x 16 and 64 x 20 adders, quant_matmul at the gate/up,
     down and q/o projections and all -128 at K = d_ff; core.moa's
     reconfigured_add (Fig 15) and serial_add on the 16 x 16 lanes as
     plain device code; every result exact, each kernel launched once
     per call
 13. adder timings at the path shapes beside the bound, the plain version
     and a library call (torch.sum, torch._int_mm)
 14. the kernels line, then the card line, then the result line
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# noqa: E402 below: these need the path
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import lut, planner, reconfig  # noqa: E402
from repro_torch.core import moa as core_moa  # noqa: E402
from repro_torch.data.pipeline import HostDataConfig, host_batch  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import bitplane_add as bpa  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moa_reduce as moa  # noqa: E402
from repro_torch.kernels import quant_matmul as qmm  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.common import init_params  # noqa: E402
from repro_torch.models.lm import train_loss  # noqa: E402
from repro_torch.models.registry import get_api  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, global_norm  # noqa: E402
from repro_torch.optim.grad_accum import value_and_grad  # noqa: E402
from repro_torch.optim.schedule import warmup_cosine  # noqa: E402
from repro_torch.serve import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.train.loop import LoopConfig, TrainLoop  # noqa: E402
from repro_torch.train.state import (build_train_step,  # noqa: E402
                                     init_train_state, split_layers)
from repro_torch.tree import leaves, map_tree  # noqa: E402

#: H100 SXM memory rate and dense bf16 and int8 tensor-core rates (NVIDIA
#: data sheet) for the bounds
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
#: INT32 operations of the CUDA cores: 132 SMs x 64 INT32 lanes x 1.98 GHz,
#: the clock of the data sheet's 67 TFLOP/s fp32 (132 x 128 x 2 x 1.98 GHz)
INT32_OPS_PER_S = 132 * 64 * 1.98e9

#: kernel sources: name -> (CUDA source, TPU kernel it replaces)
KERNELS = {
    "moa_reduce": ("src/repro_torch/kernels/csrc/moa_reduce.cu",
                   "src/repro/kernels/moa_reduce.py:93"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:97"),
    "bitplane_add": ("src/repro_torch/kernels/csrc/bitplane_add.cu",
                     "src/repro/kernels/bitplane_add.py:78"),
    "quant_matmul": ("src/repro_torch/kernels/csrc/quant_matmul.cu",
                     "src/repro/kernels/quant_matmul.py:61"),
}

#: the training path's attention shape: llama3.2-3b at batch 2 x seq 2048
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 3
#: the schedule the timed steps sit at the start of: peak lr 3e-4 after a
#: 100-step linear warm-up, cosine over 1000 steps
TRAIN_WARMUP, TRAIN_TOTAL = 100, 1000
FLASH_CHECK_SHAPES = [(2, 256, 4, 2, 64, torch.float32),
                      (1, 128, 8, 8, 128, torch.float32),
                      (2, 256, 6, 2, 80, torch.bfloat16),
                      (1, 512, 4, 1, 128, torch.float32),
                      (1, 256, 2, 2, 64, torch.float32),
                      (2, 37, 6, 2, 16, torch.float32),
                      (2, 100, 6, 2, 128, torch.bfloat16),
                      (1, 200, 4, 1, 64, torch.bfloat16),
                      (2, 37, 4, 4, 80, torch.bfloat16),
                      (2, TRAIN_SEQ, 24, 8, 128, torch.bfloat16)]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _timed_build(name):
    t0 = time.perf_counter()
    log = _build.build(name)
    return log, time.perf_counter() - t0


def phase_build() -> None:
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as ex:
        done = dict(zip(KERNELS, ex.map(_timed_build, KERNELS)))
    for name, (log, secs) in done.items():
        _build.load(name)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
        print(f"[build] {name}.cu: {secs:.2f} s"
              f"{'' if log else ' (already built)'}")
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


def phase_kernel_check(shapes) -> float:
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


def phase_reduced_parity() -> None:
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
        params = (cpu_params if dev == "cpu"
                  else map_tree(lambda t: t.to(dev), cpu_params))
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


def phase_full_width():
    """Returns the moa_reduce launches of the measured run."""
    cfg = get_config("llama3.2-3b")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(get_api(cfg).param_specs(cfg), gen, dev, cfg.dtype)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in leaves(params))
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


def phase_timing(shapes):
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


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() /
                 b.float().norm().clamp_min(1e-30))


def phase_flash_check():
    """The forward, dq and dk/dv kernels against the plain versions on the
    same CUDA inputs.  Returns, per kernel, the max |diff| over the fp32
    cases and at the training path shape (bf16, causal)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    errs = {k: {"fp32": 0.0, "path": 0.0} for k in ("fwd", "bwd_dq",
                                                     "bwd_dkv")}
    n = repeats = 0
    for b, s, hq, hkv, hd, dt in FLASH_CHECK_SHAPES:
        for causal in (True, False):
            what = f"(B,S,Hq,Hkv,hd)={(b, s, hq, hkv, hd)} {dt} causal={causal}"
            q, do = (torch.randn((b, s, hq, hd), generator=gen, device=dev)
                     .to(dt) for _ in range(2))
            k, v = (torch.randn((b, s, hkv, hd), generator=gen, device=dev)
                    .to(dt) for _ in range(2))
            o, lse = fa.flash_attention_fwd_cuda(q, k, v, causal)
            dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, o, lse, do,
                                                       causal)
            dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, lse, delta, do,
                                                     causal)
            torch.cuda.synchronize()
            po, plse = fa.flash_attention_plain(q, k, v, causal)
            tol = 2e-5 if dt == torch.float32 else 2e-2
            check(torch.allclose(o.float(), po.float(), rtol=tol, atol=tol),
                  f"flash forward != plain at {what}")
            check(dt == torch.float32 or _rel(o, po) <= 1e-2,
                  f"flash forward relative norm error {_rel(o, po)} > 1e-2 "
                  f"at {what}")
            check(torch.allclose(lse, plse, rtol=1e-5, atol=1e-5),
                  f"flash lse != plain at {what}")
            plain = fa.flash_attention_plain_bwd(q, k, v, o, lse, do, causal)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            auto = torch.autograd.grad(
                fa.flash_attention_plain(*leaves, causal)[0], leaves, do)
            for name, got, want, ref in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                            plain, auto):
                for w, wname in ((want, "plain_bwd"), (ref, "autograd")):
                    ok = (torch.allclose(got, w, rtol=1e-4, atol=1e-5)
                          if dt == torch.float32 else _rel(got, w) <= 1e-2)
                    check(ok, f"flash {name} != {wname} at {what}")
            if (b, s, hq, dt) == (TRAIN_BATCH, TRAIN_SEQ, 24,
                                  torch.bfloat16):
                o2, lse2 = fa.flash_attention_fwd_cuda(q, k, v, causal)
                check(torch.equal(o, o2) and torch.equal(lse, lse2),
                      f"flash forward: two calls differ at {what}")
                dq2, delta2 = fa.flash_attention_bwd_dq_cuda(q, k, v, o, lse,
                                                             do, causal)
                dk2, dv2 = fa.flash_attention_bwd_dkv_cuda(q, k, v, lse,
                                                           delta2, do, causal)
                check(all(torch.equal(x, y) for x, y in zip(
                    (dq, delta, dk, dv), (dq2, delta2, dk2, dv2))),
                    f"flash backward: two calls differ at {what}")
                repeats += 1
                del o2, lse2, dq2, delta2, dk2, dv2
            found = {"fwd": (o.float() - po.float()).abs().max(),
                     "bwd_dq": (dq.float() - plain[0].float()).abs().max(),
                     "bwd_dkv": max((dk.float() - plain[1].float()).abs()
                                    .max(), (dv.float() - plain[2].float())
                                    .abs().max())}
            key = "fp32" if dt == torch.float32 else None
            if (b, s, hq) == (TRAIN_BATCH, TRAIN_SEQ, 24) and causal:
                key = "path"
            for name, e in found.items():
                if key:
                    errs[name][key] = max(errs[name][key], float(e))
            n += 1
            del q, k, v, do, o, lse, dq, dk, dv, plain, auto, leaves
    print(f"[check] flash attention forward, dq and dk/dv kernels == plain "
          f"versions and autograd on {n} shape/dtype/causal cases; max "
          f"|diff| fp32 fwd {errs['fwd']['fp32']:.3e} dq "
          f"{errs['bwd_dq']['fp32']:.3e} dkv {errs['bwd_dkv']['fp32']:.3e}; "
          f"at the path shape (bf16) fwd {errs['fwd']['path']:.3e} dq "
          f"{errs['bwd_dq']['path']:.3e} dkv {errs['bwd_dkv']['path']:.3e}; "
          f"two forward and two backward calls torch.equal at the path "
          f"shape ({repeats} cases)")
    check(repeats == 2, "flash: the path shape was not repeated")
    return errs


def _zero_flash_counts() -> None:
    fa.LAUNCHES_FWD = fa.LAUNCHES_BWD_DQ = fa.LAUNCHES_BWD_DKV = 0


def _flash_counts():
    return {"fwd": fa.LAUNCHES_FWD, "bwd_dq": fa.LAUNCHES_BWD_DQ,
            "bwd_dkv": fa.LAUNCHES_BWD_DKV}


def _expected_counts(cfg, steps):
    fwd = cfg.n_layers * steps * (2 if cfg.remat else 1)
    return {"fwd": fwd, "bwd_dq": cfg.n_layers * steps,
            "bwd_dkv": cfg.n_layers * steps}


def phase_train_parity():
    """Three AdamW steps of the reduced config from one state, on the CPU
    (chunked attention) and on CUDA (the flash kernels)."""
    cfg = get_config("llama3.2-3b").reduced(dtype=torch.float32,
                                            n_kv_heads=2)
    shape = ShapeConfig("parity", seq_len=64, global_batch=4,
                              kind="train")
    state = init_train_state(cfg, torch.Generator().manual_seed(0))
    states = {"cuda": map_tree(lambda t: t.to("cuda"), state), "cpu": state}
    losses, counts = {}, None
    for dev in ("cpu", "cuda"):
        step_fn = build_train_step(
            cfg, AdamWConfig(lr=1e-3),
            lr_schedule=warmup_cosine(1e-3, 1, 3))
        loop = TrainLoop(cfg, shape, LoopConfig(
            total_steps=3, log_every=1, seed=5), step_fn, states[dev])
        _zero_flash_counts()
        loop.run()
        if dev == "cuda":
            counts = _flash_counts()
        losses[dev] = [m["loss"] for m in loop.metrics_log]
    diff = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
    check(len(losses["cuda"]) == 3 and diff <= 1e-4,
          f"reduced train: CUDA losses {losses['cuda']} differ from CPU "
          f"{losses['cpu']} by {diff} (> 1e-4)")
    want = _expected_counts(cfg, 3)
    check(counts == want, f"reduced train: flash launches {counts}, "
                          f"expected {want}")
    print(f"[parity] reduced llama3.2-3b train (fp32, kv_heads=2, batch 4 x "
          f"seq 64): losses CPU {['%.6f' % x for x in losses['cpu']]} CUDA "
          f"{['%.6f' % x for x in losses['cuda']]}, max |diff| {diff:.3e} "
          f"(tol 1e-4); flash launches {counts}")


def phase_train_full():
    """llama3.2-3b at full width: 1 untimed warm-up step, then the timed
    steps through TrainLoop with the launch counts read around them."""
    cfg = get_config("llama3.2-3b")
    check(cfg.remat and cfg.dtype == torch.bfloat16,
          "full-width train config must be bf16 with remat")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    state = init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(state["params"]))
    print(f"[train] llama3.2-3b train state: {n_params / 1e9:.3f} B fp32 "
          f"params + fp32 m, v, initialized in "
          f"{time.perf_counter() - t0:.2f} s")
    shape = ShapeConfig("train", seq_len=TRAIN_SEQ,
                              global_batch=TRAIN_BATCH, kind="train")
    data = HostDataConfig(0, 1, 0)
    # the same loss and gradient through the kernels and, for comparison
    # only, with attention.chunked_attention (the JAX package's path off
    # the TPU) in place of the kernels, same state and batch; bf16 rounds
    # at other places in the two
    batch0 = {k: torch.as_tensor(v).to(dev) for k, v in
              host_batch(cfg, shape, data, 0).items()}
    vg = value_and_grad(lambda p, b: train_loss(p, b, cfg))
    got = {}
    for flash in (True, False):
        _zero_flash_counts()
        if flash:
            loss, grads = vg(split_layers(state["params"]), batch0)
        else:
            with mock.patch.object(
                    ops, "flash_attention", lambda q, k, v, causal:
                    attention.chunked_attention(q, k, v, cfg)):
                loss, grads = vg(split_layers(state["params"]), batch0)
        got[flash] = (float(loss), float(global_norm(grads)),
                      _flash_counts()["fwd"])
        del grads
    check(got[True][2] > 0 and got[False][2] == 0,
          f"full train: flash forward launches {got[True][2]} through the "
          f"kernels, {got[False][2]} through the chunked attention")
    dl = abs(got[True][0] - got[False][0])
    dn = abs(got[True][1] - got[False][1]) / got[False][1]
    check(dl <= 2e-3 and dn <= 1e-3,
          f"full train: kernel path (loss, grad norm) {got[True][:2]} vs "
          f"chunked path {got[False][:2]}")
    print(f"[train] kernel path vs chunked path, same state and batch: loss "
          f"{got[True][0]:.5f} vs {got[False][0]:.5f} (|diff| {dl:.3e}, tol "
          f"2e-3), grad norm {got[True][1]:.4f} vs {got[False][1]:.4f} "
          f"(rel {dn:.3e}, tol 1e-3)")
    total = 1 + TRAIN_STEPS
    step_fn = build_train_step(
        cfg, AdamWConfig(lr=3e-4, grad_clip=1.0),
        lr_schedule=warmup_cosine(3e-4, TRAIN_WARMUP, TRAIN_TOTAL))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, warm = step_fn(state, host_batch(cfg, shape, data, 0))
    first_loss = float(warm["loss"])
    print(f"[train] warm-up step: loss {first_loss:.4f} grad_norm "
          f"{float(warm['grad_norm']):.4f} in "
          f"{time.perf_counter() - t0:.2f} s (untimed)")
    loop = TrainLoop(cfg, shape, LoopConfig(
        total_steps=total, log_every=1, seed=0), step_fn, state,
        data_cfg=data)
    torch.cuda.synchronize()
    _zero_flash_counts()
    t0 = time.perf_counter()
    loop.run(start_step=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _flash_counts()
    peak = torch.cuda.max_memory_allocated()
    log = loop.metrics_log
    losses = [first_loss] + [m["loss"] for m in log]
    norms = [float(warm["grad_norm"])] + [m["grad_norm"] for m in log]
    check(len(log) == TRAIN_STEPS, f"full train: {len(log)} timed steps")
    check(all(math.isfinite(x) for x in losses + norms),
          f"full train: a loss or grad norm is not finite: {losses} {norms}")
    ln_v = math.log(cfg.vocab)
    check(abs(first_loss - ln_v) <= 1.0,
          f"full train: first loss {first_loss} not within 1.0 of "
          f"ln({cfg.vocab}) = {ln_v:.4f}")
    want = _expected_counts(cfg, TRAIN_STEPS)
    check(counts == want, f"full train: flash launches {counts}, expected "
                          f"{want} (fwd 2 * layers * steps under remat)")
    ms = [m["time_s"] * 1e3 for m in log]
    toks = TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ
    for m in log:
        print(f"[train] step {m['step']}: loss {m['loss']:.4f} grad_norm "
              f"{m['grad_norm']:.4f} lr {m['lr']:.3e} "
              f"{m['time_s'] * 1e3:.1f} ms")
    print(f"[train] llama3.2-3b, 28 layers, fp32 masters / bf16 compute, "
          f"remat, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}: {TRAIN_STEPS} "
          f"timed steps, {toks} tokens in {wall:.3f} s = "
          f"{toks / wall:.1f} train tok/s; ms per step {['%.1f' % x for x in ms]}"
          f" (median {float(np.median(ms)):.1f}); first loss "
          f"{first_loss:.4f} vs ln(vocab) {ln_v:.4f}; flash launches "
          f"{counts}; max_memory_allocated {peak / 1e9:.3f} GB")
    return counts


def phase_flash_timing():
    """Device times at the training path shape (bf16, causal)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    b, s, hq, hkv, hd = TRAIN_BATCH, TRAIN_SEQ, 24, 8, 128
    dt = torch.bfloat16
    q, do = (torch.randn((b, s, hq, hd), generator=gen, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn((b, s, hkv, hd), generator=gen, device=dev).to(dt)
            for _ in range(2))
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, True)
    dq, delta = fa.flash_attention_bwd_dq_cuda(q, k, v, o, lse, do, True)
    reps = 20
    ms = {
        "fwd": device_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v, True),
                         reps),
        "bwd_dq": device_ms(lambda: fa.flash_attention_bwd_dq_cuda(
            q, k, v, o, lse, do, True), reps),
        "bwd_dkv": device_ms(lambda: fa.flash_attention_bwd_dkv_cuda(
            q, k, v, lse, delta, do, True), reps),
    }
    plain_fwd = device_ms(lambda: fa.flash_attention_plain(q, k, v, True),
                          reps)
    plain_bwd = device_ms(lambda: fa.flash_attention_plain_bwd(
        q, k, v, o, lse, do, True), reps)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
    with torch.no_grad():
        lib_fwd = device_ms(sdpa, reps)
        lib_err = float((sdpa().transpose(1, 2).float() - o.float())
                        .abs().max())
    lib_fwdbwd = device_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt),
                                                       dot), reps)
    out = sdpa()
    lib_bwd = device_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), reps)
    rows = {}
    for part, plain_ms, lib_ms in (("fwd", plain_fwd, lib_fwd),
                                   ("bwd_dq", plain_bwd, lib_bwd),
                                   ("bwd_dkv", plain_bwd, lib_bwd),
                                   ("bwd", plain_bwd, lib_bwd)):
        flops = fa.bound_flops(b, s, hq, hd, True, part)
        nbytes = fa.bound_bytes(b, s, hq, hkv, hd, dt, part)
        t_ops = flops / BF16_FLOP_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        kernel = (ms["bwd_dq"] + ms["bwd_dkv"]) if part == "bwd" else ms[part]
        rows[part] = {"ms": kernel, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": max(t_ops, t_bytes),
                      "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                      "flops": flops, "bytes": nbytes}
        print(f"[time] flash {part} (B,S,Hq,Hkv,hd)={(b, s, hq, hkv, hd)} "
              f"bf16 causal: kernel_ms {kernel:.4f} bound_ms "
              f"{rows[part]['bound_ms']:.4f} ({flops:.4e} flop / 989 "
              f"TFLOP/s; {nbytes} B / 3.35 TB/s) plain_ms {plain_ms:.4f} "
              f"library_ms {lib_ms:.4f} kernel/bound "
              f"{kernel / rows[part]['bound_ms']:.1f}")
    for part, lib_ms in (("fwd", lib_fwd), ("bwd", lib_bwd)):
        r = rows[part]
        r["bf16_peak_share"] = r["flops"] / (r["ms"] * 1e-3) / BF16_FLOP_PER_S
        r["library_bf16_peak_share"] = r["flops"] / (lib_ms * 1e-3) / \
            BF16_FLOP_PER_S
    print(f"[time] flash forward: {ms['fwd']:.4f} ms; its 2 matmuls at "
          f"{rows['fwd']['flops'] / ms['fwd'] / 1e9:.1f} TFLOP/s = "
          f"{rows['fwd']['bf16_peak_share']:.3f} of the 989 TFLOP/s bf16 "
          f"peak; SDPA forward {lib_fwd:.4f} ms, "
          f"{rows['fwd']['flops'] / lib_fwd / 1e9:.1f} TFLOP/s = "
          f"{rows['fwd']['library_bf16_peak_share']:.3f}")
    bwd_ms = ms["bwd_dq"] + ms["bwd_dkv"]
    built = fa.bound_flops(b, s, hq, hd, True, "bwd") * 7 // 5
    print(f"[time] flash backward (dq + dk/dv): {bwd_ms:.4f} ms; the "
          f"function's 5 matmuls at {rows['bwd']['flops'] / bwd_ms / 1e9:.1f}"
          f" TFLOP/s = {rows['bwd']['bf16_peak_share']:.3f} of the 989 "
          f"TFLOP/s bf16 peak; the 7 matmuls the kernels do (S and dP "
          f"recomputed) at {built / bwd_ms / 1e9:.1f} TFLOP/s = "
          f"{built / (bwd_ms * 1e-3) / BF16_FLOP_PER_S:.3f}; SDPA backward "
          f"{rows['bwd']['flops'] / lib_bwd / 1e9:.1f} TFLOP/s = "
          f"{rows['bwd']['library_bf16_peak_share']:.3f}")
    print(f"[time] scaled_dot_product_attention (is_causal, enable_gqa) at "
          f"the same shape: fwd {lib_fwd:.4f} ms, fwd+bwd {lib_fwdbwd:.4f} "
          f"ms, bwd {lib_bwd:.4f} ms; kernel fwd+bwd "
          f"{ms['fwd'] + ms['bwd_dq'] + ms['bwd_dkv']:.4f} ms; max |o - "
          f"sdpa| {lib_err:.3e}")
    return rows


def adder_shapes(cfg):
    """The adder path's shapes, from one training step of ``cfg`` at batch
    TRAIN_BATCH x seq TRAIN_SEQ: bitplane_add (label, N, M, B) over one
    activation tensor, quant_matmul (label, M, K, N) at the projections."""
    tokens = TRAIN_BATCH * TRAIN_SEQ
    lanes = tokens * cfg.d_model
    bitplane = [("16x16", 16, 16, lanes), ("4x16", 4, 16, lanes),
                ("64x20", 64, 20, lanes)]
    matmul = [("gate_up", tokens, cfg.d_model, cfg.d_ff),
              ("down", tokens, cfg.d_ff, cfg.d_model),
              ("q_o", tokens, cfg.d_model, cfg.n_heads * cfg.hd)]
    return bitplane, matmul


def _lanes(n, m_bits, b, gen):
    return torch.randint(0, 2 ** m_bits, (n, b), generator=gen,
                         device="cuda", dtype=torch.int32)


def _int8(shape, gen):
    return torch.randint(-128, 128, shape, generator=gen, device="cuda",
                         dtype=torch.int8)


def phase_adder_check(bitplane, matmul):
    """Both kernels against their plain versions on the same CUDA inputs,
    torch.equal.  Returns the max |diff| of each (0 when all are equal)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    err = {"bitplane_add": 0, "quant_matmul": 0}
    cases = [(4, 4, 64), (4, 16, 256), (16, 16, 128), (3, 8, 33),
             (64, 20, 512)] + [(n, m, b) for _, n, m, b in bitplane]
    fig12 = torch.tensor([[0xA], [0xF], [0x1], [0x2]], dtype=torch.int32,
                         device="cuda").repeat(1, 256)
    for n, m_bits, b in cases + [(4, 4, None)]:
        x = fig12 if b is None else _lanes(n, m_bits, b, gen)
        got = bpa.bitplane_add_cuda(x, m_bits)
        want = bpa.bitplane_add_plain(x, m_bits)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"bitplane_add != bitplane_add_plain at N={n} M={m_bits} B={b}")
        err["bitplane_add"] = max(err["bitplane_add"],
                                  int((got - want).abs().max()))
        del x, got, want
    check(bool((bpa.bitplane_add_cuda(fig12, 4) == 0x1C).all()),
          "bitplane_add: Fig 12 lanes do not give 0x1C")
    before = bpa.LAUNCHES
    try:
        bpa.bitplane_add_cuda(torch.zeros((8, 4), dtype=torch.int32,
                                          device="cuda"), 30)
        raised = False
    except ValueError:
        raised = True
    check(raised and bpa.LAUNCHES == before,
          "bitplane_add: the width guard did not raise before a launch")
    mm_cases = [(8, 128, 128, 32), (32, 384, 256, 32), (130, 257, 65, 32),
                (256, 1024, 512, 32), (130, 257, 65, 18)]
    mm_cases += [(m, k, n, 32) for _, m, k, n in matmul]
    for m, k, n, acc_bits in mm_cases + [(4, 8192, 4, None)]:
        if acc_bits is None:               # the reference's worst case
            x = torch.full((m, k), -128, dtype=torch.int8, device="cuda")
            w = torch.full((k, n), -128, dtype=torch.int8, device="cuda")
            acc_bits = 32
        else:
            x, w = _int8((m, k), gen), _int8((k, n), gen)
        got = qmm.quant_matmul_cuda(x, w, acc_bits)
        want = qmm.quant_matmul_plain(x, w, acc_bits)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"quant_matmul != quant_matmul_plain at {(m, k, n)} acc_bits "
              f"{acc_bits}")
        err["quant_matmul"] = max(err["quant_matmul"],
                                  int((got.long() - want.long()).abs().max()))
        if k == 8192 and m == 4:
            check(bool((got == k * 128 * 128).all()),
                  "quant_matmul: all -128 at K = 8192 is not 8192 * 2^14")
        del x, w, got, want
    print(f"[check] bitplane_add == bitplane_add_plain (torch.equal) on "
          f"{len(cases) + 1} shapes incl. Fig 12 and the path's; width guard "
          f"raises before a launch; quant_matmul == quant_matmul_plain on "
          f"{len(mm_cases) + 1} shapes incl. all -128 at K = 8192 and the "
          f"path's; max |diff| {err}")
    return err


def phase_adder_path(cfg, bitplane, matmul):
    """The library's multi-operand integer adders on the card at the
    path's shapes, with the launch counts read around the run."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    bpa.LAUNCHES = qmm.LAUNCHES = 0
    # Fig 3 == Fig 4 on the card: the netlist over all 16 codes is the LUT
    codes = torch.arange(16, dtype=torch.int32, device="cuda")
    bits = (codes[:, None] >> torch.arange(4, dtype=torch.int32,
                                           device="cuda")) & 1
    check(torch.equal(lut.lut4_netlist(bits), lut.lut4_lookup(codes)),
          "core.lut: the Fig-4 netlist differs from the Fig-3 table")
    for label, n, m_bits, b in bitplane:
        rplan = reconfig.plan_reconfig(n, m_bits)
        x = _lanes(n, m_bits, b, gen)
        want = x.sum(0, dtype=torch.int32)
        got = ops.bitplane_add(x, m_bits)
        check(torch.equal(got, want),
              f"bitplane_add {label}: not the int32 sum")
        line = (f"[adder] bitplane_add {label} (N={n}, M={m_bits}, B={b}): "
                f"exact; plan_reconfig: {len(rplan.levels)} levels, "
                f"{rplan.total_modules} modules, {rplan.result_bits} result "
                f"bits, serial {rplan.serial_clocks} clocks vs "
                f"{rplan.latency_stages} stages")
        if (n, m_bits) == (16, 16):     # Fig 15 on the same lanes
            lanes = x.t().contiguous()              # core.moa's (B, N)
            del x
            carry_max = 0
            for i, chunk in enumerate(lanes.split(1 << 21)):
                res, st = core_moa.reconfigured_add(chunk, m_bits,
                                                    return_structure=True)
                ser, clocks = core_moa.serial_add(chunk, m_bits)
                part = want[i << 21:(i << 21) + chunk.shape[0]]
                check(torch.equal(res, part) and torch.equal(ser, part),
                      "core.moa reconfigured_add / serial_add: not the sum")
                carry_max = max(carry_max, int(st["carry_total"].max()))
                del res, st, ser
            check(carry_max <= n - 1 and clocks == m_bits + 1,
                  f"core.moa: carry {carry_max} > N - 1 or clocks {clocks}")
            # Lemma 3: serial units of one Fig-4 LUT each against the
            # reconfigured adder's gate area, in the lanes' massively
            # parallel setting
            serial = planner.UnitSpec(area=lut.LUT_AREA_GATES,
                                      clocks_per_op=rplan.serial_clocks)
            parallel = planner.UnitSpec(area=rplan.gate_cost.area_gates,
                                        clocks_per_op=rplan.latency_stages)
            wins = planner.serial_beats_parallel(serial, parallel)
            line += (f"; core.moa reconfigured_add and serial_add equal it "
                     f"(max carry {carry_max} <= {n - 1}, {clocks} clocks); "
                     f"Lemma 3, serial LUT units ({lut.LUT_AREA_GATES} gates, "
                     f"{rplan.serial_clocks} clocks) beat the reconfigured "
                     f"adder ({rplan.gate_cost.area_gates:.0f} gates, "
                     f"{rplan.latency_stages} stages) in equal area: {wins}")
            del lanes
        print(line)
        del got, want
    for label, m, k, n in matmul + [("down_all_-128", matmul[1][1],
                                     matmul[1][2], matmul[1][3])]:
        if label.endswith("-128"):
            x = torch.full((m, k), -128, dtype=torch.int8, device="cuda")
            w = torch.full((k, n), -128, dtype=torch.int8, device="cuda")
        else:
            x, w = _int8((m, k), gen), _int8((k, n), gen)
        plan = qmm.k_plan(k)
        got = ops.quant_matmul(x, w)
        want = ref.quant_matmul_ref(x, w)
        check(torch.equal(got, want), f"quant_matmul {label}: not exact")
        if label.endswith("-128"):
            check(bool((got == k * 128 * 128).all()),
                  f"quant_matmul {label}: not {k} * 2^14 everywhere")
        print(f"[adder] quant_matmul {label} ({m}, {k}) @ ({k}, {n}): exact "
              f"(float64 oracle); plan block {plan.block}, "
              f"{plan.num_blocks} block(s), max_block {plan.max_block}")
        del x, w, got, want
    counts = {"bitplane_add": bpa.LAUNCHES, "quant_matmul": qmm.LAUNCHES}
    want = {"bitplane_add": len(bitplane), "quant_matmul": len(matmul) + 1}
    check(counts == want, f"adder path: launches {counts}, expected {want}")
    print(f"[adder] launches on the adder path: {counts}")
    return counts


def phase_adder_timing(bitplane, matmul):
    """Device times at the path shapes beside the bound, the plain version
    and the library call."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = {"bitplane_add": [], "quant_matmul": []}
    for label, n, m_bits, b in bitplane:
        x = _lanes(n, m_bits, b, gen)
        kernel = device_ms(lambda: bpa.bitplane_add_cuda(x, m_bits), 20)
        plain = device_ms(lambda: bpa.bitplane_add_plain(x, m_bits), 3)
        library = device_ms(lambda: torch.sum(x, 0, dtype=torch.int32), 20)
        nbytes = bpa.bound_bytes(n, b)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = (n - 1) * b / INT32_OPS_PER_S * 1e3
        per_lane = bpa.netlist_ops_per_lane(n, m_bits)
        alu = per_lane * b / INT32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        rows["bitplane_add"].append({
            "label": label, "shape": [n, m_bits, b], "ms": kernel,
            "plain_ms": plain, "library_ms": library, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "netlist_int_ops_per_lane": per_lane,
            "netlist_alu_ms": alu})
        print(f"[time] bitplane_add {label} N={n} M={m_bits} B={b}: kernel_ms "
              f"{kernel:.4f} bound_ms {bound:.4f} ({nbytes} B / 3.35 TB/s; "
              f"{n - 1} adds per lane {t_ops:.4f} ms) library_ms "
              f"{library:.4f} (torch.sum) plain_ms {plain:.4f} kernel/bound "
              f"{kernel / bound:.2f}; netlist {per_lane} int ops per lane = "
              f"{alu:.4f} ms at 16.7 Tops/s INT32")
        del x
    for label, m, k, n in matmul:
        x, w = _int8((m, k), gen), _int8((k, n), gen)
        kernel = device_ms(lambda: qmm.quant_matmul_cuda(x, w), 20)
        plain = device_ms(lambda: qmm.quant_matmul_plain(x, w), 5)
        library = device_ms(lambda: torch._int_mm(x, w), 20)
        # the same call on a column-major copy of w, for reference only
        wc = w.t().contiguous().t()
        library_col = device_ms(lambda: torch._int_mm(x, wc), 20)
        check(torch.equal(torch._int_mm(x, wc), qmm.quant_matmul_cuda(x, w)),
              f"torch._int_mm differs from the kernel at {label}")
        ops_ = qmm.bound_ops(m, k, n)
        nbytes = qmm.bound_bytes(m, k, n)
        t_ops = ops_ / INT8_OPS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        rows["quant_matmul"].append({
            "label": label, "shape": [m, k, n], "ms": kernel,
            "plain_ms": plain, "library_ms": library, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops_, "bytes": nbytes,
            "library_ms_w_column_major": library_col})
        print(f"[time] quant_matmul {label} ({m}, {k}) @ ({k}, {n}): "
              f"kernel_ms {kernel:.4f} (w transpose included) bound_ms "
              f"{bound:.4f} ({ops_:.4e} int8 ops / 1979 TOP/s; {nbytes} B / "
              f"3.35 TB/s = {t_bytes:.4f} ms) library_ms {library:.4f} "
              f"(torch._int_mm; {library_col:.4f} with w column-major) "
              f"plain_ms {plain:.4f} kernel/bound {kernel / bound:.2f}")
        del x, w, wc
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"[card] {card}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    full_cfg = get_config("llama3.2-3b")
    full_ecfg = EngineConfig(max_slots=4, max_seq=2048,
                             prefill_chunk=256).resolve()
    shapes = path_shapes(full_cfg, full_ecfg)
    err = phase_kernel_check(shapes)
    flash_err = phase_flash_check()
    phase_reduced_parity()
    launches = phase_full_width()
    rows = phase_timing(shapes)
    gc.collect()
    torch.cuda.empty_cache()       # the serve weights and KV pool go
    phase_train_parity()
    flash_launches = phase_train_full()
    gc.collect()
    torch.cuda.empty_cache()       # the train state goes
    flash_rows = phase_flash_timing()
    bitplane, matmul = adder_shapes(full_cfg)
    adder_err = phase_adder_check(bitplane, matmul)
    adder_launches = phase_adder_path(full_cfg, bitplane, matmul)
    adder_rows = phase_adder_timing(bitplane, matmul)

    main_row = next(r for r in rows if r["label"] == "prefill_o")
    source, replaces = KERNELS["moa_reduce"]
    kernels = [{
        "name": "moa_reduce", "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": "bytes",
        "library_ms": main_row["library_ms"], "shape": main_row["shape"],
        "checked": "torch.equal vs moa_reduce_plain", "shapes": rows}]
    source, replaces = KERNELS["flash_attention"]
    plain = {"fwd": "flash_attention_plain",
             "bwd_dq": "flash_attention_plain_bwd (dq, dk, dv together)",
             "bwd_dkv": "flash_attention_plain_bwd (dq, dk, dv together)"}
    library = {"fwd": "scaled_dot_product_attention forward",
               "bwd_dq": "scaled_dot_product_attention backward (dq, dk, "
                         "dv together)",
               "bwd_dkv": "scaled_dot_product_attention backward (dq, dk, "
                          "dv together)"}
    bound = {"fwd": "QK^T, PV",
             "bwd_dq": "dO V^T, dS K: 2 of the backward's 5 matmuls",
             "bwd_dkv": "QK^T, P^T dO, dS^T Q: 3 of the backward's 5 "
                        "matmuls"}
    for part in ("fwd", "bwd_dq", "bwd_dkv"):
        r = flash_rows[part]
        kernels.append({
            "name": f"flash_attention_{part}", "route": "cuda",
            "source": source, "replaces": replaces,
            "launches": flash_launches[part],
            "max_abs_err": flash_err[part]["path"],
            "max_abs_err_fp32": flash_err[part]["fp32"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": [TRAIN_BATCH, TRAIN_SEQ, 24, 8, 128], "dtype": "bf16",
            "plain": plain[part], "library": library[part],
            "bound": bound[part]})
    checked = {"bitplane_add": "torch.equal vs bitplane_add_plain",
               "quant_matmul": "torch.equal vs quant_matmul_plain"}
    for name in ("bitplane_add", "quant_matmul"):
        source, replaces = KERNELS[name]
        r = adder_rows[name][0]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": adder_launches[name],
            "max_abs_err": adder_err[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], "checked": checked[name],
            "shapes": adder_rows[name]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
