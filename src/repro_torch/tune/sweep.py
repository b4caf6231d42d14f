"""Knob-sweep runner: engines instantiated across an EngineConfig grid (the
port's copy of ``repro/tune/sweep.py``).

The serve engine's whole knob surface is one typed
:class:`~repro_torch.serve.EngineConfig`, so a tuning sweep is just a list
of configs: :class:`SweepSpec` materializes the cartesian product of a
``{field: candidate values}`` grid around a base config (optionally a
seeded random subset — random search beats grid search when only a few
knobs matter), and :func:`run_sweep` drives each point through the same
workload on a fresh engine, recording throughput / latency / memory
metrics per point.  Points whose config fails
:meth:`~repro_torch.serve.EngineConfig.resolve` (bad page divisor,
quantized pages without paging, ...) are recorded with an ``error`` string
instead of metrics — a sweep over a mixed-validity grid completes instead
of crashing.  Downstream, :mod:`repro_torch.tune.pareto` turns the records
into a Pareto front over any objective set.

Every engine is warmed up before requests are submitted, so recorded
throughput never includes first-use setup.  With ``profile_dir`` each
point's serve runs under ``torch.profiler`` (the CUDA activity too on the
card) and its Chrome trace lands in ``<profile_dir>/point<i:03d>/``.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import random
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.serve import EngineConfig, ServeEngine

__all__ = ["METRIC_KEYS", "SweepSpec", "run_sweep", "sweep_workload"]

# the metric keys every valid sweep record carries (pulled from
# ServeEngine.stats_summary) — the objective vocabulary for Pareto fronts
METRIC_KEYS = ("decode_tok_s", "prefill_tok_s", "decode_step_p50_s",
               "decode_step_p99_s", "pool_bytes", "kv_bytes_per_slot",
               "tokens_per_step", "mean_occupancy")

#: the Chrome trace's file name inside a point's trace directory
TRACE_FILE = "trace.json"


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A declarative sweep: ``base`` config + ``grid`` of per-field
    candidate values (field name -> sequence of values).  ``samples``
    (optional) caps the sweep at a seeded random subset of the full
    product — set it when the grid is combinatorially large; ``seed``
    makes the subset reproducible."""

    base: EngineConfig
    grid: Mapping[str, Sequence[Any]]
    samples: Optional[int] = None
    seed: int = 0

    def points(self) -> List[EngineConfig]:
        """Materialize the swept configs: the cartesian product of the
        grid applied over ``base`` via :meth:`EngineConfig.replace`, in
        deterministic (sorted-field, given-value) order, optionally
        subsampled to ``samples`` points with ``seed``."""
        keys = sorted(self.grid)
        combos = itertools.product(*(self.grid[k] for k in keys))
        pts = [self.base.replace(**dict(zip(keys, vals)))
               for vals in combos]
        if self.samples is not None and self.samples < len(pts):
            pts = random.Random(self.seed).sample(pts, self.samples)
        return pts


def sweep_workload(vocab: int, *, requests: int = 8,
                   shared_prefix: int = 24, tail: int = 6,
                   gen: int = 12, seed: int = 0) -> tuple:
    """The sweep's fixed benchmark traffic: ``requests`` prompts sharing
    one ``shared_prefix``-token system prompt plus unique ``tail``-token
    suffixes drawn from ``vocab``, each generating ``gen`` tokens
    (``seed`` fixes the streams).  Shared-prefix traffic exercises every
    swept subsystem at once — chunked prefill, the prefix cache, paged
    admission, and (self-similar continuations aside) speculative decode.
    Returns ``(prompts, gens)`` ready for :func:`run_sweep`."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, (shared_prefix,)).tolist()
    prompts = [system + rng.integers(0, vocab, (tail,)).tolist()
               for _ in range(requests)]
    return prompts, [gen] * requests


def _run_point(cfg, params, point, prompts, gens,
               device: Optional[Union[str, torch.device]] = None
               ) -> Dict[str, Any]:
    """One sweep measurement: build + warm an engine from ``point`` on
    ``device`` (``None`` is the card), serve the (``prompts``, ``gens``)
    workload on model ``cfg`` / ``params``, and return its metric
    record."""
    eng = ServeEngine(cfg, params, config=point, device=device)
    eng.warmup()
    reqs = [eng.submit(list(p), g) for p, g in zip(prompts, gens)]
    eng.run()
    assert all(len(r.generated) == g for r, g in zip(reqs, gens)), (
        "sweep point finished with incomplete generations")
    st = eng.stats_summary()
    return {"metrics": {k: st[k] for k in METRIC_KEYS},
            "resolved": eng.config.to_dict()}


def run_sweep(cfg, params, points: Sequence[EngineConfig], prompts,
              gens, *, profile_dir: Optional[str] = None,
              progress=None,
              device: Optional[Union[str, torch.device]] = None
              ) -> List[Dict[str, Any]]:
    """Drive every config in ``points`` through the same workload and
    return one record per point, in order.

    Args:
      cfg: model config; params: model parameters (on ``device``).
      points: the swept :class:`~repro_torch.serve.EngineConfig` list
        (e.g. from :meth:`SweepSpec.points`).
      prompts: list of token lists served at every point.
      gens: per-request generation lengths (int or list).
      profile_dir: when set, wrap each point's serve in a
        ``torch.profiler`` trace (CPU activity, and CUDA on the card)
        whose Chrome trace is written to
        ``<profile_dir>/point<i:03d>/trace.json`` (best-effort: profiler
        failures are recorded on the point as ``profile_error``, not
        raised, and the point is served again without it on the same
        device).
      progress: optional callable ``(index, record)`` invoked after each
        point — hook for live logging.
      device: ``None`` is the card (raises without one); ``"cpu"`` the
        plain PyTorch path.

    Returns:
      A list of dicts: ``{"config": <as-dict>}`` plus either
      ``"metrics"`` + ``"resolved"`` (the post-``resolve()`` config the
      engine actually ran) or ``"error"`` (the ``ValueError`` text for
      configs invalid on this model family); a profiled point adds
      ``"trace_dir"`` or ``"profile_error"``.
    """
    dev = resolve_device(device)
    if isinstance(gens, int):
        gens = [gens] * len(prompts)
    records: List[Dict[str, Any]] = []
    for i, point in enumerate(points):
        rec: Dict[str, Any] = {"config": point.to_dict()}
        try:
            point.resolve(cfg)
        except ValueError as err:
            rec["error"] = str(err)
            records.append(rec)
            if progress is not None:
                progress(i, rec)
            continue
        if profile_dir is not None:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if dev.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            trace_dir = os.path.join(profile_dir, f"point{i:03d}")
            try:
                with profile(activities=activities) as prof:
                    rec.update(_run_point(cfg, params, point, prompts,
                                          gens, dev))
                os.makedirs(trace_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(trace_dir,
                                                      TRACE_FILE))
                rec["trace_dir"] = trace_dir
            except Exception as err:  # profiler availability varies
                rec["profile_error"] = str(err)
                if "metrics" not in rec:  # tracing died before the run
                    rec.update(_run_point(cfg, params, point, prompts,
                                          gens, dev))
        else:
            rec.update(_run_point(cfg, params, point, prompts, gens, dev))
        records.append(rec)
        if progress is not None:
            progress(i, rec)
    return records
