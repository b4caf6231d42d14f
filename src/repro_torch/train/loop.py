"""Training loop (counterpart of ``repro/train/loop.py``).

Wires together the deterministic data pipeline, the train step and the
heartbeat/straggler monitors.  Pure Python around the step, so every
policy here is unit-testable without a card.  Checkpointing
(``checkpoint/ckpt.py``) and restart from a checkpoint arrive with
``ROADMAP.md`` queue 1 item 11.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import HostDataConfig, host_batch
from repro_torch.ft.failures import (FailureEvent, HeartbeatMonitor,
                                     StragglerDetector)

__all__ = ["LoopConfig", "TrainLoop"]


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    heartbeat_timeout: float = 300.0
    straggler_factor: float = 1.5
    log_every: int = 10
    grad_accum: int = 1
    seed: int = 17


def _wait(t: Any) -> None:
    """Wait for the device that holds ``t`` (the JAX loop's
    ``block_until_ready``)."""
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.synchronize(t.device)


class TrainLoop:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 loop_cfg: LoopConfig, step_fn: Callable,
                 state: Dict[str, Any],
                 data_cfg: Optional[HostDataConfig] = None):
        if loop_cfg.ckpt_dir:
            raise NotImplementedError(
                "checkpointing (checkpoint/ckpt.py) arrives with ROADMAP.md "
                "queue 1 item 11")
        self.cfg = cfg
        self.shape = shape
        self.loop_cfg = loop_cfg
        self.step_fn = step_fn
        self.state = state
        self.data_cfg = data_cfg or HostDataConfig(loop_cfg.seed, 1, 0)
        self.hb = HeartbeatMonitor(self.data_cfg.num_hosts,
                                   loop_cfg.heartbeat_timeout)
        self.straggle = StragglerDetector(
            straggler_factor=loop_cfg.straggler_factor)
        self.metrics_log: List[Dict[str, float]] = []
        self.events: List[FailureEvent] = []

    def _batch_for(self, step: int) -> Dict[str, np.ndarray]:
        g = self.loop_cfg.grad_accum
        if g > 1:
            micros = [host_batch(self.cfg, self.shape, self.data_cfg,
                                 step * g + i) for i in range(g)]
            return {k: np.stack([m[k] for m in micros]) for k in micros[0]}
        return host_batch(self.cfg, self.shape, self.data_cfg, step)

    def run(self, start_step: int = 0) -> Dict[str, Any]:
        step = start_step
        while step < self.loop_cfg.total_steps:
            t0 = time.monotonic()
            batch = self._batch_for(step)
            self.state, metrics = self.step_fn(self.state, batch)
            _wait(metrics["loss"])
            dt = time.monotonic() - t0
            self.hb.beat(self.data_cfg.host_index)
            self.straggle.record(self.data_cfg.host_index, dt)
            self.events.extend(self.hb.check(step))
            self.events.extend(self.straggle.check(step))
            step += 1
            if step % self.loop_cfg.log_every == 0 or \
                    step == self.loop_cfg.total_steps:
                self.metrics_log.append(
                    {"step": step, "time_s": dt,
                     **{k: float(v) for k, v in metrics.items()}})
        return self.state
