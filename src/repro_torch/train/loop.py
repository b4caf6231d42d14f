"""Fault-tolerant training loop (counterpart of ``repro/train/loop.py``).

Wires together the deterministic data pipeline, the train step, async
checkpointing, the heartbeat/straggler monitors and restart from the
newest committed checkpoint.  Pure Python around the step, so every
policy here is unit-testable without a card.  Data is keyed by ``(seed,
step)``, so a run restored at step ``n`` sees the batches the run that
never stopped saw from step ``n`` on.

On a device mesh (``mesh`` and ``state_shardings``, the partition specs of
the state's blocks) every rank runs the loop: saves write each rank's
blocks into one checkpoint, and :meth:`TrainLoop.maybe_restore` reads the
rank's blocks under ``state_shardings``, whatever mesh saved them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, latest_step,
                                         restore_checkpoint)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import HostDataConfig, host_batch
from repro_torch.ft.failures import (FailureEvent, HeartbeatMonitor,
                                     StragglerDetector)

__all__ = ["LoopConfig", "TrainLoop", "run_training"]


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_ckpts: int = 3
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
                 data_cfg: Optional[HostDataConfig] = None,
                 state_shardings: Any = None, mesh=None):
        self.cfg = cfg
        self.shape = shape
        self.loop_cfg = loop_cfg
        self.step_fn = step_fn
        self.state = state
        self.state_shardings, self.mesh = state_shardings, mesh
        self.data_cfg = data_cfg or HostDataConfig(loop_cfg.seed, 1, 0)
        self.ckpt = (AsyncCheckpointer(loop_cfg.ckpt_dir, loop_cfg.keep_ckpts,
                                       mesh, state_shardings)
                     if loop_cfg.ckpt_dir else None)
        self.hb = HeartbeatMonitor(self.data_cfg.num_hosts,
                                   loop_cfg.heartbeat_timeout)
        self.straggle = StragglerDetector(
            straggler_factor=loop_cfg.straggler_factor)
        self.metrics_log: List[Dict[str, float]] = []
        self.events: List[FailureEvent] = []

    # -- restart support ------------------------------------------------------
    def maybe_restore(self) -> int:
        """Resume from the newest committed checkpoint; returns start step."""
        if not self.loop_cfg.ckpt_dir:
            return 0
        step = latest_step(self.loop_cfg.ckpt_dir)
        if step is None:
            return 0
        self.state = restore_checkpoint(self.loop_cfg.ckpt_dir, step,
                                        self.state,
                                        shardings=self.state_shardings,
                                        mesh=self.mesh)
        return step

    def _batch_for(self, step: int) -> Dict[str, np.ndarray]:
        g = self.loop_cfg.grad_accum
        if g > 1:
            micros = [host_batch(self.cfg, self.shape, self.data_cfg,
                                 step * g + i) for i in range(g)]
            return {k: np.stack([m[k] for m in micros]) for k in micros[0]}
        return host_batch(self.cfg, self.shape, self.data_cfg, step)

    # -- main -----------------------------------------------------------------
    def run(self, start_step: Optional[int] = None) -> Dict[str, Any]:
        """Steps from ``start_step`` (default: the restored step, or 0) to
        ``total_steps``; with a ``ckpt_dir``, a save every ``ckpt_every``
        steps and at the end (unless the last step was just saved), then
        ``wait()``."""
        step = self.maybe_restore() if start_step is None else start_step
        saved = None
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
            if self.ckpt and step % self.loop_cfg.ckpt_every == 0:
                self.ckpt.save(step, dict(self.state))
                saved = step
        if self.ckpt:
            if saved != self.loop_cfg.total_steps:
                self.ckpt.save(self.loop_cfg.total_steps, dict(self.state))
            self.ckpt.wait()
        return self.state


def run_training(cfg: ModelConfig, shape: ShapeConfig, loop_cfg: LoopConfig,
                 step_fn: Callable, state: Dict[str, Any], **kw):
    return TrainLoop(cfg, shape, loop_cfg, step_fn, state, **kw).run()
