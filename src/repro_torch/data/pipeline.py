"""Deterministic synthetic data with per-host slices (``repro/data/pipeline.py``).

Each host materialises only its slice of the global batch, derived from
``(seed, step, row)``, so a restart, or a resize to another host count,
regenerates exactly the same global batch for a step.  numpy only: the
batches equal the JAX package's for the same ``(seed, step, row)``.  A
background ``Prefetcher`` thread keeps ``depth`` batches ready.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.inputs import batch_spec_shapes

__all__ = ["HostDataConfig", "host_batch", "global_batch", "Prefetcher"]


@dataclass(frozen=True)
class HostDataConfig:
    seed: int
    num_hosts: int
    host_index: int

    def slice_of(self, global_rows: int) -> Tuple[int, int]:
        per = global_rows // self.num_hosts
        if per * self.num_hosts != global_rows:
            raise ValueError(f"global batch {global_rows} must divide the "
                             f"host count {self.num_hosts}")
        return self.host_index * per, per


def _rows_rng(seed: int, step: int, row: int) -> np.random.Generator:
    # counter-based: every (step, row) has its own stream; host-independent
    return np.random.default_rng(np.random.SeedSequence((seed, step, row)))


def _synth_row(name: str, shape, dtype: torch.dtype, cfg: ModelConfig, rng):
    if name == "index":
        return None
    if not dtype.is_floating_point:
        # zipf-ish token stream (heavy head, like natural text)
        z = rng.zipf(1.3, size=shape)
        return np.minimum(z - 1, cfg.vocab - 1).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


def host_batch(cfg: ModelConfig, shape: ShapeConfig, data_cfg: HostDataConfig,
               step: int) -> Dict[str, np.ndarray]:
    """This host's slice of the global batch for ``step`` (row-deterministic:
    independent of the host count)."""
    out = {}
    for name, (shp, dtype) in batch_spec_shapes(cfg, shape).items():
        if name == "index":
            out[name] = np.asarray(step % shape.seq_len, np.int32)
            continue
        start, per = data_cfg.slice_of(shp[0])
        rows = [_synth_row(name, shp[1:], dtype, cfg,
                           _rows_rng(data_cfg.seed, step, r))
                for r in range(start, start + per)]
        arr = np.stack(rows)
        if name in ("labels", "tokens"):
            arr = arr.astype(np.int32)
        out[name] = arr
    return out


def global_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int, step: int
                 ) -> Dict[str, np.ndarray]:
    """Whole-batch view (the single-host path)."""
    return host_batch(cfg, shape, HostDataConfig(seed, 1, 0), step)


class Prefetcher:
    """Background-thread prefetch of this host's batches, in step order
    from ``start_step``.  A failure in the thread is raised by the
    ``next()`` that would have returned its batch; ``close()`` stops and
    joins the thread."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 data_cfg: HostDataConfig, start_step: int = 0,
                 depth: int = 2):
        self._cfg, self._shape, self._data = cfg, shape, data_cfg
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self) -> None:
        while not self._stop.is_set():
            try:
                item = host_batch(self._cfg, self._shape, self._data,
                                  self._step)
            except Exception as e:      # handed to the consumer
                item = e
            self._step += 1
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(item, Exception):
                return

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join()
