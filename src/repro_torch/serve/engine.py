"""Chunked-prefill, continuous-batching serve engine over a paged KV pool.

The counterpart of ``repro/serve/engine.py`` for the slice the port serves:

* **Chunked prefill** — an admission ingests its prompt in pieces of at
  most ``prefill_chunk`` tokens, each padded to a power-of-two shape bucket
  (the JAX engine's pieces exactly: chunk shape changes float results, so
  parity needs the same cut).
* **Continuous batching** — a FIFO :class:`~repro_torch.serve.scheduler.Scheduler`
  admits requests into a fixed-width decode batch; every decode step
  advances all live slots at their own positions, and a finished slot is
  refilled by the next admission while the rest keep decoding.
* **Paged KV** — every slot maps its positions to physical pages of one
  pool through a page table; pages are allocated as writes reach them and
  freed at retirement.  Idle lanes point their whole row at scratch page
  0, which is re-zeroed after every admission.
* **Split-K page combine** — decode attention combines its pages through
  :func:`repro_torch.kernels.ops.moa_reduce`: on the card that is the
  hand-written Hopper kernel, twice per layer per dispatch.

Dispatch is eager PyTorch (the JAX engine compiles ahead of time); the
state tensors are updated in place.  Greedy sampling only.  Prefix cache,
sessions, speculative decode, quantized KV, SLO admission, preemption and
mesh sharding are still to port (``ROADMAP.md``, queue 1).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import moa_reduce as _moa
from repro_torch.models.registry import get_api
from repro_torch.serve import cache
from repro_torch.serve.config import EngineConfig
from repro_torch.serve.sampling import SamplingParams, greedy_tokens
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["ServeEngine"]


def _buckets(chunk: int, lo: int = 8) -> Tuple[int, ...]:
    """Power-of-two prefill shape buckets up to ``chunk`` (inclusive)."""
    out, b = [], lo
    while b < chunk:
        out.append(b)
        b *= 2
    out.append(chunk)
    return tuple(out)


class ServeEngine:
    """Continuous-batching engine over one dense GQA model's paged KV pool.

    Args:
      cfg: model config (its ``dtype`` is the compute and KV dtype).
      params: parameter dict in the JAX tree's layout, on ``device`` and in
        ``cfg.dtype`` (from :func:`repro_torch.models.common.init_params`
        or :func:`repro_torch.convert.params_from_numpy`).
      config: the engine knobs (default :class:`EngineConfig`).
      device: where the model runs; ``None`` is the card, and raises when
        there is no CUDA device.  Pass ``"cpu"`` for the plain PyTorch path.
    """

    def __init__(self, cfg: ModelConfig, params: dict, *,
                 config: Optional[EngineConfig] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        ecfg = (config or EngineConfig()).resolve()
        self.config = ecfg
        self.api = get_api(cfg)
        self.cfg = cfg
        self.params = params
        self.max_slots = ecfg.max_slots
        self.max_seq = ecfg.max_seq
        self.prefill_chunk = ecfg.prefill_chunk
        self.page_size = ecfg.page_size
        self.chunk_buckets = _buckets(ecfg.prefill_chunk)
        self.scheduler = Scheduler(ecfg.max_slots, ecfg.max_seq)
        self.max_pages = ecfg.max_seq // ecfg.page_size
        # one more physical page than allocatable: page 0 is scratch
        self.pool = cache.PagePool(ecfg.pool_pages + 1)
        specs = self.api.decode_state_specs(cfg, ecfg.max_slots, ecfg.max_seq)
        self.pspecs = cache.paged_state_specs(specs, ecfg.page_size,
                                              ecfg.pool_pages + 1)
        self.state = cache.state_zeros(self.pspecs, self.device)
        # per-slot page tables; 0 = the scratch page (unallocated)
        self.table = np.zeros((ecfg.max_slots, self.max_pages), np.int64)
        #: when True, every decode dispatch appends its live-lane fp32
        #: logits (a numpy array) to ``logit_trace``
        self.trace_logits = False
        self.logit_trace: List[np.ndarray] = []
        self.reset_stats()

    # ------------------------------------------------------------ stats
    def reset_stats(self) -> None:
        """Zero the engine counters and timers."""
        self.stats: Dict[str, float] = {
            "prefill_s": 0.0, "decode_s": 0.0,
            "prefill_tokens": 0, "decode_tokens": 0,
            "decode_steps": 0, "admissions": 0, "prefill_dispatches": 0,
            "oom_deferred": 0, "moa_reduce_launches": 0,
        }

    def stats_summary(self) -> Dict[str, float]:
        """The counters plus prefill and decode tok/s (token counts over
        the seconds spent in those dispatches, each ending in a
        device-to-host read of the sampled tokens)."""
        s = dict(self.stats)
        s["prefill_tok_s"] = s["prefill_tokens"] / max(s["prefill_s"], 1e-9)
        s["decode_tok_s"] = s["decode_tokens"] / max(s["decode_s"], 1e-9)
        s["pages_in_use"] = self.pool.used_count
        s["pool_pages"] = self.pool.num_pages - 1
        s["pool_bytes"] = cache.state_bytes(self.pspecs)
        return s

    # ----------------------------------------------------------- submit
    def submit(self, prompt: Sequence[int], max_new: int,
               eos_id: Optional[int] = None,
               sampling: Optional[SamplingParams] = None) -> Request:
        """Queue one generation request.

        Args:
          prompt: token ids to condition on.
          max_new: generation budget.
          eos_id: optional stop token.
          sampling: per-request :class:`SamplingParams` (``None`` = greedy;
            only greedy exists in the port so far).

        Returns:
          The live :class:`Request` handle (its ``generated`` list fills in
          as the engine runs)."""
        return self.scheduler.submit(
            Request(prompt=list(prompt), max_new=max_new, eos_id=eos_id,
                    sampling=sampling))

    # ----------------------------------------------- page-table management
    def _release_row(self, slot: int) -> None:
        """Drop ``slot``'s page-table row, dereferencing every mapped page."""
        row = self.table[slot]
        self.pool.deref_many(row[row != 0])
        self.table[slot] = 0

    def _ensure_pages(self, slot: int, start: int, end: int) -> bool:
        """Allocate physical pages covering positions ``[start, end)`` of
        ``slot``'s row, all or nothing; False when the pool is exhausted."""
        first = start // self.page_size
        last = min(-(-end // self.page_size), self.max_pages)
        need = first + np.flatnonzero(self.table[slot, first:last] == 0)
        if need.size:
            pages = self.pool.alloc_many(int(need.size))
            if pages is None:
                return False
            self.table[slot, need] = pages
        return True

    def _scrub_scratch(self) -> None:
        """Re-zero scratch page 0: an admission's bucket-padding and idle
        lanes' writes land there, and a masked lane reads it as ``0 * v``,
        which a NaN or inf would poison."""
        cache.zero_page(self.state, self.pspecs, 0)

    # ------------------------------------------------------------ admit
    def _pieces(self, ctx: Sequence[int]) -> List[Tuple[int, int, int]]:
        """The prefill pieces of ``ctx`` as ``(start, nvalid, bucket)``:
        at most ``prefill_chunk`` tokens each, padded to the smallest shape
        bucket, the tail bucket shrunk to the cache room (a padded block
        past ``max_seq`` would clamp onto earlier positions)."""
        pieces = []
        pos = 0
        while pos < len(ctx):
            n = min(self.prefill_chunk, len(ctx) - pos)
            cb = next(b for b in self.chunk_buckets if b >= n)
            pieces.append((pos, n, min(cb, self.max_seq - pos)))
            pos += n
        return pieces

    def _admit(self, slot: int, req: Request) -> List[Request]:
        """Admit ``req`` into ``slot``: allocate its pages through the
        padded prefill end, run the prefill pieces, sample the first token.
        An admission that finds the pool exhausted is deferred to the head
        of the queue, never dropped."""
        ctx = req.context
        pieces = self._pieces(ctx)
        prefill_end = max(start + cb for start, _, cb in pieces)
        self._release_row(slot)
        if not self._ensure_pages(slot, 0, prefill_end):
            self._release_row(slot)
            self.stats["oom_deferred"] += 1
            self.scheduler.evict(slot)
            if not self.scheduler.active and not self.pool.used_count:
                raise RuntimeError(
                    f"page pool ({self.pool.num_pages - 1} pages of "
                    f"{self.page_size} tokens) cannot hold a single request "
                    f"of {len(ctx)} context tokens")
            return []
        # every piece's inputs go to the device before the timer starts
        dev = self.device
        row = torch.as_tensor(self.table[slot][None], device=dev)
        batches = []
        for start, nvalid, cb in pieces:
            toks = np.zeros((1, cb), np.int64)
            toks[0, :nvalid] = ctx[start:start + nvalid]
            batches.append({"tokens": torch.as_tensor(toks, device=dev),
                            "index": torch.tensor(start, device=dev),
                            "nvalid": nvalid, "pages": row})
        launches0 = _moa.LAUNCHES
        t0 = time.perf_counter()
        for batch in batches:
            logits, self.state = self.api.prefill_chunk(
                self.params, self.state, batch, self.cfg)
        first = int(greedy_tokens(logits)[0])
        dt = time.perf_counter() - t0
        self.stats["moa_reduce_launches"] += _moa.LAUNCHES - launches0
        self.stats["prefill_s"] += dt
        self.stats["prefill_tokens"] += len(ctx)
        self.stats["prefill_dispatches"] += len(pieces)
        self.stats["admissions"] += 1
        self._scrub_scratch()
        self.scheduler.on_prefill(req, first)
        if req.slot is None:                   # retired on its first token
            self._release_row(slot)
            return [req]
        return []

    # ------------------------------------------------------------- step
    def _decode_once(self) -> List[Request]:
        """One batched decode step over every live slot (idle lanes run
        with token 0 at position 0 on an all-scratch row; their outputs are
        discarded)."""
        for slot, req in list(self.scheduler.active.items()):
            if not self._ensure_pages(slot, req.pos, req.pos + 1):
                self.scheduler.evict(slot)
                self._release_row(slot)
                self.stats["oom_deferred"] += 1
        if not self.scheduler.active:
            return []
        tokens = np.zeros((self.max_slots, 1), np.int64)
        positions = np.zeros((self.max_slots,), np.int64)
        disp = np.zeros((self.max_slots, self.max_pages), np.int64)
        live = list(self.scheduler.active)
        for slot in live:
            req = self.scheduler.active[slot]
            tokens[slot, 0] = req.generated[-1]
            positions[slot] = req.pos
            disp[slot] = self.table[slot]
        dev = self.device
        batch = {"tokens": torch.as_tensor(tokens, device=dev),
                 "index": torch.as_tensor(positions, device=dev),
                 "pages": torch.as_tensor(disp, device=dev)}
        launches0 = _moa.LAUNCHES
        t0 = time.perf_counter()
        logits, self.state = self.api.decode_step(self.params, self.state,
                                                  batch, self.cfg)
        nxt = greedy_tokens(logits).cpu().numpy()
        dt = time.perf_counter() - t0
        self.stats["moa_reduce_launches"] += _moa.LAUNCHES - launches0
        if self.trace_logits:
            self.logit_trace.append(logits[live].cpu().numpy())
        self.stats["decode_s"] += dt
        self.stats["decode_tokens"] += len(live)
        self.stats["decode_steps"] += 1
        done = self.scheduler.on_decode({s: int(nxt[s]) for s in live})
        for slot in live:
            if slot not in self.scheduler.active:
                self._release_row(slot)
        return done

    def step(self) -> List[Request]:
        """One engine iteration: refill free slots (chunked prefill per
        admission), then one batched decode step shared by all live slots.
        Returns the requests that finished during this iteration."""
        finished: List[Request] = []
        for slot, req in self.scheduler.admissions():
            finished += self._admit(slot, req)
        if self.scheduler.active:
            finished += self._decode_once()
        return finished

    def run(self, max_steps: Optional[int] = None) -> List[Request]:
        """Drain all submitted work; returns finished requests in
        completion order. ``max_steps`` bounds engine iterations."""
        finished: List[Request] = []
        steps = 0
        while self.scheduler.has_work:
            if max_steps is not None and steps >= max_steps:
                break
            finished += self.step()
            steps += 1
        return finished
