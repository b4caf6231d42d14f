"""Continuous-batching scheduler: the FIFO core of ``repro/serve/scheduler.py``.

Pure host-side Python.  The engine asks three questions every step:

1. ``admissions()`` — which pending requests go into which free slots now
   (chunked prefill happens per admission);
2. after the batched decode step, ``on_decode(tokens)`` — append one token
   to every live request, retire the finished ones, free their slots;
3. ``has_work`` — is anything pending or live.

A slot freed by a finished request is refilled on the next
``admissions()`` call while the other slots keep decoding.  ``evict()``
puts a live request back at the head of the queue; the engine uses it to
defer an admission or a decode step that finds the page pool exhausted.
SLO-aware admission, preemption and the degrade ladder are still to port
(``ROADMAP.md``, queue 1).
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.serve.sampling import SamplingParams

__all__ = ["Request", "Scheduler"]

_rid_counter = itertools.count()


@dataclass
class Request:
    """One generation request plus its runtime bookkeeping.

    Args:
      prompt: token ids to condition on.
      max_new: generation budget (tokens sampled after the prompt).
      rid: request id (auto-assigned, monotonic per process).
      eos_id: optional stop token — generation retires on sampling it.
      sampling: per-request :class:`SamplingParams` (``None`` = greedy).
    """

    prompt: Sequence[int]
    max_new: int
    rid: int = field(default_factory=lambda: next(_rid_counter))
    eos_id: Optional[int] = None
    sampling: Optional[SamplingParams] = None

    # runtime state (owned by the scheduler/engine)
    generated: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    pos: int = 0                # tokens currently in the slot's cache
    submit_t: Optional[float] = None
    finish_t: Optional[float] = None

    @property
    def context(self) -> List[int]:
        """Tokens to prefill on (re-)admission: prompt + already generated."""
        return list(self.prompt) + self.generated

    @property
    def remaining(self) -> int:
        """Tokens still to generate before hitting ``max_new``."""
        return self.max_new - len(self.generated)

    @property
    def done(self) -> bool:
        """True once ``eos_id`` was sampled or the budget is exhausted."""
        if self.generated and self.eos_id is not None \
                and self.generated[-1] == self.eos_id:
            return True
        return self.remaining <= 0


class Scheduler:
    """FIFO slot scheduler over a shared decode batch.

    Args:
      max_slots: decode batch width (concurrent requests).
      max_seq: per-slot cache capacity (context + generated tokens).
    """

    def __init__(self, max_slots: int, max_seq: int):
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.pending: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}
        self.finished: List[Request] = []

    def submit(self, req: Request) -> Request:
        """Queue ``req`` (its context plus one generated token must fit
        ``max_seq``) and stamp its submission time; returns it."""
        if len(req.context) + 1 > self.max_seq:
            raise ValueError(
                f"request {req.rid}: context {len(req.context)} + 1 token "
                f"exceeds max_seq={self.max_seq}")
        if req.submit_t is None:
            req.submit_t = time.monotonic()
        self.pending.append(req)
        return req

    def admissions(self) -> List[Tuple[int, Request]]:
        """Pair waiting requests with free slots, both in order (FIFO,
        ascending slots).  The caller prefills; each request is then live
        in its slot."""
        free = [s for s in range(self.max_slots) if s not in self.active]
        pairs = []
        for slot in free:
            if not self.pending:
                break
            req = self.pending.popleft()
            req.slot = slot
            req.pos = 0
            self.active[slot] = req
            pairs.append((slot, req))
        return pairs

    def on_prefill(self, req: Request, first_token: int) -> None:
        """Record ``req``'s prefill: its slot holds the context, and
        ``first_token`` was sampled from the prefill logits."""
        req.pos = len(req.context)
        req.generated.append(int(first_token))
        self._maybe_retire(req)

    def on_decode(self, tokens: Dict[int, int]) -> List[Request]:
        """Advance every live slot by its sampled token (``tokens`` maps
        slot -> token id); returns the requests that finished this step
        (their slots are free again)."""
        done = []
        for slot, tok in tokens.items():
            req = self.active.get(slot)
            if req is None:
                continue
            req.generated.append(int(tok))
            req.pos += 1
            if self._maybe_retire(req):
                done.append(req)
        return done

    def _maybe_retire(self, req: Request) -> bool:
        # the next decode would write cache position req.pos; retire when
        # the cache is full instead
        if req.done or req.pos >= self.max_seq:
            if req.slot in self.active:
                del self.active[req.slot]
            req.slot = None
            req.finish_t = time.monotonic()
            self.finished.append(req)
            return True
        return False

    def evict(self, slot: int) -> Request:
        """Put the live request in ``slot`` back at the head of the queue;
        its re-admission re-prefills prompt + generated tokens."""
        req = self.active.pop(slot)
        req.slot = None
        req.pos = 0
        self.pending.appendleft(req)
        return req

    @property
    def has_work(self) -> bool:
        """True while anything is pending or live."""
        return bool(self.pending or self.active)

    @property
    def occupancy(self) -> float:
        """Fraction of decode-batch slots currently live."""
        return len(self.active) / self.max_slots
