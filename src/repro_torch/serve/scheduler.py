"""Continuous-batching scheduler: admit / decode / retire / evict, SLO-aware.

The counterpart of ``repro/serve/scheduler.py``, pure host-side Python.
The engine asks three questions every step:

1. ``admissions()`` — which pending requests go into which free slots now
   (chunked prefill happens per admission);
2. after the batched decode step, ``on_decode(tokens)`` — append one token
   to every live request, retire the finished ones, free their slots;
3. ``has_work`` — is anything pending or live.

A slot freed by a finished request is refilled on the next
``admissions()`` call while the other slots keep decoding.  ``evict()``
puts a live request back at the head of the queue; its re-admission
re-prefills (or prefix-reuses) prompt + generated tokens.

**SLO-aware admission**: a request may carry a latency SLO (``slo_ms``,
from submission to completion).  An engine-fed cost model — per-chunk
prefill time and per-step decode time — prices each request's remaining
service; admission runs earliest deadline first among SLO'd requests, then
no-SLO requests in FIFO order.  ``maybe_preempt()`` evicts a live request
only when that rescues an at-risk pending one and the victim still meets
its own SLO.  Under overload, ``shed_hopeless()`` retires pending requests
whose SLO is already unattainable, and :class:`DegradeLadder` decides which
knob the engine gives up next.  Under speculative decode the engine feeds
each slot's expected tokens per step (:attr:`Scheduler.slot_tokens_per_step`),
and a live request's decode is priced at its own rate.  On a mesh-sharded
engine (``mesh_shards > 1``) admission fills the shards' free slots
interleaved, least-loaded shard first (:meth:`Scheduler.free_slots`).
"""
from __future__ import annotations

import itertools
import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.serve.sampling import SamplingParams

__all__ = ["Request", "Scheduler", "DegradeLadder"]

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
      slo_ms: optional completion-latency SLO in milliseconds, measured
        from submission; drives admission order and eviction choice.
    """

    prompt: Sequence[int]
    max_new: int
    rid: int = field(default_factory=lambda: next(_rid_counter))
    eos_id: Optional[int] = None
    sampling: Optional[SamplingParams] = None
    slo_ms: Optional[float] = None

    # runtime state (owned by the scheduler/engine)
    generated: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    pos: int = 0                # tokens currently in the slot's cache
    submit_t: Optional[float] = None
    finish_t: Optional[float] = None
    slo_met: Optional[bool] = None
    #: why the scheduler shed this request instead of serving it (``None``
    #: for every served request); a shed request lands in ``finished``
    #: like any other, never silently dropped
    shed_reason: Optional[str] = None

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
    """Slot scheduler over a shared decode batch, with an SLO admission tier.

    Args:
      max_slots: decode batch width (concurrent requests).
      max_seq: per-slot cache capacity (context + generated tokens).
      prefill_chunk: the engine's max prefill-dispatch size; the cost model
        prices a (re-)prefill in dispatches of this size.
      mesh_shards: shards the slot batch splits into (1 = one device);
        admission balances live load across them.
      clock: monotonic time source (injectable: tests and replays drive a
        virtual clock).
      reuse_probe: optional callable mapping a context to the number of its
        leading tokens already resident in some slot's pages (the engine
        wires it to the prefix trie); the cost model prices only the rest.
    """

    def __init__(self, max_slots: int, max_seq: int, *,
                 prefill_chunk: int = 32, mesh_shards: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 reuse_probe: Optional[Callable[[Sequence[int]], int]] = None):
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.prefill_chunk = max(1, prefill_chunk)
        #: shards the slot batch splits into (1 = one device)
        self.mesh_shards = max(1, mesh_shards)
        self.slots_per_shard = max_slots // self.mesh_shards
        self.clock = clock
        self.reuse_probe = reuse_probe
        self.pending: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}
        self.finished: List[Request] = []
        # engine-fed cost model (0 = unknown yet)
        self.est_chunk_s: float = 0.0
        self.est_step_s: float = 0.0
        #: mean tokens one decode step emits per live slot (1.0 for
        #: sequential decode, more under speculative decode)
        self.est_tokens_per_step: float = 1.0
        #: engine-fed expected tokens per step of each live slot (its own
        #: accept-rate estimate under speculative decode); a slot missing
        #: here is priced at the batch mean ``est_tokens_per_step``
        self.slot_tokens_per_step: Dict[int, float] = {}
        self.slo_met_count = 0
        self.slo_missed_count = 0
        #: requests retired unserved by :meth:`shed_hopeless`
        self.shed_count = 0
        #: tokens of retired requests that did NOT miss their SLO (met it,
        #: or carried none) — the numerator of goodput
        self.goodput_tokens = 0
        #: optional engine-fed probe: how many physical pages releasing a
        #: live slot's row would actually free (shared pages free nothing);
        #: eviction tie-breaks consult it
        self.freed_probe: Optional[Callable[[int], int]] = None

    @classmethod
    def from_config(cls, config, *,
                    clock: Callable[[], float] = time.monotonic,
                    reuse_probe: Optional[Callable[[Sequence[int]], int]]
                    = None) -> "Scheduler":
        """A scheduler from a validated :class:`EngineConfig`
        (``max_slots``, ``max_seq``, ``prefill_chunk``, ``mesh_shards``);
        ``clock`` and ``reuse_probe`` pass through."""
        return cls(config.max_slots, config.max_seq,
                   prefill_chunk=config.prefill_chunk,
                   mesh_shards=getattr(config, "mesh_shards", 1),
                   clock=clock,
                   reuse_probe=reuse_probe)

    # ----------------------------------------------------------- cost model
    def update_cost_model(self, chunk_s: Optional[float] = None,
                          step_s: Optional[float] = None,
                          tokens_per_step: Optional[float] = None) -> None:
        """Feed service times: ``chunk_s`` for one prefill-chunk dispatch,
        ``step_s`` for one batched decode step, ``tokens_per_step`` for
        the tokens one step emits per live slot.  ``None`` leaves a value
        unchanged."""
        if chunk_s is not None:
            self.est_chunk_s = float(chunk_s)
        if step_s is not None:
            self.est_step_s = float(step_s)
        if tokens_per_step is not None:
            self.est_tokens_per_step = max(1.0, float(tokens_per_step))

    def est_decode_s(self, n_tokens: int,
                     tokens_per_step: Optional[float] = None) -> float:
        """Estimated time to decode ``n_tokens`` for one request: the steps
        needed at the tokens-per-step rate (``tokens_per_step`` overrides
        the batch mean: a live slot's own rate), each one batched-step
        time."""
        if n_tokens <= 0:
            return 0.0
        rate = (self.est_tokens_per_step if tokens_per_step is None
                else max(1.0, float(tokens_per_step)))
        return math.ceil(n_tokens / rate) * self.est_step_s

    def est_service_s(self, req: Request) -> float:
        """Estimated remaining service time of ``req`` if admitted now:
        chunked prefill of its context (less the resident prefix the
        ``reuse_probe`` reports) plus its remaining decode budget, at its
        slot's own rate when :attr:`slot_tokens_per_step` has one; 0 while
        the model is cold."""
        ctx_len = max(1, len(req.context))
        to_prefill = ctx_len
        if self.reuse_probe is not None:
            to_prefill = max(1, ctx_len - int(self.reuse_probe(req.context)))
        chunks = math.ceil(to_prefill / self.prefill_chunk)
        rate = (self.slot_tokens_per_step.get(req.slot)
                if req.slot is not None else None)
        return chunks * self.est_chunk_s \
            + self.est_decode_s(req.remaining, rate)

    def deadline(self, req: Request) -> Optional[float]:
        """Absolute completion deadline of ``req`` on the scheduler clock,
        or ``None`` without an SLO."""
        if req.slo_ms is None or req.submit_t is None:
            return None
        return req.submit_t + req.slo_ms / 1e3

    def slack_s(self, req: Request, now: Optional[float] = None) -> float:
        """Seconds to spare at ``now`` if ``req``'s remaining service
        started immediately (+inf without an SLO; negative means the SLO is
        already unattainable)."""
        dl = self.deadline(req)
        if dl is None:
            return math.inf
        if now is None:
            now = self.clock()
        return dl - now - self.est_service_s(req)

    # -------------------------------------------------------------- submit
    def submit(self, req: Request) -> Request:
        """Queue ``req`` (its context plus one generated token must fit
        ``max_seq``) and stamp its submission time; returns it."""
        if len(req.context) + 1 > self.max_seq:
            raise ValueError(
                f"request {req.rid}: context {len(req.context)} + 1 token "
                f"exceeds max_seq={self.max_seq}")
        if req.submit_t is None:
            req.submit_t = self.clock()
        self.pending.append(req)
        return req

    # ---------------------------------------------------------- admissions
    def shard_of_slot(self, slot: int) -> int:
        """The mesh shard holding ``slot`` (0 on a one-device engine)."""
        return slot // self.slots_per_shard

    def shard_loads(self) -> List[int]:
        """Live requests per mesh shard (``[len(active)]`` on a
        one-device engine)."""
        loads = [0] * self.mesh_shards
        for s in self.active:
            loads[self.shard_of_slot(s)] += 1
        return loads

    def free_slots(self) -> List[int]:
        """Slots not bound to a live request, in the order admission
        fills them: ascending on one device; on a sharded engine the
        shards interleaved, least-loaded first (every shard's k-th free
        slot before any shard's (k+1)-th), so consecutive admissions land
        on different shards and their loads stay balanced."""
        free = [s for s in range(self.max_slots) if s not in self.active]
        if self.mesh_shards > 1:
            loads = self.shard_loads()
            rank: Dict[int, int] = {}
            keys = {}
            for s in free:
                sh = self.shard_of_slot(s)
                keys[s] = (rank.get(sh, 0), loads[sh], sh)
                rank[sh] = rank.get(sh, 0) + 1
            free.sort(key=lambda s: keys[s])
        return free

    def admission_order(self) -> List[Request]:
        """Pending requests in policy order: earliest deadline first for
        SLO'd requests, then no-SLO requests FIFO (a stable sort, so with
        no SLOs this is FIFO, and an evicted request re-queued at the
        front keeps its priority)."""
        return sorted(self.pending,
                      key=lambda r: (self.deadline(r) is None,
                                     self.deadline(r) or 0.0))

    def admissions(self) -> List[Tuple[int, Request]]:
        """Pair waiting requests with free slots in policy order.  The
        caller prefills; each request is then live in its slot."""
        pairs = []
        for slot, req in zip(self.free_slots(), self.admission_order()):
            req.slot = slot
            req.pos = 0
            self.active[slot] = req
            pairs.append((slot, req))
        if pairs:
            admitted = {req.rid for _, req in pairs}
            self.pending = deque(r for r in self.pending
                                 if r.rid not in admitted)
        return pairs

    # -------------------------------------------------------------- decode
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
        return self.on_decode_tokens({s: [t] for s, t in tokens.items()})

    def on_decode_tokens(self, tokens: Dict[int, Sequence[int]]
                         ) -> List[Request]:
        """Advance every live slot by the 1..K+1 tokens one (speculative)
        decode step emitted for it; returns the requests that finished.
        Appending stops at retirement (eos, budget, capacity): the engine
        already truncates there, and this keeps ``pos == len(context) - 1``
        if it did not."""
        done = []
        for slot, toks in tokens.items():
            req = self.active.get(slot)
            if req is None:
                continue
            for tok in toks:
                req.generated.append(int(tok))
                req.pos += 1
                if self._maybe_retire(req):
                    done.append(req)
                    break
        return done

    def _maybe_retire(self, req: Request) -> bool:
        # the next decode would write cache position req.pos; retire when
        # the cache is full instead
        if req.done or req.pos >= self.max_seq:
            if req.slot in self.active:
                del self.active[req.slot]
                self.slot_tokens_per_step.pop(req.slot, None)
            req.slot = None
            req.finish_t = self.clock()
            if req.slo_ms is not None and req.submit_t is not None:
                req.slo_met = ((req.finish_t - req.submit_t) * 1e3
                               <= req.slo_ms)
                if req.slo_met:
                    self.slo_met_count += 1
                else:
                    self.slo_missed_count += 1
            if req.slo_met is not False:
                self.goodput_tokens += len(req.generated)
            self.finished.append(req)
            return True
        return False

    # ---------------------------------------------------------------- shed
    def slo_pressure(self, now: Optional[float] = None) -> float:
        """Fraction of SLO'd work (pending + live) whose slack at ``now``
        is below one decode step — the degrade ladder's input; 0.0 with no
        SLO'd request anywhere."""
        if now is None:
            now = self.clock()
        slod = [r for r in itertools.chain(self.pending,
                                           self.active.values())
                if self.deadline(r) is not None]
        if not slod:
            return 0.0
        at_risk = sum(1 for r in slod
                      if self.slack_s(r, now) < self.est_step_s)
        return at_risk / len(slod)

    def shed_hopeless(self, now: Optional[float] = None,
                      reason: str = "overload: SLO unattainable"
                      ) -> List[Request]:
        """Retire with ``reason`` every *pending* request whose slack at
        ``now`` is negative even if admitted immediately: serving it spends
        a slot without earning goodput, and EDF would admit it first.  Each
        lands in ``finished`` as an SLO miss; live requests are never shed.
        Returns the shed requests."""
        if now is None:
            now = self.clock()
        doomed = [r for r in self.pending
                  if self.deadline(r) is not None
                  and self.slack_s(r, now) < 0.0]
        if not doomed:
            return []
        dropped = {r.rid for r in doomed}
        self.pending = deque(r for r in self.pending
                             if r.rid not in dropped)
        for req in doomed:
            req.shed_reason = reason
            req.finish_t = now
            req.slo_met = False
            self.slo_missed_count += 1
            self.shed_count += 1
            self.finished.append(req)
        return doomed

    # --------------------------------------------------------------- evict
    def evict(self, slot: int) -> Request:
        """Put the live request in ``slot`` back at the head of the queue;
        its re-admission re-prefills prompt + generated tokens."""
        req = self.active.pop(slot)
        self.slot_tokens_per_step.pop(slot, None)
        req.slot = None
        req.pos = 0
        self.pending.appendleft(req)
        return req

    def eviction_candidate(self, now: Optional[float] = None
                           ) -> Optional[int]:
        """The live slot whose request best survives a re-queue at
        ``now``: the largest post-requeue slack (no-SLO requests have
        infinite slack, so they go first); ties prefer the slot whose
        release frees the most pages (``freed_probe``), then the least
        generated progress.  ``None`` when nothing is live."""
        if not self.active:
            return None
        if now is None:
            now = self.clock()
        probe = self.freed_probe or (lambda s: 0)
        return max(self.active,
                   key=lambda s: (self.slack_s(self.active[s], now),
                                  probe(s),
                                  -len(self.active[s].generated)))

    def maybe_preempt(self, now: Optional[float] = None) -> Optional[int]:
        """The slot to evict so that an at-risk pending request is rescued,
        or ``None``.  Preempts only when every slot is busy, the most
        urgent still-savable pending request meets its SLO if admitted now
        but not after the earliest natural slot release, and the victim
        still meets its own SLO after the re-queue."""
        if not self.pending or len(self.active) < self.max_slots:
            return None
        if now is None:
            now = self.clock()
        # a request already past saving must not shadow one a preemption
        # could still rescue
        urgent = min((r for r in self.pending
                      if self.deadline(r) is not None
                      and self.slack_s(r, now) >= 0.0),
                     key=lambda r: self.slack_s(r, now), default=None)
        if urgent is None:
            return None
        est_wait = min((self.est_decode_s(
                            r.remaining, self.slot_tokens_per_step.get(s))
                        for s, r in self.active.items()), default=0.0)
        if self.slack_s(urgent, now) >= est_wait:
            return None                       # not at risk: waiting is fine
        victim = self.eviction_candidate(now)
        if victim is None:
            return None
        if self.slack_s(self.active[victim], now) < 0.0:
            return None                       # re-queue would break its SLO
        return victim

    # --------------------------------------------------------------- state
    @property
    def has_work(self) -> bool:
        """True while anything is pending or live."""
        return bool(self.pending or self.active)

    @property
    def occupancy(self) -> float:
        """Fraction of decode-batch slots currently live."""
        return len(self.active) / self.max_slots


class DegradeLadder:
    """Hysteretic overload controller: which knob to give up next.

    A host-side state machine with no clock of its own: the engine feeds it
    one :meth:`Scheduler.slo_pressure` observation per step, and it steps
    through four levels in a fixed order (the JAX engine's numbering):

    ======  ================  ==============================================
    level   name              engine effect
    ======  ================  ==============================================
    0       ``normal``        every knob at its configured value
    1       ``spec_off``      speculative decode suspended (chain mode
                              decodes sequentially; tree and auto modes
                              verify with no drafted node)
    2       ``small_chunks``  prefill dispatches capped at the smallest
                              shape bucket
    3       ``shed``          pending requests whose SLO is already
                              unattainable are retired with a reason
    ======  ================  ==============================================

    Pressure above ``hi`` steps up one level per observation (a sustained
    overload climbs 0 -> 3 and stays); stepping down takes
    ``recover_steps`` consecutive observations below ``lo``, and the calm
    count resets on any observation at or above ``lo``.
    """

    #: the levels, in the order the ladder gives things up
    NORMAL, SPEC_OFF, SMALL_CHUNKS, SHED = 0, 1, 2, 3
    LEVEL_NAMES = ("normal", "spec_off", "small_chunks", "shed")

    def __init__(self, *, hi: float = 0.5, lo: float = 0.2,
                 recover_steps: int = 8):
        """``hi``/``lo``: step-up / step-down pressure thresholds (``lo <
        hi``; the band between holds the level); ``recover_steps``: calm
        observations needed per step down."""
        if not 0.0 <= lo < hi <= 1.0:
            raise ValueError(
                f"need 0 <= lo < hi <= 1, got lo={lo}, hi={hi}")
        if recover_steps < 1:
            raise ValueError(
                f"recover_steps must be >= 1, got {recover_steps}")
        self.hi = hi
        self.lo = lo
        self.recover_steps = recover_steps
        self.level = self.NORMAL
        #: level changes in either direction
        self.transitions = 0
        #: observations spent at a degraded (non-normal) level
        self.steps_degraded = 0
        self._calm = 0

    @property
    def level_name(self) -> str:
        """Name of the current level."""
        return self.LEVEL_NAMES[self.level]

    def observe(self, pressure: float) -> int:
        """Feed one pressure sample in [0, 1]; returns the level for the
        engine step about to run."""
        if pressure > self.hi:
            self._calm = 0
            if self.level < self.SHED:
                self.level += 1
                self.transitions += 1
        elif pressure < self.lo:
            self._calm += 1
            if self._calm >= self.recover_steps \
                    and self.level > self.NORMAL:
                self.level -= 1
                self.transitions += 1
                self._calm = 0
        else:
            self._calm = 0
        if self.level:
            self.steps_degraded += 1
        return self.level
