"""Bursty open-loop traffic: seeded traces + a deterministic replay driver
(the port's copy of ``repro/tune/workloads.py``).

The serve benchmarks and the overload tests need traffic that *overloads*
the engine on purpose — and they need the overload to be reproducible, or
every SLO/shed/degrade assertion flakes with host noise.  Two pieces:

* **Trace builders** (:func:`bursty_trace`, :func:`multi_turn_trace`):
  pure ``numpy.random.Generator`` functions emitting :class:`Arrival`
  lists — Poisson arrivals whose rate square-waves between a base and a
  burst level, long-tail (lognormal) prompt/output lengths, optional
  per-request SLOs, optional conversation ids for multi-turn traffic.
  Same arguments and seed give the JAX package's trace, field for field.

* **A virtual-clock replay driver** (:func:`replay_open_loop`): replays a
  trace through a live :class:`~repro_torch.serve.ServeEngine`
  *open-loop* (arrivals do not wait for completions) on a **virtual
  clock**.  The scheduler's injectable ``clock`` is pointed at the
  driver's virtual time, which advances by a fixed :class:`VirtualCosts`
  price per prefill dispatch / decode step instead of wall time — so
  submission stamps, deadlines, SLO pressure, shed decisions and the
  degrade ladder's whole trajectory are bit-reproducible across hosts,
  runs and devices.  Real compute still happens on the engine's device
  (tokens are real); only *time* is simulated.  The driver re-feeds the
  scheduler's cost model with the same virtual prices after every step,
  overriding the engine's wall-clock EWMA.

Multi-turn arrivals (``conv_id`` set) are causally gated: a conversation's
next turn becomes eligible only ``think_s`` virtual seconds after its
previous turn finished — a user cannot type a follow-up before reading
the reply — while unrelated traffic keeps flowing in between.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serve.scheduler import DegradeLadder

__all__ = ["Arrival", "VirtualCosts", "bursty_trace", "multi_turn_trace",
           "replay_open_loop"]


@dataclass
class Arrival:
    """One request in an open-loop trace.

    Args:
      t: earliest submission time (virtual seconds from trace start).  For
        a conversation turn after the first, the effective eligibility is
        ``max(t, previous turn's finish + think_s)``.
      prompt: token ids (for a conversation turn: this turn's NEW tokens —
        the engine prepends the session history itself).
      max_new: generation budget.
      slo_ms: optional completion-latency SLO (virtual milliseconds).
      conv_id: conversation id for multi-turn traffic (``None`` = one-shot).
      think_s: virtual seconds the user "reads" before this turn becomes
        eligible, counted from the previous turn's completion.
    """

    t: float
    prompt: List[int]
    max_new: int
    slo_ms: Optional[float] = None
    conv_id: Optional[object] = None
    think_s: float = 0.0


@dataclass
class VirtualCosts:
    """Virtual prices the replay clock advances by (seconds per event).

    ``spec_step_s`` prices a speculative decode step separately — drafting
    plus a K+1-wide verify dispatch costs more wall time than a width-1
    step, and the degrade ladder's spec_off level only pays off if the
    clock knows that.
    """

    chunk_s: float = 0.010      #: one prefill-chunk dispatch
    step_s: float = 0.020       #: one width-1 batched decode step
    spec_step_s: float = 0.032  #: one speculative (draft + verify) step

    def __post_init__(self):
        if min(self.chunk_s, self.step_s, self.spec_step_s) <= 0.0:
            raise ValueError("virtual costs must be positive")


def _lognormal_lengths(rng, n: int, mean: float, sigma: float,
                       lo: int, hi: int) -> np.ndarray:
    """``n`` long-tail lengths with the requested arithmetic ``mean``
    (lognormal: mu is solved from mean and sigma), clipped to [lo, hi]."""
    mu = np.log(max(mean, 1.0)) - sigma ** 2 / 2.0
    return np.clip(np.round(rng.lognormal(mu, sigma, n)),
                   lo, hi).astype(int)


def bursty_trace(n: int, *, rate: float, burst_rate: Optional[float] = None,
                 burst_period_s: float = 4.0, burst_duty: float = 0.25,
                 mean_prompt: float = 24.0, mean_gen: float = 12.0,
                 sigma: float = 0.6, max_prompt: int = 96, max_gen: int = 64,
                 vocab: int = 97, slo_ms: Optional[float] = None,
                 seed: int = 0) -> List[Arrival]:
    """``n`` one-shot arrivals: Poisson with a square-wave rate, long-tail
    lognormal prompt/output lengths.

    The instantaneous arrival rate is ``burst_rate`` (default ``4 * rate``)
    for the first ``burst_duty`` fraction of every ``burst_period_s``
    window and ``rate`` otherwise — an on/off burst process whose peaks
    overload a fixed-capacity engine while the troughs let it recover,
    which is exactly the shape hysteresis is for.

    Args:
      n: number of arrivals.
      rate: base arrival rate (requests per virtual second, > 0).
      burst_rate: in-burst arrival rate (``None`` = ``4 * rate``).
      burst_period_s / burst_duty: burst cycle length and on-fraction
        (``burst_duty`` in (0, 1]; ``1.0`` = constant ``burst_rate``).
      mean_prompt / mean_gen: mean prompt / output lengths (the lognormal
        tail puts occasional much-longer requests on top).
      sigma: lognormal shape (0 = deterministic lengths).
      max_prompt / max_gen: hard length caps (keep ``max_prompt + max_gen``
        within the engine's ``max_seq``).
      vocab: token ids are drawn uniformly from ``[0, vocab)``.
      slo_ms: per-request SLO applied to every arrival (``None`` = no SLO
        anywhere — note the degrade ladder then sees zero pressure).
      seed: RNG seed; same arguments + seed = same trace, bit-for-bit.
    """
    if n <= 0:
        return []
    if rate <= 0.0:
        raise ValueError(f"rate must be > 0, got {rate}")
    if not 0.0 < burst_duty <= 1.0:
        raise ValueError(f"burst_duty must be in (0, 1], got {burst_duty}")
    burst_rate = 4.0 * rate if burst_rate is None else burst_rate
    rng = np.random.default_rng(seed)
    plens = _lognormal_lengths(rng, n, mean_prompt, sigma, 1, max_prompt)
    gens = _lognormal_lengths(rng, n, mean_gen, sigma, 1, max_gen)
    out: List[Arrival] = []
    t = 0.0
    for i in range(n):
        in_burst = (t % burst_period_s) < burst_duty * burst_period_s
        lam = burst_rate if in_burst else rate
        t += float(rng.exponential(1.0 / lam))
        prompt = rng.integers(0, vocab, int(plens[i])).tolist()
        out.append(Arrival(t=t, prompt=prompt, max_new=int(gens[i]),
                           slo_ms=slo_ms))
    return out


def multi_turn_trace(users: int, turns: int, *, turn_tokens: int = 12,
                     gen: int = 8, think_s: float = 0.5,
                     stagger_s: float = 0.1, vocab: int = 97,
                     slo_ms: Optional[float] = None,
                     seed: int = 0) -> List[Arrival]:
    """``users`` conversations of ``turns`` turns each.

    Every turn carries ``turn_tokens`` fresh tokens (the engine prepends
    the session history); turn k+1 becomes eligible ``think_s`` virtual
    seconds after turn k completes.  Conversation starts are staggered by
    ``stagger_s`` so sessions interleave instead of running back to back —
    the slot-churn regime session snapshots exist for.
    """
    rng = np.random.default_rng(seed)
    out: List[Arrival] = []
    for u in range(users):
        conv = f"user{u}"
        for k in range(turns):
            prompt = rng.integers(0, vocab, turn_tokens).tolist()
            out.append(Arrival(t=u * stagger_s if k == 0 else 0.0,
                               prompt=prompt, max_new=gen, slo_ms=slo_ms,
                               conv_id=conv,
                               think_s=0.0 if k == 0 else think_s))
    return out


def replay_open_loop(eng, trace: Sequence[Arrival],
                     costs: Optional[VirtualCosts] = None, *,
                     sampling=None, eos_id: Optional[int] = None,
                     max_steps: int = 100_000) -> Dict[str, object]:
    """Replay ``trace`` through ``eng`` open-loop on a virtual clock.

    The engine's scheduler clock is pointed at the driver's virtual time
    for the duration of the replay (and restored after), so every
    deadline, slack, pressure and shed decision is a pure function of the
    trace and ``costs`` — two replays of the same trace on the same
    engine config produce identical trajectories, on any host and on
    either device.

    Args:
      eng: a warmed or cold :class:`~repro_torch.serve.ServeEngine` on any
        device (the driver calls ``warmup()`` itself; first-use setup never
        enters the clock).
      trace: :class:`Arrival` list; entries with ``conv_id`` go through
        :meth:`~repro_torch.serve.ServeEngine.submit_turn` with causal
        gating, the rest through
        :meth:`~repro_torch.serve.ServeEngine.submit`.
      costs: virtual prices (default :class:`VirtualCosts`()).
      sampling: :class:`~repro_torch.serve.SamplingParams` applied to every
        request (``None`` = greedy).
      eos_id: optional stop token for every request.
      max_steps: hard bound on engine iterations (a driver bug must not
        hang a run).

    Returns:
      dict with ``outputs`` (per-trace-entry generated-token lists, shed
      entries empty), ``finished`` (the :class:`~repro_torch.serve.Request`
      objects, completion order), ``elapsed_s`` (virtual), ``steps``,
      ``goodput_tok_s``/``served_tok_s`` (virtual-time rates),
      ``slo_met``/``slo_missed``/``shed`` counts, and the engine's
      ``stats`` summary.
    """
    costs = costs or VirtualCosts()
    vt = [0.0]                      # mutable box the clock closure reads
    saved_clock = eng.scheduler.clock
    eng.scheduler.clock = lambda: vt[0]

    def feed():
        # deterministic cost model: virtual prices + the engine's *counted*
        # (not timed) tokens-per-step ratio
        s = eng.stats
        tps = (s["decode_tokens"] / s["decode_lane_steps"]
               if s["decode_lane_steps"] else 1.0)
        spec_next = eng.spec_k and not (
            eng.ladder is not None
            and eng.ladder.level >= DegradeLadder.SPEC_OFF)
        eng.scheduler.update_cost_model(
            chunk_s=costs.chunk_s,
            step_s=costs.spec_step_s if spec_next else costs.step_s,
            tokens_per_step=tps)

    oneshot: List[tuple] = sorted(
        [(a.t, i, a) for i, a in enumerate(trace) if a.conv_id is None])
    convs: Dict[object, Deque[tuple]] = {}
    for i, a in enumerate(trace):
        if a.conv_id is not None:
            convs.setdefault(a.conv_id, deque()).append((i, a))
    conv_live: Dict[object, object] = {}     # conv_id -> live Request
    conv_ready: Dict[object, float] = {c: q[0][1].t
                                       for c, q in convs.items()}
    rid_to_idx: Dict[int, int] = {}
    outputs: List[List[int]] = [[] for _ in trace]
    finished = []
    oi = 0
    steps = 0
    try:
        eng.warmup()
        while True:
            while oi < len(oneshot) and oneshot[oi][0] <= vt[0]:
                t, i, a = oneshot[oi]
                req = eng.submit(a.prompt, a.max_new, eos_id=eos_id,
                                 sampling=sampling, slo_ms=a.slo_ms)
                rid_to_idx[req.rid] = i
                oi += 1
            for conv, q in convs.items():
                if q and conv not in conv_live \
                        and conv_ready[conv] <= vt[0]:
                    i, a = q.popleft()
                    req = eng.submit_turn(conv, a.prompt, a.max_new,
                                          eos_id=eos_id, sampling=sampling,
                                          slo_ms=a.slo_ms)
                    rid_to_idx[req.rid] = i
                    conv_live[conv] = req
            if not eng.scheduler.has_work:
                nexts = []
                if oi < len(oneshot):
                    nexts.append(oneshot[oi][0])
                nexts.extend(conv_ready[c] for c, q in convs.items()
                             if q and c not in conv_live)
                if not nexts:
                    break
                vt[0] = max(vt[0], min(nexts))
                continue
            if steps >= max_steps:
                raise RuntimeError(
                    f"replay exceeded max_steps={max_steps} "
                    f"with work outstanding")
            before = dict(eng.stats)
            done = eng.step()
            steps += 1
            d = {k: eng.stats[k] - before[k]
                 for k in ("prefill_dispatches", "decode_steps",
                           "spec_steps")}
            vt[0] += (d["prefill_dispatches"] * costs.chunk_s
                      + d["spec_steps"] * costs.spec_step_s
                      + (d["decode_steps"] - d["spec_steps"])
                      * costs.step_s)
            feed()
            for req in done:
                finished.append(req)
                idx = rid_to_idx.get(req.rid)
                if idx is not None:
                    outputs[idx] = list(req.generated)
                conv = getattr(req, "_conv_id", None)
                if conv in conv_live \
                        and conv_live[conv].rid == req.rid:
                    del conv_live[conv]
                    if convs[conv]:
                        i, nxt = convs[conv][0]
                        conv_ready[conv] = max(nxt.t,
                                               vt[0] + nxt.think_s)
    finally:
        eng.scheduler.clock = saved_clock

    sched = eng.scheduler
    elapsed = max(vt[0], 1e-9)
    served = sum(len(r.generated) for r in finished)
    return {
        "outputs": outputs,
        "finished": finished,
        "elapsed_s": vt[0],
        "steps": steps,
        "served_tokens": served,
        "served_tok_s": served / elapsed,
        "goodput_tokens": sched.goodput_tokens,
        "goodput_tok_s": sched.goodput_tokens / elapsed,
        "slo_met": sched.slo_met_count,
        "slo_missed": sched.slo_missed_count,
        "shed": sched.shed_count,
        "stats": eng.stats_summary(),
    }
