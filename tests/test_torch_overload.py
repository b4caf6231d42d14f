"""The port's SLO scheduler, preemption and degrade ladder against the JAX
package.

``Scheduler`` (on a fake clock) and ``DegradeLadder`` run the scenarios of
the JAX package's own policy tests on both implementations and must return
the same values.  The engine runs the reduced ``llama3.2-3b`` config (fp32,
``n_kv_heads=2``) with the JAX engine's weights through EDF admission,
end-to-end preemption and a seeded burst replayed on one virtual-clock loop
(the scheduler's clock is the loop's time, and fixed prices are fed to the
cost model before every step, so every policy decision is a function of
the trace alone): tokens, shared counters, page tables and refcounts must
equal the JAX engine's."""
import math
import types

import numpy as np
import pytest

from repro.serve import scheduler as jsched
from repro.tune.workloads import bursty_trace
from repro_torch.serve import scheduler as tsched
from test_torch_prefix import _both, _model

MODULES = {"jax": jsched, "torch": tsched}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _sched(m, max_slots=2, max_seq=64, chunk=8, costs=(0.1, 0.01), **kw):
    clk = FakeClock()
    s = m.Scheduler(max_slots, max_seq, prefill_chunk=chunk, clock=clk, **kw)
    if costs:
        s.update_cost_model(chunk_s=costs[0], step_s=costs[1])
    return s, clk


def _idx(reqs, got):
    """Requests as indices into ``reqs`` (rids differ across packages)."""
    return [reqs.index(r) for r in got]


# scenarios of tests/test_serve.py:579-690 and tests/test_overload.py:39-170;
# each returns the observable values

def edf_then_fifo(m):
    s, _ = _sched(m, max_slots=1)
    R = m.Request
    reqs = [s.submit(R(prompt=[1] * 4, max_new=2, slo_ms=10_000)),
            s.submit(R(prompt=[2] * 4, max_new=2)),
            s.submit(R(prompt=[3] * 4, max_new=2, slo_ms=500)),
            s.submit(R(prompt=[4] * 4, max_new=2))]
    order = _idx(reqs, s.admission_order())
    (slot, req), = s.admissions()
    return [order, slot, reqs.index(req), _idx(reqs, s.pending)]


def fifo_without_slos(m):
    s, _ = _sched(m)
    reqs = [s.submit(m.Request(prompt=[i] * 3, max_new=2)) for i in range(3)]
    return [[(slot, reqs.index(r)) for slot, r in s.admissions()],
            s.free_slots()]


def slack_and_service(m):
    s, clk = _sched(m)
    req = s.submit(m.Request(prompt=[1] * 20, max_new=10, slo_ms=1000))
    out = [s.est_service_s(req), s.slack_s(req, now=0.0), s.deadline(req)]
    clk.t = 0.9
    free = s.submit(m.Request(prompt=[1] * 4, max_new=2))
    s.update_cost_model(tokens_per_step=0.5)
    return out + [s.slack_s(req), s.slack_s(free), s.deadline(free),
                  s.est_decode_s(7), s.est_decode_s(0)]


def eviction_candidate(m):
    out = []
    s, _ = _sched(m)
    tight = s.submit(m.Request(prompt=[1] * 8, max_new=4, slo_ms=600))
    loose = s.submit(m.Request(prompt=[2] * 8, max_new=4, slo_ms=60_000))
    s.admissions()
    s.on_prefill(tight, 5)
    s.on_prefill(loose, 5)
    out.append(s.eviction_candidate() == loose.slot)
    s2, _ = _sched(m)
    a = s2.submit(m.Request(prompt=[1] * 8, max_new=4, slo_ms=60_000))
    b = s2.submit(m.Request(prompt=[2] * 8, max_new=4))
    s2.admissions()
    s2.on_prefill(a, 5)
    s2.on_prefill(b, 5)
    out.append(s2.eviction_candidate() == b.slot)
    # tests/test_overload.py:152-170: the freed-pages tie-break
    s3, _ = _sched(m)
    a = s3.submit(m.Request(prompt=[1] * 8, max_new=4))
    b = s3.submit(m.Request(prompt=[2] * 8, max_new=4))
    s3.admissions()
    s3.on_prefill(a, 9)
    s3.on_prefill(b, 9)
    s3.freed_probe = lambda sl: 3 if sl == b.slot else 0
    out.append(s3.eviction_candidate() == b.slot)
    s3.freed_probe = lambda sl: 3 if sl == a.slot else 0
    out.append(s3.eviction_candidate() == a.slot)
    out.append(_sched(m)[0].eviction_candidate())
    return out


def reuse_probe(m):
    # tests/test_paged.py:394-412
    s = m.Scheduler(2, 64, prefill_chunk=8, clock=lambda: 0.0,
                    reuse_probe=lambda ctx: 16 if ctx[0] == 1 else 0)
    s.update_cost_model(chunk_s=0.1, step_s=0.01)
    shared = s.submit(m.Request(prompt=[1] * 16, max_new=4, slo_ms=5000))
    private = s.submit(m.Request(prompt=[2] * 16, max_new=4, slo_ms=5000))
    out = [s.est_service_s(shared), s.est_service_s(private)]
    s.admissions()
    s.on_prefill(shared, 9)
    s.on_prefill(private, 9)
    return out + [s.eviction_candidate() == shared.slot]


def preempt(m):
    out = []
    s, _ = _sched(m, max_slots=1)
    bg = s.submit(m.Request(prompt=[1] * 8, max_new=50))
    s.admissions()
    s.on_prefill(bg, 5)
    s.submit(m.Request(prompt=[2] * 4, max_new=2, slo_ms=200))
    out.append(s.maybe_preempt() == bg.slot)
    s2, _ = _sched(m, max_slots=1)
    bg2 = s2.submit(m.Request(prompt=[1] * 8, max_new=50))
    s2.admissions()
    s2.on_prefill(bg2, 5)
    s2.submit(m.Request(prompt=[2] * 4, max_new=2, slo_ms=60_000))
    out.append(s2.maybe_preempt())
    s3, clk3 = _sched(m, max_slots=1)
    bg3 = s3.submit(m.Request(prompt=[1] * 8, max_new=50))
    s3.admissions()
    s3.on_prefill(bg3, 5)
    s3.submit(m.Request(prompt=[2] * 4, max_new=2, slo_ms=100))
    clk3.t = 10.0
    out.append(s3.maybe_preempt())
    # a hopeless pending request must not shadow a savable one
    s4, clk4 = _sched(m, max_slots=1)
    bg4 = s4.submit(m.Request(prompt=[1] * 8, max_new=50))
    s4.admissions()
    s4.on_prefill(bg4, 5)
    hopeless = s4.submit(m.Request(prompt=[2] * 4, max_new=2, slo_ms=50))
    clk4.t = 1.0
    savable = s4.submit(m.Request(prompt=[3] * 4, max_new=2, slo_ms=200))
    out += [s4.slack_s(hopeless) < 0 <= s4.slack_s(savable),
            s4.maybe_preempt() == bg4.slot]
    victim = s4.maybe_preempt()
    req = s4.evict(victim)
    out += [req is bg4, req.slot, req.pos, s4.pending[0] is bg4]
    return out


def slo_accounting(m):
    s, clk = _sched(m, max_slots=1)
    met = s.submit(m.Request(prompt=[1, 2], max_new=1, slo_ms=1000))
    s.admissions()
    clk.t = 0.5
    s.on_prefill(met, 5)
    missed = s.submit(m.Request(prompt=[1, 2], max_new=1, slo_ms=100))
    s.admissions()
    clk.t = 5.0
    s.on_prefill(missed, 5)
    return [met.slo_met, missed.slo_met, s.slo_met_count,
            s.slo_missed_count, met.finish_t, missed.finish_t,
            s.goodput_tokens]


def pressure(m):
    s, clk = _sched(m, costs=None)
    out = [s.slo_pressure()]
    s.update_cost_model(chunk_s=0.1, step_s=0.1)
    safe = s.submit(m.Request(prompt=[1] * 8, max_new=2, slo_ms=60_000))
    s.submit(m.Request(prompt=[2] * 8, max_new=2, slo_ms=50))
    s.submit(m.Request(prompt=[3] * 8, max_new=2))
    out.append(s.slo_pressure())
    clk.t += 120.0
    return out + [s.slo_pressure(), s.slack_s(safe) < 0,
                  s.slo_pressure(now=0.0)]


def shed(m):
    s, clk = _sched(m, costs=(0.1, 0.1))
    R = m.Request
    live = s.submit(R(prompt=[1] * 8, max_new=2, slo_ms=10))
    s.admissions()
    doomed = s.submit(R(prompt=[2] * 8, max_new=2, slo_ms=50))
    ok = s.submit(R(prompt=[3] * 8, max_new=2, slo_ms=60_000))
    noslo = s.submit(R(prompt=[4] * 8, max_new=2))
    clk.t = 1.0
    reqs = [live, doomed, ok, noslo]
    got = s.shed_hopeless()
    return [_idx(reqs, got), doomed.shed_reason, doomed.slo_met,
            doomed.finish_t, doomed in s.finished, s.shed_count,
            s.slo_missed_count, _idx(reqs, s.pending),
            live.slot in s.active, s.shed_hopeless(),
            [r.shed_reason for r in s.shed_hopeless(now=100.0,
                                                     reason="x")]]


def goodput(m):
    s, clk = _sched(m)
    met = s.submit(m.Request(prompt=[1, 2], max_new=2, slo_ms=1000))
    noslo = s.submit(m.Request(prompt=[3, 4], max_new=2))
    s.admissions()
    miss = s.submit(m.Request(prompt=[5, 6], max_new=2, slo_ms=10))
    s.on_prefill(met, 7)
    s.on_prefill(noslo, 7)
    done = s.on_decode({met.slot: 8, noslo.slot: 8})
    clk.t = 5.0
    s.admissions()
    s.on_prefill(miss, 7)
    s.on_decode({miss.slot: 8})
    return [len(done), met.slo_met, miss.slo_met, noslo.slo_met,
            s.goodput_tokens, s.occupancy, s.has_work]


def submit_validation(m):
    s, _ = _sched(m, max_seq=8)
    out = []
    try:
        s.submit(m.Request(prompt=[1] * 8, max_new=2))
    except ValueError as e:
        out.append(str(e).split(": ", 1)[1])
    s2 = m.Scheduler.from_config(types.SimpleNamespace(
        max_slots=3, max_seq=40, prefill_chunk=16))
    out += [s2.max_slots, s2.max_seq, s2.prefill_chunk,
            s2.reuse_probe is None, s2.freed_probe is None]
    return out


def ladder_flat(m):
    lad = m.DegradeLadder(hi=0.5, lo=0.2, recover_steps=4)
    levels = [lad.observe(0.9) for _ in range(20)]
    return [levels, lad.transitions, lad.level_name, lad.steps_degraded]


def ladder_recovery(m):
    lad = m.DegradeLadder(hi=0.5, lo=0.2, recover_steps=3)
    seq = [1.0, 1.0, 0.0, 0.0, 0.3, 0.0, 0.0, 0.0, 0.1, 0.1, 0.1]
    return [[lad.observe(p) for p in seq], lad.transitions,
            lad.steps_degraded, lad.level_name]


def ladder_oscillating(m):
    lad = m.DegradeLadder(hi=0.5, lo=0.2, recover_steps=8)
    return [[lad.observe(p) for p in [0.9, 0.1] * 12], lad.level,
            m.DegradeLadder.LEVEL_NAMES,
            (m.DegradeLadder.NORMAL, m.DegradeLadder.SPEC_OFF,
             m.DegradeLadder.SMALL_CHUNKS, m.DegradeLadder.SHED)]


def ladder_validation(m):
    out = []
    for kw in (dict(hi=0.2, lo=0.5), dict(recover_steps=0),
               dict(hi=1.5), dict(lo=-0.1)):
        try:
            m.DegradeLadder(**kw)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


SCENARIOS = [edf_then_fifo, fifo_without_slos, slack_and_service,
             eviction_candidate, reuse_probe, preempt, slo_accounting,
             pressure, shed, goodput, submit_validation, ladder_flat,
             ladder_recovery, ladder_oscillating, ladder_validation]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_policy_matches_reference(scenario):
    want = scenario(MODULES["jax"])
    got = scenario(MODULES["torch"])
    assert got == want
    assert want                               # the scenario observed values


# ---------------------------------------------------------------------------
# the engine against the JAX engine, on a virtual clock
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    return _model(seed=4)


CHUNK_S, STEP_S = 0.010, 0.020


def replay(eng, trace, chunk_s=CHUNK_S, step_s=STEP_S, max_steps=2000):
    """Serve ``trace`` (arrivals with ``t``, ``prompt``, ``max_new``,
    ``slo_ms``) open-loop on a virtual clock: the scheduler reads the
    loop's time, the cost model gets the fixed prices before every step,
    and time advances by those prices per prefill dispatch and decode
    step.  Returns the requests in trace order (a shed one has no
    tokens)."""
    vt = [0.0]
    eng.scheduler.clock = lambda: vt[0]
    order = sorted(range(len(trace)), key=lambda i: trace[i].t)
    reqs = [None] * len(trace)
    nxt = 0
    for _ in range(max_steps):
        while nxt < len(order) and trace[order[nxt]].t <= vt[0]:
            a = trace[order[nxt]]
            reqs[order[nxt]] = eng.submit(a.prompt, a.max_new,
                                          slo_ms=a.slo_ms)
            nxt += 1
        if not eng.scheduler.has_work:
            if nxt == len(order):
                return reqs
            vt[0] = trace[order[nxt]].t
            continue
        eng.scheduler.update_cost_model(chunk_s=chunk_s, step_s=step_s,
                                        tokens_per_step=1.0)
        before = (eng.stats["prefill_dispatches"], eng.stats["decode_steps"])
        eng.step()
        vt[0] += ((eng.stats["prefill_dispatches"] - before[0]) * chunk_s
                  + (eng.stats["decode_steps"] - before[1]) * step_s)
    raise RuntimeError("replay did not drain")


def test_edf_admission_matches_reference(model):
    """One slot, requests with and without SLOs queued at once: the
    earliest deadline goes first, then FIFO; every request is served."""
    vocab = model[0].vocab
    rng = np.random.default_rng(31)
    slos = [None, 9_000.0, 3_000.0, None, 6_000.0]
    trace = [types.SimpleNamespace(t=0.0, prompt=rng.integers(
        0, vocab, (int(n),)).tolist(), max_new=3, slo_ms=slo)
        for n, slo in zip(rng.integers(5, 20, len(slos)), slos)]
    done = []

    def drive(eng):
        reqs = replay(eng, trace)
        done.append([reqs.index(r) for r in eng.scheduler.finished])
        return reqs

    _, teng, _, _ = _both(model, drive, max_slots=1, max_seq=48,
                          prefill_chunk=8, prefix_cache=False)
    assert done[0] == done[1] == [2, 4, 1, 0, 3]
    assert teng.stats_summary()["slo_met"] == 3


def test_preemption_end_to_end_matches_reference(model):
    """An urgent SLO'd request preempts a no-SLO request mid-decode; the
    victim resumes (re-prefilling its context: the urgent request took its
    slot and overwrote its row) and both finish with their whole
    budgets."""
    vocab = model[0].vocab
    rng = np.random.default_rng(13)
    bg_prompt, urgent_prompt = (rng.integers(0, vocab, (n,)).tolist()
                                for n in (10, 4))

    def drive(eng):
        sched = eng.scheduler
        sched.clock = lambda: 0.0

        def step():
            sched.update_cost_model(chunk_s=CHUNK_S, step_s=STEP_S,
                                    tokens_per_step=1.0)
            eng.step()

        bg = eng.submit(bg_prompt, 30)
        step()
        step()
        urgent = eng.submit(urgent_prompt, 2)
        # met if admitted now, missed after bg's remaining decode
        sched.update_cost_model(chunk_s=CHUNK_S, step_s=STEP_S)
        urgent.slo_ms = (sched.est_service_s(urgent)
                         + 0.5 * sched.est_decode_s(bg.remaining)) * 1e3
        while sched.has_work:
            step()
        return [bg, urgent]

    _, teng, _, treqs = _both(model, drive, max_slots=1, max_seq=64,
                              prefill_chunk=8)
    bg, urgent = treqs
    assert len(bg.generated) == 30 and len(urgent.generated) == 2
    st = teng.stats_summary()
    assert st["preemptions"] == st["evictions"] == 1
    assert st["admissions"] == 3 and st["slo_met"] == 1
    assert st["prefix_evictions"] == 2 and st["prefix_hits"] == 0


@pytest.mark.parametrize("degrade", [False, True])
def test_burst_replay_matches_reference(model, degrade):
    """A seeded burst with SLOs on one virtual-clock loop: with the ladder
    it climbs to shedding, sheds only pending requests (each with a reason
    and no tokens), and every served request matches the JAX engine."""
    vocab = model[0].vocab
    trace = bursty_trace(18, rate=2.0, burst_rate=30.0, mean_prompt=16,
                         mean_gen=8, max_prompt=40, max_gen=16, vocab=vocab,
                         slo_ms=300.0, seed=11)
    _, teng, _, treqs = _both(model, lambda eng: replay(eng, trace),
                              max_slots=2, max_seq=96, prefill_chunk=16,
                              degrade=degrade)
    st = teng.stats_summary()
    shed = [r for r in treqs if r.shed_reason is not None]
    assert len(shed) == st["shed_requests"]
    assert all(not r.generated and r.slo_met is False for r in shed)
    assert all(len(r.generated) == r.max_new for r in treqs
               if r.shed_reason is None)
    assert st["slo_met"] + st["slo_missed"] == len(trace)
    assert st["preemptions"] >= 1
    if degrade:
        assert st["degrade_transitions"] >= 3 and st["degrade_steps"] >= 1
        assert st["shed_requests"] >= 1
    else:
        assert st["shed_requests"] == 0 and st["degrade_steps"] == 0
    assert math.isfinite(st["goodput_tok_s"])
