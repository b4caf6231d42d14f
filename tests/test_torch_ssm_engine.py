"""The serve engine, the static-batch API and the CLIs on the SSM and hybrid
families, against the JAX package.

Reduced fp32 ``falcon-mamba-7b`` and the tailed ``zamba2-1.2b``
(``reduced(n_layers=5)``) on the JAX weights.  ``EngineConfig.resolve``
turns paging, speculation, prefix reuse and KV quantization off exactly as
``repro.serve.config`` does.  The contiguous engine (3 slots for 4
requests, so one slot is reused and idle lanes run) steps in lockstep with
the JAX engine, greedy and sampled (temperature 0.8, top-k 40): ``h``,
``conv``, ``k`` and ``v`` within 1e-5 after every step, the decode logits
within 1e-5, the tokens and every counter equal.  ``warmup()`` on an
engine with live requests changes no state leaf, no counter and no token
(an SSM's ``h`` and ``conv`` have no sequence axis: the warm-up must save
and restore them whole).  ``generate`` and ``serve_batch`` give the JAX
tokens; the serve and train CLIs run both families on the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.serve import EngineConfig as JConfig
from repro.serve import SamplingParams as JSampling
from repro.serve import ServeEngine as JEngine
from repro_torch.launch import serve as tserve
from repro_torch.serve import EngineConfig, SamplingParams, ServeEngine
from test_torch_prefix import SHARED_COUNTERS
from test_torch_spec_engine import SPEC_KEYS
from test_torch_ssm import close, ssm_model

ROOT = Path(__file__).resolve().parent.parent
#: the two families: Mamba-1, and the hybrid with a tail (5 = 2 x 2 + 1)
MODELS = {"falcon-mamba-7b": {}, "zamba2-1.2b": {"n_layers": 5}}
KNOBS = dict(max_slots=3, max_seq=48, prefill_chunk=8)


@pytest.fixture(scope="module", params=sorted(MODELS))
def fam(request):
    return ssm_model(request.param, **MODELS[request.param])


def _requests(vocab):
    rng = np.random.default_rng(17)
    lens, gens = (5, 11, 17, 3), (6, 9, 4, 7)
    return [rng.integers(0, vocab, n).tolist() for n in lens], list(gens)


def _sampling(kind, i, jax_side):
    if kind == "greedy" or i == 2:
        return None
    cls = JSampling if jax_side else SamplingParams
    return cls(temperature=0.8, top_k=40, seed=11 + i)


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_resolve_gates_equal_jax(arch):
    jcfg, tcfg = ssm_model(arch, **MODELS[arch])[:2]
    for knobs in (dict(), dict(spec_k=4, spec_mode="tree"),
                  dict(kv_dtype="int8", prefix_cache=True, page_size=16)):
        j = JConfig(**KNOBS, **knobs).resolve(jcfg)
        t = EngineConfig(**KNOBS, **knobs).resolve(tcfg)
        assert t.to_dict() == j.to_dict()
        assert (t.paged_kv, t.spec_k, t.spec_mode, t.prefix_cache,
                t.kv_dtype, t.page_dedup) == (False, 0, "chain", False,
                                              "fp32", False)
    with pytest.raises(ValueError, match="not pageable"):
        EngineConfig(paged_kv=True, page_size=16, **KNOBS).resolve(tcfg)


@pytest.mark.parametrize("kind", ["greedy", "sampled"])
def test_engine_lockstep_with_jax(fam, kind):
    jcfg, tcfg, jp, tp = fam
    jeng = JEngine(jcfg, jp, config=JConfig(**KNOBS))
    teng = ServeEngine(tcfg, tp, config=EngineConfig(**KNOBS), device="cpu")
    assert not teng.paged and teng.prefix is None and teng.spec_k == 0
    assert teng.config.to_dict() == jeng.config.to_dict()
    prompts, gens = _requests(jcfg.vocab)
    for eng in (jeng, teng):
        eng.trace_logits = True
    jreqs = [jeng.submit(p, g, sampling=_sampling(kind, i, True))
             for i, (p, g) in enumerate(zip(prompts, gens))]
    treqs = [teng.submit(p, g, sampling=_sampling(kind, i, False))
             for i, (p, g) in enumerate(zip(prompts, gens))]
    steps, slots = 0, set()
    while jeng.scheduler.has_work or teng.scheduler.has_work:
        jeng.step()
        teng.step()
        steps += 1
        slots |= {r.slot for r in treqs if r.slot is not None}
        assert sorted(teng.state) == sorted(jeng.state)
        for k in teng.state:
            close(teng.state[k], jeng.state[k], 1e-5)
        assert steps < 200
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert all(len(r.generated) == g for r, g in zip(treqs, gens))
    js, ts = jeng.stats_summary(), teng.stats_summary()
    for key in SHARED_COUNTERS + SPEC_KEYS + ("kv_bytes_per_slot",
                                             "kv_dtype"):
        assert ts[key] == js[key], (key, ts[key], js[key])
    assert ts["admissions"] == 4 and len(slots) == 3      # a slot reused
    assert ts["mean_occupancy"] < 1.0                      # idle lanes ran
    assert ts["moa_reduce_launches"] == 0
    assert len(teng.logit_trace) == len(jeng.logit_trace) > 0
    for t, j in zip(teng.logit_trace, jeng.logit_trace):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


def test_warmup_keeps_state_counters_and_tokens(fam):
    """A contiguous engine with live requests, then ``warmup()``: every
    state leaf ``torch.equal`` to before, no counter moved, and the run
    ends with the tokens of an engine that never warmed up."""
    _, tcfg, _, tp = fam
    prompts, gens = _requests(tcfg.vocab)
    runs = []
    for warm in (False, True):
        eng = ServeEngine(tcfg, tp, config=EngineConfig(**KNOBS),
                          device="cpu")
        reqs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
        eng.step()
        eng.step()
        if warm:
            before = {k: v.clone() for k, v in eng.state.items()}
            stats = dict(eng.stats)
            eng.warmup()
            assert eng.stats == stats
            for k, v in eng.state.items():
                assert torch.equal(v, before[k]), k
        eng.run()
        st = eng.stats_summary()
        runs.append(([r.generated for r in reqs],
                     {k: st[k] for k in SHARED_COUNTERS}))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("greedy", [True, False])
def test_generate_equals_jax(fam, greedy):
    jcfg, tcfg, jp, tp = fam
    prompts = np.random.default_rng(7).integers(0, tcfg.vocab, (3, 9))
    want, jst = jserve.generate(jcfg, jp, prompts.astype(np.int32), 6,
                                greedy=greedy, seed=5)
    got, tst = tserve.generate(tcfg, tp, prompts, 6, greedy=greedy, seed=5,
                               device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.shape == (3, 15) and sorted(tst) == sorted(jst)


def test_serve_batch_equals_jax(fam):
    jcfg, tcfg, jp, tp = fam
    prompts, gens = _requests(tcfg.vocab)
    jout, jst = jserve.serve_batch(
        jcfg, jp, prompts, gens, slots=2, prefill_chunk=8,
        sampling=[None, JSampling(temperature=0.8, top_k=40, seed=3), None,
                  None])
    tout, tst = tserve.serve_batch(
        tcfg, tp, prompts, gens, slots=2, prefill_chunk=8,
        sampling=[None, SamplingParams(temperature=0.8, top_k=40, seed=3),
                  None, None], device="cpu")
    assert tout == jout
    for key in SHARED_COUNTERS + ("kv_bytes_per_slot", "spec_drafted"):
        assert tst[key] == jst[key], key


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_serve_cli_on_cpu(capsys, arch):
    assert tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--requests", "3", "--gen", "4",
                        "--prompt-len", "6"]) == 0
    out = capsys.readouterr().out
    assert f"[engine] arch={arch} device=cpu" in out
    assert "paged_kv=False" in out and "moa_reduce launches 0" in out
    assert "first request" in out


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_train_cli_on_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--reduced", "--device", "cpu", "--steps", "2", "--seq", "16",
         "--batch", "2"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("step")]
    assert len(lines) == 2
    losses = [float(ln.split()[3]) for ln in lines]
    assert all(np.isfinite(losses)) and abs(losses[0] - np.log(97)) < 1.0
