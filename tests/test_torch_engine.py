"""The port's serve engine against the JAX serve engine: the slice whole.

Same weights (JAX ``init_params`` through ``params_from_numpy``) and the
same knobs: 2 slots, max_seq 64, prefill chunk 16, page 16, paged KV, no
prefix cache, no speculative decode.  Four greedy requests (prompts of 5,
19, 33 and 12 tokens, 8 new tokens each) force chunked prefill, bucket
padding and slot refill.  Tokens must be equal request for request; the
first-token logits (prefill of the engine's own pieces) and every decode
step's logits agree within 1e-4 (fp32); every page is back in the pool
after ``run()``."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.models import lm as jlm
from repro.models.common import init_params as jinit
from repro.serve import EngineConfig as JConfig
from repro.serve import ServeEngine as JEngine
from repro.serve.cache import paged_state_specs as jpaged
from repro.serve.cache import state_zeros as jzeros
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models.common import init_params
from repro_torch.models.registry import get_api
from repro_torch.serve import EngineConfig, ServeEngine

ROOT = Path(__file__).resolve().parent.parent
PROMPT_LENS = (5, 19, 33, 12)
MAX_NEW = 8


@pytest.fixture(scope="module")
def served():
    jcfg = jget("llama3.2-3b").reduced(dtype=jnp.float32, n_kv_heads=2)
    tcfg = tget("llama3.2-3b").reduced(dtype=torch.float32, n_kv_heads=2)
    jp = jinit(jlm.param_specs(jcfg), jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           torch.float32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, n).tolist() for n in PROMPT_LENS]

    jeng = JEngine(jcfg, jp, config=JConfig(
        max_slots=2, max_seq=64, prefill_chunk=16, page_size=16,
        prefix_cache=False, spec_k=0, paged_kv=True))
    jeng.trace_logits = True
    jreqs = [jeng.submit(p, MAX_NEW) for p in prompts]
    jeng.run()

    teng = ServeEngine(tcfg, tp, config=EngineConfig(
        max_slots=2, max_seq=64, prefill_chunk=16, page_size=16),
        device="cpu")
    teng.trace_logits = True
    treqs = [teng.submit(p, MAX_NEW) for p in prompts]
    teng.run()
    return dict(jcfg=jcfg, jp=jp, prompts=prompts, jeng=jeng, jreqs=jreqs,
                teng=teng, treqs=treqs)


def test_greedy_tokens_equal_per_request(served):
    for j, t in zip(served["jreqs"], served["treqs"]):
        assert len(t.generated) == MAX_NEW
        assert t.generated == j.generated


def test_decode_steps_and_logits_match(served):
    jeng, teng = served["jeng"], served["teng"]
    assert teng.stats["decode_steps"] == jeng.stats["decode_steps"] == 14
    assert teng.stats["prefill_dispatches"] == \
        jeng.stats["prefill_dispatches"]
    assert len(teng.logit_trace) == len(jeng.logit_trace)
    for t, j in zip(teng.logit_trace, jeng.logit_trace):
        np.testing.assert_allclose(t, j, atol=1e-4)


def test_first_token_logits_match(served):
    """Prefill each prompt through the engine's own pieces in both packages
    and compare the logits that pick the first token."""
    teng, jcfg, jp = served["teng"], served["jcfg"], served["jp"]
    jspecs = jpaged(jlm.decode_state_specs(jcfg, 1, 64), 16, 5)
    for prompt, treq in zip(served["prompts"], served["treqs"]):
        jstate = jzeros(jspecs)
        tstate = {k: torch.zeros_like(v) for k, v in teng.state.items()}
        table = np.array([[1, 2, 3, 4]])
        for start, nvalid, cb in teng._pieces(prompt):
            toks = np.zeros((1, cb), np.int64)
            toks[0, :nvalid] = prompt[start:start + nvalid]
            jl, jstate = jlm.prefill_chunk(
                jp, jstate, {"tokens": jnp.asarray(toks, jnp.int32),
                             "index": jnp.int32(start),
                             "nvalid": jnp.int32(nvalid),
                             "pages": jnp.asarray(table, jnp.int32)}, jcfg)
            tl, tstate = teng.api.prefill_chunk(
                teng.params, tstate,
                {"tokens": torch.from_numpy(toks),
                 "index": torch.tensor(start), "nvalid": nvalid,
                 "pages": torch.from_numpy(table)}, teng.cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        assert int(tl.argmax()) == treq.generated[0]


def test_pool_drained_after_run(served):
    teng = served["teng"]
    assert not teng.scheduler.has_work
    assert teng.pool.used_count == 0
    assert teng.pool.free_count == teng.pool.num_pages - 1
    assert (teng.table == 0).all()
    assert teng.stats_summary()["pages_in_use"] == 0


@pytest.mark.parametrize("knobs,lens,new", [
    # tail bucket clipped to the cache room (35 tokens: pieces 32 + 3 in a
    # bucket of 8 shrunk to 4), a 1-token prompt, a 1-token budget
    (dict(max_slots=3, max_seq=36, prefill_chunk=32, page_size=12),
     (35, 3, 20, 1), (1, 5, 16, 3)),
    # an overcommitted pool: decode-time page exhaustion evicts a slot and
    # its re-admission re-prefills prompt + generated tokens
    (dict(max_slots=2, max_seq=48, prefill_chunk=8, page_size=16,
          pool_pages=4), (30, 9, 20), (12, 20, 5)),
])
def test_engine_matches_jax_on_edge_configs(knobs, lens, new):
    jcfg = jget("llama3.2-3b").reduced(dtype=jnp.float32, n_kv_heads=2)
    tcfg = tget("llama3.2-3b").reduced(dtype=torch.float32, n_kv_heads=2)
    jp = jinit(jlm.param_specs(jcfg), jax.random.key(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           torch.float32)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab, n).tolist() for n in lens]
    jeng = JEngine(jcfg, jp, config=JConfig(prefix_cache=False, spec_k=0,
                                            paged_kv=True, **knobs))
    jreqs = [jeng.submit(p, m) for p, m in zip(prompts, new)]
    jeng.run()
    teng = ServeEngine(tcfg, tp, config=EngineConfig(**knobs), device="cpu")
    treqs = [teng.submit(p, m) for p, m in zip(prompts, new)]
    teng.run()
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert [len(r.generated) for r in treqs] == list(new)
    for key in ("prefill_dispatches", "decode_steps", "prefill_tokens"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.pool.used_count == 0


def test_pool_exhaustion_defers_admission():
    """A pool of 3 pages holds one 33-token request at a time: the other
    admission is deferred (never dropped) and both still finish."""
    tcfg = tget("llama3.2-3b").reduced(dtype=torch.float32, n_kv_heads=2)
    params = init_params(get_api(tcfg).param_specs(tcfg),
                         torch.Generator().manual_seed(0),
                         torch.device("cpu"), torch.float32)
    eng = ServeEngine(tcfg, params, config=EngineConfig(
        max_slots=2, max_seq=64, prefill_chunk=16, page_size=16,
        pool_pages=3), device="cpu")
    reqs = [eng.submit(list(range(1, 34)), 4) for _ in range(2)]
    eng.run()
    assert all(len(r.generated) == 4 for r in reqs)
    assert eng.stats["oom_deferred"] >= 1
    assert eng.pool.used_count == 0


def test_cli_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--requests", "4", "--gen", "8"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "[engine] arch=llama3.2-3b device=cpu" in out.stdout
