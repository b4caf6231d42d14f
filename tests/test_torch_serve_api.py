"""The port's knob API and static-batch entry points against the JAX package.

``EngineConfig`` is the JAX config field for field (names, defaults and
docs), so ``knob_table_md()`` must equal the JAX one string for string;
``add_cli_args`` / ``config_from_args`` must reach every field and give
the JAX binding's config on the same command lines; ``batch_config`` must
give the JAX one's config in every mode of the JAX package's own tests;
``validate`` and ``resolve`` must raise the JAX messages and resolve to
the same values; ``mesh_shards > 1`` must raise where the JAX config
does (a contiguous engine) and resolve as it does elsewhere.  ``generate`` (the per-token loop) and ``serve_batch`` run the
reduced fp32 config on the JAX weights (``params_from_numpy``): tokens
equal, greedy and sampled; the serve CLI runs ``--per-token`` and
``--no-paged-kv`` on the CPU."""
import argparse
import dataclasses

import numpy as np
import pytest

from repro.launch import serve as jserve
from repro.serve import EngineConfig as JConfig
from repro.serve import SamplingParams as JSampling
from repro.serve import add_cli_args as jadd_cli_args
from repro.serve import config_from_args as jconfig_from_args
from repro.serve import knob_table_md as jknob_table_md
from repro.serve.config import KV_DTYPES as JKV_DTYPES
from repro_torch.launch import serve as tserve
from repro_torch.serve import (KV_DTYPES, EngineConfig, SamplingParams,
                               add_cli_args, config_from_args,
                               knob_table_md)
from test_config import NON_DEFAULT, VALIDATE_ERRORS
from test_torch_prefix import SHARED_COUNTERS, _model


@pytest.fixture(scope="module")
def model():
    return _model()


# ---------------------------------------------------------------------------
# the knob API
# ---------------------------------------------------------------------------

def test_fields_defaults_and_docs_equal_jax():
    tf, jf = dataclasses.fields(EngineConfig), dataclasses.fields(JConfig)
    assert [(f.name, f.default, f.metadata["doc"]) for f in tf] == \
        [(f.name, f.default, f.metadata["doc"]) for f in jf]
    assert tuple(KV_DTYPES) == tuple(JKV_DTYPES)
    assert EngineConfig().to_dict() == JConfig().to_dict()
    assert EngineConfig().replace(spec_k=4) == EngineConfig(spec_k=4)


def test_knob_table_equals_jax():
    assert knob_table_md() == jknob_table_md()


def _parse(add, argv):
    ap = argparse.ArgumentParser()
    add(ap)
    return ap.parse_args(argv)


#: every knob at a non-default value (the JAX test's command line)
FULL_ARGV = ["--slots", "2", "--max-seq", "64", "--prefill-chunk", "16",
             "--page", "16", "--no-prefix-cache", "--min-prefix", "4",
             "--no-paged-kv", "--pool-pages", "7", "--trie-capacity", "5",
             "--spec-k", "3", "--spec-ngram", "2", "--spec-mode", "tree",
             "--spec-tree-nodes", "6", "--spec-branch", "2",
             "--spec-drafter", "heads", "--kv-dtype", "fp32",
             "--page-dedup", "--degrade", "--mesh-shards", "2"]


@pytest.mark.parametrize("argv", [[], ["--no-spec"], ["--spec-k", "6"],
                                  ["--no-paged-kv", "--page", "0"],
                                  FULL_ARGV], ids=str)
def test_cli_binding_equals_jax(argv):
    args = _parse(add_cli_args, argv)
    for f in dataclasses.fields(EngineConfig):
        assert hasattr(args, f.name), f"no CLI binding for {f.name}"
    got = config_from_args(args)
    assert got.to_dict() == jconfig_from_args(
        _parse(jadd_cli_args, argv)).to_dict()
    if argv == FULL_ARGV:
        assert got == EngineConfig(**dict(NON_DEFAULT, paged_kv=False,
                                          kv_dtype="fp32"))


def test_cli_defaults_and_no_spec():
    assert config_from_args(_parse(add_cli_args, [])) == \
        EngineConfig(spec_k=4)
    assert config_from_args(_parse(add_cli_args, ["--no-spec"])).spec_k == 0
    assert config_from_args(
        _parse(lambda ap: add_cli_args(ap, spec_k_default=0), [])).spec_k \
        == 0


def _batch_modes(batch_config, config_cls):
    prompts = [[0] * 20, [0] * 5]
    c = config_cls(max_seq=128)
    out = [batch_config(prompts, 10), batch_config(prompts, [10, 1]),
           batch_config(prompts, 10, config=c),
           batch_config(prompts, 10, config=c, max_seq=0),
           batch_config(prompts, 10, config=c, max_seq=64),
           batch_config(prompts, 10, slots=2),
           batch_config(prompts, 10, config=c, slots=2)]
    out += [batch_config([[1, 2, 3]], 4, **({"max_seq": v} if k == "max_seq"
                                             else {k: v}))
            for k, v in NON_DEFAULT.items()]
    with pytest.raises(TypeError, match="not both"):
        batch_config(prompts, 10, config=c, spec_k=2)
    return [e.to_dict() for e in out]


def test_batch_config_equals_jax_in_every_mode():
    assert _batch_modes(tserve.batch_config, EngineConfig) == \
        _batch_modes(jserve.batch_config, JConfig)


@pytest.mark.parametrize("knobs,msg", VALIDATE_ERRORS,
                         ids=[m[:24] for _, m in VALIDATE_ERRORS])
def test_validate_messages_equal_jax(knobs, msg):
    msgs = []
    for cls in (EngineConfig, JConfig):
        with pytest.raises(ValueError, match=msg) as e:
            cls(**knobs).validate()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_resolve_messages_equal_jax(model):
    jcfg, tcfg = model[:2]
    msgs = []
    # max_seq 24: no power-of-two page in [16, 128] -> auto page 0
    for cls, cfg in ((EngineConfig, tcfg), (JConfig, jcfg)):
        with pytest.raises(ValueError, match="page_size > 0") as e:
            cls(max_seq=24, paged_kv=True).resolve(cfg)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("knobs", [
    dict(max_seq=64), dict(max_seq=64, spec_k=4, kv_dtype="int8"),
    dict(max_seq=64, paged_kv=False), dict(max_seq=64, page_size=0),
    dict(max_seq=64, page_size=0, kv_dtype="int4", page_dedup=True),
    dict(max_seq=24, spec_k=2, spec_mode="tree"),
    dict(max_seq=64, paged_kv=False, spec_k=3, spec_mode="auto"),
    dict(max_seq=48, page_size=16, pool_pages=5, page_dedup=True)],
    ids=str)
def test_resolve_equals_jax(model, knobs):
    """The auto page (0 when none fits), paged_kv from pageability, and
    the contiguous fallbacks: kv_dtype to fp32, page_dedup off, no
    pool."""
    jcfg, tcfg = model[:2]
    got = EngineConfig(**knobs).resolve(tcfg)
    assert got.to_dict() == JConfig(**knobs).resolve(jcfg).to_dict()
    assert got.resolve(tcfg) == got


def test_mesh_shards_above_one_raise(model):
    """``mesh_shards > 1`` raises where the JAX config raises, and only
    there: a paged config validates and resolves to the JAX values, a
    contiguous one raises the JAX class and message at resolution."""
    jcfg, tcfg = model[:2]
    EngineConfig(mesh_shards=1).validate()
    for knobs in (dict(mesh_shards=2), dict(mesh_shards=4, max_seq=64),
                  dict(mesh_shards=2, max_seq=48, page_size=16,
                       pool_pages=6)):
        assert EngineConfig(**knobs).validate().to_dict() == \
            JConfig(**knobs).validate().to_dict()
        assert EngineConfig(**knobs).resolve(tcfg).to_dict() == \
            JConfig(**knobs).resolve(jcfg).to_dict()
    assert tserve.batch_config([[1, 2]], 4, mesh_shards=4).validate() \
        .to_dict() == jserve.batch_config([[1, 2]], 4,
                                          mesh_shards=4).validate().to_dict()
    msgs = []
    for cls, cfg in ((EngineConfig, tcfg), (JConfig, jcfg)):
        with pytest.raises(ValueError, match="requires the paged engine") \
                as e:
            cls(mesh_shards=2, max_seq=64, paged_kv=False).resolve(cfg)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# generate and serve_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("greedy", [True, False])
@pytest.mark.parametrize("page", [0, 8])
def test_generate_equals_jax(model, greedy, page):
    """The per-token loop over dense state with a 0-d index: one softmax
    (page 0) or split-K over pages of 8 (the cache holds 10 + 6 = 16
    positions); sampled runs draw with the JAX loop's split keys."""
    jcfg, tcfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, decode_page_size=page)
    tcfg = dataclasses.replace(tcfg, decode_page_size=page)
    prompts = np.random.default_rng(7).integers(0, tcfg.vocab, (3, 10))
    want, jst = jserve.generate(jcfg, jp, prompts.astype(np.int32), 6,
                                greedy=greedy, seed=5)
    got, tst = tserve.generate(tcfg, tp, prompts, 6, greedy=greedy, seed=5,
                               device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.shape == (3, 16) and (got[:, :10] == prompts).all()
    assert sorted(tst) == sorted(jst)


@pytest.mark.parametrize("knobs", [
    dict(), dict(paged_kv=False), dict(page_size=0),
    dict(paged_kv=False, spec_k=4), dict(spec_k=4, spec_mode="tree")],
    ids=str)
def test_serve_batch_equals_jax(model, knobs):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(9)
    pat = rng.integers(0, tcfg.vocab, 5).tolist()
    prompts = [pat * 3, rng.integers(0, tcfg.vocab, 9).tolist(),
               pat * 2 + [3], rng.integers(0, tcfg.vocab, 4).tolist()]
    gens = [6, 4, 7, 5]
    jout, jst = jserve.serve_batch(
        jcfg, jp, prompts, gens, slots=2, prefill_chunk=8,
        sampling=[None, JSampling(temperature=0.8, top_k=20, seed=3), None,
                  None], **knobs)
    tout, tst = tserve.serve_batch(
        tcfg, tp, prompts, gens, slots=2, prefill_chunk=8,
        sampling=[None, SamplingParams(temperature=0.8, top_k=20, seed=3),
                  None, None], device="cpu", **knobs)
    assert tout == jout
    for key in SHARED_COUNTERS + ("kv_bytes_per_slot", "spec_drafted",
                                  "spec_accepted", "spec_tree_steps"):
        assert tst[key] == jst[key], key


def test_serve_batch_defaults_to_the_card(model):
    import torch
    tcfg, tp = model[1], model[3]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve_batch(tcfg, tp, [[1, 2, 3]], 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.generate(tcfg, tp, np.zeros((1, 3), np.int64), 2)


@pytest.mark.parametrize("argv,want", [
    (["--per-token", "--slots", "2", "--prompt-len", "6", "--gen", "4"],
     "[per-token] arch=llama3.2-3b device=cpu batch=2"),
    (["--no-paged-kv", "--requests", "3", "--gen", "5"],
     "paged_kv=False"),
    (["--no-paged-kv", "--page", "0", "--requests", "3", "--gen", "5",
      "--no-spec"], "page=0 paged_kv=False")], ids=["per-token", "contig",
                                                    "dense"])
def test_cli_runs_per_token_and_contiguous(capsys, argv, want):
    assert tserve.main(["--reduced", "--device", "cpu"] + argv) == 0
    out = capsys.readouterr().out
    assert want in out
    assert "first request" in out
