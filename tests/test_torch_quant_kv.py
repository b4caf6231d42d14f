"""The port's quantized KV pages against the JAX package.

Exact: the quantization primitives of ``repro_torch.models.quant_kv``
(codes, scales and the signs of dequantized zeros) on identical inputs,
the int4 nibble packing, ``kv_bits``, the carry audit's widths and errors,
``quant_state_specs``'s layout and errors, and ``gather_pages_dequant``.

Within tolerance: ``gqa_decode_pages`` and the ``lm`` entry points
(``decode_step``, ``prefill_chunk``, ``verify_chunk``, ``verify_tree``)
over int8 and int4 pools made from the same numpy codes and scales, on the
reduced ``llama3.2-3b`` config (fp32, ``n_kv_heads=2``): outputs within
``1e-4``; the written pools, dequantized, within one code step (the JAX
row's scale) of the JAX package's, since k and v rows differ in ulps
between the two matmuls and a code may round the other way.  Scratch page
0 is left out (it takes the masked rows in no defined order).

The engine, in lockstep with the JAX engine on the 1-layer reduced config:
int8 and int4 greedy decode, prefix reuse with copy-on-write and content
dedup (which hashes codes and scales) over quantized pages, chain and tree
speculative decode over int8 pages: tokens, counters, page tables,
refcounts and the ``kv_dtype`` / ``kv_bytes_per_slot`` / ``pool_bytes``
stats equal; the reduced MLA config (``minicpm3-4b``, 1 layer) over
int8 and int4 latent pools likewise.  The config's ``kv_dtype``
validation gives the JAX config's messages, and the serve CLI runs a
quantized, sampled workload to length.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import paging as jpaging
from repro.models import quant_kv as jq
from repro.models.common import ParamSpec as JSpec
from repro.serve import EngineConfig as JConfig
from repro.serve import cache as jcache
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models import paging as tpaging
from repro_torch.models import quant_kv as tq
from repro_torch.models.common import ParamSpec as TSpec
from repro_torch.models.registry import get_api
from repro_torch.serve import EngineConfig, ServeEngine
from repro_torch.serve import cache as tcache
from test_torch_prefix import (DEDUP_KNOBS, _dedup_prompts, _model,
                               _toks)
from test_torch_sampling import assert_same, lockstep
from test_torch_spec_engine import GEOMETRY, MODES, _prompts

BITS = {"int8": 8, "int4": 4}
PAGE, NUM_PAGES = 16, 10


def _rows(seed, shape=(3, 5, 2, 8)):
    """fp32 rows with an all-zero row, a row of -0.0, a row with one
    nonzero entry and values that land on half-way code points."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 1, 0] = -0.0
    x[0, 2, 0] = 0.0
    x[0, 2, 0, 3] = -1.5
    x[1, 0, 1] = np.arange(shape[-1], dtype=np.float32) - 3.5
    return x


# ---------------------------------------------------------------------------
# primitives, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("seed", range(3))
def test_quantize_rows_matches_jax(bits, seed):
    x = _rows(seed)
    jc, js = jq.quantize_rows(jnp.asarray(x), bits)
    tc, ts = tq.quantize_rows(torch.from_numpy(x), bits)
    assert tc.dtype == (torch.int8 if bits == 8 else torch.uint8)
    assert ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    for dt_j, dt_t in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        jd = np.asarray(jq.dequantize_rows(jc, js, dt_j).astype(
            jnp.float32))
        td = tq.dequantize_rows(tc, ts, dt_t)
        assert td.dtype == dt_t
        got = td.float().numpy()
        np.testing.assert_array_equal(got, jd)
        np.testing.assert_array_equal(np.signbit(got), np.signbit(jd))
    # zero rows come back as exact zeros
    assert not tq.dequantize_rows(tc, ts, torch.float32)[0, :2, 0].any()


def test_quantize_int8_per_tensor_matches_jax():
    x = _rows(7)
    scale = np.float32(0.0173)
    jc = jq.quantize_int8(jnp.asarray(x), jnp.asarray(scale))
    tc = tq.quantize_int8(torch.from_numpy(x), torch.tensor(scale))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(
        tq.dequantize_int8(tc, torch.tensor(scale)).numpy(),
        np.asarray(jq.dequantize_int8(jc, jnp.asarray(scale))))


def test_pack_unpack_int4_every_code_pair():
    codes = np.array([(a, b) for a in range(-8, 8) for b in range(-8, 8)],
                     np.int8).reshape(4, 128)
    jp = jq.pack_int4(jnp.asarray(codes))
    tp = tq.pack_int4(torch.from_numpy(codes))
    assert tp.dtype == torch.uint8 and tp.shape == (4, 64)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    un = tq.unpack_int4(tp)
    assert un.dtype == torch.int8
    np.testing.assert_array_equal(un.numpy(), codes)
    np.testing.assert_array_equal(un.numpy(), np.asarray(jq.unpack_int4(jp)))


def test_pack_int4_odd_axis_raises_like_jax():
    msgs = []
    for pack, x in ((jq.pack_int4, jnp.zeros((2, 5), jnp.int8)),
                    (tq.pack_int4, torch.zeros((2, 5), dtype=torch.int8))):
        with pytest.raises(ValueError) as e:
            pack(x)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_kv_bits_matches_jax():
    assert tq.kv_bits(torch.zeros(2, dtype=torch.int8)) == 8
    assert tq.kv_bits(torch.uint8) == 4
    with pytest.raises(ValueError, match="not a KV code dtype"):
        tq.kv_bits(torch.zeros(2))
    with pytest.raises(ValueError, match="bits must be 8 or 4"):
        tq.quantize_rows(torch.zeros(2, 4), 2)
    assert tq.KV_DTYPES == jq.KV_DTYPES


@pytest.mark.parametrize("page", [1, 16, 64, 128, 2 ** 20])
@pytest.mark.parametrize("bits", [8, 4])
def test_kv_carry_budget_matches_jax(page, bits):
    assert dataclasses.astuple(tq.kv_carry_budget(page, bits)) == \
        dataclasses.astuple(jq.kv_carry_budget(page, bits))
    for acc in (32, 16, 12, 8):
        out = []
        for audit in (jq.assert_kv_accumulator, tq.assert_kv_accumulator):
            try:
                out.append(dataclasses.astuple(audit(page, bits, acc)))
            except ValueError as e:
                out.append(str(e))
        assert out[0] == out[1], (page, bits, acc)


# ---------------------------------------------------------------------------
# pooled layout and the dequantizing gather
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.fixture(scope="module")
def model1():
    return _model(n_layers=1)


def _spec_dict(specs, dtype_name):
    return {k: (tuple(s.shape), tuple(s.axes), dtype_name(s.dtype), s.init)
            for k, s in specs.items()}


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "int4"])
def test_quant_state_specs_layout_matches_jax(model, kv_dtype):
    jcfg, tcfg, _, _ = model
    jp = jcache.paged_state_specs(jlm.decode_state_specs(jcfg, 2, 32), 16, 5)
    tp = tcache.paged_state_specs(
        get_api(tcfg).decode_state_specs(tcfg, 2, 32), 16, 5)
    jqs = jcache.quant_state_specs(jp, kv_dtype)
    tqs = tcache.quant_state_specs(tp, kv_dtype)
    assert _spec_dict(tqs, lambda d: str(d).removeprefix("torch.")) == \
        _spec_dict(jqs, lambda d: jnp.dtype(d).name)
    if kv_dtype == "fp32":
        assert tqs is tp
    else:
        assert sorted(tqs) == ["k", "k_scale", "v", "v_scale"]
        assert tcache.state_bytes(tqs) == jcache.state_bytes(jqs)


def test_quant_state_specs_errors_match_jax():
    cases = [
        ({"k": (2, 5, 16, 7)}, "int4"),        # odd feature extent
        ({"k": (2, 5, 16, 8)}, "int2"),        # unknown dtype
    ]
    for shapes, kv_dtype in cases:
        msgs = []
        for spec, mod, dt in ((JSpec, jcache, jnp.float32),
                              (TSpec, tcache, torch.float32)):
            specs = {n: spec(s, ("layers", "phys_page", "page_seq", None),
                             dtype=dt, init="zeros")
                     for n, s in shapes.items()}
            with pytest.raises(ValueError) as e:
                mod.quant_state_specs(specs, kv_dtype)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    odd = {"k": TSpec((2, 5, 16, 7), ("layers", "phys_page", "page_seq",
                                      None), init="zeros")}
    assert tcache.quant_state_specs(odd, "int8")["k"].shape == (2, 5, 16, 7)
    with pytest.raises(ValueError, match="flat dict of ParamSpecs"):
        tcache.quant_state_specs({"k": {"nested": odd["k"]}}, "int8")


def _quant_pools(cfg, kv_dtype, seed):
    """Quantized (layers, pages, page, Hkv, hd) pools made by the JAX
    package's quantize_rows from seeded fp32 rows: numpy codes and
    scales for both packages."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, NUM_PAGES, PAGE, cfg.n_kv_heads, cfg.hd)
    out = {}
    for name in ("k", "v"):
        x = (0.5 * rng.standard_normal(shape)).astype(np.float32)
        codes, scale = jq.quantize_rows(jnp.asarray(x), BITS[kv_dtype])
        out[name] = np.array(codes)
        out[name + "_scale"] = np.array(scale)
    return out


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_gather_pages_dequant_matches_jax(model, kv_dtype):
    pools = _quant_pools(model[0], kv_dtype, 1)
    pages = np.array([[3, 1, 0, 9], [2, 2, 7, 4]])
    want = jpaging.gather_pages_dequant(
        jnp.asarray(pools["k"][0]), jnp.asarray(pools["k_scale"][0]),
        jnp.asarray(pages, jnp.int32), jnp.float32)
    got = tpaging.gather_pages_dequant(
        torch.from_numpy(pools["k"][0]),
        torch.from_numpy(pools["k_scale"][0]), torch.from_numpy(pages),
        torch.float32)
    assert got.shape == (2, 4 * PAGE, model[0].n_kv_heads, model[0].hd)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the model over quantized pools
# ---------------------------------------------------------------------------

def _deq(state, name):
    codes = torch.as_tensor(np.array(state[name]))
    scale = torch.as_tensor(np.array(state[name + "_scale"]))
    return tq.dequantize_rows(codes, scale, torch.float32).numpy(), \
        scale.numpy()


def _close_quant_pools(tstate, jstate):
    """Codes and scales, dequantized: within one code step of the JAX
    package's (its row's scale, and 1e-5 for the scale itself), scratch
    page 0 aside."""
    for name in ("k", "v"):
        t, _ = _deq(tstate, name)
        j, js = _deq(jstate, name)
        step = js[:, 1:, ..., None] * (1 + 1e-5)
        assert (np.abs(t[:, 1:] - j[:, 1:]) <= step).all(), name
        np.testing.assert_allclose(
            tstate[name + "_scale"].numpy()[:, 1:],
            np.asarray(jstate[name + "_scale"])[:, 1:], rtol=1e-5, atol=0)


def _states(pools):
    return ({k: jnp.asarray(v) for k, v in pools.items()},
            {k: torch.from_numpy(v.copy()) for k, v in pools.items()})


def _batches(rng, vocab):
    """An lm entry point and its batch (numpy): decode over 3 slots (one
    idle), a 16-token prefill piece at position 32, a chain verify with a
    block hanging past capacity and an idle lane, a tree verify."""
    pages = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]])
    parents = np.broadcast_to(np.arange(8), (3, 8)).copy()
    pos_off = np.zeros((3, 8), np.int64)
    parents[0, :6] = [-1, 0, 1, 1, 2, 4]
    pos_off[0, :6] = [0, 1, 2, 2, 3, 4]
    parents[1, :4] = [-1, 0, 1, 2]
    pos_off[1, :4] = [0, 1, 2, 3]
    return {
        "decode_step": {"tokens": rng.integers(0, vocab, (3, 1)),
                        "index": np.array([9, 40, 0]), "pages": pages},
        "prefill_chunk": {"tokens": rng.integers(0, vocab, (1, 16)),
                          "index": np.array(32), "pages": pages[:1]},
        "verify_chunk": {"tokens": rng.integers(0, vocab, (3, 4)),
                         "index": np.array([5, 62, 0]),
                         "nspec": np.array([4, 4, 0]), "pages": pages},
        "verify_tree": {"tokens": rng.integers(0, vocab, (3, 8)),
                        "index": np.array([7, 20, 0]), "parents": parents,
                        "pos_off": pos_off, "nchain": np.array([2, 1, 0]),
                        "nspec": np.array([6, 4, 0]), "pages": pages},
    }


#: rows of each entry point's logits that are real (idle lanes aside)
LIVE = {"decode_step": slice(0, 2), "prefill_chunk": slice(0, 1),
        "verify_chunk": slice(0, 2), "verify_tree": slice(0, 2)}


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("entry", sorted(LIVE))
def test_lm_entry_points_over_quantized_pools_match_jax(model, kv_dtype,
                                                        entry):
    jcfg, tcfg, jp, tp = model
    pools = _quant_pools(jcfg, kv_dtype, 2)
    batch = _batches(np.random.default_rng(3), jcfg.vocab)[entry]
    jstate, tstate = _states(pools)
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v, dtype=torch.int64) for k, v in batch.items()}
    jout = getattr(jlm, entry)(jp, jstate, jb, jcfg)
    tout = getattr(tlm, entry)(tp, tstate, tb, tcfg)
    jl, jstate = jout[0], jout[-1]
    tl, tstate = tout[0], tout[-1]
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy()[LIVE[entry]],
                               np.asarray(jl)[LIVE[entry]], atol=1e-4)
    assert sorted(tstate) == ["k", "k_scale", "v", "v_scale"]
    for k in tstate:
        assert tstate[k].dtype == torch.from_numpy(pools[k]).dtype
    _close_quant_pools(tstate, jstate)
    # the write landed: the pool changed where the block wrote
    assert not np.array_equal(tstate["k"].numpy(), pools["k"])


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("block", ["decode", "chain", "tree"])
def test_gqa_decode_pages_over_quantized_pools_matches_jax(model, kv_dtype,
                                                           block):
    """One layer's call with ``(codes, scales)`` pools: a decode row per
    slot, a row-masked chain block (``nvalid``) or a tree block (only the
    chain rows committed)."""
    jcfg, tcfg, jp, tp = model
    pools = _quant_pools(jcfg, kv_dtype, 5)
    rng = np.random.default_rng(6)
    c = {"decode": 1, "chain": 4, "tree": 8}[block]
    x = rng.standard_normal((3, c, jcfg.d_model)).astype(np.float32)
    pages = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 0, 0, 0]])
    cur = np.array([9, 60, 3])
    extra_j, extra_t = (), ()
    if block == "chain":
        nvalid = np.array([4, 4, 1])
        extra_j = (jnp.asarray(nvalid, jnp.int32),)
        extra_t = (torch.from_numpy(nvalid),)
    elif block == "tree":
        b = _batches(rng, jcfg.vocab)["verify_tree"]
        tree = (b["parents"], b["pos_off"], b["nchain"])
        cur = b["index"]
        extra_j = (jnp.asarray(b["nspec"], jnp.int32),
                   tuple(jnp.asarray(a, jnp.int32) for a in tree))
        extra_t = (torch.from_numpy(b["nspec"]),
                   tuple(torch.as_tensor(a, dtype=torch.int64)
                         for a in tree))
    jstate, tstate = _states({k: v[0] for k, v in pools.items()})
    jpair = ((jstate["k"], jstate["k_scale"]), (jstate["v"], jstate["v_scale"]))
    tpair = ((tstate["k"], tstate["k_scale"]), (tstate["v"], tstate["v_scale"]))
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    tl = {k: v[0] for k, v in tp["blocks"]["attn"].items()}
    jout, jk, jv = jattn.gqa_decode_pages(
        jnp.asarray(x), jl, jcfg, *jpair, jnp.asarray(cur, jnp.int32),
        jnp.asarray(pages, jnp.int32), *extra_j)
    tout, tk, tv = tattn.gqa_decode_pages(
        torch.from_numpy(x), tl, tcfg, *tpair, torch.from_numpy(cur),
        torch.from_numpy(pages), *extra_t)
    assert tk[0] is tstate["k"] and tv[1] is tstate["v_scale"]
    live = slice(0, 2) if block == "tree" else slice(0, 3)
    np.testing.assert_allclose(tout.numpy()[live], np.asarray(jout)[live],
                               atol=1e-4)
    got = {"k": tk[0][None], "k_scale": tk[1][None], "v": tv[0][None],
           "v_scale": tv[1][None]}
    want = {"k": jk[0][None], "k_scale": jk[1][None], "v": jv[0][None],
            "v_scale": jv[1][None]}
    _close_quant_pools(got, want)


def test_quantized_state_needs_a_page_table(model):
    jcfg, tcfg, _, tp = model
    pools = _quant_pools(jcfg, "int8", 4)
    state = {k: torch.from_numpy(v) for k, v in pools.items()}
    batch = {"tokens": torch.zeros((1, 1), dtype=torch.int64),
             "index": torch.tensor([0])}
    with pytest.raises(ValueError, match="requires a page table"):
        tlm.decode_step(tp, state, batch, tcfg)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("mode", ["sequential", "chain", "tree"])
def test_quantized_engine_matches_jax(model1, kv_dtype, mode):
    prompts, gens = _prompts(model1[0].vocab)
    jeng, teng, jreqs, treqs = lockstep(
        model1, prompts, gens, **GEOMETRY, kv_dtype=kv_dtype,
        **MODES.get(mode, {}))
    assert_same(jeng, teng, jreqs, treqs)
    st = teng.stats_summary()
    assert st["kv_dtype"] == kv_dtype
    per_token = 2 * model1[1].n_kv_heads * (
        model1[1].hd // (8 // BITS[kv_dtype]) + 4)
    assert st["kv_bytes_per_slot"] == per_token * GEOMETRY["max_seq"]
    assert teng.state["k"].dtype == (torch.int8 if kv_dtype == "int8"
                                     else torch.uint8)


@pytest.fixture(scope="module")
def mla_model1():
    return _model(arch="minicpm3-4b", n_layers=1)


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("mode", ["sequential", "chain", "tree"])
def test_mla_quantized_engine_matches_jax(mla_model1, kv_dtype, mode):
    """int8 / int4 latent pools: one scale per (page, position) row of
    ``ckv`` and of ``kr``, codes and scales scattered together."""
    cfg = mla_model1[1]
    prompts, gens = _prompts(cfg.vocab)
    jeng, teng, jreqs, treqs = lockstep(
        mla_model1, prompts, gens, **GEOMETRY, kv_dtype=kv_dtype,
        **MODES.get(mode, {}))
    assert_same(jeng, teng, jreqs, treqs)
    assert sorted(teng.state) == ["ckv", "ckv_scale", "kr", "kr_scale"]
    assert teng.state["ckv_scale"].shape == teng.state["ckv"].shape[:3]
    per_token = cfg.n_layers * (
        (cfg.kv_lora_rank + cfg.qk_rope_dim) // (8 // BITS[kv_dtype]) + 8)
    assert teng.stats_summary()["kv_bytes_per_slot"] == \
        per_token * GEOMETRY["max_seq"]


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_prefix_reuse_with_copy_on_write_over_quantized_pages(model1,
                                                              kv_dtype):
    """A sharer copies the boundary page, codes and scales together, and
    writes into its copy while the source keeps decoding; a retired row is
    reused in place."""
    vocab = model1[0].vocab
    rng = np.random.default_rng(23)
    system = _toks(rng, vocab, 12)
    tails = [_toks(rng, vocab, 4) for _ in range(2)]
    prompts = [system, system + tails[0], system + tails[1], system]
    gens = [20, 6, 6, 3]
    knobs = dict(max_slots=2, max_seq=48, prefill_chunk=8, page_size=16,
                 kv_dtype=kv_dtype)
    jeng, teng, jreqs, treqs = lockstep(model1, prompts, gens, **knobs)
    assert_same(jeng, teng, jreqs, treqs)
    st = teng.stats_summary()
    assert st["prefix_hits"] >= 2 and st["pages_cow"] >= 2
    assert st["prefix_bytes_copied"] == st["pages_cow"] * teng.page_bytes
    cold = ServeEngine(model1[1], model1[3], config=EngineConfig(
        prefix_cache=False, **knobs), device="cpu")
    creqs = [cold.submit(p, g) for p, g in zip(prompts, gens)]
    cold.run()
    assert [r.generated for r in creqs] == [r.generated for r in treqs]


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_dedup_hashes_codes_and_scales(model1, kv_dtype):
    """Interior spans shared by content over quantized pages: the digest
    covers every leaf, scales included, and a hit changes no token."""
    rng = np.random.default_rng(42)
    prompts = _dedup_prompts(model1[0].vocab, rng)
    gens = [4] * len(prompts)
    knobs = dict(DEDUP_KNOBS, kv_dtype=kv_dtype)
    _, off, _, offreqs = lockstep(model1, prompts, gens, **knobs)
    jeng, on, jreqs, onreqs = lockstep(model1, prompts, gens,
                                       page_dedup=True, **knobs)
    assert_same(jeng, on, jreqs, onreqs)
    assert [r.generated for r in onreqs] == [r.generated for r in offreqs]
    st = on.stats_summary()
    assert st["dedup_hits"] >= len(prompts) - 1
    assert st["dedup_hash_collisions"] == 0
    assert on.pool.used_count < off.pool.used_count
    page = next(iter(on.dedup.pages()))
    parts = tcache.page_bytes(on.state, on.pspecs, page)
    assert [p.numel() for p in parts] == [
        on.pspecs[n].shape[-2] * on.pspecs[n].shape[-1] * on.page_size
        if not n.endswith("_scale") else
        4 * on.pspecs[n].shape[-1] * on.page_size
        for n in sorted(on.state)]


@pytest.mark.parametrize("bad", [dict(kv_dtype="fp16"),
                                 dict(kv_dtype="int8", paged_kv=False)],
                         ids=["membership", "contiguous"])
def test_kv_dtype_validation_matches_jax(bad):
    msgs = []
    for cls in (EngineConfig, JConfig):
        with pytest.raises(ValueError) as e:
            cls(**bad).validate()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_kv_dtype_resolves_like_jax(model1):
    jcfg, tcfg, _, _ = model1
    for kv in ("fp32", "int8", "int4"):
        t = EngineConfig(max_seq=64, kv_dtype=kv).resolve(tcfg)
        j = JConfig(max_seq=64, kv_dtype=kv, paged_kv=True).resolve(jcfg)
        assert t.kv_dtype == j.kv_dtype == kv


def test_cli_serves_quantized_sampled_requests_to_length():
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--requests", "3", "--gen", "8", "--kv-dtype",
         "int4", "--temperature", "0.8", "--top-k", "40"],
        capture_output=True, text=True, env=env, cwd=root, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "kv_dtype=int4" in out.stdout
    assert "temperature=0.8, top_k=40" in out.stdout
    first = out.stdout.strip().splitlines()[-1]
    assert first.startswith("first request:")
    assert len(first.split("->")[1].strip().strip("[]").split(",")) == 8
