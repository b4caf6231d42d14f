"""The port's Multi-head Latent Attention against the JAX package.

The reduced ``minicpm3-4b`` config (fp32: 2 layers, d 64, 4 heads,
``q_lora_rank`` 24, ``kv_lora_rank`` 16, nope 8, rope 8, v 16) with the JAX
package's ``init_params`` weights carried across by ``params_from_numpy``,
and inputs and pools made from seeded numpy arrays.

* ``_queries``, ``_latent_kv`` and ``mla_train`` within 1e-5;
* ``mla_decode_pages`` against ``repro.models.mla.mla_decode_paged``
  within 1e-5, plain and with ``nvalid`` and ``tree``, the written pools
  too;
* over int8 and int4 ``(codes, scales)`` pools within 1e-4, the written
  pools within one code step (scratch page 0 aside);
* the ``lm`` entry points (``forward``, ``train_loss``, ``decode_step``,
  ``prefill_chunk``, ``verify_chunk``, ``verify_tree``, ``hidden_states``)
  within 1e-4, over fp32, int8 and int4 pools;
* the latent decode-state layout, its pooled and quantized forms and their
  bytes equal the JAX package's; ``get_api`` returns every entry point.

The engine's lockstep tests against the JAX engine run this config (1
layer) beside llama's in ``test_torch_{engine,prefix,spec_engine,
quant_kv,sampling}.py``."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.models import mla as jmla
from repro.models import quant_kv as jq
from repro.serve import cache as jcache
from repro_torch.models import lm as tlm
from repro_torch.models import mla as tmla
from repro_torch.models import quant_kv as tq
from repro_torch.models.registry import get_api
from repro_torch.serve import cache as tcache
from test_torch_prefix import _model
from test_torch_quant_kv import LIVE, _batches

ROOT = Path(__file__).resolve().parent.parent
ARCH = "minicpm3-4b"
PAGE, NUM_PAGES = 16, 10
BITS = {"int8": 8, "int4": 4}


@pytest.fixture(scope="module")
def model():
    return _model(arch=ARCH)


def _layer(model):
    _, _, jp, tp = model
    return (jax.tree.map(lambda a: a[0], jp["blocks"]["attn"]),
            {k: v[0] for k, v in tp["blocks"]["attn"].items()})


def _close(t, j, atol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# parameters and layouts
# ---------------------------------------------------------------------------

def test_params_from_numpy_carries_the_mla_tree(model):
    jcfg, tcfg, jp, tp = model
    attn = tp["blocks"]["attn"]
    assert sorted(attn) == ["kv_norm", "q_norm", "wk_b", "wkv_a", "wo",
                            "wq_a", "wq_b", "wv_b"]
    for name, leaf in jp["blocks"]["attn"].items():
        assert attn[name].shape == leaf.shape
        assert attn[name].shape[0] == jcfg.n_layers
        np.testing.assert_array_equal(attn[name].numpy(), np.asarray(leaf))
    specs = tlm.param_specs(tcfg)["blocks"]["attn"]
    assert {k: s.shape for k, s in specs.items()} == \
        {k: tuple(v.shape) for k, v in attn.items()}


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "int4"])
def test_latent_state_layout_matches_jax(model, kv_dtype):
    jcfg, tcfg, _, _ = model
    jd, td = jlm.decode_state_specs(jcfg, 2, 32), tlm.decode_state_specs(
        tcfg, 2, 32)
    assert sorted(td) == ["ckv", "kr"]
    assert {k: (s.shape, s.axes) for k, s in td.items()} == \
        {k: (tuple(s.shape), tuple(s.axes)) for k, s in jd.items()}
    jqs = jcache.quant_state_specs(jcache.paged_state_specs(jd, 16, 5),
                                   kv_dtype)
    tqs = tcache.quant_state_specs(tcache.paged_state_specs(td, 16, 5),
                                   kv_dtype)
    assert {k: (s.shape, s.axes) for k, s in tqs.items()} == \
        {k: (tuple(s.shape), tuple(s.axes)) for k, s in jqs.items()}
    assert tcache.state_bytes(tqs) == jcache.state_bytes(jqs)


def test_get_api_serves_mla(model):
    api = get_api(model[1])
    assert api.param_specs is tlm.param_specs
    for field in ("train_loss", "forward", "decode_state_specs",
                  "decode_step", "prefill_chunk", "verify_chunk",
                  "verify_tree", "draft_head_specs"):
        assert getattr(api, field) is getattr(tlm, field), field


def test_train_scale_rounds_like_jax():
    """1/sqrt(dn + dr) at the published width (96) and the reduced one
    (16), formed in the compute dtype as the JAX training path forms it."""
    for d in (96, 16):
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            want = 1.0 / jnp.sqrt(jnp.asarray(d, jnp.float32)).astype(jdt)
            assert tmla._train_scale(d, tdt) == float(want), (d, jdt)


# ---------------------------------------------------------------------------
# the layer's pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_slot", [False, True])
def test_queries_and_latent_kv_match_jax(model, per_slot):
    jcfg, tcfg, _, _ = model
    jl, tl = _layer(model)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, jcfg.d_model)).astype(np.float32)
    pos = (rng.integers(0, 60, (3, 5)) if per_slot else np.arange(7, 12))
    jq_, jr = jax.jit(jmla._queries, static_argnums=2)(
        jnp.asarray(x), jl, jcfg, jnp.asarray(pos, jnp.int32))
    tq_, tr = tmla._queries(torch.from_numpy(x), tl, tcfg,
                            torch.from_numpy(pos))
    assert tq_.shape == (3, 5, 4, 8) and tr.shape == (3, 5, 4, 8)
    _close(tq_, jq_, 1e-5)
    _close(tr, jr, 1e-5)
    jc, jk = jax.jit(jmla._latent_kv, static_argnums=2)(
        jnp.asarray(x), jl, jcfg, jnp.asarray(pos, jnp.int32))
    tc, tk = tmla._latent_kv(torch.from_numpy(x), tl, tcfg,
                             torch.from_numpy(pos))
    assert tc.shape == (3, 5, 16) and tk.shape == (3, 5, 8)
    _close(tc, jc, 1e-5)
    _close(tk, jk, 1e-5)


@pytest.mark.parametrize("seq", [32, 20])
def test_mla_train_matches_jax(model, seq):
    """Chunked over two query chunks of 16 (S = 32) and unchunked (16 does
    not divide S = 20)."""
    jcfg, tcfg, _, _ = model
    jl, tl = _layer(model)
    x = np.random.default_rng(2).standard_normal(
        (2, seq, jcfg.d_model)).astype(np.float32)
    _close(tmla.mla_train(torch.from_numpy(x), tl, tcfg),
           jax.jit(jmla.mla_train, static_argnums=2)(jnp.asarray(x), jl,
                                                     jcfg), 1e-5)


def _pools(cfg, seed):
    rng = np.random.default_rng(seed)
    return {name: (0.5 * rng.standard_normal(
        (cfg.n_layers, NUM_PAGES, PAGE, width))).astype(np.float32)
        for name, width in (("ckv", cfg.kv_lora_rank),
                            ("kr", cfg.qk_rope_dim))}


def _quant_pools(cfg, kv_dtype, seed):
    out = {}
    for name, x in _pools(cfg, seed).items():
        codes, scale = jq.quantize_rows(jnp.asarray(x), BITS[kv_dtype])
        out[name] = np.array(codes)
        out[name + "_scale"] = np.array(scale)
    return out


def _block(rng, vocab, block):
    """(x, cur, pages, extra JAX args, extra port args) of one layer call:
    a decode row per slot (a 0-length slot among them), a 16-row prefill
    piece, a row-masked chain block hanging past capacity, or a tree."""
    c = {"decode": 1, "prefill": 16, "chain": 4, "tree": 8}[block]
    b = 1 if block == "prefill" else 3
    x = rng.standard_normal((b, c, 64)).astype(np.float32)
    pages = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 0, 0, 0]])[:b]
    cur = np.array(32) if block == "prefill" else np.array([9, 60, 0])
    ej, et = (), ()
    if block == "chain":
        nvalid = np.array([4, 4, 1])
        ej, et = (jnp.asarray(nvalid, jnp.int32),), (torch.from_numpy(nvalid),)
    elif block == "tree":
        bt = _batches(rng, vocab)["verify_tree"]
        tree = (bt["parents"], bt["pos_off"], bt["nchain"])
        cur = bt["index"]
        ej = (jnp.asarray(bt["nspec"], jnp.int32),
              tuple(jnp.asarray(a, jnp.int32) for a in tree))
        et = (torch.from_numpy(bt["nspec"]),
              tuple(torch.as_tensor(a, dtype=torch.int64) for a in tree))
    return x, cur, pages, ej, et


#: slots whose output is real (a tree's third lane is idle)
BLOCK_LIVE = {"decode": slice(0, 3), "prefill": slice(0, 1),
              "chain": slice(0, 3), "tree": slice(0, 2)}


def _decode_layer(model, pools, block, seed):
    """One layer's call in both packages over ``pools`` (layer 0's leaves,
    a pair per leaf when quantized); returns (JAX out, port out, JAX pools,
    port pools, the port pools passed in)."""
    jcfg, tcfg, _, _ = model
    jl, tl = _layer(model)
    x, cur, pages, ej, et = _block(np.random.default_rng(seed), jcfg.vocab,
                                   block)
    jpools = [jax.tree.map(jnp.asarray, p) for p in pools]
    tpools = [tuple(torch.from_numpy(a.copy()) for a in p)
              if isinstance(p, tuple) else torch.from_numpy(p.copy())
              for p in pools]
    jout, jc, jk = jax.jit(jmla.mla_decode_paged, static_argnums=2)(
        jnp.asarray(x), jl, jcfg, *jpools, jnp.asarray(cur, jnp.int32),
        jnp.asarray(pages, jnp.int32), *ej)
    tout, tc, tk = tmla.mla_decode_pages(
        torch.from_numpy(x), tl, tcfg, *tpools, torch.from_numpy(cur),
        torch.from_numpy(pages), *et)
    return jout, tout, (jc, jk), (tc, tk), tpools


@pytest.mark.parametrize("block", sorted(BLOCK_LIVE))
def test_mla_decode_pages_matches_jax(model, block):
    pools = _pools(model[0], 3)
    jout, tout, jnew, tnew, tin = _decode_layer(
        model, [pools["ckv"][0], pools["kr"][0]], block, 4)
    assert tnew[0] is tin[0] and tnew[1] is tin[1]       # in place
    live = BLOCK_LIVE[block]
    assert tout.shape == jout.shape
    _close(tout[live], jout[live], 1e-5)
    for t, j in zip(tnew, jnew):
        np.testing.assert_allclose(t.numpy()[1:], np.asarray(j)[1:],
                                   atol=1e-5, rtol=0)
    assert not np.array_equal(tnew[0].numpy(), pools["ckv"][0])


def _close_quant(t, j):
    """Codes and scales, dequantized: within one code step of the JAX
    package's (its row's scale), scratch page 0 aside."""
    td = tq.dequantize_rows(t[0], t[1], torch.float32).numpy()
    jd = np.asarray(jq.dequantize_rows(j[0], j[1], jnp.float32))
    step = np.asarray(j[1])[1:, ..., None] * (1 + 1e-5)
    assert (np.abs(td[1:] - jd[1:]) <= step).all()
    np.testing.assert_allclose(t[1].numpy()[1:], np.asarray(j[1])[1:],
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("block", ["decode", "chain", "tree"])
def test_mla_decode_pages_over_quantized_pools_matches_jax(model, kv_dtype,
                                                           block):
    pools = _quant_pools(model[0], kv_dtype, 5)
    pair = [(pools[n][0], pools[n + "_scale"][0]) for n in ("ckv", "kr")]
    jout, tout, jnew, tnew, tin = _decode_layer(model, pair, block, 6)
    assert tnew[0][0] is tin[0][0] and tnew[1][1] is tin[1][1]
    assert tnew[0][0].dtype == (torch.int8 if kv_dtype == "int8"
                                else torch.uint8)
    live = BLOCK_LIVE[block]
    _close(tout[live], jout[live], 1e-4)
    for t, j in zip(tnew, jnew):
        _close_quant(t, j)


# ---------------------------------------------------------------------------
# the lm entry points
# ---------------------------------------------------------------------------

def test_forward_and_train_loss_match_jax(model):
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab, (2, 32))
    labels = rng.integers(0, jcfg.vocab, (2, 32))
    jl, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jcfg)
    tl, aux = tlm.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert float(aux) == 0.0
    _close(tl, jl, 1e-4)
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    assert abs(float(get_api(tcfg).train_loss(tp, tb, tcfg))
               - float(jlm.train_loss(jp, jb, jcfg))) <= 1e-4


def test_train_loss_gradient_flows_through_every_mla_weight(model):
    _, tcfg, _, tp = model
    params = {k: v for k, v in tp.items()}
    params["blocks"] = dict(tp["blocks"], attn={
        k: v.clone().requires_grad_() for k, v in
        tp["blocks"]["attn"].items()})
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, tcfg.vocab, (2, 16)))
    loss = tlm.train_loss(params, {"tokens": toks, "labels": toks}, tcfg)
    loss.backward()
    for name, w in params["blocks"]["attn"].items():
        assert w.grad is not None and bool(w.grad.abs().sum() > 0), name


def _entry(model, entry, pools):
    jcfg, tcfg, jp, tp = model
    batch = _batches(np.random.default_rng(3), jcfg.vocab)[entry]
    jstate = {k: jnp.asarray(v) for k, v in pools.items()}
    tstate = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v, dtype=torch.int64) for k, v in batch.items()}
    jout = getattr(jlm, entry)(jp, jstate, jb, jcfg)
    tout = getattr(tlm, entry)(tp, tstate, tb, tcfg)
    assert tout[0].dtype == torch.float32
    _close(tout[0][LIVE[entry]], jout[0][LIVE[entry]], 1e-4)
    return jout[-1], tout[-1]


@pytest.mark.parametrize("entry", sorted(LIVE))
def test_lm_entry_points_match_jax(model, entry):
    pools = _pools(model[0], 9)
    jstate, tstate = _entry(model, entry, pools)
    assert sorted(tstate) == ["ckv", "kr"]
    for k in tstate:
        np.testing.assert_allclose(tstate[k].numpy()[:, 1:],
                                   np.asarray(jstate[k])[:, 1:], atol=1e-5,
                                   rtol=0)
    assert not np.array_equal(tstate["ckv"].numpy(), pools["ckv"])


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
@pytest.mark.parametrize("entry", sorted(LIVE))
def test_lm_entry_points_over_quantized_pools_match_jax(model, kv_dtype,
                                                        entry):
    pools = _quant_pools(model[0], kv_dtype, 10)
    jstate, tstate = _entry(model, entry, pools)
    assert sorted(tstate) == ["ckv", "ckv_scale", "kr", "kr_scale"]
    for n in ("ckv", "kr"):
        for layer in range(model[0].n_layers):
            _close_quant((tstate[n][layer], tstate[n + "_scale"][layer]),
                         (jstate[n][layer], jstate[n + "_scale"][layer]))


def test_hidden_states_match_jax(model):
    """The port's temporary latent pool against the JAX package's dense
    cache: the teacher-forced hidden states the draft heads fit on."""
    jcfg, tcfg, jp, tp = model
    toks = np.random.default_rng(11).integers(0, jcfg.vocab, (2, 21))
    _close(tlm.hidden_states(tp, tcfg, torch.from_numpy(toks)),
           jlm.hidden_states(jp, jcfg, jnp.asarray(toks, jnp.int32)), 1e-4)


def test_quantized_latent_state_needs_a_page_table(model):
    pools = _quant_pools(model[0], "int8", 12)
    state = {k: torch.from_numpy(v) for k, v in pools.items()}
    batch = {"tokens": torch.zeros((1, 1), dtype=torch.int64),
             "index": torch.tensor([0])}
    with pytest.raises(ValueError, match="requires a page table"):
        tlm.decode_step(model[3], state, batch, model[1])


def test_cli_serves_mla_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--requests", "3", "--gen", "6"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"[engine] arch={ARCH} device=cpu" in out.stdout
    first = out.stdout.strip().splitlines()[-1]
    assert first.startswith("first request:")
    assert len(first.split("->")[1].strip().strip("[]").split(",")) == 6
