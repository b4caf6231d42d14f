"""The port's SSM layers and SSM LM against the JAX package.

Reduced fp32 configs: ``falcon-mamba-7b`` (Mamba-1) and ``zamba2-1.2b``'s
Mamba-2 layer.  JAX ``init_params`` weights go through
``params_from_numpy``; inputs come from numpy seeds.  The ``ssm_a``
initialiser and every parameter and state spec equal the JAX ones exactly;
the convs agree within 1e-6; ``mamba1_decode`` / ``mamba2_decode`` and the
LM's ``decode_step`` (0-d and (B,) index) and ``prefill_chunk`` (``nvalid``
< C) within ``rtol = atol = 1e-5``; ``mamba*_train``, ``ssm_forward`` and
``ssm_train_loss`` at S = 13 (one chunk: the reduced ``ssm_chunk`` 8 does
not divide it) and S = 32 (four chunks) within 2e-5, and every gradient of
the loss within 1e-4 of ``jax.grad``.  The port's prefill is
``torch.equal`` to its own per-token decode loop, logits and state, and
bucket padding changes nothing."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.models import hybrid as jhybrid
from repro.models import registry as jreg
from repro.models import ssm as jssm
from repro.models.common import init_params as jinit
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import hybrid as thybrid
from repro_torch.models import registry as treg
from repro_torch.models import ssm as tssm
from repro_torch.models.common import ParamSpec, init_params as tinit
from repro_torch.tree import leaves, map_tree


def ssm_model(arch="falcon-mamba-7b", seed=0, **over):
    """(JAX config, port config, JAX params, port params) of the reduced
    fp32 ``arch``; the hybrid's ``lora_b`` (zeros at init) is drawn
    random, so the LoRA delta on ``wq`` is exercised."""
    jcfg = jget(arch).reduced(dtype=jnp.float32, **over)
    tcfg = tget(arch).reduced(dtype=torch.float32, **over)
    jp = jinit(jreg.get_api(jcfg).param_specs(jcfg), jax.random.key(seed))
    if "lora_b" in jp:
        rng = np.random.default_rng(seed + 100)
        jp["lora_b"] = jnp.asarray(
            0.2 * rng.standard_normal(jp["lora_b"].shape), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           torch.float32)
    return jcfg, tcfg, jp, tp


def close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=tol, atol=tol)


def tbatch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def spec_tuple(s):
    """A spec's fields, its dtype by name (jnp and torch dtypes differ)."""
    dt = (str(s.dtype).split(".")[-1] if isinstance(s.dtype, torch.dtype)
          else np.dtype(s.dtype).name)
    return (tuple(s.shape), tuple(s.axes), dt, s.init, s.scale)


def assert_same_specs(tspecs, jspecs):
    """The same nesting, key for key, and the same fields at every leaf."""
    flat = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: hasattr(x, "axes"))[0]
    assert len(flat) == len(leaves(tspecs))
    for path, j in flat:
        t = tspecs
        for k in path:
            t = t[k.key]
        assert spec_tuple(t) == spec_tuple(j), path


def zero_state(specs, jax_side):
    if jax_side:
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), specs,
                            is_leaf=lambda x: hasattr(x, "axes"))
    return map_tree(lambda s: torch.zeros(s.shape, dtype=s.dtype), specs)


def random_state(tspecs, rng):
    """The same random state for both packages: {name: numpy array}."""
    return {k: (0.3 * rng.standard_normal(s.shape)).astype(np.float32)
            for k, s in tspecs.items()}


@pytest.fixture(scope="module")
def m1():
    return ssm_model("falcon-mamba-7b")


@pytest.fixture(scope="module")
def m2():
    return ssm_model("zamba2-1.2b")


# ---------------------------------------------------------------------------
# initialisers and specs, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8,), (64, 8), (3, 16, 16), (2, 64), (4, 6)])
def test_ssm_a_equals_jax(shape):
    """``log(1..state)`` on the last axis: every entry the correctly
    rounded fp32 log, and within one ulp of the JAX table (XLA's CPU log
    is a polynomial, not correctly rounded: it is one ulp off at log(7)
    and at 15 more of the first 1024 integers)."""
    from repro.models.common import _init_leaf as jleaf
    from repro.models.common import ParamSpec as JSpec
    j = np.asarray(jleaf(JSpec(shape, (None,) * len(shape), init="ssm_a"),
                         jax.random.key(0)))
    t = tinit({"a": ParamSpec(shape, (None,) * len(shape), init="ssm_a")},
              torch.Generator().manual_seed(0), torch.device("cpu"))["a"]
    want = np.broadcast_to(np.array(
        [np.float32(math.log(n)) for n in range(1, shape[-1] + 1)]), shape)
    assert t.dtype == torch.float32 and tuple(t.shape) == shape
    np.testing.assert_array_equal(t.numpy(), want)
    np.testing.assert_array_max_ulp(t.numpy(), j, maxulp=1)
    if shape[-1] < 7:
        np.testing.assert_array_equal(t.numpy(), j)


def test_ssm_dt_is_log_uniform_from_the_generator():
    spec = {"d": ParamSpec((4096,), (None,), init="ssm_dt")}
    a = tinit(spec, torch.Generator().manual_seed(3), torch.device("cpu"))
    b = tinit(spec, torch.Generator().manual_seed(3), torch.device("cpu"))
    c = tinit(spec, torch.Generator().manual_seed(4), torch.device("cpu"))
    assert torch.equal(a["d"], b["d"]) and not torch.equal(a["d"], c["d"])
    d = a["d"]
    assert d.dtype == torch.float32
    assert float(d.min()) >= 1e-3 * (1 - 1e-6)
    assert float(d.max()) <= 1e-1 * (1 + 1e-6)
    # uniform in log space: the mean of log10 is -2, the quartiles -2.5/-1.5
    lg = torch.log10(d)
    assert abs(float(lg.mean()) + 2.0) < 0.05
    q = torch.quantile(lg, torch.tensor([0.25, 0.75]))
    assert abs(float(q[0]) + 2.5) < 0.06 and abs(float(q[1]) + 1.5) < 0.06


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
@pytest.mark.parametrize("reduced", [True, False])
def test_mamba_param_specs_equal_jax(arch, reduced):
    jcfg, tcfg = jget(arch), tget(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jf, tf = ((jssm.mamba1_param_specs, tssm.mamba1_param_specs)
              if jcfg.ssm_variant == "mamba1" else
              (jssm.mamba2_param_specs, tssm.mamba2_param_specs))
    assert_same_specs(tf(tcfg), jf(jcfg))
    # the JAX quirk: Mamba-2's A_log is drawn with the dt initialiser
    if jcfg.ssm_variant == "mamba2":
        assert tf(tcfg)["A_log"].init == "ssm_dt"


@pytest.mark.parametrize("reduced", [True, False])
def test_ssm_lm_specs_equal_jax(reduced):
    jcfg, tcfg = jget("falcon-mamba-7b"), tget("falcon-mamba-7b")
    if reduced:
        jcfg = jcfg.reduced(dtype=jnp.float32)
        tcfg = tcfg.reduced(dtype=torch.float32)
    assert_same_specs(thybrid.ssm_param_specs(tcfg),
                      jhybrid.ssm_param_specs(jcfg))
    assert_same_specs(thybrid.ssm_decode_state_specs(tcfg, 3, 64),
                      jhybrid.ssm_decode_state_specs(jcfg, 3, 64))


def test_init_state_shapes_equal_jax(m1, m2):
    for (jcfg, tcfg, _, _), jf, tf in (
            (m1, jssm.mamba1_init_state, tssm.mamba1_init_state),
            (m2, jssm.mamba2_init_state, tssm.mamba2_init_state)):
        j, t = jf(jcfg, 3), tf(tcfg, 3)
        assert sorted(j) == sorted(t)
        for k in j:
            assert tuple(t[k].shape) == j[k].shape
            assert t[k].dtype == torch.float32 and not t[k].any()


# ---------------------------------------------------------------------------
# the convs and the scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 5, 13])
def test_causal_conv1d_within_1e6(s):
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 24)).astype(np.float32)
    w = rng.standard_normal((24, 4)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    j = jssm._causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    t = tssm._causal_conv1d(*map(torch.from_numpy, (x, w, b)))
    close(t, j, 1e-6)


def test_conv_step_within_1e6_and_equals_the_sequence_conv():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 24)).astype(np.float32)
    w = rng.standard_normal((24, 4)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    cache_j = jnp.zeros((2, 3, 24), jnp.float32)
    cache_t = torch.zeros((2, 3, 24))
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    ys = []
    for i in range(7):
        yj, cache_j = jssm._conv_step(jnp.asarray(x[:, i:i + 1]), cache_j,
                                      jnp.asarray(w), jnp.asarray(b))
        yt, cache_t = tssm._conv_step(torch.from_numpy(x[:, i:i + 1]),
                                      cache_t, tw, tb)
        close(yt, yj, 1e-6)
        close(cache_t, cache_j, 1e-6)
        ys.append(yt)
    # the tap order is the sequence conv's: the steps equal it
    full = tssm._causal_conv1d(torch.from_numpy(x), tw, tb)
    assert torch.equal(torch.cat(ys, 1), full)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 13, 16])
def test_assoc_scan_equals_jax_and_the_recurrence(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.0, 1.0, (2, n, 3)).astype(np.float32)
    b = rng.standard_normal((2, n, 3)).astype(np.float32)
    ja, jb = jax.lax.associative_scan(jssm._ssm_assoc_op,
                                      (jnp.asarray(a), jnp.asarray(b)),
                                      axis=1)
    ta, tb = tssm._assoc_scan([torch.from_numpy(a), torch.from_numpy(b)], 1)
    close(ta, ja, 1e-6)
    close(tb, jb, 1e-6)
    h = np.zeros((2, 3), np.float32)
    for t in range(n):
        h = a[:, t] * h + b[:, t]
        np.testing.assert_allclose(tb[:, t].numpy(), h, rtol=1e-5,
                                   atol=1e-6)


def test_assoc_scan_is_stable_where_a_cumprod_underflows():
    """exp(dt * A) products reach 0 in fp32 within a chunk: the scan stays
    finite and equal to the recurrence (a cumprod-and-divide would give
    0/0)."""
    n = 64
    a = torch.full((1, n, 1), 0.05)
    b = torch.ones((1, n, 1))
    acum, bcum = tssm._assoc_scan([a, b], 1)
    assert float(acum[0, -1, 0]) == 0.0
    h = torch.zeros(1)
    for t in range(n):
        h = a[0, t] * h + b[0, t]
    assert torch.isfinite(bcum).all()
    assert abs(float(bcum[0, -1, 0]) - float(h[0])) < 1e-6


# ---------------------------------------------------------------------------
# the Mamba layers
# ---------------------------------------------------------------------------

def _block(model):
    """Layer 0's Mamba params of either family, both packages."""
    jcfg, tcfg, jp, tp = model
    if "blocks" in jp:
        return (jax.tree.map(lambda a: a[0], jp["blocks"]["ssm"]),
                map_tree(lambda a: a[0], tp["blocks"]["ssm"]))
    return (jax.tree.map(lambda a: a[0, 0], jp["mamba_groups"]["ssm"]),
            map_tree(lambda a: a[0, 0], tp["mamba_groups"]["ssm"]))


@pytest.mark.parametrize("variant", ["mamba1", "mamba2"])
@pytest.mark.parametrize("s", [13, 32])
def test_mamba_train_within_2e5(m1, m2, variant, s):
    model = m1 if variant == "mamba1" else m2
    jcfg, tcfg = model[:2]
    jb, tb = _block(model)
    x = np.random.default_rng(s).standard_normal(
        (2, s, tcfg.d_model)).astype(np.float32)
    jf = jssm.mamba1_train if variant == "mamba1" else jssm.mamba2_train
    tf = tssm.mamba1_train if variant == "mamba1" else tssm.mamba2_train
    j = jax.jit(lambda p, x: jf(x, p, jcfg))(jb, jnp.asarray(x))
    t = tf(torch.from_numpy(x), tb, tcfg)
    close(t, j, 2e-5)


@pytest.mark.parametrize("variant", ["mamba1", "mamba2"])
def test_mamba_decode_within_1e5(m1, m2, variant):
    model = m1 if variant == "mamba1" else m2
    jcfg, tcfg = model[:2]
    jb, tb = _block(model)
    rng = np.random.default_rng(5)
    init = (tssm.mamba1_init_state if variant == "mamba1"
            else tssm.mamba2_init_state)(tcfg, 3)
    st = {k: (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
          for k, v in init.items()}
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    jf = jssm.mamba1_decode if variant == "mamba1" else jssm.mamba2_decode
    tf = tssm.mamba1_decode if variant == "mamba1" else tssm.mamba2_decode
    jstep = jax.jit(lambda p, x, s: jf(x, p, jcfg, s))
    for i in range(4):
        x = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
        jo, jst = jstep(jb, jnp.asarray(x), jst)
        to, new = tf(torch.from_numpy(x), tb, tcfg, tst)
        # the new state comes back as new tensors
        assert all(new[k] is not tst[k] for k in tst)
        tst = new
        close(to, jo, 1e-5)
        for k in tst:
            close(tst[k], jst[k], 1e-5)


def test_mamba1_train_equals_decode_loop(m1):
    """The chunked scan of the training path and the decode step give the
    same outputs (the two paths the engine and training take)."""
    _, tcfg, _, _ = m1
    _, tb = _block(m1)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 16, tcfg.d_model)).astype(np.float32))
    full = tssm.mamba1_train(x, tb, tcfg)
    st = tssm.mamba1_init_state(tcfg, 2)
    outs = []
    for i in range(16):
        o, st = tssm.mamba1_decode(x[:, i:i + 1], tb, tcfg, st)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=2e-5,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# the SSM LM
# ---------------------------------------------------------------------------

def lm_batch(cfg, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (2, s)).astype(np.int32)
    mask = (rng.uniform(size=(2, s)) < 0.8).astype(np.float32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1), "loss_mask": mask}


def loss_and_grads(model, s, seed=0):
    """(JAX loss, JAX grads, port loss, port grads) of the family's
    ``train_loss`` on one batch."""
    jcfg, tcfg, jp, tp = model
    japi, tapi = jreg.get_api(jcfg), treg.get_api(tcfg)
    batch = lm_batch(jcfg, s, seed)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: japi.train_loss(p, b, jcfg)))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = map_tree(lambda a: a.clone().requires_grad_(True), tp)
    tl = tapi.train_loss(tparams, tbatch(batch), tcfg)
    tl.backward()
    return jl, jg, tl, map_tree(lambda a: a.grad, tparams)


def assert_grads_close(tg, jg, tol):
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    for path, j in flat:
        t = tg
        for k in path:
            t = t[k.key]
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol,
                                   atol=tol, err_msg=str(path))


@pytest.mark.parametrize("s", [13, 32])
def test_ssm_forward_within_2e5(m1, s):
    jcfg, tcfg, jp, tp = m1
    batch = lm_batch(jcfg, s, 1)
    j = jax.jit(lambda p, b: jhybrid.ssm_forward(p, b, jcfg))(
        jp, {"tokens": jnp.asarray(batch["tokens"])})
    t, aux = thybrid.ssm_forward(tp, tbatch(batch), tcfg)
    close(t, j, 2e-5)
    assert aux.shape == () and float(aux) == 0.0


@pytest.mark.parametrize("s", [13, 32])
def test_ssm_train_loss_and_grads_match_jax(m1, s):
    jl, jg, tl, tg = loss_and_grads(m1, s)
    close(tl, jl, 2e-5)
    assert_grads_close(tg, jg, 1e-4)


def test_ssm_remat_keeps_loss_and_grads(m1):
    import dataclasses
    _, tcfg, _, tp = m1
    batch = tbatch(lm_batch(tcfg, 16, 2))
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        p = map_tree(lambda a: a.clone().requires_grad_(True), tp)
        loss = thybrid.ssm_train_loss(p, batch, cfg)
        loss.backward()
        out.append((loss.detach(), leaves(map_tree(lambda a: a.grad, p))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def decode_steps(model, index_kind, steps=4, seed=3, b=3, smax=16):
    """Both packages' ``decode_step`` from one random state; asserts the
    logits and every leaf within 1e-5 after each step."""
    jcfg, tcfg, jp, tp = model
    japi, tapi = jreg.get_api(jcfg), treg.get_api(tcfg)
    rng = np.random.default_rng(seed)
    specs = tapi.decode_state_specs(tcfg, b, smax)
    st = random_state(specs, rng)
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    jstep = jax.jit(lambda p, s, bt: japi.decode_step(p, s, bt, jcfg))
    for i in range(steps):
        tok = rng.integers(0, jcfg.vocab, (b, 1))
        idx = (np.asarray(i + 2) if index_kind == "scalar"
               else rng.integers(0, smax, b))
        jlg, jst = jstep(jp, jst, {"tokens": jnp.asarray(tok, jnp.int32),
                                   "index": jnp.asarray(idx, jnp.int32)})
        tlg, out = tapi.decode_step(
            tp, tst, {"tokens": torch.from_numpy(tok),
                      "index": torch.from_numpy(np.asarray(idx))}, tcfg)
        assert out is tst                       # written in place
        assert tlg.dtype == torch.float32 and tlg.shape == (b, tcfg.vocab)
        close(tlg, jlg, 1e-5)
        for k in tst:
            close(tst[k], jst[k], 1e-5)


@pytest.mark.parametrize("index_kind", ["scalar", "vector"])
def test_ssm_decode_step_within_1e5(m1, index_kind):
    decode_steps(m1, index_kind)


def prefill_vs_jax(model, c=8, nvalid=5, b=2, smax=16, seed=4):
    """One ``prefill_chunk`` of ``nvalid`` < C tokens, bucket padding
    behind them, from a random state: logits and state within 1e-5."""
    jcfg, tcfg, jp, tp = model
    japi, tapi = jreg.get_api(jcfg), treg.get_api(tcfg)
    rng = np.random.default_rng(seed)
    st = random_state(tapi.decode_state_specs(tcfg, b, smax), rng)
    toks = rng.integers(0, jcfg.vocab, (b, c))
    jlg, jst = jax.jit(lambda p, s, bt: japi.prefill_chunk(p, s, bt, jcfg))(
        jp, {k: jnp.asarray(v) for k, v in st.items()},
        {"tokens": jnp.asarray(toks, jnp.int32),
         "index": jnp.asarray(3, jnp.int32),
         "nvalid": jnp.asarray(nvalid, jnp.int32)})
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    tlg, _ = tapi.prefill_chunk(
        tp, tst, {"tokens": torch.from_numpy(toks), "index": torch.tensor(3),
                  "nvalid": nvalid}, tcfg)
    close(tlg, jlg, 1e-5)
    for k in tst:
        close(tst[k], jst[k], 1e-5)


@pytest.mark.parametrize("nvalid", [1, 5, 8])
def test_ssm_prefill_chunk_within_1e5(m1, nvalid):
    prefill_vs_jax(m1, nvalid=nvalid)


def prefill_equals_loop(model, p=13, chunk=8, b=2, smax=24):
    """The port's chunked prefill (pieces of ``chunk``, the last padded to
    the bucket) is ``torch.equal`` to its per-token decode loop."""
    _, tcfg, _, tp = model
    api = treg.get_api(tcfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, tcfg.vocab, (b, p)))
    specs = api.decode_state_specs(tcfg, b, smax)
    ref = zero_state(specs, False)
    for i in range(p):
        ref_lg, ref = api.decode_step(
            tp, ref, {"tokens": toks[:, i:i + 1], "index": torch.tensor(i)},
            tcfg)
    got = zero_state(specs, False)
    pos = 0
    while pos < p:
        n = min(chunk, p - pos)
        piece = torch.full((b, chunk), 42, dtype=torch.int64)
        piece[:, :n] = toks[:, pos:pos + n]
        lg, got = api.prefill_chunk(
            tp, got, {"tokens": piece, "index": torch.tensor(pos),
                      "nvalid": n}, tcfg)
        pos += n
    assert torch.equal(lg, ref_lg)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_ssm_prefill_equals_per_token_loop(m1):
    prefill_equals_loop(m1)


def bucket_padding_inert(model):
    """Padding a chunk to its bucket with other tokens changes neither
    the logits nor the state, nor the next decode step."""
    _, tcfg, _, tp = model
    api = treg.get_api(tcfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab, (1, 5)))
    specs = api.decode_state_specs(tcfg, 1, 16)
    outs = []
    for pad in (None, 42, 7):
        st = zero_state(specs, False)
        piece = toks if pad is None else torch.cat(
            [toks, torch.full((1, 3), pad)], 1)
        lg, st = api.prefill_chunk(
            tp, st, {"tokens": piece, "index": torch.tensor(0),
                     "nvalid": 5}, tcfg)
        nxt, st = api.decode_step(
            tp, st, {"tokens": torch.tensor([[3]]), "index": torch.tensor(5)},
            tcfg)
        outs.append((lg, nxt, st))
    for lg, nxt, st in outs[1:]:
        assert torch.equal(lg, outs[0][0]) and torch.equal(nxt, outs[0][1])
        for k in st:
            assert torch.equal(st[k], outs[0][2][k])


def test_ssm_bucket_padding_is_inert(m1):
    bucket_padding_inert(m1)


def test_prefill_with_no_valid_token_keeps_the_state(m1):
    _, tcfg, _, tp = m1
    api = treg.get_api(tcfg)
    st = {k: torch.from_numpy(v) for k, v in random_state(
        api.decode_state_specs(tcfg, 1, 8), np.random.default_rng(0)).items()}
    before = {k: v.clone() for k, v in st.items()}
    lg, st = api.prefill_chunk(tp, st, {"tokens": torch.zeros((1, 8),
                                                              dtype=torch.int64),
                                        "index": torch.tensor(0),
                                        "nvalid": 0}, tcfg)
    assert not lg.any() and lg.shape == (1, tcfg.vocab)
    assert all(torch.equal(st[k], before[k]) for k in st)
