"""The port's speculative model surface against the JAX package.

Row-masked and ancestor-masked writes and masks (``masked_cache_write``,
``ancestor_matrix``, ``tree_valid``, ``scatter_token_rows(nvalid)``) are
integer or copy operations and must be equal exactly.  ``verify_chunk``,
``verify_tree`` and ``hidden_states`` run the reduced ``llama3.2-3b``
config (fp32, ``n_kv_heads=2``) on the JAX weights (``params_from_numpy``)
and paged pools made from the same numpy arrays: logits within
``atol=1e-4``, pools within ``1e-5`` with scratch page 0 left out (it takes
the masked rows, in no defined order); the draft-head candidates must be
equal, ties ranked lower token id first as ``jax.lax.top_k`` ranks them.
The draft-head fit is held to the JAX formula: the loss within ``1e-5``,
its gradients within ``1e-6`` (absolute) and one bias-corrected Adam
update from equal weights and gradients within ``1e-6``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import paging as jpaging
from repro.models.common import init_params as jinit
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models import paging as tpaging

PAGE, NUM_PAGES = 16, 10


@pytest.fixture(scope="module")
def models():
    jcfg = jget("llama3.2-3b").reduced(dtype=jnp.float32, n_kv_heads=2)
    tcfg = tget("llama3.2-3b").reduced(dtype=torch.float32, n_kv_heads=2)
    jp = jinit(jlm.param_specs(jcfg), jax.random.key(0))
    jp["draft_heads"] = jinit(jlm.draft_head_specs(jcfg, n_heads=3,
                                                   head_dim=16),
                              jax.random.key(7))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           torch.float32)
    return jcfg, tcfg, jp, tp


def _pools(cfg, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, NUM_PAGES, PAGE, cfg.n_kv_heads, cfg.hd)
    return {k: (0.5 * rng.standard_normal(shape)).astype(np.float32)
            for k in ("k", "v")}


def _close_pools(tstate, jstate):
    """Pools equal within 1e-5 outside scratch page 0."""
    for k in ("k", "v"):
        np.testing.assert_allclose(tstate[k].numpy()[:, 1:],
                                   np.asarray(jstate[k])[:, 1:],
                                   atol=1e-5, rtol=1e-5)


def _jbatch(batch):
    return {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.int64)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# masks and masked writes, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared_pos", [False, True])
def test_masked_cache_write_drops_rows_near_capacity(shared_pos):
    """Rows at or past ``nvalid`` or capacity are dropped, not clamped
    over earlier positions; ``batched_cache_write`` keeps clamping like
    ``dynamic_update_slice``."""
    rng = np.random.default_rng(0)
    b, s, c = 4, 12, 5
    cache = rng.standard_normal((b, s, 2, 4)).astype(np.float32)
    new = rng.standard_normal((b, c, 2, 4)).astype(np.float32)
    if shared_pos:
        pos = np.arange(9, 9 + c)                       # 12, 13 past S
    else:
        pos = np.array([3, 10, 0, 9])[:, None] + np.arange(c)[None]
    nvalid = np.array([5, 5, 0, 2])
    want = jattn.masked_cache_write(jnp.asarray(cache), jnp.asarray(new),
                                    jnp.asarray(pos, jnp.int32),
                                    jnp.asarray(nvalid, jnp.int32))
    got = tattn.masked_cache_write(torch.from_numpy(cache.copy()),
                                   torch.from_numpy(new),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(nvalid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if not shared_pos:
        # slot 1 (positions 10..14): rows 2..4 dropped, and positions
        # 7..9, where a clamped start would have shifted them, untouched
        np.testing.assert_array_equal(got.numpy()[1, :10], cache[1, :10])
    cur = np.array([3, 10, 0, 9])
    clamp_j = jattn.batched_cache_write(jnp.asarray(cache), jnp.asarray(new),
                                        jnp.asarray(cur, jnp.int32))
    clamp_t = tattn.batched_cache_write(torch.from_numpy(cache.copy()),
                                        torch.from_numpy(new),
                                        torch.from_numpy(cur))
    np.testing.assert_array_equal(clamp_t.numpy(), np.asarray(clamp_j))


def _random_blocks(rng, b, cw):
    """Engine-shaped tree blocks: per slot a chain part of u rows, then a
    random tree of n nodes, then self-parented padding; idle slots."""
    parents = np.broadcast_to(np.arange(cw), (b, cw)).copy()
    nvalid = np.zeros(b, np.int64)
    nchain = np.zeros(b, np.int64)
    pos_off = np.zeros((b, cw), np.int64)
    for s in range(b):
        if rng.random() < 0.2:
            continue                                    # idle lane
        u = int(rng.integers(1, 4))
        n = int(rng.integers(0, cw - u + 1))
        parents[s, 0] = -1
        parents[s, 1:u] = np.arange(u - 1)
        pos_off[s, :u] = np.arange(u)
        depth = {}
        for i in range(n):
            par = int(rng.integers(-1, i))
            depth[i] = 1 if par < 0 else depth[par] + 1
            parents[s, u + i] = u - 1 if par < 0 else u + par
            pos_off[s, u + i] = u - 1 + depth[i]
        nchain[s], nvalid[s] = u, u + n
    return parents, pos_off, nchain, nvalid


@pytest.mark.parametrize("seed", range(3))
def test_ancestor_matrix_and_tree_valid_equal(seed):
    rng = np.random.default_rng(seed)
    b, cw, smax = 5, 9, 40
    parents, _, _, nvalid = _random_blocks(rng, b, cw)
    index = rng.integers(0, smax - cw, b)
    want = jattn.ancestor_matrix(jnp.asarray(parents, jnp.int32))
    got = tattn.ancestor_matrix(torch.from_numpy(parents))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jattn.tree_valid(jnp.asarray(index, jnp.int32),
                            jnp.asarray(parents, jnp.int32),
                            jnp.asarray(nvalid, jnp.int32), smax)
    got = tattn.tree_valid(torch.from_numpy(index),
                           torch.from_numpy(parents),
                           torch.from_numpy(nvalid), smax)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shared_pos", [False, True])
def test_scatter_token_rows_nvalid_equal(shared_pos):
    """Valid rows land through the table, the rest on scratch page 0
    (compared without it)."""
    rng = np.random.default_rng(1)
    pool = rng.standard_normal((NUM_PAGES, PAGE, 2, 4)).astype(np.float32)
    pages = np.array([[1, 2, 3], [4, 5, 6], [0, 0, 0], [7, 8, 9]])
    rows = rng.standard_normal((4, 6, 2, 4)).astype(np.float32)
    if shared_pos:
        pos = np.arange(44, 50)                         # 48, 49 past table
    else:
        pos = np.array([[14], [40], [0], [3]]) + np.arange(6)[None]
    nvalid = np.array([6, 5, 0, 2])
    want = jpaging.scatter_token_rows(jnp.asarray(pool),
                                      jnp.asarray(pages, jnp.int32),
                                      jnp.asarray(rows),
                                      jnp.asarray(pos, jnp.int32),
                                      jnp.asarray(nvalid, jnp.int32))
    got = tpaging.scatter_token_rows(torch.from_numpy(pool.copy()),
                                     torch.from_numpy(pages),
                                     torch.from_numpy(rows),
                                     torch.from_numpy(pos),
                                     torch.from_numpy(nvalid))
    np.testing.assert_array_equal(got.numpy()[1:], np.asarray(want)[1:])
    assert not np.array_equal(got.numpy()[1:], pool[1:])


# ---------------------------------------------------------------------------
# verify entry points
# ---------------------------------------------------------------------------

def test_verify_chunk_matches_jax(models):
    """Three slots: 3 drafts at index 5, a block hanging past capacity
    (rows at 64, 65 dropped), an idle lane (``nspec`` 0)."""
    jcfg, tcfg, jp, tp = models
    pools = _pools(jcfg, 2)
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (3, 4)),
             "index": np.array([5, 62, 0]), "nspec": np.array([4, 4, 0]),
             "pages": np.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]])}
    jl, jstate = jlm.verify_chunk(jp, {k: jnp.asarray(v) for k, v in
                                       pools.items()}, _jbatch(batch), jcfg)
    tstate = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    tl, tstate = tlm.verify_chunk(tp, tstate, _tbatch(batch), tcfg)
    assert tl.shape == (3, 4, jcfg.vocab) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                               atol=1e-4)
    _close_pools(tstate, jstate)


def _tree_batch(rng, vocab, cw=8):
    """Slot 0: 2 chain rows at index 7, a 4-node tree (a fork at the
    root); slot 1: 1 chain row at index 20, a 3-node chain tree; slot 2
    idle."""
    parents = np.broadcast_to(np.arange(cw), (3, cw)).copy()
    pos_off = np.zeros((3, cw), np.int64)
    parents[0, :6] = [-1, 0, 1, 1, 2, 4]
    pos_off[0, :6] = [0, 1, 2, 2, 3, 4]
    parents[1, :4] = [-1, 0, 1, 2]
    pos_off[1, :4] = [0, 1, 2, 3]
    return {"tokens": rng.integers(0, vocab, (3, cw)),
            "index": np.array([7, 20, 0]), "parents": parents,
            "pos_off": pos_off, "nchain": np.array([2, 1, 0]),
            "nspec": np.array([6, 4, 0]),
            "pages": np.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]])}


def test_verify_tree_matches_jax(models):
    """Logits at every valid row, the draft heads' candidates, and pools
    where only the chain rows were committed."""
    jcfg, tcfg, jp, tp = models
    pools = _pools(jcfg, 3)
    batch = _tree_batch(np.random.default_rng(3), jcfg.vocab)
    jl, jtop, jstate = jlm.verify_tree(
        jp, {k: jnp.asarray(v) for k, v in pools.items()}, _jbatch(batch),
        jcfg, head_topk=3)
    tstate = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    tl, ttop, tstate = tlm.verify_tree(tp, tstate, _tbatch(batch), tcfg,
                                       head_topk=3)
    for s, n in enumerate((6, 4)):
        np.testing.assert_allclose(tl.numpy()[s, :n], np.asarray(jl)[s, :n],
                                   atol=1e-4)
        np.testing.assert_array_equal(ttop.numpy()[s, :n],
                                      np.asarray(jtop)[s, :n])
    assert ttop.shape == (3, 8, 3, 3)
    _close_pools(tstate, jstate)
    # drafted rows committed nothing: slot 0's row 2 (position 9) and
    # beyond are the pool's old values
    flat = tstate["k"].numpy()[:, 1:5].reshape(jcfg.n_layers, 64, -1)
    old = pools["k"][:, 1:5].reshape(jcfg.n_layers, 64, -1)
    np.testing.assert_array_equal(flat[:, 9:], old[:, 9:])
    assert not np.array_equal(flat[:, 7:9], old[:, 7:9])


def test_verify_tree_without_heads_returns_none(models):
    jcfg, tcfg, jp, tp = models
    batch = _tree_batch(np.random.default_rng(4), jcfg.vocab)
    plain = {k: v for k, v in tp.items() if k != "draft_heads"}
    state = {k: torch.from_numpy(v) for k, v in _pools(jcfg, 4).items()}
    _, top, _ = tlm.verify_tree(plain, state, _tbatch(batch), tcfg)
    assert top is None


@pytest.mark.parametrize("seed", range(3))
def test_top_k_ranks_ties_like_jax(seed):
    """Values from a small integer range (many exact ties, -0 and +0
    among them): the port's ranking equals ``jax.lax.top_k``'s; so do the
    draft-head candidates when ``lm_head`` has duplicate columns."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (4, 6, 50)).astype(np.float32)
    x[0, 0, :5] = -0.0
    for k in (1, 3, 7):
        want = np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1])
        got = tlm.topk_low_index_first(torch.from_numpy(x), k).numpy()
        np.testing.assert_array_equal(got, want)
    jcfg = jget("llama3.2-3b").reduced(dtype=jnp.float32, n_kv_heads=2)
    heads = jinit(jlm.draft_head_specs(jcfg, n_heads=2, head_dim=8),
                  jax.random.key(seed))
    lm_head = rng.standard_normal((jcfg.d_model, 8)).astype(np.float32)
    lm_head = np.repeat(lm_head, 4, axis=1)             # ties in fours
    hs = rng.standard_normal((2, 3, jcfg.d_model)).astype(np.float32)
    jparams = {"draft_heads": heads, "lm_head": jnp.asarray(lm_head)}
    want = np.asarray(jlm._draft_head_top(jparams, jnp.asarray(hs), 6))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu",
                                torch.float32)
    got = tlm._draft_head_top(tparams, torch.from_numpy(hs), 6).numpy()
    np.testing.assert_array_equal(got, want)


def test_hidden_states_match_jax(models):
    jcfg, tcfg, jp, tp = models
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (2, 23))
    want = jlm.hidden_states(jp, jcfg, jnp.asarray(toks, jnp.int32))
    got = tlm.hidden_states(tp, tcfg, torch.from_numpy(toks))
    assert got.shape == (2, 23, jcfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# ---------------------------------------------------------------------------
# draft-head fit
# ---------------------------------------------------------------------------

def _jax_loss(w, x_all, y_all, m_all, lm_head):
    """The loss of ``repro.models.lm.fit_draft_heads``, as written there."""
    t = jax.nn.silu(jnp.einsum("nd,hde->hne", x_all, w["w1"]))
    xh = x_all[None] + jnp.einsum("hne,hed->hnd", t, w["w2"])
    logits = xh @ lm_head
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, y_all[..., None], axis=-1)[..., 0]
    return (nll * m_all).sum() / jnp.maximum(m_all.sum(), 1.0)


def _jax_adam(w, g, opt, i, lr):
    """The update of ``repro.models.lm.fit_draft_heads``, as written
    there."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    mu = jax.tree.map(lambda m, gg: b1 * m + (1 - b1) * gg, opt["mu"], g)
    nu = jax.tree.map(lambda v, gg: b2 * v + (1 - b2) * gg * gg, opt["nu"],
                      g)
    t = jnp.float32(i) + 1
    w = jax.tree.map(lambda p, m, v: p - lr * (m / (1 - b1 ** t))
                     / (jnp.sqrt(v / (1 - b2 ** t)) + eps), w, mu, nu)
    return w, {"mu": mu, "nu": nu}


def test_draft_head_loss_and_adam_update_match_jax(models):
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(6)
    h, e, n = 2, 16, 30
    x_all = rng.standard_normal((n, jcfg.d_model)).astype(np.float32)
    y_all = rng.integers(0, jcfg.vocab, (h, n))
    m_all = (rng.random((h, n)) < 0.8).astype(np.float32)
    w = {"w1": (0.02 * rng.standard_normal((h, jcfg.d_model, e))
                ).astype(np.float32),
         "w2": (0.05 * rng.standard_normal((h, e, jcfg.d_model))
                ).astype(np.float32)}
    lm_head = np.array(jp["lm_head"])
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    jargs = (jnp.asarray(x_all), jnp.asarray(y_all, jnp.int32),
             jnp.asarray(m_all), jnp.asarray(lm_head))
    jloss, jg = jax.value_and_grad(_jax_loss)(jw, *jargs)
    tw = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in w.items()}
    tloss = tlm.draft_head_loss(tw, torch.from_numpy(x_all),
                                torch.from_numpy(y_all),
                                torch.from_numpy(m_all),
                                torch.from_numpy(lm_head))
    tg = dict(zip(tw, torch.autograd.grad(tloss, list(tw.values()))))
    assert abs(float(tloss.detach()) - float(jloss)) <= 1e-5
    for k in w:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   atol=1e-6, rtol=0)
    # two Adam steps from equal weights, moments and gradients
    g = {k: np.array(v) for k, v in jg.items()}
    jopt = {"mu": {k: jnp.zeros_like(v) for k, v in jw.items()},
            "nu": {k: jnp.zeros_like(v) for k, v in jw.items()}}
    topt = {"mu": {k: torch.zeros(v.shape) for k, v in w.items()},
            "nu": {k: torch.zeros(v.shape) for k, v in w.items()}}
    tw = {k: torch.from_numpy(v.copy()) for k, v in w.items()}
    for i in range(2):
        jw, jopt = _jax_adam(jw, {k: jnp.asarray(v) for k, v in g.items()},
                             jopt, i, 1e-2)
        tlm.adam_update(tw, {k: torch.from_numpy(v) for k, v in g.items()},
                        topt, i, 1e-2)
        for k in w:
            np.testing.assert_allclose(tw[k].numpy(), np.asarray(jw[k]),
                                       atol=1e-6, rtol=0)


def test_fit_draft_heads_learns_offsets(models):
    """Fitted heads beat the zero-init warm start (the plain next-token
    head) on their own trajectories, and the shapes install under
    ``params["draft_heads"]``."""
    jcfg, tcfg, jp, tp = models
    rng = np.random.default_rng(5)
    streams = [rng.integers(0, jcfg.vocab, (40,)).tolist()
               for _ in range(2)]

    def top1_hits(heads):
        hits = tot = 0
        for s in streams:
            x = tlm.hidden_states(tp, tcfg, torch.tensor([s]))[0]
            t = torch.nn.functional.silu(
                torch.einsum("nd,hde->hne", x, heads["w1"]))
            xh = x[None] + torch.einsum("hne,hed->hnd", t, heads["w2"])
            pred = (xh @ tp["lm_head"]).argmax(-1).numpy()
            for h in range(2):
                for i in range(len(s) - h - 2):
                    hits += int(pred[h, i] == s[i + h + 2])
                    tot += 1
        return hits / tot

    fitted = tlm.fit_draft_heads(tcfg, tp, streams, n_heads=2, head_dim=32,
                                 steps=120, seed=3)
    assert fitted["w1"].shape == (2, tcfg.d_model, 32)
    assert fitted["w2"].shape == (2, 32, tcfg.d_model)
    cold = {k: v * 0 for k, v in fitted.items()}
    assert top1_hits(fitted) > top1_hits(cold)
    with pytest.raises(ValueError, match="non-empty"):
        tlm.fit_draft_heads(tcfg, tp, [[1, 2]], n_heads=4)
