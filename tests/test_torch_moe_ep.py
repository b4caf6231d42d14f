"""The port's expert-parallel MoE FFN against the JAX package, on 8 gloo
CPU ranks laid out as ``make_test_mesh()``'s data 2 x model 4 (one spawn
for the file, ``tests/_torch_dist.py``).

``tests/dist_progs/prog_moe_ep.py``'s case: reduced ``phi3.5-moe`` with 4
experts (one a ``model`` rank), capacity factor 4.0 (drop-free), fp32,
the JAX ``init_params`` weights carried across and x of (4, 8, d) from a
numpy seed; the oracle is JAX's ``moe_ffn_dense_dispatch`` on the whole
batch.

* ``moe_ffn_ep`` on each rank's blocks (its 2 batch rows and 2 sequence
  positions, its expert's weights with the embed dim split over ``data``)
  gives its block of the dense output within 2e-4; its aux equals the mean
  of JAX ``_router``'s aux over the 8 ranks' token blocks (what the JAX EP
  path computes) within 1e-6, and the dense aux within rtol 0.1 as in the
  JAX program; the bytes it hands to the collectives equal what the
  shapes say;
* ``moe_ffn_ep_psum`` (tokens on every rank, each rank its expert's
  assignments, partial outputs summed over ``model``) gives the dense
  output within 2e-4;
* ``moe_ffn`` on the mesh takes EP from whole weights (the rank's batch
  rows, the same on every ``model`` rank): output within 2e-4 and aux
  within 1e-6 as above; the gradient of ``sum(y * c) + aux`` with respect
  to the rank's x rows, and the weights' gradients meaned over ``data``,
  equal ``jax.grad`` of the same objective through the dense dispatch and
  the per-block aux within 2e-4; with ``use_ep`` off it is the dense
  dispatch of the rank's rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist
from repro.configs.registry import get_config as jget
from repro.models import moe as jmoe
from repro.models.common import init_params as jinit

ARCH = "phi3.5-moe-42b-a6.6b"
OVER = {"n_experts": 4, "capacity_factor": 4.0, "use_ep": True}
DP, EP = 2, 4
TOL = 2e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = jget(ARCH).reduced(dtype=jnp.float32, **OVER)
    params = jax.tree.map(np.asarray, jinit(jmoe.moe_param_specs(cfg),
                                            jax.random.key(0)))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 8, cfg.d_model)).astype(np.float32)
    c = rng.standard_normal(x.shape).astype(np.float32)
    ranks = _torch_dist.run_ranks(
        DP * EP, "moe_ep_program",
        {"arch": ARCH, "over": OVER, "params": params, "x": x, "c": c},
        tmp_path_factory.mktemp("moe_ep"))
    return cfg, params, x, c, ranks


def _ok(ranks, case):
    out = []
    for r, res in enumerate(ranks):
        status, value = res[case]
        assert status == "ok", f"rank {r}:\n{value}"
        out.append(value)
    return out


def _blocks(a, r, m):
    return np.split(np.split(a, DP, 0)[r], EP, 1)[m]


def _ep_aux(cfg, params, x):
    """The JAX EP path's aux: the mean of each rank's router loss."""
    auxes = [jmoe._router(jnp.asarray(_blocks(x, r, m)).reshape(
        -1, cfg.d_model), params["router"], cfg)[2]
        for r in range(DP) for m in range(EP)]
    return sum(auxes) / len(auxes)


def test_moe_ffn_ep_matches_dense_dispatch(setup):
    cfg, params, x, _, ranks = setup
    dense_y, dense_aux = jmoe.moe_ffn_dense_dispatch(jnp.asarray(x), params,
                                                     cfg)
    ep_aux = float(_ep_aux(cfg, params, x))
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    t = 2 * 2                                  # a rank's tokens
    cap = int(np.ceil(t * cfg.top_k * cfg.capacity_factor / e))
    a2a = 2 * e * cap * d * 4                  # out and back, fp32
    # router + w1 + w3 + w2 blocks, gathered over data, then the router's
    # (d, 1) block over model; aux's all-reduce over model and data
    gathers = (d // 2 * 1 + 3 * (d // 2) * f + d * 1) * 4
    for i, ((y, aux), nbytes) in enumerate(_ok(ranks, "ep")):
        want = _blocks(np.asarray(dense_y), i // EP, i % EP)
        np.testing.assert_allclose(y, want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(float(aux), ep_aux, rtol=1e-6)
        np.testing.assert_allclose(float(aux), float(dense_aux), rtol=0.1)
        assert nbytes == {"all_to_all": a2a, "all_gather": gathers,
                          "all_reduce": 2 * 4}


def test_moe_ffn_ep_psum_matches_dense_dispatch(setup):
    cfg, params, x, _, ranks = setup
    dense_y, dense_aux = jmoe.moe_ffn_dense_dispatch(jnp.asarray(x), params,
                                                     cfg)
    for y, aux in _ok(ranks, "psum"):
        np.testing.assert_allclose(y, np.asarray(dense_y), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(float(aux), float(dense_aux), rtol=1e-6)


def test_moe_ffn_routes_to_ep_with_whole_gradients(setup):
    cfg, params, x, c, ranks = setup

    def objective(p, xx):
        y, _ = jmoe.moe_ffn_dense_dispatch(xx, p, cfg)
        # the ranks' losses: each its rows' sum(y * c) plus aux, meaned
        # over data by the train step
        return jnp.sum(y * c) / DP + _ep_aux(cfg, p, xx)

    gp, gx = jax.grad(objective, argnums=(0, 1))(params, jnp.asarray(x))
    dense_y, _ = jmoe.moe_ffn_dense_dispatch(jnp.asarray(x), params, cfg)
    ep_aux = float(_ep_aux(cfg, params, x))
    for i, (y, aux, g_x, g_p) in enumerate(_ok(ranks, "routed")):
        r = i // EP
        np.testing.assert_allclose(y, np.split(np.asarray(dense_y), DP)[r],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(float(aux), ep_aux, rtol=1e-6)
        # the rank's own loss weighs its rows DP times the meaned one
        np.testing.assert_allclose(g_x, DP * np.split(np.asarray(gx), DP)[r],
                                   rtol=TOL, atol=TOL)
        for k in params:
            np.testing.assert_allclose(g_p[k], np.asarray(gp[k]), rtol=TOL,
                                       atol=TOL, err_msg=k)


def test_moe_ffn_without_ep_is_the_dense_dispatch(setup):
    cfg, params, x, _, ranks = setup
    for i, (y, aux) in enumerate(_ok(ranks, "dense_without_ep")):
        rows = np.split(x, DP)[i // EP]
        want_y, want_aux = jmoe.moe_ffn_dense_dispatch(jnp.asarray(rows),
                                                       params, cfg)
        np.testing.assert_allclose(y, np.asarray(want_y), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
