"""The port's radix-4 mesh collectives and int8 compressed gradient mean
against the JAX package, on 8 gloo CPU ranks (one spawn for the file,
``tests/_torch_dist.py``).

The cases are ``tests/dist_progs/prog_collectives.py``'s at its sizes:

* ``make_tree_mesh`` factors an 8-rank ``data`` axis into ``data_t0`` x
  ``data_t1`` = 4 x 2, ranks row-major; without a spawn,
  ``tree_mesh_layout`` gives the JAX plan's stage axes for 8 -> (4, 2),
  6 -> (3, 2), 16 and 32, and keeps the other axes in place;
* ``tree_psum`` of fp32 integers (a tree of two leaves), ``tree_pmean``
  and the reduce-scatter + all-gather tree equal the numpy sum exactly;
* an int32 ``tree_psum`` under the 8-operand int8 plan is ``torch.equal``
  to the sum and stays int32; an int8 carrier and a 13-wide scatter raise
  with the JAX package's texts;
* ``compressed_psum_mean``'s mean and residual equal, bit for bit, JAX's
  ``quantize_int8`` / ``dequantize_int8`` applied per shard along a
  leading shard axis with one shared amax and an int32 sum, on integer
  and on normal gradients with a nonzero residual; ``(g - new_err)``
  meaned over the ranks equals the mean within 1e-6;
* ``make_test_mesh`` gives (2, 4) and (2, 2, 2), and a mesh whose size is
  not the world size raises with both numbers;
* without a spawn, ``maybe_init_distributed`` joins NCCL when a host has
  a card for each of its ranks (``LOCAL_WORLD_SIZE``), gloo when ranks
  share a card or run on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from repro.dist import collectives as jcoll
from repro.dist.plan import make_reduction_plan as jplan
from repro.optim.compression import dequantize_int8, quantize_int8
from repro_torch.dist.collectives import tree_mesh_layout
from repro_torch.dist.plan import make_reduction_plan

WORLD = 8


def _payload():
    rng = np.random.default_rng(0)
    g_int = rng.integers(-60, 60, (WORLD, 33)).astype(np.float32)
    normal = {k: rng.standard_normal((WORLD,) + s).astype(np.float32)
              for k, s in (("w", (5, 6)), ("b", (7,)))}
    return {
        "x": np.arange(WORLD * 5, dtype=np.float32).reshape(WORLD, 5),
        "v": np.arange(WORLD * 16, dtype=np.float32).reshape(WORLD, 16),
        "xi": np.random.default_rng(1).integers(
            -128, 128, (WORLD, 7)).astype(np.int32),
        "grid": {"g": {"w": g_int},
                 "e": {"w": np.zeros_like(g_int)}},
        "normal": {"g": normal,
                   "e": {k: 1e-3 * rng.standard_normal(v.shape).astype(
                       np.float32) for k, v in normal.items()}},
    }


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    payload = _payload()
    ranks = _torch_dist.run_ranks(WORLD, "collectives_program", payload,
                                  tmp_path_factory.mktemp("collectives"))
    return payload, ranks


def _ok(ranks, case):
    out = []
    for r, res in enumerate(ranks):
        status, value = res[case]
        assert status == "ok", f"rank {r}:\n{value}"
        out.append(value)
    return out


def _jax_compressed(g, e):
    """The JAX package's own quantizer per shard, one shared scale."""
    g32 = jnp.asarray(g) + jnp.asarray(e)
    amax = jnp.max(jnp.abs(g32))
    scale = jnp.maximum(amax / 127.0, 1e-12)
    q = quantize_int8(g32, scale)
    new_e = g32 - dequantize_int8(q, scale)
    total = jnp.sum(q.astype(jnp.int32), axis=0)
    return (np.asarray(dequantize_int8(total, scale) / g.shape[0]),
            np.asarray(new_e))


@pytest.mark.parametrize("n,stages", [(8, (4, 2)), (6, (3, 2)),
                                      (16, (4, 4)), (32, (4, 4, 2)),
                                      (4, (4,)), (1, ())])
def test_tree_mesh_layout_matches_the_jax_plan(n, stages):
    plan = jplan(n)
    assert make_reduction_plan(n).stages == plan.stages == stages
    shape, names, sub = tree_mesh_layout((2, n, 3), ("pod", "data", "model"),
                                         "data")
    assert sub == plan.sub_axis_names("data")
    if len(stages) <= 1:
        assert (shape, names) == ((2, n, 3), ("pod", "data", "model"))
    else:
        assert shape == (2,) + stages + (3,)
        assert names == ("pod",) + sub + ("model",)
    with pytest.raises(ValueError, match="not in mesh axes"):
        tree_mesh_layout((n,), ("data",), "model")
    with pytest.raises(ValueError, match=f"plan is for N={n + 1}"):
        tree_mesh_layout((n,), ("data",), "data", make_reduction_plan(n + 1))


def test_make_tree_mesh_factors_eight_ranks(run):
    _, ranks = run
    for r, out in enumerate(_ok(ranks, "layout")):
        assert out["sub"] == ("data_t0", "data_t1")
        assert out["shape"] == {"data_t0": 4, "data_t1": 2}
        assert out["coord"] == (r // 2, r % 2)


def test_tree_psum_equals_the_flat_sum(run):
    payload, ranks = run
    want = payload["x"].sum(0)
    for out in _ok(ranks, "psum_f32"):
        np.testing.assert_array_equal(out["a"], want)
        np.testing.assert_array_equal(out["b"][0], 2 * want)
    for out in _ok(ranks, "pmean"):
        np.testing.assert_allclose(out, want / WORLD, rtol=1e-7)


def test_reduce_scatter_gather_tree(run):
    payload, ranks = run
    for out in _ok(ranks, "reduce_scatter_gather"):
        np.testing.assert_array_equal(out, payload["v"].sum(0))


def test_unscatterable_payload_names_tree_psum(run):
    _, ranks = run
    for msg in _ok(ranks, "unscatterable"):
        assert msg is not None
        assert "use tree_psum for unscatterable payloads" in msg
        assert "not divisible by the 8-device tree" in msg


def test_int32_tree_psum_is_exact(run):
    payload, ranks = run
    want = payload["xi"].sum(0)
    for got, nbytes in _ok(ranks, "int_exact"):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        # one int32 payload of 7 a stage, two stages
        assert nbytes == {"all_reduce": 2 * 7 * 4}


def test_int8_carrier_overflow_raises_the_jax_text(run):
    _, ranks = run
    plan = jplan(8, payload_bits=8, acc_bits=32)
    with pytest.raises(ValueError) as jerr:
        jcoll._check_int_payload(jnp.zeros(3, jnp.int8), 8, plan)
    for msg in _ok(ranks, "int_overflow"):
        assert msg == str(jerr.value)
        assert "carrier overflows" in msg


@pytest.mark.parametrize("name", ["grid", "normal"])
def test_compressed_psum_mean_equals_the_jax_quantizer(run, name):
    payload, ranks = run
    case = payload[name]
    outs = _ok(ranks, "compressed")
    for r, out in enumerate(outs):
        mean, new_err = out[name]
        for k in case["g"]:
            want_mean, want_err = _jax_compressed(case["g"][k], case["e"][k])
            np.testing.assert_array_equal(mean[k], want_mean)
            np.testing.assert_array_equal(new_err[k], want_err[r])
    if name == "grid":
        # integer grid payloads with a shared scale: the mean is near the
        # exact one (prog_collectives.py's atol)
        np.testing.assert_allclose(mean["w"], case["g"]["w"].mean(0),
                                   atol=0.5)
    # error feedback: the ranks' (g + e - new_err) meaned is the mean
    for k in case["g"]:
        errs = np.stack([out[name][1][k] for out in outs])
        recon = (case["g"][k] + case["e"][k] - errs).mean(0)
        np.testing.assert_allclose(recon, mean[k], rtol=1e-6, atol=1e-6)


def test_make_test_mesh_shapes(run):
    _, ranks = run
    for r, (flat, pod) in enumerate(_ok(ranks, "test_meshes")):
        assert flat["shape"] == {"data": 2, "model": 4}
        assert flat["coord"] == (r // 4, r % 4)
        assert pod["shape"] == {"pod": 2, "data": 2, "model": 2}
        assert pod["coord"] == (r // 4, (r // 2) % 2, r % 2)


def test_mesh_of_the_wrong_size_raises(run):
    _, ranks = run
    for msg in _ok(ranks, "wrong_size"):
        assert msg is not None
        assert "holds 4 ranks" in msg and "has 8" in msg


def test_mesh_needs_a_process_group():
    from repro_torch.launch.mesh import build_mesh, device_mesh
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="needs a process group"):
        device_mesh((2,), ("data",), "cpu")
    assert build_mesh(pods=2, devices="cpu") is None


@pytest.mark.parametrize("env,device,count,want", [
    # 2 hosts x 8 cards: a card a rank, whatever the world size
    ({"WORLD_SIZE": "16", "LOCAL_WORLD_SIZE": "8", "LOCAL_RANK": "3"},
     "cuda", 8, ("cuda:3", "nccl")),
    # 4 ranks on one card share it
    ({"WORLD_SIZE": "4", "LOCAL_WORLD_SIZE": "4", "LOCAL_RANK": "3"},
     "cuda", 1, ("cuda:0", "gloo")),
    # no LOCAL_WORLD_SIZE: the whole world on one host
    ({"WORLD_SIZE": "2", "LOCAL_RANK": "1"}, "cuda", 2, ("cuda:1", "nccl")),
    ({"WORLD_SIZE": "16", "LOCAL_WORLD_SIZE": "8", "LOCAL_RANK": "3"},
     "cpu", 8, ("cpu", "gloo"))])
def test_maybe_init_distributed_picks_the_backend_per_host(
        monkeypatch, env, device, count, want):
    from repro_torch.launch import mesh
    for k in ("WORLD_SIZE", "LOCAL_WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    joined = []
    monkeypatch.setattr(mesh, "resolve_device", torch.device)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(mesh.dist, "init_process_group",
                        lambda backend, init_method: joined.append(
                            (backend, init_method)))
    dev = mesh.maybe_init_distributed(device)
    assert (str(dev), joined) == (want[0], [(want[1], "env://")])
