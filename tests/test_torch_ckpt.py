"""The port's checkpoints, restart, data prefetch and elastic planner
against the JAX package, on the CPU.

The port writes the JAX package's layout with a JSON manifest where the
JAX package writes msgpack: for one train state the two manifests decode
to the same fields and every ``.npy`` leaf is equal.  Restart is exact
(``torch.equal``: 6 straight steps against 3 + restore + 3), and the
port's losses stay within 1e-5 of the JAX loop's from one converted state
(the reduced fp32 ``llama3.2-3b`` with ``n_kv_heads=2``).
"""
import json
import os
import threading

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs.base import ShapeConfig as JShape
from repro.configs.registry import get_config as jget
from repro.data import pipeline as jpipe
from repro.ft.failures import plan_elastic_mesh as jplan
from repro.optim import adamw as jadamw
from repro.optim import schedule as jsched
from repro.train import loop as jloop
from repro.train import state as jstate
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import train_state_from_numpy
from repro_torch.data import pipeline as tpipe
from repro_torch.ft.failures import plan_elastic_mesh as tplan
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedule as tsched
from repro_torch.train import loop as tloop
from repro_torch.train import state as tstate
from repro_torch.tree import leaves, map_tree

SEQ, BATCH = 32, 4


def _cfgs():
    return (jget("llama3.2-3b").reduced(dtype=jnp.float32, n_kv_heads=2),
            tget("llama3.2-3b").reduced(dtype=torch.float32, n_kv_heads=2))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _mixed_tree(seed=0):
    """bf16, fp32 and int32 leaves, nested dicts and a list."""
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn((3, 5), generator=g).to(torch.bfloat16),
        "b": {"z": torch.randn((4,), generator=g),
              "a": torch.randint(-9, 9, (2, 3), generator=g,
                                 dtype=torch.int32)},
        "layers": [torch.randn((2,), generator=g),
                   {"k": torch.randn((1, 2, 2), generator=g)
                    .to(torch.bfloat16)}],
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _assert_trees_equal(a, b):
    fa, fb = tckpt.flatten_with_paths(a), tckpt.flatten_with_paths(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


def _jax_tree(ttree):
    """The same values as a JAX tree (bf16 leaves as jnp.bfloat16)."""
    def conv(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
        return jnp.asarray(t.numpy())
    return map_tree(conv, ttree)


def test_flatten_order_and_paths_equal_jax():
    tree = _mixed_tree()
    want = [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(_jax_tree(tree))[0]]
    got = tckpt.flatten_with_paths(tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, t), (_, a) in zip(got, want):
        assert tuple(t.shape) == a.shape


def test_round_trip_bf16_fp32_int32(tmp_path):
    tree = _mixed_tree()
    path = tckpt.save_checkpoint(str(tmp_path), 3, tree)
    assert path == os.path.join(str(tmp_path), "step_00000003")
    assert os.path.exists(os.path.join(path, ".complete"))
    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)
    recs = {r["path"]: r for r in meta["leaves"]}
    assert meta["step"] == 3
    assert recs["['w']"]["dtype"] == "bfloat16"
    assert recs["['w']"]["stored"] == "float32->bfloat16"
    assert recs["['b']['a']"]["stored"] == "int32"
    assert recs["['step']"]["shape"] == []
    target = map_tree(torch.zeros_like, _mixed_tree(seed=1))
    got = tckpt.restore_checkpoint(str(tmp_path), 3, target)
    _assert_trees_equal(got, tree)
    assert isinstance(got["layers"], list) and list(got) == list(target)


def test_restore_checks_missing_leaves_and_shapes(tmp_path):
    tckpt.save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(KeyError, match="missing leaf"):
        tckpt.restore_checkpoint(str(tmp_path), 1, {"b": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore_checkpoint(str(tmp_path), 1, {"a": torch.zeros(4)})


def test_restore_takes_target_dtype_and_device(tmp_path):
    tckpt.save_checkpoint(str(tmp_path), 2, {"a": torch.arange(4.0)})
    got = tckpt.restore_checkpoint(
        str(tmp_path), 2, {"a": torch.zeros(4, dtype=torch.bfloat16)},
        device="cpu")
    assert got["a"].dtype == torch.bfloat16
    assert torch.equal(got["a"].float(), torch.arange(4.0))


def test_incomplete_checkpoint_is_ignored(tmp_path):
    d = str(tmp_path)
    assert tckpt.latest_step(d) is None
    assert tckpt.latest_step(os.path.join(d, "absent")) is None
    tckpt.save_checkpoint(d, 4, {"a": torch.ones(2)})
    # a crash mid-save leaves a .tmp directory; a step without the marker
    # is not committed either
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    os.makedirs(os.path.join(d, "step_00000008"))
    np.save(os.path.join(d, "step_00000008", "leaf_00000.npy"), np.zeros(2))
    assert tckpt.latest_step(d) == 4
    assert jckpt.latest_step(d) == 4


def test_async_checkpointer_keeps_the_newest(tmp_path):
    ck = tckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for step in range(1, 6):
        ck.save(step, {"a": torch.full((3,), float(step))})
    ck.close()
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]
    got = tckpt.restore_checkpoint(str(tmp_path), 5, {"a": torch.zeros(3)})
    assert torch.equal(got["a"], torch.full((3,), 5.0))


def test_async_save_snapshots_before_returning(tmp_path):
    """The state changes in place after ``save`` returns and before its
    files are written: the files hold the saved values.  The worker thread
    is held busy until then, so a copy left to it would see the change."""
    ck = tckpt.AsyncCheckpointer(str(tmp_path), keep=3)
    release = threading.Event()
    blocker = ck._pool.submit(release.wait, 30)
    tree = _mixed_tree()
    want = map_tree(torch.clone, tree)
    fut = ck.save(1, tree)
    with torch.no_grad():
        for t in leaves(tree):
            t.add_(1)
    assert not fut.done()
    release.set()
    assert blocker.result() is True
    ck.close()
    got = tckpt.restore_checkpoint(str(tmp_path), 1,
                                   map_tree(torch.zeros_like, tree))
    _assert_trees_equal(got, want)


def test_async_checkpointer_reuses_its_host_buffer(tmp_path):
    """A save refills the host buffer of a save whose files are written, and
    never one whose files are still being written."""
    ck = tckpt.AsyncCheckpointer(str(tmp_path), keep=3)
    tree = _mixed_tree()
    ck.save(1, tree)
    ck.wait()
    first, = ck._free
    release = threading.Event()
    blocker = ck._pool.submit(release.wait, 30)
    want2 = map_tree(torch.clone, tree)
    ck.save(2, tree)                    # refills step 1's buffer
    assert not ck._free
    with torch.no_grad():
        for t in leaves(tree):
            t.add_(1)
    want3 = map_tree(torch.clone, tree)
    ck.save(3, tree)                    # step 2 still holds it: a new one
    release.set()
    assert blocker.result() is True
    ck.wait()
    assert len(ck._free) == 2 and any(b is first for b in ck._free)
    ck.close()
    for step, want in ((2, want2), (3, want3)):
        got = tckpt.restore_checkpoint(str(tmp_path), step,
                                       map_tree(torch.zeros_like, tree))
        _assert_trees_equal(got, want)


def _jax_train_state(jcfg, seed):
    return jstate.init_train_state(jcfg, jax.random.key(seed))


def _read_both(d):
    with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
        return msgpack.unpackb(f.read())


@pytest.mark.parametrize("which", ["train_state", "mixed"])
def test_manifest_and_leaves_equal_jax(tmp_path, which):
    if which == "train_state":
        jcfg, _ = _cfgs()
        jtree = _jax_train_state(jcfg, 0)
        ttree = train_state_from_numpy(_np(jtree), "cpu")
    else:
        ttree = _mixed_tree()
        jtree = _jax_tree(ttree)
    jdir = jckpt.save_checkpoint(str(tmp_path / "jax"), 5, jtree)
    tdir = tckpt.save_checkpoint(str(tmp_path / "port"), 5, ttree)
    jmeta = _read_both(jdir)
    with open(os.path.join(tdir, "manifest.json")) as f:
        tmeta = json.load(f)
    assert tmeta == jmeta
    assert sorted(os.listdir(tdir)) == sorted(
        n.replace("manifest.msgpack", "manifest.json")
        for n in os.listdir(jdir))
    for rec in jmeta["leaves"]:
        a = np.load(os.path.join(jdir, rec["file"]))
        b = np.load(os.path.join(tdir, rec["file"]))
        assert a.dtype == b.dtype and np.array_equal(a, b), rec["path"]


def test_jax_written_checkpoint_restores_into_the_port(tmp_path):
    """The JAX package's leaves, under its manifest's fields written as
    JSON (the port reads no msgpack), restore into the port's tree."""
    jcfg, tcfg = _cfgs()
    jtree = _jax_train_state(jcfg, 3)
    jtree = {**jtree, "step": jnp.asarray(11, jnp.int32),
             "m": jax.tree.map(lambda x: x + 0.5, jtree["m"])}
    d = jckpt.save_checkpoint(str(tmp_path), 11, jtree)
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(_read_both(d), f)
    assert tckpt.latest_step(str(tmp_path)) == 11
    target = tstate.init_train_state(tcfg, torch.Generator().manual_seed(9))
    got = tckpt.restore_checkpoint(str(tmp_path), 11, target)
    want = train_state_from_numpy(_np(jtree), "cpu")
    _assert_trees_equal(got, want)


def _loops(tmp_path):
    """(JAX step fn, port step fn, JAX state, port state) from one state."""
    jcfg, tcfg = _cfgs()
    j0 = _jax_train_state(jcfg, 0)
    opt = dict(lr=1e-3, grad_clip=1.0)
    jstep = jax.jit(jstate.build_train_step(
        jcfg, jadamw.AdamWConfig(**opt),
        lr_schedule=jsched.warmup_cosine(1e-3, 1, 6)))
    tstep = tstate.build_train_step(
        tcfg, tadamw.AdamWConfig(**opt),
        lr_schedule=tsched.warmup_cosine(1e-3, 1, 6))
    return jcfg, tcfg, jstep, tstep, j0


def _tloop(tcfg, tstep, state, total, ckpt_dir, every=3):
    return tloop.TrainLoop(tcfg, TShape("t", SEQ, BATCH, "train"),
                           tloop.LoopConfig(total_steps=total,
                                            ckpt_dir=ckpt_dir,
                                            ckpt_every=every, log_every=1,
                                            seed=5),
                           tstep, state)


def test_train_loop_restart_is_exact(tmp_path):
    """6 straight steps == 3 steps + crash + restore + 3 steps, bit for
    bit; the losses of the straight run equal the JAX loop's within 1e-5."""
    jcfg, tcfg, jstep, tstep, j0 = _loops(tmp_path)
    straight = _tloop(tcfg, tstep, train_state_from_numpy(_np(j0), "cpu"),
                      6, str(tmp_path / "a"))
    final_a = straight.run()
    assert tckpt.latest_step(str(tmp_path / "a")) == 6

    _tloop(tcfg, tstep, train_state_from_numpy(_np(j0), "cpu"), 3,
           str(tmp_path / "b")).run()
    # "restart": a new loop on a state from another seed, same directory
    other = train_state_from_numpy(_np(_jax_train_state(jcfg, 1)), "cpu")
    resumed = _tloop(tcfg, tstep, other, 6, str(tmp_path / "b"))
    assert resumed.maybe_restore() == 3
    final_b = resumed.run(start_step=3)
    for key in ("params", "m", "v", "step"):
        _assert_trees_equal(final_b[key], final_a[key])
    assert [m["loss"] for m in resumed.metrics_log] == \
        [m["loss"] for m in straight.metrics_log[3:]]
    on_disk = tckpt.restore_checkpoint(str(tmp_path / "b"), 6,
                                       map_tree(torch.zeros_like, final_a))
    _assert_trees_equal(on_disk, final_a)

    jl = jloop.TrainLoop(jcfg, JShape("t", SEQ, BATCH, "train"),
                         jloop.LoopConfig(total_steps=6, log_every=1,
                                          seed=5), jstep, j0)
    jl.run()
    np.testing.assert_allclose([m["loss"] for m in straight.metrics_log],
                               [m["loss"] for m in jl.metrics_log],
                               rtol=1e-5, atol=1e-5)


def _reversed_keys(tree):
    if isinstance(tree, dict):
        return {k: _reversed_keys(tree[k]) for k in reversed(list(tree))}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_reversed_keys(v) for v in tree)
    return tree


def test_restart_is_exact_whatever_the_key_order(tmp_path):
    """A resume onto a state whose dicts were built in another key order is
    still bit for bit the run that never stopped: the global gradient
    norm, the one sum over leaves, runs in sorted key order."""
    jcfg, tcfg, _, tstep, j0 = _loops(tmp_path)
    straight = _tloop(tcfg, tstep, train_state_from_numpy(_np(j0), "cpu"),
                      4, str(tmp_path / "a"), every=2)
    final_a = straight.run()
    _tloop(tcfg, tstep, train_state_from_numpy(_np(j0), "cpu"), 2,
           str(tmp_path / "b"), every=2).run()
    other = _reversed_keys(train_state_from_numpy(
        _np(_jax_train_state(jcfg, 1)), "cpu"))
    resumed = _tloop(tcfg, tstep, other, 4, str(tmp_path / "b"), every=2)
    final_b = resumed.run()
    assert list(final_b["params"]) == list(reversed(list(final_a["params"])))
    for key in ("params", "m", "v", "step"):
        _assert_trees_equal(final_b[key], final_a[key])
    assert [m["loss"] for m in resumed.metrics_log] == \
        [m["loss"] for m in straight.metrics_log[2:]]
    assert [m["grad_norm"] for m in resumed.metrics_log] == \
        [m["grad_norm"] for m in straight.metrics_log[2:]]


def test_run_without_start_step_restores(tmp_path):
    jcfg, tcfg, jstep, tstep, j0 = _loops(tmp_path)
    d = str(tmp_path / "c")
    _tloop(tcfg, tstep, train_state_from_numpy(_np(j0), "cpu"), 2, d,
           every=2).run()
    loop = _tloop(tcfg, tstep, train_state_from_numpy(_np(j0), "cpu"), 4, d,
                  every=2)
    loop.run()
    assert [m["step"] for m in loop.metrics_log] == [3, 4]
    assert int(loop.state["step"]) == 4
    assert tckpt.latest_step(d) == 4


def test_run_training_matches_the_loop(tmp_path):
    _, tcfg, _, tstep, j0 = _loops(tmp_path)
    a = tloop.run_training(tcfg, TShape("t", SEQ, BATCH, "train"),
                           tloop.LoopConfig(total_steps=2, seed=5), tstep,
                           train_state_from_numpy(_np(j0), "cpu"))
    b = _tloop(tcfg, tstep, train_state_from_numpy(_np(j0), "cpu"), 2,
               None).run()
    _assert_trees_equal(a, b)


@pytest.mark.parametrize("arch,hosts", [("llama3.2-3b", 1),
                                        ("llama3.2-3b", 2),
                                        ("hubert-xlarge", 1),
                                        ("internvl2-26b", 2)])
def test_prefetcher_yields_host_batches_in_order(arch, hosts):
    jcfg = jget(arch).reduced(dtype=jnp.float32)
    tcfg = tget(arch).reduced(dtype=torch.float32)
    shape, data = TShape("t", 24, 4, "train"), tpipe.HostDataConfig(
        7, hosts, hosts - 1)
    pf = tpipe.Prefetcher(tcfg, shape, data, start_step=3, depth=2)
    try:
        got = [next(pf) for _ in range(4)]
    finally:
        pf.close()
    assert not pf._thread.is_alive()
    for i, batch in enumerate(got):
        want = tpipe.host_batch(tcfg, shape, data, 3 + i)
        jwant = jpipe.host_batch(jcfg, JShape("t", 24, 4, "train"),
                                 jpipe.HostDataConfig(7, hosts, hosts - 1),
                                 3 + i)
        assert set(batch) == set(want) == set(jwant)
        for k in want:
            np.testing.assert_array_equal(batch[k], want[k])
            np.testing.assert_array_equal(batch[k], jwant[k])


def test_prefetcher_raises_a_failed_batch():
    tcfg = tget("llama3.2-3b").reduced(dtype=torch.float32)
    pf = tpipe.Prefetcher(tcfg, TShape("t", 8, 3, "train"),
                          tpipe.HostDataConfig(0, 2, 0))
    try:
        with pytest.raises(ValueError, match="must divide"):
            next(pf)
    finally:
        pf.close()
    assert not pf._thread.is_alive()


@pytest.mark.parametrize("arch", ["llama3.2-3b", "hubert-xlarge",
                                  "internvl2-26b"])
def test_global_batch_is_exactly_jax(arch):
    jcfg = jget(arch).reduced(dtype=jnp.float32)
    tcfg = tget(arch).reduced(dtype=torch.float32)
    want = jpipe.global_batch(jcfg, JShape("t", 24, 2, "train"), 11, 4)
    got = tpipe.global_batch(tcfg, TShape("t", 24, 2, "train"), 11, 4)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_plan_elastic_mesh_equals_jax():
    n = 0
    for devices in (1, 2, 3, 7, 8, 16, 48, 100, 256, 512):
        for mp in (1, 2, 4, 8, 16):
            for gb in (1, 6, 8, 12, 256, 384):
                for pods in (1, 2, 4):
                    assert tplan(devices, mp, gb, pods) == \
                        jplan(devices, mp, gb, pods), \
                        (devices, mp, gb, pods)
                    n += 1
    assert n == 900
    assert tplan(512, 16, 256, pods=2) == (2, 16, 16)
    assert tplan(8, 16, 256) is None
