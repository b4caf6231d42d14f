"""Rank programs of the port's mesh tests, the runner that starts them, and
a mesh whose ranks are threads.

:func:`run_ranks` starts ``world`` processes (``spawn``), joins them into
one gloo group through a ``file://`` rendezvous under the test's
``tmp_path`` (no TCP port, so parallel test workers never collide), runs
one program of this module on every rank and returns each rank's results.
A program runs a dict of cases one after another and records, for each,
its result or the error's traceback, so one spawn serves a whole test
file.  The join has a deadline of its own: a hung rendezvous or
collective fails the tests of that file, not the suite.  This module
imports no JAX: the ranks run the port alone, and the test files hold
their results against the JAX package in the parent process.

:func:`run_threads` runs a function on every rank of a mesh whose ranks
are threads of the test's process (:class:`ThreadMesh`, a
:class:`~repro_torch.launch.mesh.MeshView` whose collectives meet in an
in-memory :class:`Exchange`): no spawn, no process group, and the byte
counts, by op and by axis, those of the live ``Transport``.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import threading
import time
import traceback
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.dist.transport import Transport, split_len
from repro_torch.launch.mesh import MeshView

#: seconds a spawn may take from start to the last rank's exit
JOIN_TIMEOUT = 240
#: seconds one collective may wait for its peers before it raises
COLLECTIVE_TIMEOUT = 60


class Exchange:
    """Where the threads of one fake mesh meet: each collective writes the
    rank's tensor into its group's slots, waits for the group, reads every
    slot and waits again before a slot may be written anew.  One thread
    computes at a time: a rank holds the ``baton`` from its start and lets
    it go only while it waits in a collective, so the ranks never contend
    for the interpreter (on a busy host, threads that do contend for it
    wait a switch interval at every op)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.baton = threading.Lock()
        self.groups = {}

    def swap(self, key, n: int, i: int, x: torch.Tensor):
        with self.lock:
            g = self.groups.setdefault(key, ([None] * n,
                                             threading.Barrier(n)))
        slots, bar = g
        slots[i] = x.detach().clone()
        self.baton.release()
        try:
            bar.wait()
            out = list(slots)
            bar.wait()
        finally:
            self.baton.acquire()
        return out


class ThreadTransport(Transport):
    """A :class:`Transport` whose collectives go through an
    :class:`Exchange`; the byte counts are the real class's, each under
    the axis its group names, and a length the axis's ranks do not divide
    raises, as the live ops do."""

    def __init__(self, mesh):
        super().__init__()
        self.mesh = mesh

    def axis_of(self, group) -> str:
        return group[0]

    def _swap(self, x, group):
        axis, key = group
        return self.mesh.exchange.swap(key, self.mesh.shape[axis],
                                       self.mesh.index(axis), x)

    def all_reduce(self, x, group, op="sum"):
        self._count("all_reduce", x, group)
        parts = self._swap(x, group)
        out = parts[0].clone()
        for p in parts[1:]:
            out = torch.maximum(out, p) if op == "max" else out + p
        return out

    def all_gather(self, x, group, dim=0):
        self._count("all_gather", x, group)
        return torch.cat(self._swap(x, group), dim=dim)

    def reduce_scatter(self, x, group, dim=0):
        axis, _ = group
        n, i = self.mesh.shape[axis], self.mesh.index(axis)
        b = split_len(x.shape[dim], n, "reduce_scatter")
        self._count("reduce_scatter", x, group)
        total = sum(self._swap(x, group))
        return total.narrow(dim, i * b, b).clone()

    def all_to_all(self, x, group):
        axis, _ = group
        n, i = self.mesh.shape[axis], self.mesh.index(axis)
        b = split_len(x.shape[0], n, "all_to_all")
        self._count("all_to_all", x, group)
        return torch.cat([p[i * b:(i + 1) * b] for p in self._swap(x, group)])


class ThreadMesh(MeshView):
    """One rank's view of a mesh whose ranks are threads: a group is
    ``(axis, key)``, the key naming the ranks that share this rank's
    coordinates on the other axes."""

    def __init__(self, shape, coord, exchange):
        super().__init__(shape, coord, "cpu")
        self.exchange = exchange
        self.transport = ThreadTransport(self)

    def group(self, axis):
        rest = tuple((a, c) for a, c in self.coord.items() if a != axis)
        return axis, (axis, rest)


def run_threads(shape, fn):
    """``fn(mesh)`` on every rank of ``shape`` (a dict), each in a thread;
    returns the ranks' results in row-major order."""
    ex = Exchange()
    coords = list(np.ndindex(*shape.values()))
    out, errs = [None] * len(coords), []

    def run(i, coord):
        with ex.baton:
            try:
                out[i] = fn(ThreadMesh(shape, coord, ex))
            except BaseException as e:        # surfaced below
                errs.append(e)
    threads = [threading.Thread(target=run, args=(i, c))
               for i, c in enumerate(coords)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    if errs:
        raise errs[0]
    return out


def run_ranks(world: int, program: str, payload, tmp_path,
              timeout: float = JOIN_TIMEOUT) -> List[dict]:
    """Run ``program`` (a function name of this module) on ``world`` gloo
    ranks; returns ``[results of rank 0, ...]``."""
    ctx = mp.get_context("spawn")
    out = str(tmp_path)
    # through a file: a payload larger than a pipe's buffer would hold
    # each start until that child had imported enough to read it
    with open(os.path.join(out, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    procs = [ctx.Process(target=_rank_main, args=(r, world, out, program),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        raise TimeoutError(f"ranks {hung} of {program} still ran after "
                           f"{timeout} s")
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        err = os.path.join(out, f"rank{failed[0]}.err")
        text = open(err).read() if os.path.exists(err) else "(no traceback)"
        raise RuntimeError(f"ranks {failed} of {program} failed:\n{text}")
    results = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _rank_main(rank: int, world: int, out: str, program: str):
    try:
        torch.set_num_threads(1)
        with open(os.path.join(out, "payload.pkl"), "rb") as f:
            payload = pickle.load(f)
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(out, 'store')}",
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
        results = globals()[program](rank, payload)
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _run_cases(cases: Dict[str, Callable]) -> dict:
    """Each case's ``("ok", value)`` or ``("error", traceback)``."""
    out = {}
    for name, fn in cases.items():
        try:
            out[name] = ("ok", fn())
        except Exception:
            out[name] = ("error", traceback.format_exc())
    return out


def _np(t):
    """``t`` as numpy copies: a CPU tensor's ``numpy()`` shares its memory,
    and a later step updates the state in place."""
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_np(v) for v in t)
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy().copy()
    return t


# ---------------------------------------------------------------------------
# tests/test_torch_collectives.py (8 ranks)
# ---------------------------------------------------------------------------

def collectives_program(rank: int, payload) -> dict:
    from repro_torch.dist.collectives import (make_tree_mesh, tree_pmean,
                                              tree_psum,
                                              tree_reduce_scatter_gather)
    from repro_torch.dist.plan import make_reduction_plan
    from repro_torch.launch.mesh import device_mesh, make_test_mesh
    from repro_torch.optim.compression import compressed_psum_mean

    mesh = device_mesh((8,), ("data",), "cpu")
    tmesh, sub = make_tree_mesh(mesh, "data")
    plan8 = make_reduction_plan(8, payload_bits=8, acc_bits=32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))

    def layout():
        return {"sub": sub, "shape": tmesh.shape,
                "coord": tuple(tmesh.index(a) for a in sub)}

    def psum_f32():
        x = t(payload["x"][rank])
        return _np(tree_psum({"a": x, "b": [2 * x]}, sub, mesh=tmesh))

    def pmean():
        return _np(tree_pmean(t(payload["x"][rank]), sub, mesh=tmesh))

    def reduce_scatter_gather():
        return _np(tree_reduce_scatter_gather(t(payload["v"][rank]), sub,
                                              mesh=tmesh))

    def unscatterable():
        try:
            tree_reduce_scatter_gather(torch.ones(13), sub, mesh=tmesh)
        except ValueError as e:
            return str(e)
        return None

    def int_exact():
        tmesh.transport.reset()
        got = tree_psum(t(payload["xi"][rank]), sub, plan=plan8, mesh=tmesh)
        return _np(got), dict(tmesh.transport.bytes)

    def int_overflow():
        try:
            tree_psum(t(payload["xi"][rank]).to(torch.int8), sub, plan=plan8,
                      mesh=tmesh)
        except ValueError as e:
            return str(e)
        return None

    def compressed():
        out = {}
        for name in ("grid", "normal"):
            g = {k: t(v[rank]) for k, v in payload[name]["g"].items()}
            e = {k: t(v[rank]) for k, v in payload[name]["e"].items()}
            out[name] = _np(compressed_psum_mean(g, e, sub, 8, mesh=tmesh))
        return out

    def test_meshes():
        a = make_test_mesh("cpu")
        b = make_test_mesh("cpu", multi_pod=True)
        return ({"shape": a.shape, "coord": (a.index("data"),
                                             a.index("model"))},
                {"shape": b.shape, "coord": tuple(b.index(x) for x in
                                                  b.axis_names)})

    def wrong_size():
        try:
            device_mesh((4,), ("data",), "cpu")
        except ValueError as e:
            return str(e)
        return None

    return _run_cases({
        "layout": layout, "psum_f32": psum_f32, "pmean": pmean,
        "reduce_scatter_gather": reduce_scatter_gather,
        "unscatterable": unscatterable, "int_exact": int_exact,
        "int_overflow": int_overflow, "compressed": compressed,
        "test_meshes": test_meshes, "wrong_size": wrong_size})


# ---------------------------------------------------------------------------
# tests/test_torch_moe_ep.py (8 ranks: data 2 x model 4)
# ---------------------------------------------------------------------------

def moe_ep_program(rank: int, payload) -> dict:
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist.collectives import tree_pmean
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe

    cfg = get_config(payload["arch"]).reduced(dtype=torch.float32,
                                              **payload["over"])
    mesh = make_test_mesh("cpu")
    ep, m = mesh.shape["model"], mesh.index("model")
    dp, r = mesh.shape["data"], mesh.index("data")
    p = params_from_numpy(payload["params"], "cpu", torch.float32)
    x = torch.from_numpy(payload["x"])
    c = torch.from_numpy(payload["c"])
    rows = lambda t: t.chunk(dp, 0)[r]

    def ep_block():
        blk = {"router": p["router"].chunk(dp, 0)[r].chunk(ep, 1)[m],
               "w1": p["w1"].chunk(ep, 0)[m].chunk(dp, 1)[r],
               "w3": p["w3"].chunk(ep, 0)[m].chunk(dp, 1)[r],
               "w2": p["w2"].chunk(ep, 0)[m].chunk(dp, 2)[r]}
        mesh.transport.reset()
        y, aux = moe.moe_ffn_ep(rows(x).chunk(ep, 1)[m], blk, cfg, mesh)
        return _np((y, aux)), dict(mesh.transport.bytes)

    def psum():
        blk = {"router": p["router"].chunk(ep, 1)[m],
               **{k: p[k].chunk(ep, 0)[m] for k in ("w1", "w3", "w2")}}
        return _np(moe.moe_ffn_ep_psum(x, blk, cfg, mesh))

    def routed():
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xr = rows(x).clone().requires_grad_(True)
        y, aux = moe.moe_ffn(xr, leaves, cfg, mesh)
        loss = (y * rows(c)).sum() + aux
        grads = torch.autograd.grad(loss, [xr] + list(leaves.values()))
        gp = dict(zip(leaves, grads[1:]))
        return _np((y, aux, grads[0],
                    tree_pmean(gp, ("data",), mesh=mesh)))

    def dense_without_ep():
        off = dataclasses.replace(cfg, use_ep=False)
        return _np(moe.moe_ffn(rows(x), p, off, mesh))

    return _run_cases({"ep": ep_block, "psum": psum, "routed": routed,
                       "dense_without_ep": dense_without_ep})


# ---------------------------------------------------------------------------
# tests/test_torch_dist_train.py (8 ranks: pod 2 x data 2 x model 2, and
# data 2 x model 4)
# ---------------------------------------------------------------------------

def dist_train_program(rank: int, payload) -> dict:
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import params_from_numpy, train_state_from_numpy
    from repro_torch.dist.collectives import tree_pmean
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import attention
    from repro_torch.models.registry import get_api
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.grad_accum import value_and_grad
    from repro_torch.train import state as state_mod
    from repro_torch.models.common import gather_block
    from repro_torch.train.state import (build_train_step, gather_train_state,
                                         init_train_state, shard_train_state,
                                         split_layers, train_state_shardings)
    from repro_torch.tree import map_tree

    def stack_layers(tree):
        """The inverse of ``split_layers``: the per-layer dicts stacked."""
        return {**tree, "blocks": map_tree(lambda *xs: torch.stack(xs),
                                           *tree["blocks"])}

    pod = make_test_mesh("cpu", multi_pod=True)
    flat = make_test_mesh("cpu")
    opt = AdamWConfig(lr=1e-2, grad_clip=1.0)
    cfg_of = lambda name: get_config(payload[name]["arch"]).reduced(
        dtype=torch.float32, **payload[name]["over"])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    rows_of = lambda mesh: (mesh.size([a for a in mesh.axis_names
                                       if a != "model"]),
                            mesh.flat_index([a for a in mesh.axis_names
                                             if a != "model"]))

    def standard_step():
        tr = payload["train"]
        cfg = cfg_of("train")
        whole = train_state_from_numpy(tr["state"], "cpu")
        batch = {k: t(v) for k, v in tr["batch"].items()}
        n, r = rows_of(pod)
        api = get_api(cfg)
        vg = value_and_grad(lambda p, b: api.train_loss(p, b, cfg, pod))
        mine = {k: v.chunk(n)[r] for k, v in batch.items()}
        loss, grads = vg(whole["params"], mine)
        grads = tree_pmean(grads, ("pod", "data"), mesh=pod)
        loss = tree_pmean(loss, ("pod", "data"), mesh=pod)
        # the step on the rank's blocks of the state
        shardings = train_state_shardings(cfg, pod)
        state = shard_train_state(whole, shardings, pod)
        step = build_train_step(cfg, opt, mesh=pod)
        _, metrics = step(state, batch)
        params = gather_train_state(state, shardings, pod)["params"]
        return _np((loss, grads, metrics, params))

    def compressed_step():
        tr = payload["train"]
        cfg = cfg_of("train")
        whole = train_state_from_numpy(tr["state"], "cpu")
        whole["err"] = init_train_state(
            cfg, torch.Generator().manual_seed(0), pod_compressed=True,
            n_pods=2)["err"]
        shardings = train_state_shardings(cfg, pod, pod_compressed=True,
                                          n_pods=2)
        state = shard_train_state(whole, shardings, pod)
        step = build_train_step(cfg, opt, mesh=pod, pod_compressed=True)
        batch = {k: t(v) for k, v in tr["batch"].items()}
        # this pod's gradient as the step computes it before compression:
        # the rank's rows, meaned over data
        api = get_api(cfg)
        n, r = rows_of(pod)
        _, pod_grads = value_and_grad(
            lambda p, b: api.train_loss(p, b, cfg, pod))(
                split_layers(whole["params"]),
                {k: v.chunk(n)[r] for k, v in batch.items()})
        pod_grads = tree_pmean(pod_grads, ("data",), mesh=pod)
        # and the gradient the step hands AdamW: the rank's blocks,
        # gathered whole here
        seen = {}
        real = state_mod.adamw_update

        def spy(opt_cfg, params, grads, *rest, mesh=None, shardings=None):
            seen["grads"] = map_tree(
                lambda g, ps: gather_block(g.detach(), ps, mesh), grads,
                shardings)
            return real(opt_cfg, params, grads, *rest, mesh=mesh,
                        shardings=shardings)
        state_mod.adamw_update = spy
        try:
            _, metrics = step(state, batch)
        finally:
            state_mod.adamw_update = real
        # whole leaves, each rank's err its pod's block of 1
        err = map_tree(lambda e, ps: gather_block(e, ps, pod, keep=("pod",)),
                       state["err"], shardings["err"])
        params = gather_train_state(state, shardings, pod)["params"]
        first = _np((metrics, params, err, stack_layers(pod_grads),
                     stack_layers(seen["grads"])))
        _, metrics = step(state, batch)
        err = map_tree(lambda e, ps: gather_block(e, ps, pod, keep=("pod",)),
                       state["err"], shardings["err"])
        return first, _np((metrics, err))

    def decode(name, api_name):
        dc = payload[name]
        cfg = cfg_of(name)
        api = get_api(cfg)
        params = params_from_numpy(dc["params"], "cpu", torch.float32)
        n, r = rows_of(pod)
        tp, m = pod.shape["model"], pod.index("model")

        def block(name, a):
            a = t(a).chunk(n, 1)[r]
            return (a.chunk(tp, 2)[m] if name in ("k", "v") else a).clone()
        state = {k: block(k, v) for k, v in dc["state"].items()}
        batch = {"tokens": t(dc["tokens"]).chunk(n)[r],
                 "index": torch.tensor(dc["index"])}
        pod.transport.reset()
        logits, state = getattr(api, api_name)(params, state, batch, cfg, pod)
        return _np((logits, state, dict(pod.transport.bytes)))

    def head_pad():
        hp = payload["head_pad"]
        cfg = cfg_of("head_pad")
        api = get_api(cfg)
        params = params_from_numpy(hp["params"], "cpu", torch.float32)
        n, r = rows_of(flat)
        batch = {k: t(v).chunk(n)[r] for k, v in hp["batch"].items()}
        logits, _ = api.forward(params, batch, cfg, flat)
        loss, grads = value_and_grad(
            lambda p, b: api.train_loss(p, b, cfg, flat))(params, batch)
        return _np((attention.tp_head_pad(cfg, flat), logits,
                    tree_pmean(loss, ("data",), mesh=flat),
                    tree_pmean(grads, ("data",), mesh=flat)))

    def refusals():
        cfg = cfg_of("train")
        out = []
        for fn in (lambda: build_train_step(cfg, opt, mesh=flat,
                                            pod_compressed=True),
                   lambda: decode_vector_index(cfg)):
            try:
                fn()
                out.append(None)
            except ValueError as e:
                out.append(str(e))
        return out

    def decode_vector_index(cfg):
        api = get_api(cfg)
        dc = payload["decode"]
        params = params_from_numpy(dc["params"], "cpu", torch.float32)
        state = {k: t(v).chunk(4, 1)[0].chunk(2, 2)[0].clone()
                 for k, v in dc["state"].items()}
        api.decode_step(params, state, {"tokens": t(dc["tokens"])[:2],
                                        "index": torch.tensor([3, 4])},
                        cfg, pod)

    return _run_cases({
        "standard_step": standard_step, "compressed_step": compressed_step,
        "decode": lambda: decode("decode", "decode_step"),
        "hybrid_decode": lambda: decode("hybrid", "decode_step"),
        "head_pad": head_pad, "refusals": refusals})


# ---------------------------------------------------------------------------
# tests/test_torch_sharded_state.py (8 ranks: pod 2 x data 2 x model 2 and
# data 2 x model 4; then 4 ranks for the elastic restore, 2 for the CLI)
# ---------------------------------------------------------------------------

def _sharded_run(cfg, mesh, state_np, batches, opt, ckpt=None):
    """Steps of ``cfg`` on ``mesh`` from the whole numpy state, sharded:
    per step the metrics, the gathered params and the transport's bytes,
    the first step's gradient as AdamW got it (gathered, layers stacked),
    and with ``ckpt`` (a directory) a save after the first step and the
    gathered state then; the shapes of the residual stream a decoder
    block took (``stream``) and of the logits the vocab-parallel loss took
    (``vocab_ce``)."""
    from repro_torch.checkpoint.ckpt import AsyncCheckpointer
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.models import lm
    from repro_torch.models.common import gather_block
    from repro_torch.train import state as state_mod
    from repro_torch.train.state import (build_train_step, gather_train_state,
                                         shard_train_state,
                                         train_state_shardings)
    from repro_torch.tree import map_tree

    shardings = train_state_shardings(cfg, mesh)
    state = shard_train_state(train_state_from_numpy(state_np, "cpu"),
                              shardings, mesh)
    blocks = {k: {"/".join(map(str, i)): tuple(t.shape) for i, t in
                  _paths(state[k])} for k in ("params", "m", "v")}
    step = build_train_step(cfg, opt, mesh=mesh)
    out = {"blocks": blocks, "steps": [], "stream": set(), "vocab_ce": set()}
    real = state_mod.adamw_update
    real_block, real_ce = lm._block_train, lm.vocab_parallel_cross_entropy

    def block_spy(x, *a):
        out["stream"].add(tuple(x.shape))
        return real_block(x, *a)

    def ce_spy(logits, *a):
        out["vocab_ce"].add(tuple(logits.shape))
        return real_ce(logits, *a)

    def spy(opt_cfg, params, grads, *rest, mesh=None, shardings=None):
        if "grads" not in out:
            whole = map_tree(lambda g, ps: gather_block(g, ps, mesh), grads,
                             shardings)
            out["grads"] = _np({k: map_tree(lambda *xs: torch.stack(xs),
                                            *v) if isinstance(v, list) else v
                                for k, v in whole.items()})
        return real(opt_cfg, params, grads, *rest, mesh=mesh,
                    shardings=shardings)
    for i, batch in enumerate(batches):
        mesh.transport.reset()
        state_mod.adamw_update = spy
        lm._block_train, lm.vocab_parallel_cross_entropy = block_spy, ce_spy
        try:
            state, metrics = step(state, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
        finally:
            state_mod.adamw_update = real
            lm._block_train, lm.vocab_parallel_cross_entropy = (real_block,
                                                                real_ce)
        out["steps"].append(_np((metrics, gather_train_state(
            state, shardings, mesh)["params"], dict(mesh.transport.bytes))))
        if ckpt is not None and i == 0:
            saver = AsyncCheckpointer(ckpt, mesh=mesh, shardings=shardings)
            saver.save(1, state)
            saver.close()
            out["saved"] = _np(gather_train_state(state, shardings, mesh))
    return out


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k],
                                                        prefix + (k,))]
    return [(prefix, tree)]


def sharded_state_program(rank: int, payload) -> dict:
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.common import shard_block
    from repro_torch.models.lm import vocab_parallel_embed
    from repro_torch.optim.adamw import AdamWConfig

    pod = make_test_mesh("cpu", multi_pod=True)
    flat = make_test_mesh("cpu")
    opt = AdamWConfig(lr=1e-2, grad_clip=1.0)
    cfg_of = lambda c: get_config(c["arch"]).reduced(dtype=torch.float32,
                                                     **c["over"])
    meshes = {"pod": pod, "flat": flat}

    def embed():
        out = {}
        for vocab, e in payload["embed"].items():
            table = torch.from_numpy(e["table"])
            if vocab % flat.shape["model"] == 0:
                table = shard_block(table, ("model",), flat)
            leaf = table.clone().requires_grad_(True)
            y = vocab_parallel_embed(torch.from_numpy(e["tokens"]), leaf,
                                     flat, vocab)
            grad, = torch.autograd.grad((y * torch.from_numpy(e["c"])).sum(),
                                        leaf)
            out[vocab] = _np((y, grad))
        return out

    def run(name):
        c = payload[name]
        return _sharded_run(cfg_of(c), meshes[c["mesh"]], c["state"],
                            c["batches"], opt, c.get("ckpt"))

    return _run_cases({"embed": embed,
                       **{name: (lambda n=name: run(n))
                          for name in ("llama", "moe", "moe_dense",
                                       "hybrid", "llama_ragged",
                                       "moe_drop")}})


def _mesh_decode(cfg, mesh, case):
    """A prompt through ``prefill_chunk`` and greedy ``decode_step`` s on
    ``mesh`` (data, model): the params the rank's blocks under
    ``train_state_shardings`` (``mesh_params``), the state its rows over
    ``data`` and, for ``k`` / ``v``, its stretch of the cache over
    ``model``.  Returns each call's logits of the rank's rows and the
    greedy tokens."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.common import shard_block
    from repro_torch.models.registry import get_api
    from repro_torch.train.state import mesh_params, train_state_shardings
    from repro_torch.tree import map_tree

    api = get_api(cfg)
    whole = params_from_numpy(case["params"], "cpu", torch.float32)
    shardings = train_state_shardings(cfg, mesh)["params"]
    params = mesh_params(map_tree(lambda t, ps: shard_block(t, ps, mesh)
                                  .clone(), whole, shardings), cfg, mesh)
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    prompt = torch.from_numpy(case["prompt"]).chunk(dp)[mesh.index("data")]
    b, p = prompt.shape
    state = {}
    for k, sp in api.decode_state_specs(cfg, b * dp, case["smax"]).items():
        shape = list(sp.shape)
        shape[1] //= dp
        if k in ("k", "v"):
            shape[2] //= tp
        state[k] = torch.zeros(shape, dtype=sp.dtype)
    out = []
    with torch.no_grad():
        logits, state = api.prefill_chunk(
            params, state, {"tokens": prompt, "index": torch.tensor(0),
                            "nvalid": p}, cfg, mesh)
        out.append(logits)
        for i in range(case["steps"]):
            tok = out[-1].argmax(-1)[:, None]
            logits, state = api.decode_step(
                params, state, {"tokens": tok,
                                "index": torch.tensor(p + i)}, cfg, mesh)
            out.append(logits)
    return _np((torch.stack(out), torch.stack([o.argmax(-1) for o in out])))


def elastic_program(rank: int, payload) -> dict:
    """The llama checkpoint of ``sharded_state_program`` restored onto a
    (data, model) mesh of ``payload["mesh"]``, then step 2; and prefill
    and greedy decode on that mesh of sharded params (``_mesh_decode``)."""
    from repro_torch.checkpoint.ckpt import restore_checkpoint
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.state import (build_train_step, gather_train_state,
                                         init_train_state,
                                         train_state_shardings)

    cfg = get_config(payload["arch"]).reduced(dtype=torch.float32,
                                              **payload["over"])
    mesh = device_mesh(payload["mesh"], ("data", "model"), "cpu")

    def restore():
        shardings = train_state_shardings(cfg, mesh)
        target = init_train_state(cfg, torch.Generator(), mesh=mesh)
        state = restore_checkpoint(payload["ckpt"], 1, target,
                                   shardings=shardings, mesh=mesh)
        restored = _np(gather_train_state(state, shardings, mesh))
        step = build_train_step(cfg, AdamWConfig(lr=1e-2, grad_clip=1.0),
                                mesh=mesh)
        _, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in payload["batch"].items()})
        return restored, _np((metrics, gather_train_state(
            state, shardings, mesh)["params"]))

    def decode(name):
        c = payload["decode"][name]
        dcfg = get_config(c["arch"]).reduced(dtype=torch.float32, **c["over"])
        return _mesh_decode(dcfg, mesh, c)

    return _run_cases({"restore": restore,
                       **{f"decode_{name}": (lambda n=name: decode(n))
                          for name in payload["decode"]}})


def train_cli_program(rank: int, payload) -> dict:
    """``launch/train.py``'s ``main`` on this 2-rank group, twice on one
    checkpoint directory (``main`` leaves the group, so a new one is
    joined after each run); each run's printed lines."""
    import contextlib
    import io

    from repro_torch.launch import train as tlaunch

    def run(steps, store):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tlaunch.main(payload["argv"] + ["--steps", str(steps)])
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(payload['dir'], store)}",
            rank=rank, world_size=2,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
        return buf.getvalue()

    return _run_cases({"first": lambda: run(payload["steps"][0], "store1"),
                       "resumed": lambda: run(payload["steps"][1],
                                              "store2")})
