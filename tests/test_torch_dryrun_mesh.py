"""The dry run's collective term on a mesh, and split-K MLA decode.

* (a) The meta count equals the live count: for reduced ``llama3.2-3b``,
  ``phi3.5-moe`` under expert parallelism and ``minicpm3-4b`` at one
  layer and ``zamba2-1.2b`` at one group (2 layers), on ``(data 2, model
  4)`` and ``(pod 2, data 2, model 2)``, the train step, the prefill
  forward and one decode step run on every rank of a mesh of threads
  (``_torch_dist.ThreadMesh``) with real tensors, and each rank's
  ``Transport`` counts, by op and by axis, and the bytes it holds of the
  step's arguments equal, to the byte, those of a rank's program traced
  on meta tensors (the dry run's ``_rank_cell``): the same rank's at
  ranks that take every coordinate of every axis between them, rank
  0's at the others.  Split-K decode takes the int32 index the dry
  run's batch holds; a length an axis does not divide is refused, on
  meta tensors as live.
* (b) At full width on meta, the steps of ``chip_smoke.py``'s phases X6
  and X7 (llama3.2-3b at 2 of 28 layers, 2 x 2048 tokens) count the bytes
  their ranks' ``Transport`` counted on an H100.
* (c) ``mla_decode_splitk`` through ``decode_step`` / ``prefill_chunk``
  on ``model`` 2 and 4 x ``data`` 1 and 2 against the JAX package's
  one-device ``prefill_chunk`` + ``decode_step`` (reduced minicpm3-4b,
  fp32): a prompt chunk that straddles the ranks' stretches, then 4
  greedy decode steps; logits and each rank's latent blocks within 1e-5.
  A paged or quantized MLA state on ``model 2`` still raises.
* (d) The JAX dry run's collectives of (a)'s cells on ``(2, 4)`` (8 CPU
  devices, a subprocess started with the module's first test): the
  port's total over JAX's lies in [0.1, 10] for each cell.  The two lay
  the mesh out differently (the port by hand, JAX by its partitioner),
  so only the scale is held.
"""
import collections
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
from repro.configs.registry import get_config as jget
from repro.models.registry import get_api as jget_api
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.launch import dryrun
from repro_torch.launch.inputs import make_batch
from repro_torch.launch.mesh import MeshView
from repro_torch.models.common import init_params, shard_block
from repro_torch.models.registry import get_api
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.roofline import report
from repro_torch.train.state import (build_train_step, init_train_state,
                                     mesh_params, train_state_shardings)
from repro_torch.tree import map_tree

#: (arch, overrides of its reduced config): one decoder layer (zamba2:
#: one group of 2 Mamba layers and the shared block); a count sums the
#: same collectives a layer
CONFIGS = {"llama": ("llama3.2-3b", {"n_layers": 1}),
           "moe": ("phi3.5-moe-42b-a6.6b", {"use_ep": True, "n_layers": 1}),
           "zamba": ("zamba2-1.2b", {"n_layers": 2}),
           "mla": ("minicpm3-4b", {"n_layers": 1})}
MESHES = {"2x4": {"data": 2, "model": 4},
          "2x2x2": {"pod": 2, "data": 2, "model": 2}}
#: 8 sequences of 16 tokens; a decode step against a cache of 16
CELLS = {"train": ShapeConfig("train", 16, 8, "train"),
         "prefill": ShapeConfig("prefill", 16, 8, "prefill"),
         "decode": ShapeConfig("decode", 16, 8, "decode")}
#: the mesh of (d), on the JAX side a ("data", "model") device mesh
JAX_MESH = (2, 4)


def _cfg(name):
    arch, over = CONFIGS[name]
    return tget(arch).reduced(**over)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the thread meshes' ranks are threads already,
    and the tensors are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_counts():
    """The JAX dry run of (d), started before the other tests of the file
    and read by (d)."""
    spec = {"mesh": list(JAX_MESH),
            "cells": [[f"{name}_{kind}", CONFIGS[name][0], CONFIGS[name][1],
                       [shape.kind, shape.seq_len, shape.global_batch]]
                      for name in CONFIGS for kind, shape in CELLS.items()]}
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(here, os.pardir, "src"),
         os.environ.get("PYTHONPATH", "")]), JAX_PLATFORMS="cpu")
    # at a lower priority: it compiles beside the suite's other workers
    nice = ["nice", "-n", "10"] if shutil.which("nice") else []
    proc = subprocess.Popen(
        nice + [sys.executable, os.path.join(here, "_jax_dryrun.py"),
                json.dumps(spec)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    box = {}

    def result():
        if "out" not in box:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-2000:]
            box["out"] = json.loads(out.strip().splitlines()[-1])
        return box["out"]
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _counts(transport):
    return (collections.Counter(transport.axis_bytes),
            collections.Counter(transport.axis_calls),
            collections.Counter(transport.bytes))


#: rank 0's meta count of (a)'s cells, by (config, mesh, kind), which (d)
#: reads again
_RANK0 = {}


def _meta(name, mesh_name, kind, coord):
    """(transport, held bytes) of the rank at ``coord``'s step traced on
    meta tensors."""
    view, fn, args = dryrun._rank_cell(_cfg(name), CELLS[kind],
                                       MESHES[mesh_name], coord, None)
    held = dryrun.held_bytes(args[:-1])
    out = dryrun._run_counted(view, fn, args), held
    if not any(coord):
        _RANK0[name, mesh_name, kind] = out[0]
    return out


def _live(cfg, shape, mesh):
    """One step of ``shape``'s kind on this thread's rank, with real
    tensors: the train step on the rank's blocks of a seeded state, or the
    prefill forward / a decode step on ``mesh_params`` of the rank's
    blocks, the rank's rows and its block of a zero cache.  Returns the
    step's counts and the bytes the rank holds of its arguments but the
    batch."""
    api = get_api(cfg)
    gen = torch.Generator().manual_seed(0)
    batch = make_batch(cfg, shape)
    if shape.kind == "train":
        state = init_train_state(cfg, gen, mesh=mesh)
        step = build_train_step(cfg, AdamWConfig(lr=1e-3, grad_clip=1.0),
                                mesh=mesh)
        held = dryrun.held_bytes(state)
        mesh.transport.reset()
        step(state, batch)
        return _counts(mesh.transport), held
    whole = init_params(api.param_specs(cfg), gen, torch.device("cpu"))
    params = mesh_params(map_tree(
        lambda t, ps: shard_block(t, ps, mesh).clone(), whole,
        train_state_shardings(cfg, mesh)["params"]), cfg, mesh)
    rows = [a for a in mesh.axis_names if a != "model"]
    n, r, tp = mesh.size(rows), mesh.flat_index(rows), mesh.shape["model"]
    batch = {k: v if v.dim() == 0 else v.chunk(n)[r]
             for k, v in batch.items()}
    with torch.no_grad():
        mesh.transport.reset()
        if shape.kind == "prefill":
            api.forward(params, batch, cfg, mesh)
            return _counts(mesh.transport), dryrun.held_bytes(params)
        state = {}
        for k, sp in api.decode_state_specs(
                cfg, shape.global_batch, shape.seq_len).items():
            dims = list(sp.shape)
            dims[1] //= n
            if k in ("k", "v", "ckv", "kr"):
                dims[2] //= tp
            state[k] = torch.zeros(dims, dtype=sp.dtype)
        held = dryrun.held_bytes((params, state))
        mesh.transport.reset()
        api.decode_step(params, state, batch, cfg, mesh)
    return _counts(mesh.transport), held


@pytest.mark.parametrize("kind", sorted(CELLS))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_meta_count_equals_the_live_count_on_every_rank(name, mesh_name,
                                                        kind):
    cfg, shape, sizes = _cfg(name), CELLS[kind], MESHES[mesh_name]
    live = _torch_dist.run_threads(sizes, lambda m: _live(cfg, shape, m))
    coords = list(np.ndindex(*sizes.values()))
    # between them these ranks take every coordinate of every axis
    traced = {tuple(i % n for n in sizes.values())
              for i in range(max(sizes.values()))}
    metas = {c: _meta(name, mesh_name, kind, c) for c in sorted(traced)}
    meta, held = metas[coords[0]]
    for coord, (counts, live_held) in zip(coords, live):
        want, want_held = metas.get(coord, (meta, held))
        assert (counts, live_held) == (_counts(want), want_held), coord
        by_axis, calls, by_op = counts
        assert by_op and all(n > 0 for n in by_op.values()), coord
        # every op is counted under one of the mesh's axes
        assert {a for _, a in by_axis} <= set(sizes), by_axis
    by_axis, calls, by_op = _counts(meta)
    coll, axes = dryrun.collective_record(meta, sizes)
    assert sum(v["bytes"] for v in coll.values()) == sum(by_op.values())
    assert {dryrun.KINDS[op]: n for op, n in by_op.items()} == {
        k: v["bytes"] for k, v in coll.items()}
    assert sum(v["count"] for v in coll.values()) == sum(calls.values())
    assert sum(r["bytes"] for a in axes.values() for r in a.values()) == \
        sum(by_op.values())


def test_collective_record_follows_the_ring_model():
    """``wire_bytes`` of each kind: the JAX package's ring formulas with
    ``g`` the axis's ranks (``repro/roofline/analysis.py``)."""
    t = MeshView({"data": 4, "model": 2}).transport
    t.all_gather(torch.empty(10, device="meta"), "data")        # 40 B
    t.reduce_scatter(torch.empty(8, device="meta"), "model")    # 32 B
    t.all_reduce(torch.empty(3, device="meta"), "data")         # 12 B
    t.all_to_all(torch.empty(4, device="meta"), "model")        # 16 B
    t.all_reduce(torch.empty(2, device="meta"), "model")        # 8 B
    coll, axes = dryrun.collective_record(t, {"data": 4, "model": 2})
    assert coll == {
        "all-gather": {"bytes": 40, "wire_bytes": 40 * 3, "count": 1},
        "reduce-scatter": {"bytes": 32, "wire_bytes": 32 / 2, "count": 1},
        "all-reduce": {"bytes": 20, "wire_bytes": 2 * 12 * 3 / 4
                       + 2 * 8 / 2, "count": 2},
        "all-to-all": {"bytes": 16, "wire_bytes": 16 / 2, "count": 1}}
    assert axes["data"]["all-reduce"] == {"bytes": 12, "count": 1,
                                          "wire_bytes": 18.0}
    assert set(axes["model"]) == {"reduce-scatter", "all-to-all",
                                  "all-reduce"}
    with pytest.raises(ValueError, match="not a rank"):
        MeshView({"data": 2}, (2,))


def test_a_length_the_axis_does_not_divide_is_refused():
    """``reduce_scatter`` and ``all_to_all`` of a length the axis's ranks
    do not divide raise, and count nothing, on meta tensors and on a mesh
    of threads, as ``reduce_scatter_tensor`` and ``all_to_all_single``
    do on a live group."""
    t = MeshView({"model": 4}).transport
    with pytest.raises(ValueError, match="does not split"):
        t.reduce_scatter(torch.empty(3, 6, device="meta"), "model", dim=1)
    with pytest.raises(ValueError, match="does not split"):
        t.all_to_all(torch.empty(6, device="meta"), "model")
    assert not t.bytes
    assert t.reduce_scatter(torch.empty(3, 8, device="meta"), "model",
                            dim=1).shape == (3, 2)

    def rank(mesh):
        g, errs = mesh.group("model"), []
        for op in (lambda: mesh.transport.reduce_scatter(torch.ones(3), g),
                   lambda: mesh.transport.all_to_all(torch.ones(5), g)):
            with pytest.raises(ValueError, match="does not split") as e:
                op()
            errs.append(e.value)
        return errs, dict(mesh.transport.bytes)

    for errs, counted in _torch_dist.run_threads({"model": 2}, rank):
        assert len(errs) == 2 and counted == {}


def test_production_mesh_record_has_a_collective_term():
    """A reduced cell on the 16x16 and 2x16x16 meshes: the record's
    collectives, their sum, the roofline's collective term over
    ``ici_bw``, the dominant term over all three, and the report's row."""
    cfg = _cfg("llama")
    recs = []
    for mesh in ("single", "multi"):
        rec = dryrun.run_cell("llama3.2-3b", ShapeConfig("t", 32, 512,
                                                         "train"),
                              mesh=mesh, cfg=cfg, verbose=False)
        total = rec["collective_bytes_per_device"]
        assert total > 0 and total == sum(
            v["bytes"] for v in rec["collectives"].values())
        assert set(rec["collectives_by_axis"]) <= set(dryrun.MESHES[mesh])
        ro = rec["roofline"]
        assert ro["collective_s"] == total / dryrun.H100.ici_bw
        terms = {k: ro[k + "_s"] for k in ("compute", "memory",
                                           "collective")}
        assert ro["dominant"] == max(terms, key=terms.get)
        assert rec["multi_pod"] == (mesh == "multi")
        # a train rank holds its blocks under the JAX package's rules
        assert rec["resident_bytes_per_device"] == dryrun._resident_bytes(
            cfg, ShapeConfig("t", 32, 512, "train"), dryrun.MESHES[mesh],
            None)
        recs.append(rec)
    card = dryrun.run_cell("llama3.2-3b", ShapeConfig("t", 32, 512, "train"),
                           cfg=cfg, verbose=False)
    assert card["collectives"] == {} and card["collectives_by_axis"] == {}
    rows = report.collective_table([card] + recs).splitlines()
    assert len(rows) == 4 and rows[0].startswith("| arch | shape | mesh |")
    for row, rec in zip(rows[2:], recs):
        gb = [f"{rec['collectives'].get(k, {}).get('bytes', 0) / 1e9:.2f}"
              for k in ("all-gather", "reduce-scatter", "all-reduce",
                        "all-to-all")]
        assert row == (f"| llama3.2-3b | t | {rec['mesh']} | "
                       + " | ".join(gb) + " | "
                       f"{rec['collective_bytes_per_device'] / 1e9:.2f} | "
                       f"{report.fmt_seconds(rec['roofline']['collective_s'])}"
                       f" | {rec['roofline']['dominant']} |")


#: what the ranks' Transports counted on the card, a step (PERF.md, PRs
#: 30 and 31): X6 on (data 2, model 1), X7 fp32 on (model 2, data 1)
CARD_BYTES = {
    "X6": {"all_gather": 2_381_371_392, "reduce_scatter": 3_957_387_264,
           "all_reduce": 88},
    "X7": {"all_gather": 1_769_472_000, "reduce_scatter": 1_157_627_904,
           "all_reduce": 1_576_071_240}}


@pytest.mark.parametrize("phase", sorted(CARD_BYTES))
def test_full_width_meta_count_equals_the_cards(phase):
    over = {"n_layers": 2}
    if phase == "X7":
        over["dtype"] = torch.float32
    cfg = dataclasses.replace(tget("llama3.2-3b"), **over)
    mesh = ({"data": 2, "model": 1} if phase == "X6"
            else {"model": 2, "data": 1})
    got = dryrun.count_collectives(
        cfg, ShapeConfig("train", 2048, 2, "train"), mesh)
    assert dict(got.bytes) == CARD_BYTES[phase]


@pytest.mark.parametrize("name", ["llama", "mla"])
def test_splitk_decode_takes_an_int32_index(name):
    """The dry run's batch and JAX's hold a 0-d int32 index: split-K's
    owner write took it (``index_copy_`` wants int64) and gives what an
    int64 index gives."""
    cfg = _cfg(name)
    api = get_api(cfg)
    params = init_params(api.param_specs(cfg),
                         torch.Generator().manual_seed(1),
                         torch.device("cpu"))
    tokens = torch.tensor([[3], [5]])

    def rank(mesh):
        out = []
        for dt in (torch.int64, torch.int32):
            state = {k: torch.ones((sp.shape[0], 2, 8) + sp.shape[3:],
                                   dtype=sp.dtype)
                     for k, sp in api.decode_state_specs(cfg, 2, 16).items()}
            with torch.no_grad():
                logits, state = api.decode_step(
                    params, state, {"tokens": tokens,
                                    "index": torch.tensor(9, dtype=dt)},
                    cfg, mesh)
            out.append((logits, state))
        return out

    for (l64, s64), (l32, s32) in _torch_dist.run_threads({"model": 2},
                                                          rank):
        assert torch.equal(l64, l32)
        assert all(torch.equal(s64[k], s32[k]) for k in s64)


# ---------------------------------------------------------------------------
# (c) split-K MLA decode against the JAX package's one-device decode
# ---------------------------------------------------------------------------

#: a PROMPT-token chunk into a cache of SMAX (it straddles every stretch
#: of SMAX / model), then DECODE_STEPS greedy steps, for BATCH sequences
PROMPT, SMAX, DECODE_STEPS, BATCH = 20, 32, 4, 4


@pytest.fixture(scope="module")
def jax_mla():
    cfg = jget("minicpm3-4b").reduced(dtype=jnp.float32)
    api = jget_api(cfg)
    tcfg = tget("minicpm3-4b").reduced(dtype=torch.float32)
    params = map_tree(lambda t: t.numpy(), init_params(
        get_api(tcfg).param_specs(tcfg), torch.Generator().manual_seed(3),
        torch.device("cpu")))
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int64)
    state = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                         api.decode_state_specs(cfg, BATCH, SMAX),
                         is_leaf=lambda x: hasattr(x, "axes"))
    logits, state = jax.jit(lambda p, st, b: api.prefill_chunk(
        p, st, b, cfg))(params, state, {
            "tokens": jnp.asarray(prompt, jnp.int32), "index": jnp.int32(0),
            "nvalid": jnp.int32(PROMPT)})
    out, states = [np.asarray(logits)], [jax.tree.map(np.asarray, state)]
    decode = jax.jit(lambda p, st, b: api.decode_step(p, st, b, cfg))
    for i in range(DECODE_STEPS):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        logits, state = decode(params, state, {
            "tokens": tok, "index": jnp.int32(PROMPT + i)})
        out.append(np.asarray(logits))
        states.append(jax.tree.map(np.asarray, state))
    return params, prompt, np.stack(out), states


@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("tp", [2, 4])
def test_mla_decode_splitk_equals_the_jax_decode(jax_mla, tp, dp):
    jparams, prompt, want, states = jax_mla
    cfg = tget("minicpm3-4b").reduced(dtype=torch.float32)
    api = get_api(cfg)
    params = params_from_numpy(jparams, "cpu", torch.float32)

    def rank(mesh):
        d, m = mesh.index("data"), mesh.index("model")
        rows = torch.from_numpy(prompt).chunk(dp)[d]
        state = {k: torch.zeros((sp.shape[0], BATCH // dp, SMAX // tp)
                                + sp.shape[3:], dtype=sp.dtype)
                 for k, sp in api.decode_state_specs(cfg, BATCH,
                                                     SMAX).items()}
        out, blocks = [], []
        with torch.no_grad():
            logits, state = api.prefill_chunk(
                params, state, {"tokens": rows, "index": torch.tensor(0),
                                "nvalid": PROMPT}, cfg, mesh)
            out.append(logits)
            blocks.append({k: v.clone() for k, v in state.items()})
            for i in range(DECODE_STEPS):
                logits, state = api.decode_step(
                    params, state, {"tokens": logits.argmax(-1)[:, None],
                                    "index": torch.tensor(PROMPT + i)},
                    cfg, mesh)
                out.append(logits)
                blocks.append({k: v.clone() for k, v in state.items()})
        return (d, m), torch.stack(out).numpy(), blocks

    for (d, m), got, blocks in _torch_dist.run_threads(
            {"data": dp, "model": tp}, rank):
        rows = slice(d * BATCH // dp, (d + 1) * BATCH // dp)
        span = slice(m * SMAX // tp, (m + 1) * SMAX // tp)
        np.testing.assert_allclose(got, want[:, rows], rtol=1e-5, atol=1e-5)
        for step, (blk, st) in enumerate(zip(blocks, states)):
            for k, v in blk.items():
                np.testing.assert_allclose(
                    v.numpy(), st[k][:, rows, span], rtol=1e-5, atol=1e-5,
                    err_msg=f"{k} after call {step}")


def test_paged_and_quantized_mla_states_still_raise_on_a_model_axis():
    cfg = tget("minicpm3-4b").reduced(dtype=torch.float32)
    api = get_api(cfg)
    params = init_params(api.param_specs(cfg),
                         torch.Generator().manual_seed(0),
                         torch.device("cpu"))
    mesh = MeshView({"model": 2}, (0,), "cpu")
    l, rkv, dr = cfg.n_layers, cfg.kv_lora_rank, cfg.qk_rope_dim
    tokens = torch.zeros((2, 1), dtype=torch.int64)
    pools = {"ckv": torch.zeros((l, 5, 4, rkv)),
             "kr": torch.zeros((l, 5, 4, dr))}
    quant = {"ckv": torch.zeros((l, 5, 4, rkv), dtype=torch.int8),
             "ckv_scale": torch.zeros((l, 5, 4, 1)),
             "kr": torch.zeros((l, 5, 4, dr), dtype=torch.int8),
             "kr_scale": torch.zeros((l, 5, 4, 1))}
    pages = torch.tensor([[1, 2], [3, 4]])
    for state, extra in ((pools, {"pages": pages}),
                         (quant, {"pages": pages}), (quant, {})):
        with pytest.raises(ValueError, match="split-K only|page table"):
            api.decode_step(params, dict(state),
                            {"tokens": tokens, "index": torch.tensor(3),
                             **extra}, cfg, mesh)


# ---------------------------------------------------------------------------
# (d) the scale of the port's count against the JAX partitioner's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_total_within_10x_of_jax(jax_counts, name):
    sizes = dict(zip(("data", "model"), JAX_MESH))
    jax_out = jax_counts()
    for kind, shape in CELLS.items():
        meta = _RANK0.get((name, "2x4", kind))
        if meta is None:
            meta = dryrun.count_collectives(_cfg(name), shape, sizes)
        port = sum(meta.bytes.values())
        theirs = sum(v["bytes"] for v in jax_out[f"{name}_{kind}"].values())
        assert 0.1 <= port / theirs <= 10, (name, kind, port, theirs)
