"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's: shape cells, parameter counts, sharding specs and resident
bytes for every arch at full width (from the specs alone, nothing
allocated), deterministic batches, one full-width cell traced on meta
tensors through ``run_cell`` and the CLI, and the kernel entry points on
meta tensors."""
import json
import os

# ``repro.launch.dryrun`` asks XLA for 512 host devices when it is
# imported; this process keeps the device count it had
_saved_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry  # noqa: E402
if _saved_flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _saved_flags

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs.registry import get_config as jget  # noqa: E402
from repro.configs.registry import list_archs  # noqa: E402
from repro.launch import inputs as jinputs  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models.registry import get_api as jget_api  # noqa: E402
from repro.train.state import train_state_shardings  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import bitplane_add as bpa  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moa_reduce as moa  # noqa: E402
from repro_torch.kernels import quant_matmul as qmm  # noqa: E402
from repro_torch.launch import dryrun, inputs, mesh  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.registry import get_api  # noqa: E402
from repro_torch.roofline import report  # noqa: E402
from repro_torch.roofline.analysis import count_cost  # noqa: E402

ARCHS = list_archs()
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _flat(tree, prefix=(), seq=(list, tuple)):
    """{path: leaf} of a tree of dicts and ``seq`` containers (either
    package's)."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in
                _flat(tree[k], prefix + (k,), seq).items()}
    if isinstance(tree, seq):
        return {p: v for i, x in enumerate(tree) for p, v in
                _flat(x, prefix + (i,), seq).items()}
    return {prefix: tree}


def test_shapes_and_cells_equal():
    assert list(base.SHAPES) == list(jbase.SHAPES)
    for name, s in base.SHAPES.items():
        j = jbase.SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == (
            j.name, j.seq_len, j.global_batch, j.kind)
    assert base._FULL_ATTENTION == jbase._FULL_ATTENTION
    cells = 0
    for arch in ARCHS:
        enc = get_config(arch).encoder_only
        assert enc == jget(arch).encoder_only
        assert base.cells_for(arch, enc) == jbase.cells_for(arch, enc)
        cells += len(base.cells_for(arch, enc))
    assert cells == 31


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal(arch):
    n = common.param_count(get_api(get_config(arch)).param_specs(
        get_config(arch)))
    jcfg = jget(arch)
    jn = jcommon.param_count(jget_api(jcfg).param_specs(jcfg))
    assert n == jn
    assert dryrun._active_params(get_config(arch), n) == \
        jdry._active_params(jcfg, jn)


def _spec_trees(arch, shape_name):
    """(port, JAX) ParamSpec trees a cell keeps resident, by name."""
    cfg, jcfg = get_config(arch), jget(arch)
    shape, jshape = base.SHAPES[shape_name], jbase.SHAPES[shape_name]
    out = {"params": (get_api(cfg).param_specs(cfg),
                      jget_api(jcfg).param_specs(jcfg))}
    if shape.kind == "decode":
        out["state"] = (inputs.decode_state_structs(cfg, shape)[1],
                        jinputs.decode_state_structs(jcfg, jshape)[1])
    return out


def _cells():
    return [(a, s) for a in ARCHS
            for s in base.cells_for(a, get_config(a).encoder_only)]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch,shape_name", _cells())
def test_pspecs_and_resident_bytes_equal(arch, shape_name, mesh_name):
    sizes, names = MESHES[mesh_name]
    amesh = AbstractMesh(sizes, names)
    pmesh = dryrun.MESHES[mesh_name]
    assert pmesh == dict(zip(names, sizes))
    for what, (ptree, jtree) in _spec_trees(arch, shape_name).items():
        pflat, jflat = _flat(ptree), _flat(jtree)
        assert set(pflat) == set(jflat), what
        got = _flat(common.make_shardings(ptree, pmesh), seq=list)
        for path, js in jflat.items():
            ps = pflat[path]
            assert (ps.shape, ps.axes) == (js.shape, js.axes), path
            want = tuple(jcommon.logical_to_pspec(js.axes, amesh, None,
                                                  js.shape))
            assert common.logical_to_pspec(ps.axes, pmesh, None,
                                           ps.shape) == want, (what, path)
            assert got[path] == want, (what, path)
    # resident bytes, as each package's run_cell sums them
    cfg, jcfg = get_config(arch), jget(arch)
    shape, jshape = base.SHAPES[shape_name], jbase.SHAPES[shape_name]
    if shape.kind == "train":
        want = jdry._sharded_bytes(
            jcommon.shape_structs(jdry.train_state_specs(jcfg)),
            train_state_shardings(jcfg, amesh), amesh)
    else:
        pspecs = jget_api(jcfg).param_specs(jcfg)
        want = jdry._sharded_bytes(jcommon.shape_structs(pspecs),
                                   jcommon.make_shardings(pspecs, amesh),
                                   amesh)
        if shape.kind == "decode":
            _, sspecs = jinputs.decode_state_structs(jcfg, jshape)
            want += jdry._sharded_bytes(
                jcommon.shape_structs(sspecs),
                jcommon.make_shardings(sspecs, amesh), amesh)
    assert dryrun._resident_bytes(cfg, shape, pmesh, None) == want


def test_production_meshes():
    assert list(mesh.make_production_mesh().items()) == [("data", 16),
                                                         ("model", 16)]
    assert list(mesh.make_production_mesh(multi_pod=True).items()) == [
        ("pod", 2), ("data", 16), ("model", 16)]
    for multi in (False, True):
        sizes, names = MESHES["multi" if multi else "single"]
        assert mesh.mesh_summary(mesh.make_production_mesh(
            multi_pod=multi)) == "x".join(f"{n}={s}" for n, s in
                                          zip(names, sizes))
    assert mesh.mesh_summary(mesh.card_mesh()) == "data=1xmodel=1"


def test_pspec_rules_edge_cases():
    """A mesh axis is used once, a non-dividing dim replicates, trailing
    Nones go, and ``exclude`` drops an axis: as the JAX package does."""
    pm = {"pod": 2, "data": 16, "model": 16}
    am = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    cases = [(("heads", "mlp", None), (32, 64, 8), None),
             (("embed", "vocab"), (4096, 151552), None),
             (("embed", "vocab"), (4096, 151553), None),
             (("kv_heads", None, None), (2, 128, 4), None),
             (("batch", "kv_seq", None), (128, 32768, 4), {"pod"}),
             (("layers", None), (28, 3), None)]
    for axes, shp, excl in cases:
        want = tuple(jcommon.logical_to_pspec(axes, am, None, shp, excl))
        assert common.logical_to_pspec(axes, pm, None, shp, excl) == want


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_equal(arch, kind):
    cfg, jcfg = get_config(arch).reduced(), jget(arch).reduced()
    shape = base.ShapeConfig("t", 32, 3, kind)
    jshape = jbase.ShapeConfig("t", 32, 3, kind)
    got = inputs.make_batch(cfg, shape, seed=5)
    want = jinputs.make_batch(jcfg, jshape, seed=5)
    assert list(got) == list(want)
    specs = inputs.input_specs(cfg, shape)
    assert inputs.batch_logical_axes(cfg, shape) == \
        jinputs.batch_logical_axes(jcfg, jshape)
    for k, w in want.items():
        g = got[k]
        assert g.device.type == "cpu" and specs[k].device.type == "meta"
        assert tuple(g.shape) == w.shape == tuple(specs[k].shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert np.array_equal(g.float().numpy(),
                              np.asarray(w, dtype=np.float32)), k


def test_full_width_cell_run_cell_cli_and_report(tmp_path, capsys):
    """llama3.2-3b decode_32k at full width, traced on meta tensors."""
    rec = dryrun.run_cell("llama3.2-3b", "decode_32k", verbose=False)
    assert rec["chips"] == 1 and rec["collectives"] == {}
    assert rec["collective_bytes_per_device"] == 0.0
    assert rec["memory_analysis"]["temp_size"] is None
    cfg = get_config("llama3.2-3b")
    n = common.param_count(get_api(cfg).param_specs(cfg))
    assert rec["n_params"] == n
    kv = 2 * 28 * 128 * 32768 * 8 * 128 * 2          # K and V, bf16
    assert rec["resident_bytes_per_device"] == 4 * n + kv
    assert not rec["fits_hbm"]
    ro = rec["roofline"]
    assert ro["dominant"] == "memory" and ro["hw"] == "h100-sxm5"
    # every matmul of the step: at least the model's 2 N FLOPs a token
    assert ro["model_flops"] == 2.0 * n * 128
    assert rec["cost_analysis"]["flops"] >= ro["model_flops"]
    assert rec["cost_analysis"]["bytes"] >= 4 * n + kv
    assert dryrun.main(["--arch", "llama3.2-3b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    path = tmp_path / "llama3.2-3b__decode_32k__card.json"
    with open(path) as f:
        cli_rec = json.load(f)
    for k in ("cost_analysis", "resident_bytes_per_device", "roofline",
              "n_params", "n_active_params", "tokens_per_step", "mesh"):
        assert cli_rec[k] == rec[k], k
    capsys.readouterr()
    assert dryrun.main(["--arch", "llama3.2-3b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    assert "skip (cached)" in capsys.readouterr().out
    assert report.main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "1 traced cells (1 one-card, 0 single-pod 16x16" in out
    assert "| llama3.2-3b | decode_32k | data=1xmodel=1 |" in out
    assert "## Roofline (one card, per-device terms)" in out


@pytest.mark.parametrize("arch", ["llama3.2-3b", "minicpm3-4b",
                                  "falcon-mamba-7b"])
def test_flops_against_xla(arch):
    """XLA's count over the port's for reduced prefill (2, 128): in
    [1.0, 1.3].  XLA also counts elementwise work and ``FlopCounterMode``
    only matmul-class ops, so the ratio is above 1, most for the SSM scan
    (measured 1.057, 1.065, 1.263)."""
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    fn, structs = jdry.build_cell(jget(arch).reduced(),
                                  jbase.ShapeConfig("c", 128, 2, "prefill"),
                                  jmesh, donate=False)
    with jmesh, jcommon.unrolled_scans():
        xla = jdry.extract_cost(fn.lower(*structs))["flops"]
    pfn, args = dryrun.build_cell(get_config(arch).reduced(),
                                  base.ShapeConfig("c", 128, 2, "prefill"))
    port = count_cost(pfn, *args)["flops"]
    assert 1.0 <= xla / port <= 1.3, xla / port


def test_meta_tensors_take_the_plain_path(monkeypatch):
    """No build, no launch counter, no kernel wrapper on meta."""
    def refuse(*a, **k):
        raise AssertionError("a meta tensor reached the kernel build")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    counters = [(moa, "LAUNCHES"), (bpa, "LAUNCHES"), (qmm, "LAUNCHES"),
                (fa, "LAUNCHES_FWD"), (fa, "LAUNCHES_BWD_DQ"),
                (fa, "LAUNCHES_BWD_DKV")]
    before = [getattr(m, n) for m, n in counters]
    meta = torch.device("meta")
    x = torch.empty(16, 4, 24, device=meta, requires_grad=True)
    out = ops.moa_reduce(x)
    assert out.shape == (4, 24) and out.device == meta
    out.sum().backward()
    assert x.grad.shape == x.shape
    assert ops.bitplane_add(torch.empty(8, 32, dtype=torch.int32,
                                        device=meta), 8).shape == (32,)
    y = ops.quant_matmul(torch.empty(8, 64, dtype=torch.int8, device=meta),
                         torch.empty(64, 16, dtype=torch.int8, device=meta))
    assert y.shape == (8, 16) and y.dtype == torch.int32
    q = torch.empty(2, 32, 4, 16, device=meta, requires_grad=True)
    k = torch.empty(2, 32, 2, 16, device=meta, requires_grad=True)
    v = torch.empty(2, 32, 2, 16, device=meta, requires_grad=True)
    o = ops.flash_attention(q, k, v)
    assert o.shape == q.shape
    o.sum().backward()
    assert (q.grad.shape, k.grad.shape) == (q.shape, k.shape)
    assert [getattr(m, n) for m, n in counters] == before


class _Elsewhere:
    """A tensor stand-in on a device the port does not run on."""

    dtype = torch.float32
    shape = (4, 8, 2, 16)
    device = torch.device("mps")

    def to(self, *a, **k):
        return self


@pytest.mark.parametrize("call", [
    lambda t: ops.moa_reduce(t), lambda t: ops.bitplane_add(t, 8),
    lambda t: ops.quant_matmul(t, t), lambda t: ops.flash_attention(t, t, t)],
    ids=["moa_reduce", "bitplane_add", "quant_matmul", "flash_attention"])
def test_other_devices_still_raise(call):
    with pytest.raises(ValueError, match="runs on cuda, cpu or meta"):
        call(_Elsewhere())
