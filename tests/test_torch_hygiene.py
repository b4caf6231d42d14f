"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the JAX package ``repro``, entry points default to the
card, and a CPU tensor takes the plain path without launching a kernel."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels import moa_reduce as moa
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.models.common import init_params
from repro_torch.models.registry import get_api
from repro_torch.serve import ServeEngine

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_files_found():
    rel = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/serve/engine.py",
            "src/repro_torch/kernels/moa_reduce.py",
            "src/repro_torch/kernels/flash_attention.py",
            "src/repro_torch/train/state.py",
            "src/repro_torch/train/loop.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/optim/adamw.py",
            "src/repro_torch/data/pipeline.py",
            "src/repro_torch/ft/failures.py",
            "src/repro_torch/kernels/bitplane_add.py",
            "src/repro_torch/kernels/quant_matmul.py",
            "src/repro_torch/core/moa.py",
            "chip_smoke.py"} <= rel


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def _imports_no_jax(modules):
    code = (f"import sys, {modules}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr


def test_engine_import_loads_no_jax():
    _imports_no_jax("repro_torch.serve.engine, repro_torch.launch.serve")


def test_train_import_loads_no_jax():
    _imports_no_jax("repro_torch.launch.train, repro_torch.train.loop")


def test_adder_import_loads_no_jax():
    _imports_no_jax("repro_torch.kernels.ops, repro_torch.core.moa")


def test_engine_defaults_to_the_card():
    cfg = get_config("llama3.2-3b").reduced(dtype=torch.float32)
    params = init_params(get_api(cfg).param_specs(cfg),
                         torch.Generator().manual_seed(0),
                         torch.device("cpu"), torch.float32)
    if torch.cuda.is_available():
        eng = ServeEngine(cfg, params, device=None)
        assert eng.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(cfg, params, device=None)


def test_cpu_tensor_takes_plain_path_without_launch():
    x = torch.randn(16, 4, 24)
    before = moa.LAUNCHES
    got = ops.moa_reduce(x)
    assert moa.LAUNCHES == before
    assert torch.equal(got, moa.moa_reduce_plain(x))


def test_train_cli_defaults_to_the_card():
    argv = ["--reduced", "--steps", "1", "--seq", "16", "--batch", "2"]
    if torch.cuda.is_available():
        assert train_cli.main(argv) == 0
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(argv)
