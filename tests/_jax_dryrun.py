"""The JAX dry run's collectives of small cells on 8 CPU devices.

    python tests/_jax_dryrun.py '<json spec>'

The spec is ``{"mesh": [2, 4], "cells": [[name, arch, overrides,
[kind, seq_len, global_batch]], ...]}``; each cell's config is the arch's
reduced one with ``overrides``.  ``repro.launch.dryrun.run_cell`` (no
cost pass) runs each on a ``("data", "model")`` mesh of that shape, and
the last line of stdout is ``{name: collectives}``.  A process of its own:
the device count is fixed when JAX starts, and importing
``repro.launch.dryrun`` asks for 512 devices, so the count is set again
after that import and before JAX starts.  The collectives are the SPMD
partitioner's, fixed before code generation, so the CPU backend compiles
without LLVM's optimizations (the same counts, in less time).
"""
import json
import os
import sys

from repro.launch import dryrun as jdry  # noqa: E402  (sets XLA_FLAGS)

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import SHAPES, ShapeConfig  # noqa: E402
from repro.configs.registry import get_config  # noqa: E402


def main(spec: dict) -> dict:
    shape = tuple(spec["mesh"])
    mesh = jax.sharding.Mesh(
        np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
        ("data", "model"))
    out = {}
    for name, arch, over, (kind, seq, batch) in spec["cells"]:
        SHAPES[name] = ShapeConfig(name, seq, batch, kind)
        rec = jdry.run_cell(arch, name, multi_pod=False, mesh=mesh,
                            cost_pass=False, verbose=False,
                            cfg=get_config(arch).reduced(**over))
        out[name] = rec["collectives"]
    return out


if __name__ == "__main__":
    print(json.dumps(main(json.loads(sys.argv[1]))))
