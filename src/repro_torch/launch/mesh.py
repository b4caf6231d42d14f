"""Mesh shapes for the dry run (``repro/launch/mesh.py``).

A mesh here is an ordered mapping of axis name to size: all that the
sharding arithmetic (:func:`repro_torch.models.common.logical_to_pspec`)
and the dry run read.  There is no device mesh and no test mesh yet: those
need processes (``ROADMAP.md`` step 6b).
"""
from __future__ import annotations

from typing import Dict, Mapping

__all__ = ["make_production_mesh", "card_mesh", "mesh_summary"]


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """16x16 single-pod (256 chips) or 2x16x16 multi-pod (512 chips).

    Axes: ("data", "model") / ("pod", "data", "model"). "data" carries
    DP + FSDP; "model" carries TP / EP / SP / kv-seq sharding; "pod" is the
    slow boundary between pods (gradient reduction only).
    """
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def card_mesh() -> Dict[str, int]:
    """One card: every rule falls back to replication."""
    return {"data": 1, "model": 1}


def mesh_summary(mesh: Mapping[str, int]) -> str:
    return "x".join(f"{k}={v}" for k, v in mesh.items())
