"""Render the dry run's tables from its record files.

    PYTHONPATH=src python -m repro_torch.roofline.report results/dryrun_torch

The counterpart of ``repro/roofline/report.py``, with the port's wording:
a cell is traced on meta tensors (its trace seconds stand where the JAX
tables print compile seconds), counted bytes are per aten op, and the
card's HBM is an H100's.  The collective columns are the counts and
bytes of one rank's step on the mesh (``launch/dryrun.py``
``count_collectives``); a record with no collective term (``None``: its
mesh path raises) and no temp size prints ``n/a`` there.
"""
from __future__ import annotations

import glob
import json
import os
import sys
from typing import Dict, List

from repro_torch.roofline.analysis import H100, fmt_seconds

__all__ = ["load_records", "dryrun_table", "roofline_table",
           "collective_table", "summarize", "main"]


def load_records(out_dir: str) -> List[Dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def _gb(x) -> str:
    return "n/a" if x is None else f"{x / 1e9:.2f}"


def dryrun_table(recs: List[Dict]) -> str:
    lines = [
        "| arch | shape | mesh | trace s | resident GB/dev | temp "
        "GB/dev | collectives (count: ag/ar/rs/a2a/cp) | coll GB/dev |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        c = r["collectives"]
        counts = "n/a" if c is None else "/".join(
            str(int(c.get(k, {}).get("count", 0))) for k in (
                "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute"))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['trace_s']} | {_gb(r['resident_bytes_per_device'])} "
            f"| {_gb(r['memory_analysis'].get('temp_size'))} | {counts} "
            f"| {_gb(r['collective_bytes_per_device'])} |")
    return "\n".join(lines)


def roofline_table(recs: List[Dict], single_pod_only: bool = True) -> str:
    lines = [
        "| arch | shape | compute | memory | collective | dominant | "
        "bound | MODEL_FLOPS | counted/MODEL | note |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if single_pod_only and r["multi_pod"]:
            continue
        ro = r["roofline"]
        ratio = (ro["hlo_flops_global"] / ro["model_flops"]
                 if ro["model_flops"] else float("nan"))
        note = _bottleneck_note(r)
        lines.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {fmt_seconds(ro['compute_s'])} "
            f"| {fmt_seconds(ro['memory_s'])} "
            f"| {fmt_seconds(ro['collective_s'])} "
            f"| {ro['dominant']} | {fmt_seconds(ro['bound_s'])} "
            f"| {ro['model_flops']:.2e} | {ratio:.2f} | {note} |")
    return "\n".join(lines)


def _bottleneck_note(r: Dict) -> str:
    ro = r["roofline"]
    dom = ro["dominant"]
    if dom == "collective":
        big = max(r["collectives"].items(),
                  key=lambda kv: kv[1]["bytes"])[0]
        return f"{big} dominates wire traffic"
    if dom == "memory":
        if r["kind"] == "decode":
            return "weight+KV streaming (decode is bandwidth-bound)"
        return "activation traffic (per-op aten bytes)"
    return "tensor-core-bound"


#: the kinds the port's mesh code issues, in the table's order
_KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all")


def collective_table(recs: List[Dict]) -> str:
    """The records of 2 or more chips: per device, the GB handed to each
    kind of collective in one rank's step, their sum, the collective
    term (the sum over the ``H100`` entry's 50 GB/s a link) and the
    dominant term; ``n/a`` where the cell's mesh path raises."""
    lines = [
        "| arch | shape | mesh | " + " | ".join(f"{k} GB" for k in _KINDS)
        + " | coll GB/dev | collective | dominant |",
        "|---|---|---|" + "---|" * (len(_KINDS) + 3),
    ]
    for r in recs:
        if r["chips"] < 2:
            continue
        c = r["collectives"]
        kinds = " | ".join(
            "n/a" if c is None else _gb(c.get(k, {}).get("bytes", 0))
            for k in _KINDS)
        ro = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {kinds} "
            f"| {_gb(r['collective_bytes_per_device'])} "
            f"| {fmt_seconds(ro['collective_s'])} | {ro['dominant']} |")
    return "\n".join(lines)


def summarize(recs: List[Dict]) -> str:
    n_card = sum(r["chips"] == 1 for r in recs)
    n_single = sum(not r["multi_pod"] and r["chips"] > 1 for r in recs)
    n_multi = sum(bool(r["multi_pod"]) for r in recs)
    fits = sum(bool(r["fits_hbm"]) for r in recs)
    card = f"{n_card} one-card, " if n_card else ""
    return (f"{len(recs)} traced cells ({card}{n_single} single-pod 16x16, "
            f"{n_multi} multi-pod 2x16x16); resident state fits "
            f"{H100.hbm_per_chip / 1e9:.0f} GB HBM on {fits}/{len(recs)}.")


def main(argv=None) -> int:
    out_dir = (argv or sys.argv[1:] or ["results/dryrun_torch"])[0]
    recs = load_records(out_dir)
    print("## Dry-run summary\n")
    print(summarize(recs) + "\n")
    print(dryrun_table(recs))
    if any(r["chips"] > 1 for r in recs):
        print("\n## Collectives (per device, one rank's step)\n")
        print(collective_table(recs))
    for title, keep in (("one card", lambda r: r["chips"] == 1),
                        ("single-pod 16x16",
                         lambda r: r["chips"] > 1 and not r["multi_pod"])):
        sub = [r for r in recs if keep(r)]
        if sub:
            print(f"\n## Roofline ({title}, per-device terms)\n")
            print(roofline_table(sub))
    return 0


if __name__ == "__main__":
    sys.exit(main())
