"""The port's roofline arithmetic and report (``repro_torch.roofline``)
against the JAX package's, with the JAX ``HW`` built from the port's H100
numbers, and ``count_cost`` on meta tensors."""
import json
import math

import pytest
import torch

from repro.roofline import report as jreport
from repro.roofline.analysis import HW as JHW
from repro.roofline.analysis import fmt_seconds as jfmt
from repro.roofline.analysis import model_flops as jmodel_flops
from repro.roofline.analysis import roofline_report as jroofline
from repro_torch.roofline import report
from repro_torch.roofline.analysis import (H100, count_cost, fmt_seconds,
                                           model_flops, roofline_report)

JH100 = JHW(name=H100.name, peak_flops=H100.peak_flops, hbm_bw=H100.hbm_bw,
            ici_bw=H100.ici_bw, hbm_per_chip=H100.hbm_per_chip)

#: the port's wording where the JAX tables name XLA or a TPU; nothing else
#: in the text may differ
WORDING = [("compile s", "trace s"), ("HLO temp GB/dev", "temp GB/dev"),
           ("HLO/MODEL", "counted/MODEL"), ("MXU-bound", "tensor-core-bound"),
           ("pre-fusion HLO bytes", "per-op aten bytes"),
           ("compiled cells", "traced cells"), ("16 GB HBM", "80 GB HBM")]


def _ported_text(text):
    for jax_words, port_words in WORDING:
        text = text.replace(jax_words, port_words)
    return text


def test_h100_constants():
    assert (H100.peak_flops, H100.hbm_bw, H100.hbm_per_chip) == (
        989e12, 3.35e12, 80e9)
    assert H100.ici_bw == 900e9 / 18


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("n_active", [None, 6_600_000_000])
def test_model_flops_equal(kind, n_active):
    for n, d in ((3_212_749_824, 1_048_576), (41_873_153_024, 128), (1, 1)):
        assert model_flops(n, d, kind, n_active) == \
            jmodel_flops(n, d, kind, n_active)


REPORT_INPUTS = [
    dict(flops_per_device=2.266e12, bytes_per_device=5.1e11,
         coll_bytes_per_device=0.0, chips=1, model_flops_total=8.2e11),
    dict(flops_per_device=1.2e14, bytes_per_device=3.0e12,
         coll_bytes_per_device=0.0, chips=256, model_flops_total=2.9e16),
    dict(flops_per_device=4.0e9, bytes_per_device=1.0e12,
         coll_bytes_per_device=2.5e10, chips=512, model_flops_total=0.0),
    dict(flops_per_device=0.0, bytes_per_device=0.0,
         coll_bytes_per_device=0.0, chips=1, model_flops_total=0.0),
]


@pytest.mark.parametrize("kw", REPORT_INPUTS)
def test_roofline_report_equal(kw):
    assert roofline_report(hw=H100, **kw) == jroofline(hw=JH100, **kw)


def test_roofline_report_without_collective_term():
    ro = roofline_report(flops_per_device=1e15, bytes_per_device=1e12,
                         coll_bytes_per_device=None, chips=256)
    assert ro["collective_s"] is None and ro["dominant"] == "compute"
    assert ro["bound_s"] == 1e15 / H100.peak_flops
    assert fmt_seconds(None) == "n/a"


@pytest.mark.parametrize("s", [0, 0.0, 3e-9, 9.99e-4, 1e-3, 0.5, 0.999,
                               1.0, 42.123, 1e5])
def test_fmt_seconds_equal(s):
    assert fmt_seconds(s) == jfmt(s)


def _records():
    """(port records, JAX records) of the same synthetic cells, the
    collective term 0."""
    cells = [("llama3.2-3b", "train_4k", "train", False, 1.2e15, 9e11, True),
             ("llama3.2-3b", "decode_32k", "decode", False, 2e11, 4e11, True),
             ("phi3.5-moe-42b-a6.6b", "prefill_32k", "prefill", True, 3e14,
              1e14, False),
             ("zamba2-1.2b", "long_500k", "decode", True, 1e9, 1e10, True),
             ("hubert-xlarge", "prefill_32k", "prefill", False, 1e12, 2e13,
              False)]
    port, jax_recs = [], []
    for i, (arch, shape, kind, multi, flops, byts, fits) in enumerate(cells):
        chips = 512 if multi else 256
        kw = dict(flops_per_device=flops, bytes_per_device=byts,
                  coll_bytes_per_device=0.0, chips=chips,
                  model_flops_total=flops * chips * 0.8 if i else 0.0)
        common = {
            "arch": arch, "shape": shape, "kind": kind,
            "mesh": ("pod=2xdata=16xmodel=16" if multi
                     else "data=16xmodel=16"),
            "chips": chips, "multi_pod": multi,
            "collectives": {}, "collective_bytes_per_device": 0.0,
            "memory_analysis": {"temp_size": 1.5e9 * i},
            "resident_bytes_per_device": 3.7e9 * (i + 1),
            "fits_hbm": fits}
        port.append(dict(common, trace_s=round(0.37 * i, 2),
                         roofline=roofline_report(hw=H100, **kw)))
        jax_recs.append(dict(common, compile_s=round(0.37 * i, 2),
                             roofline=jroofline(hw=JH100, **kw)))
    return port, jax_recs


def test_report_tables_and_summary_equal():
    port, jax_recs = _records()
    assert report.dryrun_table(port) == _ported_text(
        jreport.dryrun_table(jax_recs))
    for single in (True, False):
        assert report.roofline_table(port, single) == _ported_text(
            jreport.roofline_table(jax_recs, single))
    assert report.summarize(port) == _ported_text(jreport.summarize(jax_recs))


def test_report_without_collectives_prints_na(tmp_path, capsys):
    port, _ = _records()
    rec = dict(port[1], collectives=None, collective_bytes_per_device=None,
               memory_analysis={"temp_size": None},
               roofline=roofline_report(
                   flops_per_device=2e11, bytes_per_device=4e11,
                   coll_bytes_per_device=None, chips=256))
    row = report.dryrun_table([rec]).splitlines()[-1]
    assert row.endswith("| n/a | n/a | n/a |")
    row = report.roofline_table([rec]).splitlines()[-1]
    assert "| n/a | memory |" in row
    card = dict(port[0], chips=1, mesh="data=1xmodel=1")
    assert report.summarize([card, rec]).startswith(
        "2 traced cells (1 one-card, 1 single-pod 16x16, 0 multi-pod")
    with open(tmp_path / "a.json", "w") as f:
        json.dump(card, f)
    assert report.main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "## Roofline (one card, per-device terms)" in out
    assert "single-pod 16x16, per-device" not in out


def test_count_cost_matmul_and_view():
    x = torch.empty(64, 128, device="meta")
    w = torch.empty(128, 32, device="meta")
    got = count_cost(lambda a, b: a @ b, x, w)
    assert got["flops"] == 2 * 64 * 128 * 32
    assert got["bytes"] == 4 * (64 * 128 + 128 * 32 + 64 * 32)
    assert got["out"].shape == (64, 32) and got["ops"] == 1
    got = count_cost(lambda a: a.view(-1), x)
    assert got["bytes"] == 0 and got["flops"] == 0 and got["ops"] == 1
    got = count_cost(lambda a: a.transpose(0, 1)[3:9], x)
    assert got["bytes"] == 0 and got["ops"] == 2
    # a bf16 elementwise op: both inputs and the output, no FLOPs counted
    a = torch.empty(1000, dtype=torch.bfloat16, device="meta")
    got = count_cost(torch.add, a, a)
    assert got["bytes"] == 3 * 2000 and got["flops"] == 0
    assert math.isclose(got["bytes"] / H100.hbm_bw, 6000 / 3.35e12)
