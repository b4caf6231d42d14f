"""Roofline analysis from a meta-tensor trace (no card required).

The counterpart of ``repro/roofline/analysis.py``.  Three terms per
(arch x shape x mesh) cell, all in seconds:

    compute    = FLOPs            / (chips * PEAK_FLOPS)
    memory     = bytes            / (chips * HBM_BW)
    collective = collective_bytes / (chips * ICI_BW)

FLOPs and bytes come from :func:`count_cost`, which runs the step once on
meta tensors (the JAX package reads them from XLA's ``cost_analysis()``).
The collective bytes a device moves come from one rank's step traced on
meta tensors by the port's own mesh code, each collective counted by a
:class:`~repro_torch.dist.transport.MetaTransport`
(:func:`repro_torch.launch.dryrun.count_collectives`), where the JAX
package reads them from the partitioned HLO; 0 on one card, which moves
nothing, and ``None`` where a cell's mesh path raises.  XLA's HLO text
parsers (``collective_breakdown``, ``collective_bytes``,
``count_hlo_ops``) have no counterpart: there is no HLO text.

Hardware model: one NVIDIA H100 SXM5 (NVIDIA's H100 Tensor Core GPU data
sheet, dense rates without sparsity): 989 TFLOP/s bf16, 3.35 TB/s HBM3,
80 GB, and NVLink 4 at 900 GB/s over 18 links, i.e. 50 GB/s a link.  The
rates assume the card's full 700 W power limit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["HW", "H100", "count_cost", "roofline_report", "model_flops",
           "fmt_seconds"]


@dataclasses.dataclass(frozen=True)
class HW:
    name: str
    peak_flops: float          # per-chip, bf16
    hbm_bw: float              # per-chip bytes/s
    ici_bw: float              # per-link bytes/s
    hbm_per_chip: float        # bytes


H100 = HW(name="h100-sxm5", peak_flops=989e12, hbm_bw=3.35e12, ici_bw=50e9,
          hbm_per_chip=80e9)


# ---------------------------------------------------------------------------
# cost counting on meta tensors
# ---------------------------------------------------------------------------

#: ops that alias their input but whose schema does not say so
_ALIASING = {torch.ops.aten._unsafe_view.default}


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every tensor input and output of each aten op;
    a view moves none."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        if not (func.is_view or func in _ALIASING):
            self.bytes += sum(
                t.numel() * t.element_size()
                for t in tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor))
        return out


def count_cost(fn: Callable, *args) -> Dict[str, Any]:
    """Run ``fn(*args)`` once and count its work: ``flops`` from
    ``torch.utils.flop_counter.FlopCounterMode`` (matmul-class ops only:
    elementwise work, which XLA's count includes, is not counted) and
    ``bytes``, the bytes of every tensor input and output of each aten op
    (views count 0), the counterpart of XLA's pre-fusion "bytes
    accessed".  Both counts are per op, not per fused kernel: a fused
    kernel reads and writes less.

    Meant for meta tensors, which carry shapes and no data, so nothing
    runs on any device and a kernel is never launched: the kernel entry
    points take their plain versions on meta (``gqa_train`` gates flash on
    ``x.is_cuda``), whose matmuls are counted.  A CUDA kernel's launch
    through ``ctypes`` is invisible to both counters.  Returns ``{"flops",
    "bytes", "ops", "out"}``, ``out`` being what ``fn`` returned."""
    flop_mode = FlopCounterMode(display=False)
    byte_mode = _ByteCounter()
    with flop_mode, byte_mode:
        out = fn(*args)
    return {"flops": float(flop_mode.get_total_flops()),
            "bytes": float(byte_mode.bytes), "ops": byte_mode.ops,
            "out": out}


# ---------------------------------------------------------------------------
# roofline report
# ---------------------------------------------------------------------------

def model_flops(n_params: int, n_tokens: int, kind: str,
                n_active: Optional[int] = None) -> float:
    """Useful-work FLOPs: 6*N*D for a train step (fwd+bwd), 2*N*D for
    forward-only (prefill/decode). MoE: pass activated params as n_active."""
    n = n_active if n_active is not None else n_params
    per_tok = 6.0 * n if kind == "train" else 2.0 * n
    return per_tok * n_tokens


def roofline_report(*, flops_per_device: float, bytes_per_device: float,
                    coll_bytes_per_device: Optional[float], chips: int,
                    hw: HW = H100, model_flops_total: float = 0.0
                    ) -> Dict[str, Any]:
    """Three roofline terms (seconds) + dominant + usefulness ratio.

    Counts are per device: the global totals over ``chips``.  With
    ``coll_bytes_per_device`` None (not known) the collective term is None
    and the dominant term is taken over compute and memory."""
    t_compute = flops_per_device / hw.peak_flops
    t_memory = bytes_per_device / hw.hbm_bw
    t_coll = (None if coll_bytes_per_device is None
              else coll_bytes_per_device / hw.ici_bw)
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    known = {k: v for k, v in terms.items() if v is not None}
    dominant = max(known, key=known.get)
    bound = max(known.values())
    useful = (model_flops_total / (flops_per_device * chips)
              if flops_per_device else 0.0)
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "bound_s": bound,
        # fraction of the bound the tensor cores would be busy: perfect
        # overlap model
        "compute_fraction_of_bound": (t_compute / bound) if bound else 0.0,
        "model_flops": model_flops_total,
        "hlo_flops_global": flops_per_device * chips,
        "useful_flops_ratio": useful,
        "chips": chips,
        "hw": hw.name,
    }


def fmt_seconds(s: Optional[float]) -> str:
    if s is None:
        return "n/a"
    if s == 0:
        return "0"
    if s < 1e-3:
        return f"{s * 1e6:.1f}us"
    if s < 1:
        return f"{s * 1e3:.2f}ms"
    return f"{s:.2f}s"
