"""Fused N-operand reduction: the radix-4 page combine, as a Hopper kernel.

Replaces the TPU kernel ``repro/kernels/moa_reduce.py:moa_reduce_pallas``.
The CUDA source is ``csrc/moa_reduce.cu`` (its header note gives the
design): the ``make_reduction_plan(N)`` tree is the complete 4-ary tree over
the operands padded with zeros, so its 4^s aligned subtrees just below the
top s levels (:func:`split_levels`) go to 4^s adjacent lanes, which own the
same output columns (four when the layout allows 16-byte loads).  Each lane
reduces its subtree with its level-0 loads in flight together, and the top
s levels combine through warp shuffles as ``(a + b) + (c + d)``, so the
kernel equals :func:`moa_reduce_plain` bit for bit in fp32 and int32.

Bound on the H100: bytes.  A call moves ``(N * in_bytes + out_bytes) * M``
bytes, so its least time is that over 3.35 TB/s (:func:`bound_bytes`).  At
the decode shapes of the serve path (N = 16 pages, M = 96 or 12288) that is
far below the cost of a launch, so the kernel is launch-bound there;
fusing the combine into the split-K attention is the later fix.

* :func:`radix4_tree_sum` / :func:`moa_reduce_plain` — the plain PyTorch
  version, which the CPU path and the tests use.
* :func:`moa_reduce_cuda` — the kernel's wrapper; it adds one to
  :data:`LAUNCHES` each time it launches the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.dist import plan as dist_plan
from repro_torch.kernels import _build

__all__ = ["LAUNCHES", "MAX_OPERANDS", "radix4_tree_sum", "moa_reduce_plain",
           "moa_reduce_cuda", "bound_bytes", "split_levels"]

#: Number of times :func:`moa_reduce_cuda` has launched the kernel.
LAUNCHES = 0

#: The kernel keeps 8 tree levels in registers: N <= 4^8.
MAX_OPERANDS = 4 ** 8

#: (input dtype, accumulator dtype) -> the C interface's dtype code.
_DTYPE_CODES = {
    (torch.float32, torch.float32): 0,
    (torch.bfloat16, torch.float32): 1,
    (torch.int32, torch.int32): 2,
}


def radix4_tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Radix-4 tree reduction over axis 0 (the §7 tree, level by level).

    Levels (padding + grouping) come from the shared
    ``make_reduction_plan(N)``; each group of four becomes
    ``(a + b) + (c + d)``, zero padding included.  The port of
    ``repro/kernels/moa_reduce.py:radix4_tree_sum``."""
    for level in dist_plan.make_reduction_plan(x.shape[0]).levels:
        if level.pad:
            pad = torch.zeros((level.pad,) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            x = torch.cat([x, pad], dim=0)
        g = x.reshape((level.groups, 4) + tuple(x.shape[1:]))
        x = (g[:, 0] + g[:, 1]) + (g[:, 2] + g[:, 3])
    return x[0]


def moa_reduce_plain(x: torch.Tensor, acc_dtype: torch.dtype = torch.float32,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Sum over axis 0 in ``acc_dtype`` through the radix-4 tree, cast to
    ``out_dtype`` (default: the input dtype) — what the kernel computes."""
    out_dtype = out_dtype or x.dtype
    return radix4_tree_sum(x.to(acc_dtype)).to(out_dtype)


def bound_bytes(n: int, m: int, in_dtype: torch.dtype,
                acc_dtype: torch.dtype) -> int:
    """Bytes the reduction must move: every operand read once, every
    output (in the accumulator dtype) written once."""
    in_b = torch.empty((), dtype=in_dtype).element_size()
    out_b = torch.empty((), dtype=acc_dtype).element_size()
    return (n * in_b + out_b) * m


def split_levels(n: int) -> int:
    """s, the top tree levels the kernel combines across lanes for ``n``
    operands: 0 for N <= 4, 1 for N <= 64, else 2.  Each of the 4^s lanes
    of a column then reduces a subtree of at least one whole level-0
    group (4^(L - s) >= 4 operand slots, L the plan's level count)."""
    return 0 if n <= 4 else 1 if n <= 64 else 2


def moa_reduce_cuda(x: torch.Tensor, acc_dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """Launch the kernel on a contiguous ``(N, M)`` CUDA tensor; returns
    the ``(M,)`` sums in ``acc_dtype``.  Raises on what the kernel does not
    take (device, dtype pair, rank, contiguity, N out of range) and when
    the launch is refused."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"moa_reduce_cuda needs a CUDA tensor, got {x.device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"moa_reduce_cuda needs a contiguous (N, M) tensor, "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")
    code = _DTYPE_CODES.get((x.dtype, acc_dtype))
    if code is None:
        raise ValueError(f"moa_reduce_cuda takes (input, accumulator) dtypes "
                         f"{sorted(map(str, _DTYPE_CODES))}, got "
                         f"({x.dtype}, {acc_dtype})")
    n, m = x.shape
    if not 1 <= n <= MAX_OPERANDS:
        raise ValueError(f"moa_reduce_cuda reduces 1..{MAX_OPERANDS} "
                         f"operands, got {n}")
    out = torch.empty((m,), dtype=acc_dtype, device=x.device)
    if m == 0:
        return out
    lib = _build.load("moa_reduce")
    fn = lib.moa_reduce_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), n, m, code, split_levels(n),
                 stream)
    if err:
        raise RuntimeError(f"moa_reduce kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
