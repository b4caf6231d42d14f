"""Exact int8 x int8 -> int32 matmul with Theorem-planned K blocks, as a
Hopper kernel.

Replaces the TPU kernel ``repro/kernels/quant_matmul.py:quant_matmul_pallas``.
The CUDA source is ``csrc/quant_matmul.cu`` (its header note gives the
design): 128 x 128 output tiles on the tensor cores (``mma.sync`` m16n8k32
s8.s8.s32), K walked in the blocks of
``plan_dot_accumulation(K, 8, 8, acc_bits, align=128)``, each block summed
in its own int32 registers and the block partials added in int32.

Bound on the H100: operations.  ``2 M K N`` int8 operations over 1,979
TOP/s (:func:`bound_ops`); the bytes (:func:`bound_bytes`) over 3.35 TB/s
take about half as long at the training projection shapes.

* :func:`quant_matmul_plain` — the plain PyTorch version: the same K
  blocks, each an exact float64 product (integer matmul does not exist on
  CUDA; |sum| <= K * 2^14 < 2^53), added in int32.  The CPU path and the
  tests use it.
* :func:`quant_matmul_cuda` — the kernel's wrapper; it adds one to
  :data:`LAUNCHES` each time it launches the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.accum import AccumPlan, plan_dot_accumulation
from repro_torch.kernels import _build

__all__ = ["LAUNCHES", "k_plan", "quant_matmul_plain", "quant_matmul_cuda",
           "bound_bytes", "bound_ops"]

#: Number of times :func:`quant_matmul_cuda` has launched the kernel.
LAUNCHES = 0


def k_plan(k: int, acc_bits: int = 32) -> AccumPlan:
    """The K blocking of ``quant_matmul_pallas``; the block walked is
    ``min(plan.block, k)``."""
    return plan_dot_accumulation(k, lhs_bits=8, rhs_bits=8,
                                 acc_bits=acc_bits, align=128)


def _check_shapes(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"quant_matmul needs x (M, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")


def quant_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                       acc_bits: int = 32) -> torch.Tensor:
    """``x @ w`` of int8 operands as int32, block by block of the plan."""
    _check_shapes(x, w)
    k = x.shape[1]
    out = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.int32,
                      device=x.device)
    if k == 0:
        return out
    bk = min(k_plan(k, acc_bits).block, k)
    for k0 in range(0, k, bk):
        part = (x[:, k0:k0 + bk].to(torch.float64) @
                w[k0:k0 + bk].to(torch.float64))
        out += part.to(torch.int32)
    return out


def bound_bytes(m: int, k: int, n: int) -> int:
    """Bytes the product must move: x and w (int8) read once, the int32
    result written once."""
    return m * k + k * n + 4 * m * n


def bound_ops(m: int, k: int, n: int) -> int:
    """int8 operations of the product: a multiply and an add per term."""
    return 2 * m * k * n


def quant_matmul_cuda(x: torch.Tensor, w: torch.Tensor,
                      acc_bits: int = 32) -> torch.Tensor:
    """Launch the kernel on int8 CUDA tensors x ``(M, K)`` and w ``(K, N)``
    (contiguous); returns the ``(M, N)`` int32 product.  w is copied to the
    K-major layout the kernel reads, inside this call.  Raises on what the
    kernel does not take and when the launch is refused."""
    global LAUNCHES
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"quant_matmul_cuda needs CUDA tensors on one "
                         f"device, got {x.device} and {w.device}")
    _check_shapes(x, w)
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"quant_matmul_cuda takes int8 operands, got "
                         f"{x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("quant_matmul_cuda needs contiguous operands")
    (m, k), n = x.shape, w.shape[1]
    if m > 65535 * 128:
        raise ValueError(f"quant_matmul_cuda takes M <= {65535 * 128}, "
                         f"got {m}")
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    bk = min(k_plan(k, acc_bits).block, k)
    wt = w.t().contiguous()
    fn = _build.load("quant_matmul").quant_matmul_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), wt.data_ptr(), out.data_ptr(), m, n, k, bk,
                 stream)
    if err:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out
