"""Exact int8 x int8 -> int32 matmul with Theorem-planned K blocks, as
Hopper kernels.

Replaces the TPU kernel ``repro/kernels/quant_matmul.py:quant_matmul_pallas``.
The CUDA source is ``csrc/quant_matmul.cu`` (its header note gives the
design).  :func:`route` picks the kernels of a call from its shape and
alignment alone, before any launch:

* ``"wgmma"`` (K and N multiples of 16, both bases 16-byte aligned, so TMA
  can describe x and w): one launch of ``qmm_wgmma``, int8 ``wgmma`` fed by
  a TMA ring, with the operands swapped (``outᵀ = wᵀ xᵀ``) so that w is read
  in the row-major layout the caller gives: no copy of w.  One accumulator
  over all of K; the source note shows it equals the sum of the
  ``plan_dot_accumulation(K, 8, 8, acc_bits, align=128)`` block partials
  added in int32.
* ``"mma_sync"`` (every other shape): the pre-pass ``qmm_transpose`` writes
  w K-major, then ``qmm_mma_sync`` (``mma.sync`` m16n8k32) walks K in the
  plan's blocks.

Bound on the H100: operations.  ``2 M K N`` int8 operations over 1,979
TOP/s (:func:`bound_ops`); the bytes (:func:`bound_bytes`) over 3.35 TB/s
take about half as long at the training projection shapes.

* :func:`quant_matmul_plain` — the plain PyTorch version: the same K
  blocks, each an exact float64 product (integer matmul does not exist on
  CUDA; |sum| <= K * 2^14 < 2^53), added in int32.  The CPU path and the
  tests use it.
* :func:`quant_matmul_cuda` — the wrapper.  :data:`LAUNCHES` counts
  product launches, one a call; :data:`WGMMA_LAUNCHES` and
  :data:`MMA_SYNC_LAUNCHES` each route's, :data:`TRANSPOSE_LAUNCHES` the
  pre-pass's.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.accum import AccumPlan, plan_dot_accumulation
from repro_torch.kernels import _build

__all__ = ["LAUNCHES", "WGMMA_LAUNCHES", "MMA_SYNC_LAUNCHES",
           "TRANSPOSE_LAUNCHES", "k_plan", "route", "quant_matmul_plain",
           "wgmma_cuda", "transpose_w_cuda", "mma_sync_cuda",
           "quant_matmul_cuda", "bound_bytes", "bound_ops"]

#: Launches of a product kernel (either route).
LAUNCHES = 0
#: Launches of ``qmm_wgmma`` by :func:`wgmma_cuda` and of ``qmm_mma_sync``
#: by :func:`mma_sync_cuda`.
WGMMA_LAUNCHES = 0
MMA_SYNC_LAUNCHES = 0
#: Launches of the pre-pass ``qmm_transpose`` by :func:`transpose_w_cuda`.
TRANSPOSE_LAUNCHES = 0


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


def route(k: int, n: int, x_ptr: int, w_ptr: int) -> str:
    """The kernels a call of depth ``k`` and width ``n`` takes, by shape and
    alignment alone: ``"wgmma"`` when TMA can describe x ``(M, K)`` and w
    ``(K, N)`` (rows of a multiple of 16 bytes, 16-byte-aligned bases),
    else ``"mma_sync"``."""
    if k % 16 == 0 and n % 16 == 0 and x_ptr % 16 == 0 and w_ptr % 16 == 0:
        return "wgmma"
    return "mma_sync"


def _launch(name: str, argtypes, *args) -> None:
    """Call ``csrc/quant_matmul.cu``'s ``name`` on the current stream of
    the device of the first tensor argument; raise if the launch failed."""
    fn = getattr(_build.load("quant_matmul"), name)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    device = args[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args), stream)
    if err:
        raise RuntimeError(f"quant_matmul: {name} failed: CUDA error {err}")


_P, _L = ctypes.c_void_p, ctypes.c_longlong


def wgmma_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (M, K) @ w (K, N)`` as int32 by ``qmm_wgmma`` (the ``"wgmma"``
    route: K and N multiples of 16, aligned bases); one launch, counted in
    :data:`LAUNCHES` and :data:`WGMMA_LAUNCHES`."""
    global LAUNCHES, WGMMA_LAUNCHES
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    _launch("quant_matmul_wgmma_launch", [_P, _P, _P, _L, _L, _L],
            x, w, out, m, n, k)
    LAUNCHES += 1
    WGMMA_LAUNCHES += 1
    return out


def transpose_w_cuda(w: torch.Tensor) -> torch.Tensor:
    """The ``"mma_sync"`` route's pre-pass: w ``(K, N)`` int8 on the card ->
    wt ``(N, ldt)``, ``ldt`` = K rounded up to 16, zeros past K; one
    ``qmm_transpose`` launch, counted in :data:`TRANSPOSE_LAUNCHES`."""
    global TRANSPOSE_LAUNCHES
    k, n = w.shape
    if n > 65535 * 64:
        raise ValueError(f"qmm_transpose takes N <= {65535 * 64}, got {n}")
    ldt = -(-k // 16) * 16
    wt = torch.empty((n, ldt), dtype=torch.int8, device=w.device)
    _launch("quant_matmul_transpose_launch", [_P, _P, _L, _L, _L],
            w, wt, k, n, ldt)
    TRANSPOSE_LAUNCHES += 1
    return wt


def mma_sync_cuda(x: torch.Tensor, wt: torch.Tensor, k: int,
                  bk: int) -> torch.Tensor:
    """``x (M, K) @ wt[:, :K]ᵀ`` as int32 by ``qmm_mma_sync``, walking K in
    blocks of ``bk``; one launch, counted in :data:`LAUNCHES` and
    :data:`MMA_SYNC_LAUNCHES`."""
    global LAUNCHES, MMA_SYNC_LAUNCHES
    (m, _), (n, ldw) = x.shape, wt.shape
    if m > 65535 * 128:
        raise ValueError(f"qmm_mma_sync takes M <= {65535 * 128}, got {m}")
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    _launch("quant_matmul_mma_sync_launch", [_P, _P, _L, _P, _L, _L, _L, _L],
            x, wt, ldw, out, m, n, k, bk)
    LAUNCHES += 1
    MMA_SYNC_LAUNCHES += 1
    return out


def quant_matmul_cuda(x: torch.Tensor, w: torch.Tensor,
                      acc_bits: int = 32) -> torch.Tensor:
    """Launch the kernels of :func:`route` on int8 CUDA tensors x ``(M, K)``
    and w ``(K, N)`` (contiguous, w row-major as the caller gives it);
    returns the ``(M, N)`` int32 product.  Raises on what the kernels do not
    take and when a launch is refused."""
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
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=torch.int32, device=x.device)
    if k == 0:
        return torch.zeros((m, n), dtype=torch.int32, device=x.device)
    if route(k, n, x.data_ptr(), w.data_ptr()) == "wgmma":
        return wgmma_cuda(x, w)
    bk = min(k_plan(k, acc_bits).block, k)
    return mma_sync_cuda(x, transpose_w_cuda(w), k, bk)
