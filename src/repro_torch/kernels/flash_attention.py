"""Causal GQA flash attention, forward and backward, as Hopper kernels.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:flash_attention_pallas``.
The CUDA source is ``csrc/flash_attention.cu`` (its header note gives the
design): the forward kernel streams K/V tiles through shared memory with
the online ``(m, l, acc)`` softmax in fp32 registers and also writes the
row log-sum-exp ``lse``; the backward is FlashAttention-2 style in two
kernels, ``dq`` (which also writes ``delta = rowsum(dO * O)``) and then
``dk, dv`` (one block per key tile sums the GQA group, no atomics).  fp32
inputs run on the CUDA cores; bf16 inputs on the tensor cores, forward
and backward alike with Hopper's ``wgmma``, TMA loads through a ring of
mbarriers and warp specialisation (``sm_90a``; built for head dims 64 and
128, the wrappers zero-pad 16, 32 and 80 and cut the outputs back).  The
TPU kernel has no VJP; the gradient here is the port's own.

Bound on the H100: operations.  Causal forward does two matmuls of
``2 * hd`` flops per visible (q, k) pair, the FlashAttention-2 backward
five (:func:`bound_flops`); bytes (:func:`bound_bytes`) are far below that
at the training shapes.

* :func:`flash_attention_plain` / :func:`flash_attention_plain_bwd` — the
  plain PyTorch versions (materialised fp32 softmax; explicit gradient
  formulas), which the CPU path and the tests use.
* :func:`flash_attention_fwd_cuda`, :func:`flash_attention_bwd_dq_cuda`,
  :func:`flash_attention_bwd_dkv_cuda` — the kernels' wrappers; each adds
  one to its counter (:data:`LAUNCHES_FWD`, :data:`LAUNCHES_BWD_DQ`,
  :data:`LAUNCHES_BWD_DKV`) where it launches its kernel.
* :class:`FlashAttention` (CUDA tensors) and :class:`FlashAttentionPlain`
  (CPU tensors) — ``torch.autograd.Function``s that save ``o`` and ``lse``
  in the forward and run the matching backward.

Layout at every public function, as in the JAX package: q ``(B, S, Hq,
hd)``, k/v ``(B, S, Hkv, hd)``, ``Hq % Hkv == 0`` (q head ``h`` reads KV
head ``h // (Hq // Hkv)``); ``lse`` is ``(B, Hq, S)`` fp32.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

__all__ = ["LAUNCHES_FWD", "LAUNCHES_BWD_DQ", "LAUNCHES_BWD_DKV",
           "SUPPORTED_HD", "BF16_HD", "NEG_INF", "default_scale",
           "flash_attention_plain", "flash_attention_plain_bwd",
           "flash_attention_fwd_cuda", "flash_attention_bwd_dq_cuda",
           "flash_attention_bwd_dkv_cuda", "FlashAttention",
           "FlashAttentionPlain", "bound_flops", "bound_bytes"]

#: Launches of the forward kernel, the dq kernel and the dk/dv kernel.
LAUNCHES_FWD = 0
LAUNCHES_BWD_DQ = 0
LAUNCHES_BWD_DKV = 0

#: Head dims the kernels are built for; :class:`FlashAttention` pads any
#: other head dim with zeros up to the next one (as the TPU wrapper padded
#: to 128 lanes).
SUPPORTED_HD = (16, 32, 64, 80, 128)

#: Head dims the bf16 kernels are built for; the wrappers zero-pad a bf16
#: head dim up to the next one (zeros change neither the dots nor
#: ``delta``) and cut the outputs back.
BF16_HD = (64, 128)

#: The reference's finite mask value (``repro/kernels/ref.py``).
NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: matmuls of 2 * hd flops per visible (q, k) pair, per part.  The
#: backward function needs five; the two backward kernels' shares split
#: them (dq: dO V^T, dS K; dk/dv: QK^T, P^T dO, dS^T Q), so the shares sum
#: to the function's bound.  That each kernel recomputes QK^T (and dO V^T)
#: is a cost of this design, not of the function, and is in no bound.
_MATMULS = {"fwd": 2, "bwd": 5, "bwd_dq": 2, "bwd_dkv": 3}


def default_scale(hd: int) -> float:
    return 1.0 / math.sqrt(hd)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _repeat_kv(x: torch.Tensor, rep: int) -> torch.Tensor:
    return x if rep == 1 else torch.repeat_interleave(x, rep, dim=2)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, scale: float
            ) -> torch.Tensor:
    """fp32 ``(B, Hq, S, S)`` scaled scores, masked with ``NEG_INF``."""
    k = _repeat_kv(k.float(), q.shape[2] // k.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * scale
    if causal:
        n = q.shape[1]
        keep = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, NEG_INF)
    return s


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the forward kernel computes: ``(o in q.dtype, lse (B, Hq, S)
    fp32)`` with ``o = sum_k exp(s - m) v / max(l, 1e-30)`` and ``lse = m +
    log(max(l, 1e-30))``, all in fp32."""
    scale = default_scale(q.shape[-1]) if scale is None else scale
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    lc = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)       # (B, Hq, S, 1)
    v = _repeat_kv(v.float(), q.shape[2] // v.shape[2])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v) / lc.transpose(1, 2)
    lse = (m + torch.log(lc))[..., 0]
    return o.to(q.dtype), lse


def flash_attention_plain_bwd(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = True,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """What the backward kernels compute, by the explicit formulas:
    ``P = exp(s - lse)``, ``dV = P^T dO``, ``dP = dO V^T``, ``delta =
    rowsum(dO * O)``, ``dS = P (dP - delta)``, ``dQ = dS K scale``, ``dK =
    dS^T Q scale``; dK and dV summed over each KV head's q heads.  Returns
    ``(dq, dk, dv)`` in the inputs' dtypes."""
    scale = default_scale(q.shape[-1]) if scale is None else scale
    b, n, hq, hd = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    do32 = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, _repeat_kv(v.float(), rep))
    delta = (do32 * o.float()).sum(dim=-1).transpose(1, 2)   # (B, Hq, S)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _repeat_kv(k.float(), rep))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dk = dk.reshape(b, n, hkv, rep, hd).sum(dim=3)
    dv = dv.reshape(b, n, hkv, rep, hd).sum(dim=3)
    return ((dq * scale).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype))


# ---------------------------------------------------------------------------
# Bounds
# ---------------------------------------------------------------------------

def _pairs(b: int, s: int, hq: int, causal: bool) -> int:
    return b * hq * (s * (s + 1) // 2 if causal else s * s)


def bound_flops(b: int, s: int, hq: int, hd: int, causal: bool = True,
                part: str = "fwd") -> int:
    """Flops the function needs: ``part`` is ``fwd`` (QK^T, PV), ``bwd``
    (the five FlashAttention-2 matmuls), or one backward kernel's share of
    those five: ``bwd_dq`` (dO V^T, dS K) or ``bwd_dkv`` (QK^T, P^T dO,
    dS^T Q).  Each matmul is ``2 * hd`` flops per visible (q, k) pair."""
    return _MATMULS[part] * 2 * hd * _pairs(b, s, hq, causal)


def bound_bytes(b: int, s: int, hq: int, hkv: int, hd: int,
                dtype: torch.dtype, part: str = "fwd") -> int:
    """Bytes the function must move, each input read once and each output
    written once: ``fwd`` reads q, k, v and writes o and lse; ``bwd`` reads
    q, k, v, o, dO, lse and writes dq, dk, dv.  The backward kernels'
    shares split ``bwd``: ``bwd_dq`` q, o, dO, lse and dq; ``bwd_dkv`` k, v,
    dk and dv."""
    e = torch.empty((), dtype=dtype).element_size()
    qn, kn, st = b * s * hq * hd, b * s * hkv * hd, b * hq * s * 4
    parts = {
        "fwd": e * (2 * qn + 2 * kn) + st,
        "bwd_dq": e * 4 * qn + st,
        "bwd_dkv": e * 4 * kn,
        "bwd": e * (4 * qn + 4 * kn) + st,
    }
    return parts[part]


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_ARGTYPES = {
    "flash_attention_fwd": 5,
    "flash_attention_bwd_dq": 8,
    "flash_attention_bwd_dkv": 8,
}


def _fn(name: str):
    fn = getattr(_build.load("flash_attention"), name)
    fn.argtypes = ([ctypes.c_void_p] * _ARGTYPES[name] +
                   [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           **same_as_q: torch.Tensor) -> int:
    """Validate what every kernel takes; returns the dtype code."""
    tensors = {"q": q, "k": k, "v": v, **same_as_q}
    for tname, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} needs CUDA tensors, got {tname} on "
                             f"{t.device}")
        if t.device != q.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} needs contiguous 16-byte aligned "
                             f"tensors; {tname} has strides {t.stride()}")
    code = _DTYPE_CODES.get(q.dtype)
    if code is None or any(t.dtype != q.dtype for t in tensors.values()):
        raise ValueError(f"{name} takes fp32 or bf16 q, k, v of one dtype, "
                         f"got {[str(t.dtype) for t in tensors.values()]}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name} needs q (B, S, Hq, hd) and k, v (B, S, "
                         f"Hkv, hd), got {tuple(q.shape)}, {tuple(k.shape)},"
                         f" {tuple(v.shape)}")
    b, s, hq, hd = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, hd) or \
            k.shape[2] < 1 or hq % k.shape[2] or s < 1:
        raise ValueError(f"{name}: k/v shape {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)} (Hq % Hkv must be 0)")
    if hd not in SUPPORTED_HD:
        raise ValueError(f"{name} is built for head dims {SUPPORTED_HD}, "
                         f"got {hd} (FlashAttention pads to the next one)")
    for tname, t in same_as_q.items():
        if t.shape != q.shape:
            raise ValueError(f"{name}: {tname} shape {tuple(t.shape)} != q "
                             f"{tuple(q.shape)}")
    return code


def _check_stat(name: str, what: str, t: torch.Tensor, q: torch.Tensor
                ) -> None:
    b, s, hq, _ = q.shape
    if (t.dtype != torch.float32 or tuple(t.shape) != (b, hq, s)
            or not t.is_contiguous() or t.device != q.device):
        raise ValueError(f"{name} needs {what} as a contiguous fp32 "
                         f"{(b, hq, s)} tensor on {q.device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _launch(name: str, ptrs, q: torch.Tensor, k: torch.Tensor, causal: bool,
            scale: float, code: int) -> None:
    b, s, hq, hd = q.shape
    fn = _fn(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*[t.data_ptr() for t in ptrs], b, s, hq, k.shape[2], hd,
                 float(scale), int(bool(causal)), code, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel; returns ``(o, lse)``.  Raises on what the
    kernel does not take (device, dtype, shape, contiguity, head dim) and
    when the launch is refused."""
    global LAUNCHES_FWD
    name = "flash_attention_fwd"
    code = _check(name, q, k, v)
    hd = q.shape[-1]
    scale = default_scale(hd) if scale is None else scale
    q, k, v = _pad_bf16(q, k, v)
    o = torch.empty_like(q)
    b, s, hq, _ = q.shape
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    _launch(name, (q, k, v, o, lse), q, k, causal, scale, code)
    LAUNCHES_FWD += 1
    return _unpad(o, hd), lse


def flash_attention_bwd_dq_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, o: torch.Tensor,
                                lse: torch.Tensor, do: torch.Tensor,
                                causal: bool = True,
                                scale: Optional[float] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dq kernel; returns ``(dq, delta)`` with ``delta =
    rowsum(do * o)`` (fp32, ``(B, Hq, S)``) for the dk/dv kernel."""
    global LAUNCHES_BWD_DQ
    name = "flash_attention_bwd_dq"
    code = _check(name, q, k, v, o=o, do=do)
    _check_stat(name, "lse", lse, q)
    hd = q.shape[-1]
    scale = default_scale(hd) if scale is None else scale
    q, k, v, o, do = _pad_bf16(q, k, v, o, do)
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    _launch(name, (q, k, v, o, do, lse, delta, dq), q, k, causal, scale,
            code)
    LAUNCHES_BWD_DQ += 1
    return _unpad(dq, hd), delta


def flash_attention_bwd_dkv_cuda(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, lse: torch.Tensor,
                                 delta: torch.Tensor, do: torch.Tensor,
                                 causal: bool = True,
                                 scale: Optional[float] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel (after the dq kernel, which made
    ``delta``); returns ``(dk, dv)``."""
    global LAUNCHES_BWD_DKV
    name = "flash_attention_bwd_dkv"
    code = _check(name, q, k, v, do=do)
    _check_stat(name, "lse", lse, q)
    _check_stat(name, "delta", delta, q)
    hd = q.shape[-1]
    scale = default_scale(hd) if scale is None else scale
    q, k, v, do = _pad_bf16(q, k, v, do)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch(name, (q, k, v, do, lse, delta, dk, dv), q, k, causal, scale,
            code)
    LAUNCHES_BWD_DKV += 1
    return _unpad(dk, hd), _unpad(dv, hd)


def _pad_hd(t: torch.Tensor, sizes=SUPPORTED_HD) -> torch.Tensor:
    """Zero-pad the head dim up to the next of ``sizes`` (a no-op at a
    size itself; zeros add nothing to the dots)."""
    hd = t.shape[-1]
    to = next((h for h in sizes if h >= hd), None)
    if to is None:
        raise ValueError(f"flash attention takes head dims up to "
                         f"{sizes[-1]}, got {hd}")
    return t if to == hd else F.pad(t, (0, to - hd))


def _pad_bf16(*ts: torch.Tensor):
    """bf16 tensors padded to a head dim of :data:`BF16_HD`, what the bf16
    kernels take; fp32 tensors as they are."""
    if ts[0].dtype != torch.bfloat16:
        return ts
    return tuple(_pad_hd(t, BF16_HD) for t in ts)


def _unpad(t: torch.Tensor, hd: int) -> torch.Tensor:
    return t if t.shape[-1] == hd else t[..., :hd].contiguous()


class FlashAttention(torch.autograd.Function):
    """Flash attention on CUDA tensors: the forward kernel, and the dq and
    dk/dv kernels in the backward.  ``apply(q, k, v, causal, scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        hd = q.shape[-1]
        # the scale of the head dim the caller gave, not of the padded one
        scale = default_scale(hd) if scale is None else scale
        qp, kp, vp = (_pad_hd(t.contiguous()) for t in (q, k, v))
        o, lse = flash_attention_fwd_cuda(qp, kp, vp, causal, scale)
        ctx.save_for_backward(qp, kp, vp, o, lse)
        ctx.causal, ctx.scale, ctx.hd = causal, scale, hd
        return o if o.shape[-1] == hd else o[..., :hd]

    @staticmethod
    def backward(ctx, do):
        qp, kp, vp, o, lse = ctx.saved_tensors
        do = _pad_hd(do.contiguous())
        dq, delta = flash_attention_bwd_dq_cuda(qp, kp, vp, o, lse, do,
                                                ctx.causal, ctx.scale)
        dk, dv = flash_attention_bwd_dkv_cuda(qp, kp, vp, lse, delta, do,
                                              ctx.causal, ctx.scale)
        hd = ctx.hd
        return dq[..., :hd], dk[..., :hd], dv[..., :hd], None, None


class FlashAttentionPlain(torch.autograd.Function):
    """The same function on CPU tensors: :func:`flash_attention_plain`
    forward, :func:`flash_attention_plain_bwd` backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_plain(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_plain_bwd(q, k, v, o, lse, do,
                                               ctx.causal, ctx.scale)
        return dq, dk, dv, None, None
