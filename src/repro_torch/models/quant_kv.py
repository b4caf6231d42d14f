"""Symmetric quantization primitives for KV pages (and per-tensor int8).

The counterpart of ``repro/models/quant_kv.py`` on tensors:

* per-tensor int8 with a shared scale (:func:`quantize_int8` /
  :func:`dequantize_int8`);
* per-row symmetric int8/int4 codes with an fp32 scale per (token, head)
  row (:func:`quantize_rows` / :func:`dequantize_rows`), the element type
  of a quantized KV page pool.  int4 codes are packed two per byte
  (:func:`pack_int4` / :func:`unpack_int4`); the code dtype is the bit
  tag (``int8`` -> 8-bit, ``uint8`` -> packed 4-bit, :func:`kv_bits`).

Rounding is ``torch.round``, half to even like ``jnp.round``, so the same
fp32 rows give the same codes and scales.  The nibble arithmetic runs in
int16 and is cast to ``uint8`` only once it is in range.

Whether ``page_size`` quantized rows sum exactly in an int32 carrier is
the paper's carry math: :func:`kv_carry_budget` is ``carry_budget(N =
page_size, M = bits, k = 2)`` and :func:`assert_kv_accumulator` raises at
engine build when the exact width plus a sign bit does not fit.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.core.carry import CarryBudget, carry_budget

__all__ = [
    "KV_DTYPES", "quantize_int8", "dequantize_int8",
    "quantize_rows", "dequantize_rows", "pack_int4", "unpack_int4",
    "kv_bits", "kv_carry_budget", "assert_kv_accumulator",
]

#: Engine-facing names for the KV page element type ("fp32" is the
#: unquantized pool, in the model's own dtype).
KV_DTYPES = ("fp32", "int8", "int4")

#: Smallest scale: an all-zero row quantizes to zero codes with this
#: scale, so dequantization gives exact zeros.
_SCALE_FLOOR = 1e-12


def quantize_int8(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8 with a shared (pre-agreed) scale."""
    q = torch.round(g.float() / scale)
    return torch.clamp(q, -127, 127).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` (fp32 output)."""
    return q.float() * scale


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int8 codes in [-8, 7] two per byte along the last axis:
    ``(..., D)`` -> ``(..., D // 2)`` uint8, element ``i`` holding code
    ``2i`` in the low nibble and ``2i + 1`` in the high one, each offset
    by 8.  Raises for an odd ``D``."""
    if q.shape[-1] % 2:
        raise ValueError(f"pack_int4 needs an even last axis, "
                         f"got {q.shape[-1]}")
    lo = q[..., 0::2].to(torch.int16) + 8
    hi = q[..., 1::2].to(torch.int16) + 8
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4(u: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: ``(..., D/2)`` uint8 -> ``(..., D)``
    int8 codes in [-8, 7]."""
    w = u.to(torch.int16)
    lo = (w & 0x0F) - 8
    hi = (w >> 4) - 8
    out = torch.stack([lo, hi], dim=-1).to(torch.int8)
    return out.reshape(u.shape[:-1] + (u.shape[-1] * 2,))


def kv_bits(codes: Union[torch.Tensor, torch.dtype]) -> int:
    """Bit width a KV code tensor's dtype encodes: ``int8`` -> 8,
    ``uint8`` (two packed nibbles) -> 4."""
    dt = codes.dtype if isinstance(codes, torch.Tensor) else codes
    if dt == torch.int8:
        return 8
    if dt == torch.uint8:
        return 4
    raise ValueError(f"not a KV code dtype: {dt} (expected int8 or uint8)")


def quantize_rows(x: torch.Tensor, bits: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric quantization over the last axis: each row gets
    the fp32 scale ``max(amax(|row|) / qmax, 1e-12)``, so rows can be
    written into a quantized pool one at a time.  ``bits`` 8 gives int8
    codes in [-127, 127]; 4 gives codes in [-7, 7] packed two per byte
    (``D`` even).  Returns ``(codes, scale)``: codes ``(..., D)`` int8 or
    ``(..., D // 2)`` uint8, scale ``(...,)`` fp32."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    qmax = 127 if bits == 8 else 7
    x32 = x.float()
    amax = torch.amax(torch.abs(x32), dim=-1)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, which is an ulp off the CPU's (and XLA's) division
    scale = torch.clamp(amax / torch.full_like(amax, qmax),
                        min=_SCALE_FLOOR)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -qmax, qmax)
    q = q.to(torch.int8)
    return (pack_int4(q) if bits == 4 else q), scale


def dequantize_rows(codes: torch.Tensor, scale: torch.Tensor,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` (the bit width read off
    ``codes.dtype``): ``codes * scale`` in fp32, cast to ``out_dtype``."""
    if kv_bits(codes) == 4:
        codes = unpack_int4(codes)
    out = codes.float() * scale[..., None].float()
    return out.to(out_dtype)


def kv_carry_budget(page_size: int, bits: int) -> CarryBudget:
    """The paper's exact width plan for summing one page's quantized rows:
    ``carry_budget(N=page_size, M=bits, k=2)``."""
    return carry_budget(page_size, bits, 2)


def assert_kv_accumulator(page_size: int, bits: int,
                          acc_bits: int = 32) -> CarryBudget:
    """Build-time audit that a page-wide sum of quantized magnitudes fits
    the integer carrier: ``result_digits`` magnitude bits plus a sign bit
    must not exceed ``acc_bits``.  Raises ``ValueError`` otherwise;
    returns the :class:`CarryBudget`."""
    b = kv_carry_budget(page_size, bits)
    need = b.result_digits + 1
    if need > acc_bits:
        raise ValueError(
            f"page_size={page_size} x int{bits} rows need {need} "
            f"accumulator bits ({b.result_digits} magnitude + sign), which "
            f"overflows the int{acc_bits} carrier — shrink the page size")
    return b
