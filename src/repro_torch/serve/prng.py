"""The parts of JAX's threefry PRNG that token sampling draws from.

The JAX serve engine samples slot ``b``'s token with
``jax.random.categorical(fold_in(PRNGKey(seed), idx), logits)``.  To give
the same tokens, the port computes the same bits: this module follows the
installed jax's threefry path (``jax_threefry_partitionable`` on, as jax
0.9 sets it) for 32-bit draws —

* :func:`threefry_2x32`: the Threefry-2x32 block cipher, 20 rounds with
  rotations ``(13, 15, 26, 6)`` and ``(17, 29, 16, 24)`` and a key
  injection every 4 rounds (the third key word ``k1 ^ k2 ^ 0x1BD11BDA``);
* :func:`prng_key` (``threefry_seed``): the key ``(seed >> 32, seed &
  0xFFFFFFFF)`` of a 32-bit seed, i.e. ``(0, seed)`` as uint32 words;
* :func:`fold_in`: ``threefry_2x32(key, (0, data))``;
* :func:`random_bits`: the partitionable 32-bit draw, whose counters are
  the 64-bit flat index split into (hi, lo) words and whose bits are the
  two cipher outputs XORed;
* :func:`uniform`, :func:`gumbel` and :func:`categorical` on top, as in
  ``jax.random``: mantissa bits under exponent 0 minus one, scaled to
  ``[minval, 1)``; ``-log(-log(u))`` at ``minval = tiny``; the Gumbel
  argmax.

Everything is batched over rows: a key is a pair of ``(R,)`` tensors, one
key per row, and a draw of ``(R, V)`` is one pass.  torch has no ``add``
for ``uint32``, so the words live in int64 tensors with values in
``[0, 2**32)``; a word is masked back to 32 bits wherever its high bits
could reach the low ones (before a right shift, and at the end).

The integer part is bit-exact with JAX.  The float part after the
uniforms (``log``) is torch's, which can differ from XLA's by an ulp; the
sampled tokens agree unless two candidates' noisy logits tie that
closely.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

__all__ = ["threefry_2x32", "prng_key", "fold_in", "random_bits",
           "uniform", "gumbel", "categorical", "Key"]

#: a batch of threefry keys: the two uint32 words, each an int64 tensor
Key = Tuple[torch.Tensor, torch.Tensor]

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_ONE_BITS = 0x3F800000
_F32_TINY = torch.finfo(torch.float32).tiny


def threefry_2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                  x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter words ``(x1, x2)`` under the key
    ``(k1, k2)``: int64 tensors holding uint32 values, broadcast against
    each other.  Returns the two output words (int64, in ``[0, 2**32)``)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    # x0 is masked only at the end: its low 32 bits depend only on the low
    # bits of what it adds, and 20 rounds of adding < 2**32 stay far below
    # 2**63.  x1 feeds a right shift, so it is kept masked.
    x0 = x1 + ks[0]
    x1 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & _MASK
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + (ks[(i + 2) % 3] + (i + 1))) & _MASK
    return x0 & _MASK, x1


def prng_key(seed: Union[int, torch.Tensor]) -> Key:
    """``jax.random.PRNGKey(seed)`` of 32-bit seeds (a Python int or an
    ``(R,)`` integer tensor, one key per entry, on its device): the words
    ``(0, seed & 0xFFFFFFFF)``."""
    s = torch.as_tensor(seed, dtype=torch.int64)
    return torch.zeros_like(s), s & _MASK


def fold_in(key: Key, data: Union[int, torch.Tensor]) -> Key:
    """``jax.random.fold_in(key, data)`` for 32-bit ``data`` (an int or a
    tensor broadcast against the key words): the cipher of the counter
    words ``(0, data)``."""
    k1, k2 = key
    d = torch.as_tensor(data, dtype=torch.int64, device=k1.device) & _MASK
    return threefry_2x32(k1, k2, torch.zeros_like(d), d)


def random_bits(key: Key, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for each key of the batch:
    an ``(R, n)`` int64 tensor of uint32 values (``(n,)`` for a key of
    0-d words).  The counters of element ``i`` are ``(i >> 32, i &
    0xFFFFFFFF)``."""
    k1, k2 = key
    idx = torch.arange(n, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry_2x32(k1[..., None], k2[..., None], idx >> 32,
                           idx & _MASK)
    return b1 ^ b2


def uniform(key: Key, n: int, minval: float = 0.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, 1.0)`` per key:
    the top 23 bits of each draw as the mantissa of a float in [1, 2),
    minus 1, scaled to ``[minval, 1)`` and floored at ``minval``."""
    bits = random_bits(key, n)
    f = ((bits >> 9) | _F32_ONE_BITS).to(torch.int32).view(torch.float32)
    # the bounds as fp32 values, taken on the host (no copy to the device)
    lo = torch.tensor(minval, dtype=torch.float32)
    span = float(torch.tensor(1.0, dtype=torch.float32) - lo)
    lo = float(lo)
    return torch.clamp((f - 1.0) * span + lo, min=lo)


def gumbel(key: Key, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` per key, in its default
    ``"low"`` mode: ``-log(-log(u))`` with ``u`` uniform on ``[tiny,
    1)``."""
    return -torch.log(-torch.log(uniform(key, n, _F32_TINY)))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis, one key
    per row of ``logits`` (``(R, V)``): the argmax of Gumbel noise plus the
    logits (the first index on ties).  Returns ``(R,)`` int64."""
    g = gumbel(key, logits.shape[-1])
    return torch.argmax(g + logits, dim=-1)
