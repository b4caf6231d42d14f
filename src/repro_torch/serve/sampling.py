"""Token sampling (counterpart of ``repro/serve/sampling.py``).

The engine passes every slot's sampling knobs as ``(B,)`` lanes
(temperature, top-k, top-p, seed, sample index) beside the ``(B, V)``
logits, and :func:`sample_tokens` returns one token per row on the
logits' device, in one pass over the batch.  Randomness is stateless:
each draw keys off ``fold_in(PRNGKey(seed), sample_index)``
(:mod:`repro_torch.serve.prng`, threefry as in the JAX package), so a
request's stream is a function of ``(seed, index)`` and the logits only:
the same across engine restarts, slots, preemption and batch makeup.

``temperature == 0`` is the greedy path, exactly ``argmax(logits)``
(:func:`greedy_tokens`); the engine calls that alone when every live lane
is greedy, since the sampled branch would be discarded anyway.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

import torch

from repro_torch.serve import prng

__all__ = ["SamplingParams", "GREEDY", "greedy_tokens", "sampling_lanes",
           "sample_tokens"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration (host-side, hashable).

    Args:
      temperature: softmax temperature; ``0`` selects greedy decoding
        (exact ``argmax``, the default).
      top_k: keep only the ``top_k`` highest-logit tokens before sampling;
        ``0`` (or ``>= vocab``) disables the truncation.
      top_p: nucleus truncation: keep the smallest set of tokens whose
        cumulative probability reaches ``top_p``; ``1.0`` disables it.
      seed: per-request PRNG seed (a 32-bit integer); with the running
        sample index it determines the request's draws.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 <= self.top_p <= 1.0:
            raise ValueError(f"top_p must be in [0, 1], got {self.top_p}")

    @property
    def is_greedy(self) -> bool:
        """True when this request always takes the argmax path."""
        return self.temperature == 0.0


#: The default request policy: argmax decoding, no randomness.
GREEDY = SamplingParams()

#: the lanes of :func:`sample_tokens`: temps, top_ks, top_ps, seeds, idxs
Lanes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor]


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """``(B, V)`` logits -> ``(B,)`` argmax token ids (the first maximum
    on ties, as ``jnp.argmax`` picks)."""
    return torch.argmax(logits, dim=-1)


def sampling_lanes(params_per_slot: Sequence[SamplingParams],
                   sample_idx_per_slot: Sequence[int],
                   device: Union[str, torch.device, None] = None) -> Lanes:
    """Pack per-slot :class:`SamplingParams` (empty slots carry
    :data:`GREEDY`) and sample indices (tokens each slot's request has
    sampled so far) into the ``(B,)`` lanes of :func:`sample_tokens`:
    ``(temps, top_ks, top_ps, seeds, idxs)``, fp32 and int64, on
    ``device``."""
    sp = list(params_per_slot)

    def lane(vals, dtype):
        return torch.tensor(vals, dtype=dtype, device=device)

    return (lane([p.temperature for p in sp], torch.float32),
            lane([p.top_k for p in sp], torch.int64),
            lane([p.top_p for p in sp], torch.float32),
            lane([p.seed for p in sp], torch.int64),
            lane(list(sample_idx_per_slot), torch.int64))


def sample_tokens(logits: torch.Tensor, temps: torch.Tensor,
                  top_ks: torch.Tensor, top_ps: torch.Tensor,
                  seeds: torch.Tensor, idxs: torch.Tensor) -> torch.Tensor:
    """One token per row of ``logits`` ``(B, V)``, as the JAX package's
    ``_sample_row`` draws it, all rows in one pass: sort each row
    descending (stable, ``jnp.argsort(-logits)``'s order), divide by
    ``max(temp, 1e-6)``, keep rank ``< top_k`` (all when ``top_k <= 0``)
    and the nucleus ``cumsum(probs) - probs < top_p`` (rank 0 always), set
    the rest to ``-inf``, take the Gumbel argmax under
    ``fold_in(PRNGKey(seed), idx)`` and map it back through the order.
    Rows with ``temp <= 0`` return ``argmax(logits)``.  The lanes are
    ``(B,)`` tensors on the logits' device (:func:`sampling_lanes`).
    Returns ``(B,)`` int64."""
    vocab = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1)
    order = torch.sort(-logits, dim=-1, stable=True).indices
    scaled = (torch.gather(logits, -1, order)
              / torch.clamp(temps, min=1e-6)[:, None])
    ranks = torch.arange(vocab, device=logits.device)
    kk = torch.where(top_ks <= 0, torch.full_like(top_ks, vocab), top_ks)
    keep = ranks[None] < kk[:, None]
    e = torch.exp(scaled - torch.amax(scaled, dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    keep &= (torch.cumsum(probs, dim=-1) - probs) < top_ps[:, None]
    keep[:, 0] = True
    masked = torch.where(keep, scaled, torch.full_like(scaled, -torch.inf))
    key = prng.fold_in(prng.prng_key(seeds), idxs)
    rank = prng.categorical(key, masked)
    sampled = torch.gather(order, -1, rank[:, None])[:, 0]
    return torch.where(temps <= 0, greedy, sampled)
