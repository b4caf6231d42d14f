"""Token sampling (counterpart of ``repro/serve/sampling.py``): greedy only.

``temperature == 0`` is the JAX engine's greedy fast path, exactly
``argmax(logits)``.  Stochastic sampling needs the JAX package's random
bits (threefry ``fold_in`` + ``categorical``) to give the same tokens, and
arrives with ROADMAP.md queue 1 item 7; until then a request with
``temperature > 0`` raises.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["SamplingParams", "GREEDY", "greedy_tokens"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration (host-side, hashable).

    Args:
      temperature: softmax temperature; ``0`` selects greedy decoding.
        The port serves greedy only, so a positive value raises.
      top_k: top-k truncation (``0`` disables); read only when sampling.
      top_p: nucleus truncation (``1.0`` disables); read only when sampling.
      seed: per-request PRNG seed; read only when sampling.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.temperature > 0:
            raise NotImplementedError(
                "stochastic sampling (temperature > 0) needs threefry parity "
                "with the JAX package: ROADMAP.md queue 1 item 7")
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


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """``(B, V)`` logits -> ``(B,)`` argmax token ids (the first maximum
    on ties, as ``jnp.argmax`` picks)."""
    return torch.argmax(logits, dim=-1)
