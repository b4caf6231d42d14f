"""Typed serve-engine configuration (counterpart of ``repro/serve/config.py``).

The port's :class:`EngineConfig` holds the knobs of the features the port
serves — batching, paging, the prefix cache, page dedup and the degrade
ladder — with the JAX config's defaults and validation messages; the JAX
config's other knobs (speculative decode, quantized KV, contiguous slots,
mesh shards) arrive with their features (``ROADMAP.md``, queue 1).  The
engine always runs the paged allocator, so ``page_size`` must resolve to a
page.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["EngineConfig", "auto_page_size"]


def auto_page_size(max_seq: int) -> int:
    """Largest power-of-two page in [16, 128] that divides ``max_seq`` and
    leaves at least two pages (a 1-page split-K combine is a no-op)."""
    for p in (128, 64, 32, 16):
        if max_seq % p == 0 and max_seq // p >= 2:
            return p
    return 0


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The port's serve-engine knobs; defaults are the JAX engine's.

    Args:
      max_slots: decode batch width (concurrent requests).
      max_seq: per-slot cache capacity (context + generated tokens).
      prefill_chunk: max tokens per prefill dispatch (shape buckets are
        powers of two up to it).
      page_size: KV page of the split-K combine and the allocator
        (``None`` = :func:`auto_page_size`; must divide ``max_seq``).
      prefix_cache: enable prefix reuse (auto-off for non-positional
        state).
      min_prefix: smallest resident-prefix match worth reusing.
      pool_pages: allocatable pages in the physical pool (``None`` = one
        full row per slot; smaller overcommits and defers admissions when
        the pool runs dry).
      trie_capacity: LRU bound on prefix-trie entries (``None`` =
        unbounded).
      page_dedup: content-hash full pages at admission and share
        byte-identical ones by reference, wherever they sit in either
        sequence.
      degrade: enable the overload degrade ladder: under measured SLO
        pressure step down to smaller prefill chunks, then shed hopeless
        pending requests, recovering with hysteresis.
    """

    max_slots: int = 4
    max_seq: int = 128
    prefill_chunk: int = 32
    page_size: Optional[int] = None
    prefix_cache: bool = True
    min_prefix: int = 8
    pool_pages: Optional[int] = None
    trie_capacity: Optional[int] = None
    page_dedup: bool = False
    degrade: bool = False

    def validate(self) -> "EngineConfig":
        """Check the model-independent constraints; returns ``self``."""
        if self.max_slots < 1:
            raise ValueError("need at least one slot")
        if self.max_seq < 1:
            raise ValueError(f"max_seq must be >= 1, got {self.max_seq}")
        if self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        if self.pool_pages is not None and self.pool_pages < 1:
            raise ValueError(
                f"pool_pages must be >= 1, got {self.pool_pages}")
        if self.trie_capacity is not None and self.trie_capacity < 1:
            raise ValueError(
                f"trie_capacity must be >= 1, got {self.trie_capacity}")
        if self.page_size is not None and self.page_size < 1:
            raise ValueError(
                f"page_size must be >= 1 (the port serves paged KV only; "
                f"contiguous slots are still to port, see ROADMAP.md "
                f"queue 1), got {self.page_size}")
        if self.page_size and self.max_seq % self.page_size:
            raise ValueError(
                f"page_size={self.page_size} must divide "
                f"max_seq={self.max_seq}")
        return self

    def resolve(self, model_cfg) -> "EngineConfig":
        """Validate, then resolve the auto knobs against ``model_cfg``: the
        page size, the pool size, and ``prefix_cache``, which is off for a
        family whose decode state is not positional.  Raises when no page
        size fits ``max_seq``.  Imports the model registry lazily, so
        building and validating a config stays pure host-side Python."""
        self.validate()
        from repro_torch.models.registry import get_api
        from repro_torch.serve import cache
        page_size = self.page_size
        if page_size is None:
            page_size = auto_page_size(self.max_seq)
            if not page_size:
                raise ValueError(
                    f"auto_page_size found no power-of-two page in "
                    f"[16, 128] dividing max_seq={self.max_seq} into >= 2 "
                    f"pages; pass an explicit page_size")
        pool_pages = self.pool_pages
        if pool_pages is None:
            pool_pages = self.max_slots * (self.max_seq // page_size)
        specs = get_api(model_cfg).decode_state_specs(
            model_cfg, self.max_slots, self.max_seq)
        prefix_cache = bool(self.prefix_cache
                            and cache.supports_prefix(specs))
        return dataclasses.replace(self, page_size=page_size,
                                   pool_pages=pool_pages,
                                   prefix_cache=prefix_cache)
