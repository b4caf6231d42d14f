"""Typed serve-engine configuration (counterpart of ``repro/serve/config.py``).

The port's :class:`EngineConfig` holds only the knobs this slice
implements; the JAX config's other knobs (prefix cache, speculative decode,
quantized KV, page dedup, degrade ladder, mesh shards) arrive with their
features (``ROADMAP.md``, queue 1).  The engine always runs the paged
allocator, so ``page_size`` must resolve to a page.
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
      pool_pages: allocatable pages in the physical pool (``None`` = one
        full row per slot; smaller overcommits and defers admissions when
        the pool runs dry).
    """

    max_slots: int = 4
    max_seq: int = 128
    prefill_chunk: int = 32
    page_size: Optional[int] = None
    pool_pages: Optional[int] = None

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

    def resolve(self) -> "EngineConfig":
        """Validate, then fill the auto knobs: the page size and the pool
        size.  Raises when no page size fits ``max_seq``."""
        self.validate()
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
        return dataclasses.replace(self, page_size=page_size,
                                   pool_pages=pool_pages)
