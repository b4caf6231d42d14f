"""Paged decode state: the physical page pool and its host-side allocator.

The counterpart of the paged half of ``repro/serve/cache.py``.  Positional
state leaves live in a physical page pool — :func:`paged_state_specs`
rewrites each leaf's ``(batch, kv_seq)`` axis pair into ``(phys_page,
page_seq)`` — and :class:`PagePool` hands out pages on the host, with
reference counts.  The device half works in place on the state tensors
(:func:`zero_page`).

Not in this slice: prefix trie, page dedup, copy-on-write page copies,
quantized pools and sharded pools (``ROADMAP.md``, queue 1).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.common import ParamSpec, map_specs

__all__ = ["state_zeros", "state_bytes", "paged_state_specs", "zero_page",
           "PagePool"]


def _leaves(specs: Any) -> List[ParamSpec]:
    if isinstance(specs, ParamSpec):
        return [specs]
    return [leaf for v in specs.values() for leaf in _leaves(v)]


def state_zeros(specs: Any, device: torch.device) -> Any:
    """Zero decode state straight from the ``specs`` tree.  Zeros, never
    ``torch.empty``: masked positions still reach the split-K sum as
    ``0 * v``, so every pool byte must be a finite value."""
    return map_specs(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device), specs)


def state_bytes(specs: Any) -> int:
    """Total decode-state footprint in bytes of the ``specs`` tree."""
    total = 0
    for s in _leaves(specs):
        n = 1
        for d in s.shape:
            n *= d
        total += n * torch.empty((), dtype=s.dtype).element_size()
    return total


def paged_state_specs(specs: Dict[str, ParamSpec], page_size: int,
                      num_pages: int) -> Dict[str, ParamSpec]:
    """Rewrite a contiguous decode-state ``specs`` dict into its pooled
    layout: every leaf's adjacent ``(batch, kv_seq)`` axis pair becomes
    ``(phys_page, page_seq)`` with extents ``(num_pages, page_size)``.
    Raises ``ValueError`` for a leaf without that pair or whose ``kv_seq``
    extent the page does not divide."""
    out = {}
    for name, s in specs.items():
        if "batch" not in s.axes or "kv_seq" not in s.axes:
            raise ValueError(f"leaf {name!r} is not positional: no "
                             f"(batch, kv_seq) axis pair")
        bax = s.axes.index("batch")
        if s.axes.index("kv_seq") != bax + 1 or s.shape[bax + 1] % page_size:
            raise ValueError(
                f"leaf {name!r} is not pageable at page_size={page_size}: "
                f"it needs adjacent (batch, kv_seq) axes with kv_seq "
                f"divisible by the page")
        out[name] = ParamSpec(
            s.shape[:bax] + (num_pages, page_size) + s.shape[bax + 2:],
            s.axes[:bax] + ("phys_page", "page_seq") + s.axes[bax + 2:],
            dtype=s.dtype, init=s.init, scale=s.scale)
    return out


def zero_page(state: Dict[str, torch.Tensor],
              pspecs: Dict[str, ParamSpec], page: int) -> None:
    """Zero ONE physical page in every leaf of the pooled ``state``, in
    place.  The engine scrubs the scratch page with this after every
    admission, so masked lanes read finite zeros through it."""
    for name, t in state.items():
        ax = pspecs[name].axes.index("phys_page")
        t.select(ax, page).zero_()


class PagePool:
    """Host-side physical-page allocator with reference counts.

    Physical page 0 is reserved as the **scratch page**: it is never
    allocated, unallocated page-table entries point at it, and idle decode
    lanes aim their whole table row at it.  Pages ``1 .. num_pages-1`` are
    allocatable.  A page returns to the free list when its count reaches
    zero; :meth:`deref_many` raises instead of letting a count go negative.
    (The JAX pool's prefix-sharing ``ref`` and its shard blocks arrive with
    those features.)"""

    def __init__(self, num_pages: int):
        """Create a pool of ``num_pages`` physical pages, page 0 scratch."""
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (one is scratch), "
                             f"got {num_pages}")
        self.num_pages = num_pages
        self.refcount = np.zeros(num_pages, np.int32)
        self.refcount[0] = 1                   # scratch: pinned forever
        self._free: List[int] = list(range(num_pages - 1, 0, -1))

    @property
    def free_count(self) -> int:
        """Number of allocatable pages currently free."""
        return len(self._free)

    @property
    def used_count(self) -> int:
        """Number of non-scratch pages currently allocated."""
        return self.num_pages - 1 - self.free_count

    def alloc_many(self, n: int) -> Optional[np.ndarray]:
        """Take ``n`` free pages at once (each refcount 1), all-or-nothing:
        an ``(n,)`` int32 array, or ``None`` (nothing allocated) when fewer
        than ``n`` are free."""
        if n > len(self._free):
            return None
        if n == 0:
            return np.empty(0, np.int32)
        pages = np.asarray(self._free[len(self._free) - n:][::-1], np.int32)
        del self._free[len(self._free) - n:]
        self.refcount[pages] = 1
        return pages

    def deref_many(self, pages: np.ndarray) -> int:
        """Drop one reference from each of ``pages``; frees those that
        reach zero and returns how many.  Validates before mutating: a
        scratch or out-of-range page, or an underflow, raises with every
        count untouched."""
        pages = np.asarray(pages, np.int64)
        if pages.size == 0:
            return 0
        if (pages <= 0).any() or (pages >= self.num_pages).any():
            raise ValueError(f"deref of scratch/out-of-range page(s) "
                             f"{[int(p) for p in pages]}")
        drops = np.bincount(pages, minlength=self.num_pages)
        if (self.refcount < drops).any():
            bad = np.flatnonzero(self.refcount < drops)
            raise ValueError(f"refcount underflow on page(s) "
                             f"{[int(p) for p in bad]}")
        self.refcount -= drops.astype(self.refcount.dtype)
        freed = np.flatnonzero((drops > 0) & (self.refcount == 0))
        self._free.extend(int(p) for p in freed)
        return int(freed.size)
