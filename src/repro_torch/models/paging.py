"""Paged-KV primitives: gather a slot view, scatter new rows.

The counterpart of ``repro/models/paging.py``.  Every positional state
leaf is a physical page pool ``(num_pages, page_size, ...)``, and each slot
has a ``(n_pages,)`` row of page indices (the page table).  Physical page 0
is the scratch page: idle lanes point their whole row at it, and
out-of-table rows are written there, so only scratch ever receives
duplicate scatter targets.  (The row mask of speculative verification,
``nvalid``, arrives with that feature.)

Unlike the JAX version, :func:`scatter_token_rows` writes into the pool in
place (PyTorch tensors are mutable; the pool is the largest tensor the
engine holds) and returns the same tensor.
"""
from __future__ import annotations

import torch

__all__ = ["gather_pages", "scatter_token_rows"]


def gather_pages(pool: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """Gather per-slot pages into a contiguous sequence view.

    ``pool``: ``(num_pages, page_size, ...)``; ``pages``: ``(B, n_pages)``
    integer page table.  Returns a new ``(B, n_pages * page_size, ...)``
    tensor; position ``s`` of slot ``b`` reads
    ``pool[pages[b, s // page_size], s % page_size]``."""
    v = pool[pages]                              # (B, n_pages, page, ...)
    return v.reshape((v.shape[0], v.shape[1] * v.shape[2]) + v.shape[3:])


def scatter_token_rows(pool: torch.Tensor, pages: torch.Tensor,
                       rows: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Write ``C`` new rows per slot into the pool through the page table,
    in place.

    ``pages``: ``(B, n_pages)`` int64 page table; ``rows``: ``(B, C, ...)``
    (cast to the pool dtype); ``pos``: int64 positions ``(B, C)`` per slot
    or ``(C,)`` shared by all slots; row ``j`` of slot ``b`` lands at
    ``(pages[b, pos // page], pos % page)``.  Rows whose position lies
    past the table go to scratch page 0.  Returns ``pool``."""
    page = pool.shape[1]
    n_pages = pages.shape[1]
    if pos.dim() == 1:
        pos = pos[None].expand(rows.shape[0], rows.shape[1])
    lp = torch.div(pos, page, rounding_mode="floor")          # (B, C)
    off = pos % page
    in_range = lp < n_pages
    phys = torch.gather(pages, 1, torch.clamp(lp, max=n_pages - 1))
    phys = torch.where(in_range, phys, torch.zeros_like(phys))  # 0 = scratch
    pool.index_put_((phys, off), rows.to(pool.dtype))
    return pool
