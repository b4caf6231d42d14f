"""Paged-KV primitives: gather a slot view, scatter new rows.

The counterpart of ``repro/models/paging.py``.  Every positional state
leaf is a physical page pool ``(num_pages, page_size, ...)``, and each slot
has a ``(n_pages,)`` row of page indices (the page table).  Physical page 0
is the scratch page: idle lanes point their whole row at it, and
out-of-table rows are written there, and so are the rows a speculative
verify masks off (``nvalid``: draft padding, idle lanes, a tree's drafted
rows), so only scratch ever receives duplicate scatter targets.  Those
rows differ, and later masked rows attend what scratch holds, so a
verify's duplicates all write the last one's row (:func:`scatter_plan`):
the bytes a CPU scatter leaves (it applies duplicates in order, so the
last one wins, as the JAX package's does), whatever order a CUDA scatter
applies them in.  The plan is the same for every layer and leaf of a
dispatch, so the decode stack builds it once.

A quantized pool (``kv_dtype`` int8 or int4) is a pair of leaves, integer
codes and fp32 per-row scales in the same pooled layout:
:func:`gather_pages_dequant` gathers both through the page table and
returns the float view, and the writer quantizes its rows and scatters
codes and scales through the same table with the same row mask.

Unlike the JAX version, :func:`scatter_token_rows` writes into the pool in
place (PyTorch tensors are mutable; the pool is the largest tensor the
engine holds) and returns the same tensor.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.quant_kv import dequantize_rows

__all__ = ["gather_pages", "gather_pages_dequant", "token_coords",
           "scatter_plan", "plan_rows", "scatter_token_rows"]

#: (phys_page, offset, last writer or None): :func:`scatter_plan`
ScatterPlan = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


def gather_pages(pool: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """Gather per-slot pages into a contiguous sequence view.

    ``pool``: ``(num_pages, page_size, ...)``; ``pages``: ``(B, n_pages)``
    integer page table.  Returns a new ``(B, n_pages * page_size, ...)``
    tensor; position ``s`` of slot ``b`` reads
    ``pool[pages[b, s // page_size], s % page_size]``."""
    v = pool[pages]                              # (B, n_pages, page, ...)
    return v.reshape((v.shape[0], v.shape[1] * v.shape[2]) + v.shape[3:])


def gather_pages_dequant(pool: torch.Tensor, scale_pool: torch.Tensor,
                         pages: torch.Tensor, out_dtype: torch.dtype
                         ) -> torch.Tensor:
    """Dequantizing :func:`gather_pages`: gather a code pool
    (``(num_pages, page, ..., D)`` int8, or ``(..., D/2)`` packed uint8)
    and its per-row scale pool (``(num_pages, page, ...)`` fp32) through
    ``pages`` and return the ``(B, n_pages * page, ..., D)`` view in
    ``out_dtype``."""
    return dequantize_rows(gather_pages(pool, pages),
                           gather_pages(scale_pool, pages), out_dtype)


def token_coords(pages: torch.Tensor, pos: torch.Tensor, page: int,
                 batch: int, nvalid: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``(phys_page, offset)`` pool coordinates, each ``(B, C)``, that
    :func:`scatter_token_rows` writes row ``j`` of slot ``b`` to: ``(pages[b,
    pos // page], pos % page)``, with scratch page 0 for a position past
    the table and, with ``nvalid``, for every row ``j >= nvalid[b]``.
    ``pos`` is ``(B, C)``, or ``(C,)`` for all ``batch`` slots."""
    n_pages = pages.shape[1]
    if pos.dim() == 1:
        pos = pos[None].expand(batch, pos.shape[0])
    lp = torch.div(pos, page, rounding_mode="floor")          # (B, C)
    off = pos % page
    in_range = lp < n_pages
    if nvalid is not None:
        rows_idx = torch.arange(pos.shape[1], device=pos.device)
        in_range = in_range & (rows_idx[None] < nvalid[:, None])
    phys = torch.gather(pages, 1, torch.clamp(lp, max=n_pages - 1))
    phys = torch.where(in_range, phys, torch.zeros_like(phys))  # 0 = scratch
    return phys, off


def scatter_plan(pages: torch.Tensor, pos: torch.Tensor, page: int,
                 batch: int, nvalid: Optional[torch.Tensor] = None
                 ) -> ScatterPlan:
    """Where :func:`scatter_token_rows` writes a block: its
    :func:`token_coords` and, with ``nvalid`` (the rows it sends to
    scratch share targets), ``last`` (B, C): the flat index ``b' * C +
    j'`` of the last row, in row-major order, with row ``(b, j)``'s
    target, whose value every row of that target writes.  Pairwise over
    the block's B * C rows."""
    phys, off = token_coords(pages, pos, page, batch, nvalid)
    if nvalid is None:
        return phys, off, None
    dest = (phys * page + off).reshape(-1)
    idx = torch.arange(dest.numel(), device=dest.device)
    same = dest[:, None] == dest[None, :]
    last = torch.where(same, idx[None], -1).amax(1).reshape(phys.shape)
    return phys, off, last


def plan_rows(rows: torch.Tensor, plan: ScatterPlan) -> torch.Tensor:
    """``rows`` (B, C, ...) as ``plan`` writes them: each row replaced by
    its target's last writer (unchanged without one)."""
    last = plan[2]
    if last is None:
        return rows
    return rows.reshape((-1,) + tuple(rows.shape[2:]))[last]


def scatter_token_rows(pool: torch.Tensor, pages: torch.Tensor,
                       rows: torch.Tensor, pos: torch.Tensor,
                       nvalid: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Write ``C`` new rows per slot into the pool through the page table,
    in place.

    ``pages``: ``(B, n_pages)`` int64 page table; ``rows``: ``(B, C, ...)``
    (cast to the pool dtype); ``pos``: int64 positions ``(B, C)`` per slot
    or ``(C,)`` shared by all slots; row ``j`` of slot ``b`` lands at
    ``(pages[b, pos // page], pos % page)``.  Rows whose position lies
    past the table go to scratch page 0, and so, with ``nvalid`` (a
    ``(B,)`` per-slot count of valid rows), does every row ``j >=
    nvalid[b]``; with ``nvalid`` the rows that share a target all write
    the last one's (:func:`scatter_plan`).  Returns ``pool``."""
    plan = scatter_plan(pages, pos, pool.shape[1], rows.shape[0], nvalid)
    pool.index_put_(plan[:2], plan_rows(rows, plan).to(pool.dtype))
    return pool
