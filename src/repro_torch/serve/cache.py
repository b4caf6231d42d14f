"""Paged decode state: the page pool, its allocator, and the reuse indices.

The counterpart of the paged half of ``repro/serve/cache.py``.  Positional
state leaves live in a physical page pool — :func:`paged_state_specs`
rewrites each leaf's ``(batch, kv_seq)`` axis pair into ``(phys_page,
page_seq)`` — and :class:`PagePool` hands out pages on the host, with
reference counts, so one physical page can sit in several page-table rows.
The device half works in place on the state tensors: :func:`zero_page`
scrubs scratch, :func:`copy_page` is the copy-on-write step of a
prefix-cache hit, :func:`page_bytes` reads one page as raw bytes.

Two host-side indices decide what an admission may share:

* :class:`PrefixTrie` — a radix trie over the token sequence each slot's
  pages hold; admission asks it for the longest resident prefix of a new
  context (live or recently retired rows alike);
* :class:`PageDedupIndex` — content digest -> physical page over full
  pages, so a byte-identical page anywhere in a sequence is shared by
  reference.

Prefix reuse is only sound when every state leaf is positional
(:func:`supports_prefix`): a KV row at position ``i`` depends only on
tokens ``[0..i]``, so a shared page equals a recomputed one.

A contiguous engine (``paged_kv=False``) keeps the ``(layers, batch,
kv_seq, ...)`` layout of ``decode_state_specs`` instead: each request owns
one batch index, a *slot*, and admission works on that slot alone
(:func:`slot_slice`, :func:`slot_update`, :func:`reset_slot`,
:func:`copy_slot`, all in place).  :func:`pageable` says when a state tree
can be pooled at all.

A quantized pool (``kv_dtype`` int8 or int4, :func:`quant_state_specs`)
turns each leaf into integer codes plus an fp32 ``<name>_scale`` sibling
in the same pooled layout, so every page operation here (zeroing,
copy-on-write, the bytes dedup hashes) moves codes and scales together.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.common import ParamSpec
from repro_torch.tree import leaves, map_tree

__all__ = ["state_zeros", "state_bytes", "supports_prefix", "batch_axis",
           "slot_slice", "slot_update", "reset_slot", "copy_slot",
           "pageable", "paged_state_specs", "quant_state_specs", "zero_page", "copy_page", "page_bytes",
           "PagePool", "PrefixTrie", "PageDedupIndex"]


def state_zeros(specs: Any, device: torch.device) -> Any:
    """Zero decode state straight from the ``specs`` tree.  Zeros, never
    ``torch.empty``: masked positions still reach the split-K sum as
    ``0 * v``, so every pool byte must be a finite value."""
    return map_tree(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device), specs)


def state_bytes(specs: Any) -> int:
    """Total decode-state footprint in bytes of the ``specs`` tree."""
    total = 0
    for s in leaves(specs):
        n = 1
        for d in s.shape:
            n *= d
        total += n * torch.empty((), dtype=s.dtype).element_size()
    return total


def supports_prefix(specs: Any) -> bool:
    """True when every leaf of ``specs`` is positional (has a ``kv_seq``
    axis), i.e. a shared page prefix equals a recomputed one.  Attention
    families qualify; SSM and hybrid state summarizes the whole sequence
    and does not."""
    lv = leaves(specs)
    return bool(lv) and all("kv_seq" in s.axes for s in lv)


def batch_axis(spec: ParamSpec) -> int:
    """Index of the batch (slot) axis in one state leaf's ``spec.axes``."""
    return spec.axes.index("batch")


def slot_slice(state: Dict[str, torch.Tensor],
               specs: Dict[str, ParamSpec], slot: int
               ) -> Dict[str, torch.Tensor]:
    """``slot``'s rows of the contiguous ``state`` as a batch-1 state dict
    of views: a write through them lands in ``state``."""
    return {name: t.narrow(batch_axis(specs[name]), slot, 1)
            for name, t in state.items()}


def slot_update(state: Dict[str, torch.Tensor],
                specs: Dict[str, ParamSpec], slot: int,
                slot_state: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """Write the batch-1 dict ``slot_state`` into ``slot`` of ``state``, in
    place; returns ``state``."""
    for name, view in slot_slice(state, specs, slot).items():
        view.copy_(slot_state[name])
    return state


def reset_slot(state: Dict[str, torch.Tensor],
               specs: Dict[str, ParamSpec], slot: int
               ) -> Dict[str, torch.Tensor]:
    """Zero exactly one ``slot`` of ``state``, in place (an admission must
    not disturb the other slots); returns ``state``."""
    for view in slot_slice(state, specs, slot).values():
        view.zero_()
    return state


def copy_slot(state: Dict[str, torch.Tensor],
              specs: Dict[str, ParamSpec], src: int, dst: int
              ) -> Dict[str, torch.Tensor]:
    """Copy slot ``src`` of ``state`` over slot ``dst``, in place; returns
    ``state``.  The contiguous engine's prefix-cache hit: the whole slot is
    copied, positions past the reused prefix included, which is safe
    because attention masks positions at or past the current length and
    prefill overwrites them in order."""
    return slot_update(state, specs, dst, slot_slice(state, specs, src))


def pageable(specs: Dict[str, ParamSpec], page_size: int) -> bool:
    """True when ``specs`` can be pooled in pages of ``page_size`` tokens:
    every leaf has adjacent ``(batch, kv_seq)`` axes and a ``kv_seq``
    extent the page divides.  Attention families qualify; SSM and hybrid
    state does not (it keeps contiguous slots)."""
    if page_size <= 0:
        return False
    lv = leaves(specs)
    if not lv:
        return False
    for s in lv:
        if "batch" not in s.axes or "kv_seq" not in s.axes:
            return False
        bax, sax = s.axes.index("batch"), s.axes.index("kv_seq")
        if sax != bax + 1 or s.shape[sax] % page_size:
            return False
    return True


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


def quant_state_specs(pspecs: Dict[str, ParamSpec], kv_dtype: str
                      ) -> Dict[str, ParamSpec]:
    """Rewrite a pooled spec dict (:func:`paged_state_specs`) into its
    quantized layout: every leaf becomes an integer code leaf plus an fp32
    ``<name>_scale`` sibling with one scale per (page, position, head) row
    (the last axis is the quantization group), keeping the ``(phys_page,
    page_seq)`` axes.  ``"int8"`` keeps the leaf shapes (int8 codes);
    ``"int4"`` halves the last axis (two codes a uint8 byte; an odd extent
    raises); ``"fp32"`` returns ``pspecs`` unchanged."""
    if kv_dtype == "fp32":
        return pspecs
    if kv_dtype not in ("int8", "int4"):
        raise ValueError(f"kv_dtype must be one of ('fp32', 'int8', "
                         f"'int4'), got {kv_dtype!r}")
    out: Dict[str, ParamSpec] = {}
    for name, s in pspecs.items():
        if not isinstance(s, ParamSpec):
            raise ValueError(f"quant_state_specs needs a flat dict of "
                             f"ParamSpecs, got {type(s)} at {name!r}")
        if kv_dtype == "int4":
            feat = s.shape[-1]
            if feat % 2:
                raise ValueError(
                    f"kv_dtype='int4' packs two codes per byte, but leaf "
                    f"{name!r} has an odd feature extent {feat}")
            shape, dtype = s.shape[:-1] + (feat // 2,), torch.uint8
        else:
            shape, dtype = s.shape, torch.int8
        out[name] = ParamSpec(shape, s.axes, dtype=dtype, init="zeros")
        out[name + "_scale"] = ParamSpec(s.shape[:-1], s.axes[:-1],
                                         dtype=torch.float32, init="zeros")
    return out


def zero_page(state: Dict[str, torch.Tensor],
              pspecs: Dict[str, ParamSpec], page: int) -> None:
    """Zero ONE physical page in every leaf of the pooled ``state``, in
    place.  The engine scrubs the scratch page with this after every
    admission, so masked lanes read finite zeros through it."""
    for name, t in state.items():
        ax = pspecs[name].axes.index("phys_page")
        t.select(ax, page).zero_()


def copy_page(state: Dict[str, torch.Tensor],
              pspecs: Dict[str, ParamSpec], src: int, dst: int) -> None:
    """Copy ONE physical page ``src`` over page ``dst`` in every leaf of
    the pooled ``state``, in place.  The copy-on-write step of a
    prefix-cache hit: only the partial boundary page is copied (full pages
    are shared by reference), so a hit moves O(page) bytes, not
    O(prefix)."""
    for name, t in state.items():
        ax = pspecs[name].axes.index("phys_page")
        t.select(ax, dst).copy_(t.select(ax, src))


def page_bytes(state: Dict[str, torch.Tensor],
               pspecs: Dict[str, ParamSpec], page: int) -> List[torch.Tensor]:
    """The raw bytes of ONE physical page, one flat ``uint8`` tensor per
    leaf in sorted leaf order, on the pool's device.  The page axis sits
    behind the layer axis, so the selected page is a strided view: it is
    made contiguous before its bytes are reinterpreted (numpy has no
    bfloat16, so a float view cannot go to the host as is).  Comparing
    these tensors is byte identity — unlike a float compare, which calls
    +0 and -0 equal and NaN unequal to itself."""
    out = []
    for name in sorted(state):
        ax = pspecs[name].axes.index("phys_page")
        out.append(state[name].select(ax, page).contiguous()
                   .view(torch.uint8).reshape(-1))
    return out


class PagePool:
    """Host-side physical-page allocator with reference counts.

    Physical page 0 is reserved as the **scratch page**: it is never
    allocated, unallocated page-table entries point at it, and idle decode
    lanes aim their whole table row at it.  Pages ``1 .. num_pages-1`` are
    allocatable.

    Refcounts count the references to a page — page-table rows and
    session snapshots: an owning writer holds one, each prefix or dedup
    sharer adds one.  A page returns to the free list only when its count
    reaches zero, which is how a shared page outlives the slot that first
    wrote it; :meth:`deref` raises instead of letting a count go negative.

    **Sharded pools** (``shards > 1``, mesh serving): the pool splits into
    ``shards`` equal blocks of ``num_pages // shards`` contiguous pages.
    Block ``s`` is shard ``s``'s state, and the first page of every block
    is that shard's scratch page (pinned, never allocated; global page 0
    stays the "unallocated" page-table sentinel).  Each block keeps its own
    free list, so an admission on shard ``s`` draws only from block ``s``.
    Page ids stay global on the host; a dispatch turns them into
    shard-local offsets with one ``% block``
    (:meth:`repro_torch.serve.mesh.MeshPlan.local_pages`).  ``shards=1`` is
    the one-device pool."""

    def __init__(self, num_pages: int, shards: int = 1):
        """Create a pool of ``num_pages`` physical pages split into
        ``shards`` equal blocks, the first page of each block its scratch
        page (so at least 2 pages a shard; ``num_pages`` must divide
        evenly)."""
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if num_pages % shards:
            raise ValueError(f"num_pages={num_pages} must split into "
                             f"{shards} equal per-shard blocks")
        block = num_pages // shards
        if block < 2:
            raise ValueError(f"need >= 2 pages per shard (one is scratch), "
                             f"got {num_pages} over {shards} shard(s)")
        self.num_pages = num_pages
        self.shards = shards
        #: pages per shard block (including the block's scratch page)
        self.block = block
        self.refcount = np.zeros(num_pages, np.int32)
        self._free: List[List[int]] = []
        for s in range(shards):
            base = s * block
            self.refcount[base] = 1            # shard scratch: pinned
            # pop() -> base + 1, base + 2, ...
            self._free.append(list(range(base + block - 1, base, -1)))
        self.allocs = 0
        self.oom_events = 0

    def shard_of(self, page: int) -> int:
        """The shard whose block holds physical ``page``."""
        return int(page) // self.block

    def is_scratch(self, page) -> Any:
        """Scratch predicate (scalar or vectorized): the first page of
        every shard block, global page 0 included."""
        return page % self.block == 0

    @property
    def free_count(self) -> int:
        """Number of allocatable pages free across all shards
        (:meth:`free_count_in` gives one shard's)."""
        return sum(len(f) for f in self._free)

    def free_count_in(self, shard: int = 0) -> int:
        """Number of allocatable pages free in ``shard``'s block (what
        gates an admission on that shard)."""
        return len(self._free[shard])

    @property
    def used_count(self) -> int:
        """Number of non-scratch pages currently allocated."""
        return self.num_pages - self.shards - self.free_count

    def alloc(self, shard: int = 0) -> int:
        """Take one free page from ``shard``'s block (refcount 1).  Returns
        its global index, or ``-1`` when that block is exhausted (counted
        in ``oom_events``; the caller reclaims or defers)."""
        free = self._free[shard]
        if not free:
            self.oom_events += 1
            return -1
        p = free.pop()
        self.refcount[p] = 1
        self.allocs += 1
        return p

    def alloc_many(self, n: int, shard: int = 0) -> Optional[np.ndarray]:
        """Take ``n`` free pages from ``shard``'s block at once (each
        refcount 1), all-or-nothing: an ``(n,)`` int32 array of global
        indices, or ``None`` (nothing allocated, one OOM event counted)
        when fewer than ``n`` are free there."""
        free = self._free[shard]
        if n > len(free):
            self.oom_events += 1
            return None
        if n == 0:
            return np.empty(0, np.int32)
        pages = np.asarray(free[len(free) - n:][::-1], np.int32)
        del free[len(free) - n:]
        self.refcount[pages] = 1
        self.allocs += n
        return pages

    def ref(self, page: int) -> None:
        """Add one reference to an allocated ``page`` (prefix sharing)."""
        if page <= 0 or page >= self.num_pages or self.is_scratch(page) \
                or self.refcount[page] <= 0:
            raise ValueError(f"ref of unallocated/scratch page {page}")
        self.refcount[page] += 1

    def ref_many(self, pages: np.ndarray) -> None:
        """Add one reference to each of ``pages`` (a whole shared-prefix
        span at once; duplicates count once per occurrence).  Validates
        before mutating."""
        pages = np.asarray(pages, np.int64)
        if pages.size == 0:
            return
        if (pages <= 0).any() or (pages >= self.num_pages).any() or \
                self.is_scratch(pages).any() or \
                (self.refcount[pages] <= 0).any():
            bad = [int(p) for p in pages
                   if p <= 0 or p >= self.num_pages
                   or self.is_scratch(p) or self.refcount[p] <= 0]
            raise ValueError(f"ref of unallocated/scratch page(s) {bad}")
        np.add.at(self.refcount, pages, 1)

    def deref(self, page: int) -> bool:
        """Drop one reference to ``page``; frees it at zero, back to its
        own shard's free list.  Returns True when the page was freed.
        Raises on scratch, an out-of-range page, or a page whose count is
        already zero (underflow)."""
        if page <= 0 or page >= self.num_pages or self.is_scratch(page):
            raise ValueError(f"deref of scratch/out-of-range page {page}")
        if self.refcount[page] <= 0:
            raise ValueError(f"refcount underflow on page {page}")
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self._free[self.shard_of(page)].append(int(page))
            return True
        return False

    def deref_many(self, pages: np.ndarray) -> int:
        """Drop one reference from each of ``pages`` (a whole row at once;
        duplicates count as several derefs); frees those that reach zero,
        each back to its own shard's free list, and returns how many.
        Validates before mutating: a scratch or out-of-range page, or an
        underflow, raises with every count untouched."""
        pages = np.asarray(pages, np.int64)
        if pages.size == 0:
            return 0
        if (pages <= 0).any() or (pages >= self.num_pages).any() or \
                self.is_scratch(pages).any():
            raise ValueError(
                f"deref of scratch/out-of-range page(s) "
                f"{[int(p) for p in pages if p <= 0 or p >= self.num_pages or self.is_scratch(p)]}")
        drops = np.bincount(pages, minlength=self.num_pages)
        if (self.refcount < drops).any():
            bad = np.flatnonzero(self.refcount < drops)
            raise ValueError(f"refcount underflow on page(s) "
                             f"{[int(p) for p in bad]}")
        self.refcount -= drops.astype(self.refcount.dtype)
        freed = np.flatnonzero((drops > 0) & (self.refcount == 0))
        for p in freed:
            self._free[self.shard_of(p)].append(int(p))
        return int(freed.size)


class _TrieNode:
    """One trie position: a child edge per token, plus the slots whose
    resident token sequence passes through this node."""

    __slots__ = ("children", "slots")

    def __init__(self):
        self.children: Dict[int, "_TrieNode"] = {}
        self.slots: set = set()


class PrefixTrie:
    """Radix trie mapping token prefixes to the slot rows that hold them.

    The engine keeps it in step with the pages: :meth:`insert` after a
    prefill writes a slot's context, :meth:`extend` after each decode step
    writes the fed token, :meth:`remove` when a slot's pages are about to
    be overwritten or released.  An entry outlives its *request*: a retired
    row stays matchable until its slot is reused or reclaimed.

    With ``capacity`` set, inserting beyond it evicts the least-recently-
    used entries (recency is touched by inserts, extends and successful
    matches), counted in :attr:`evictions`."""

    def __init__(self, capacity: Optional[int] = None):
        """An empty trie; ``capacity`` bounds the indexed slots (``None``
        = unbounded)."""
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._root = _TrieNode()
        self._slot_tokens: Dict[int, List[int]] = {}
        self.capacity = capacity
        self.evictions = 0
        self._clock = 0
        self._last_used: Dict[int, int] = {}

    def _touch(self, slot: int) -> None:
        self._clock += 1
        self._last_used[slot] = self._clock

    def lru_slots(self) -> List[int]:
        """Indexed slots, least-recently-used first (the order the
        capacity bound and the engine's pressure reclaim evict in)."""
        return sorted(self._slot_tokens, key=lambda s: self._last_used[s])

    def __len__(self) -> int:
        """Number of slots with a resident (matchable) entry."""
        return len(self._slot_tokens)

    def tokens(self, slot: int) -> Optional[List[int]]:
        """The token sequence indexed for ``slot`` (or None)."""
        toks = self._slot_tokens.get(slot)
        return None if toks is None else list(toks)

    def length(self, slot: int) -> Optional[int]:
        """Number of tokens indexed for ``slot`` (or None if no entry)."""
        toks = self._slot_tokens.get(slot)
        return None if toks is None else len(toks)

    def insert(self, slot: int, tokens: Sequence[int]) -> List[int]:
        """Index ``tokens`` as the content of ``slot``'s pages (replacing
        any previous entry for it).  Returns the slots evicted to honour
        ``capacity``, LRU first and never ``slot`` itself; the caller
        releases their pages."""
        self.remove(slot)
        node = self._root
        for t in tokens:
            node = node.children.setdefault(int(t), _TrieNode())
            node.slots.add(slot)
        self._slot_tokens[slot] = [int(t) for t in tokens]
        self._touch(slot)
        evicted: List[int] = []
        if self.capacity is not None:
            while len(self._slot_tokens) > self.capacity:
                victim = next(s for s in self.lru_slots() if s != slot)
                self.remove(victim)
                self.evictions += 1
                evicted.append(victim)
        return evicted

    def extend(self, slot: int, token: int) -> None:
        """Append one ``token`` to ``slot``'s entry (decode wrote one more
        position).  No-op if the slot has no entry."""
        toks = self._slot_tokens.get(slot)
        if toks is None:
            return
        node = self._root
        for t in toks:
            node = node.children[t]
        node = node.children.setdefault(int(token), _TrieNode())
        node.slots.add(slot)
        toks.append(int(token))
        self._touch(slot)

    def remove(self, slot: int) -> bool:
        """Drop ``slot``'s entry, pruning nodes that index no slot any
        more.  Returns True if an entry was removed."""
        toks = self._slot_tokens.pop(slot, None)
        if toks is None:
            return False
        self._last_used.pop(slot, None)
        node, path = self._root, []
        for t in toks:
            path.append((node, t))
            node = node.children[t]
            node.slots.discard(slot)
        for parent, t in reversed(path):
            child = parent.children[t]
            if not child.slots and not child.children:
                del parent.children[t]
        return True

    def longest_match(self, tokens: Sequence[int], touch: bool = True,
                      allowed: Optional[Callable[[int], bool]] = None
                      ) -> Tuple[int, int]:
        """Longest resident prefix of ``tokens`` as ``(length, slot)``: the
        deepest walk along ``tokens`` and a slot holding that whole prefix
        (the smallest on ties); ``(0, -1)`` when nothing matches.  A match
        refreshes the slot's recency unless ``touch`` is False (cost-model
        probes must not promote entries).  ``allowed`` restricts the
        candidate slots; the walk stops at the deepest node that still has
        an allowed slot."""
        node, depth, slot = self._root, 0, -1
        for t in tokens:
            nxt = node.children.get(int(t))
            if nxt is None:
                break
            cand = (nxt.slots if allowed is None
                    else {s for s in nxt.slots if allowed(s)})
            if not cand:
                break
            node, depth = nxt, depth + 1
            slot = min(cand)
        if touch and slot >= 0:
            self._touch(slot)
        return depth, slot


class PageDedupIndex:
    """Content-addressed index over *full* physical pages.

    The trie sees only token prefixes: a shared span that starts past
    position 0 is invisible to it.  The engine hashes the bytes of every
    full page an admission wrote and registers ``digest -> page`` here; a
    later page with the same digest is a *candidate* twin, shared by
    reference only after a byte compare confirms it (a collision is
    counted and degrades to a miss).

    The index holds no references: the engine un-indexes a page
    (:meth:`discard`) whenever it is freed or about to be rewritten, so
    every indexed page has a positive refcount.  With ``capacity`` set it
    drops least-recently-used entries (never page references)."""

    def __init__(self, capacity: Optional[int] = None):
        """An empty index; ``capacity`` bounds the indexed pages (``None``
        = unbounded)."""
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._by_digest: Dict[bytes, List[int]] = {}
        self._by_page: Dict[int, bytes] = {}
        self.capacity = capacity
        self.evictions = 0
        self._clock = 0
        self._last_used: Dict[int, int] = {}

    def __len__(self) -> int:
        """Number of physical pages indexed."""
        return len(self._by_page)

    def pages(self) -> List[int]:
        """Every indexed physical page (for invariant checks)."""
        return list(self._by_page)

    def digest_of(self, page: int) -> Optional[bytes]:
        """The digest ``page`` is indexed under (or None)."""
        return self._by_page.get(page)

    def _touch(self, page: int) -> None:
        self._clock += 1
        self._last_used[page] = self._clock

    def insert(self, page: int, digest: bytes) -> None:
        """Index ``page`` under ``digest`` (replacing its previous digest);
        honours ``capacity`` LRU-first, counted in :attr:`evictions`."""
        self.discard(page)
        self._by_digest.setdefault(digest, []).append(int(page))
        self._by_page[int(page)] = digest
        self._touch(int(page))
        if self.capacity is not None:
            while len(self._by_page) > self.capacity:
                victim = min((p for p in self._by_page if p != page),
                             key=lambda p: self._last_used[p], default=None)
                if victim is None:
                    break
                self.discard(victim)
                self.evictions += 1

    def candidates(self, digest: bytes) -> List[int]:
        """Pages indexed under ``digest`` (possible twins; the caller
        byte-compares before sharing).  Refreshes their recency."""
        pages = list(self._by_digest.get(digest, ()))
        for p in pages:
            self._touch(p)
        return pages

    def discard(self, page: int) -> bool:
        """Drop ``page`` from the index (freed, or about to change).
        Returns True if an entry was removed."""
        digest = self._by_page.pop(int(page), None)
        if digest is None:
            return False
        self._last_used.pop(int(page), None)
        plist = self._by_digest[digest]
        plist.remove(int(page))
        if not plist:
            del self._by_digest[digest]
        return True

    def discard_many(self, pages) -> int:
        """:meth:`discard` each of ``pages``; returns how many entries were
        removed."""
        return sum(self.discard(int(p)) for p in np.asarray(pages).ravel())
