"""Multi-turn conversation sessions: retired page refs that outlive slots.

The counterpart of ``repro/serve/sessions.py``.  The prefix trie keeps a
retired slot's pages matchable only until the slot is reused — useless for
a conversation whose user returns after every slot has turned over.  A
:class:`SessionStore` closes that gap on the host: when a turn retires, the
engine snapshots the slot's page-table row into the conversation's
:class:`Session` and takes one pool reference per page, so the history
stays resident and byte-intact (pages are written only through live table
rows, and the copy-on-write and detach paths never write through a page
with refcount > 1).  The next turn re-admits the history as shared pages.

Pure host-side Python with no allocator of its own: the engine owns the
page pool and does every ref and deref; sessions carry the row snapshots,
the token histories and the LRU order the engine's pressure reclaim drops
snapshots in (a drop costs only a re-prefill).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

__all__ = ["Session", "SessionStore"]


class Session:
    """One conversation's accumulated state.

    Attributes:
      history: every token of the conversation so far (each turn's prompt
        and reply, in order) — the prefix the next turn's context extends.
      row: page-table row snapshot holding the first ``covered`` tokens of
        ``history`` (``None`` until a turn retires, or after a pressure
        drop).  The engine holds one pool reference per page in it.
      covered: cache positions the snapshot holds (``history[:covered]``;
        a turn's final sampled token is never written, so ``covered <
        len(history)``).
      turns: turns retired so far.
    """

    __slots__ = ("conv_id", "history", "row", "covered", "turns")

    def __init__(self, conv_id):
        self.conv_id = conv_id
        self.history: List[int] = []
        self.row: Optional[np.ndarray] = None
        self.covered: int = 0
        self.turns: int = 0


class SessionStore:
    """conv-id -> :class:`Session` map with LRU order for pressure drops."""

    def __init__(self):
        self._sessions: Dict[object, Session] = {}
        self._clock = 0
        self._last_used: Dict[object, int] = {}
        #: snapshots dropped by the engine's pressure reclaim
        self.drops = 0

    def __len__(self) -> int:
        return len(self._sessions)

    def __contains__(self, conv_id) -> bool:
        return conv_id in self._sessions

    def get(self, conv_id) -> Optional[Session]:
        """``conv_id``'s session, or ``None`` (does not touch LRU)."""
        return self._sessions.get(conv_id)

    def ensure(self, conv_id) -> Session:
        """``conv_id``'s session, created empty on first use; refreshes its
        LRU recency."""
        sess = self._sessions.get(conv_id)
        if sess is None:
            sess = self._sessions[conv_id] = Session(conv_id)
        self._touch(conv_id)
        return sess

    def _touch(self, conv_id) -> None:
        self._clock += 1
        self._last_used[conv_id] = self._clock

    def lru_snapshots(self) -> List[Session]:
        """Sessions holding a row snapshot, least-recently-used first — the
        order pressure reclaim takes them in."""
        return sorted((s for s in self._sessions.values()
                       if s.row is not None),
                      key=lambda s: self._last_used[s.conv_id])

    def take_snapshot(self, sess: Session) -> Optional[np.ndarray]:
        """Detach and return ``sess``'s row snapshot (``None`` if none).
        The caller derefs the returned pages; the history survives, so the
        next turn re-prefills."""
        row, sess.row, sess.covered = sess.row, None, 0
        return row

    def pop(self, conv_id) -> Optional[np.ndarray]:
        """End conversation ``conv_id``: drop its session and return the
        row snapshot for the caller to deref (or ``None``)."""
        sess = self._sessions.pop(conv_id, None)
        self._last_used.pop(conv_id, None)
        if sess is None:
            return None
        return sess.row

    def snapshot_pages(self) -> List[int]:
        """Every physical page some snapshot references, once per
        reference (the refcount ground truth's session half)."""
        out: List[int] = []
        for s in self._sessions.values():
            if s.row is not None:
                out.extend(int(p) for p in s.row if p)
        return out
