"""Speculative multi-token decode: drafting, tree topology + acceptance.

The port's copy of ``repro/serve/spec.py`` (pure host-side Python: the
same names, the same results; the JAX package is never imported).

Host-side (like :mod:`repro_torch.serve.scheduler`), so the policy
is unit-testable without compiling a model.  The serve engine's classic
decode loop is strictly sequential: ONE token per dispatch, because
token ``i+1``'s distribution depends on token ``i``.  Speculative decode is
the paper's sequential-to-combinatorial tilt applied to generation: guess
candidate tokens cheaply on the host (*drafting*), then score all of them
in ONE wide dispatch (``verify_chunk`` / ``verify_tree``) — a few serial
steps replaced by one parallel multi-operand step, with the split-K page
combine still running through the shared radix-4 ``ReductionPlan``.

Pieces that live here:

* :class:`PromptLookupDrafter` — a **model-free** chain drafter: match the
  last n-gram of a slot's token history (prompt + generated output) against
  earlier occurrences in that same history and propose the continuation.
  Zero extra weights, zero extra dispatches; it exploits the
  self-similarity of real generation (quoting the prompt, code/list
  patterns, repetition loops).  The lookup is *iterated*: when the matched
  continuation is shorter than the budget (e.g. a tight repetition cycle),
  the draft-so-far is appended to the history and matched again, so short
  cycles still fill all K lanes.
* :class:`SuffixCache` — the incremental per-slot suffix-table behind the
  lookup drafters.  The original drafter re-scanned the full history on
  every call (O(len) Python work per step at long outputs); the cache
  indexes each n-gram's occurrence positions once, extends by only the
  newly emitted tokens each step, and truncates back on any rollback /
  slot reuse (``sync`` diffs against the slot's current history).
* :class:`TreeDraft` — a flattened token *tree*: per-node drafted token,
  parent index (``-1`` = child of the anchor row) and 1-based depth.
  A chain is the degenerate single-branch tree (:meth:`TreeDraft.chain`).
* :class:`NGramTreeDrafter` — the fan-out generalization of prompt lookup:
  top-``a`` distinct continuations per node from the same suffix tables —
  a main chain plus ranked sibling hedges, each extended with its own
  top-1 continuation while the node budget lasts.
* :class:`DraftHeadDrafter` — medusa-style drafting from small extra heads
  that share the slot's hidden state inside the verify dispatch (no second
  model, no second KV cache — see ``repro_torch.models.lm.draft_head_specs``).
  Head ``h``'s top-``a`` candidates fill tree depth ``h + 1``.
* :func:`accept_tokens` / :func:`accept_path` — the acceptance rules.  The
  verify dispatch samples a token at EVERY fed position from the true
  logits with the request's own stateless PRNG stream
  (``fold_in(PRNGKey(seed), i)`` at sample index ``i`` —
  :mod:`repro_torch.serve.sampling`); a draft node is accepted while it equals
  the token actually sampled at its parent.  Because each emitted token is
  always *the* sample the non-speculative engine would have drawn at that
  index, the output stream is **bit-exact** vs sequential decode for
  greedy AND stochastic lanes — for a deterministic (delta) proposal this
  exact-match rule *is* rejection sampling: a draft ``d`` survives with
  probability ``p(d)``, and on rejection the emitted correction is
  distributed as ``p`` conditioned on ``!= d`` — the residual
  distribution.  For a tree the rule walks the longest accepted
  root-to-leaf path; every branch point just offers the sampler more than
  one delta to match, which can only lengthen the accepted path, never
  change any emitted token.
* :func:`expected_tokens_chain` / :func:`expected_tokens_tree` /
  :func:`pick_shape` — the Lemma-3 reconfigurator model: closed-form
  expected-tokens-per-dispatch for a K-chain vs an (a, d) tree at a
  measured per-candidate accept rate; ``spec_mode="auto"`` picks the shape
  each step exactly the way ``core/reconfig`` picks adder tilings (the
  paper's sequential-to-combinatorial crossover, applied a second time).
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "PromptLookupDrafter", "propose_draft", "accept_tokens",
    "SuffixCache", "TreeDraft", "NGramTreeDrafter", "DraftHeadDrafter",
    "accept_path", "expected_tokens_chain", "expected_tokens_tree",
    "tree_depth", "pick_shape", "per_candidate_accept",
]


def _lookup(history: Sequence[int], k: int, ngram_max: int,
            ngram_min: int) -> List[int]:
    """One prompt-lookup round: the continuation (up to ``k`` tokens) after
    the most recent earlier occurrence of the longest matching suffix
    n-gram of ``history`` (n from ``ngram_max`` down to ``ngram_min``)."""
    n_hist = len(history)
    for n in range(min(ngram_max, n_hist - 1), ngram_min - 1, -1):
        pat = list(history[-n:])
        for i in range(n_hist - n - 1, -1, -1):
            if list(history[i:i + n]) == pat:
                cont = list(history[i + n:i + n + k])
                if cont:
                    return cont
                break       # suffix-adjacent match: no continuation to take
    return []


def propose_draft(history: Sequence[int], k: int, ngram_max: int = 3,
                  ngram_min: int = 1) -> List[int]:
    """Draft up to ``k`` candidate next tokens for one slot by iterated
    prompt lookup over its own ``history`` (prompt + generated so far).

    Args:
      history: the slot's full token history; the last token is the one
        the next decode step would feed.
      k: draft budget (the verify dispatch width is ``k + 1``).
      ngram_max: longest suffix n-gram tried first (longer matches are
        higher-precision anchors).
      ngram_min: shortest n-gram worth matching; below it the drafter
        returns fewer than ``k`` tokens rather than guessing blind.

    Returns:
      0 to ``k`` drafted tokens.  An empty draft degrades the step to the
      classic single-token decode (still one dispatch, one emitted token).
    """
    if k <= 0 or len(history) < ngram_min + 1:
        return []
    out: List[int] = []
    h = list(history)
    while len(out) < k:
        cont = _lookup(h, k - len(out), ngram_max, ngram_min)
        if not cont:
            break
        out.extend(cont)
        h.extend(cont)
    return out[:k]


class SuffixCache:
    """Incremental per-slot n-gram suffix table for the lookup drafters.

    Maps every n-gram (``ngram_min <= n <= ngram_max``) of the indexed
    token history to the ascending list of its *end* positions.  ``sync``
    diffs against the slot's current history and extends (or, after a
    rollback / slot reuse, truncates then extends) by only the changed
    tail, so per-step indexing cost is O(new tokens) instead of the
    O(full history) re-scan the original drafter paid on every call.
    Lookups reproduce :func:`propose_draft` / :func:`_lookup` bit-for-bit
    (the tests pin the equivalence under a randomized churn walk).
    """

    def __init__(self, ngram_max: int = 3, ngram_min: int = 1):
        if ngram_min < 1 or ngram_max < ngram_min:
            raise ValueError(f"need 1 <= ngram_min <= ngram_max, got "
                             f"[{ngram_min}, {ngram_max}]")
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min
        self.tokens: List[int] = []
        #: pattern -> ascending end positions (end = index one past the
        #: pattern's last token) in the indexed history
        self._ends: Dict[Tuple[int, ...], List[int]] = {}
        #: resyncs that had to rewind the table (rollback / slot reuse)
        self.invalidations = 0
        #: tokens indexed incrementally across the cache's lifetime
        self.indexed_tokens = 0

    def _index_one(self, j: int) -> None:
        """Index every n-gram ending at position ``j + 1``."""
        end = j + 1
        for g in range(self.ngram_min, self.ngram_max + 1):
            if end < g:
                break
            pat = tuple(self.tokens[end - g:end])
            self._ends.setdefault(pat, []).append(end)

    def _truncate(self, length: int) -> None:
        """Rewind the index so it covers only ``tokens[:length]``."""
        for j in range(len(self.tokens) - 1, length - 1, -1):
            end = j + 1
            for g in range(self.ngram_min, self.ngram_max + 1):
                if end < g:
                    break
                pat = tuple(self.tokens[end - g:end])
                ends = self._ends.get(pat)
                if ends:                       # appended ascending: pop back
                    ends.pop()
                    if not ends:
                        del self._ends[pat]
        del self.tokens[length:]

    def sync(self, history: Sequence[int]) -> None:
        """Bring the table in line with ``history``: extend by the new
        tail, or truncate to the longest common prefix first when the
        history rewound / diverged (rollback, eviction re-admission, slot
        reuse by a different request)."""
        h = list(history)
        n = len(self.tokens)
        if len(h) < n or h[:n] != self.tokens:
            m = 0
            lim = min(n, len(h))
            while m < lim and h[m] == self.tokens[m]:
                m += 1
            self._truncate(m)
            self.invalidations += 1
            n = m
        for j in range(n, len(h)):
            self.tokens.append(h[j])
            self._index_one(j)
            self.indexed_tokens += 1

    # ------------------------------------------------------------- lookups
    def _latest_end(self, pat: Tuple[int, ...], extra: Sequence[int],
                    before: int) -> int:
        """Most recent occurrence end ``<= before`` of ``pat`` in the
        virtual history ``tokens + extra`` (``-1`` when absent).  Committed
        occurrences come from the index; occurrences ending inside (or
        spanning into) the ``extra`` overlay are scanned directly — the
        overlay is at most one draft budget long."""
        g = len(pat)
        n_comm = len(self.tokens)
        best = -1
        for end in range(min(before, n_comm + len(extra)),
                         n_comm, -1):          # overlay + boundary spans
            lo = end - g
            if lo < 0:
                break
            window = tuple((self.tokens[i] if i < n_comm
                            else extra[i - n_comm])
                           for i in range(lo, end))
            if window == pat:
                return end
        ends = self._ends.get(pat)
        if ends:
            i = bisect.bisect_right(ends, min(before, n_comm)) - 1
            if i >= 0:
                best = ends[i]
        return best

    def _virtual(self, extra: Sequence[int], i: int) -> int:
        n_comm = len(self.tokens)
        return self.tokens[i] if i < n_comm else extra[i - n_comm]

    def lookup(self, extra: Sequence[int], k: int) -> List[int]:
        """One lookup round over ``tokens + extra`` — same semantics as
        :func:`_lookup` (longest suffix n-gram, most recent earlier
        occurrence, continuation up to ``k`` tokens)."""
        n_hist = len(self.tokens) + len(extra)
        for g in range(min(self.ngram_max, n_hist - 1),
                       self.ngram_min - 1, -1):
            pat = tuple(self._virtual(extra, i)
                        for i in range(n_hist - g, n_hist))
            end = self._latest_end(pat, extra, n_hist - 1)
            if end >= 0:
                return [self._virtual(extra, i)
                        for i in range(end, min(end + k, n_hist))]
        return []

    def topk_next(self, extra: Sequence[int], a: int) -> List[int]:
        """Up to ``a`` DISTINCT candidate next tokens after the synced
        history extended by the pending ``extra`` tokens, ranked by
        (longest n-gram, most recent occurrence) — the fan-out primitive
        behind :class:`NGramTreeDrafter`.  Rank 0 is exactly what
        :meth:`lookup` would continue with."""
        n_hist = len(self.tokens) + len(extra)
        out: List[int] = []
        for g in range(min(self.ngram_max, n_hist - 1),
                       self.ngram_min - 1, -1):
            pat = tuple(self._virtual(extra, i)
                        for i in range(n_hist - g, n_hist))
            before = n_hist - 1
            while len(out) < a:
                end = self._latest_end(pat, extra, before)
                if end < 0:
                    break
                tok = self._virtual(extra, end)
                if tok not in out:
                    out.append(tok)
                before = end - 1
            if len(out) >= a:
                break
        return out[:a]

    def propose(self, k: int) -> List[int]:
        """Iterated-lookup chain draft over the synced history — identical
        output to ``propose_draft(self.tokens, k, ...)``."""
        if k <= 0 or len(self.tokens) < self.ngram_min + 1:
            return []
        out: List[int] = []
        while len(out) < k:
            cont = self.lookup(out, k - len(out))
            if not cont:
                break
            out.extend(cont)
        return out[:k]


@dataclasses.dataclass(frozen=True)
class PromptLookupDrafter:
    """Engine-facing drafter config: ``propose(history, k)`` wraps
    :func:`propose_draft` with this instance's n-gram window.

    The engine keeps one :class:`SuffixCache` per slot (see
    :meth:`make_cache`) and drafts through :meth:`propose_cached`, which
    indexes only the tokens emitted since the previous step; the uncached
    :meth:`propose` remains as the reference implementation the tests pin
    the cache against.

    Args:
      ngram_max: longest suffix n-gram matched first (default 3).
      ngram_min: shortest n-gram worth matching (default 1).
    """

    ngram_max: int = 3
    ngram_min: int = 1

    def __post_init__(self):
        if self.ngram_min < 1 or self.ngram_max < self.ngram_min:
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"[{self.ngram_min}, {self.ngram_max}]")

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        """Up to ``k`` drafted tokens for ``history`` (see
        :func:`propose_draft`)."""
        return propose_draft(history, k, self.ngram_max, self.ngram_min)

    def make_cache(self) -> SuffixCache:
        """A fresh per-slot incremental suffix table for this n-gram
        window."""
        return SuffixCache(self.ngram_max, self.ngram_min)

    def propose_cached(self, cache: SuffixCache, history: Sequence[int],
                       k: int) -> List[int]:
        """Same ``k``-token draft over ``history`` as :meth:`propose`
        but through the slot's incremental ``cache`` — O(new tokens)
        table work per step."""
        cache.sync(history)
        return cache.propose(k)


def accept_tokens(sampled: Sequence[int],
                  drafts: Sequence[int]) -> Tuple[List[int], int]:
    """Longest-matching-prefix acceptance for one slot (chain drafts).

    Args:
      sampled: the ``len(drafts) + 1`` tokens sampled in-graph from the
        verify dispatch's logits — ``sampled[j]`` is the token drawn (with
        the request's own PRNG stream at sample index ``base + j``) from
        the true distribution after fed token ``j``.
      drafts: the drafted tokens that were fed at positions ``1..k``.

    Returns:
      ``(emitted, accepted)``: the tokens this step emits — the accepted
      draft prefix plus one correction/bonus token, i.e. ``sampled[:a+1]``
      where ``a`` is the number of leading positions with
      ``sampled[j] == drafts[j]`` — and ``a`` itself.  Every emitted token
      is exactly what sequential decode would have sampled at its index,
      which is what makes speculative output bit-exact (see module doc).
    """
    a = 0
    while a < len(drafts) and int(sampled[a]) == int(drafts[a]):
        a += 1
    return [int(sampled[j]) for j in range(a + 1)], a


# ---------------------------------------------------------------------------
# token trees
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TreeDraft:
    """A flattened drafted token tree for one slot.

    Node ``i`` holds drafted token ``tokens[i]``; its parent is node
    ``parents[i]`` (``-1`` = child of the *anchor* — the slot's last
    emitted token, which is fed as the final chain row of the verify
    block); ``depths[i]`` is its 1-based distance from the anchor.  Nodes
    are topologically ordered (``parents[i] < i``), which lets the
    acceptance walk and the in-graph ancestor mask both run a single
    forward pass over the flat list.

    Args:
      tokens: drafted token per node.
      parents: parent node index per node (``-1`` = anchor child).
      depths: 1-based depth per node (anchor children are depth 1).
    """

    tokens: Tuple[int, ...]
    parents: Tuple[int, ...]
    depths: Tuple[int, ...]

    def __post_init__(self):
        n = len(self.tokens)
        if len(self.parents) != n or len(self.depths) != n:
            raise ValueError("tokens/parents/depths must be equally long")
        for i, (par, dep) in enumerate(zip(self.parents, self.depths)):
            if not -1 <= par < i:
                raise ValueError(
                    f"node {i}: parent {par} not topologically earlier")
            want = 1 if par < 0 else self.depths[par] + 1
            if dep != want:
                raise ValueError(f"node {i}: depth {dep} != {want}")

    @property
    def n(self) -> int:
        """Node count (the verify block adds this many tree rows)."""
        return len(self.tokens)

    @property
    def depth(self) -> int:
        """Deepest node's depth (0 for an empty tree)."""
        return max(self.depths, default=0)

    @classmethod
    def chain(cls, tokens: Sequence[int]) -> "TreeDraft":
        """The degenerate single-branch tree over the drafted ``tokens``:
        node ``i`` is the child of node ``i - 1``: the chain draft of
        :func:`propose_draft` as a tree."""
        toks = tuple(int(t) for t in tokens)
        return cls(toks, tuple(range(-1, len(toks) - 1)),
                   tuple(range(1, len(toks) + 1)))

    def path_tokens(self, path: Sequence[int]) -> List[int]:
        """The drafted tokens along a node-index path."""
        return [self.tokens[i] for i in path]


def accept_path(sampled: Sequence[int],
                tree: TreeDraft) -> Tuple[List[int], List[int]]:
    """Longest accepted root-to-leaf path acceptance for one slot.

    Args:
      sampled: ``tree.n + 1`` tokens sampled in-graph from the tree-verify
        logits — ``sampled[0]`` from the anchor row, ``sampled[1 + i]``
        from tree node ``i``, each drawn with the request's own PRNG
        stream at sample index ``base + depth(row)`` so a row's draw is
        exactly the draw sequential decode would make at that output
        index.
      tree: the drafted topology that was fed.

    Returns:
      ``(emitted, path)``: the emitted tokens — the sample at the anchor,
      then, while the sample matches one of the current node's children,
      the sample at that child (first matching child in node order) — and
      the accepted node-index path.  The final emitted token is the
      correction/bonus draw at the first mismatch (or at the deepest
      accepted node), so ``len(emitted) == len(path) + 1`` and every
      emitted token is bit-exact vs sequential decode (chain drafts reduce
      to :func:`accept_tokens` exactly).
    """
    emitted = [int(sampled[0])]
    path: List[int] = []
    cur = -1
    while True:
        nxt = -1
        for i in range(len(tree.tokens)):
            if tree.parents[i] == cur and tree.tokens[i] == emitted[-1]:
                nxt = i
                break
        if nxt < 0:
            break
        path.append(nxt)
        emitted.append(int(sampled[1 + nxt]))
        cur = nxt
    return emitted, path


@dataclasses.dataclass(frozen=True)
class NGramTreeDrafter:
    """Fan-out prompt-lookup drafting: a :class:`TreeDraft` whose level-1
    nodes are the top-``branch`` distinct continuations from the slot's
    suffix tables, with the rank-0 path extended chain-wise to full depth
    and every hedge node extended with its own top-1 continuation while
    the node budget lasts (main chain first — so at accept rates where a
    chain is optimal the tree *contains* that chain).

    Args:
      ngram_max: longest suffix n-gram matched first (default 3).
      ngram_min: shortest n-gram worth matching (default 1).
    """

    ngram_max: int = 3
    ngram_min: int = 1

    def __post_init__(self):
        if self.ngram_min < 1 or self.ngram_max < self.ngram_min:
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"[{self.ngram_min}, {self.ngram_max}]")

    def make_cache(self) -> SuffixCache:
        """A fresh per-slot incremental suffix table (shared layout with
        :class:`PromptLookupDrafter`)."""
        return SuffixCache(self.ngram_max, self.ngram_min)

    def propose_tree(self, cache: SuffixCache, history: Sequence[int],
                     nodes: int, branch: int, max_depth: int) -> TreeDraft:
        """Draft a tree of up to ``nodes`` nodes / ``max_depth`` depth /
        ``branch`` children per node for the slot whose (rolled-forward)
        history is ``history``; ``cache`` is the slot's suffix table and
        is synced in place."""
        cache.sync(history)
        if nodes <= 0 or max_depth <= 0 \
                or len(cache.tokens) < self.ngram_min + 1:
            return TreeDraft((), (), ())
        toks: List[int] = []
        pars: List[int] = []
        deps: List[int] = []
        paths: List[List[int]] = []            # token path per node

        def add(par: int, tok: int) -> int:
            toks.append(int(tok))
            pars.append(par)
            deps.append(1 if par < 0 else deps[par] + 1)
            paths.append(([] if par < 0 else paths[par]) + [int(tok)])
            return len(toks) - 1

        def extend_chain(par: int) -> None:
            """Grow ``par``'s rank-0 continuation chain to the budget."""
            while len(toks) < nodes:
                d = 0 if par < 0 else deps[par]
                if d >= max_depth:
                    return
                extra = [] if par < 0 else paths[par]
                cont = cache.lookup(extra, max_depth - d)
                if not cont:
                    return
                for t in cont:
                    if len(toks) >= nodes or (0 if par < 0
                                              else deps[par]) >= max_depth:
                        return
                    par = add(par, t)

        # main chain (identical to propose_draft's chain draft), then
        # hedges breadth-first — a bare ranked sibling at EVERY spine level
        # before any hedge grows its own continuation chain.  Depth-first
        # hedging would let the root hedge's extension eat the budget and
        # leave deep forks uncovered; breadth-first realizes the
        # branch-candidates-per-level shape the Lemma-3 expected-tokens
        # model prices (q = 1 - (1-p)^branch at each level).
        extend_chain(-1)
        spine = list(range(len(toks)))         # the main chain's node ids
        hedges: List[int] = []
        for par in [-1] + spine:
            if len(toks) >= nodes:
                break
            d = 0 if par < 0 else deps[par]
            if d >= max_depth:
                break
            extra = [] if par < 0 else paths[par]
            have = {toks[i] for i in range(len(toks))
                    if pars[i] == par}
            for tok in cache.topk_next(extra, branch):
                if len(toks) >= nodes:
                    break
                if tok in have:
                    continue
                have.add(tok)
                hedges.append(add(par, tok))
        for nid in hedges:                     # leftovers extend hedges
            if len(toks) >= nodes:
                break
            extend_chain(nid)
        return TreeDraft(tuple(toks), tuple(pars), tuple(deps))


@dataclasses.dataclass(frozen=True)
class DraftHeadDrafter:
    """Medusa-style drafting from the verify dispatch's own draft heads.

    The model side (``repro_torch.models.lm.draft_head_specs`` +
    ``verify_tree``) adds ``n_heads`` small residual-MLP heads over the
    slot's final hidden state — head ``h`` predicts the token at offset
    ``h + 2`` from the position it reads (offset ``+1`` is the ordinary
    ``lm_head`` sample) and the dispatch returns each head's top-``a``
    candidate tokens for every fed row.  No draft model, no second KV
    cache: the heads ride the same dispatch, the same page pool.

    The host keeps, per slot, the head candidates read at the *last
    accepted row* of the previous step and builds the next step's
    :class:`TreeDraft` from them: depth-1 nodes are head 0's top-``a``
    candidates for the token after the anchor, and each deeper level
    chains head ``d``'s candidates under the previous level's rank-0
    node (ranked siblings hedge the first guess; deeper levels follow
    the spine — the classic sparse medusa topology).

    Args:
      n_heads: draft heads the model was built with (tree depth budget).
    """

    n_heads: int = 4

    def __post_init__(self):
        if self.n_heads < 1:
            raise ValueError(f"need n_heads >= 1, got {self.n_heads}")

    def propose_tree(self, head_top: Optional[Sequence[Sequence[int]]],
                     nodes: int, branch: int, max_depth: int) -> TreeDraft:
        """Build the tree from ``head_top`` — per head, the ranked
        candidate tokens read at the previous step's last accepted row
        (``None`` right after prefill / (re-)admission: no prediction
        yet, draft nothing).  Level ``d`` keeps the first ``branch``
        candidates of head ``d`` (deduped within the level), capped at
        ``nodes`` total nodes and ``max_depth`` levels."""
        if head_top is None or len(head_top) == 0 or nodes <= 0 \
                or max_depth <= 0:
            return TreeDraft((), (), ())
        toks: List[int] = []
        pars: List[int] = []
        deps: List[int] = []
        spine = -1
        for d, cands in enumerate(head_top[:max_depth]):
            if len(toks) >= nodes:
                break
            nxt_spine = -1
            seen: set = set()
            for rank, tok in enumerate(cands[:branch]):
                if len(toks) >= nodes or tok in seen:
                    continue
                seen.add(int(tok))
                toks.append(int(tok))
                pars.append(spine)
                deps.append(d + 1)
                if rank == 0:
                    nxt_spine = len(toks) - 1
            if nxt_spine < 0:
                break
            spine = nxt_spine
        return TreeDraft(tuple(toks), tuple(pars), tuple(deps))


# ---------------------------------------------------------------------------
# Lemma-3 reconfigurator: chain-K vs tree-(a, d) expected tokens/dispatch
# ---------------------------------------------------------------------------

def expected_tokens_chain(accept: float, k: int) -> float:
    """Closed-form expected emitted tokens of one K-chain verify dispatch
    at per-candidate accept probability ``accept``: the accepted prefix is
    geometric, so ``E = sum_{j=0..k} p^j = (1 - p^(k+1)) / (1 - p)`` —
    ``k + 1`` as ``p -> 1``, ``1`` as ``p -> 0``."""
    p = min(max(float(accept), 0.0), 1.0)
    return float(sum(p ** j for j in range(int(k) + 1)))


def tree_depth(nodes: int, branch: int) -> int:
    """Depth of the fullest ``branch``-ary tree that fits in ``nodes``
    nodes (a 1-ary "tree" is a chain: depth = nodes)."""
    nodes, branch = int(nodes), int(branch)
    if nodes <= 0:
        return 0
    if branch <= 1:
        return nodes
    d, used, width = 0, 0, branch
    while used + width <= nodes:
        used += width
        d += 1
        width *= branch
    return max(d, 1)


def expected_tokens_tree(accept: float, nodes: int, branch: int) -> float:
    """Closed-form expected emitted tokens of one tree verify dispatch:
    with ``branch`` independent delta candidates per level, a level
    advances with ``q = 1 - (1 - p)^branch >= p`` and the accepted path
    is geometric in ``q`` down to depth ``d = nodes // branch`` — the
    spine-with-hedges shape the engine drafts (a ``branch``-wide fan per
    spine level costs ``branch`` nodes/level, so the budget buys
    ``nodes / branch`` hedged levels; ``branch = 1`` degenerates to the
    chain, ``d = nodes``).  ``E = sum_{j=0..d} q^j``.  The fan-out trades
    depth for hedging — ahead of the chain at low accept, behind it
    (``d < k`` at equal node budget) as ``accept -> 1`` — the Lemma-3
    crossover."""
    p = min(max(float(accept), 0.0), 1.0)
    b = max(int(branch), 1)
    q = 1.0 - (1.0 - p) ** b
    d = max(1, int(nodes) // b) if nodes > 0 else 0
    return float(sum(q ** j for j in range(d + 1)))


def pick_shape(accept_chain: float, accept_tree: float, k: int,
               nodes: int, branch: int, chain_cost_s: float = 1.0,
               tree_cost_s: float = 1.0) -> str:
    """The reconfigurator decision: ``"chain"`` or ``"tree"``, whichever
    maximizes expected tokens per second — expected tokens per dispatch
    (closed forms above: chain of depth ``k`` at rate ``accept_chain``
    vs a ``nodes``-node, ``branch``-way tree at rate ``accept_tree``)
    over the measured per-dispatch cost of each shape (``chain_cost_s``
    / ``tree_cost_s``; default equal costs, i.e. both shapes ride the
    same wide dispatch and only expected tokens matter).

    Each shape is priced at its *own* per-candidate accept estimate: the
    two shapes may draft through different predictors (n-gram chain vs
    draft-head tree), so a single shared rate would let one drafter's
    streak mask the other's misses and the decision would oscillate.
    With one drafter, pass the same estimate twice and this reduces to
    the pure Lemma-3 crossover.  Ties go to the chain (narrower KV write
    footprint)."""
    ec = expected_tokens_chain(accept_chain, k) \
        / max(float(chain_cost_s), 1e-12)
    et = expected_tokens_tree(accept_tree, nodes, branch) \
        / max(float(tree_cost_s), 1e-12)
    return "tree" if et > ec else "chain"


def per_candidate_accept(successes: int, trials: int,
                         mean_branch: float = 1.0) -> float:
    """Invert a measured per-*level* accept fraction (``successes``
    accepted levels out of ``trials`` tested) back to the per-candidate
    probability the closed forms are parameterized by: with ``a``
    candidates per level, ``q = 1 - (1 - p)^a``, so
    ``p = 1 - (1 - q)^(1/a)``.  ``mean_branch`` is the average tested
    fan-out (1 for chain steps, where ``p == q``)."""
    if trials <= 0:
        return 0.0
    q = min(max(successes / trials, 0.0), 1.0)
    a = max(float(mean_branch), 1.0)
    if q >= 1.0:
        return 1.0
    return 1.0 - (1.0 - q) ** (1.0 / a)
