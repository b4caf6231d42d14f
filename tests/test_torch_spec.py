"""The port's ``serve/spec.py`` against the JAX package's, function for
function.

``repro_torch.serve.spec`` is a copy of the pure-Python
``repro.serve.spec``: each scenario below runs the cases of the JAX
package's own tests (``tests/test_spec.py:50-100``,
``tests/test_spec_tree.py:45-275``) on both modules and records every
return value, or the type and message of every error; the two records
must be equal.  The seeded sweeps draw histories, trees and samples with
numpy and compare the two modules on each."""
import numpy as np
import pytest

from repro.serve import spec as jspec
from repro_torch.serve import spec as tspec

MODULES = {"jax": jspec, "torch": tspec}


def _catch(fn):
    try:
        return fn()
    except Exception as e:                  # noqa: BLE001 - compared below
        return ("raise", type(e).__name__, str(e))


def _tree(t):
    return None if t is None else (t.tokens, t.parents, t.depths)


# ---------------------------------------------------------------------------
# the JAX package's cases, each returning its observable values
# ---------------------------------------------------------------------------

def propose_draft_cases(m):
    return [m.propose_draft([5, 7, 8, 9, 1, 2, 7, 8], 3),
            m.propose_draft([1, 2, 3, 4, 9, 2, 3, 1, 2, 3], 1),
            m.propose_draft([4, 5, 6] * 4, 8),
            m.propose_draft([], 4), m.propose_draft([3], 4),
            m.propose_draft([1, 2, 3], 0), m.propose_draft([9, 9], 4),
            m.propose_draft([1, 2, 3, 4, 5], 4),
            m.propose_draft([1, 2, 1, 2, 1], 3, ngram_max=1)]


def drafter_validation(m):
    return [_catch(lambda: m.PromptLookupDrafter(ngram_max=0)),
            _catch(lambda: m.PromptLookupDrafter(ngram_max=2, ngram_min=3)),
            m.PromptLookupDrafter(ngram_max=2).propose([4, 5, 6] * 3, 4)]


def accept_tokens_cases(m):
    return [m.accept_tokens([7, 8, 9, 4], [7, 8, 9]),
            m.accept_tokens([7, 5, 9, 4], [7, 8, 9]),
            m.accept_tokens([3, 5, 9, 4], [7, 8, 9]),
            m.accept_tokens([3], [])]


def tree_draft_validation(m):
    return [_catch(lambda: m.TreeDraft((1, 2), (-1,), (1,))),
            _catch(lambda: m.TreeDraft((1, 2), (-1, 2), (1, 2))),
            _catch(lambda: m.TreeDraft((1, 2), (-1, 0), (1, 3))),
            _catch(lambda: m.TreeDraft((1,), (-1,), (2,)))]


def tree_draft_chain(m):
    t = m.TreeDraft.chain([5, 6, 7])
    empty = m.TreeDraft((), (), ())
    return [_tree(t), t.n, t.depth, t.path_tokens([0, 2]), empty.n,
            empty.depth]


def accept_path_branch(m):
    tree = m.TreeDraft((3, 5, 7), (-1, -1, 1), (1, 1, 2))
    return [m.accept_path([5, 99, 7, 4], tree),
            m.accept_path([3, 8, 7, 4], tree),
            m.accept_path([6, 8, 7, 4], tree)]


def suffix_cache_counts(m):
    c = m.SuffixCache()
    c.sync([1, 2, 3])
    c.sync([1, 2, 3, 4, 5])
    out = [c.indexed_tokens, c.invalidations]
    c.sync([1, 2, 9])
    out += [c.invalidations, c.tokens]
    hist = [1, 2, 3, 0, 1, 2, 4, 0, 1, 2]
    c = m.SuffixCache()
    c.sync(hist)
    return out + [c.topk_next([], 2), c.lookup([], 1), c.propose(3)]


def ngram_tree(m):
    d = m.NGramTreeDrafter()
    hist = [1, 2, 3, 9, 0, 1, 2, 4, 8, 0, 1, 2]
    return [_tree(d.propose_tree(d.make_cache(), hist, nodes=6, branch=2,
                                 max_depth=4)),
            _tree(d.propose_tree(d.make_cache(), [1, 2, 3], 0, 2, 2)),
            _tree(d.propose_tree(d.make_cache(), [], 4, 2, 2)),
            _tree(d.propose_tree(d.make_cache(), [7, 7, 7, 7, 7], 3, 2, 8)),
            _catch(lambda: m.NGramTreeDrafter(ngram_max=0))]


def draft_head_tree(m):
    d = m.DraftHeadDrafter(n_heads=3)
    head_top = [[10, 11, 12], [20, 20, 21], [30, 31, 32]]
    return [_tree(d.propose_tree(head_top, nodes=8, branch=2, max_depth=3)),
            _tree(d.propose_tree(None, 8, 2, 3)),
            _tree(d.propose_tree([], 8, 2, 3)),
            _tree(d.propose_tree(head_top, 8, 2, 0)),
            _tree(d.propose_tree(head_top, 3, 3, 3)),
            _catch(lambda: m.DraftHeadDrafter(n_heads=0))]


def closed_forms(m):
    out = [m.expected_tokens_chain(1.0, 5), m.expected_tokens_chain(0.0, 5),
           m.expected_tokens_chain(0.5, 2), m.expected_tokens_tree(0.5, 4, 2),
           m.tree_depth(0, 2), m.tree_depth(6, 1), m.tree_depth(6, 2),
           m.tree_depth(12, 3)]
    for p in (0.0, 0.3, 0.9, 1.0):
        out += [m.expected_tokens_tree(p, 5, 1), m.expected_tokens_tree(
            p, 12, 3)]
    return out


def pick_shape_cases(m):
    out = []
    for budget in range(2, 17):
        for branch in (2, 3, 4):
            out.append([m.pick_shape(q, q, budget, budget, branch)
                        for q in np.linspace(0.01, 0.99, 25)])
            out.append([m.pick_shape(0.05, 0.95, budget, budget, branch),
                        m.pick_shape(0.95, 0.05, budget, budget, branch)])
    out.append([m.pick_shape(0.5, 0.5, 4, 4, 1, chain_cost_s=1.0,
                             tree_cost_s=2.0),
                m.pick_shape(0.5, 0.5, 4, 4, 1, chain_cost_s=2.0,
                             tree_cost_s=1.0)])
    return out


def per_candidate(m):
    out = [m.per_candidate_accept(0, 0), m.per_candidate_accept(5, 5, 2.0)]
    for p in (0.1, 0.4, 0.8):
        for b in (1.0, 2.0, 3.0):
            q = 1 - (1 - p) ** b
            out.append(m.per_candidate_accept(int(q * 1e6), int(1e6),
                                              mean_branch=b))
    return out


SCENARIOS = [propose_draft_cases, drafter_validation, accept_tokens_cases,
             tree_draft_validation, tree_draft_chain, accept_path_branch,
             suffix_cache_counts, ngram_tree, draft_head_tree, closed_forms,
             pick_shape_cases, per_candidate]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_reference(scenario):
    want = scenario(jspec)
    assert scenario(tspec) == want
    assert want


def test_closed_forms_keep_their_limits():
    """The port's own values at the limits the JAX package's tests pin."""
    assert tspec.expected_tokens_chain(1.0, 5) == pytest.approx(6.0)
    assert tspec.expected_tokens_tree(0.5, 4, 2) == \
        pytest.approx(1 + 0.75 + 0.75 ** 2)
    assert tspec.pick_shape(0.99, 0.99, 8, 8, 2) == "chain"
    assert tspec.pick_shape(0.05, 0.05, 8, 8, 2) == "tree"


# ---------------------------------------------------------------------------
# seeded sweeps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_accept_path_and_tokens_sweep(seed):
    """Chains through both rules, and random trees through
    ``accept_path``, on both modules."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        draft = rng.integers(0, 4, int(rng.integers(0, 6))).tolist()
        sampled = rng.integers(0, 4, len(draft) + 1).tolist()
        got = [m.accept_path(sampled, m.TreeDraft.chain(draft))
               for m in (jspec, tspec)]
        assert got[0] == got[1]
        assert tspec.accept_tokens(sampled, draft) == \
            jspec.accept_tokens(sampled, draft)
        n = int(rng.integers(1, 9))
        parents, depths = [], []
        for i in range(n):
            par = int(rng.integers(-1, i))
            parents.append(par)
            depths.append(1 if par < 0 else depths[par] + 1)
        toks = rng.integers(0, 4, n).tolist()
        samp = rng.integers(0, 4, n + 1).tolist()
        got = [m.accept_path(samp, m.TreeDraft(toks, parents, depths))
               for m in (jspec, tspec)]
        assert got[0] == got[1]


@pytest.mark.parametrize("seed", range(4))
def test_suffix_cache_and_drafters_sweep(seed):
    """An extend / rewind / diverge walk over both modules' suffix caches:
    after every sync the chain proposals, top-k hedges, n-gram trees and
    invalidation counts are equal, and the cached chain equals the
    uncached ``propose_draft``."""
    rng = np.random.default_rng(100 + seed)
    caches = {k: m.SuffixCache() for k, m in MODULES.items()}
    tree_d = {k: m.NGramTreeDrafter() for k, m in MODULES.items()}
    chain_d = {k: m.PromptLookupDrafter() for k, m in MODULES.items()}
    hist = rng.integers(0, 6, 12).tolist()
    for _ in range(12):
        op = int(rng.integers(0, 3))
        if op == 0:
            hist = hist + rng.integers(0, 6, 3).tolist()
        elif op == 1:
            hist = hist[:max(len(hist) - 2, 1)]
        else:
            hist = rng.integers(0, 6, 10).tolist()
        seen = {}
        for k, m in MODULES.items():
            c = caches[k]
            c.sync(hist)
            seen[k] = [c.invalidations, c.indexed_tokens, c.tokens,
                       [c.propose(kk) for kk in (1, 4)],
                       c.topk_next([], 3), c.lookup([hist[-1]], 2),
                       chain_d[k].propose_cached(c, hist, 4),
                       _tree(tree_d[k].propose_tree(c, hist, 6, 2, 3))]
        assert seen["torch"] == seen["jax"]
        assert seen["torch"][3] == [jspec.propose_draft(hist, kk)
                                    for kk in (1, 4)]


@pytest.mark.parametrize("seed", range(3))
def test_head_trees_and_shapes_sweep(seed):
    """Draft-head trees from random candidate tables, and the shape pick
    at random accept rates and budgets, on both modules."""
    rng = np.random.default_rng(200 + seed)
    for _ in range(40):
        h, a = int(rng.integers(1, 5)), int(rng.integers(1, 4))
        top = rng.integers(0, 5, (h, a)).tolist()
        nodes, branch = int(rng.integers(0, 10)), int(rng.integers(1, 4))
        depth = int(rng.integers(0, 5))
        got = [_tree(m.DraftHeadDrafter(n_heads=h).propose_tree(
            top, nodes, branch, depth)) for m in (jspec, tspec)]
        assert got[0] == got[1]
        pc, pt = rng.random(2)
        k = int(rng.integers(1, 9))
        got = [m.pick_shape(pc, pt, k, max(nodes, 1), branch)
               for m in (jspec, tspec)]
        assert got[0] == got[1]
        s, t = int(rng.integers(0, 20)), int(rng.integers(0, 20))
        mb = 1.0 + float(rng.random())
        assert tspec.per_candidate_accept(min(s, t), t, mb) == \
            jspec.per_candidate_accept(min(s, t), t, mb)
