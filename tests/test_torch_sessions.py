"""The port's multi-turn sessions against the JAX package.

``SessionStore`` runs the same op sequences as the JAX package's and must
give the same results.  The engine serves conversations of several turns on
fewer slots than conversations, so slots turn over between turns, at the
reduced ``llama3.2-3b`` config (fp32, ``n_kv_heads=2``) with the JAX
engine's weights: once with a pool large enough that no snapshot is
dropped, once with a pool so small that reclaim drops snapshots.  Tokens,
shared counters, page tables and refcounts must equal the JAX engine's."""
import numpy as np
import pytest

from repro.serve import sessions as jsessions
from repro_torch.serve import sessions as tsessions
from test_torch_prefix import _both, _model, _trace


def _store_ops():
    def snap(row, covered):
        def op(s):
            sess = s.ensure("b")
            sess.row, sess.covered = np.asarray(row), covered
            return sess.turns
        return op

    return [
        lambda s: len(s), lambda s: "a" in s, lambda s: s.get("a"),
        lambda s: s.ensure("a").history, lambda s: "a" in s,
        lambda s: s.ensure("b").covered, lambda s: s.lru_snapshots(),
        snap([3, 4, 0], 20),
        lambda s: [x.conv_id for x in s.lru_snapshots()],
        lambda s: s.snapshot_pages(),
        lambda s: setattr(s.ensure("a"), "row", np.asarray([5])),
        lambda s: [x.conv_id for x in s.lru_snapshots()],
        lambda s: s.ensure("b").covered,
        lambda s: [x.conv_id for x in s.lru_snapshots()],
        lambda s: sorted(s.snapshot_pages()),
        lambda s: s.take_snapshot(s.get("b")),
        lambda s: (s.get("b").row, s.get("b").covered),
        lambda s: s.take_snapshot(s.get("b")),
        lambda s: s.pop("a"), lambda s: s.pop("a"), lambda s: len(s),
        lambda s: s.drops,
    ]


def test_session_store_matches_reference():
    want = _trace(jsessions.SessionStore, _store_ops())
    got = _trace(tsessions.SessionStore, _store_ops())
    assert got == want
    sess = tsessions.Session("c")
    assert (sess.history, sess.row, sess.covered, sess.turns) == \
        ([], None, 0, 0)


@pytest.fixture(scope="module")
def model():
    return _model(seed=3)


CONVS, TURNS, REPLY = 3, 3, 4


def _conversation(eng, turns, released):
    """Every conversation's turns in rounds (three conversations on two
    slots: slots turn over between turns), then end every session and
    record which page references that released."""
    reqs = []
    for k in range(TURNS):
        for c in range(CONVS):
            reqs.append(eng.submit_turn(f"user{c}", turns[c][k], REPLY))
        eng.run()
    before = np.asarray(eng.pool.refcount).copy()
    snap = np.bincount(eng.sessions.snapshot_pages(),
                       minlength=eng.pool.num_pages)
    assert sum(eng.end_session(f"user{c}") for c in range(CONVS)) == CONVS
    assert not eng.end_session("user0")
    released.append((before - np.asarray(eng.pool.refcount)).tolist()
                    == snap.tolist())
    return reqs


@pytest.mark.parametrize("pool_pages,drops", [(40, False), (9, True)])
def test_sessions_match_reference(model, pool_pages, drops):
    rng = np.random.default_rng(5)
    vocab = model[0].vocab
    turns = [[rng.integers(0, vocab, (20 if k == 0 else 12,)).tolist()
              for k in range(TURNS)] for _ in range(CONVS)]
    released = []
    _, teng, _, treqs = _both(
        model, lambda eng: _conversation(eng, turns, released),
        max_slots=2, max_seq=96, prefill_chunk=16, page_size=16,
        pool_pages=pool_pages)
    assert released == [True, True]
    st = teng.stats_summary()
    assert st["session_turns"] == CONVS * TURNS
    assert all(len(r.generated) == REPLY for r in treqs)
    assert st["sessions_live"] == 0 and not teng.sessions.snapshot_pages()
    if drops:
        assert st["session_snapshot_drops"] > 0
    else:
        assert st["session_snapshot_drops"] == 0
        # every returning turn reused its history, from its snapshot or,
        # when its previous row is still resident, from the trie
        assert st["session_hits"] + st["prefix_hits"] == \
            CONVS * (TURNS - 1)
        assert st["session_hits"] > 0
    # each turn's prompt is the whole history so far
    for c in range(CONVS):
        mine = treqs[c::CONVS]
        for k in range(1, TURNS):
            prev = mine[k - 1]
            assert list(mine[k].prompt) == \
                list(prev.prompt) + prev.generated + turns[c][k]


def test_session_snapshot_survives_slot_turnover(model):
    """One slot: the conversation's row is overwritten by other traffic
    between turns, yet the next turn re-admits its history from the
    snapshot (a session hit, not a trie hit), with or without the prefix
    cache."""
    rng = np.random.default_rng(6)
    vocab = model[0].vocab
    first, second = (rng.integers(0, vocab, (n,)).tolist() for n in (24, 9))
    other = rng.integers(0, vocab, (30,)).tolist()

    def drive(eng):
        r1 = eng.submit_turn("c", first, REPLY)
        eng.run()
        r2 = eng.submit(other, REPLY)
        eng.run()
        r3 = eng.submit_turn("c", second, REPLY)
        eng.run()
        return [r1, r2, r3]

    knobs = dict(max_slots=1, max_seq=96, prefill_chunk=16, page_size=16)
    _, teng, _, treqs = _both(model, drive, **knobs)
    st = teng.stats_summary()
    assert st["session_hits"] == 1 and st["prefix_hits"] == 0
    assert st["session_reused_tokens"] == len(first) + REPLY - 1
    _, off, _, oreqs = _both(model, drive, prefix_cache=False, **knobs)
    assert off.stats["session_hits"] == 1 and off.prefix is None
    assert [r.generated for r in oreqs] == [r.generated for r in treqs]
