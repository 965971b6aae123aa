"""The churn path of the port's engines (plain kernels on the CPU)
against the JAX package's: the delta automaton with its fold, the
background rebuild and the encode arena.

The same seeded churn (numpy: inserts, re-inserts of a changed filter,
deletes, deletes and re-inserts) drives the port's `MatchEngine` and
`ShardedMatchEngine` and the JAX package's, with small thresholds that
the sequence crosses many times (rebuild 40, fold 16).  Every window's
fid sets equal the reference's and a brute-force oracle's.  With the
fold pinned synchronous (``_fold_async = False``) and the builder
joined after each call, the delta automaton's tables, the base's tables
and the token dictionary equal the reference's bit for bit; a filter
holding every word is inserted first, so that the builder and the fold
never grow the dictionary concurrently (which would order token ids by
thread timing).

Then the reference's own churn cases (tests/test_match_engine.py) and
tracepoint races (tests/test_tp_races.py) run on the port with its own
`tp`, and a fold failure surfaces once on the caller's thread.  Every
thread join has a timeout; nothing sleeps to wait for a thread."""

import threading

import numpy as np
import pytest
import torch

from emqx_tpu import topic as RT
from emqx_tpu.engine import MatchEngine as RefEngine
from emqx_tpu.parallel import sharded as ref_sh

from emqx_tpu_torch import tp
from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.config import BrokerEngineConfig
from emqx_tpu_torch.engine import MatchEngine, _EncArena
from emqx_tpu_torch.ops.dictionary import TokenDict
from emqx_tpu_torch.ops.trie_host import HostTrie
from emqx_tpu_torch.parallel import sharded as sh

WORDS = ["a", "b", "c", "", "dev", "$SYS", "x"]
# a wildcard filter holding every word: inserted first, it puts the
# whole alphabet into the dictionary at the first build
ALPHABET = "/".join(WORDS) + "/+"
CPU8 = [torch.device("cpu")] * 8
JOIN_S = 30.0


def _filter(rng) -> str:
    while True:
        depth = int(rng.integers(1, 6))
        ws = []
        for i in range(depth):
            r = rng.random()
            if r < 0.2:
                ws.append("+")
            elif r < 0.3 and i == depth - 1:
                ws.append("#")
            else:
                ws.append(WORDS[int(rng.integers(len(WORDS)))])
        flt = "/".join(ws)
        if flt:
            return flt


def _topic(rng) -> str:
    return "/".join(WORDS[int(k)] for k in
                    rng.integers(0, len(WORDS), int(rng.integers(1, 7))))


def _oracle(live, topic):
    ws = RT.words(topic)
    return {f for f, flt in live.items()
            if RT.match_words(ws, RT.words(flt))}


def _join(eng) -> None:
    for t in (eng._build_thread, eng._fold_thread):
        if t is not None:
            t.join(JOIN_S)
            assert not t.is_alive(), "a builder thread did not finish"


def _drain(eng) -> None:
    """Wait for the fold in flight, if any (a bounded join)."""
    _join(eng)
    assert not eng._folding


def _check_window(engines, live, rng, n=40):
    topics = [_topic(rng) for _ in range(n)]
    for flt in list(live.values())[:20]:
        topics.append("/".join(WORDS[int(rng.integers(3))] if w in "+#"
                               else w for w in flt.split("/")))
    got = [e.match_batch(topics) for e in engines]
    for i, t in enumerate(topics):
        want = _oracle(live, t)
        assert all(g[i] == want for g in got), (
            t, [sorted(g[i]) for g in got], sorted(want))


def _same_tables(port, ref) -> None:
    assert port._tdict._ids == ref._tdict._ids
    if ref._daut is None:
        assert port._daut is None
    else:
        for k in ("fp_rows", "node_rows", "code_off", "code_idx"):
            assert np.array_equal(getattr(port._daut, k),
                                  getattr(ref._daut, k)), k
        assert port._daut.salt == ref._daut.salt
        assert port._daut.kernel_levels == ref._daut.kernel_levels == 9
        assert port._dfid_arr.tolist() == ref._dfid_arr.tolist()
        assert port._daut_fids == ref._daut_fids
    if isinstance(port, sh.ShardedMatchEngine):
        for a, b in zip(port.index.tables, ref.index.tables):
            assert np.array_equal(a, b)
        assert port.index.offsets == ref.index.offsets
    else:
        for k in ("fp_rows", "node_rows", "code_off", "code_idx"):
            assert np.array_equal(getattr(port._aut, k),
                                  getattr(ref._aut, k)), k
    assert port._fid_arr.tolist() == ref._fid_arr.tolist()
    ps, rs = port.index_stats(), ref.index_stats()
    assert ps == {k: rs[k] for k in ps}


def _pair(kind, background):
    kw = dict(max_levels=8, f_width=4, m_cap=16, rebuild_threshold=40,
              background_rebuild=background)
    if kind == "single":
        port = MatchEngine(device="cpu", delta_aut_threshold=16, **kw)
        ref = RefEngine(use_device=True, delta_aut_threshold=16, **kw)
    else:
        port = sh.ShardedMatchEngine(
            sh.make_mesh(8, sub=4, devices=CPU8), **kw)
        ref = ref_sh.ShardedMatchEngine(ref_sh.make_mesh(4), **kw)
        port.delta_aut_threshold = ref.delta_aut_threshold = 16
    for e in (port, ref):
        e._fold_async = False
        e.insert(ALPHABET, 10**6)
        e.rebuild()
    return port, ref


@pytest.mark.parametrize("kind,background,seed", [
    ("single", False, 0), ("single", True, 1),
    ("sharded", False, 2), ("sharded", True, 3),
])
def test_churn_equals_reference(kind, background, seed):
    rng = np.random.default_rng(seed)
    port, ref = _pair(kind, background)
    live = {10**6: ALPHABET}
    next_fid = 0
    for step in range(420):
        r = rng.random()
        if r < 0.5 or len(live) < 10:
            flt, fid = _filter(rng), next_fid
            next_fid += 1
            ops = [("insert", flt, fid)]
        else:
            fid = int(rng.choice(sorted(live)))
            if r < 0.7:  # a re-insert of a changed filter
                ops = [("insert", _filter(rng), fid)]
            elif r < 0.85:
                ops = [("delete", fid)]
            else:  # deleted and inserted again
                ops = [("delete", fid), ("insert", live[fid], fid)]
        for op in ops:
            for e in (port, ref):
                if op[0] == "insert":
                    e.insert(op[1], op[2])
                else:
                    assert e.delete(op[1])
                _join(e)
            if op[0] == "insert":
                live[op[2]] = op[1]
            else:
                del live[op[1]]
        if step % 30 == 29:
            _check_window((port, ref), live, rng)
            _same_tables(port, ref)
    assert port.counters["folds"] >= 3
    assert port.counters["rebuilds"] >= 3
    assert port.counters["daut_windows"] >= 3
    port.rebuild()
    ref.rebuild()
    _check_window((port, ref), live, rng)
    _same_tables(port, ref)


@pytest.mark.parametrize("kind", ["single", "sharded"])
def test_insert_many_windows_equal_reference(kind):
    """Churn in `insert_many` windows (the broker's subscribe batches),
    a fid listed twice in one window keeping its last filter."""
    rng = np.random.default_rng(7)
    port, ref = _pair(kind, False)
    live = {10**6: ALPHABET}
    for step in range(12):
        pairs = [(_filter(rng), int(f)) for f in rng.integers(0, 150, 24)]
        for e in (port, ref):
            e.insert_many(pairs)
        live.update((fid, flt) for flt, fid in pairs)
        for fid in rng.choice(sorted(live), 4, replace=False):
            fid = int(fid)
            assert port.delete(fid) == ref.delete(fid)
            live.pop(fid)
        _check_window((port, ref), live, rng, n=20)
        _same_tables(port, ref)
    assert port.counters["folds"] >= 2


def test_insert_many_duplicate_fid_last_wins():
    eng = MatchEngine(device="cpu", max_levels=8, rebuild_threshold=10**9,
                      delta_aut_threshold=10**9)
    eng.insert_many([("a/+", 1), ("b/+", 1)])
    assert eng.match("a/x") == set()
    assert eng.match("b/x") == {1}
    eng.insert_many([("c/+", 1), ("d/+", 1), ("e/+", 2)])
    assert eng.match("c/x") == set()
    assert eng.match("d/x") == {1}
    assert eng.match("e/x") == {2}
    with pytest.raises(ValueError):
        eng.insert_many([("ok/+", 20_000), ("bad/#/mid", 20_001)])
    assert 20_000 not in eng._by_fid


# ------------------------------------ the reference's own churn cases


def _churn_engine(**kw):
    kw.setdefault("max_levels", 8)
    kw.setdefault("rebuild_threshold", 10**9)
    return MatchEngine(device="cpu", **kw)


@pytest.mark.parametrize("seed", range(2))
def test_churn_delta_and_delete(seed):
    """Mutations after a rebuild are visible without a rebuild."""
    rng = np.random.default_rng(1000 + seed)
    eng = _churn_engine()
    live, fid = {}, 0
    for round_ in range(4):
        for _ in range(80):
            flt = _filter(rng)
            eng.insert(flt, fid)
            live[fid] = flt
            fid += 1
        if round_ == 1:
            eng.rebuild()
        for victim in list(live)[::3]:
            eng.delete(victim)
            del live[victim]
        _check_window((eng,), live, rng)


def test_reinsert_changed_filter_after_rebuild():
    eng = _churn_engine()
    eng.insert("a/+", 1)
    eng.rebuild()
    eng.insert("b/+", 1)
    assert eng.match("a/x") == set()
    assert eng.match("b/x") == {1}
    eng.rebuild()
    assert eng.match("a/x") == set()
    assert eng.match("b/x") == {1}


def test_delete_then_reinsert_same_filter_after_rebuild():
    eng = _churn_engine()
    eng.insert("a/+", 1)
    eng.rebuild()
    eng.delete(1)
    assert eng.match("a/x") == set()
    eng.insert("a/+", 1)
    assert eng.match("a/x") == {1}


def test_background_rebuild_no_stop_the_world():
    """Mutations during a background rebuild stay correct through the
    swap; the insert path never runs a build."""
    rng = np.random.default_rng(7)
    eng = _churn_engine(background_rebuild=True, rebuild_threshold=64)
    live, fid = {}, 0
    for round_ in range(6):
        for _ in range(100):
            flt = _filter(rng)
            eng.insert(flt, fid)
            live[fid] = flt
            fid += 1
        for victim in rng.choice(sorted(live), 10, replace=False):
            eng.delete(int(victim))
            del live[int(victim)]
        _check_window((eng,), live, rng, n=20)
    _join(eng)
    _check_window((eng,), live, rng)
    assert eng.counters["rebuilds"] >= 2
    assert eng.index_stats()["building"] is False


@pytest.mark.parametrize("seed", range(2))
def test_delta_automaton_churn_equivalence(seed):
    """Sustained churn through base + delta automaton + residual,
    with deletes of base and delta-automaton entries, and a rebuild
    that drops the delta tier."""
    rng = np.random.default_rng(2000 + seed)
    eng = _churn_engine(delta_aut_threshold=32)
    live, fid, built_delta = {}, 0, False
    for round_ in range(5):
        for _ in range(100):
            flt = _filter(rng)
            eng.insert(flt, fid)
            live[fid] = flt
            fid += 1
        _drain(eng)
        built_delta = built_delta or eng._daut is not None
        if round_ == 0:
            eng.rebuild()
        if round_ == 3:
            for victim in list(live)[::2]:
                eng.delete(victim)
                del live[victim]
        _check_window((eng,), live, rng)
    assert built_delta
    eng.rebuild()
    assert eng._daut is None
    _check_window((eng,), live, rng)


def test_delta_fold_residual_bound():
    """The host residual stays geometrically bounded while the delta
    folds, and the delta automaton keeps few table shapes."""
    eng = _churn_engine(delta_aut_threshold=64)
    eng._fold_async = False
    shapes = set()
    for i in range(3000):
        eng.insert(f"churn/{i % 97}/+/x{i}", i)
        assert eng._residual_count <= max(64, len(eng._delta) // 2), i
        if eng._daut is not None:
            shapes.add((eng._daut.node_rows.shape, eng._daut.kernel_levels))
    assert eng._daut is not None
    assert len(eng._daut_fids) + eng._residual_count >= 3000 - 64
    assert len(shapes) <= 4


def test_async_fold_churn_equivalence():
    """Random churn with asynchronous folds: once the folds drain,
    every window equals the oracle."""
    rng = np.random.default_rng(1234)
    eng = _churn_engine(delta_aut_threshold=32)
    live, fid = {}, 0
    for _ in range(2000):
        r = rng.random()
        if r < 0.70 or not live:
            fid += 1
            flt = _filter(rng)
            eng.insert(flt, fid)
            live[fid] = flt
        elif r < 0.85:
            victim = int(rng.choice(sorted(live)))
            eng.delete(victim)
            del live[victim]
        else:
            victim = int(rng.choice(sorted(live)))
            flt = _filter(rng)
            eng.insert(flt, victim)
            live[victim] = flt
    _drain(eng)
    _check_window((eng,), live, rng, n=100)
    assert eng._daut is not None


def test_reinserted_fid_survives_fold():
    """Tombstones are per generation: a fid re-pointed at another
    filter is masked in the base and served by the delta automaton."""
    eng = _churn_engine(delta_aut_threshold=16)
    eng._fold_async = False
    for i in range(40):
        eng.insert(f"seed/{i}/+", i)
    eng.rebuild()
    eng.insert("moved/here/#", 7)
    assert eng.match("moved/here/x") == {7}
    assert 7 not in eng.match("seed/7/q")
    for i in range(100, 140):
        eng.insert(f"churn/{i}/+", i)
    assert eng._daut is not None and 7 in eng._daut_fids
    assert eng.match("moved/here/x") == {7}
    assert 7 not in eng.match("seed/7/q")
    eng.delete(8)
    for i in range(200, 240):
        eng.insert(f"churn2/{i}/+", i)
    assert 8 not in eng.match("seed/8/q")


# ------------------------------------------------- tracepoint races


def _race_engine(n=400, threshold=64):
    eng = _churn_engine(delta_aut_threshold=threshold)
    oracle = HostTrie()
    for i in range(n):
        eng.insert(f"seed/{i % 23}/+/s{i}", i)
        oracle.insert(f"seed/{i % 23}/+/s{i}", i)
    eng.rebuild()
    _drain(eng)  # a fold the seed inserts started, discarded by now
    return eng, oracle


def _oracle_check(eng, oracle, topics):
    for t, g in zip(topics, eng.match_batch(topics)):
        assert g == oracle.match_words(RT.words(t)), t


def _churn(eng, oracle, start, count):
    for i in range(start, start + count):
        eng.insert(f"churn/{i % 97}/+/c{i}", i)
        oracle.insert(f"churn/{i % 97}/+/c{i}", i)


def _churn_until_capture(eng, oracle, trace, start):
    for round_ in range(50):
        if tp.events_of(trace, "fold_capture"):
            return
        _churn(eng, oracle, start + round_ * 100, 100)
    raise AssertionError("fold never captured")


def test_fold_adopts_inside_match_window():
    """The adoption lands between a window's snapshot and its overlay."""
    eng, oracle = _race_engine()
    _churn(eng, oracle, 1000, 200)
    _drain(eng)
    topics = [f"churn/{i % 97}/x/y" for i in range(60)] + [
        f"seed/{i % 23}/q/r" for i in range(40)]
    with tp.collect() as trace, tp.force_ordering(
            after="match_overlay", block="fold_adopt"):
        _churn_until_capture(eng, oracle, trace, 2000)
        _oracle_check(eng, oracle, topics)
        _drain(eng)
    tp.assert_present(trace, "fold_commit")
    tp.assert_order(trace, "match_overlay", "fold_commit")
    _oracle_check(eng, oracle, topics)


def test_fold_adopts_before_overlay_of_older_snapshot():
    """A window snapshots, the fold adopts, then the window overlays
    its older snapshot: the entries between the two watermarks come
    from the residual view."""
    eng, oracle = _race_engine()
    _churn(eng, oracle, 1000, 200)
    _drain(eng)
    topics = [f"churn/{i % 97}/x/y" for i in range(60)]
    failed = []

    def matcher():
        try:
            _oracle_check(eng, oracle, topics)
        except BaseException as exc:  # reported on the test's thread
            failed.append(exc)

    with tp.collect() as trace:
        with tp.force_ordering(after="match_snapshot", block="fold_adopt"):
            with tp.force_ordering(after="fold_commit",
                                   block="match_overlay"):
                t = threading.Thread(target=matcher)
                _churn_until_capture(eng, oracle, trace, 2000)
                t.start()
                t.join(JOIN_S)
                assert not t.is_alive()
        _drain(eng)
    assert not failed, failed
    tp.assert_present(trace, "fold_commit")
    tp.assert_order(trace, "match_snapshot", "fold_commit")
    tp.assert_order(trace, "fold_commit", "match_overlay")
    _oracle_check(eng, oracle, topics)


def test_base_swap_discards_inflight_fold():
    """A background base swap while a fold is pinned before adoption
    discards the fold; matching stays equal to the oracle."""
    eng, oracle = _race_engine()
    eng.background_rebuild = True
    eng.rebuild_threshold = 250
    topics = [f"churn/{i % 97}/x/y" for i in range(60)]
    with tp.collect() as trace:
        with tp.force_ordering(after="daut_drop",
                               block="fold_assemble_done"):
            # a fold captures at 64 and waits before its adoption; the
            # rebuild starts at 250, and its swap (at the next window)
            # drops the delta tier, which releases the fold
            _churn(eng, oracle, 3000, 400)
            t = eng._build_thread
            assert t is not None
            t.join(JOIN_S)
            assert not t.is_alive()
            eng.match_batch(["churn/1/x/y"])  # polls the swap
        _drain(eng)
    tp.assert_present(trace, "daut_drop")
    gen = tp.assert_present(trace, "fold_discard")["gen"]
    tp.assert_absent(trace, "fold_commit", gen=gen)
    _oracle_check(eng, oracle, topics)


def test_fold_failure_surfaces_once_and_matching_goes_on():
    """An error in the fold thread (here injected; on the card, a CUDA
    error) is not swallowed: the next call on the caller's thread
    raises it, once and before it changes anything, and the windows
    after it equal the host trie; a later fold recovers."""
    eng, oracle = _race_engine()
    topics = [f"churn/{i % 97}/x/y" for i in range(60)]
    with tp.collect() as trace:
        with tp.inject("fold_assemble_done", RuntimeError("injected")):
            eng.insert_many([(f"churn/{i % 97}/+/c{i}", i)
                             for i in range(1000, 1200)])
            for i in range(1000, 1200):
                oracle.insert(f"churn/{i % 97}/+/c{i}", i)
            _drain(eng)
        tp.assert_present(trace, "fold_capture")
        assert eng._daut is None
        with pytest.raises(RuntimeError, match="injected"):
            eng.insert("never/+", 99_999)
        assert 99_999 not in eng._by_fid
        _oracle_check(eng, oracle, topics)  # raises nothing now
        _churn(eng, oracle, 5000, 200)
        _drain(eng)
    assert eng._daut is not None
    _oracle_check(eng, oracle, topics)


def test_upload_error_in_the_fold_thread_reaches_the_caller():
    """A device error in the fold's upload (what a CUDA error looks
    like to the thread) is raised by the next window, not logged."""
    eng, oracle = _race_engine()

    def upload(aut):
        raise RuntimeError("CUDA error: an illegal memory access")

    eng._upload = upload
    eng.insert_many([(f"u/{i}/+", 5000 + i) for i in range(70)])
    _drain(eng)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        eng.match_batch(["u/1/x"])
    assert eng.match_batch(["u/1/x"]) == [{5001}]


def test_builder_failure_surfaces_once_and_rebuild_recovers():
    """A failed background build is raised by the next call; the base
    stays the old one, the delta tiers keep the windows exact, and the
    next build succeeds."""
    eng = _churn_engine(background_rebuild=True, rebuild_threshold=40)
    oracle = HostTrie()
    orig = eng._build

    def boom(inputs, hash_buckets=0):
        raise MemoryError("builder ran out")

    eng._build = boom
    pairs = [(f"b/{i % 7}/+/{i}", i) for i in range(60)]
    eng.insert_many(pairs)
    for flt, fid in pairs:
        oracle.insert(flt, fid)
    _join(eng)
    assert not eng._building and eng._aut is None
    with pytest.raises(MemoryError, match="builder ran out"):
        eng.match_batch(["b/1/x/8"])
    eng._build = orig
    topics = [f"b/{i % 7}/x/{i}" for i in range(60)]
    _oracle_check(eng, oracle, topics)
    eng.insert("b/+/+/99", 99)  # past the threshold: a new build
    oracle.insert("b/+/+/99", 99)
    _join(eng)
    _oracle_check(eng, oracle, topics)
    assert eng._aut is not None and eng.counters["rebuilds"] == 1


def test_deferred_rebuild_starts_on_kick():
    """`defer_rebuild` holds a background rebuild back (the delta tiers
    keep the windows exact); `kick_rebuild` starts it."""
    eng = _churn_engine(background_rebuild=True, rebuild_threshold=32)
    eng.defer_rebuild = lambda: True
    live = {i: f"k/{i % 5}/+" for i in range(40)}
    eng.insert_many([(flt, fid) for fid, flt in live.items()])
    assert eng._build_thread is None and not eng.index_stats()["building"]
    rng = np.random.default_rng(3)
    _check_window((eng,), live, rng, n=10)
    assert eng.kick_rebuild() is True
    _join(eng)
    assert eng.kick_rebuild() is False  # one build at a time, until its swap
    _check_window((eng,), live, rng, n=10)  # polls the swap
    assert eng.index_stats()["base"] == 40 and eng.counters["rebuilds"] == 1


# ------------------------------------------------- arena and wiring


def test_enc_arena_dead_marks_grows_and_compacts():
    """Arena rows equal `encode_filters` on the live filters, in row
    order, through dead marks, doubling and the 50% sweep."""
    from emqx_tpu_torch.ops.automaton import encode_filters

    for native in (True, False):
        td = TokenDict()
        arena = _EncArena(4, native=native, cap=8)
        items = [(i, ("a", str(i % 5), "+")) for i in range(9000)]
        arena.apply(items, (), td)
        assert arena.used == 9000 and len(arena.blen) == 16384
        arena.apply([(3, ("b", "#"))], [4, 5], td)
        mat, blen, ish, flist = arena.views()
        assert (blen[[3, 4, 5]] == -1).all() and arena.dead == 3
        assert arena.rows[3] == 9000 and arena.fid_view()[9000] == 3
        rows = sorted(arena.rows.values())
        want = encode_filters([flist[r] for r in rows], td, 4,
                              native=native)
        assert np.array_equal(mat[rows], want[0])
        assert np.array_equal(blen[rows], want[1])
        assert np.array_equal(ish[rows], want[2])
        view = arena.fid_view()
        # past half the rows dead (and past 4,096): a sweep
        arena.apply([], list(range(6, 9000)), td)
        assert arena.dead == 0 and arena.used == 4
        assert arena.rows == {0: 0, 1: 1, 2: 2, 3: 3}
        assert [f for f, _ in arena.flist] == [0, 1, 2, 3]
        assert view.tolist()[:3] == [0, 1, 2]  # old views stay intact
        assert view[9000] == 3


def test_sharded_offsets_hold_while_a_build_appends():
    """The arenas go on growing under a live sharded index while a
    build runs; the port's offsets were fixed at assembly.  The
    reference computes them from the growing filter lists, so its
    offsets move (a fault of the reference, not copied)."""
    mesh = sh.make_mesh(8, sub=4, devices=CPU8)
    port = sh.ShardedMatchEngine(mesh, max_levels=8)
    ref = ref_sh.ShardedMatchEngine(ref_sh.make_mesh(4), max_levels=8)
    live = {i: f"s/{i % 9}/+" for i in range(80)}
    for e in (port, ref):
        e.insert_many([(flt, fid) for fid, flt in live.items()])
        e.rebuild()
    before = [e.index.offsets for e in (port, ref)]
    items = [(1000 + i, ("t", str(i), "+")) for i in range(40)]
    for e in (port, ref):  # what a builder thread does, mid-window
        e._build(("delta", items, set()))
    assert port.index.offsets == before[0]
    assert ref.index.offsets != before[1]
    topics = [f"s/{i}/x" for i in range(9)]
    for t, g in zip(topics, port.match_batch(topics)):
        assert g == _oracle(live, t), t


def test_broker_config_rebuilds_in_the_background():
    assert BrokerEngineConfig().background_rebuild is True
    eng = Broker(device="cpu").router.engine
    assert eng.background_rebuild is True
    assert set(eng.index_stats()) == {
        "base", "delta", "folded", "residual", "deep", "exact",
        "deleted", "building", "folding"}
