"""The port's MatchEngine (plain kernels on the CPU) against the JAX
package's MatchEngine and the host trie: the same insert / insert_many
/ delete / match sequence, with churn across rebuilds, gives the same
fid sets."""

import random

import pytest

from emqx_tpu import topic as RT
from emqx_tpu.engine import MatchEngine as RefEngine
from emqx_tpu.ops.trie_host import HostTrie

from emqx_tpu_torch.engine import MatchEngine
from emqx_tpu_torch.ops import match_kernel as mk

WORDS = ["a", "b", "c", "", "dev", "$SYS", "x"]


def _filter(rng):
    depth = rng.randint(1, 5)
    ws = []
    for i in range(depth):
        r = rng.random()
        if r < 0.2:
            ws.append("+")
        elif r < 0.3 and i == depth - 1:
            ws.append("#")
        else:
            ws.append(rng.choice(WORDS))
    return "/".join(ws)


def _topic(rng):
    return "/".join(rng.choice(WORDS) for _ in range(rng.randint(1, 6)))


def _oracle(live, topic):
    ws = RT.words(topic)
    return {fid for fid, flt in live.items()
            if RT.match_words(ws, RT.words(flt))}


@pytest.mark.parametrize("seed", range(3))
def test_engine_equals_reference_under_churn(seed):
    rng = random.Random(seed)
    kw = dict(max_levels=8, f_width=4, m_cap=16, rebuild_threshold=48)
    port = MatchEngine(device="cpu", **kw)
    ref = RefEngine(use_device=True, **kw)
    live = {}
    fid = 0
    for step in range(6):
        batch = []
        for _ in range(40):
            flt = _filter(rng)
            try:
                RT.validate_filter(flt)
            except ValueError:
                continue
            batch.append((flt, fid))
            fid += 1
        port.insert_many(batch)
        ref.insert_many(batch)
        live.update({f: flt for flt, f in batch})
        for f in rng.sample(sorted(live), 10):
            assert port.delete(f) == ref.delete(f)
            del live[f]
        # re-insert some fids with new filters (tombstone + residual)
        for f in rng.sample(sorted(live), 5):
            flt = _filter(rng)
            try:
                RT.validate_filter(flt)
            except ValueError:
                continue
            port.insert(flt, f)
            ref.insert(flt, f)
            live[f] = flt
        if step == 2:
            port.rebuild()
            ref.rebuild()
        topics = [_topic(rng) for _ in range(64)]
        got = port.match_batch(topics)
        want = ref.match_batch(topics)
        for t, g, w in zip(topics, got, want):
            assert g == w == _oracle(live, t), t
    assert port.counters["rebuilds"] >= 2
    assert port.counters["dev_windows"] >= 3


def test_engine_overflow_rows_rematch_on_host():
    eng = MatchEngine(device="cpu", max_levels=8, f_width=2, m_cap=4)
    trie = HostTrie()
    for i in range(12):
        pat = ["+"] * 4
        pat[i % 4] = "w%d" % (i % 3)
        eng.insert("/".join(pat), i)
        trie.insert("/".join(pat), i)
    eng.rebuild()
    topic = "w0/w1/w2/w0"
    assert eng.match(topic) == trie.match(topic)
    assert eng.counters["ovf_rows"] >= 1


def test_engine_compact_clip_reruns_dense():
    """A window whose codes overflow the compact buffer reruns on the
    dense kernel and doubles the capacity multiplier."""
    eng = MatchEngine(device="cpu", max_levels=8, f_width=8, m_cap=64)
    trie = HostTrie()
    shapes = ["#", "{p}/#", "+/#", "{p}/{q}", "{p}/+", "+/{q}", "+/+",
              "{p}/{q}/#", "{p}/+/#", "+/{q}/#", "+/+/#"]
    fid = 0
    for k in range(4):
        for shape in shapes:
            flt = shape.format(p=f"p{k}", q=f"q{k}")
            eng.insert(flt, fid)
            trie.insert(flt, fid)
            fid += 1
    eng.rebuild()
    before = mk.match_batch.launches
    # 4 distinct topics x 10 codes > c_cap = 2 x 16 padded rows
    topics = ["p0/q0", "p1/q1", "p2/q2", "p3/q3", "p0/q0"]
    got = eng.match_batch(topics)
    assert got == [trie.match(t) for t in topics]
    assert eng.counters["clip_reruns"] == 1
    assert eng._ccap_mult == 4
    assert mk.match_batch.launches == before  # CPU: plain version only


def test_host_stage_packs_one_upload():
    import numpy as np
    import torch

    from emqx_tpu_torch.state import HostStage

    st = HostStage("cpu")
    for n in (3, 5000):  # the second call grows the buffer
        a, b, c = st.views([(np.float64, (2, n)), (np.int8, (n,)),
                            (bool, (3,))])
        a[...] = np.arange(2 * n).reshape(2, n) / 4
        b[...] = -(np.arange(n) % 100)
        c[...] = [True, False, True]
        ta, tb, tc = st.upload()
        a[...] = 0  # the upload is a copy
        assert ta.dtype == torch.float64 and ta.shape == (2, n)
        assert torch.equal(ta, torch.arange(2 * n).reshape(2, n) / 4)
        assert tb.dtype == torch.int8 and tb.tolist() == (
            -(np.arange(n) % 100)).tolist()
        assert tc.tolist() == [True, False, True]
    (got,) = st.download(tb)
    assert got.dtype == np.int8 and got.shape == (5000,)


@pytest.mark.parametrize("seed", range(2))
def test_engine_native_equals_python_path_and_reference(seed):
    """The churn world through three engines: the port's native host
    path (the default), its Python referees (``native=False``) and the
    JAX package's engine give the same fid sets, window by window."""
    rng = random.Random(100 + seed)
    kw = dict(max_levels=4, f_width=4, m_cap=16, rebuild_threshold=40)
    nat = MatchEngine(device="cpu", **kw)
    py = MatchEngine(device="cpu", native=False, **kw)
    ref = RefEngine(use_device=True, **kw)
    assert type(nat._wild).__name__ == "NativeTrie"
    assert type(py._wild).__name__ == "HostTrie"
    live = {}
    fid = 0
    for step in range(5):
        batch = []
        for _ in range(30):
            flt = _filter(rng)
            try:
                RT.validate_filter(flt)
            except ValueError:
                continue
            batch.append((flt, fid if fid % 3 else f"s{fid}"))
            fid += 1
        for eng in (nat, py, ref):
            eng.insert_many(batch)
        live.update({f: flt for flt, f in batch})
        for f in rng.sample(sorted(live, key=str), 6):
            assert nat.delete(f) == py.delete(f) == ref.delete(f)
            del live[f]
        if step == 1:
            for eng in (nat, py, ref):
                eng.rebuild()
        # repeated topics hit the row cache; new words (after a rebuild)
        # drop it
        topics = [_topic(rng) for _ in range(48)] * 2
        got = [eng.match_batch(topics) for eng in (nat, py, ref)]
        for i, t in enumerate(topics):
            assert got[0][i] == got[1][i] == got[2][i] == _oracle(live, t), t
        # filters deeper than max_levels live in the deep host tier
        deep = "/".join(["a"] * 6) + "/#"
        for eng in (nat, py, ref):
            eng.insert(deep, f"deep{step}")
        live[f"deep{step}"] = deep
    assert nat._aut.node_rows.tolist() == py._aut.node_rows.tolist()
    assert nat._aut.fp_rows.tolist() == py._aut.fp_rows.tolist()
    assert nat._tdict._ids == py._tdict._ids
    assert nat.counters == py.counters
    assert nat.counters["dev_windows"] >= 3


def test_engine_overflow_and_clip_worlds_equal_on_both_host_paths():
    """The overflow and compact-clip worlds above, through the native
    host path and its Python referees: the same fid sets."""
    engines = [MatchEngine(device="cpu", max_levels=8, f_width=2, m_cap=4,
                           native=native) for native in (True, False)]
    for eng in engines:
        for i in range(12):
            pat = ["+"] * 4
            pat[i % 4] = "w%d" % (i % 3)
            eng.insert("/".join(pat), i)
        eng.rebuild()
    topics = ["w0/w1/w2/w0", "w1/w1/w1/w1", "x/y/z/w"]
    assert engines[0].match_batch(topics) == engines[1].match_batch(topics)
    assert engines[0].counters["ovf_rows"] == engines[1].counters[
        "ovf_rows"] >= 1
    shapes = ["#", "{p}/#", "+/#", "{p}/{q}", "{p}/+", "+/{q}", "+/+",
              "{p}/{q}/#", "{p}/+/#", "+/{q}/#", "+/+/#"]
    engines = [MatchEngine(device="cpu", max_levels=8, f_width=8, m_cap=64,
                           native=native) for native in (True, False)]
    for eng in engines:
        for k in range(4):
            for j, shape in enumerate(shapes):
                eng.insert(shape.format(p=f"p{k}", q=f"q{k}"), 20 * k + j)
        eng.rebuild()
    topics = ["p0/q0", "p1/q1", "p2/q2", "p3/q3", "p0/q0"]
    assert engines[0].match_batch(topics) == engines[1].match_batch(topics)
    assert engines[0].counters["clip_reruns"] == \
        engines[1].counters["clip_reruns"] == 1
