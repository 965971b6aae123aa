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
