"""The port's native host path against its Python referees and the JAX
package's native libraries: the host trie (`ops.trie_native`), the
token dictionary's batch encoders (`ops.tokdict_native`), the sorts
(`ops.sortutil_native`) and the window wire assembly
(`ops.dispatchasm`, `DispatchEncoder`'s arena,
`Session.deliver_run_native`).  The tolerance is exact equality:
the same fid sets, token ids, arrays and bytes."""

import time

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from emqx_tpu.codec import mqtt as RC
from emqx_tpu.message import Message as RMessage
from emqx_tpu.ops import dispatchasm as rda
from emqx_tpu.ops import sortutil_native as rsu
from emqx_tpu.ops import tokdict_native as rtd
from emqx_tpu.ops import trie_native as rtn
from emqx_tpu.ops.dictionary import TokenDict as RTokenDict

from emqx_tpu_torch.broker.session import Session, SubOpts
from emqx_tpu_torch.codec import mqtt as PC
from emqx_tpu_torch.message import Message
from emqx_tpu_torch.ops import _native, dispatchasm
from emqx_tpu_torch.ops.automaton import encode_filters
from emqx_tpu_torch.ops.dictionary import TokenDict, encode_topics
from emqx_tpu_torch.ops.sortutil_native import argsort_i64, unique_inverse_i64
from emqx_tpu_torch.ops.trie_host import HostTrie
from emqx_tpu_torch.ops.trie_native import NativeTrie, make_trie

LEVEL = st.sampled_from(["a", "b", "", "$SYS", "x", "dev", "é"])
FID = st.one_of(st.integers(0, 12), st.sampled_from(["f", "g", "h"]),
                st.tuples(st.just("rule"), st.sampled_from("rs"),
                          st.integers(0, 2)))


@st.composite
def filters(draw):
    body = draw(st.lists(st.one_of(LEVEL, st.just("+")), min_size=0,
                         max_size=4))
    if not body or draw(st.booleans()):
        body = body + ["#"]
    return "/".join(body)


TOPIC = st.lists(LEVEL, min_size=1, max_size=5).map("/".join)


def test_reference_native_libraries_build():
    """The JAX package's loaders build its libraries (under the
    top-level native/build/) with this machine's compiler."""
    for mod in (rtn, rtd, rsu, rda):
        assert mod.load() is not None, mod.__name__


def test_port_libraries_build_clean():
    _native.load_all()
    for name in _native.NAMES:
        info = _native.build_info[name]
        assert "warning" not in info["log"], info["log"]
        assert info["path"].startswith(_native.BUILD_DIR)


@settings(max_examples=60, deadline=None)
@given(ops=st.lists(st.tuples(st.sampled_from("iiid"), FID, filters()),
                    min_size=1, max_size=40),
       topics=st.lists(TOPIC, min_size=1, max_size=12),
       marks=st.lists(st.floats(0, 1), min_size=1, max_size=4))
def test_native_trie_equals_reference_and_host_trie(ops, topics, marks):
    port, ref, host = NativeTrie(), rtn.NativeTrie(), HostTrie()
    for kind, fid, flt in ops:
        if kind == "i":
            seqs = {port.insert(flt, fid), ref.insert(flt, fid),
                    host.insert(flt, fid)}
        else:
            seqs = {port.delete_id(fid), ref.delete_id(fid),
                    host.delete_id(fid)}
        assert len(seqs) == 1, (kind, fid, flt, seqs)
    assert port.last_seq() == ref.last_seq() == host.last_seq()
    assert dict(port.filters()) == dict(host.filters())
    assert len(port) == len(host)
    for _k, fid, _f in ops:
        assert (fid in port) == (fid in host)
    last = host.last_seq()
    for t in topics:
        ws = tuple(t.split("/"))
        want = host.match(t)
        assert port.match(t) == ref.match(t) == want, t
        assert port.match_words(ws) == want
        for m in marks:
            w = int(m * (last + 1))
            assert port.match_since_words(ws, w) == \
                ref.match_since_words(ws, w) == \
                host.match_since_words(ws, w), (t, w)


def test_native_trie_batch_insert_and_growth():
    port, host = NativeTrie(), HostTrie()
    items = [(f"w/{i % 7}/+/#", i, ("w", str(i % 7), "+", "#")) if i % 5
             else ("w/+/+/#", i, ("w", "+", "+", "#")) for i in range(6000)]
    items += [("w/+/+/#", "x", ("w", "+", "+", "#"))]
    seqs = port.insert_batch(items)
    assert seqs == [host.insert(f, fid, ws) for f, fid, ws in items]
    # 1,200 matches: the 1,024-entry buffer grows and the call repeats
    got = port.match("w/3/z/q")
    assert got == host.match("w/3/z/q") and len(got) > 1024
    assert port.insert(items[0][0], 0) == 0  # unchanged
    assert isinstance(make_trie(), NativeTrie)
    assert isinstance(make_trie(native=False), HostTrie)


def _filter_items(rng, n):
    words = ["a", "b", "", "$SYS", "dev", "é", "x1", "x2"]
    out = []
    for i in range(n):
        ws = [str(rng.choice(words + ["+"])) for _ in
              range(rng.integers(0, 5))]
        if not ws or rng.random() < 0.3:
            ws.append("#")
        out.append((i, tuple(ws)))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_native_encoder_equals_python_and_reference(seed):
    rng = np.random.default_rng(seed)
    items = _filter_items(rng, 300)
    nat, py, ref = TokenDict(), TokenDict(), RTokenDict()
    pre = ["dev", "zz"]  # words known before the encoder is seeded
    for w in pre:
        nat.add(w), py.add(w), ref.add(w)
    a = encode_filters(items, nat, 8, native=True)
    b = encode_filters(items, py, 8, native=False)
    n = len(items)
    r = (np.full((n, 8), -4, np.int32), np.zeros(n, np.int32),
         np.zeros(n, bool))
    assert ref.encode_filters_into(items, 8, *r)
    for x, y, z in zip(a[:3], b[:3], r):
        assert np.array_equal(x, y) and np.array_equal(x, z)
    assert list(nat._ids.items()) == list(py._ids.items()) == \
        list(ref._ids.items())
    assert len(nat.native()) == len(nat)
    # a word added after the batch gets the same id on every side
    assert nat.add("later") == py.add("later") == ref.add("later")
    topics = [tuple(str(rng.choice(["a", "b", "", "$SYS", "dev", "q"]))
                    for _ in range(rng.integers(1, 7))) for _ in range(200)]
    for levels in (1, 3, 6):
        want = encode_topics(py, topics, levels)
        got = (np.empty((200, levels), np.int32), np.empty(200, np.int32),
               np.empty(200, bool))
        nat.native().encode_topics_into(["/".join(t) for t in topics],
                                        levels, *got)
        rgot = (np.empty((200, levels), np.int32), np.empty(200, np.int32),
                np.empty(200, bool))
        ref.native().encode_topics_into(["/".join(t) for t in topics],
                                        levels, *rgot)
        for x, y, z in zip(got, want, rgot):
            assert np.array_equal(x, y) and np.array_equal(x, z), levels


def test_native_encoder_deep_filter_raises_and_mirrors():
    nat, py = TokenDict(), TokenDict()
    items = [(0, ("p", "q")), (1, ("r", "s", "t", "u")), (2, ("v",))]
    with pytest.raises(ValueError, match="deeper than max_levels=3"):
        encode_filters(items, nat, 3, native=True)
    with pytest.raises(ValueError, match="deeper than max_levels=3"):
        encode_filters(items, py, 3, native=False)
    # the words ahead of the failing filter are in both maps
    assert list(nat._ids) == ["p", "q", "r", "s", "t"]
    assert nat.native().add("t") == nat.get("t")


@pytest.mark.parametrize("n", [0, 1, 7, 5000, 20000])
def test_sorts_equal_numpy_and_reference(n):
    rng = np.random.default_rng(n)
    a = rng.integers(-50, 50, n).astype(np.int64) * (1 << 33) + \
        rng.integers(0, 3, n)
    want = np.argsort(a, kind="stable")
    assert np.array_equal(argsort_i64(a), want)
    assert np.array_equal(rsu.argsort_i64(a), want)
    u, inv = unique_inverse_i64(a)
    wu, winv = np.unique(a, return_inverse=True)
    ru, rinv = rsu.unique_inverse_i64(a)
    assert np.array_equal(u, wu) and np.array_equal(u, ru)
    assert np.array_equal(inv, winv.reshape(-1)) and np.array_equal(inv, rinv)


T0 = 1_700_000_000.25


def _window(cls):
    """The same window of messages as either package's Message."""
    out = []
    for i in range(6):
        props = {}
        if i % 3 == 1:
            props["user_property"] = [("k", f"v{i}")]
        if i == 4:
            props["message_expiry_interval"] = 100
        out.append(cls(topic=f"t/{i % 4}/é", payload=bytes(range(i * 40)),
                       qos=i % 3, retain=i % 2 == 0, properties=props,
                       timestamp=T0 - 3.5))
    return out


def _runs(rng):
    """Client runs: (version, msg idx, effective qos, retain) columns."""
    runs = []
    for j in range(5):
        nd = int(rng.integers(1, 12))
        sm = np.sort(rng.integers(0, 6, nd)).astype(np.int64)
        runs.append((PC.MQTT_V5 if j % 2 else PC.MQTT_V4, sm,
                     rng.integers(0, 3, nd).astype(np.int64),
                     rng.random(nd) < 0.5))
    return runs


@pytest.mark.parametrize("seed", range(3))
def test_window_assembly_equals_python_encoder_and_reference(
        seed, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: T0)  # fixes the expiry left
    rng = np.random.default_rng(seed)
    msgs, rmsgs = _window(Message), _window(RMessage)
    runs = _runs(rng)
    enc, renc, pyenc = PC.DispatchEncoder(), RC.DispatchEncoder(), \
        PC.DispatchEncoder()
    bodies, rbodies, pids, want = [], [], [], []
    next_pid = 1
    for ver, sm, eff, ret in runs:
        keys = sm * 6 + eff * 2 + ret
        bodies.append(enc.key_slots(msgs, ver, keys))
        rbodies.append(renc.key_slots(rmsgs, ver, keys))
        pid = np.full(len(sm), -1, np.int64)
        wire = []
        for t in range(len(sm)):
            m, q, r = msgs[sm[t]], int(eff[t]), bool(ret[t])
            if q == 0:
                pkt = pyenc.publish_qos0(m, r, ver)
            else:
                pid[t] = next_pid
                pkt = pyenc.publish(m, q, r, next_pid, ver)
                next_pid += 1
            wire.append(PC.serialize(pkt, ver))
        pids.append(pid)
        want.append(b"".join(wire))
    body, pid = np.concatenate(bodies), np.concatenate(pids)
    run_start = np.cumsum([0] + [len(b) for b in bodies[:-1]]).astype(
        np.int64)
    run_out = np.cumsum([0] + [len(w) for w in want[:-1]]).astype(np.int64)
    total = sum(len(w) for w in want)
    out = bytearray(total)
    assert dispatchasm.assemble_window(
        enc.native_views(), body, pid, run_start, run_out, out) == total
    assert bytes(out) == b"".join(want)
    rout = bytearray(total)
    assert rda.assemble_window(
        rda.load(), renc.native_views(), np.concatenate(rbodies), pid,
        run_start, run_out, len(runs), len(pid), rout) == total
    assert bytes(rout) == bytes(out)
    # one run alone, and a plan whose offsets are off by one byte
    one = bytearray(len(want[1]))
    assert dispatchasm.assemble_run(enc.native_views(), bodies[1], pids[1],
                                    one) == len(one)
    assert bytes(one) == want[1]
    bad = run_out.copy()
    bad[2] += 1
    assert dispatchasm.assemble_window(
        enc.native_views(), body, pid, run_start, bad,
        bytearray(total + 1)) == -3


def _session(max_inflight=32):
    s = Session("c", max_inflight=max_inflight)
    s._next_pid = 65530  # the block wraps past 65535
    s.inflight.insert(3, object())
    return s


@pytest.mark.parametrize("seed", range(2))
def test_deliver_run_native_equals_deliver_decided(seed, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: T0)
    rng = np.random.default_rng(seed)
    msgs = _window(Message)
    opts = SubOpts(qos=2)
    for ver, sm, eff, ret in _runs(rng):
        drop = rng.random(len(sm)) < 0.25
        nat, py = _session(), _session()
        enc, pyenc = PC.DispatchEncoder(), PC.DispatchEncoder()
        body, pid, npub = nat.deliver_run_native(
            msgs, sm, eff, ret, drop, enc, ver)
        decided = [(msgs[i], opts, int(q), bool(r)) for i, q, r, d in
                   zip(sm, eff, ret, drop) if not d]
        pkts = py.deliver_decided(decided, encoder=pyenc, version=ver)
        want = b"".join(PC.serialize(p, ver) for p in pkts)
        out = bytearray(len(want))
        if len(body):
            assert dispatchasm.assemble_run(
                enc.native_views(), body, pid, out) == len(want)
        assert bytes(out) == want
        assert npub == tuple(sum(1 for p in pkts if p.qos == q)
                             for q in (0, 1, 2))
        assert nat._next_pid == py._next_pid
        assert [(k, v.msg, v.qos, v.ts) for k, v in nat.inflight.items()
                if k != 3] == [(k, v.msg, v.qos, v.ts) for k, v in
                               py.inflight.items() if k != 3]
    # no room for every QoS>0 delivery: the per-delivery loop's turn
    full = _session(max_inflight=2)
    assert full.deliver_run_native(
        msgs, np.array([1, 2], np.int64), np.array([1, 2], np.int64),
        np.zeros(2, bool), np.zeros(2, bool), PC.DispatchEncoder(),
        PC.MQTT_V5) is None
    assert len(full.inflight) == 1
