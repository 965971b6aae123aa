"""The port's durable store (`emqx_tpu_torch.ds`) held to the JAX
package's and to the in-memory oracle `ReferenceStorage`: the same
seeded messages go into both packages' stores under both layouts
(``lts``, ``hash``) and ``n_shards`` 1 and 4; the same filters find the
same streams, the same iterators return the same messages in the same
order, and both agree with the oracle.  A data directory one package
wrote boots in the other and replays the same messages, both ways.
The port's segment log is its own ``native/dslog.cpp``, built at first
use; a build that fails raises."""

import os

import numpy as np
import pytest

from emqx_tpu import ds as rds
from emqx_tpu.ds import persist as rpersist
from emqx_tpu.ds.lts import LtsStorage as RLts
from emqx_tpu.ds.sharded import ShardedStorage as RSharded
from emqx_tpu.message import Message as RMessage

from emqx_tpu_torch import ds as pds
from emqx_tpu_torch.ds import api as papi
from emqx_tpu_torch.ds import native as pnative
from emqx_tpu_torch.ds import persist as ppersist
from emqx_tpu_torch.ds.lts import LtsStorage as PLts
from emqx_tpu_torch.ds.sharded import ShardedStorage as PSharded
from emqx_tpu_torch.message import Message as PMessage
from emqx_tpu_torch.ops import _native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOPICS = ["fleet/{d}/telemetry", "fleet/{d}/status", "site/{s}/door/{d}",
          "alerts/{s}", "fleet/{d}/telemetry/gps"]
FILTERS = ["fleet/+/telemetry", "fleet/#", "site/+/door/+", "site/s1/#",
           "alerts/s2", "#", "+/d3/+", "fleet/d1/telemetry", "nomatch/x"]


def world(seed, n=300):
    """Seeded messages: topics from a small fleet, QoS 1/2, MQTT 5
    properties on some, increasing timestamps with repeats."""
    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000.0 + seed
    out = []
    t = t0
    for i in range(n):
        shape = TOPICS[int(rng.integers(len(TOPICS)))]
        topic = shape.format(d=f"d{int(rng.integers(6))}",
                             s=f"s{int(rng.integers(3))}")
        props = {}
        if rng.random() < 0.2:
            props["correlation_data"] = bytes(rng.integers(0, 256, 4,
                                                           dtype=np.uint8))
        if rng.random() < 0.2:
            props["user_property"] = [("k", f"v{i}")]
        if rng.random() < 0.8:
            t += float(rng.integers(1, 5)) * 0.001
        out.append(dict(
            topic=topic, qos=int(rng.integers(1, 3)),
            payload=bytes(rng.integers(0, 256, int(rng.integers(0, 64)),
                                       dtype=np.uint8)),
            retain=bool(rng.random() < 0.1), from_client=f"c{i % 7}",
            from_username=None if rng.random() < 0.5 else "u",
            mid=bytes(rng.integers(0, 256, 16, dtype=np.uint8)),
            timestamp=t, properties=props))
    return out


def msgs(side, spec):
    cls = RMessage if side == "ref" else PMessage
    return [cls(**dict(m, properties=dict(m["properties"]))) for m in spec]


def view(m):
    return (m.topic, m.payload, m.qos, m.retain, m.from_client,
            m.from_username, m.mid, m.timestamp, m.properties)


def drain(store, flt):
    """Every stream for ``flt`` and the messages each iterator returns,
    read in batches of 7."""
    out = []
    for s in store.get_streams(flt, 0):
        it = store.make_iterator(s, flt, 0)
        got = []
        while True:
            it, batch = store.next(it, 7)
            if not batch:
                break
            got.extend(view(m) for m in batch)
        out.append((s.to_json(), got))
    return out


def make(side, layout, shards, d):
    if shards > 1:
        return (RSharded if side == "ref" else PSharded)(
            d, n_shards=shards, layout=layout)
    if layout == "lts":
        return (RLts if side == "ref" else PLts)(d)
    return (rds if side == "ref" else pds).LocalStorage(d)


@pytest.mark.parametrize("layout", ["lts", "hash"])
@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_store_iterators_equal_reference_and_oracle(layout, shards, seed,
                                                    tmp_path):
    spec = world(seed)
    stores = {}
    for side in ("ref", "port"):
        st = make(side, layout, shards, str(tmp_path / side))
        # two batches, the second after a metadata flush
        st.store_batch(msgs(side, spec[:170]))
        st.save_meta()
        st.store_batch(msgs(side, spec[170:]))
        stores[side] = st
    oracle = pds.ReferenceStorage()
    oracle.store_batch(msgs("port", spec))
    try:
        for flt in FILTERS:
            port = drain(stores["port"], flt)
            assert port == drain(stores["ref"], flt), flt
            want = sorted(m for _s, ms in drain(oracle, flt) for m in ms)
            got = sorted(m for _s, ms in port for m in ms)
            assert got == want, flt
            # each stream's records come in (ts) order
            for _s, ms in port:
                assert [m[7] for m in ms] == sorted(m[7] for m in ms)
        assert stores["port"].generation() == stores["ref"].generation()
    finally:
        for st in stores.values():
            st.close()


def test_oracle_equals_reference_oracle():
    spec = world(5, 120)
    a, b = pds.ReferenceStorage(n_streams=8), rds.ReferenceStorage(
        n_streams=8)
    a.store_batch(msgs("port", spec))
    b.store_batch(msgs("ref", spec))
    for flt in FILTERS:
        assert drain(a, flt) == drain(b, flt)


def test_record_codec_equals_reference():
    from emqx_tpu.ds import api as rapi

    for m in world(3, 60):
        pm, rm = msgs("port", [m])[0], msgs("ref", [m])[0]
        blob = papi.encode_message(pm)
        assert blob == rapi.encode_message(rm)
        assert view(papi.decode_message(blob)) == view(
            rapi.decode_message(blob))
    for t in ("a/b/c", "a/b", "a", "x/y/z/w"):
        for n in (1, 4, 16):
            assert papi.stream_of(t, n) == rapi.stream_of(t, n)
    for f in FILTERS + ["a", "a/#", "#/x"]:
        assert papi.filter_streams(f, 16) == rapi.filter_streams(f, 16)


def _seed_sessions(DS, d, layout, shards, spec, side):
    """Checkpoint two sessions, persist the backlog, close."""
    ds = DS(d, layout=layout, n_shards=shards, fsync="always")
    t0 = spec[0]["timestamp"] - 1.0
    ds.save("sub-a", {"fleet/+/telemetry": {"qos": 1}}, 3600.0, now=t0)
    ds.save("sub-b", {"site/#": {"qos": 2}, "alerts/+": {"qos": 1}},
            3600.0, now=t0)
    for f in ("fleet/+/telemetry", "site/#", "alerts/+"):
        ds.add_filter(f)
    n = ds.persist(msgs(side, spec))
    ds.sync()
    ds.close()
    return n


def _replay_all(DS, d, layout, shards, now):
    ds = DS(d, layout=layout, n_shards=shards)
    try:
        out = {}
        for cid in ("sub-a", "sub-b"):
            st = ds._boot_states[cid]
            out[cid] = [(flt, view(m)) for flt, m in ds.replay(st)]
        return out, ds.layout, ds.n_shards
    finally:
        ds.close()


@pytest.mark.parametrize("layout,shards", [("lts", 1), ("hash", 1),
                                           ("lts", 4)])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_data_directory_cross_reads(layout, shards, writer, tmp_path):
    """A directory one package wrote boots in the other and in itself,
    and both replay the same messages."""
    spec = world(11, 200)
    # timestamps after the checkpoints' disconnect instant
    d = str(tmp_path / "data")
    DS = {"ref": rpersist.DurableSessions, "port": ppersist.DurableSessions}
    n = _seed_sessions(DS[writer], d, layout, shards, spec, writer)
    assert n > 0
    outs = {}
    for reader in ("ref", "port"):
        outs[reader] = _replay_all(DS[reader], d, layout, shards, None)
    assert outs["port"] == outs["ref"]
    replayed, lay, nsh = outs["port"]
    assert (lay, nsh) == (layout, shards)
    assert len(replayed["sub-a"]) + len(replayed["sub-b"]) >= n


def test_persist_gate_equals_reference(tmp_path):
    """The port's gate matches on the host trie with the reference
    engine's refcounts: the same messages are captured."""
    spec = world(7, 250)
    got = {}
    for side, DS in (("ref", rpersist.DurableSessions),
                     ("port", ppersist.DurableSessions)):
        ds = DS(str(tmp_path / side), layout="hash")
        for f in ("fleet/+/telemetry", "fleet/+/telemetry", "site/#",
                  "$share/g/alerts/+", "+/d2/#"):
            ds.add_filter(f)
        ds.remove_filter("fleet/+/telemetry")  # one ref left
        ds.remove_filter("+/d2/#")  # gone
        ms = msgs(side, spec)
        ms.append(msgs(side, [dict(spec[0], topic="$SYS/x")])[0])
        got[side] = (ds.persist(ms), ds.gate.appended)
        ds.close()
    assert got["port"] == got["ref"]
    assert got["port"][0] > 0


def test_rendezvous_pick_equals_reference():
    from emqx_tpu.ds.replication import rendezvous_pick

    rng = np.random.default_rng(2)
    for _ in range(50):
        nodes = [f"m{int(x)}" for x in rng.integers(0, 40, 5)]
        key = f"g:{int(rng.integers(1000))}"
        for k in (1, 2):
            assert ppersist.rendezvous_pick(key, nodes, k) == \
                rendezvous_pick(key, nodes, k)


def test_dslog_builds_from_the_ports_source():
    """The segment log is built by the port's loader from its own copy
    into ``ops/build``; the top-level ``native/`` is the JAX package's."""
    lib = pnative.load()
    assert lib is _native.load("dslog")
    path = _native.build_info["dslog"]["path"]
    assert path.startswith(os.path.join(REPO, "emqx_tpu_torch", "ops",
                                        "build"))
    assert _native.source_path("dslog") == os.path.join(
        REPO, "emqx_tpu_torch", "native", "dslog.cpp")
    assert "dslog" not in _native.NAMES  # not one of the engine's set
