"""Persistent sessions on the port's broker (``durable.enable``,
``device="cpu"``) against the JAX package's, on the wire: the same
scripted clients on both brokers, byte for byte.  A persistent session
subscribes, disconnects (checkpointed), misses publishes that the host
gate persists, the broker restarts on its data directory, and the
reconnect replays the missed interval; the same with two members of a
durable ``$share`` group, whose streams split by rendezvous hash; a
live (no restart) reconnect; and a clean start that drops the
checkpoint and the gate's refs."""

import os

import numpy as np
import pytest

from emqx_tpu.broker.broker import Broker as RefBroker
from emqx_tpu.codec import mqtt as C
from emqx_tpu.config import BrokerConfig as RefConfig

from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.config import BrokerConfig

from test_torch_broker import Pair


def _cfgs(tmp_path, **durable):
    out = []
    for name, cls in (("ref", RefConfig), ("port", BrokerConfig)):
        cfg = cls()
        cfg.sys.enable = False
        cfg.durable.enable = True
        cfg.durable.data_dir = str(tmp_path / name)
        for k, v in durable.items():
            setattr(cfg.durable, k, v)
        out.append(cfg)
    return out


def _brokers(cfgs, strategy="round_robin"):
    rcfg, pcfg = cfgs
    return (RefBroker(config=rcfg, shared_strategy=strategy),
            Broker(config=pcfg, device="cpu", shared_strategy=strategy))


def _shutdown(ref, port):
    ref.shutdown()
    port.shutdown()


def _connect(ref, port, cid, version, clean=False, expiry=3600):
    c = Pair(ref, port, version)
    props = ({"session_expiry_interval": expiry}
             if version == C.MQTT_V5 else {})
    c.send(C.Connect(client_id=cid, proto_ver=version, keepalive=30,
                     clean_start=clean, properties=props))
    return c


def _drain(clients):
    while sum(c.auto_ack() for c in clients):
        pass


def _publish_all(pub, msgs, base=100):
    for k, (topic, qos, retain, payload) in enumerate(msgs):
        pid = (base + k) if qos else None
        pub.send(C.Publish(topic=topic, qos=qos, retain=retain,
                           payload=payload, packet_id=pid))
        if qos == 2:
            pub.send(C.Pubrel(packet_id=pid))


def _script(seed, n=40):
    rng = np.random.default_rng(seed)
    topics = ["fleet/a/t", "fleet/b/t", "fleet/c/s", "site/1/door",
              "alerts/x", "other/y"]
    return [(topics[int(rng.integers(len(topics)))],
             int(rng.integers(0, 3)), bool(rng.random() < 0.2),
             bytes(rng.integers(0, 256, int(rng.integers(0, 40)),
                                dtype=np.uint8)))
            for _ in range(n)]


SUBSCRIBERS = {
    # cid: (version, [(filter, qos, no_local, rap)])
    "ps1": (C.MQTT_V5, [("fleet/+/t", 1, False, False),
                        ("site/#", 2, False, True)]),
    "ps2": (C.MQTT_V4, [("fleet/#", 2, False, False)]),
    "ps3": (C.MQTT_V5, [("alerts/+", 1, True, False),
                        ("fleet/c/+", 0, False, False)]),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("layout", ["lts", "hash"])
def test_restart_replay_wire_equals_reference(seed, layout, tmp_path):
    cfgs = _cfgs(tmp_path, layout=layout, fsync="always")
    ref, port = _brokers(cfgs)
    subs = {}
    for cid, (ver, flts) in SUBSCRIBERS.items():
        # an MQTT 3.1.1 session persists only without clean start
        c = subs[cid] = _connect(ref, port, cid, ver,
                                 clean=ver == C.MQTT_V5)
        c.send(C.Subscribe(packet_id=1, subscriptions=[
            C.Subscription(topic_filter=f, qos=q, no_local=nl,
                           retain_as_published=rap)
            for f, q, nl, rap in flts]))
        c.assert_same(f"subscribe {cid}")
    for c in subs.values():
        c.send(C.Disconnect())
    # the publishes the sessions miss
    pub = _connect(ref, port, "pub", C.MQTT_V5, clean=True, expiry=0)
    _publish_all(pub, _script(seed))
    pub.assert_same("publisher acks")
    for b in (ref, port):
        assert b.durable.gate.appended > 0
        assert not b.durable.gate.dirty  # always mode: flushed
    _shutdown(ref, port)

    # the restart: new brokers on the same directories
    ref, port = _brokers(cfgs)
    assert sorted(s.clientid for s in port.durable.boot_states()) == \
        sorted(s.clientid for s in ref.durable.boot_states())
    back = {}
    for cid, (ver, _flts) in SUBSCRIBERS.items():
        back[cid] = _connect(ref, port, cid, ver)
        back[cid].assert_same(f"resume connack+replay {cid}")
    _drain(back.values())
    for cid, c in back.items():
        c.assert_same(f"replayed {cid}")
        pubs = [p for p in C.StreamParser(version=c.version).feed(
            b"".join(c.port.writes)) if p.type == C.PUBLISH]
        assert pubs, cid
    assert port.metrics.val("session.resumed") == ref.metrics.val(
        "session.resumed")
    assert [port.durable.has_checkpoint(c) for c in SUBSCRIBERS] == \
        [ref.durable.has_checkpoint(c) for c in SUBSCRIBERS] == \
        [False] * len(SUBSCRIBERS)
    _shutdown(ref, port)


def test_live_reconnect_and_clean_start_equal_reference(tmp_path):
    """No restart: the detached session's mqueue replays on a live
    reconnect and the checkpoint is dropped; a clean start then
    discards the session and releases the gate's refs."""
    ref, port = _brokers(_cfgs(tmp_path))
    c = _connect(ref, port, "live", C.MQTT_V5, clean=True)
    c.send(C.Subscribe(packet_id=1, subscriptions=[
        C.Subscription(topic_filter="fleet/#", qos=1)]))
    c.send(C.Disconnect())
    for b in (ref, port):
        assert b.durable.has_checkpoint("live") is False  # not booted
    pub = _connect(ref, port, "pub", C.MQTT_V4, clean=True, expiry=0)
    _publish_all(pub, _script(5, 12))
    c2 = _connect(ref, port, "live", C.MQTT_V5)
    _drain([c2])
    c2.assert_same("live resume")
    assert port.durable._refs == ref.durable._refs == {"fleet/#": 1}
    c2.send(C.Disconnect())
    c3 = _connect(ref, port, "live", C.MQTT_V5, clean=True)
    c3.assert_same("clean start")
    assert port.durable._refs == ref.durable._refs == {}
    _shutdown(ref, port)


def test_durable_shared_group_replays_each_stream_once(tmp_path):
    """Two persistent members of ``$share/g/fleet/#`` and a direct
    subscriber: the group's offline interval replays once across the
    members (each stream to its rendezvous owner), on both brokers
    alike; the detached members get no live picks meanwhile."""
    cfgs = _cfgs(tmp_path, layout="hash")
    ref, port = _brokers(cfgs)
    members = {}
    for cid in ("m1", "m2"):
        c = members[cid] = _connect(ref, port, cid, C.MQTT_V5, clean=True)
        c.send(C.Subscribe(packet_id=1, subscriptions=[
            C.Subscription(topic_filter="$share/g/fleet/#", qos=1)]))
        c.assert_same(f"join {cid}")
    for c in members.values():
        c.send(C.Disconnect())
    pub = _connect(ref, port, "pub", C.MQTT_V5, clean=True, expiry=0)
    msgs = [(f"fleet/{k % 5}/t", 1, False, b"%d" % k) for k in range(30)]
    _publish_all(pub, msgs)
    pub.assert_same("publisher acks")
    for b in (ref, port):
        assert b.metrics.val("messages.delivered") == 0
    _shutdown(ref, port)
    ref, port = _brokers(cfgs)
    back = {cid: _connect(ref, port, cid, C.MQTT_V5) for cid in members}
    _drain(back.values())
    got = 0
    for cid, c in back.items():
        c.assert_same(f"shared replay {cid}")
        got += sum(1 for p in C.StreamParser(version=C.MQTT_V5).feed(
            b"".join(c.ref.writes)) if p.type == C.PUBLISH)
    assert got == len(msgs)  # each message exactly once across the group
    _shutdown(ref, port)


def test_durable_shared_pick_skips_detached_members(tmp_path):
    """Live traffic to a group with one connected and one detached
    persistent member goes to the connected one only."""
    ref, port = _brokers(_cfgs(tmp_path))
    a = _connect(ref, port, "a", C.MQTT_V5, clean=True)
    b = _connect(ref, port, "b", C.MQTT_V5, clean=True)
    for c in (a, b):
        c.send(C.Subscribe(packet_id=1, subscriptions=[
            C.Subscription(topic_filter="$share/g/x/#", qos=1)]))
    b.send(C.Disconnect())
    pub = _connect(ref, port, "pub", C.MQTT_V5, clean=True, expiry=0)
    _publish_all(pub, [(f"x/{k}", 1, False, b"v") for k in range(6)])
    _drain([a])
    a.assert_same("connected member takes every pick")
    n = sum(1 for p in C.StreamParser(version=C.MQTT_V5).feed(
        b"".join(a.port.writes)) if p.type == C.PUBLISH)
    assert n == 6
    for br in (ref, port):
        assert len(br.cm.lookup("b").mqueue) == 0
    _shutdown(ref, port)
