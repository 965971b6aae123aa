"""The retainer and ``$exclusive/`` in the port against the JAX package.

`Retainer` on seeded random topics and filters (store, replace,
empty-payload delete and prune, ``$`` topics under root wildcards,
``#`` matching the parent level, the count and payload limits, both
kinds of expiry at a fixed ``now``); then the broker's wire: retained
publishes replayed to late subscribers by ``retain_handling``, after
the SUBACK, with the retain bit kept, through the session's inflight
window and mqueue; and ``$exclusive/`` with the option off and on."""

import numpy as np
import pytest

from emqx_tpu.broker.broker import Broker as RefBroker
from emqx_tpu.codec import mqtt as C
from emqx_tpu.config import BrokerConfig as RefConfig
from emqx_tpu.message import Message as RefMessage
from emqx_tpu.retainer import Retainer as RefRetainer

from emqx_tpu_torch import topic as T
from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.config import BrokerConfig
from emqx_tpu_torch.message import Message
from emqx_tpu_torch.retainer import Retainer

from test_torch_broker import Pair

WORDS = ["a", "b", "c", "$SYS", "$x", "", "dev"]


def _topic(rng):
    return "/".join(WORDS[rng.integers(0, len(WORDS))]
                    for _ in range(rng.integers(1, 5)))


def _filter(rng):
    ws = [("+", "#", WORDS[rng.integers(0, len(WORDS))])[
        rng.integers(0, 3)] for _ in range(rng.integers(1, 5))]
    if "#" in ws:
        ws = ws[:ws.index("#") + 1]
    return "/".join(ws)


def _view(msgs):
    return [(m.topic, bytes(m.payload)) for m in msgs]


@pytest.mark.parametrize("limits", [
    {},
    {"max_retained_messages": 20},
    {"max_payload_size": 3},
    {"msg_expiry_interval": 50.0},
])
def test_retainer_equals_reference(limits):
    """A seeded script of stores (replacing, deleting by empty payload,
    some with a message expiry interval) and reverse matches at fixed
    times gives the same answers, in the same order, on both."""
    rng = np.random.default_rng(3)
    ref, port = RefRetainer(**limits), Retainer(**limits)
    got, want = [], []
    now = 1000.0
    for step in range(800):
        op = rng.integers(0, 10)
        if op < 6:
            topic = _topic(rng)
            payload = b"" if rng.integers(0, 5) == 0 else \
                b"p" * int(rng.integers(1, 6))
            props = ({"message_expiry_interval": int(rng.integers(1, 80))}
                     if rng.integers(0, 4) == 0 else {})
            ts = now - float(rng.integers(0, 100))
            want.append(ref.store(RefMessage(topic=topic, payload=payload,
                                             retain=True, timestamp=ts,
                                             properties=dict(props))))
            got.append(port.store(Message(topic=topic, payload=payload,
                                          retain=True, timestamp=ts,
                                          properties=dict(props))))
        elif op == 6:
            topic = _topic(rng)
            want.append(ref.delete(topic))
            got.append(port.delete(topic))
        else:
            flt = _filter(rng)
            at = now + float(rng.integers(0, 60))
            want.append(_view(ref.match(flt, now=at)))
            got.append(_view(port.match(flt, now=at)))
        want.append((len(ref), ref.topics()))
        got.append((len(port), port.topics()))
        if step == 700:
            ref.clear()
            port.clear()
    assert got == want
    assert sum(isinstance(x, list) and len(x) > 0 and isinstance(x[0], tuple)
               and isinstance(x[0][0], str) for x in got) > 20


def test_retainer_root_wildcards_skip_dollar_topics():
    r = Retainer()
    for t in ("$SYS/a", "a", "a/b", "$x", "a/$y"):
        r.store(Message(topic=t, payload=b"1", retain=True))
    assert sorted(m.topic for m in r.match("#")) == ["a", "a/$y", "a/b"]
    assert sorted(m.topic for m in r.match("+")) == ["a"]
    assert sorted(m.topic for m in r.match("a/#")) == ["a", "a/$y", "a/b"]
    assert sorted(m.topic for m in r.match("$SYS/#")) == ["$SYS/a"]
    # stored order: a/b before a/$y
    assert [m.topic for m in r.match("$share/g/a/+")] == ["a/b", "a/$y"]
    # brute force: the reverse walk equals topic.match over the store
    for flt in ("#", "+", "a/+", "+/+", "$SYS/+", "a/#", "+/#"):
        want = sorted(t for t in r.topics() if T.match(t, flt))
        assert sorted(m.topic for m in r.match(flt)) == want, flt


def test_retainer_disabled_stores_nothing():
    r = Retainer(enable=False)
    assert not r.store(Message(topic="a", payload=b"x", retain=True))
    assert len(r) == 0 and r.match("#") == []


# ------------------------------------------------------------ the wire


def _pair(ref, port, cid, ver=C.MQTT_V5, **props):
    c = Pair(ref, port, ver)
    c.send(C.Connect(client_id=cid, proto_ver=ver, keepalive=30,
                     properties=props if ver == C.MQTT_V5 else {}))
    c.assert_same(f"connect {cid}")
    return c


def _drain(clients):
    while sum(c.auto_ack() for c in clients):
        pass


def _subscribe(c, pid, *subs):
    c.send(C.Subscribe(packet_id=pid, subscriptions=[
        C.Subscription(topic_filter=f, qos=q, retain_handling=rh,
                       retain_as_published=rap)
        for f, q, rh, rap in subs]))


def _publishes(c):
    return [p for p in C.StreamParser(version=c.version).feed(
        b"".join(c.port.writes)) if p.type == C.PUBLISH]


def test_retained_replay_wire_equals_reference():
    """Retained publishes (replaced, deleted, a ``$`` topic), then late
    subscribers with retain_handling 0/1/2 at MQTT 5.0 and 3.1.1, a
    re-subscribe, retain_as_published false (the replay keeps retain=1),
    a ``$share`` subscriber (no replay) and a retained will."""
    ref = RefBroker(shared_strategy="round_robin")
    port = Broker(device="cpu", shared_strategy="round_robin")
    pub = _pair(ref, port, "pub")
    for k, (topic, payload, qos) in enumerate([
        ("r/1", b"one", 1), ("r/2", b"two", 2), ("r/3", b"three", 0),
        ("r/1", b"one-again", 1), ("r/3", b"", 0), ("$SYS/r", b"d", 1),
        ("r/4/deep", b"deep", 2), ("q", b"q", 1),
    ]):
        pub.send(C.Publish(topic=topic, qos=qos, retain=True,
                           payload=payload,
                           packet_id=k + 1 if qos else None))
        if qos == 2:
            pub.send(C.Pubrel(packet_id=k + 1))
    pub.assert_same("retained publishes")
    assert len(port.retainer) == len(ref.retainer) == 5
    assert port.metrics["messages.retained"] == \
        ref.metrics.val("messages.retained")
    late = [_pair(ref, port, f"l{rh}", **{"session_expiry_interval": 0})
            for rh in range(3)]
    for rh, c in enumerate(late):
        _subscribe(c, 1, ("r/+", 1, rh, rh == 1), ("#", 2, rh, False),
                   ("$share/g/r/#", 1, rh, False))
    v3 = _pair(ref, port, "v3", ver=C.MQTT_V4)
    _subscribe(v3, 1, ("r/#", 2, 0, False), ("$SYS/#", 0, 0, False))
    _drain([*late, v3])
    for c in (*late, v3):
        c.assert_same(f"replay {c.port.ch.clientid}")
    replayed = _publishes(late[0])
    assert replayed and all(p.retain for p in replayed)
    assert not _publishes(late[2])
    # a re-subscribe: rh 0 replays again, rh 1 does not
    for c in late[:2]:
        _subscribe(c, 2, ("r/+", 0, int(c is late[1]), False))
    _drain(late)
    for c in late:
        c.assert_same(f"re-subscribe {c.port.ch.clientid}")
    # live traffic after the replay: rap false clears the bit
    pub.send(C.Publish(topic="r/9", qos=1, retain=True, payload=b"live",
                       packet_id=50))
    _drain([*late, v3, pub])
    for c in (*late, v3, pub):
        c.assert_same(f"live {c.port.ch.clientid}")
    live = [p.retain for p in _publishes(late[0]) if p.topic == "r/9"]
    assert live and not any(live)
    # a retained will stores when it fires
    w = Pair(ref, port, C.MQTT_V5)
    w.send(C.Connect(client_id="w", proto_ver=C.MQTT_V5, will=C.Will(
        topic="r/will", payload=b"gone", qos=1, retain=True)))
    w.ref.ch.connection_lost("closed")
    w.port.ch.connection_lost("closed")
    _drain([*late, v3])
    late2 = _pair(ref, port, "late2")
    _subscribe(late2, 1, ("r/will", 1, 0, False))
    _drain([late2, *late, v3])
    for c in (late2, *late, v3):
        c.assert_same(f"will {c.port.ch.clientid}")
    assert [p.payload for p in _publishes(late2)] == [b"gone"]


def test_retained_burst_past_inflight_goes_to_mqueue():
    """A replay burst larger than the inflight window queues in the
    mqueue, and past ``max_mqueue_len`` drops, as in the JAX package;
    the acks then drain the queue."""
    ref_cfg, port_cfg = RefConfig(), BrokerConfig()
    for cfg in (ref_cfg, port_cfg):
        cfg.mqtt.max_inflight = 4
        cfg.mqtt.max_mqueue_len = 10
    ref, port = RefBroker(config=ref_cfg), Broker(config=port_cfg,
                                                  device="cpu")
    pub = _pair(ref, port, "pub")
    for k in range(20):
        pub.send(C.Publish(topic=f"b/{k}", qos=1, retain=True,
                           payload=b"%d" % k, packet_id=k + 1))
    sub = _pair(ref, port, "sub")
    _subscribe(sub, 1, ("b/+", 1, 0, False))
    sub.assert_same("burst")
    assert len(_publishes(sub)) == 4
    assert len(port.cm.lookup("sub").mqueue) == 10
    assert port.metrics["delivery.dropped.queue_full"] == \
        ref.metrics.val("delivery.dropped.queue_full") == 6
    _drain([sub])
    sub.assert_same("drained")
    assert len(_publishes(sub)) == 14


# ---------------------------------------------------------- $exclusive


@pytest.mark.parametrize("ver", [C.MQTT_V5, C.MQTT_V4])
def test_exclusive_off_is_refused(ver):
    """With ``exclusive_subscription`` off (the default) ``$exclusive/``
    gets 0x8F (0x80 on 3.1.1) and subscribes nothing."""
    ref, port = RefBroker(), Broker(device="cpu")
    c = _pair(ref, port, "c", ver=ver)
    _subscribe(c, 1, ("$exclusive/a/b", 1, 0, False), ("a/b", 1, 0, False))
    c.assert_same("suback")
    suback = list(C.StreamParser(version=ver).feed(c.port.writes[-1]))[0]
    assert suback.reason_codes == [0x8F if ver == C.MQTT_V5 else 0x80, 1]
    assert port.router.subscription_count() == 1


def test_exclusive_on_grants_one_holder_and_releases():
    """With the option on: the first client holds the filter, a second
    gets 0x97; UNSUBSCRIBE and the end of the session release it."""
    ref_cfg, port_cfg = RefConfig(), BrokerConfig()
    ref_cfg.mqtt.exclusive_subscription = True
    port_cfg.mqtt.exclusive_subscription = True
    ref, port = RefBroker(config=ref_cfg), Broker(config=port_cfg,
                                                  device="cpu")
    a, b = _pair(ref, port, "a"), _pair(ref, port, "b")
    _subscribe(a, 1, ("$exclusive/x/+", 1, 0, False),
               ("$exclusive/", 1, 0, False))
    _subscribe(b, 1, ("$exclusive/x/+", 1, 0, False),
               ("$exclusive/y", 0, 0, False))
    for c in (a, b):
        c.assert_same("subscribe")
    assert list(C.StreamParser(version=C.MQTT_V5).feed(
        b.port.writes[-1]))[0].reason_codes == [0x97, 0]
    pub = _pair(ref, port, "pub")
    pub.send(C.Publish(topic="x/1", qos=1, payload=b"m", packet_id=1))
    _drain([a, b, pub])
    for c in (a, b, pub):
        c.assert_same("publish")
    assert len(_publishes(a)) == 1 and not _publishes(b)
    # UNSUBSCRIBE releases: b takes the filter
    a.send(C.Unsubscribe(packet_id=2, topic_filters=["$exclusive/x/+"]))
    _subscribe(b, 3, ("$exclusive/x/+", 1, 0, False))
    # the end of b's session releases y and x/+: a takes both
    b.send(C.Disconnect())
    _subscribe(a, 4, ("$exclusive/y", 1, 0, False),
               ("$exclusive/x/+", 2, 0, False))
    for c in (a, b):
        c.assert_same("release")
    assert list(C.StreamParser(version=C.MQTT_V5).feed(
        a.port.writes[-1]))[0].reason_codes == [1, 2]
    assert port.exclusive._holders == {"x/+": "a", "y": "a"}
