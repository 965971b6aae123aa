"""Shared subscriptions (``$share/<group>/<filter>``) in the port against
the JAX package: the `SharedSubManager`'s seven strategies pick the same
members under the same seed; the router keeps a filter's route while a
direct subscriber or a group remains; the broker writes the same bytes
to every client for groups mixed with direct subscribers, at MQTT 3.1.1
and 5.0, under the strategies whose picks do not depend on the order a
window visits its (message, filter, group) triples; a member whose
session is gone is skipped; and ``random``/``sticky`` deliver each
message to exactly one member of each group."""

import numpy as np
import pytest

from emqx_tpu.broker.broker import Broker as RefBroker
from emqx_tpu.broker.session import SubOpts as RefSubOpts
from emqx_tpu.broker.shared import STRATEGIES as REF_STRATEGIES
from emqx_tpu.broker.shared import SharedSubManager as RefManager
from emqx_tpu.codec import mqtt as C
from emqx_tpu.config import BrokerConfig as RefConfig
from emqx_tpu.message import Message as RefMessage
from emqx_tpu.router import Router as RefRouter

from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.broker.session import SubOpts
from emqx_tpu_torch.broker.shared import STRATEGIES, SharedSubManager
from emqx_tpu_torch.config import BrokerConfig
from emqx_tpu_torch.engine import MatchEngine
from emqx_tpu_torch.message import Message
from emqx_tpu_torch.router import Router

from test_torch_broker import Pair

# the strategies whose picks do not depend on the order in which a
# window visits its (message, filter, group) triples (round_robin_per_group
# only with one filter per group, as below)
ORDER_FREE = ("round_robin", "round_robin_per_group", "hash_clientid",
              "hash_topic")


# ------------------------------------------------------------ manager


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_manager_picks_equal_reference(strategy):
    """A numpy-seeded script of joins, leaves, leave_alls and picks
    (with and without ``exclude``) gives the same picks, members and
    groups on both managers under the same seed."""
    assert STRATEGIES == REF_STRATEGIES
    rng = np.random.default_rng(7)
    ref, port = RefManager(strategy, seed=11), SharedSubManager(strategy,
                                                               seed=11)
    groups, filters = ["g1", "g2", "g3"], ["a/+", "a/#", "b"]
    clients = [f"c{i}" for i in range(6)]
    got, want = [], []
    for _ in range(600):
        op = rng.integers(0, 10)
        g = groups[rng.integers(0, 3)]
        f = filters[rng.integers(0, 3)]
        c = clients[rng.integers(0, 6)]
        if op < 3:
            want.append(ref.join(g, f, c))
            got.append(port.join(g, f, c))
        elif op == 3:
            want.append(ref.leave(g, f, c))
            got.append(port.leave(g, f, c))
        elif op == 4 and rng.integers(0, 4) == 0:
            want.append(ref.leave_all(c))
            got.append(port.leave_all(c))
        else:
            topic = f"a/t{rng.integers(0, 5)}"
            excl = ({clients[rng.integers(0, 6)]}
                    if rng.integers(0, 3) == 0 else None)
            want.append(ref.pick(g, f, RefMessage(topic=topic,
                                                  from_client=c), excl))
            got.append(port.pick(g, f, Message(topic=topic, from_client=c),
                                 excl))
        want.append((sorted(ref.groups_for(f)), ref.members(g, f)))
        got.append((sorted(port.groups_for(f)), port.members(g, f)))
    assert got == want
    assert sum(x is not None and not isinstance(x, (bool, list, tuple))
               for x in got) > 100  # real picks happened


def test_manager_refuses_unknown_strategy():
    with pytest.raises(ValueError):
        SharedSubManager("nope")


# ------------------------------------------------------------- router


def test_router_shared_and_direct_same_filter():
    """The reference's router test on both routers: the route lives
    while a direct subscriber or a group remains."""
    for r, opts, eng in (
        (RefRouter(), RefSubOpts, None),
        (Router(MatchEngine(device="cpu")), SubOpts, "port"),
    ):
        match = (r.engine.match_batch if eng else r.match_batch)
        r.subscribe("c1", "t/x", opts(qos=1))
        r.subscribe("c2", "$share/g/t/x", opts(qos=1))
        assert match(["t/x"])[0] == {"t/x"}
        assert r.shared.members("g", "t/x") == ["c2"]
        assert r.subscription_count() == 2
        assert sorted(r.topics()) == ["t/x"]
        r.unsubscribe("c1", "t/x")
        assert match(["t/x"])[0] == {"t/x"}
        assert r.shared_opts("t/x", "g", "c2").share_group == "g"
        assert r.shared_slot_of("t/x", "g", "c2") is not None
        r.unsubscribe("c2", "$share/g/t/x")
        assert match(["t/x"])[0] == set()
        assert r.subscription_count() == 0 and r.topics() == []


def test_router_shared_slots_join_the_opts_columns():
    """A shared subscription's options take a slot of the opts table
    that K3 reads; it is freed on leave and reused."""
    r = Router(MatchEngine(device="cpu"))
    r.subscribe("c1", "$share/g/a/+", SubOpts(qos=2, retain_as_published=True))
    slot = r.shared_slot_of("a/+", "g", "c1")
    qos, nl, rap, subid = r.opts_columns()
    assert (qos[slot], nl[slot], rap[slot], subid[slot]) == (2, 0, 1, 0)
    r.subscribe("c1", "$share/g/a/+", SubOpts(qos=1))  # refresh
    assert r.shared_slot_of("a/+", "g", "c1") == slot
    assert r.opts_columns()[0][slot] == 1
    r.cleanup_client("c1")
    assert r.shared_slot_of("a/+", "g", "c1") is None
    assert r.shared.groups_for("a/+") == []
    r.subscribe("c2", "d", SubOpts())
    assert r.opts_at(slot) is not None  # the freed slot is reused
    *_, shared = r.expand_window([{"d"}])
    assert shared == []


# -------------------------------------------------------- wire bytes

GROUPS = {
    # clientid: (version, [(filter, qos, rap)])
    "m1": (C.MQTT_V5, [("$share/g1/s/+/a", 1, False), ("s/#", 0, False)]),
    "m2": (C.MQTT_V4, [("$share/g1/s/+/a", 2, False)]),
    "m3": (C.MQTT_V5, [("$share/g1/s/+/a", 0, False),
                       ("$share/g2/s/x/#", 1, True)]),
    "m4": (C.MQTT_V4, [("$share/g2/s/x/#", 1, False)]),
    "m5": (C.MQTT_V5, [("$share/g2/s/x/#", 2, True),
                       ("$share/g3/k/#", 1, False)]),
    "d1": (C.MQTT_V5, [("s/x/a", 1, False)]),
    "m6": (C.MQTT_V4, [("$share/g3/k/#", 2, False)]),
}
TOPICS = ["s/x/a", "s/y/a", "s/x/b/c", "k/1", "s/z/a", "k/2/3", "none"]


def _pub_clients(ref, port):
    pubs = []
    for cid, ver in (("p1", C.MQTT_V5), ("p2", C.MQTT_V4)):
        p = Pair(ref, port, ver)
        p.send(C.Connect(client_id=cid, proto_ver=ver, keepalive=30))
        pubs.append(p)
    return pubs


def _shared_world(ref, port, rounds=3, seed=5):
    clients = {}
    for cid, (ver, subs) in GROUPS.items():
        c = clients[cid] = Pair(ref, port, ver)
        # m4 (3.1.1) keeps its session past a disconnect
        c.send(C.Connect(client_id=cid, proto_ver=ver, keepalive=30,
                         clean_start=cid != "m4",
                         properties={"session_expiry_interval": 60}
                         if ver == C.MQTT_V5 else {}))
        c.send(C.Subscribe(packet_id=1, subscriptions=[
            C.Subscription(topic_filter=f, qos=q, retain_as_published=rap)
            for f, q, rap in subs]))
        c.assert_same(f"subscribe {cid}")
    port.router.engine.rebuild()
    ref.router.engine.rebuild()
    pubs = _pub_clients(ref, port)
    rng = np.random.default_rng(seed)
    pid = 1
    for r in range(rounds):
        for k in range(10):
            p = pubs[rng.integers(0, 2)]
            qos = int(rng.integers(0, 3))
            topic = TOPICS[rng.integers(0, len(TOPICS))]
            p.send(C.Publish(topic=topic, qos=qos,
                             retain=bool(rng.integers(0, 4) == 0),
                             payload=b"m%d" % pid,
                             packet_id=pid if qos else None))
            if qos == 2:
                p.send(C.Pubrel(packet_id=pid))
            pid += 1
            while sum(c.auto_ack() for c in clients.values()):
                pass
        for c in [*clients.values(), *pubs]:
            c.assert_same(f"round {r}")
        if r == 0:
            # m2 leaves g1, m4 disconnects (its session stays, detached:
            # a detached member still takes picks and queues QoS>0)
            clients["m2"].send(C.Unsubscribe(
                packet_id=3, topic_filters=["$share/g1/s/+/a"]))
            clients["m4"].send(C.Disconnect())
        if r == 1:
            # m3 leaves every group with its session (expiry 0 on v5)
            clients["m3"].send(C.Disconnect(
                properties={"session_expiry_interval": 0}))
    return clients


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("strategy", ORDER_FREE)
def test_shared_wire_bytes_equal_reference(strategy, native):
    ref = RefBroker(shared_strategy=strategy)
    port = Broker(device="cpu", native=native, shared_strategy=strategy)
    clients = _shared_world(ref, port)
    # the direct subscriber and each group took deliveries
    seen = {cid: sum(p.type == C.PUBLISH for p in C.StreamParser(
                version=c.version).feed(b"".join(c.port.writes)))
            for cid, c in clients.items()}
    assert seen["d1"] and seen["m1"] > seen["d1"], seen
    assert seen["m3"] + seen["m4"] + seen["m5"] and seen["m5"] + seen["m6"]
    assert port.router.engine.counters["decide_windows"] > 0
    assert port.metrics["messages.dropped.no_subscribers"] == \
        ref.metrics.val("messages.dropped.no_subscribers")


def test_shared_only_message_is_delivered_not_dropped():
    """A message only a group received counts as delivered: the drop
    count reads the merged (direct + shared) message column."""
    b = Broker(device="cpu", native=False, shared_strategy="round_robin")
    ref = RefBroker(shared_strategy="round_robin")
    for br, msg, opts in ((b, Message, SubOpts), (ref, RefMessage,
                                                  RefSubOpts)):
        chans = _fake_connect(br, ["c1"])
        br.subscribe("c1", "$share/g/t", opts(qos=0))
        assert br.publish_many([msg(topic="t"), msg(topic="u")]) == [1, 0]
        val = br.metrics.val if hasattr(br.metrics, "val") else \
            br.metrics.__getitem__
        assert val("messages.dropped.no_subscribers") == 1
        assert val("messages.delivered") == 1
        assert len(chans["c1"].sent) == 1


def test_direct_delivery_stays_ahead_of_shared_for_one_client():
    """One client that is both a direct subscriber and a group member
    gets the direct delivery first for each message (the stable sort),
    with the direct and shared subscriptions' own options."""
    b = Broker(device="cpu", native=False, shared_strategy="round_robin")
    chans = _fake_connect(b, ["c1"])
    b.subscribe("c1", "$share/g/t/+", SubOpts(qos=1))
    b.subscribe("c1", "t/#", SubOpts(qos=0))
    assert b.publish_many([Message(topic="t/a", qos=2, payload=b"1"),
                           Message(topic="t/b", qos=2, payload=b"2")]) \
        == [2, 2]
    assert [(p.payload, p.qos) for p in chans["c1"].sent] == [
        (b"1", 0), (b"1", 1), (b"2", 0), (b"2", 1)]


# ----------------------------------------------------------- skip-dead


class FakeChannel:
    version = C.MQTT_V5

    def __init__(self):
        self.sent = []
        self.closed = None

    def send_packets(self, pkts):
        self.sent.extend(pkts)

    def cork(self):
        pass

    def uncork(self):
        pass

    def close(self, reason):
        self.closed = reason


def _fake_connect(b, cids):
    """Open a clean session for each client id on a `FakeChannel`
    (the port's broker takes it with ``native=False``)."""
    out = {}
    for cid in cids:
        ch = out[cid] = FakeChannel()
        b.cm.open_session(True, cid, ch, expiry_interval=0.0)
    return out


@pytest.mark.parametrize("side", ["ref", "port"])
def test_shared_dispatch_picks_one_and_skips_dead(side):
    """The JAX package's skip-dead scenario (a kicked member leaves its
    group; a member whose session vanished without a discard stays in
    the group and is skipped), on both brokers.  ``native=False``: the
    fake channel takes packets, not a spliced wire."""
    if side == "ref":
        b, msg, opts = RefBroker(shared_strategy="round_robin"), \
            RefMessage, RefSubOpts
    else:
        b, msg, opts = Broker(device="cpu", native=False,
                              shared_strategy="round_robin"), \
            Message, SubOpts
    chans = _fake_connect(b, ["c1", "c2", "c3"])
    for cid in ("c1", "c2"):
        b.cm.lookup(cid).subscribe("$share/g/t", opts(qos=0))
        b.subscribe(cid, "$share/g/t", opts(qos=0))
    for _ in range(4):
        assert b.publish(msg(topic="t")) == 1
    assert len(chans["c1"].sent) == 2 and len(chans["c2"].sent) == 2
    b.cm.kick("c1")  # discarded: leaves the group
    assert chans["c1"].closed == "kicked"
    assert b.router.shared.members("g", "t") == ["c2"]
    for _ in range(2):
        assert b.publish(msg(topic="t")) == 1
    assert len(chans["c2"].sent) == 4
    # c3 joins; its session then vanishes with no discard: it stays a
    # member and every pick that lands on it moves on to c2
    b.subscribe("c3", "$share/g/t", opts(qos=0))
    assert b.cm.remove("c3") and not b.cm.remove("c3")
    assert b.router.shared.members("g", "t") == ["c2", "c3"]
    for _ in range(4):
        assert b.publish(msg(topic="t")) == 1
    assert len(chans["c2"].sent) == 8 and not chans["c3"].sent
    # the last live member gone: nobody takes the message
    b.cm.remove("c2")
    assert b.publish(msg(topic="t")) == 0


# ------------------------------------------------------- reason codes


@pytest.mark.parametrize("shared_on", [True, False])
def test_share_reason_codes_and_connack(shared_on):
    """``$share`` with no-local gives 0x82 (MQTT-3.8.3-4); with
    ``shared_subscription = False`` every ``$share`` gets 0x9E (0x80 on
    3.1.1) and the CONNACK says shared subscriptions are unavailable."""
    ref_cfg, port_cfg = RefConfig(), BrokerConfig()
    ref_cfg.mqtt.shared_subscription = shared_on
    port_cfg.mqtt.shared_subscription = shared_on
    ref, port = RefBroker(config=ref_cfg), Broker(config=port_cfg,
                                                  device="cpu")
    for ver in (C.MQTT_V5, C.MQTT_V4):
        c = Pair(ref, port, ver)
        c.send(C.Connect(client_id=f"c{ver}", proto_ver=ver))
        c.send(C.Subscribe(packet_id=1, subscriptions=[
            C.Subscription(topic_filter="$share/g/a/+", qos=1,
                           no_local=True),
            C.Subscription(topic_filter="$share/g/a/+", qos=1),
            C.Subscription(topic_filter="$share/g", qos=1),
            C.Subscription(topic_filter="a/+", qos=2, no_local=True),
        ]))
        c.assert_same(f"v{ver}")
        connack, suback = (list(C.StreamParser(version=ver).feed(w))[0]
                           for w in c.port.writes[:2])
        assert ("shared_subscription_available" in connack.properties) \
            == (ver == C.MQTT_V5 and not shared_on)
        if ver == C.MQTT_V5:
            assert suback.reason_codes == (
                [0x82, 1, 0x8F, 2] if shared_on else [0x9E, 0x9E, 0x8F, 2])


# ----------------------------------------------------------- invariant


@pytest.mark.parametrize("strategy", ["random", "sticky"])
def test_random_and_sticky_pick_exactly_one_member_per_group(strategy):
    """The order-dependent strategies are held to a rule: each message
    reaches exactly one live member of each group it matches."""
    b = Broker(device="cpu", native=False, shared_strategy=strategy)
    members = {"g1": ["a1", "a2", "a3"], "g2": ["b1", "b2"],
               "g3": ["c1", "c2", "c3", "c4"]}
    filters = {"g1": "x/+", "g2": "x/#", "g3": "+/+"}
    chans = _fake_connect(b, [m for ms in members.values() for m in ms])
    for g, ms in members.items():
        for m in ms:
            b.subscribe(m, f"$share/{g}/{filters[g]}", SubOpts(qos=0))
    b.router.engine.rebuild()
    msgs = [Message(topic=f"x/{k % 7}", qos=1, payload=b"%d" % k)
            for k in range(90)]
    for k in range(0, 90, 30):
        assert b.publish_many(msgs[k:k + 30]) == [3] * 30
    for g, ms in members.items():
        got = sorted(p.payload for m in ms for p in chans[m].sent)
        assert got == sorted(m.payload for m in msgs), g
    if strategy == "sticky":
        for g, ms in members.items():
            assert sum(bool(chans[m].sent) for m in ms) == 1, g
