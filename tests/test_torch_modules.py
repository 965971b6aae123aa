"""The port's broker modules and guards against the JAX package's:
delayed publish, topic rewrite (publish and subscribe), topic metrics,
the rate limiter's buckets under an injected clock, alarms, the slow-
subscriber board and the ``$SYS`` heartbeat; and the slice as a whole,
authentication + ACL + rewrite + delayed publish + topic metrics + a
``$SYS`` subscriber, through the `Pair` harness with the native host
path on and off.  Clocks are injected (``tick(now)``, a patched
``time.time``/``time.monotonic``); nothing sleeps."""

import json
import time
import types

import pytest

from emqx_tpu import access as RA
from emqx_tpu import limiter as RL
from emqx_tpu import ops_guard as RG
from emqx_tpu import sys_topics as RS
from emqx_tpu.broker.broker import Broker as RefBroker
from emqx_tpu.codec import mqtt as C
from emqx_tpu.config import BrokerConfig as RefConfig
from emqx_tpu.modules import RewriteRule as RefRule

from emqx_tpu_torch import access as PA
from emqx_tpu_torch import limiter as PL
from emqx_tpu_torch import ops_guard as PG
from emqx_tpu_torch import sys_topics as PS
from emqx_tpu_torch.broker import broker as port_broker
from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.config import BrokerConfig
from emqx_tpu_torch.modules import RewriteRule
from emqx_tpu_torch.ops import dispatchasm

from test_torch_broker import Pair


class Clock:
    """A ``time.time`` both packages read, moved by the test."""

    def __init__(self, monkeypatch):
        self.now = time.time()
        monkeypatch.setattr(time, "time", lambda: self.now)


def _brokers(native, **cfg):
    ref_cfg, port_cfg = RefConfig(), BrokerConfig()
    for c in (ref_cfg, port_cfg):
        for k, v in cfg.items():
            sect, _, name = k.partition("__")
            setattr(getattr(c, sect), name, v)
    return (RefBroker(config=ref_cfg),
            Broker(config=port_cfg, device="cpu", native=native))


def _client(ref, port, cid, subs=(), version=C.MQTT_V5, **kw):
    c = Pair(ref, port, version)
    c.send(C.Connect(client_id=cid, proto_ver=version, **kw))
    if subs:
        c.send(C.Subscribe(packet_id=1, subscriptions=[
            C.Subscription(topic_filter=f, qos=q) for f, q in subs]))
    c.assert_same(f"connect {cid}")
    return c


def _settle(clients, same=True):
    while sum(c.auto_ack() for c in clients):
        pass
    for c in clients:
        if same:
            c.assert_same(c.port.ch.clientid)


def _tick(ref, port, now):
    ref.tick(now)
    port.tick(now)


# ----------------------------------------------------- delayed publish

@pytest.mark.parametrize("native", [True, False])
def test_delayed_publish_is_delivered_after_tick(native, monkeypatch):
    """``$delayed/<s>/topic`` is swallowed at publish (PUBACK 0x10 on
    MQTT 5: no subscriber got it yet) and delivered on the real topic by
    the first ``tick`` at or past its time, exactly once; a malformed
    delay counts as dropped."""
    clock = Clock(monkeypatch)
    ref, port = _brokers(native)
    sub = _client(ref, port, "s", [("a/#", 1)])
    pub = _client(ref, port, "p")
    for k, topic in enumerate(("$delayed/0/a/b", "$delayed/5/a/c",
                               "$delayed/x/a/d", "$delayed/3")):
        pub.send(C.Publish(topic=topic, qos=1, payload=b"%d" % k,
                           packet_id=k + 1))
    _settle([sub, pub])
    assert [p.reason_code for p in C.StreamParser(version=5).feed(
        b"".join(pub.port.writes)) if p.type == C.PUBACK] == [0x10] * 4
    n0 = len(sub.port.writes)
    assert len(port.delayed) == 2
    assert port.metrics["messages.delayed"] == 2
    # the fold swallows all four; the two malformed count twice
    assert port.metrics["messages.dropped"] == 4 + 2
    _tick(ref, port, clock.now + 1)
    _settle([sub, pub])
    assert len(sub.port.writes) == n0 + 1 and len(port.delayed) == 1
    _tick(ref, port, clock.now + 2)
    _settle([sub, pub])
    assert len(sub.port.writes) == n0 + 1
    _tick(ref, port, clock.now + 6)
    _settle([sub, pub])
    got = [(p.topic, p.payload) for p in C.StreamParser(version=5).feed(
        b"".join(sub.port.writes)) if p.type == C.PUBLISH]
    assert got == [("a/b", b"0"), ("a/c", b"1")]
    assert len(port.delayed) == 0
    assert port.metrics.all() == ref.metrics.all()


# -------------------------------------------------------- topic rewrite

def _rewrite_rules(R):
    return [R("all", "x/#", r"^x/(.+)$", r"y/\1"),
            R("subscribe", "s/+", r"^s/(\w+)$", r"sub/\1"),
            R("publish", "p/+/+", r"^p/(\w+)/(\w+)$", r"q/\2/\1")]


@pytest.mark.parametrize("native", [True, False])
def test_topic_rewrite_pub_and_sub(native, monkeypatch):
    """Publish and subscribe rewrites, the last matching rule winning;
    ``$``-topics never rewritten; a delayed publish rewritten when
    ``tick`` releases it; UNSUBSCRIBE takes the same rewrite."""
    clock = Clock(monkeypatch)
    ref, port = _brokers(native)
    for r in _rewrite_rules(RefRule):
        ref.rewrite.add_rule(r)
    for r in _rewrite_rules(RewriteRule):
        port.rewrite.add_rule(r)
    assert port.rewrite.rewrite_sub("s/a") == "sub/a"
    assert port.rewrite.rewrite_sub("$share/g/x/1") == "$share/g/x/1"
    s1 = _client(ref, port, "s1", [("s/a", 1), ("y/#", 2)])
    s2 = _client(ref, port, "s2", [("q/#", 1), ("x/#", 0)])
    pub = _client(ref, port, "p")
    clients = [s1, s2, pub]
    for k, topic in enumerate(("x/1", "p/a/b", "s/a", "sub/a",
                               "$delayed/0/x/2", "$SYS/x/1")):
        pub.send(C.Publish(topic=topic, qos=1, payload=b"%d" % k,
                           packet_id=k + 1))
        _settle(clients)
    _tick(ref, port, clock.now + 1)
    _settle(clients)
    s1.send(C.Unsubscribe(packet_id=7, topic_filters=["s/a", "x/#"]))
    pub.send(C.Publish(topic="sub/a", qos=1, payload=b"late", packet_id=9))
    _settle(clients)
    topics = [p.topic for p in C.StreamParser(version=5).feed(
        b"".join(s1.port.writes)) if p.type == C.PUBLISH]
    assert topics == ["y/1", "sub/a", "y/2"]
    assert port.metrics.all() == ref.metrics.all()


# -------------------------------------------------------- topic metrics

def _tm_info(b):
    return [{k: v for k, v in m.items() if k != "created_at"}
            for m in b.topic_metrics.info()]


@pytest.mark.parametrize("native", [True, False])
def test_topic_metrics_in_out_and_rate(native, monkeypatch):
    clock = Clock(monkeypatch)
    ref, port = _brokers(native)
    for b in (ref, port):
        assert not b.hooks.has("message.delivered")
        assert b.topic_metrics.register("m/#")
        assert b.topic_metrics.register("m/+/x")
        assert b.hooks.has("message.delivered")
    subs = [_client(ref, port, f"s{i}", [(f, q)]) for i, (f, q) in
            enumerate((("m/#", 1), ("m/+/x", 0), ("#", 2)))]
    pub = _client(ref, port, "p")
    for k, (topic, qos) in enumerate((("m/a/x", 0), ("m/b", 1),
                                      ("m/c/x", 2), ("n/a", 1),
                                      ("m/d/x", 1))):
        pub.send(C.Publish(topic=topic, qos=qos, payload=b"v",
                           packet_id=k + 1 if qos else None))
        if qos == 2:
            pub.send(C.Pubrel(packet_id=k + 1))
        _settle(subs + [pub])
    _tick(ref, port, clock.now + 2)
    assert _tm_info(port) == _tm_info(ref)
    info = {m["topic"]: m for m in port.topic_metrics.info()}
    assert info["m/#"]["messages.in"] == 4
    assert info["m/#"]["messages.out"] == 4 + 3 + 4
    assert info["m/+/x"]["rate.in"] == 3 / 2
    for b in (ref, port):
        b.topic_metrics.unregister("m/#")
        b.topic_metrics.unregister("m/+/x")
        assert not b.hooks.has("message.delivered")


@pytest.mark.parametrize("with_hook", [False, True])
def test_window_builds_run_lists_only_for_a_delivered_hook(with_hook,
                                                           monkeypatch):
    """Without a ``message.delivered`` hook no run builds its
    ``(msg, opts)`` list; with `TopicMetrics` registered the runs build
    it, and the native splice still takes the same runs."""
    b = Broker(device="cpu")
    built, spliced = [], []
    orig_mat = Broker._materialize_run
    monkeypatch.setattr(Broker, "_materialize_run",
                        lambda *a: built.append(1) or orig_mat(*a))
    orig_dec = port_broker._Decided.decided
    monkeypatch.setattr(port_broker._Decided, "decided",
                        lambda *a: built.append(2) or orig_dec(*a))
    orig_asm = dispatchasm.assemble_window
    monkeypatch.setattr(dispatchasm, "assemble_window",
                        lambda views, body, pid, starts, *a: spliced.append(
                            len(starts)) or orig_asm(views, body, pid,
                                                     starts, *a))
    if with_hook:
        b.topic_metrics.register("w/#")
    ref = RefBroker()
    subs = [_client(ref, b, f"s{i}", [("w/#", i % 3)]) for i in range(6)]
    pub = _client(ref, b, "p")
    b.router.engine.rebuild()
    for k in range(4):
        pub.send(C.Publish(topic=f"w/{k}", qos=1, payload=b"x",
                           packet_id=k + 1))
    _settle(subs + [pub])
    assert spliced == [6] * 4
    assert (len(built) == 6 * 4) if with_hook else not built
    if with_hook:
        assert b.topic_metrics.info()[0]["messages.out"] == 24


# -------------------------------------------------------------- limiter

def test_limiter_buckets_equal_reference_under_injected_clock(monkeypatch):
    t = [100.0]
    fake = types.SimpleNamespace(monotonic=lambda: t[0], time=time.time)
    monkeypatch.setattr(RL, "time", fake)
    monkeypatch.setattr(PL, "time", fake)
    got = []
    for L in (RL, PL):
        t[0] = 100.0
        bucket = L.TokenBucket(10, burst=20)
        conn = L.ConnectionLimiter(messages_rate=5, bytes_rate=100)
        shared = L.ConnectionLimiter(messages_rate=8, shared=True)
        tree = L.HierarchicalLimiter(L.ConnectionLimiter(messages_rate=50),
                                     shared, None)
        out = []
        for k in range(40):
            t[0] += 0.05 * (k % 4)
            out.append((bucket.consume(3, now=t[0]),
                        conn.consume(30 * (k % 3), k % 2),
                        tree.consume(0, 1)))
            if k == 20:
                bucket.clamp(0.5)
                shared.clamp(0.25)
        got.append(out)
    assert got[0] == got[1]
    assert any(x[2] > 0 for x in got[1]) and any(x[0] > 0 for x in got[1])
    assert PL.HierarchicalLimiter(None, None).consume(10, 1) == 0.0


# ------------------------------------------------------ alarms and slow

def test_alarms_publish_and_expire_like_reference():
    """activate (with ttl), duplicate, update with re-raise damping,
    held deactivate cancelled by a re-activate, tick expiry: the same
    ``$SYS/brokers/<node>/alarms/...`` bytes to a ``$SYS/#``
    subscriber, the same active set and history."""
    ref, port = _brokers(True)
    watch = _client(ref, port, "w", [("$SYS/#", 0)])
    t0 = 1000.0
    for b in (ref, port):
        a = b.alarms
        assert a.activate("high_load", details={"v": 1}, ttl=30, now=t0)
        assert not a.activate("high_load", now=t0 + 1)
        a.update("olp", details={"level": 1}, min_reraise=10, now=t0)
        assert not a.update("olp", details={"level": 2}, min_reraise=10,
                            now=t0 + 5)
        assert a.update("olp", details={"level": 3}, min_reraise=10,
                        now=t0 + 11)
        a.activate("held", now=t0)
        assert not a.deactivate("held", hold=5, now=t0 + 1)
        a.activate("held", now=t0 + 2)  # cancels the held deactivate
        a.tick(now=t0 + 10)
        assert [x.name for x in a.active()] == ["high_load", "olp", "held"]
        a.deactivate("olp", hold=2, now=t0 + 12)
        a.tick(now=t0 + 40)
    watch.assert_same("alarms")
    for b in (ref, port):
        assert [x.name for x in b.alarms.active()] == ["held"]
        assert [x.name for x in b.alarms.history()] == ["high_load", "olp"]
    assert port.metrics["alarms.activate"] == ref.metrics.val(
        "alarms.activate") == 4


def test_slow_subs_board_equal_reference(monkeypatch):
    clock = Clock(monkeypatch)
    boards = []
    for G in (RG, PG):
        clock.now = 5000.0
        s = G.SlowSubs(top_k=3, threshold_ms=100, expire_interval=60)
        for k, lat in enumerate((50, 300, 120, 900, 101, 400, 99)):
            clock.now += 10
            s.record(f"c{k}", f"t/{k}", lat)
        top = s.top()
        expired = s.tick(now=clock.now + 35)
        boards.append((top, expired, s.top()))
    assert boards[0] == boards[1]
    assert [e["latency_ms"] for e in boards[1][0]] == [900, 400, 300]


# ----------------------------------------------------------------- $SYS

def _sys_shape(msg):
    try:
        body = json.loads(msg.payload)
    except ValueError:
        body = None
    keys = sorted(body) if isinstance(body, dict) else type(body).__name__
    return (msg.topic, msg.qos, msg.retain, msg.sys, keys)


def test_sys_heartbeat_shape_equal_reference(monkeypatch):
    """The heartbeat set: the same topics, QoS, flags and JSON keys
    (values differ: uptime, clocks, engine counters); published only
    when the interval elapsed."""
    ref, port = _brokers(True, sys__interval=10)
    _client(ref, port, "s", [("a/+", 1), ("$share/g/b", 0)])
    pub = _client(ref, port, "p")
    pub.send(C.Publish(topic="a/1", qos=1, payload=b"x", packet_id=1,
                       retain=True))
    shapes = []
    for S, b in ((RS, ref), (PS, port)):
        sysm = S.SysTopics(b)
        shapes.append([_sys_shape(m) for m in sysm.heartbeat_messages()])
        assert sysm.tick(now=1000.0) == len(shapes[-1])
        assert sysm.tick(now=1005.0) == 0
        assert sysm.tick(now=1010.0) == len(shapes[-1])
    assert shapes[0] == shapes[1]
    topics = [s[0].rsplit("/", 1)[-1] for s in shapes[1]]
    assert topics[:4] == ["version", "uptime", "datetime", "sysdescr"]
    assert "profiler" in topics
    pm = {m.topic.rsplit("/", 1)[-1]: m
          for m in PS.SysTopics(port).heartbeat_messages()}
    assert json.loads(pm["metrics"].payload) == port.metrics.all()
    assert json.loads(pm["stats"].payload)["subscriptions.count"] == 2


# -------------------------------------------------------- the whole slice

ACL = [
    ("deny", "all", "subscribe", ["$SYS/#", {"eq": "#"}]),
    ("allow", "all", "publish", ["dev/%c/#", "$delayed/+/dev/%c/#"]),
    ("allow", "all", "subscribe", ["dev/#", "fleet/#"]),
]


def _packets(w, version):
    return list(C.StreamParser(version=version).feed(b"".join(w.writes)))


def _same_packets(c, version):
    """Every packet equal in bytes, except the ``$SYS`` heartbeats'
    payloads: those equal in JSON keys (or both not JSON)."""
    got, want = _packets(c.port, version), _packets(c.ref, version)
    assert len(got) == len(want)
    n_sys = 0
    for g, w in zip(got, want):
        hb = (g.type == C.PUBLISH and g.topic.startswith("$SYS/brokers/")
              and "/alarms/" not in g.topic)
        if hb:
            n_sys += 1
            assert (g.topic, g.qos, g.retain, g.dup, g.packet_id) == (
                w.topic, w.qos, w.retain, w.dup, w.packet_id)
            gj, wj = (_sys_shape(types.SimpleNamespace(
                topic="", qos=0, retain=0, sys=0, payload=p.payload))
                for p in (g, w))
            assert gj == wj, g.topic
        else:
            assert C.serialize(g, version) == C.serialize(w, version)
    return n_sys


@pytest.mark.parametrize("native", [True, False])
def test_slice_wire_equal_reference(native, monkeypatch):
    """authn + ACL + rewrite + delayed publish + topic metrics + a
    superuser ``$SYS/#`` subscriber, on a small world through K1's and
    K3's plain versions: the same packets to every client, the same
    topic metrics, the same access counters."""
    clock = Clock(monkeypatch)
    ref, port = _brokers(native, auth__allow_anonymous=False,
                         auth__authz_default="deny", sys__interval=1)
    for b, A, R in ((ref, RA, RefRule), (port, PA, RewriteRule)):
        d = A.DictAuthenticator()
        for k in range(4):
            d.add_user(f"u{k}", f"pw{k}")
        d.add_user("root", "rootpw", is_superuser=True)
        b.access.authenticators.append(d)
        b.access.authz_sources.append(A.AclProvider(
            A.AclRule(p, w, a, t) for p, w, a, t in ACL))
        b.rewrite.add_rule(R("publish", "dev/+/raw/#",
                             r"^dev/(\w+)/raw/(.+)$", r"fleet/\1/\2"))
        b.topic_metrics.register("fleet/#")
    syss = [RS.SysTopics(ref), PS.SysTopics(port)]
    bad = _client(ref, port, "c9", username="u1", password=b"nope")
    assert bad.port.writes == [bytes.fromhex("2003008600")]
    root = _client(ref, port, "root", [("$SYS/#", 0), ("fleet/#", 1)],
                   username="root", password=b"rootpw")
    subs = [_client(ref, port, f"s{k}", [("fleet/#", k % 3), ("#", 0),
                                         ("dev/#", 1)],
                    version=(C.MQTT_V5, C.MQTT_V4)[k % 2],
                    username=f"u{k}", password=b"pw%d" % k)
            for k in range(2)]
    pubs = [_client(ref, port, f"c{k}", username=f"u{k}",
                    password=b"pw%d" % k) for k in (2, 3)]
    clients = [root, *subs, *pubs]
    port.router.engine.rebuild()
    ref.router.engine.rebuild()
    k = 0
    for step in range(3):
        for p in pubs:
            cid = p.port.ch.clientid
            for topic in (f"dev/{cid}/raw/t{step}", f"dev/{cid}/ok",
                          f"dev/other/raw/x", f"$delayed/1/dev/{cid}/raw/d"):
                k += 1
                p.send(C.Publish(topic=topic, qos=1 + k % 2,
                                 payload=b"%d" % k, packet_id=k))
                if k % 2:
                    p.send(C.Pubrel(packet_id=k))
            _settle(clients, same=False)
        clock.now += 1.5
        _tick(ref, port, clock.now)
        for s in syss:
            s.tick(clock.now)
        _settle(clients, same=False)
    n_sys = sum(_same_packets(c, c.version) for c in clients)
    assert n_sys >= 3 * len(syss[1].heartbeat_messages())
    assert _tm_info(port) == _tm_info(ref)
    fm = port.topic_metrics.info()[0]
    assert fm["messages.in"] == 12 and fm["messages.out"] == 12 * 3
    for name in ("client.authenticate", "client.authorize",
                 "authorization.allow", "authorization.deny",
                 "packets.publish.auth_error",
                 "packets.subscribe.auth_error", "messages.delayed",
                 "messages.delivered"):
        assert port.metrics[name] == ref.metrics.val(name) > 0, name


def test_server_limiter_levels_and_connection_pause(monkeypatch):
    """Each `BrokerServer` listener gives each connection its own
    buckets, the listener's shared ones and the broker's zone buckets; a
    connection sleeps a limiter's whole deficit in 1 s slices
    (asyncio.sleep is recorded, not waited)."""
    import asyncio

    from emqx_tpu_torch.broker import connection as conn_mod
    from emqx_tpu_torch.broker.listener import BrokerServer

    cfg = BrokerConfig()
    lc = cfg.listeners[0]
    assert BrokerServer(cfg, device="cpu").listeners[0]._make_limiter() \
        is None
    lc.messages_rate = 10
    only = BrokerServer(cfg, device="cpu").listeners[0]._make_limiter()
    assert isinstance(only, PL.ConnectionLimiter)
    lc.max_bytes_rate = 1000
    cfg.mqtt.zone_messages_rate = 50
    srv = BrokerServer(cfg, device="cpu")
    lst = srv.listeners[0]
    tree = lst._make_limiter()
    assert isinstance(tree, PL.HierarchicalLimiter)
    assert tree.levels[1:] == [lst._shared_limiter, srv.broker.zone_limiter]
    assert lst._make_limiter().levels[1] is tree.levels[1]
    slept = []

    async def fake_sleep(s):
        slept.append(s)

    monkeypatch.setattr(conn_mod.asyncio, "sleep", fake_sleep)
    c = conn_mod.Connection.__new__(conn_mod.Connection)
    c.broker = srv.broker
    c.limiter = types.SimpleNamespace(consume=lambda nb, nm: 2.5)
    c._closed = asyncio.Event()
    asyncio.run(c._limit(10, 1))
    assert slept == [1.0, 1.0, 0.5]
    assert srv.broker.metrics["connection.rate_limited"] == 1
