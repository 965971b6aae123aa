"""Authentication, authorization, the banned list and the flapping
detector of the port against the JAX package's: the provider chains
(salted SHA-256, PBKDF2, HS256 JWT) and the ACL (``%c``/``%u``,
``{"eq": ...}``, superuser, ``authz_default``) give the same verdicts;
and through the `Pair` harness, with the native host path on and off,
CONNECT refusals, denied publishes under both ``deny_action``s, denied
subscriptions, bans and the flapping ban write the same bytes and count
the same metrics."""

import asyncio
import time

import pytest

from emqx_tpu import access as RA
from emqx_tpu import auth_providers as RP
from emqx_tpu import hooks as RH
from emqx_tpu.broker.broker import Broker as RefBroker
from emqx_tpu.codec import mqtt as C
from emqx_tpu.config import BrokerConfig as RefConfig

from emqx_tpu_torch import access as PA
from emqx_tpu_torch import auth_providers as PP
from emqx_tpu_torch import hooks as PH
from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.config import BrokerConfig

from test_torch_broker import Pair

SIDES = ((RA, RP, RH), (PA, PP, PH))
SECRET = b"k" * 32


def _authn(A, P, H, allow_anonymous):
    ac = A.AccessControl(hooks=H.HookRegistry(),
                         allow_anonymous=allow_anonymous)
    d = A.DictAuthenticator()
    d.add_user("alice", "pw1")
    d.add_user("root", "rootpw", is_superuser=True)
    p = P.Pbkdf2Authenticator(iterations=10)
    p.add_user("bob", "pw2")
    ac.authenticators += [d, p, P.JwtAuthenticator(
        SECRET, required_claims={"sub": "%c"})]

    def verdict(client, acc):
        if client.username == "evil":
            return A.DENY
        if client.username == "vip":
            return A.ALLOW
        return None

    ac.hooks.add("client.authenticate", verdict)
    return ac


def _clients(P):
    now = time.time()
    return [
        ("c1", "alice", b"pw1"), ("c1", "alice", b"bad"),
        ("c2", "root", b"rootpw"), ("c3", "bob", b"pw2"),
        ("c3", "bob", b"pw1"), ("c4", "nobody", b"x"), ("c5", None, None),
        ("c6", "evil", b"pw1"), ("c7", "vip", b""),
        ("c8", None, P.make_jwt(SECRET, {"sub": "c8"}).encode()),
        ("c8", None, P.make_jwt(SECRET, {"sub": "cX"}).encode()),
        ("c8", None, P.make_jwt(SECRET, {"sub": "c8", "is_superuser": True,
                                         "exp": now + 60}).encode()),
        ("c8", None, P.make_jwt(SECRET, {"sub": "c8",
                                         "exp": now - 60}).encode()),
        ("c8", None, P.make_jwt(SECRET, {"sub": "c8",
                                         "nbf": now + 60}).encode()),
        ("c8", None, P.make_jwt(b"other" * 8, {"sub": "c8"}).encode()),
    ]


@pytest.mark.parametrize("allow_anonymous", [True, False])
def test_authn_chain_equal_reference(allow_anonymous):
    got = []
    for A, P, H in SIDES:
        ac = _authn(A, P, H, allow_anonymous)
        side = []
        for cid, user, pw in _clients(P):
            ok, ci = ac.authenticate(A.ClientInfo(
                clientid=cid, username=user, password=pw))
            side.append((cid, user, ok, ci.is_superuser))
            ok_a, ci_a = asyncio.run(ac.authenticate_async(A.ClientInfo(
                clientid=cid, username=user, password=pw)))
            assert (ok_a, ci_a.is_superuser) == (ok, ci.is_superuser)
        got.append(side)
    assert got[0] == got[1]
    assert {(c, ok) for c, _u, ok, _s in got[1]} >= {
        ("c1", True), ("c1", False), ("c6", False), ("c7", True)}


ACL = [
    ("deny", "all", "subscribe", ["$SYS/#", {"eq": "#"}]),
    ("allow", ("username", "admin"), "all", ["#"]),
    ("allow", "all", "publish", ["dev/%c/#"]),
    ("allow", "all", "subscribe", ["user/%u/+", {"eq": "dev/%c/+"}]),
    ("allow", ("clientid", "c9"), "publish", ["x/+"]),
]


def _acl(A, H, authz_default="deny"):
    ac = A.AccessControl(hooks=H.HookRegistry(), authz_default=authz_default)
    ac.authz_sources.append(A.AclProvider(
        A.AclRule(p, w, a, t) for p, w, a, t in ACL))
    ac.hooks.add("client.authorize",
                 lambda client, action, topic, acc:
                 A.DENY if topic.startswith("blocked/") else None)
    return ac


TOPICS = ["#", "$SYS/x", "$SYS/#", "dev/c1/a", "dev/c1/+", "dev/c2/a",
          "user/u1/x", "user/u1/x/y", "user/%u/x", "x/y", "blocked/a",
          "other"]
WHO = [("c1", "u1", False), ("c2", None, False), ("c9", "admin", False),
       ("c9", "u9", False), ("s", "u1", True)]


@pytest.mark.parametrize("authz_default", ["allow", "deny"])
def test_acl_placeholders_eq_and_superuser_equal_reference(authz_default):
    got = []
    for A, _P, H in SIDES:
        ac = _acl(A, H, authz_default)
        side = []
        for cid, user, su in WHO:
            ci = A.ClientInfo(clientid=cid, username=user, is_superuser=su)
            for action in (A.PUBLISH, A.SUBSCRIBE):
                for t in TOPICS:
                    v = ac.authorize(ci, action, t)
                    assert asyncio.run(ac.authorize_async(ci, action, t)) == v
                    side.append(v)
        got.append(side)
    assert got[0] == got[1]
    assert any(got[1]) and not all(got[1])


# -------------------------------------------------------------- wire

USERS = (("pub", "pubpw", False), ("sub", "subpw", False),
         ("root", "rootpw", True))


def _world(native, deny_action="ignore", **auth):
    ref_cfg, port_cfg = RefConfig(), BrokerConfig()
    for cfg in (ref_cfg, port_cfg):
        cfg.auth.allow_anonymous = auth.get("allow_anonymous", False)
        cfg.auth.authz_default = auth.get("authz_default", "deny")
        cfg.auth.deny_action = deny_action
    ref = RefBroker(config=ref_cfg)
    port = Broker(config=port_cfg, device="cpu", native=native)
    for b, A in ((ref, RA), (port, PA)):
        d = A.DictAuthenticator()
        for user, pw, su in USERS:
            d.add_user(user, pw, is_superuser=su)
        b.access.authenticators.append(d)
        b.access.authz_sources.append(A.AclProvider(
            A.AclRule(p, w, a, t) for p, w, a, t in ACL + [
                ("allow", "all", "subscribe", ["dev/+/#"])]))
    return ref, port


def _connect(ref, port, cid, user, pw, version=C.MQTT_V5):
    c = Pair(ref, port, version)
    c.send(C.Connect(client_id=cid, proto_ver=version, username=user,
                     password=pw, clean_start=True))
    c.assert_same(f"connect {cid}")
    return c


def _drain(clients):
    while sum(c.auto_ack() for c in clients):
        pass


def _assert_metrics_equal(ref, port):
    r, p = ref.metrics.all(), port.metrics.all()
    diff = {k: (r.get(k), p.get(k)) for k in set(r) | set(p)
            if r.get(k, 0) != p.get(k, 0)}
    assert not diff, diff
    for k in ("client.authenticate", "client.authorize",
              "authorization.allow", "authorization.deny",
              "packets.publish.auth_error", "packets.subscribe.auth_error"):
        assert p[k] > 0, k


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("deny_action", ["ignore", "disconnect"])
def test_access_wire_bytes_and_metrics_equal_reference(native, deny_action):
    ref, port = _world(native, deny_action)
    # refusals: a bad password, an unknown user, an anonymous client
    # (anonymous off), on both protocol versions
    for cid, user, pw, ver in (("x1", "pub", b"nope", C.MQTT_V5),
                               ("x2", "pub", b"nope", C.MQTT_V4),
                               ("x3", "ghost", b"pw", C.MQTT_V5),
                               ("x4", None, None, C.MQTT_V4)):
        c = _connect(ref, port, cid, user, pw, ver)
        assert c.port.closed == ["connack_error"]
    sub = _connect(ref, port, "sub", "sub", b"subpw")
    sub.send(C.Subscribe(packet_id=1, subscriptions=[
        C.Subscription(topic_filter=f, qos=q) for f, q in (
            ("dev/+/#", 1), ("$SYS/#", 0), ("#", 0), ("user/sub/+", 2),
            ("user/other/+", 1), ("blocked/x", 1))]))
    sub.assert_same("subscribe")
    v3 = _connect(ref, port, "sub3", "sub", b"subpw", C.MQTT_V4)
    v3.send(C.Subscribe(packet_id=2, subscriptions=[
        C.Subscription(topic_filter="#", qos=1),
        C.Subscription(topic_filter="dev/#", qos=1)]))
    v3.assert_same("v3 subscribe")
    root = _connect(ref, port, "root", "root", b"rootpw")
    root.send(C.Subscribe(packet_id=3, subscriptions=[
        C.Subscription(topic_filter="$SYS/#", qos=0),
        C.Subscription(topic_filter="#", qos=1)]))
    pub = _connect(ref, port, "pub", "pub", b"pubpw")
    clients = [sub, v3, root, pub]
    for k, (topic, qos) in enumerate((
            ("dev/pub/a", 1), ("dev/pub/b", 2), ("dev/other/a", 0),
            ("dev/pub/c", 0), ("user/sub/x", 1), ("dev/pub/d", 1))):
        pub.send(C.Publish(topic=topic, qos=qos, payload=b"%d" % k,
                           packet_id=(10 + k) if qos else None))
        if qos == 2:
            pub.send(C.Pubrel(packet_id=10 + k))
        _drain(clients)
        for c in clients:
            c.assert_same(f"publish {topic}")
    if deny_action == "disconnect":
        # the first denied publish closes the connection
        assert pub.port.closed[0] == "rc_0x87"
        assert pub.ref.closed[0] == "rc_0x87"
    else:
        assert not pub.port.closed
    # the banned list answers before authentication
    ref.banned.ban("clientid", "sub")
    port.banned.ban("clientid", "sub")
    again = _connect(ref, port, "sub", "sub", b"subpw")
    assert again.port.writes[-1] == bytes.fromhex("2003008a00")
    ref.banned.ban("username", "pub")
    port.banned.ban("username", "pub")
    _connect(ref, port, "pub9", "pub", b"pubpw")
    _assert_metrics_equal(ref, port)


@pytest.mark.parametrize("native", [True, False])
def test_flapping_client_is_banned_like_reference(native, monkeypatch):
    """A client that connects and drops 15 times inside a minute (the
    default FlappingConfig) is banned: the 16th CONNECT gets CONNACK
    0x8A on both brokers, the flapping alarm goes out on ``$SYS`` to a
    superuser subscriber, and the ban lifts after ``ban_time``."""
    ref, port = _world(native, allow_anonymous=True, authz_default="allow")
    watch = _connect(ref, port, "watch", "root", b"rootpw")
    watch.send(C.Subscribe(packet_id=1, subscriptions=[
        C.Subscription(topic_filter="$SYS/brokers/+/alarms/#", qos=0)]))
    for k in range(16):
        c = _connect(ref, port, "flap", None, None)
        if k < 15:  # a CONNACK with reason code 0
            assert c.port.writes[0][0] == 0x20 and c.port.writes[0][3] == 0
            for w in (c.ref, c.port):
                w.ch.connection_lost("closed")
    assert c.port.writes[-1] == bytes.fromhex("2003008a00")
    assert c.ref.writes[-1] == c.port.writes[-1]
    watch.assert_same("flapping alarm")
    assert b"flapping/flap" in b"".join(watch.port.writes)
    assert [a.name for a in port.alarms.active()] == ["flapping/flap"]
    real = time.time
    monkeypatch.setattr(time, "time", lambda: real() + 301)
    for b in (ref, port):
        b.tick()
    watch.assert_same("alarm expiry")
    assert port.alarms.active() == [] and len(port.alarms.history()) == 1
    back = _connect(ref, port, "flap", None, None)
    assert back.port.writes[0][3] == 0
    _assert_metrics_equal_counts(ref, port)


def _assert_metrics_equal_counts(ref, port):
    r, p = ref.metrics.all(), port.metrics.all()
    assert {k: v for k, v in r.items() if v} == {k: v for k, v in p.items()
                                                 if v}
    assert p["client.flapping_banned"] == 1 and p["client.banned"] == 1


def test_async_authorize_hook_keeps_publish_order():
    """An async ``client.authorize`` hook (`with_async`) moves each
    PUBLISH and SUBSCRIBE into the channel's ordered chain of async
    continuations: the verdicts arrive out of order, the acks and
    deliveries do not; an async ``client.authenticate`` hook defers
    CONNECT, and a SUBSCRIBE pipelined before the CONNACK is replayed
    after it.  Both brokers write the same bytes."""

    async def world():
        ref, port = _world(True, allow_anonymous=True,
                           authz_default="allow")
        for b, H, A in ((ref, RH, RA), (port, PH, PA)):
            def sync(client, action, topic, acc, A=A):
                return A.DENY if topic.endswith("/deny") else None

            async def slow(client, action, topic, acc, A=A):
                # later publishes resolve first
                level = topic.split("/")[1]
                for _ in range(int(level) % 5 if level.isdigit() else 0):
                    await asyncio.sleep(0)
                return sync(client, action, topic, acc)

            b.hooks.add("client.authorize", H.with_async(sync, slow))

            def authn(client, acc, A=A):
                return A.ALLOW

            async def authn_async(client, acc, A=A):
                await asyncio.sleep(0)
                return A.ALLOW

            b.hooks.add("client.authenticate",
                        H.with_async(authn, authn_async))
        sub = Pair(ref, port, C.MQTT_V5)
        sub.send(C.Connect(client_id="s", proto_ver=C.MQTT_V5))
        sub.send(C.Subscribe(packet_id=1, subscriptions=[
            C.Subscription(topic_filter="t/#", qos=1),
            C.Subscription(topic_filter="t/9/deny", qos=1)]))
        pub = Pair(ref, port, C.MQTT_V5)
        pub.send(C.Connect(client_id="p", proto_ver=C.MQTT_V5))
        for _ in range(20):
            await asyncio.sleep(0)
        for k in range(12):
            tail = "deny" if k % 3 == 2 else "ok"
            pub.send(C.Publish(topic=f"t/{k}/{tail}", qos=1,
                               payload=b"%d" % k, packet_id=k + 1))
        for _ in range(200):
            await asyncio.sleep(0)
            _drain([sub, pub])
        for c in (sub, pub):
            c.assert_same("async chain")
        acks = [p for p in pub.port.packets if p.type == C.PUBACK]
        assert [a.packet_id for a in acks] == list(range(1, 13))
        assert [a.reason_code for a in acks] == [
            0x87 if k % 3 == 2 else 0 for k in range(12)]
        got = [p.payload for p in C.StreamParser(version=C.MQTT_V5).feed(
            b"".join(sub.port.writes)) if p.type == C.PUBLISH]
        assert got == [b"%d" % k for k in range(12) if k % 3 != 2]

    asyncio.run(world())


def test_acl_prefetch_returns_at_once_without_db_sources():
    """Without DB-backed authz sources ``prefetch_acl`` returns at once
    and caches nothing, in both packages; with one, both cache the
    client's rows at the prefetch, evaluate them after the file sources,
    and keep no entry when a fetch fails (the chain default decides)."""

    class Rows:
        def __init__(self, rows):
            self.rows, self.calls = rows, 0

        async def fetch_rows(self, client):
            self.calls += 1
            if self.rows is None:
                raise ConnectionError("db down")
            return [dict(r, topic=r["topic"].replace("X", client.clientid))
                    for r in self.rows]

    rows = [{"permission": "deny", "action": "publish", "topic": "a/X/no"},
            {"permission": "allow", "action": "all", "topic": "a/X/#"}]
    out = []
    for A in (RA, PA):
        ac = A.AccessControl(authz_default="deny")
        assert asyncio.run(ac.prefetch_acl(A.ClientInfo("c0"))) is None
        assert ac._acl_cache == {} and not ac.has_async_authz
        src = Rows(rows)
        ac.db_authz_sources.append(src)
        ac.authz_sources.append(A.AclProvider([A.AclRule(
            "deny", action="subscribe", topics=["a/c1/sub"])]))
        c1, c2 = A.ClientInfo("c1"), A.ClientInfo("c2")
        asyncio.run(ac.prefetch_acl(c1))
        verdicts = [ac.authorize(c, act, t) for c in (c1, c2)
                    for act in (A.PUBLISH, A.SUBSCRIBE)
                    for t in ("a/c1/x", "a/c1/no", "a/c1/sub", "b")]
        src.rows = None
        asyncio.run(ac.prefetch_acl(c1))
        out.append((ac.has_async_authz, src.calls, verdicts,
                    ac._acl_cache, ac.authorize(c1, A.PUBLISH, "a/c1/x")))
    assert out[0] == out[1]
    assert out[1][2][:8] == [True, False, True, False,
                             True, True, False, False]
    assert out[1][3] == {} and out[1][4] is False


def test_access_world_refuses_delays_and_counts_on_cpu():
    """`workload.access_world`, the world the card's parity runs, on the
    CPU: every 8th publish refused, each delayed publish released once
    to every QoS 0 ``load/#`` subscriber (no inflight window holds its
    deliveries back), and the topic metrics on ``load/#``
    equal to the accepted publishes and the deliveries."""
    import numpy as np

    from emqx_tpu_torch import workload as W

    subs, msgs = W.access_script(np.random.default_rng(5), 24, 400)
    raw, tm, metrics = W.access_world("cpu", subs, msgs)
    delayed = {b"%d" % k for k, (_, t, _) in enumerate(msgs)
               if t.startswith("$delayed/")}
    assert metrics["packets.publish.auth_error"] == 400 // 8
    assert metrics["messages.delayed"] == len(delayed) > 0
    assert tm[0]["messages.in"] == metrics["messages.publish"] == 400 - 50
    assert tm[0]["messages.out"] == metrics["messages.delivered"] > 0
    checked = [cid for cid, flts in subs if ("load/#", 0) in flts]
    assert checked
    for cid in checked:
        got = [p.payload for p in C.StreamParser(version=C.MQTT_V5).feed(
            raw[cid]) if p.type == C.PUBLISH and p.payload in delayed]
        assert sorted(got) == sorted(delayed)
