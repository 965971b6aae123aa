"""The port's database-backed authentication and authorization against
the JAX package's: the password-hashing suite (every algorithm and salt
position, pbkdf2, bcrypt where the platform's crypt(3) has it), the
placeholder compiler in both paramstyles, ACL row evaluation, the SQL
and Redis providers over the JAX package's own fakes, the gated
connectors, and the per-client ACL cache (prefetched at CONNECT, no
round trip after it, eviction sparing live clients).

Every async scenario runs under `asyncio.wait_for` with its own limit.
"""

import asyncio
import sys

import numpy as np
import pytest

from emqx_tpu import access as RA
from emqx_tpu import auth_db as RD
from emqx_tpu.broker.listener import BrokerServer as RefServer
from emqx_tpu.config import BrokerConfig as RefConfig
from emqx_tpu.config import ListenerConfig as RefListener

from emqx_tpu_torch import access as PA
from emqx_tpu_torch import auth_db as PD
from emqx_tpu_torch.broker.listener import BrokerServer
from emqx_tpu_torch.config import BrokerConfig, ListenerConfig

from mqtt_client import TestClient
from test_auth_db import FakeRedis, FakeSql

SIDES = ((RA, RD), (PA, PD))
LIMIT = 20.0


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT))


# ------------------------------------------------------------- hashing

@pytest.mark.parametrize("algo", ["plain", "md5", "sha", "sha256",
                                  "sha512"])
@pytest.mark.parametrize("pos", ["prefix", "suffix"])
def test_simple_hash_suite_equals_reference(algo, pos):
    for pw, salt in (("s3cret", "NaCl"), ("", ""), ("pässwörd", "s:1")):
        stored = PD.hash_password(pw, algo, salt=salt, salt_position=pos)
        assert stored == RD.hash_password(pw, algo, salt=salt,
                                          salt_position=pos)
        if algo == "plain" and not pw.isascii():
            # the JAX package's fault, copied: hmac.compare_digest
            # refuses a non-ASCII str, so a plain non-ASCII stored
            # password raises instead of verifying
            for D in (RD, PD):
                with pytest.raises(TypeError, match="non-ASCII"):
                    D.verify_password(pw.encode(), stored, algo, salt, pos)
            continue
        for given in (pw.encode(), b"wrong", None):
            assert PD.verify_password(given, stored, algo, salt, pos) == \
                RD.verify_password(given, stored, algo, salt, pos)
        assert PD.verify_password(pw.encode(), stored, algo, salt, pos)
        if algo != "plain":
            assert not PD.verify_password(pw.encode(), stored, algo,
                                          "other", pos)


def test_pbkdf2_and_bcrypt_equal_reference(monkeypatch):
    stored = PD.hash_password("pw", "pbkdf2", salt="salty", iterations=1000)
    assert stored == RD.hash_password("pw", "pbkdf2", salt="salty",
                                      iterations=1000)
    assert PD.verify_password(b"pw", stored, "pbkdf2", "salty",
                              iterations=1000)
    assert not PD.verify_password(b"pw", stored, "pbkdf2", "salty",
                                  iterations=999)
    assert PD.bcrypt_supported() == RD.bcrypt_supported()
    if PD.bcrypt_supported():
        for D, E in ((PD, RD), (RD, PD)):  # each verifies the other's
            bc = D.hash_password("hello", "bcrypt")
            assert bc.startswith("$2")
            assert E.verify_password(b"hello", bc, "bcrypt")
            assert not E.verify_password(b"nope", bc, "bcrypt")
        known = "$2b$10$N9qo8uLOickgx2ZMRZoMyeLsZqCYRq5JA..Ba2xizzVJebx3sdMuu"
        assert PD.verify_password(b"hello", known, "bcrypt")
    # a platform without $2b$ refuses a bcrypt provider at construction,
    # loudly, in both packages
    for D in (RD, PD):
        monkeypatch.setattr(D, "_bcrypt_ok", False)
        with pytest.raises(RuntimeError, match="'bcrypt' is not supported"):
            D.SqlAuthenticator(FakeSql({}), algorithm="bcrypt")
        with pytest.raises(RuntimeError, match="'bcrypt' is not supported"):
            D.RedisAuthenticator(FakeRedis({}), algorithm="bcrypt")
        D.check_algorithm_supported("sha256")


# ----------------------------------------------------------- templating

TEMPLATES = [
    "SELECT h FROM u WHERE username = ${username} AND clientid = "
    "${clientid} AND ip = ${peerhost}",
    "SELECT h FROM u WHERE username = ${username} AND c = %c",
    "SELECT h FROM u WHERE t LIKE 'x/%' AND ip = ${peerhost}",
    "SELECT %u, %a, %P, ${password}, 100%% FROM t WHERE a = '%x'",
    "no placeholders at all",
]
CLIENTS = [
    dict(clientid="c1' OR 1=1 --", username="bob", peerhost="10.0.0.9:5312",
         password=b"pw"),
    dict(clientid="c", peerhost="2001:db8::7:51234"),
    dict(clientid="", username=None, peerhost="", password=None),
    dict(clientid="dev/7", username="ué", password=b"\xff\xfe"),
]


@pytest.mark.parametrize("paramstyle", ["format", "numeric"])
@pytest.mark.parametrize("template", TEMPLATES)
def test_compile_query_equals_reference(template, paramstyle):
    sql, getters = PD.compile_query(template, paramstyle)
    ref_sql, ref_getters = RD.compile_query(template, paramstyle)
    assert sql == ref_sql
    for kw in CLIENTS:
        assert PD.render_params(getters, PA.ClientInfo(**kw)) == \
            RD.render_params(ref_getters, RA.ClientInfo(**kw))
        for pattern in ("room/${clientid}/#", "%u/%c/%a", template):
            assert PD.render_topic(pattern, PA.ClientInfo(**kw)) == \
                RD.render_topic(pattern, RA.ClientInfo(**kw))


def test_compile_query_ipv6_and_percent_escaping():
    sql, getters = PD.compile_query(
        "SELECT h FROM u WHERE t LIKE 'x/%' AND ip = ${peerhost}")
    assert sql == "SELECT h FROM u WHERE t LIKE 'x/%%' AND ip = %s"
    c = PA.ClientInfo(clientid="c", peerhost="2001:db8::7:51234")
    assert [g(c) for g in getters] == ["2001:db8::7"]
    sql_pg, _ = PD.compile_query(
        "SELECT h FROM u WHERE username = ${username} AND c = %c",
        paramstyle="numeric")
    assert sql_pg == "SELECT h FROM u WHERE username = $1 AND c = $2"


def _random_rows(rng, n):
    pats = ["dev/${clientid}/#", "eq t/+/literal", "eq_t/x/y", "a/+/c",
            "#", "${username}/in", "admin/#", "bad/#/x", "%c/%u", "+"]
    return [{"permission": str(rng.choice(["allow", "deny", "ALLOW"])),
             "action": str(rng.choice(["publish", "subscribe", "all",
                                       "All"])),
             "topic": str(rng.choice(pats))} for _ in range(n)]


def test_evaluate_acl_rows_equals_reference():
    rng = np.random.default_rng(14)
    topics = ["dev/dev7/up", "t/+/literal", "t/x/literal", "t/x/y", "a/b/c",
              "admin/x", "u1/in", "dev7/u1", "x", "bad/q/x", "dev/other/up"]
    decided = set()
    for _ in range(200):
        rows = _random_rows(rng, int(rng.integers(0, 6)))
        for kw in (dict(clientid="dev7", username="u1"),
                   dict(clientid="dev7")):
            for action in (PA.PUBLISH, PA.SUBSCRIBE):
                for t in topics:
                    got = PD.evaluate_acl_rows(rows, PA.ClientInfo(**kw),
                                               action, t)
                    assert got == RD.evaluate_acl_rows(
                        rows, RA.ClientInfo(**kw), action, t)
                    decided.add(got)
    assert decided == {PA.ALLOW, PA.DENY, PA.IGNORE}


# ------------------------------------------------------------ providers

def test_sql_providers_over_reference_fake_equal_reference():
    async def t():
        outs = []
        for A, D in SIDES:
            fake = FakeSql({
                "alice": {"password_hash": D.hash_password("pw", "sha256",
                                                           "s1"),
                          "salt": "s1", "is_superuser": 1},
                "eve": {"password_hash": D.hash_password("pw", "sha512",
                                                         "s2", "suffix"),
                        "salt": "s2", "is_superuser": 0},
            })
            fake.acl["alice"] = [
                {"permission": "allow", "action": "all",
                 "topic": "room/${clientid}/#"}]
            authn = D.SqlAuthenticator(fake, algorithm="sha256")
            authn512 = D.SqlAuthenticator(fake, algorithm="sha512",
                                          salt_position="suffix")
            authz = D.SqlAuthorizer(fake)
            got = []
            for who, pw in (("alice", b"pw"), ("alice", b"no"),
                            ("ghost", b"pw"), ("eve", b"pw"),
                            ("alice", None)):
                c = A.ClientInfo(clientid="c9", username=who, password=pw)
                got.append(await authn.authenticate_async(c))
                got.append(await authn512.authenticate_async(c))
                got.append(authn.authenticate(c))
                for topic in ("room/c9/t", "room/x/t"):
                    got.append(await authz.authorize_async(
                        c, A.PUBLISH, topic))
                    got.append(authz.authorize(c, A.PUBLISH, topic))

            class Down(FakeSql):
                async def query(self, sql, params):
                    raise ConnectionError("db down")

            down = A.ClientInfo(clientid="c", username="alice",
                                password=b"pw")
            got.append(await D.SqlAuthenticator(
                Down({})).authenticate_async(down))
            got.append(await D.SqlAuthorizer(Down({})).authorize_async(
                down, A.PUBLISH, "t"))
            outs.append((got, fake.queries))
        return outs

    (ref, ref_q), (prt, prt_q) = run(t())
    assert prt == ref and prt_q == ref_q
    assert prt[0] == (PA.ALLOW, {"is_superuser": True})
    assert prt_q[0][1] == ("alice",)  # the username as a bind parameter


def test_redis_providers_over_reference_fake_equal_reference():
    async def t():
        outs = []
        for A, D in SIDES:
            fake = FakeRedis({
                "mqtt_user:bob": {
                    "password_hash": D.hash_password("pw", "sha256", "ns"),
                    "salt": "ns", "is_superuser": "1"},
                "mqtt_acl:bob": {"tele/${clientid}/#": "publish",
                                 "cfg/#": "subscribe"},
            })
            authn = D.RedisAuthenticator(fake)
            authz = D.RedisAuthorizer(fake)
            got = []
            for who, pw in (("bob", b"pw"), ("bob", b"x"), ("nobody", b"x")):
                got.append(await authn.authenticate_async(A.ClientInfo(
                    clientid="d1", username=who, password=pw)))
            c = A.ClientInfo(clientid="d1", username="bob")
            for action in (A.PUBLISH, A.SUBSCRIBE):
                for topic in ("tele/d1/up", "cfg/x", "other"):
                    got.append(await authz.authorize_async(c, action, topic))
            got.append(await authz.fetch_rows(c))
            with pytest.raises(ValueError):
                D.RedisAuthenticator(fake, cmd="GET k")
            with pytest.raises(ValueError):
                D.RedisAuthorizer(fake, cmd="HGETALL")

            class Flat(FakeRedis):  # the [k, v, k, v] reply shape
                async def cmd(self, *args):
                    table = await super().cmd(*args)
                    return [x for kv in table.items() for x in kv]

            got.append(await D.RedisAuthorizer(Flat(fake.hashes)).fetch_rows(c))
            outs.append((got, fake.cmds))
        return outs

    (ref, ref_c), (prt, prt_c) = run(t())
    assert prt == ref and prt_c == ref_c
    assert prt[0] == (PA.ALLOW, {"is_superuser": True})


@pytest.mark.parametrize("cls,driver", [
    ("MysqlConnector", "aiomysql"),
    ("PostgresConnector", "asyncpg"),
    ("RedisConnector", "redis"),
])
def test_gated_connectors_raise_without_their_driver(monkeypatch, cls,
                                                     driver):
    monkeypatch.setitem(sys.modules, driver, None)
    if driver == "redis":
        monkeypatch.setitem(sys.modules, "redis.asyncio", None)
    msgs = []
    for D in (RD, PD):
        with pytest.raises(RuntimeError) as exc:
            getattr(D, cls)()
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] == f"{cls} requires the '{driver}' driver"
    assert PD.SqlConnector.paramstyle == "format"
    assert PD.PostgresConnector.paramstyle == "numeric"


# ------------------------------------------------- the ACL cache, broker

def _server(side):
    if side == "ref":
        cfg = RefConfig(listeners=[RefListener(bind="127.0.0.1", port=0)])
        cfg.engine.use_device = False
    else:
        cfg = BrokerConfig(listeners=[ListenerConfig(bind="127.0.0.1",
                                                     port=0)])
    cfg.auth.authz_default = "deny"
    return (RefServer(cfg) if side == "ref"
            else BrokerServer(cfg, device="cpu"))


def test_broker_prefetches_acl_at_connect_no_round_trip_after():
    """Over a real socket on both servers: the ACL is fetched once at
    CONNECT; subscribe and publish authorization then read the cache,
    with the same SUBACK codes, deliveries and query counts."""

    async def t():
        outs = []
        for side, D in (("ref", RD), ("port", PD)):
            srv = _server(side)
            await srv.start()
            fake = FakeSql({})
            fake.acl["carol"] = [
                {"permission": "deny", "action": "publish",
                 "topic": "eq room/${clientid}/ro"},
                {"permission": "allow", "action": "all",
                 "topic": "room/${clientid}/#"}]
            srv.broker.access.db_authz_sources.append(D.SqlAuthorizer(fake))
            try:
                c = TestClient(srv.listeners[0].port, "k9")
                await c.connect(username="carol")
                n_q = len(fake.queries)
                codes = []
                for flt in ("room/k9/temp", "other/t"):
                    ack = await c.subscribe(flt, qos=1)
                    codes.append(ack.reason_codes[0])
                await c.publish("room/k9/temp", b"21", qos=0)
                got = await c.recv_publish()
                ack = await c.publish("room/k9/ro", b"x", qos=1)
                codes.append(ack.reason_code)
                outs.append((n_q, codes, got.payload, len(fake.queries),
                             sorted(srv.broker.access._acl_cache)))
                await c.close()
            finally:
                await srv.stop()
        return outs

    ref, prt = run(t())
    assert prt == ref
    assert prt[0] == 1 and prt[3] == 1  # no round trip after CONNECT
    assert prt[1] == [1, 0x87, 0x87]
    assert prt[4] == ["k9"]


def test_acl_cache_eviction_spares_live_clients():
    outs = []
    for A in (RA, PA):
        ac = A.AccessControl(authz_default="deny")
        live = {"keep-1", "keep-2"}
        ac.is_live = lambda cid: cid in live
        for i in range(50):
            ac._acl_cache[f"dead-{i}"] = []
        ac._acl_cache["keep-1"] = [{"permission": "allow", "action": "all",
                                   "topic": "#"}]
        ac._acl_cache["keep-2"] = []
        ac._evict_acl()
        outs.append((sorted(ac._acl_cache),
                     ac.authorize(A.ClientInfo(clientid="keep-1"),
                                  A.PUBLISH, "t/x")))
        # at the bound with every client live: the oldest tenth goes
        ac._acl_cache = {f"c{i}": [] for i in range(100_000)}
        ac.is_live = lambda cid: True
        ac._evict_acl()
        outs.append((len(ac._acl_cache), next(iter(ac._acl_cache))))
    assert outs[:2] == outs[2:]
    assert outs[2] == (["keep-1", "keep-2"], True)
    assert outs[3] == (90_000, "c10000")


def test_broker_wires_liveness_into_acl_eviction():
    """The port's broker answers ``is_live`` from its connection
    manager, as the JAX package's: a connected client's prefetched rows
    survive the cache's pressure, a gone client's do not."""

    async def t():
        srv = _server("port")
        fake = FakeSql({})
        fake.acl["dan"] = [{"permission": "allow", "action": "all",
                            "topic": "#"}]
        srv.broker.access.db_authz_sources.append(PD.SqlAuthorizer(fake))
        await srv.start()
        try:
            c = TestClient(srv.listeners[0].port, "live-1")
            await c.connect(username="dan")
            ac = srv.broker.access
            assert ac.is_live("live-1") and not ac.is_live("gone")
            ac._acl_cache["gone"] = []
            ac._evict_acl()
            assert sorted(ac._acl_cache) == ["live-1"]
            await c.close()
        finally:
            await srv.stop()

    run(t())
