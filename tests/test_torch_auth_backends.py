"""The port's wire-protocol back ends against the JAX package's: BSON
and the Mongo OP_MSG connector (authn, the ACL prefetch, pipelining,
the redial), the LDAP BER codec and simple bind (with RFC 4514 DN
escaping), the HTTP authenticator (on the port's own client, against an
aiohttp service) and the TLS-PSK store.  The Mongo and LDAP servers are
`workload.MongoFixture` and `workload.LdapFixture`, the ones chip_smoke
runs on the card's machine; each package's providers talk to the same
fixture and must give the same verdicts and send the same bytes.

Every async scenario runs under `asyncio.wait_for` with its own limit.
"""

import asyncio
import ssl
import struct

import pytest

from emqx_tpu import access as RA
from emqx_tpu import auth_ldap as RL
from emqx_tpu import auth_mongo as RM
from emqx_tpu import auth_providers as RP
from emqx_tpu import psk as RK

from emqx_tpu_torch import access as PA
from emqx_tpu_torch import auth_ldap as PL
from emqx_tpu_torch import auth_mongo as PM
from emqx_tpu_torch import auth_providers as PP
from emqx_tpu_torch import psk as PK
from emqx_tpu_torch import workload as W
from emqx_tpu_torch.auth_db import hash_password

LIMIT = 20.0


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT))


# ---------------------------------------------------------------- BSON

DOCS = [
    {},
    {"find": "mqtt_user", "filter": {"username": "alice"}, "limit": 1,
     "$db": "mqtt"},
    {"big": 1 << 40, "neg": -(1 << 31), "edge": (1 << 31) - 1,
     "past": 1 << 31, "ok": 1.0, "nan_free": -0.5, "flag": True,
     "off": False, "none": None},
    {"arr": ["a", 2, {"x": False}, [], [1, [2, [3]]]], "empty": {},
     "utf8": "vehículo/ü", "nul_free": ""},
    {"cursor": {"firstBatch": [{"username": "u", "topics": ["a/#"]}],
                "id": 0, "ns": "mqtt.mqtt_acl"}, "ok": 1.0},
]


@pytest.mark.parametrize("doc", DOCS)
def test_bson_bytes_equal_reference(doc):
    enc = PM.bson_encode(doc)
    assert enc == RM.bson_encode(doc)
    assert PM.bson_decode(enc) == RM.bson_decode(enc) == (doc, len(enc))
    # decoding at an offset, as the OP_MSG reader does
    assert PM.bson_decode(b"\x00" * 5 + enc, 5) == (doc, len(enc) + 5)


def test_bson_refuses_the_same_values():
    for bad in ({"x": b"bytes"}, {"x": object()}, {"x": {1, 2}}):
        for M in (RM, PM):
            with pytest.raises(TypeError):
                M.bson_encode(bad)
    date = struct.pack("<i", 16) + b"\x09d\x00" + b"\x00" * 8 + b"\x00"
    for M in (RM, PM):
        with pytest.raises(ValueError, match="unsupported type 0x09"):
            M.bson_decode(date)


# ------------------------------------------------------------- MongoDB

def _mongo_world():
    users = [{"username": "alice", "salt": "na", "is_superuser": True,
              "password_hash": hash_password("s3cret", "sha256", "na")},
             {"username": "nohash", "salt": ""}]
    acl = [{"username": "bob", "permission": "allow", "action": "publish",
            "topics": ["ok/#", "dev/${clientid}/up"]},
           {"username": "bob", "permission": "deny", "action": "all",
            "topic": "#"},
           {"username": "bob", "permission": "allow", "action": "all"}]
    return W.MongoFixture({"mqtt_user": users, "mqtt_acl": acl})


def test_mongo_authn_and_acl_prefetch_equal_reference():
    async def t():
        fm = _mongo_world()
        await fm.start()
        outs = []
        try:
            for A, M in ((RA, RM), (PA, PM)):
                conn = M.MongoConnector("127.0.0.1", fm.port)
                authn = M.MongoAuthenticator(conn)
                got = []
                for who, pw in (("alice", b"s3cret"), ("alice", b"wrong"),
                                ("nobody", b"x"), ("nohash", b"x"),
                                (None, b"x"), ("alice", None)):
                    got.append(await authn.authenticate_async(A.ClientInfo(
                        clientid="a", username=who, password=pw)))
                ac = A.AccessControl(authz_default="deny")
                ac.db_authz_sources.append(M.MongoAuthorizer(conn))
                bob = A.ClientInfo(clientid="b7", username="bob")
                await ac.prefetch_acl(bob)
                got.append(ac._acl_cache["b7"])
                got += [ac.authorize(bob, act, t)
                        for act in (A.PUBLISH, A.SUBSCRIBE)
                        for t in ("ok/x", "dev/b7/up", "dev/b8/up", "z")]
                await ac.close()
                outs.append((got, dict(fm.finds)))
                fm.finds = dict.fromkeys(fm.finds, 0)
        finally:
            await fm.stop()
        return outs

    ref, prt = run(t())
    assert prt == ref
    got, finds = prt
    assert got[:4] == [(PA.ALLOW, {"is_superuser": True}), (PA.DENY, {}),
                       (PA.IGNORE, {}), (PA.IGNORE, {})]
    assert got[6] == [
        {"permission": "allow", "action": "publish", "topic": "ok/#"},
        {"permission": "allow", "action": "publish",
         "topic": "dev/${clientid}/up"},
        {"permission": "deny", "action": "all", "topic": "#"}]
    assert got[7:] == [True, True, False, False, False, False, False, False]
    assert finds == {"mqtt_user": 5, "mqtt_acl": 1}


def test_mongo_commands_pipeline_on_one_connection():
    """Two commands in flight on one connection, answered in reverse:
    each caller gets its own reply (``responseTo``), in both packages."""

    async def t():
        conns = []

        async def handler(r, w):
            conns.append(w)
            seen = []
            for _ in range(2):
                length, rid, _to, _op = struct.unpack(
                    "<iiii", await r.readexactly(16))
                doc, _ = PM.bson_decode(await r.readexactly(length - 16), 5)
                seen.append((rid, doc))
            for rid, doc in reversed(seen):
                body = struct.pack("<I", 0) + b"\x00" + PM.bson_encode(
                    {"echo": doc.get("find", ""), "ok": 1.0})
                w.write(struct.pack("<iiii", 16 + len(body), 99, rid, 2013)
                        + body)
            await w.drain()

        server = await asyncio.start_server(handler, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        out = []
        for M in (RM, PM):
            conn = M.MongoConnector("127.0.0.1", port)
            r1, r2 = await asyncio.gather(conn.command({"find": "alpha"}),
                                          conn.command({"find": "beta"}))
            out.append((r1["echo"], r2["echo"]))
            await conn.close()
        for w in conns:
            w.close()
        server.close()
        await server.wait_closed()
        return out, len(conns)

    out, n_conns = run(t())
    assert out == [("alpha", "beta")] * 2
    assert n_conns == 2  # one pipelined connection a package


def test_mongo_fixture_pipelines_and_counts():
    """The workload fixture answers pipelined finds in order, by filter
    equality with ``limit``, and refuses other commands."""

    async def t():
        fm = _mongo_world()
        await fm.start()
        conn = PM.MongoConnector("127.0.0.1", fm.port)
        try:
            rows = await asyncio.gather(*(
                conn.find("mqtt_acl", {"username": u})
                for u in ("bob", "x", "bob")))
            one = await conn.command({"find": "mqtt_acl",
                                      "filter": {"username": "bob",
                                                 "action": "all"},
                                      "limit": 1})
            bad = await conn.command({"insert": "mqtt_user"})
        finally:
            await conn.close()
            await fm.stop()
        return rows, one, bad, fm.finds, fm.connections

    rows, one, bad, finds, n_conns = run(t())
    assert [len(r) for r in rows] == [3, 0, 3]
    assert one["cursor"]["firstBatch"][0]["topic"] == "#"
    assert bad["ok"] == 0.0
    assert finds == {"mqtt_user": 0, "mqtt_acl": 4} and n_conns == 1


def test_mongo_redials_after_connection_loss():
    async def t():
        out = []
        for M in (RM, PM):
            fm = _mongo_world()
            await fm.start()
            conn = M.MongoConnector("127.0.0.1", fm.port)
            first = await conn.find_one("mqtt_user", {"username": "alice"})
            first_w = conn._w
            await fm.stop()
            first_w.close()
            for _ in range(1000):  # the pump sees the EOF soon
                if conn._w is None:
                    break
                await asyncio.sleep(0.01)
            reset = conn._w is None  # the pump's teardown reset it
            await fm.start()
            conn.port = fm.port
            again = await asyncio.wait_for(
                conn.find_one("mqtt_user", {"username": "alice"}), 5.0)
            out.append((first["username"], reset, again["username"],
                        fm.connections))
            await conn.close()
            await fm.stop()
        return out

    ref, prt = run(t())
    assert prt == ref == ("alice", True, "alice", 2)  # the redial


# ---------------------------------------------------------------- LDAP

@pytest.mark.parametrize("msg_id,dn,pw", [
    (7, "uid=alice,dc=x", b"pw"),
    (0, "", b""),
    (127, "uid=b", b"x"),
    (128, "uid=c", b"y" * 127),
    (70000, "uid=" + "d" * 200 + ",ou=users,dc=example,dc=com", b"p" * 300),
    (2 ** 31 - 1, "cn=ünï,dc=x", bytes(range(256))),
])
def test_ber_bind_request_bytes_equal_reference(msg_id, dn, pw):
    req = PL.bind_request(msg_id, dn, pw)
    assert req == RL.bind_request(msg_id, dn, pw)
    assert req[0] == 0x30


@pytest.mark.parametrize("resp", [
    bytes([0x30, 0x0C, 0x02, 0x01, 7, 0x61, 0x07, 0x0A, 0x01, 0x00, 0x04,
           0x00, 0x04, 0x00]),
    bytes([0x30, 0x0C, 0x02, 0x01, 9, 0x61, 0x07, 0x0A, 0x01, 49, 0x04,
           0x00, 0x04, 0x00]),
    # long-form lengths and a two-byte message id
    bytes([0x30, 0x81, 0x0D, 0x02, 0x02, 0x01, 0x00, 0x61, 0x81, 0x07,
           0x0A, 0x01, 32, 0x04, 0x00, 0x04, 0x00]),
])
def test_ber_bind_response_parse_equals_reference(resp):
    assert PL.parse_bind_response(resp) == RL.parse_bind_response(resp)


@pytest.mark.parametrize("resp", [
    bytes([0x31, 0x03, 0x02, 0x01, 0x01]),  # not an LDAPMessage
    bytes([0x30, 0x03, 0x04, 0x01, 0x01]),  # no messageID
    bytes([0x30, 0x08, 0x02, 0x01, 0x01, 0x65, 0x03, 0x0A, 0x01, 0x00]),
    bytes([0x30, 0x08, 0x02, 0x01, 0x01, 0x61, 0x03, 0x02, 0x01, 0x00]),
])
def test_ber_bind_response_refusals_equal_reference(resp):
    msgs = []
    for L in (RL, PL):
        with pytest.raises(ValueError) as exc:
            L.parse_bind_response(resp)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_escape_dn_value_equals_reference():
    for v in ("alice", "x,ou=admins", "#lead ", " a+b<c>d;e\"f\\g",
              "n\x00ul", "", " ", "#", "a b", "ü=ö"):
        assert PL.escape_dn_value(v) == RL.escape_dn_value(v)
    assert PL.escape_dn_value("x,ou=admins") == "x\\,ou\\=admins"


def test_ldap_bind_and_dn_escaping_equal_reference():
    """Binds against the workload's directory: the right password
    ALLOWs, a wrong one DENYs, an entry the directory lacks and an
    empty password IGNORE, and a username with DN metacharacters
    reaches the directory escaped (no admin bind), in both packages,
    with the same bytes on the wire."""
    dn = "uid={},ou=users,dc=example,dc=com"

    async def t():
        fl = W.LdapFixture({dn.format("alice"): b"pw1",
                            "uid=bob,ou=admins,dc=example,dc=com":
                            b"adminpw"})
        await fl.start()
        out = []
        try:
            for A, L in ((RA, RL), (PA, PL)):
                ld = L.LdapAuthenticator("127.0.0.1", fl.port)
                got = []
                for who, pw in (("alice", b"pw1"), ("alice", b"no"),
                                ("carol", b"pw"), ("alice", b""),
                                (None, b"pw1"),
                                ("bob,ou=admins,dc=example,dc=com",
                                 b"adminpw")):
                    got.append(await ld.authenticate_async(A.ClientInfo(
                        clientid="c", username=who, password=pw)))
                ac = A.AccessControl(allow_anonymous=False)
                ac.authenticators.append(ld)
                got.append(ac.has_async_authn)
                got.append((await ac.authenticate_async(A.ClientInfo(
                    clientid="c", username="alice", password=b"pw1")))[0])
                await ac.close()
                out.append((got, list(fl.binds)))
                fl.binds.clear()
        finally:
            await fl.stop()
        return out

    ref, prt = run(t())
    assert prt == ref
    got, binds = prt
    assert got == [(PA.ALLOW, {}), (PA.DENY, {}), (PA.IGNORE, {}),
                   (PA.IGNORE, {}), (PA.IGNORE, {}), (PA.IGNORE, {}),
                   True, True]
    assert binds[-2][0].startswith("uid=bob\\,ou\\=admins")
    assert binds[-2][0].endswith(",ou=users,dc=example,dc=com")


def test_ldap_transport_failure_is_ignore():
    async def t():
        server = await asyncio.start_server(
            lambda r, w: w.close(), "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        out = []
        for A, L in ((RA, RL), (PA, PL)):
            ld = L.LdapAuthenticator("127.0.0.1", port, timeout=2.0)
            out.append(await ld.authenticate_async(A.ClientInfo(
                clientid="c", username="alice", password=b"pw")))
        server.close()
        await server.wait_closed()
        return out

    assert run(t()) == [(PA.IGNORE, {})] * 2


# ---------------------------------------------------------------- HTTP

def test_http_authenticator_verdicts_equal_reference():
    """Both packages' `HttpAuthenticator` against one aiohttp service:
    the request JSON, allow with is_superuser, deny, ignore, a non-200,
    a body that is not JSON by its type, and a service past the
    timeout."""
    from aiohttp import web

    async def t():
        seen = []

        async def handle(request):
            body = await request.json()
            seen.append((request.method, request.content_type, body))
            who = body["username"]
            if who == "slow":
                await asyncio.sleep(2)
            if who == "down":
                return web.Response(status=503)
            if who == "text":
                return web.Response(text='{"result": "allow"}')
            if who == "list":
                return web.json_response(["allow"])
            if who == "alice" and body["password"] == "pw":
                return web.json_response({"result": "allow",
                                          "is_superuser": True})
            if who == "alice":
                return web.json_response({"result": "deny"})
            return web.json_response({"result": "ignore"})

        app = web.Application()
        app.router.add_route("*", "/auth", handle)
        runner = web.AppRunner(app, access_log=None)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        out = []
        try:
            for A, P in ((RA, RP), (PA, PP)):
                ha = P.HttpAuthenticator(f"http://127.0.0.1:{port}/auth",
                                         timeout=0.5)
                got = [ha.authenticate(A.ClientInfo("x")), ha.is_async]
                for who, pw in (("alice", b"pw"), ("alice", b"no"),
                                ("bob", b"pw"), ("down", b""),
                                ("text", b"x"), ("slow", b"x"),
                                (None, None)):
                    got.append(await ha.authenticate_async(A.ClientInfo(
                        clientid="c1", username=who, password=pw,
                        peerhost="10.0.0.1:1883")))
                # the reference reads a non-object body outside its guard
                try:
                    await ha.authenticate_async(A.ClientInfo(
                        clientid="c1", username="list"))
                except AttributeError as exc:
                    got.append(type(exc).__name__)
                await ha.close()
                out.append((got, list(seen)))
                seen.clear()
        finally:
            await runner.cleanup()
        return out

    ref, prt = run(t())
    assert prt == ref
    got, seen = prt
    assert got[2:] == [(PA.ALLOW, {"is_superuser": True}), (PA.DENY, {}),
                       (PA.IGNORE, {}), (PA.IGNORE, {}), (PA.IGNORE, {}),
                       (PA.IGNORE, {}), (PA.IGNORE, {}), "AttributeError"]
    assert seen[0] == ("POST", "application/json",
                       {"clientid": "c1", "username": "alice",
                        "password": "pw", "peerhost": "10.0.0.1:1883"})


def test_http_authenticator_on_the_workload_service_keeps_alive():
    """On the port's own server (`workload.HttpAuthFixture`): the
    verdicts, and one keep-alive connection for every request."""

    async def t():
        svc = W.HttpAuthFixture({"u1": "p1"})
        await svc.start()
        ha = PP.HttpAuthenticator(svc.url)
        try:
            got = [await ha.authenticate_async(PA.ClientInfo(
                clientid="c", username=u, password=p))
                for u, p in (("u1", b"p1"), ("u1", b"x"), ("u2", b"p1"))]
            opened = ha._session.connections_opened
        finally:
            await ha.close()
            await svc.stop()
        return got, opened, [r["username"] for r in svc.requests]

    got, opened, asked = run(t())
    assert got == [(PA.ALLOW, {"is_superuser": False}), (PA.DENY, {}),
                   (PA.IGNORE, {})]
    assert opened == 1 and asked == ["u1", "u1", "u2"]


# ----------------------------------------------------------------- PSK

def test_psk_store_file_and_lookup_equal_reference(tmp_path):
    f = tmp_path / "psk.txt"
    lines = ("# fleet keys\n"
             "dev-1:6162636431323334\n"
             " dev-2 : feedface \n"
             "badline\n"
             "dev-3:nothex\n"
             "\n"
             "dev-4:00:ff\n")
    out = []
    for K in (RK, PK):
        f.write_text(lines)
        store = K.PskStore(str(f))
        got = [len(store)]
        for ident in ("dev-1", "dev-2", "dev-3", "dev-4", "ghost"):
            got.append(store.lookup(ident))
        got += [store.server_callback(None, b"dev-1"),
                store.server_callback(None, b"ghost"),
                store.server_callback(None, None)]
        store.insert("dev-9", b"k")
        store.delete("dev-2")
        got.append((store.lookup("dev-9"), store.lookup("dev-2")))
        f.write_text("dev-1:00ff\n")
        got += [store.refresh(), store.lookup("dev-9"), dict(store.stats)]
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        got.append(store.attach(ctx))
        with pytest.raises(RuntimeError, match="unreadable"):
            K.PskStore(str(tmp_path / "missing.txt"))
        got.append(len(K.PskStore()))
        out.append(got)
    assert out[0] == out[1]
    got = out[1]
    assert got[:6] == [2, b"abcd1234", bytes.fromhex("feedface"), None,
                       None, None]
    assert got[-2] == hasattr(ssl.SSLContext, "set_psk_server_callback")


# ------------------------------------------------- the auth world, both

def _ref_impl():
    from types import SimpleNamespace

    from emqx_tpu import config as RC
    from emqx_tpu.broker.listener import BrokerServer as RefServer

    def server(cfg):
        cfg.engine.use_device = False
        return RefServer(cfg)

    return SimpleNamespace(config=RC, ldap=RL, providers=RP, mongo=RM,
                           server=server)


def test_authdb_world_on_cpu_equals_reference():
    """`workload.authdb_world`, the world chip_smoke's parity runs on the
    card, through both packages' servers on the same fixtures: every
    client's bytes (CONNACKs of each back end, refusals, SUBACKs,
    PUBACKs with the 0x87 refusals, deliveries), the metrics and what
    each back end was asked (one ACL find a client, none after CONNECT)."""
    script = W.authdb_script(14, 32, 64, n_gcp=(2, 2), n_ldap=8,
                             n_http=8, n_msgs=48, rsa_bits=1024)
    prt = W.authdb_world("cpu", script, n_filters=2000)
    ref = W.authdb_world("cpu", script, n_filters=2000, impl=_ref_impl())
    assert prt["bytes"] == ref["bytes"]
    assert prt["asked"] == ref["asked"]
    assert prt["metrics"] == ref["metrics"]
    accepted = sum(ok for *_, ok in script["connects"])
    finds = prt["asked"]["mongo"]
    assert finds == prt["asked"]["before_publish"][0]
    assert finds == {"mqtt_user": 8, "mqtt_acl": accepted}
    m = prt["metrics"]
    assert m["authorization.deny"] == 48 // 8 + len(script["subscribers"])
    assert m["client.connected"] == accepted == 28
