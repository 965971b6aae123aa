"""The port's management API against the JAX package's, on the wire.

Both packages' `BrokerServer`s (the reference on its host path, the
port with ``device="cpu"``) run on one event loop in a background
thread; ONE client (`http.client`, or raw socket bytes, from a worker
thread) drives both, so a difference is the servers', never the
clients'.  Each response is compared by status, content type and parsed
JSON body after the volatile fields (tokens, times, key ids and
secrets, ports, remote addresses) are normalised.  The scripted sequence
covers every ported route under every role: anonymous, administrator,
viewer, publisher.  Then the reference's own REST cases in the same
form, and the routes of modules not ported yet: 501 ``NOT_PORTED`` in
the port, where a real 404 and 405 equal aiohttp's.

Every test's coroutine runs under `asyncio.wait_for` with its own limit.
"""

import asyncio
import http.client
import json
import re
import socket
import tempfile
import threading

import pytest

from emqx_tpu import config as RC
from emqx_tpu.broker.listener import BrokerServer as RefServer

from emqx_tpu_torch import config as PC
from emqx_tpu_torch import httpd
from emqx_tpu_torch import workload as W
from emqx_tpu_torch import mgmt as PM
from emqx_tpu_torch.broker.listener import BrokerServer

from mqtt_client import TestClient

LIMIT = 30.0  # seconds, each test's coroutine


class Loop:
    """An event loop in a daemon thread: both packages' servers and the
    MQTT clients live on it."""

    def __init__(self) -> None:
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro, limit: float = LIMIT):
        fut = asyncio.run_coroutine_threadsafe(
            asyncio.wait_for(coro, limit), self.loop)
        return fut.result(limit + 5)

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(5)


@pytest.fixture(scope="module")
def L():
    lp = Loop()
    yield lp
    lp.close()


def _cfg(mod, data_dir, **api):
    cfg = mod.BrokerConfig(listeners=[mod.ListenerConfig(bind="127.0.0.1",
                                                         port=0)])
    cfg.api.enable = True
    cfg.api.port = 0
    cfg.api.data_dir = data_dir
    cfg.sys.interval = float("inf")  # no heartbeat: its first tick races
    for k, v in api.items():
        setattr(cfg.api, k, v)
    return cfg


def ref_server(data_dir=None, **api):
    cfg = _cfg(RC, data_dir or tempfile.mkdtemp(prefix="emqx-mgmt-"), **api)
    cfg.engine.use_device = False
    srv = RefServer(cfg)
    # sysmon (not ported, ROADMAP.md section 1 item 7) samples the host:
    # on a loaded box it raises alarms whose $SYS messages add windows
    srv.sysmon.interval = float("inf")
    return srv


def port_server(data_dir=None, **api):
    cfg = _cfg(PC, data_dir or tempfile.mkdtemp(prefix="emqx-mgmt-"), **api)
    return BrokerServer(cfg, device="cpu")


async def start_pair(tmp_path=None, **api):
    """A started (reference, port) pair, each with its own data dir."""
    dirs = [None, None]
    if tmp_path is not None:
        dirs = [str(tmp_path / "ref"), str(tmp_path / "port")]
    ref, prt = ref_server(dirs[0], **api), port_server(dirs[1], **api)
    await ref.start()
    await prt.start()
    return ref, prt


async def stop_all(*servers):
    for s in servers:
        await s.stop()


# ------------------------------------------------------------ the client

def call(port, method, path, body=None, headers=None, raw=None):
    """One request on a fresh connection: (status, content type, parsed
    body or the text, headers)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    hdrs = dict(headers or {})
    data = raw
    if body is not None:
        data = json.dumps(body).encode()
        hdrs["Content-Type"] = "application/json"
    conn.request(method, path, body=data, headers=hdrs)
    resp = conn.getresponse()
    payload = resp.read()
    ctype = resp.getheader("Content-Type")
    out_headers = {k.lower(): v for k, v in resp.getheaders()}
    conn.close()
    if payload and ctype and ctype.startswith("application/json"):
        parsed = json.loads(payload)
    else:
        parsed = payload.decode("utf-8", "replace")
    return resp.status, ctype, parsed, out_headers


async def acall(port, *a, **kw):
    return await asyncio.get_running_loop().run_in_executor(
        None, lambda: call(port, *a, **kw))


def raw_exchange(port, data: bytes, timeout: float = 3.0) -> bytes:
    """Send raw request bytes; everything the server writes until it
    closes (or ``timeout`` of silence)."""
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)

    def send():  # beside the reads: a server may answer before the end
        try:
            s.sendall(data)
        except OSError:
            pass

    sender = threading.Thread(target=send, daemon=True)
    sender.start()
    try:
        out = b""
        while True:
            try:
                chunk = s.recv(65536)
            except socket.timeout:
                break
            except ConnectionResetError:
                break
            if not chunk:
                break
            out += chunk
        return out
    finally:
        s.close()
        sender.join(timeout)


async def araw(port, data, timeout=3.0):
    return await asyncio.get_running_loop().run_in_executor(
        None, raw_exchange, port, data, timeout)


norm = W.api_norm  # volatile fields (tokens, times, key ids) as "*"


# what the reference shows and the port does not have yet (ROADMAP.md
# section 3): node rows of unported modules; the rule engine's gauges of
# the engine's host/device auto-policy and breaker (item 7)
NODE_ROWS_NOT_PORTED = ("resume", "olp_level", "durability", "flight",
                        "multicore")
RULES_STATS_NOT_PORTED = ("dev_errors", "host_us_ewma", "dev_us_ewma",
                          "breaker_open")
FAMILIES_NOT_PORTED = tuple(f"emqx_rules_{k}"
                            for k in RULES_STATS_NOT_PORTED)


def ref_view(path, body):
    """The reference's body without what `NODE_ROWS_NOT_PORTED` and
    `RULES_STATS_NOT_PORTED` name; timing EWMAs normalised in both."""
    if not isinstance(body, dict):
        return body
    body = dict(body)
    if path.startswith("/api/v5/nodes") and "data" in body:
        body["data"] = [{k: v for k, v in row.items()
                         if k not in NODE_ROWS_NOT_PORTED}
                        for row in body["data"]]
    if path.startswith("/api/v5/rules") and "stats" in body:
        body["stats"] = {k: v for k, v in body["stats"].items()
                         if k not in RULES_STATS_NOT_PORTED}
    return body


def ewma_free(body):
    if isinstance(body, dict) and isinstance(body.get("stats"), dict):
        body = dict(body)
        body["stats"] = {k: ("*" if k.endswith("_us_ewma") and v is not None
                             else v) for k, v in body["stats"].items()}
    return body


def first_diff(a, b, where=""):
    """Where two JSON values first differ, and the two values there."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b)):
            if a.get(k, "<absent>") != b.get(k, "<absent>"):
                return first_diff(a.get(k, "<absent>"),
                                  b.get(k, "<absent>"), f"{where}.{k}")
    elif isinstance(a, list) and isinstance(b, list) and a != b:
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return first_diff(x, y, f"{where}[{i}]")
        return where, f"length {len(a)} vs {len(b)}"
    return where, a, b


basic = W.basic_auth


class Both:
    """The same request to both servers; the responses compared."""

    def __init__(self, ref, prt, log) -> None:
        self.ports = (ref.api.port, prt.api.port)
        self.log = log
        self.auth = ({}, {})  # per-server headers of the current role

    async def login(self, user="admin", password="public"):
        outs = []
        for port in self.ports:
            outs.append(await acall(port, "POST", "/api/v5/login",
                                    {"username": user,
                                     "password": password}))
        assert [o[:2] for o in outs] == [(200,) + outs[0][1:2]] * 2, outs
        return tuple({"Authorization": "Bearer " + o[2]["token"]}
                     for o in outs)

    async def req(self, method, path, body=None, auth=None, raw=None,
                  expect=None, compare_body=True, keys_only=False):
        auth = auth if auth is not None else self.auth
        outs = []
        for port, hdr in zip(self.ports, auth):
            outs.append(await acall(port, method, path, body, hdr, raw))
        (rs, rc, rb, _), (ps, pc, pb, _) = outs
        self.log.append((method, path, rs))
        assert (ps, pc) == (rs, rc), (method, path, outs)
        if expect is not None:
            assert rs == expect, (method, path, outs[0])
        if keys_only:
            assert sorted(pb) == sorted(rb), (method, path, sorted(pb),
                                              sorted(rb))
        elif compare_body:
            want = norm(ewma_free(ref_view(path, rb)))
            got = norm(ewma_free(pb))
            assert got == want, (method, path, first_diff(got, want))
        return rb, pb


# ------------------------------------------------------- prometheus parse

parse_prometheus = W.prom_parse  # strict: one TYPE a family, +Inf == _count


def families_apart_from_engine(types):
    """The families but the match engine's gauges (each package's own
    `MatchEngine.stats()`) and `FAMILIES_NOT_PORTED`."""
    return {n: k for n, k in types.items()
            if not (n.startswith("emqx_engine_") and k == "gauge")
            and n not in FAMILIES_NOT_PORTED}


# ---------------------------------------------------- the scripted world

async def mqtt_pair(ref, prt, cid, *subs):
    """One MQTT client of the same id on each server, subscribed."""
    out = []
    for srv in (ref, prt):
        c = TestClient(srv.listeners[0].port, cid)
        await c.connect()
        for flt, qos in subs:
            await c.subscribe(flt, qos=qos)
        out.append(c)
    return out


def test_scripted_sequence_every_route_every_role(L):
    """Every ported route of `mgmt.MgmtApi`, anonymous, then as admin,
    viewer and publisher: equal statuses, content types and normalised
    bodies; then the audit trails and the scrapes."""

    async def t():
        ref, prt = await start_pair()
        log = []
        B = Both(ref, prt, log)
        anon = ({}, {})
        subs = []
        try:
            # anonymous: 401 with the header, the open routes open
            for method, path in (("GET", "/api/v5/clients"),
                                 ("POST", "/api/v5/publish"),
                                 ("PUT", "/api/v5/configs"),
                                 ("GET", "/api/v5/audit"),
                                 ("DELETE", "/api/v5/clients/x"),
                                 ("GET", "/api/v5/olp"),
                                 ("GET", "/api/v5/nope"),
                                 ("HEAD", "/")):
                await B.req(method, path, auth=anon, expect=401)
            for port in B.ports:
                st, _, _, hdrs = await acall(port, "GET", "/api/v5/stats")
                assert st == 401
                assert hdrs["www-authenticate"] == \
                    'Basic realm="emqx_tpu api key"'
            await B.req("GET", "/", auth=anon, expect=200)
            await B.req("GET", "/dashboard", auth=anon, expect=200)
            await B.req("POST", "/api/v5/login", {"username": "admin",
                                                  "password": "nope"},
                        auth=anon, expect=401)
            await B.req("POST", "/api/v5/login", {"user": "admin"},
                        auth=anon, expect=400)
            for hdr in ("Bearer not.a.token", "Basic bm9wZTpub3Bl",
                        "Digest x"):
                await B.req("GET", "/api/v5/stats",
                            auth=({"Authorization": hdr},) * 2,
                            expect=401)
            B.auth = await B.login()

            # keys and users
            keys = {}
            for role in ("viewer", "publisher", "administrator"):
                rb, pb = await B.req("POST", "/api/v5/api_key",
                                     {"name": f"k-{role}", "role": role},
                                     expect=201)
                keys[role] = (basic(rb["api_key"], rb["api_secret"]),
                              basic(pb["api_key"], pb["api_secret"]))
            await B.req("POST", "/api/v5/api_key", {"name": "x",
                                                   "role": "root"},
                        expect=400)
            await B.req("POST", "/api/v5/api_key", {"role": "viewer"},
                        expect=400)
            await B.req("GET", "/api/v5/api_key", expect=200)
            await B.req("POST", "/api/v5/users", {"username": "auditor",
                                                 "password": "s3cret",
                                                 "role": "viewer"},
                        expect=201)
            await B.req("POST", "/api/v5/users", {"username": "auditor",
                                                 "password": "x"},
                        expect=409)
            await B.req("POST", "/api/v5/users", {"username": "u2"},
                        expect=400)
            await B.req("POST", "/api/v5/users", {"username": "tmp",
                                                 "password": "pw",
                                                 "role": "administrator"},
                        expect=201)
            await B.req("GET", "/api/v5/users", expect=200)
            await B.req("DELETE", "/api/v5/users/admin", expect=400)
            await B.req("DELETE", "/api/v5/users/tmp", expect=204)
            await B.req("DELETE", "/api/v5/users/tmp", expect=404)

            # MQTT clients, subscriptions, topics
            subs += await mqtt_pair(ref, prt, "dev-42", ("tele/+/up", 1),
                                    ("tele/#", 0))
            subs += await mqtt_pair(ref, prt, "dev-7", ("cmd/7", 2))
            await B.req("GET", "/api/v5/clients", expect=200)
            await B.req("GET", "/api/v5/clients/dev-42", expect=200)
            await B.req("HEAD", "/api/v5/clients/dev-42", expect=200)
            await B.req("GET", "/api/v5/clients/nobody", expect=404)
            await B.req("GET", "/api/v5/subscriptions", expect=200)
            await B.req("GET", "/api/v5/topics", expect=200)

            # topic metrics, with an escaped topic on the DELETE path
            await B.req("POST", "/api/v5/mqtt/topic_metrics",
                        {"topic": "tele/+/up"}, expect=201)
            await B.req("POST", "/api/v5/mqtt/topic_metrics",
                        {"topic": "tele/+/up"}, expect=409)
            await B.req("POST", "/api/v5/mqtt/topic_metrics",
                        {"topic": "a/#/b"}, expect=400)
            await B.req("GET", "/api/v5/mqtt/topic_metrics", expect=200)

            # rules (their WHERE lowers into the rules kernel's plain
            # version in the port)
            await B.req("POST", "/api/v5/rules",
                        {"id": "r1", "sql": 'SELECT * FROM "tele/#" '
                         'WHERE payload.x > 1', "description": "d"},
                        expect=201)
            await B.req("POST", "/api/v5/rules",
                        {"id": "r2", "sql": 'SELECT * FROM "cmd/+"'},
                        expect=201)
            await B.req("POST", "/api/v5/rules",
                        {"id": "bad", "sql": "NOT SQL"}, expect=400)
            await B.req("POST", "/api/v5/rules", {"sql": "x"}, expect=400)

            # publish over REST, delivered over MQTT: dev-42 holds the
            # tele/ subscriptions, dev-7 cmd/7
            n_in = {"dev-42": 0, "dev-7": 0}
            for k, (topic, payload, qos) in enumerate((
                    ("tele/7/up", '{"x": 5}', 1), ("tele/8/up", '{"x": 0}',
                                                    0),
                    ("cmd/7", "go", 2), ("none/here", "z", 1))):
                rb, _ = await B.req("POST", "/api/v5/publish",
                                    {"topic": topic, "payload": payload,
                                     "qos": qos}, expect=200)
                who = "dev-7" if topic == "cmd/7" else "dev-42"
                n_in[who] += rb["delivered"]
            await B.req("POST", "/api/v5/publish", {"payload": "x"},
                        expect=400)
            await B.req("POST", "/api/v5/publish",
                        {"topic": "t", "qos": "high"}, expect=400)
            for cid, r, p in zip(("dev-42", "dev-7"), subs[0::2],
                                 subs[1::2]):
                got = [[(pkt.topic, pkt.payload, pkt.qos)
                        for pkt in [await asyncio.wait_for(
                            c.recv_publish(), 10) for _ in range(n_in[cid])]]
                       for c in (r, p)]
                assert got[1] == got[0] and got[0], got
            for c in subs:  # the broker has taken every ack before this
                await c.ping()
            await B.req("GET", "/api/v5/rules", expect=200)
            await B.req("DELETE", "/api/v5/rules/r2", expect=204)
            await B.req("DELETE", "/api/v5/rules/r2", expect=404)
            await B.req("GET", "/api/v5/mqtt/topic_metrics", expect=200)
            await B.req("DELETE", "/api/v5/mqtt/topic_metrics/tele%2F%2B"
                        "%2Fup", expect=204)
            await B.req("DELETE", "/api/v5/mqtt/topic_metrics/tele%2F%2B"
                        "%2Fup", expect=404)

            # stats, metrics, nodes
            await B.req("GET", "/api/v5/stats", expect=200)
            await B.req("GET", "/api/v5/metrics", expect=200)
            await B.req("GET", "/api/v5/nodes", expect=200)

            # alarms, banned, slow subscriptions
            for srv in (ref, prt):
                srv.broker.alarms.activate("high_mem", details={"pct": 93},
                                           message="memory high")
            await B.req("GET", "/api/v5/alarms", expect=200)
            await B.req("DELETE", "/api/v5/alarms", expect=204)
            await B.req("GET", "/api/v5/alarms", expect=200)
            await B.req("GET", "/api/v5/alarms?activated=false",
                        expect=200)
            await B.req("POST", "/api/v5/banned",
                        {"as": "peerhost", "who": "10.0.0.9",
                         "seconds": 60}, expect=201)
            await B.req("POST", "/api/v5/banned", {"as": "clientid"},
                        expect=400)
            await B.req("GET", "/api/v5/banned", expect=200)
            await B.req("DELETE", "/api/v5/banned/peerhost/10.0.0.9",
                        expect=204)
            await B.req("DELETE", "/api/v5/banned/peerhost/10.0.0.9",
                        expect=404)
            await B.req("GET", "/api/v5/slow_subscriptions", expect=200)

            # failpoints: each server arms its own package's registry;
            # the engine breaker is the JAX package's alone (the port's
            # engine launches or raises), so only its edge is compared
            rb, pb = await B.req("GET", "/api/v5/failpoints", expect=200,
                                 keys_only=True)
            assert (pb["enabled"], pb["data"], pb["seams"]) == (
                rb["enabled"], rb["data"], rb["seams"])
            assert pb["engine_breaker"] == {
                k: rb["engine_breaker"][k] for k in ("open", "trips")}
            await B.req("PUT", "/api/v5/failpoints/mgmt.probe",
                        {"action": "delay", "delay": 0.01, "times": 2,
                         "seed": 5, "match": "k"}, expect=200)
            await B.req("PUT", "/api/v5/failpoints/mgmt.probe",
                        {"action": "explode"}, expect=400)
            await B.req("PUT", "/api/v5/failpoints/mgmt.probe",
                        {"action": "drop", "prob": "x"}, expect=400)
            rb, pb = await B.req("GET", "/api/v5/failpoints", expect=200,
                                 keys_only=True)
            assert pb["data"] == rb["data"] and pb["enabled"] is True
            await B.req("DELETE", "/api/v5/failpoints/mgmt.probe",
                        expect=204)
            await B.req("DELETE", "/api/v5/failpoints/mgmt.probe",
                        expect=404)
            await B.req("DELETE", "/api/v5/failpoints", expect=204)

            # the profiler: the engine field and the stage times differ
            # by design (ROADMAP.md section 3), its shape does not
            rb, pb = await B.req("GET", "/api/v5/profiler?windows=4",
                                 expect=200, keys_only=True)
            assert pb["enabled"] is rb["enabled"] is True
            assert pb["windows"] and rb["windows"]
            await B.req("GET", "/api/v5/profiler?windows=bogus",
                        expect=400)
            rb, pb = await B.req("GET", "/api/v5/profiler/trace",
                                 expect=200, keys_only=True)
            assert pb["traceEvents"] and rb["traceEvents"]
            await B.req("GET", "/api/v5/profiler/trace?windows=x",
                        expect=400)
            await B.req("DELETE", "/api/v5/profiler", expect=204)
            rb, pb = await B.req("GET", "/api/v5/profiler", expect=200,
                                 keys_only=True)
            assert pb["windows"] == rb["windows"] == []

            # configs: a ported path, a bad one, a coercion, a bad body
            await B.req("PUT", "/api/v5/configs",
                        {"path": "mqtt.max_qos_allowed", "value": 1},
                        expect=200)
            await B.req("PUT", "/api/v5/configs",
                        {"path": "mqtt.retry_interval", "value": 5},
                        expect=200)
            await B.req("PUT", "/api/v5/configs",
                        {"path": "mqtt.nope", "value": 1}, expect=400)
            await B.req("PUT", "/api/v5/configs", {"value": 1},
                        expect=400)
            await B.req("PUT", "/api/v5/configs",
                        {"path": "mqtt.max_inflight", "value": "many"},
                        expect=400)
            for srv in (ref, prt):
                assert srv.broker.config.mqtt.max_qos_allowed == 1
                assert srv.broker.config.mqtt.retry_interval == 5.0
                assert isinstance(srv.broker.config.mqtt.retry_interval,
                                  float)

            # the schema registry over REST
            avro = {"type": "record", "name": "R",
                    "fields": [{"name": "x", "type": "long"}]}
            await B.req("POST", "/api/v5/schema_registry",
                        {"name": "t1", "type": "avro", "source": avro},
                        expect=201)
            await B.req("POST", "/api/v5/schema_registry",
                        {"name": "t2", "type": "nope", "source": {}},
                        expect=400)
            await B.req("GET", "/api/v5/schema_registry", expect=200)
            await B.req("DELETE", "/api/v5/schema_registry/t1",
                        expect=204)
            await B.req("DELETE", "/api/v5/schema_registry/t1",
                        expect=404)

            # the viewer: reads, no writes but its own password
            viewer = await B.login("auditor", "s3cret")
            for path in ("/api/v5/metrics", "/api/v5/clients",
                         "/api/v5/users", "/api/v5/api_key"):
                await B.req("GET", path, auth=viewer, expect=200,
                            compare_body=path != "/api/v5/metrics")
            for method, path, body in (
                    ("POST", "/api/v5/publish", {"topic": "t",
                                                 "payload": "x"}),
                    ("DELETE", "/api/v5/clients/dev-7", None),
                    ("POST", "/api/v5/rules", {"id": "v", "sql": "x"}),
                    ("PUT", "/api/v5/users/admin/change_pwd",
                     {"old_pwd": "public", "new_pwd": "x"}),
                    ("POST", "/api/v5/data/export", {}),
                    ("GET", "/api/v5/data/export/x.tar.gz", None),
                    ("PUT", "/api/v5/failpoints/x", {"action": "off"})):
                await B.req(method, path, body, auth=viewer, expect=403)
            await B.req("PUT", "/api/v5/users/auditor/change_pwd",
                        {"old_pwd": "wrong", "new_pwd": "n"}, auth=viewer,
                        expect=401)
            await B.req("PUT", "/api/v5/users/auditor/change_pwd",
                        {"old_pwd": "s3cret", "new_pwd": "n"},
                        auth=viewer, expect=204)
            await B.req("GET", "/api/v5/stats", auth=viewer, expect=401)
            viewer = await B.login("auditor", "n")
            await B.req("GET", "/api/v5/stats", auth=viewer, expect=200,
                        compare_body=False)
            # the viewer key: reads only
            await B.req("GET", "/api/v5/banned", auth=keys["viewer"],
                        expect=200)
            await B.req("POST", "/api/v5/banned", {"as": "clientid",
                                                   "who": "x"},
                        auth=keys["viewer"], expect=403)

            # the publisher key: publish, and 403 everywhere else
            await B.req("POST", "/api/v5/publish",
                        {"topic": "tele/9/up", "payload": '{"x": 3}'},
                        auth=keys["publisher"], expect=200)
            for method, path in (("GET", "/api/v5/clients"),
                                 ("GET", "/api/v5/stats"),
                                 ("GET", "/metrics?x=1"),
                                 ("GET", "/api/v5/olp"),
                                 ("POST", "/api/v5/users"),
                                 ("DELETE", "/api/v5/api_key/zzz"),
                                 ("POST", "/api/v5/data/export"),
                                 ("GET", "/api/v5/nope"),
                                 ("PUT", "/api/v5/publish")):
                await B.req(method, path, {}, auth=keys["publisher"],
                            expect=403 if path != "/metrics?x=1" else 200,
                            compare_body=path != "/metrics?x=1")
            # an administrator key
            await B.req("GET", "/api/v5/nodes", auth=keys["administrator"],
                        expect=200)

            # the GCP device registry is off: 501 NOT_ENABLED from both
            # (tests/test_torch_gcp_device.py drives it on)
            for method in ("GET", "POST"):
                await B.req(method, "/api/v5/gcp_devices", {}, expect=501)
            for method in ("GET", "PUT", "DELETE"):
                await B.req(method, "/api/v5/gcp_devices/reg/d%2F1", {},
                            expect=501)

            # kick, then the client is gone
            await B.req("DELETE", "/api/v5/clients/dev-7", expect=204)
            await asyncio.sleep(0.1)
            await B.req("DELETE", "/api/v5/clients/nobody", expect=404)

            # Broker.info(): the same counts and metrics
            assert prt.broker.info() == ref.broker.info()
            # the audit trails: the same mutating calls, statuses, actors
            rb, pb = await B.req("GET", "/api/v5/audit", expect=200)
            assert len(rb["data"]) > 30

            # the scrape: a strict parse, equal families but engine_*
            outs = [await acall(port, "GET", "/metrics")
                    for port in B.ports]
            assert [o[:2] for o in outs] == \
                [(200, "text/plain; charset=utf-8")] * 2
            rt, _ = parse_prometheus(outs[0][2])
            pt, _ = parse_prometheus(outs[1][2])
            assert families_apart_from_engine(pt) == \
                families_apart_from_engine(rt)
            assert any(n.startswith("emqx_engine_") for n in pt)
            # the keys removed leave their own key: delete them last
            rb, pb = await B.req("GET", "/api/v5/api_key", expect=200)
            for rk, pk in zip(rb["data"], pb["data"]):
                outs = [await acall(port, "DELETE",
                                    f"/api/v5/api_key/{k['api_key']}",
                                    None, hdr)
                        for port, k, hdr in zip(B.ports, (rk, pk),
                                                B.auth)]
                assert [o[:2] for o in outs] == [(204, None)] * 2
            await B.req("DELETE", "/api/v5/api_key/key-none", expect=404)
            await B.req("GET", "/api/v5/nodes", auth=keys["administrator"],
                        expect=401)
        finally:
            for c in subs:
                await c.close()
            await stop_all(ref, prt)
        return log

    log = L.run(t(), LIMIT)
    statuses = {s for _, _, s in log}
    assert {200, 201, 204, 400, 401, 403, 404, 409} <= statuses
    # every ported route was driven
    for method, template, name in PM.ROUTES:
        if name is None:
            continue
        rx = httpd._Resource(template).regex
        assert any(m == method and rx.match(p.split("?")[0])
                   for m, p, _ in log), (method, template)


# ------------------------------------------- the reference's REST cases

def test_rest_clients_subscriptions_stats_like_reference(L):
    """tests/test_mgmt.py:57 in the wire-compared form."""

    async def t():
        ref, prt = await start_pair()
        B = Both(ref, prt, [])
        B.auth = await B.login()
        cs = await mqtt_pair(ref, prt, "dev-42", ("tele/+/up", 1))
        try:
            rb, pb = await B.req("GET", "/api/v5/clients", expect=200)
            assert any(x["clientid"] == "dev-42" for x in pb["data"])
            rb, pb = await B.req("GET", "/api/v5/clients/dev-42",
                                 expect=200)
            assert pb["connected"] is True
            rb, pb = await B.req("GET", "/api/v5/subscriptions",
                                 expect=200)
            assert {"clientid": "dev-42", "topic": "tele/+/up"} in \
                pb["data"]
            rb, pb = await B.req("GET", "/api/v5/topics", expect=200)
            assert any(t["topic"] == "tele/+/up" for t in pb["data"])
            rb, pb = await B.req("GET", "/api/v5/stats", expect=200)
            assert pb["connections.count"] == 1
            rb, pb = await B.req("POST", "/api/v5/publish",
                                 {"topic": "tele/7/up", "payload": "ping",
                                  "qos": 1}, expect=200)
            assert pb["delivered"] == 1
            for c in cs:
                pkt = await c.recv_publish()
                assert pkt.topic == "tele/7/up" and pkt.payload == b"ping"
            await B.req("DELETE", "/api/v5/clients/dev-42", expect=204)
            await asyncio.sleep(0.05)
            rb, pb = await B.req("GET", "/api/v5/clients/dev-42",
                                 compare_body=False)
            assert rb == pb or norm(rb) == norm(pb)
        finally:
            for c in cs:
                await c.close()
            await stop_all(ref, prt)

    L.run(t(), LIMIT)


def test_rest_rules_crud_like_reference(L):
    """tests/test_mgmt.py:113 in the wire-compared form."""

    async def t():
        ref, prt = await start_pair()
        B = Both(ref, prt, [])
        B.auth = await B.login()
        try:
            await B.req("POST", "/api/v5/rules", {
                "id": "r9", "sql": 'SELECT * FROM "a/#" WHERE payload.x > 1',
            }, expect=201)
            rb, pb = await B.req("GET", "/api/v5/rules", expect=200)
            assert pb["data"][0]["id"] == "r9"
            await B.req("POST", "/api/v5/rules",
                        {"id": "bad", "sql": "NOT SQL"}, expect=400)
            await B.req("DELETE", "/api/v5/rules/r9", expect=204)
            await B.req("DELETE", "/api/v5/rules/r9", expect=404)
        finally:
            await stop_all(ref, prt)

    L.run(t(), LIMIT)


def test_prometheus_exposition_like_reference(L):
    """tests/test_mgmt.py:143 in the wire-compared form: after one QoS 1
    publish over MQTT both scrapes carry the same counters."""

    async def t():
        ref, prt = await start_pair()
        cs = []
        try:
            for srv in (ref, prt):
                c = TestClient(srv.listeners[0].port, "p")
                await c.connect()
                await c.publish("x/y", b"1", qos=1)
                cs.append(c)
            texts = []
            for srv in (ref, prt):
                st, ct, text, _ = await acall(srv.api.port, "GET",
                                              "/metrics")
                assert (st, ct) == (200, "text/plain; charset=utf-8")
                texts.append(text)
            for text in texts:
                assert "# TYPE emqx_messages_received counter" in text
                assert "emqx_messages_received 1" in text
                assert "# TYPE emqx_connections_count gauge" in text
                assert "emqx_uptime_seconds" in text
            types = [parse_prometheus(x)[0] for x in texts]
            assert families_apart_from_engine(types[1]) == \
                families_apart_from_engine(types[0])
            # the counters that do not depend on timing are equal
            vals = [{n: v for n, lab, v in parse_prometheus(x)[1]
                     if types[0].get(n) == "counter"} for x in texts]
            assert vals[1] == vals[0]
        finally:
            for c in cs:
                await c.disconnect()
            await stop_all(ref, prt)

    L.run(t(), LIMIT)


def test_alarms_rest_like_reference(L):
    """tests/test_ops_guard.py:82 in the wire-compared form (the $SYS
    alarm topic too)."""

    async def t():
        ref, prt = await start_pair()
        mons = await mqtt_pair(ref, prt, "mon", ("$SYS/#", 0))
        B = Both(ref, prt, [])
        try:
            for srv in (ref, prt):
                srv.broker.alarms.activate(
                    "high_mem", details={"pct": 93}, message="memory high")
            for mon in mons:
                pkt = await mon.recv_publish()
                assert pkt.topic.endswith("/alarms/activate")
                assert b"high_mem" in pkt.payload
            B.auth = await B.login()
            rb, pb = await B.req("GET", "/api/v5/alarms", expect=200)
            assert pb["data"][0]["name"] == "high_mem"
            await B.req("DELETE", "/api/v5/alarms", expect=204)
            rb, pb = await B.req("GET", "/api/v5/alarms", expect=200)
            assert pb["data"] == []
            rb, pb = await B.req("GET", "/api/v5/alarms?activated=false",
                                 expect=200)
            assert pb["data"][0]["name"] == "high_mem"
        finally:
            for c in mons:
                await c.close()
            await stop_all(ref, prt)

    L.run(t(), LIMIT)


def test_banned_rest_crud_like_reference(L):
    """tests/test_ops_guard.py:119 in the wire-compared form."""

    async def t():
        ref, prt = await start_pair()
        B = Both(ref, prt, [])
        B.auth = await B.login()
        try:
            await B.req("POST", "/api/v5/banned",
                        {"as": "peerhost", "who": "10.0.0.9",
                         "seconds": 60}, expect=201)
            rb, pb = await B.req("GET", "/api/v5/banned", expect=200)
            assert pb["data"][0]["who"] == "10.0.0.9"
            await B.req("DELETE", "/api/v5/banned/peerhost/10.0.0.9",
                        expect=204)
        finally:
            await stop_all(ref, prt)

    L.run(t(), LIMIT)


def test_rest_schema_crud_like_reference(L, tmp_path):
    """tests/test_schema_registry.py:136 in the wire-compared form, and
    the registry's file in data_dir reloaded by a new server."""

    async def t():
        ref, prt = await start_pair(tmp_path)
        B = Both(ref, prt, [])
        B.auth = await B.login()
        try:
            await B.req("POST", "/api/v5/schema_registry", {
                "name": "t1", "type": "avro",
                "source": {"type": "record", "name": "R", "fields": [
                    {"name": "x", "type": "long"}]}}, expect=201)
            rb, pb = await B.req("POST", "/api/v5/schema_registry", {
                "name": "bad", "type": "protobuf",
                "source": "not a proto"}, expect=400, keys_only=True)
            # the message names the compiler: protoc's own text there,
            # the port's proto3 parser here
            assert pb["code"] == rb["code"] == "BAD_REQUEST"
            assert rb["message"].startswith("protoc rejected the schema: ")
            assert pb["message"].startswith(
                "the proto3 parser rejected the schema: "), pb
            rb, pb = await B.req("GET", "/api/v5/schema_registry",
                                 expect=200)
            assert {"name": "t1", "type": "avro"} in pb["data"]
        finally:
            await stop_all(ref, prt)
        # the file each wrote reloads on a new server over its data_dir
        from emqx_tpu_torch.schema_registry import global_registry

        reg = global_registry()
        reg.persist_path = None  # forget it here, not in the file
        reg.remove("t1")
        assert reg.get("t1") is None
        prt2 = port_server(str(tmp_path / "port"))
        await prt2.start()
        try:
            assert global_registry().get("t1") is not None
            st, _, body, _ = await acall(
                prt2.api.port, "DELETE", "/api/v5/schema_registry/t1",
                None, (await _token(prt2.api.port)))
            assert st == 204
            st, _, body, _ = await acall(
                prt2.api.port, "DELETE", "/api/v5/schema_registry/t1",
                None, (await _token(prt2.api.port)))
            assert st == 404
        finally:
            await prt2.stop()

    L.run(t(), LIMIT)


async def _token(port, user="admin", password="public"):
    st, _, body, _ = await acall(port, "POST", "/api/v5/login",
                                 {"username": user, "password": password})
    assert st == 200, body
    return {"Authorization": "Bearer " + body["token"]}


# ------------------------------------------------ routes not ported yet

def _concrete(template):
    return re.sub(r"\{(\w+)(?::[^}]+)?\}", "x1", template)


def test_unported_routes_answer_501_naming_their_item(L):
    """Every route of a module in `mgmt.NOT_PORTED` answers 501
    NOT_PORTED in the port, behind the same authentication; the
    reference serves them (or answers its own 501 NOT_ENABLED for the
    GCP registry)."""
    unported = [(m, p) for m, p, h in PM.ROUTES if h is None]
    assert len(unported) == 28

    async def t():
        ref, prt = await start_pair()
        try:
            hdr = await _token(prt.api.port)
            for method, template in unported:
                path = _concrete(template)
                st, ct, body, _ = await acall(prt.api.port, method, path,
                                              {}, hdr)
                module, item = PM.not_ported_module(template)
                assert (st, ct) == (501, "application/json; charset=utf-8")
                assert body == {
                    "code": "NOT_PORTED",
                    "message": f"{module} is not ported to emqx_tpu_torch "
                               f"(ROADMAP.md section 1, item {item})"}
                # anonymous: 401 first, as every route
                st, _, _, _ = await acall(prt.api.port, method, path, {})
                assert st == 401
            # the reference answers these routes: it has the modules
            rh = await _token(ref.api.port)
            st, _, body, _ = await acall(ref.api.port, "GET",
                                         "/api/v5/gcp_devices", None, rh)
            assert st == 501 and body["code"] == "NOT_ENABLED"
            st, _, _, _ = await acall(ref.api.port, "GET", "/api/v5/olp",
                                      None, rh)
            assert st == 200
        finally:
            await stop_all(ref, prt)

    L.run(t(), LIMIT)


@pytest.mark.parametrize("method,path,status", [
    ("GET", "/api/v5/nothing", 404),
    ("GET", "/api/v5/clients/", 404),
    ("GET", "//api/v5/clients", 404),
    ("PUT", "/api/v5/clients", 405),
    ("POST", "/api/v5/stats", 405),
    ("PATCH", "/api/v5/rules/r1", 405),
    ("POST", "/api/v5/profiler", 405),
    ("PUT", "/api/v5/gcp_devices/a/b", 200),
    ("POST", "/api/v5/flight/x", 405),
    ("GET", "/metrics/", 404),
])
def test_not_found_and_method_not_allowed_equal_aiohttp(L, method, path,
                                                        status):
    """A real 404 or 405 (with its Allow header) equals aiohttp's, byte
    for byte in status, type, body and Allow; the 200 case is a route
    the router must find (the PUT on a ``{deviceid:.+}`` path)."""

    async def t():
        ref, prt = await start_pair()
        try:
            outs = []
            for srv in (ref, prt):
                hdr = await _token(srv.api.port)
                outs.append(await acall(srv.api.port, method, path, {},
                                        hdr))
        finally:
            await stop_all(ref, prt)
        return outs

    (rs, rc, rb, rh), (ps, pc, pb, ph) = L.run(t(), LIMIT)
    if status == 200:  # the reference's 501 NOT_ENABLED, the port's 501
        assert rs == ps == 501
        return
    assert (ps, pc, pb) == (rs, rc, rb) and ps == status
    assert ph.get("allow") == rh.get("allow")
