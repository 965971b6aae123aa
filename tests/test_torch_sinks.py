"""The port's rule egress against the JAX package's: the buffer worker,
the resource manager, the aggregator, the HTTP sink and the rule
engine's sink and aggregate actions in both SELECT lanes.

Each worker scenario runs one scripted resource (duck-typed, so either
package's `BufferWorker` drives it) through both packages' workers and
compares what the resource received, batch by batch, the worker's
counters (the port has no ``flush_deferred``: it has no overload
protection) and the alarms its manager raised.  Thresholds are count
and byte thresholds with a 30 s age; the drain is awaited explicitly.

The broker worlds compare per-sink query streams and aggregator
records exactly.  Within one rule the batched lane emits action-major
and the scalar lane row-major, so the worlds give each rule one action
(the streams are then equal in order too); an aggregator's object
boundaries depend on how many records a push brings (a cap crossed
mid-push flushes the whole push), so across lanes the JSONL record
stream is compared, and within a lane the objects themselves.
"""

import asyncio
import json
import random
import sys
import time

import numpy as np
import pytest

from emqx_tpu import aggregator as ref_aggregator
from emqx_tpu import resources as ref_resources
from emqx_tpu import schema_registry as ref_schema_registry
from emqx_tpu.broker.broker import Broker as RefBroker
from emqx_tpu.config import BrokerConfig as RefConfig
from emqx_tpu.message import Message as RefMessage
from emqx_tpu.rules import engine as ref_engine

from emqx_tpu_torch import aggregator as port_aggregator
from emqx_tpu_torch import resources as port_resources
from emqx_tpu_torch import workload as W
from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.broker.listener import BrokerServer
from emqx_tpu_torch.config import BrokerConfig, ListenerConfig
from emqx_tpu_torch.message import Message
from emqx_tpu_torch.rules import engine as port_engine

PKGS = {"ref": ref_resources, "port": port_resources}


async def wait_until(cond, timeout=5.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.002)


class Script:
    """A batching resource with scripted failures, partial consumes and
    health."""

    max_batch = 64

    def __init__(self, max_batch=64):
        self.max_batch = max_batch
        self.calls = []  # one list per delivery call
        self.fail_next = 0
        self.healthy = True
        self.consume_limit = None

    @property
    def received(self):
        return [q for c in self.calls for q in c]

    async def on_start(self):
        pass

    async def on_stop(self):
        pass

    async def on_query(self, query):
        if self.fail_next > 0:
            self.fail_next -= 1
            raise ConnectionError("sink down (scripted)")
        self.calls.append([query])

    async def on_query_batch(self, queries):
        if self.fail_next > 0:
            self.fail_next -= 1
            raise ConnectionError("sink down (scripted)")
        if self.consume_limit is not None:
            queries = queries[: self.consume_limit]
        self.calls.append(list(queries))
        return len(queries)

    async def health_check(self):
        return self.healthy


class Single(Script):
    """The same resource without batch delivery."""

    on_query_batch = None

    def __init__(self):
        super().__init__(max_batch=1)


class AlarmLog:
    def __init__(self):
        self.log = []

    def activate(self, name, details=None, message="", **kw):
        self.log.append(("on", name, message))

    def deactivate(self, name, **kw):
        self.log.append(("off", name))


def _worker_state(w, sink):
    snap = w.batch_hist.snapshot()
    stats = dict(w.stats)
    assert stats.pop("flush_deferred", 0) == 0
    return (sink.calls, stats, w.status, w.breaker_open, len(w),
            snap.counts, snap.count)


def _both(scenario):
    out = {side: asyncio.run(asyncio.wait_for(scenario(PKGS[side]), 20))
           for side in ("ref", "port")}
    assert out["port"] == out["ref"]
    return out["port"]


def test_count_threshold_releases_one_batch():
    async def run(R):
        sink = Script()
        w = R.BufferWorker(sink, batch_records=4, batch_age=30.0,
                           retry_base=0.01)
        await w.start()
        try:
            for i in range(4):
                w.enqueue(("q", i))
            await wait_until(lambda: len(sink.received) == 4)
            w.enqueue_batch([f"b{i}" for i in range(9)])
            await wait_until(lambda: len(sink.received) == 13)
            w.enqueue_batch(["t0", "t1"])  # below every threshold
            await asyncio.sleep(0.02)
            assert len(sink.received) == 13
            return _worker_state(w, sink)
        finally:
            await w.stop()

    calls = _both(run)[0]
    assert [len(c) for c in calls] == [4, 9]


def test_byte_threshold_releases_before_age():
    async def run(R):
        sink = Script()
        w = R.BufferWorker(sink, batch_records=10_000, batch_bytes=64,
                           batch_age=30.0, retry_base=0.01)
        await w.start()
        try:
            w.enqueue(b"x" * 30)
            await asyncio.sleep(0.02)
            assert sink.received == []  # lingering: 30 B < 64 B
            w.enqueue("y" * 40)
            await wait_until(lambda: len(sink.received) == 2)
            w.enqueue(("k", b"z" * 60))  # a tuple counts 16 + its bytes
            await wait_until(lambda: len(sink.received) == 3)
            return _worker_state(w, sink)
        finally:
            await w.stop()

    assert [len(c) for c in _both(run)[0]] == [2, 1]


def test_age_threshold_flushes_partial_batch():
    async def run(R):
        sink = Script()
        w = R.BufferWorker(sink, batch_records=1000, batch_age=0.05,
                           retry_base=0.01)
        await w.start()
        try:
            w.enqueue_batch(["a", "b", "c"])
            await wait_until(lambda: len(sink.received) == 3)
            return _worker_state(w, sink)
        finally:
            await w.stop()

    assert _both(run)[0] == [["a", "b", "c"]]


def test_drop_oldest_and_queue_full_edge():
    async def run(R):
        sink = Script()
        events = []
        w = R.BufferWorker(sink, max_buffer=6, retry_base=0.01)
        w.on_queue_full = events.append
        got = [w.enqueue_batch(list(range(9)))]  # 3 oldest drop
        got.append(w.enqueue(9))  # drops 3; the edge holds
        got.append(w.enqueue_batch([10, 11]))
        held = list(w._buf)
        await w.start()  # drains
        try:
            await wait_until(lambda: len(w) == 0)
            got.append(w.enqueue(12))  # below half: the edge re-arms
            got.append(w.enqueue_batch(list(range(13, 21))))  # 3 drop
            await wait_until(lambda: len(w) == 0)
            return got, held, events, _worker_state(w, sink)
        finally:
            await w.stop()

    got, held, events, state = _both(run)
    assert got[:3] == [3, False, 2] and held == [6, 7, 8, 9, 10, 11]
    assert events == [3, 3]
    assert state[1]["dropped"] == 9


def test_breaker_parks_and_replays_with_alarms():
    async def run(R):
        sink = Script()
        sink.fail_next, sink.healthy = 2, False
        alarms = AlarmLog()
        mgr = R.ResourceManager(alarms=alarms)
        w = await mgr.create("s1", sink, breaker_threshold=2,
                             health_interval=0.03, retry_base=0.005)
        try:
            w.enqueue_batch([f"q{i}" for i in range(5)])
            await wait_until(lambda: w.breaker_open, what="breaker")
            w.enqueue_batch(["q5", "q6"])  # intake goes on while parked
            await asyncio.sleep(0.08)  # probes fail: still parked
            parked = (len(w), list(sink.received))
            sink.healthy = True
            await wait_until(lambda: len(sink.received) == 7)
            info = mgr.info()["s1"]
            summary = mgr.summary()
            return (parked, _worker_state(w, sink), list(alarms.log),
                    info["batch_size"]["count"], summary["batches"],
                    summary["breakers_open"])
        finally:
            await mgr.stop_all()

    parked, state, alarms, *_ = _both(run)
    assert parked == (7, [])
    assert state[0] == [[f"q{i}" for i in range(7)]]
    assert state[1]["breaker_opens"] == 1 and state[1]["retried"] == 2
    # the probe's health flip clears resource_down before the breaker
    assert [a[:2] for a in alarms] == [
        ("on", "sink_breaker:s1"), ("off", "resource_down:s1"),
        ("off", "sink_breaker:s1")]


def test_partial_consume_and_max_retries():
    async def run(R):
        part = Script()
        part.consume_limit = 2
        w = R.BufferWorker(part, retry_base=0.002)
        dead = Single()
        dead.fail_next = 10**6
        d = R.BufferWorker(dead, retry_base=0.002, max_retries=1)
        await w.start()
        await d.start()
        try:
            w.enqueue_batch(list(range(5)))
            await wait_until(lambda: len(part.received) == 5)
            d.enqueue("x")
            d.enqueue("y")
            await wait_until(lambda: d.stats["failed"] == 2)
            return _worker_state(w, part), _worker_state(d, dead)
        finally:
            await w.stop()
            await d.stop()

    part, dead = _both(run)
    assert part[0] == [[0, 1], [2, 3], [4]] and part[1]["retried"] == 2
    assert dead[1]["failed"] == 2 and dead[1]["retried"] == 4
    assert dead[2] == "disconnected"


def test_manager_remove_clears_alarms_and_replaces_worker():
    async def run(R):
        alarms = AlarmLog()
        mgr = R.ResourceManager(alarms=alarms)
        sink = Script()
        sink.fail_next, sink.healthy = 10**6, False
        w = await mgr.create("s", sink, breaker_threshold=1,
                             health_interval=10.0, retry_base=0.002)
        w.enqueue("a")
        await wait_until(lambda: w.breaker_open)
        w2 = await mgr.create("s", Script())  # replaces: clears alarms
        out = (mgr.get("s") is w2, mgr.get("nope"), list(alarms.log),
               await mgr.remove("s"), await mgr.remove("s"),
               mgr.summary())
        assert out[-1].pop("flush_deferred", 0) == 0
        await mgr.stop_all()
        return out

    is_new, none, alarms, removed, again, summary = _both(run)
    assert is_new and none is None and removed and not again
    assert alarms[0][:2] == ("on", "sink_breaker:s")
    assert ("off", "sink_breaker:s") in alarms
    assert summary["sinks"] == 0


# ------------------------------------------------------ aggregator

def _records(rng, n):
    return [{"a": rng.randint(0, 9), "s": rng.choice(["x", "y,z", 'q"']),
             **({"extra": rng.random()} if rng.random() < 0.3 else {}),
             **({"o": {"k": [1, 2]}} if rng.random() < 0.2 else {})}
            for _ in range(n)]


@pytest.mark.parametrize("container", ["jsonl", "csv"])
def test_aggregator_bodies_equal_reference(container):
    out = {}
    for side, A in (("ref", ref_aggregator), ("port", port_aggregator)):
        rng = random.Random(4)
        bodies, keys = [], []
        a = A.Aggregator(lambda k, b: (keys.append(k), bodies.append(b)),
                         name="n", container=container, interval_s=10.0,
                         max_records=5, max_bytes=10**6,
                         column_order=["s", "a"])
        a._bucket_start = 1_000_000.0
        a.push(_records(rng, 3))
        ticks = [a.tick(now=1_000_005.0)]  # not due
        a.push(_records(rng, 4))  # 7 >= 5: flushes inline
        a.push(_records(rng, 2))
        a._bucket_start = 2_000_000.0
        ticks.append(a.tick(now=2_000_010.0))  # due
        ticks.append(a.tick(now=2_000_100.0))  # nothing buffered
        small = A.Aggregator(lambda k, b: bodies.append(b), interval_s=1e9,
                             max_records=10**6, max_bytes=120,
                             container=container)
        small.push(_records(rng, 2))
        small.push(_records(rng, 2))  # crosses the byte cap

        def boom(k, b):
            raise OSError("store down")

        bad = A.Aggregator(boom, max_records=1, container=container)
        bad.push(_records(rng, 1))
        stats = [dict(x.stats) for x in (a, small, bad)]
        for s in stats:
            assert s.pop("deferred_ticks", 0) == 0
        out[side] = (bodies, ticks, stats, keys[0])
    assert out["port"] == out["ref"]
    bodies, ticks, stats, key0 = out["port"]
    assert ticks == [False, True, False] and len(bodies) == 3
    assert stats[2]["errors"] == 1 and stats[0]["flushed_objects"] == 2
    assert key0 == f"n/19700112T134640Z/0.{container}"
    with pytest.raises(ValueError):
        port_aggregator.Aggregator(lambda k, b: None, container="xml")


# ------------------------------------------------ the broker worlds

class FakeWorker:
    """Just enough of BufferWorker for the engine's sink handoff."""

    def __init__(self):
        self.queries = []

    def enqueue(self, q):
        self.queries.append(q)
        return True

    def enqueue_batch(self, qs):
        self.queries.extend(qs)
        return 0


_SELECTS = [
    "*", "payload.a AS a, topic",
    "payload.a + payload.b AS s, payload.a * 2 AS d, 'k' AS lit",
    "payload.s + '!' AS cat, clientid",
    "payload.a / payload.b AS q, payload.a mod 2 AS m",
    "payload.obj AS o, payload.a AS a", "payload.a AS x, payload.b AS x",
    "-payload.a AS neg, 7 AS seven",
    "lower(clientid) AS l, payload.a AS a",  # scalar lane
    "CASE WHEN qos = 0 THEN 'q0' ELSE 'qn' END AS c",  # scalar lane
]
_WHERES = ["payload.a >= 0", "payload.b > 0", "qos >= 0",
           "payload.s = 'x' OR payload.a < 2", "is_not_null(payload.a)",
           "regex_match(payload.s, '^x')"]
_TEMPLATES = [None, '{"t":"${topic}","a":${a}}',
              "v=${a} s=${s} cat=${cat} missing=${nope}", "${o} ${x} ${neg}"]
_FILTERS = ["t/#", "t/+/x", "t/1/x", "t/2/#"]
_TOPICS = ["t/1/x", "t/2/x", "t/2/y", "q/none"]


def _egress_world(seed):
    rng = random.Random(seed)
    rules = []
    for i in range(rng.randint(6, 12)):
        kind = rng.choice(["sink", "sink", "agg"])
        rules.append((f"r{i}", f"SELECT {rng.choice(_SELECTS)} FROM "
                      f'"{rng.choice(_FILTERS)}" WHERE {rng.choice(_WHERES)}',
                      kind, rng.choice(_TEMPLATES)))
    rules.append(("lost", 'SELECT * FROM "t/#"', "missing", None))
    windows = []
    k = 0
    for _ in range(6):
        win = []
        for _ in range(rng.randint(1, 12)):
            payload = {}
            if rng.random() < 0.85:
                payload["a"] = (rng.randint(-5, 5) if rng.random() < 0.7
                                else round(rng.uniform(-5, 5), 2))
            if rng.random() < 0.7:
                payload["b"] = rng.randint(0, 3)
            if rng.random() < 0.6:
                payload["s"] = rng.choice(["x", "y", "zz"])
            if rng.random() < 0.3:
                payload["obj"] = rng.choice([{"k": 1}, [1, 2]])
            body = json.dumps(payload).encode()
            if rng.random() < 0.08:
                body = b"not json {"
            win.append(dict(topic=rng.choice(_TOPICS), payload=body,
                            qos=rng.randint(0, 2),
                            retain=bool(rng.getrandbits(1)),
                            from_client=rng.choice(["c1", "c2"]),
                            mid=k.to_bytes(16, "big"), timestamp=1.7e9 + k))
            k += 1
        windows.append(win)
    return rules, windows


def _egress_run(rules, windows, side, force):
    if side == "ref":
        cfg = RefConfig()
        cfg.engine.use_device = False
        b, R, A, M = RefBroker(config=cfg), ref_engine, ref_aggregator, \
            RefMessage
    else:
        b, R, A, M = Broker(device="cpu"), port_engine, port_aggregator, \
            Message
    b.rules.select_force = force
    sinks, bodies = {}, {}
    for rid, sql, kind, tmpl in rules:
        if kind == "agg":
            bodies[rid] = []
            agg = A.Aggregator(lambda k, body, _b=bodies[rid]: _b.append(body),
                               interval_s=1e9, max_records=4)
            action = R.AggregateAction(agg)
        else:
            sinks[rid] = FakeWorker()
            if kind == "sink":
                b.resources._workers[f"s:{rid}"] = sinks[rid]
            action = R.SinkAction(f"s:{rid}", payload=tmpl)
        b.rules.add_rule(rid, sql, actions=[action])
    for win in windows:
        b.publish_many([M(**m) for m in win])
    for r in b.rules.rules.values():
        for a in r.actions:
            if isinstance(a, R.AggregateAction):
                a.aggregator.flush()
    counters = {rid: (r.matched, r.passed, r.failed, r.actions_success,
                      r.actions_failed) for rid, r in b.rules.rules.items()}
    m = b.metrics
    val = m.val if hasattr(m, "val") else m.__getitem__
    metrics = {k: val(k) for k in ("actions.success", "actions.failed",
                                    "actions.batched", "rules.matched")}
    st = b.rules.stats()
    return ({k: w.queries for k, w in sinks.items()}, bodies, counters,
            metrics, {k: st[k] for k in ("select_lowered",
                                         "select_batched_rows",
                                         "select_scalar_rows")})


@pytest.mark.parametrize("seed", [2, 9, 13, 31])
def test_egress_worlds_equal_reference_in_both_lanes(seed):
    rules, windows = _egress_world(seed)
    runs = {(side, force): _egress_run(rules, windows, side, force)
            for side in ("ref", "port") for force in ("batched", "scalar")}
    for force in ("batched", "scalar"):
        assert runs["port", force] == runs["ref", force], force
    bat, sca = runs["port", "batched"], runs["port", "scalar"]
    assert bat[0] == sca[0], "sink query streams"
    assert bat[2] == sca[2], "rule counters"
    for rid in bat[1]:
        assert b"".join(bat[1][rid]) == b"".join(sca[1][rid]), rid
    assert sca[4]["select_batched_rows"] == 0
    assert bat[4]["select_batched_rows"] > 0
    # the rule whose resource is missing fails each of its actions
    assert bat[2]["lost"][4] == bat[2]["lost"][1] > 0
    assert (bat[3]["actions.batched"] + bat[2]["lost"][4]
            == bat[4]["select_batched_rows"])


def _ref_sinks_world(windows, force):
    """`workload.sinks_world` built from the JAX package's classes."""
    reg = ref_schema_registry.global_registry()
    reg.add(W.FLEET_AVRO_NAME, "avro", W.FLEET_AVRO)
    cfg = RefConfig()
    cfg.engine.use_device = False
    b = RefBroker(config=cfg)
    b.rules.select_force = force
    bodies = []
    agg = ref_aggregator.Aggregator(
        lambda k, body: bodies.append(body), name="fleet", container="jsonl",
        interval_s=3600.0, max_records=W.SINK_AGG_RECORDS)
    for k, (rid, sql) in enumerate(W.make_rules(99, n_fallback=6)):
        action = (ref_engine.SinkAction(W.SINK_ID) if k < 80
                  else ref_engine.SinkAction(W.SINK_ID,
                                             payload=W.SINK_TEMPLATE)
                  if k < 93 else ref_engine.AggregateAction(agg))
        b.rules.add_rule(rid, sql, actions=[action])
    b.rules.add_rule("avro", W.AVRO_SQL,
                     actions=[ref_engine.SinkAction(W.SINK_ID)])
    sink = W.RecordingSink()

    async def run():
        w = await b.resources.create(W.SINK_ID, sink, batch_records=512,
                                     batch_age=0.05, max_buffer=1 << 20)
        for win in windows:
            b.publish_many([RefMessage(**m) for m in win])
        await wait_until(lambda: len(sink.queries) == w.stats["matched"])
        await b.resources.stop_all()

    asyncio.run(run())
    agg.flush()
    counters = {rid: (r.matched, r.passed, r.failed, r.actions_success,
                      r.actions_failed) for rid, r in b.rules.rules.items()}
    return sink.queries, bodies, counters


def _undecoded(query):
    if not query.startswith('{"d": {'):
        return query
    return json.dumps(dict(json.loads(query), d=None))


def test_sinks_world_equals_reference_and_scalar_referee():
    """The chip phase's world (config 4's rules with sink, template and
    aggregate actions, the Avro rule) at 3 windows of 96 messages: the
    port's batched lane equals its scalar referee and the JAX package's
    broker, query for query and record for record."""
    rng = np.random.default_rng(12)
    windows = W.sink_windows(rng, 3, 96, W.populations(1000, 8))
    bat = W.sinks_world("cpu", windows, "batched")
    sca = W.sinks_world("cpu", windows, "scalar")
    auto = W.sinks_world("cpu", windows)
    ref = _ref_sinks_world(windows, "batched")
    assert bat[0] == sca[0] == auto[0]
    # the JAX package's schema_decode reads a payload as its UTF-8 text
    # (decoded with replacement), so a binary Avro record does not
    # decode there: in this world every such row carries d = null.
    # Otherwise the streams are equal
    assert [_undecoded(q) for q in bat[0]] == ref[0]
    assert sum(q.startswith('{"d": null') for q in ref[0]) == 36
    assert bat[2] == sca[2] == ref[2]
    assert bat[1] == ref[1]
    assert b"".join(bat[1]) == b"".join(sca[1])
    assert bat[3]["actions.success"] == sca[3]["actions.success"]
    assert bat[3]["actions.failed"] == 0
    st = bat[4]
    assert st["select_lowered"] == 99
    avro_hits = bat[2]["avro"][1]
    assert avro_hits == 36 and st["select_scalar_rows"] == avro_hits
    assert st["select_batched_rows"] == bat[3]["actions.batched"] > 0
    decoded = [json.loads(q) for q in bat[0] if '"d": {' in q]
    assert len(decoded) == avro_hits
    assert {"vin", "speed", "odometer", "gear", "fault"} == set(
        decoded[0]["d"])


# --------------------------------------------------------- HTTP sink

def test_http_sink_posts_bodies_like_reference():
    from aiohttp import web

    async def run():
        got = {"ref": [], "port": []}
        fail = {"n": 0}

        async def handle(request):
            if request.method == "HEAD":  # the health probe
                return web.Response(status=200)
            body = await request.read()
            if fail["n"] > 0:
                fail["n"] -= 1
                return web.Response(status=503)
            got[request.match_info["side"]].append(
                (request.method, request.headers.get("X-K"), body))
            return web.Response(status=204)

        app = web.Application()
        app.router.add_route("*", "/{side}", handle)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        stats = {}
        try:
            for side, R in (("ref", ref_resources), ("port", port_resources)):
                sink = R.HttpSink(f"http://127.0.0.1:{port}/{side}",
                                  method="PUT", headers={"X-K": "v"})
                w = R.BufferWorker(sink, retry_base=0.005)
                await w.start()
                try:
                    assert w.status == "connected"
                    fail["n"] = 2  # the first two deliveries get a 503
                    w.enqueue("a")
                    w.enqueue(b"b")
                    w.enqueue({"j": 1})
                    await wait_until(lambda: w.stats["success"] == 3)
                    s = dict(w.stats)
                    s.pop("flush_deferred", None)
                    stats[side] = (s, w.status)
                finally:
                    await w.stop()
                assert sink._session is None
        finally:
            await runner.cleanup()
        return got, stats

    got, stats = asyncio.run(asyncio.wait_for(run(), 20))
    assert got["port"] == got["ref"]
    assert got["port"] == [("PUT", "v", b"a"), ("PUT", "v", b"b"),
                           ("PUT", "v", b'{"j": 1}')]
    assert stats["port"] == stats["ref"]
    assert stats["port"][0]["retried"] == 2


def _server(**kw):
    cfg = BrokerConfig(listeners=[ListenerConfig(bind="127.0.0.1", port=0)],
                       **kw)
    return BrokerServer(cfg, device="cpu", native=False)


def test_server_starts_config_sinks_and_rule_reaches_http():
    from aiohttp import web

    async def run():
        bodies = []

        async def handle(request):
            if request.method == "POST":
                bodies.append(await request.read())
            return web.Response(status=200)

        app = web.Application()
        app.router.add_route("*", "/hook", handle)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        server = _server(sinks=[{"id": "web", "type": "http",
                                 "url": f"http://127.0.0.1:{port}/hook",
                                 "max_buffer": 7}])
        b = server.broker
        b.config.engine.batch_publish = False
        b.rules.add_rule("r", 'SELECT payload.v AS v FROM "t/#"',
                         actions=[port_engine.SinkAction("web",
                                                         payload="v=${v}")])
        try:
            await server.start()
            w = b.resources.get("web")
            assert w is not None and w.max_buffer == 7
            assert w.status == "connected"
            b.publish(Message(topic="t/1", payload=b'{"v": 3}'))
            await wait_until(lambda: bodies == [b"v=3"])
        finally:
            await server.stop()
            await runner.cleanup()
        assert b.resources.get("web") is None
        return bodies

    assert asyncio.run(asyncio.wait_for(run(), 20)) == [b"v=3"]


def test_sink_that_cannot_start_raises_out_of_server_start(monkeypatch):
    ok = {"id": "a", "type": "http", "url": "http://127.0.0.1:9/x"}

    async def start(server):
        try:
            await server.start()
        finally:
            await server.stop()

    # kafka is not ported: start raises, and the sink started before it
    # is stopped again
    server = _server(sinks=[ok, {"id": "k", "type": "kafka",
                                 "bootstrap": [["h", 1]], "topic": "t"}])
    with pytest.raises(ValueError, match="kafka is not ported"):
        asyncio.run(start(server))
    assert server.broker.resources.get("a") is None
    # an http sink needs no aiohttp: it starts with aiohttp unimportable
    # (the port's own client), and is stopped with the server
    monkeypatch.setitem(sys.modules, "aiohttp", None)
    server = _server(sinks=[ok])
    asyncio.run(start(server))
    assert server.broker.resources.get("a") is None
    with pytest.raises(ValueError, match="unknown sink type"):
        asyncio.run(start(_server(sinks=[{"id": "x", "type": "smtp"}])))


def test_housekeeping_ticks_aggregators():
    async def run():
        server = _server()
        bodies = []
        agg = port_aggregator.Aggregator(lambda k, b: bodies.append(b),
                                         interval_s=0.0)
        server.broker.aggregators.append(agg)
        await server.start()
        try:
            agg.push([{"a": 1}])
            await wait_until(lambda: bodies, timeout=3.0)
        finally:
            await server.stop()
        return bodies

    assert asyncio.run(run()) == [b'{"a":1}\n']
