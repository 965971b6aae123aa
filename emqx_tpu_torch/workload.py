"""Fleet-telemetry subscription and publish workload.

The filter families and the Zipf-skewed publish stream of the repo's
headline benchmark (``bench.py`` ``make_filters``/``make_topics``):
BASELINE configs 3 and 4 — 1M and 10M mixed ``+``/``#`` wildcard
subscriptions with ~``fanout`` subscribers per matched topic.

`fleet_encoded` builds the same filter set straight into the
automaton's build input arrays with numpy, for sizes where a Python
loop over 10M filters would dominate a run.  Given a `TokenDict`
seeded by `seed_words`, it yields exactly what
``encode_filters(make_filters(...))`` would.

`full_frontier` is the match kernels' worst case: a filter set whose
frontier doubles every level, to fill and overflow the widest frontier.

`shared_script` is a seeded world of ``$share`` groups beside direct
subscribers, and `retained_topics` one last-known-state topic per
device of a fleet.  `access_script` is a seeded world of authenticated
clients under EMQX's default ACL, and `access_world` runs it through a
broker's channels in process.  `fairness_world` is one flooding and one
light client through a broker's channels and its publish batcher, and
`TransportClient` a minimal MQTT client over tcp, ssl, ws or wss.

`make_rules` and `make_rule_payloads` add config 4's rule-engine half:
SQL rules whose FROM filters cover the fleet topic families and whose
WHERE clauses are the predicate shapes of ``bench.py``'s rules bench,
plus arithmetic and presence checks, over JSON telemetry payloads that
carry float32-lossy values (millisecond timestamps, 2**24 + 1).

`ApiClient` is a management-API client on one keep-alive
``http.client`` connection, and `mgmt_world` a seeded script through a
`BrokerServer`'s management API and its MQTT listener (API keys of each
role, config 4's rules over REST, REST and MQTT publishes, the read-back
routes, the scrape), normalised for a card-against-CPU comparison.

`add_sink_rules` gives the same 99 fleet rules the rule egress — sink
actions into a `RecordingSink` (JSON rows or a template) and aggregate
actions into a JSONL `Aggregator` — plus one Avro rule on
``avro/+/state`` that decodes `FLEET_AVRO` records
(`make_avro_records`); `sinks_world` runs windows through such a broker
in process and returns everything that left it.
"""

from __future__ import annotations

import asyncio
import base64
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .ops.dictionary import PAD_TOK, PLUS_TOK, TokenDict
from .resources import Resource


def populations(n_subs: int, fanout: int) -> Tuple[int, int, int, int]:
    return (
        max(n_subs // (2 * fanout), 1),
        max(n_subs // (5 * fanout), 1),
        max(n_subs // (5 * fanout), 1),
        max(n_subs // (10 * fanout), 1),
    )


def make_filters(n_subs: int, fanout: int):
    """``[(fid, words)]`` of the four filter families, and the family
    populations ``(vehicles, dev groups, sites, alert zones)``."""
    n_vehicles, n_dev, n_site, n_alert = pops = populations(n_subs, fanout)
    filters = []
    for i in range(n_subs):
        kind = i % 10
        if kind < 5:  # fanout x subscribers share each vehicle
            filters.append((i, ("vehicles", f"v{i % n_vehicles}",
                                "sensors", "#")))
        elif kind < 7:
            filters.append((i, ("dev", f"g{i % n_dev}", "+", f"d{i % 7}")))
        elif kind < 9:
            filters.append((i, ("site", "+", "floor", f"f{i % n_site}",
                                "#")))
        else:
            filters.append((i, ("alerts", f"z{i % n_alert}", "+", "+")))
    return filters, pops


def make_topics(rng: np.random.Generator, n: int, pops) -> List[str]:
    """``n`` publish topics: 60% Zipf(1.3)-skewed vehicle telemetry,
    then device, site and never-matching topics."""
    n_vehicles, n_dev, n_site, n_alert = pops
    zipf = rng.zipf(1.3, size=n) % max(n_vehicles, 1)
    topics = []
    for i in range(n):
        k = i % 10
        if k < 6:
            topics.append(f"vehicles/v{zipf[i]}/sensors/temp")
        elif k < 8:
            topics.append(f"dev/g{i % n_dev}/x/d{i % 7}")
        elif k < 9:
            topics.append(f"site/s{i % 7}/floor/f{i % n_site}/a")
        else:
            topics.append(f"nomatch/q{i}")
    return topics


_CONST = ("vehicles", "sensors", "dev", "site", "floor", "alerts")


def seed_words(tdict: TokenDict, pops: Sequence[int]) -> None:
    """Add every word of the filter families to ``tdict`` in a fixed
    order: the constants, then each family's numbered words."""
    n_vehicles, n_dev, n_site, n_alert = pops
    for w in _CONST:
        tdict.add(w)
    for prefix, n in (("v", n_vehicles), ("g", n_dev), ("d", 7),
                      ("f", n_site), ("z", n_alert)):
        for j in range(n):
            tdict.add(f"{prefix}{j}")


def fleet_encoded(n_subs: int, fanout: int, tdict: TokenDict,
                  max_levels: int = 16):
    """``(mat, blen, is_hash, pops)`` for ``make_filters(n_subs,
    fanout)``, encoded with ``tdict`` after `seed_words`."""
    pops = populations(n_subs, fanout)
    seed_words(tdict, pops)
    n_vehicles, n_dev, n_site, n_alert = pops
    tid = tdict.get
    i = np.arange(n_subs, dtype=np.int64)
    kind = i % 10
    mat = np.full((n_subs, max_levels), PAD_TOK, np.int32)
    blen = np.full(n_subs, 4, np.int32)
    is_hash = np.zeros(n_subs, bool)
    v0, g0, d0, f0, z0 = (tid(w) for w in ("v0", "g0", "d0", "f0", "z0"))

    veh = kind < 5
    mat[veh, 0] = tid("vehicles")
    mat[veh, 1] = v0 + i[veh] % n_vehicles
    mat[veh, 2] = tid("sensors")
    blen[veh] = 3
    is_hash[veh] = True

    dev = (kind >= 5) & (kind < 7)
    mat[dev, 0] = tid("dev")
    mat[dev, 1] = g0 + i[dev] % n_dev
    mat[dev, 2] = PLUS_TOK
    mat[dev, 3] = d0 + i[dev] % 7

    site = (kind >= 7) & (kind < 9)
    mat[site, 0] = tid("site")
    mat[site, 1] = PLUS_TOK
    mat[site, 2] = tid("floor")
    mat[site, 3] = f0 + i[site] % n_site
    is_hash[site] = True

    alert = kind == 9
    mat[alert, 0] = tid("alerts")
    mat[alert, 1] = z0 + i[alert] % n_alert
    mat[alert, 2] = PLUS_TOK
    mat[alert, 3] = PLUS_TOK
    return mat, blen, is_hash, pops


# WHERE shapes: bench.py's rules bench (numeric / string / IN /
# presence, its fixed thresholds replaced by {k}), then arithmetic
# (div, mod, /, and +, -, * with 0.5 literals) and more presence
# checks; {k} makes each rule's literals distinct, which defeats the
# program dedup
RULE_WHERE = (
    "payload.v = {k}",
    "payload.v > {k} AND payload.s = 'x'",
    "payload.s IN ('q', 'z{k}')",
    "is_null(payload.w) AND payload.v >= {k}",
    "payload.v IN ({k}, 31)",
    "NOT (payload.v < {k}) AND payload.s != 'y'",
    "payload.v div 3 = {k}",
    "payload.v mod 7 = {k} mod 7",
    "payload.v / 4 > {k}.5",
    "payload.v + 0.5 >= {k} AND payload.v * 0.5 - 0.5 < 20",
    "payload.ts - timestamp < {k}",
    "payload.big - 1 = 16777216 + {k} OR is_not_null(payload.w)",
    "is_not_null(payload.s) AND payload.v <= {k}",
    "-payload.v < -{k} OR payload.w = payload.v OR false",
)
# not lowerable: these rules take the per-rule interpreter fallback
RULE_WHERE_FALLBACK = (
    "regex_match(payload.s, '^[xq]')",
    "topic LIKE 'vehicles/%/sensors/temp'",
)
RULE_FROM = (
    "vehicles/+/sensors/#", "vehicles/v{j}/sensors/#", "dev/+/+/d{d}",
    "site/+/floor/#", "alerts/#",
)


def make_rules(n: int, n_fallback: int = 0) -> List[Tuple[str, str]]:
    """``[(rule_id, sql)]``: ``n`` rules over the fleet families, the
    last ``n_fallback`` of them not lowerable."""
    out = []
    for i in range(n):
        flt = RULE_FROM[i % len(RULE_FROM)].format(j=i % 50, d=i % 7)
        if i >= n - n_fallback:
            where = RULE_WHERE_FALLBACK[i % len(RULE_WHERE_FALLBACK)]
        else:
            where = RULE_WHERE[i % len(RULE_WHERE)].format(k=i % 61)
        out.append((f"rule{i}", f'SELECT * FROM "{flt}" WHERE {where}'))
    return out


def make_distinct_wheres(n: int) -> List[str]:
    """``n`` WHERE clauses, no two of which lower to one program."""
    return [RULE_WHERE[i % len(RULE_WHERE)].format(k=i) for i in range(n)]


def make_rule_payloads(rng: np.random.Generator, n: int,
                       t0_ms: int = 1752000000000) -> List[bytes]:
    """``n`` JSON telemetry payloads: a reading ``v`` (integer or
    fractional), a status string, sometimes a warning field, a
    millisecond timestamp and ``2**24 + 1``."""
    v = rng.integers(0, 61, n)
    frac = rng.random(n) < 0.3
    s = rng.choice(np.array(["x", "y", "q", "z7"]), n)
    w = rng.random(n) < 0.2
    out = []
    for i in range(n):
        body = {
            "v": float(v[i]) + 0.25 if frac[i] else int(v[i]),
            "s": str(s[i]),
            "ts": t0_ms + int(i),
            "big": 16777217,
        }
        if w[i]:
            body["w"] = int(v[i]) % 5
        out.append(json.dumps(body).encode())
    return out


# ------------------------------------------------------ rule egress

# a vehicle's state record, Avro-encoded by the fleet's gateways
FLEET_AVRO = {
    "type": "record", "name": "FleetState", "fields": [
        {"name": "vin", "type": "string"},
        {"name": "speed", "type": "double"},
        {"name": "odometer", "type": "long"},
        {"name": "gear", "type": {"type": "enum", "name": "Gear",
                                  "symbols": ["P", "R", "N", "D"]}},
        {"name": "fault", "type": ["null", "string"]},
    ],
}
FLEET_AVRO_NAME = "fleet_avro"
SINK_ID = "fleet"
SINK_TEMPLATE = "${clientid}|${topic}|${qos}"
AVRO_SQL = (f"SELECT schema_decode('{FLEET_AVRO_NAME}', payload) AS d, "
            'topic FROM "avro/+/state"')
SINK_AGG_RECORDS = 512  # the aggregator's record cap


def make_avro_records(rng: np.random.Generator, n: int) -> List[dict]:
    """``n`` `FLEET_AVRO` records: a VIN, a speed, an odometer reading,
    a gear and now and then a fault code."""
    speed = rng.random(n) * 130.0
    odo = rng.integers(0, 400_000, n)
    gear = rng.integers(0, 4, n)
    fault = rng.random(n) < 0.1
    return [{"vin": f"VIN{int(odo[i]) % 997:05d}",
             "speed": float(speed[i]), "odometer": int(odo[i]),
             "gear": "PRND"[int(gear[i])],
             "fault": f"P0{int(odo[i]) % 900 + 100}" if fault[i] else None}
            for i in range(n)]


class RecordingSink(Resource):
    """A batching sink that keeps every query it is handed, in order,
    and the size of every batch."""

    max_batch = 512

    def __init__(self) -> None:
        self.queries: List = []
        self.batches: List[int] = []

    async def on_query(self, query) -> None:
        self.queries.append(query)

    async def on_query_batch(self, queries) -> int:
        self.queries.extend(queries)
        self.batches.append(len(queries))
        return len(queries)


def add_sink_rules(broker, aggregator) -> None:
    """Config 4's 99 fleet rules (`make_rules(99, n_fallback=6)`, all
    ``SELECT *``) with the egress actions: rules 0-79 sink their row as
    JSON into `SINK_ID`, rules 80-92 sink `SINK_TEMPLATE`, rules 93-98
    push into ``aggregator``; then `AVRO_SQL` sinking into `SINK_ID`
    (its SELECT calls a function, so it takes the scalar lane)."""
    from .rules.engine import AggregateAction, SinkAction

    for k, (rid, sql) in enumerate(make_rules(99, n_fallback=6)):
        action = (SinkAction(SINK_ID) if k < 80
                  else SinkAction(SINK_ID, payload=SINK_TEMPLATE) if k < 93
                  else AggregateAction(aggregator))
        broker.rules.add_rule(rid, sql, actions=[action])
    broker.rules.add_rule("avro", AVRO_SQL, actions=[SinkAction(SINK_ID)])


def sink_aggregator(bodies: List[bytes]):
    """The JSONL aggregator of `add_sink_rules`: an object per
    `SINK_AGG_RECORDS` records (or per hour), its body appended to
    ``bodies``."""
    from .aggregator import Aggregator

    return Aggregator(lambda key, body: bodies.append(body), name="fleet",
                      container="jsonl", interval_s=3600.0,
                      max_records=SINK_AGG_RECORDS)


def sink_windows(rng: np.random.Generator, n_windows: int, n: int,
                 pops) -> List[List[dict]]:
    """Windows of ``n`` fleet telemetry messages (`make_topics`,
    `make_rule_payloads`) as `Message` keywords, every 8th an Avro
    state record on ``avro/<vin>/state``; ids and timestamps fixed."""
    from .schema_registry import AvroSchema

    avro = AvroSchema(FLEET_AVRO)
    out, k = [], 0
    for _ in range(n_windows):
        topics = make_topics(rng, n, pops)
        bodies = make_rule_payloads(rng, n)
        recs = make_avro_records(rng, n)
        win = []
        for i in range(n):
            topic, body = topics[i], bodies[i]
            if i % 8 == 7:
                topic = f"avro/{recs[i]['vin']}/state"
                body = avro.encode(recs[i])
            win.append(dict(topic=topic, payload=body, qos=1,
                            from_client=f"pub{i % 4}",
                            mid=k.to_bytes(16, "big"),
                            timestamp=1752000000.0 + k / 1000))
            k += 1
        out.append(win)
    return out


def sinks_world(device: str, windows: Sequence[Sequence[dict]],
                select_force: Optional[str] = None):
    """`add_sink_rules` on a `Broker` on ``device`` (the match engine
    holding only the rules' filters, built), the schema registered in the
    node's registry, ``select_force`` on its rule engine: every window
    through `Broker.publish_many`, then the sink's worker drained and
    the aggregator flushed.  Returns the sink's queries, the aggregator
    bodies, each rule's counters, the broker's action metrics and the
    rule engine's `stats()`."""
    from .broker.broker import Broker
    from .message import Message
    from .schema_registry import global_registry

    global_registry().add(FLEET_AVRO_NAME, "avro", FLEET_AVRO)
    b = Broker(device=device)
    b.rules.select_force = select_force
    bodies: List[bytes] = []
    agg = sink_aggregator(bodies)
    b.aggregators.append(agg)
    add_sink_rules(b, agg)
    b.router.engine.rebuild()  # the rules' filters onto the device
    sink = RecordingSink()

    async def run() -> None:
        worker = await b.resources.create(
            SINK_ID, sink, batch_records=512, batch_age=0.05,
            max_buffer=1 << 20)
        try:
            for win in windows:
                b.publish_many([Message(**m) for m in win])
            want = worker.stats["matched"]
            while len(sink.queries) < want:
                await asyncio.sleep(0.005)
        finally:
            await b.resources.stop_all()

    asyncio.run(asyncio.wait_for(run(), 60))
    agg.flush()
    counters = {rid: (r.matched, r.passed, r.failed, r.actions_success,
                      r.actions_failed) for rid, r in b.rules.rules.items()}
    metrics = {k: b.metrics[k] for k in (
        "actions.success", "actions.failed", "actions.batched",
        "rules.matched")}
    return sink.queries, bodies, counters, metrics, b.rules.stats()


def full_frontier(rng: np.random.Generator, n_topics: int,
                  depth: int = 5) -> Tuple[List[str], List[str]]:
    """Every filter over ``+``, ``a``, ``b`` and ``c`` of 1..``depth``
    levels, those of up to ``depth - 2`` levels also with a trailing
    ``#``; and ``n_topics`` topics of 0..``depth + 2`` levels over
    ``a``..``d`` (``d`` matches only ``+``), a ``$``-topic and a topic
    deeper than any filter among them.  A topic over ``a``..``c`` has
    2**i frontier nodes at level i: 16 at level 4, 32 (an overflow of
    the widest frontier) at level 5."""
    filters: List[str] = []
    level = [[]]
    for d in range(1, depth + 1):
        level = [ws + [w] for ws in level for w in ("+", "a", "b", "c")]
        filters += ["/".join(ws) for ws in level]
        if d <= depth - 2:
            filters += ["/".join(ws + ["#"]) for ws in level]
    words = np.array(["a", "b", "c", "d"])
    topics = ["/".join(rng.choice(words, int(rng.integers(0, depth + 3))))
              for _ in range(max(n_topics - 2, 0))]
    topics += ["$SYS/a/b", "/".join(["a"] * (3 * depth))][:n_topics]
    return filters, topics


SHARED_FILTERS = ("sh/+/+", "sh/#", "sh/a/+", "sh/+/b", "sh/a/b", "+/a/#")


def shared_script(rng: np.random.Generator, n_clients: int, n_groups: int,
                  n_msgs: int):
    """A seeded world of ``$share`` groups beside direct subscribers.

    Returns ``(subs, msgs)``: ``subs`` as ``[(clientid, [(filter,
    qos)])]``, each client a member of one group (group ``j`` holds one
    filter, ``SHARED_FILTERS[j % 6]``) and one in three also a direct
    subscriber of a filter of the same pool; ``msgs`` as ``[(topic, qos,
    from_client)]`` over ``sh/{a,b,c}/{a,b,c}``, ``x/a/b`` and a topic
    no filter matches."""
    topics = [f"sh/{a}/{b}" for a in "abc" for b in "abc"]
    topics += ["x/a/b", "none"]
    subs = []
    for i in range(n_clients):
        j = int(rng.integers(0, n_groups))
        flts = [(f"$share/g{j}/{SHARED_FILTERS[j % len(SHARED_FILTERS)]}",
                 int(rng.integers(0, 3)))]
        if rng.integers(0, 3) == 0:
            flts.append((SHARED_FILTERS[int(rng.integers(
                0, len(SHARED_FILTERS)))], int(rng.integers(0, 3))))
        subs.append((f"c{i}", flts))
    msgs = [(topics[int(rng.integers(0, len(topics)))],
             int(rng.integers(0, 3)), f"p{int(rng.integers(0, 5))}")
            for _ in range(n_msgs)]
    return subs, msgs


def retained_topics(pops) -> List[str]:
    """One last-known-state topic per device: ``vehicles/v{i}/sensors/
    state`` for each vehicle, ``dev/g{j}/x/d{j % 7}`` for each device
    group and ``site/s{k % 7}/floor/f{k}/a`` for each alert zone's count
    of sites (``pops`` from `populations`)."""
    n_vehicles, n_dev, _n_site, n_alert = pops
    return ([f"vehicles/v{i}/sensors/state" for i in range(n_vehicles)]
            + [f"dev/g{j}/x/d{j % 7}" for j in range(n_dev)]
            + [f"site/s{k % 7}/floor/f{k}/a" for k in range(n_alert)])


# EMQX's default acl.conf, in AclRule form ((permission, who, action,
# topics)): no one subscribes to $SYS/# or to the literal "#"; every
# client publishes under its own subtree (and delays messages there);
# `access_acl` adds the filters clients may subscribe to, and the
# broker's authz_default (deny) refuses the rest.
DEFAULT_ACL = (
    ("deny", "all", "subscribe", ("$SYS/#", {"eq": "#"})),
    ("allow", "all", "publish", ("raw/%c/#", "$delayed/+/raw/%c/#")),
)


def access_acl(sub_filters: Sequence[str]) -> List[tuple]:
    """`DEFAULT_ACL` plus one rule that allows subscribing to exactly
    ``sub_filters``."""
    return [*DEFAULT_ACL,
            ("allow", "all", "subscribe", tuple(sub_filters))]


# the rewrite every load topic passes through: raw/<client>/<rest> is
# published on load/<client>/<rest>
ACCESS_REWRITE = ("publish", "raw/#", r"^raw/(\w+)/(.+)$", r"load/\1/\2")
ACCESS_FILTERS = ("load/#", "load/+/+", "+/+/+", "+/#", "load/+/#")


def access_script(rng: np.random.Generator, n_clients: int, n_msgs: int):
    """A seeded world of authenticated clients under `access_acl`.

    Returns ``(subs, msgs)``: ``subs`` as ``[(clientid, [(filter,
    qos)])]`` over `ACCESS_FILTERS` (one in five also asks for the
    literal ``#``, which the ACL refuses); ``msgs`` as ``[(clientid,
    topic, qos)]``: ``raw/<clientid>/m<k % 16>`` (rewritten onto
    ``load/``), every 8th under another client's subtree (refused),
    one in 16 ``$delayed/1/raw/<clientid>/d<k>``.  Client ``c<i>``
    authenticates as user ``u<i>`` with password ``p<i>``."""
    subs = []
    for i in range(n_clients):
        flts = [(ACCESS_FILTERS[int(rng.integers(0, len(ACCESS_FILTERS)))],
                 int(rng.integers(0, 3)))]
        if rng.integers(0, 5) == 0:
            flts.append(("#", 1))
        subs.append((f"c{i}", flts))
    msgs = []
    for k in range(n_msgs):
        cid = f"c{int(rng.integers(0, n_clients))}"
        if k % 8 == 7:
            topic = f"raw/x{cid}/m{k % 16}"
        elif k % 16 == 5:
            topic = f"$delayed/1/raw/{cid}/d{k}"
        else:
            topic = f"raw/{cid}/m{k % 16}"
        msgs.append((cid, topic, int(rng.integers(0, 3))))
    return subs, msgs


def access_world(device: str, subs, msgs):
    """Run `access_script`'s ``(subs, msgs)`` in process on a `Broker`
    on ``device`` (MQTT 5): users ``u<i>``/``p<i>``, the ACL of
    `access_acl` under authz_default deny, the `ACCESS_REWRITE` rule and
    `TopicMetrics` on ``load/#``.  Each client connects with its
    password and subscribes; every publish goes through its client's
    channel (authorized one by one); then one ``tick`` releases the
    delayed ones.  Returns every client's bytes, the topic metrics
    (without their clock-dependent keys) and the broker's `Metrics`."""
    import time

    # the broker is imported here: it is not needed by the scripts above
    from .access import AclProvider, AclRule, DictAuthenticator
    from .broker.broker import Broker
    from .broker.channel import Channel
    from .codec import mqtt as C
    from .config import BrokerConfig
    from .modules import RewriteRule

    cfg = BrokerConfig()
    cfg.auth.allow_anonymous = False
    cfg.auth.authz_default = "deny"
    b = Broker(cfg, device=device)
    users = DictAuthenticator()
    for i in range(len(subs)):
        users.add_user(f"u{i}", f"p{i}")
    b.access.authenticators.append(users)
    b.access.authz_sources.append(AclProvider(
        AclRule(*r) for r in access_acl(ACCESS_FILTERS)))
    b.rewrite.add_rule(RewriteRule(*ACCESS_REWRITE))
    b.topic_metrics.register("load/#")

    def feed(ch, pkt):
        for q in C.StreamParser(version=C.MQTT_V5).feed(
                C.serialize(pkt, C.MQTT_V5)):
            ch.handle_in(q)

    raw, chans = {}, {}
    for i, (cid, flts) in enumerate(subs):
        buf = raw[cid] = bytearray()
        chans[cid] = Channel(b, send=lambda pkts, buf=buf: buf.extend(
            b"".join(C.serialize(p, C.MQTT_V5) for p in pkts)),
            close=lambda reason: None)
        feed(chans[cid], C.Connect(client_id=cid, proto_ver=C.MQTT_V5,
                                   username=f"u{i}", password=b"p%d" % i))
        feed(chans[cid], C.Subscribe(packet_id=1, subscriptions=[
            C.Subscription(topic_filter=f, qos=q) for f, q in flts]))
    b.router.engine.rebuild()
    for k, (cid, topic, qos) in enumerate(msgs):
        feed(chans[cid], C.Publish(topic=topic, qos=qos, payload=b"%d" % k,
                                   packet_id=k % 65535 + 1 if qos else None))
    b.tick(time.time() + 2)
    info = [{k: v for k, v in m.items() if k not in ("created_at", "rate.in")}
            for m in b.topic_metrics.info()]
    return {cid: bytes(v) for cid, v in raw.items()}, info, b.metrics


def fairness_world(device: str, n_flood: int = 600):
    """A QoS 0 subscriber on ``t/#``; client ``flood`` publishes
    ``n_flood`` QoS 0 messages on ``t/f``, then client ``light`` one on
    ``t/l``, all through their channels into a `PublishBatcher` that
    starts only then.  Returns the subscriber's bytes and the size of
    every window (the batcher's lanes put ``light`` in the first)."""
    from .broker.broker import Broker, PublishBatcher
    from .broker.channel import Channel
    from .codec import mqtt as C

    async def run():
        b = Broker(device=device)
        b.batcher = PublishBatcher(b)
        sizes: List[int] = []
        prepare = b.publish_prepare
        b.publish_prepare = lambda msgs: sizes.append(len(msgs)) or \
            prepare(msgs)
        raw, chans = bytearray(), {}
        for cid in ("sub", "flood", "light"):
            out = raw if cid == "sub" else bytearray()
            chans[cid] = Channel(b, send=lambda pkts, out=out: out.extend(
                b"".join(C.serialize(p, C.MQTT_V5) for p in pkts)),
                close=lambda reason: None)

        def feed(cid, pkt):
            for q in C.StreamParser().feed(C.serialize(pkt, C.MQTT_V5)):
                chans[cid].handle_in(q)

        for cid in chans:
            feed(cid, C.Connect(client_id=cid, proto_ver=C.MQTT_V5))
        feed("sub", C.Subscribe(packet_id=1, subscriptions=[
            C.Subscription(topic_filter="t/#", qos=0)]))
        b.router.engine.rebuild()
        for k in range(n_flood):
            feed("flood", C.Publish(topic="t/f", payload=b"%d" % k))
        feed("light", C.Publish(topic="t/l", payload=b"light"))
        await b.batcher.start()
        try:
            while sum(sizes) < n_flood + 1 or b.batcher.depth():
                await asyncio.sleep(0.01)
        finally:
            await b.batcher.stop()
        return bytes(raw), sizes

    return asyncio.run(asyncio.wait_for(run(), 120))


WS_KEY = "dGhlIHNhbXBsZSBub25jZQ=="  # RFC 6455's sample nonce


class TransportClient:
    """A minimal asyncio MQTT client over tcp, ssl, ws or wss (``kind``)
    on the port's codec, for tests and `chip_smoke.py`.  Every byte the
    server sends is kept in ``raw`` (on WebSocket the socket's bytes:
    the handshake response and the frames); parsed packets go to
    ``inbox`` (None at the end of the stream).  ``pause``/``resume``
    stop and restart reading the socket, as a stalled subscriber
    does.  TLS trusts ``cafile`` and checks the name ``localhost``.  It
    sends no PINGREQ of its own, so it connects with keepalive 0."""

    def __init__(self, port: int, client_id: str, kind: str = "tcp",
                 version: int = 5, cafile: Optional[str] = None,
                 username: Optional[str] = None,
                 password: Optional[bytes] = None) -> None:
        from .codec import mqtt as C

        self.C = C
        self.port, self.kind = port, kind
        self.client_id, self.version = client_id, version
        self.cafile = cafile
        self.username, self.password = username, password
        self.raw = bytearray()
        self.parser = C.StreamParser(version=version)
        self.inbox: asyncio.Queue = asyncio.Queue()
        self.reader = self.writer = None
        self._reading = asyncio.Event()
        self._reading.set()
        self._tasks: List[asyncio.Task] = []

    async def open(self, path: str = "/mqtt") -> None:
        ctx = None
        if self.kind in ("ssl", "wss"):
            import ssl

            ctx = ssl.create_default_context(cafile=self.cafile)
        self.reader, self.writer = await asyncio.open_connection(
            "127.0.0.1", self.port, ssl=ctx,
            server_hostname="localhost" if ctx else None)
        frames = None
        if self.kind in ("ws", "wss"):
            self.writer.write((
                f"GET {path} HTTP/1.1\r\nHost: localhost\r\n"
                "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                f"Sec-WebSocket-Key: {WS_KEY}\r\n"
                "Sec-WebSocket-Version: 13\r\n"
                "Sec-WebSocket-Protocol: mqtt\r\n\r\n").encode())
            self.raw += await self.reader.readuntil(b"\r\n\r\n")
            frames = asyncio.StreamReader()
            self._tasks.append(asyncio.ensure_future(self._unframe(frames)))
        self._tasks.append(asyncio.ensure_future(self._pump(frames)))

    async def _pump(self, frames) -> None:
        while True:
            await self._reading.wait()
            data = await self.reader.read(65536)
            self.raw += data
            if frames is not None:
                if data:
                    frames.feed_data(data)
                else:
                    frames.feed_eof()
                    return
            elif data:
                for p in self.parser.feed(data):
                    self.inbox.put_nowait(p)
            if not data:
                self.inbox.put_nowait(None)
                return

    async def _unframe(self, frames) -> None:
        from .broker import ws as W

        while True:
            try:
                op, _fin, payload = await W.read_frame(frames)
            except asyncio.IncompleteReadError:
                self.inbox.put_nowait(None)
                return
            if op == W.OP_BINARY:
                for p in self.parser.feed(payload):
                    self.inbox.put_nowait(p)

    def send(self, *pkts) -> None:
        """One write (one WebSocket frame) carrying ``pkts``."""
        data = b"".join(self.C.serialize(p, self.version) for p in pkts)
        if self.kind in ("ws", "wss"):
            from .broker import ws as W

            data = W.frame(W.OP_BINARY, data, mask=os.urandom(4))
        self.writer.write(data)

    async def expect(self, ptype: int, timeout: float = 30.0):
        pkt = await asyncio.wait_for(self.inbox.get(), timeout)
        if pkt is None or pkt.type != ptype:
            raise AssertionError(
                f"{self.client_id}: expected packet type {ptype}, got {pkt!r}")
        return pkt

    async def connect(self, rc: int = 0, clean_start: bool = True,
                      **props):
        """Open, CONNECT (the client's credentials, ``clean_start``,
        MQTT 5 ``props``), and return the CONNACK, which must carry
        reason code ``rc``."""
        await self.open()
        self.send(self.C.Connect(client_id=self.client_id,
                                 proto_ver=self.version, keepalive=0,
                                 clean_start=clean_start,
                                 username=self.username,
                                 password=self.password, properties=props))
        ack = await self.expect(self.C.CONNACK)
        if ack.reason_code != rc:
            raise AssertionError(f"CONNACK {ack.reason_code} for "
                                 f"{self.client_id}, expected {rc}")
        return ack

    async def subscribe(self, flt: str, qos: int, rh: int = 0) -> None:
        self.send(self.C.Subscribe(packet_id=1, subscriptions=[
            self.C.Subscription(topic_filter=flt, qos=qos,
                                retain_handling=rh)]))
        ack = await self.expect(self.C.SUBACK)
        if ack.reason_codes != [qos]:
            raise AssertionError(f"SUBACK {ack.reason_codes} for {flt}")

    async def quiet(self) -> None:
        """PINGREQ, and PINGRESP as the next packet: nothing the broker
        wrote before it is still unread."""
        self.send(self.C.Pingreq())
        await self.expect(self.C.PINGRESP)

    def pause(self) -> None:
        self._reading.clear()

    def resume(self) -> None:
        self._reading.set()

    async def eof(self, timeout: float = 30.0) -> None:
        """Wait for the server to close the stream, then close."""
        await asyncio.wait_for(asyncio.gather(*self._tasks), timeout)
        await self.close()

    async def close(self) -> None:
        for t in self._tasks:
            t.cancel()
        if self.writer is not None:
            self.writer.close()
            try:
                await self.writer.wait_closed()
            except (ConnectionError, OSError):
                pass


# ------------------------------------------------- the management API

API_VOLATILE = {"token", "at", "created_at", "uptime", "activated_at",
                "deactivated_at", "expired_at", "api_key", "api_secret",
                "from", "until", "rate.in"}


def api_norm(x):
    """A management-API body with its volatile fields (tokens, times,
    a rate the 1 Hz tick computes, key ids and secrets, remote
    addresses) replaced by "*"."""
    if isinstance(x, dict):
        return {k: "*" if k in API_VOLATILE and v is not None else api_norm(v)
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(api_norm(v) for v in x)
    if isinstance(x, str) and x.startswith("key-") and len(x) == 20:
        return "key-*"  # an API key's id as an audit actor
    return x


class ApiClient:
    """A management-API client on one keep-alive `http.client`
    connection to ``127.0.0.1:port``, sending ``auth`` (a header dict)
    on every request.  Its calls block: make them from a thread, never
    from the event loop the server runs on."""

    def __init__(self, port: int, auth: Optional[dict] = None,
                 timeout: float = 60.0) -> None:
        import http.client

        self.auth = dict(auth or {})
        self.conn = http.client.HTTPConnection("127.0.0.1", port,
                                               timeout=timeout)

    def call(self, method: str, path: str, body=None, parse: bool = True):
        """(status, content type, the JSON body parsed, or the text, or
        b"" when empty); with ``parse=False`` the body's bytes."""
        hdrs = dict(self.auth)
        data = None
        if body is not None:
            data = json.dumps(body).encode()
            hdrs["Content-Type"] = "application/json"
        self.conn.request(method, path, body=data, headers=hdrs)
        resp = self.conn.getresponse()
        raw = resp.read()
        ctype = resp.getheader("Content-Type") or ""
        if not parse:
            return resp.status, ctype, raw
        if raw and ctype.startswith("application/json"):
            return resp.status, ctype, json.loads(raw)
        return resp.status, ctype, raw.decode("utf-8", "replace") \
            if raw else b""

    def login(self, username: str = "admin",
              password: str = "public") -> dict:
        st, _, body = self.call("POST", "/api/v5/login",
                                {"username": username,
                                 "password": password})
        if st != 200:
            raise AssertionError(f"login {username}: {st} {body}")
        return {"Authorization": "Bearer " + body["token"]}

    def close(self) -> None:
        self.conn.close()


def basic_auth(key: str, secret: str) -> dict:
    import base64

    return {"Authorization": "Basic " + base64.b64encode(
        f"{key}:{secret}".encode()).decode()}


def prom_parse(text: str):
    """A strict parse of a Prometheus text exposition: ``({family:
    kind}, [(name, labels, value)])``.  Raises on a repeated TYPE line,
    a bad name or kind, an unknown comment, an unparseable sample, and a
    histogram whose buckets are not cumulative or whose ``+Inf`` bucket
    differs from its ``_count``."""
    import re

    name_re = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
    sample_re = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+"
                           r"(\S+)$")
    types: dict = {}
    samples: list = []
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            if name in types or not name_re.match(name) or kind not in (
                    "counter", "gauge", "histogram", "summary"):
                raise AssertionError(f"bad or repeated TYPE line {line!r}")
            types[name] = kind
        elif line.startswith("# HELP "):
            if not name_re.match(line.split(" ", 3)[2]):
                raise AssertionError(f"bad HELP line {line!r}")
        elif line.startswith("#"):
            raise AssertionError(f"unknown comment {line!r}")
        else:
            m = sample_re.match(line)
            if m is None:
                raise AssertionError(f"unparseable sample {line!r}")
            float(m.group(3))
            samples.append((m.group(1), m.group(2) or "", m.group(3)))
    by: dict = {}
    for name, labels, value in samples:
        by.setdefault(name, []).append((labels, value))
    for fam, kind in types.items():
        if kind != "histogram":
            continue
        buckets = by.get(fam + "_bucket", [])
        cum = [int(v) for _, v in buckets]
        (_, count), = by[fam + "_count"]
        if not buckets or buckets[-1][0] != '{le="+Inf"}' or \
                cum != sorted(cum) or cum[-1] != int(count):
            raise AssertionError(f"{fam}: buckets {buckets} _count {count}")
    return types, samples


MGMT_SUBS = (("watch-all", "#", 1), ("watch-veh", "vehicles/+/sensors/#", 0),
             ("watch-dev", "dev/+/+/d3", 1))


def mgmt_world(device: str, n_filters: int = 4000, n_msgs: int = 64,
               seed: int = 13) -> dict:
    """A `BrokerServer` on ``device`` with the API on, ``n_filters`` of
    config 3's fleet filters in its engine and the `MGMT_SUBS` MQTT
    subscribers; over the API: admin login, an API key of each role and
    a viewer user, config 4's 100 rules (`make_rules(100, n_fallback=6)`,
    no actions), the engine rebuilt, then ``n_msgs`` fleet publishes one
    at a time, alternately over REST (the publisher key) and over MQTT
    (QoS 1, each PUBACK awaited); then the read-back routes, the roles'
    refusals, an unported route and the scrape.  Every HTTP call runs in
    a worker thread.  Returns the normalised outcome: each REST
    publish's ``delivered``, each rule's counters, the subscribers'
    bytes, the metrics, the other read-backs and the scrape's
    families."""
    import shutil
    import tempfile

    from . import topic as T
    from .broker.listener import BrokerServer
    from .config import BrokerConfig, ListenerConfig

    rng = np.random.default_rng(seed)
    filters, pops = make_filters(n_filters, 8)
    topics = make_topics(rng, n_msgs, pops)
    payloads = make_rule_payloads(rng, n_msgs)
    out: dict = {}

    async def run() -> None:
        data_dir = tempfile.mkdtemp(prefix="emqx-mgmt-")
        cfg = BrokerConfig(listeners=[ListenerConfig(bind="127.0.0.1",
                                                     port=0)])
        cfg.sys.enable = False
        cfg.api.enable, cfg.api.port, cfg.api.data_dir = True, 0, data_dir
        srv = BrokerServer(cfg, device=device)
        eng = srv.broker.router.engine
        eng.insert_many([("/".join(ws), fid) for fid, ws in filters])
        await srv.start()
        loop = asyncio.get_running_loop()
        admin = ApiClient(srv.api.port)
        clients = [admin]
        subs = {}
        acks = []

        async def call(cl, *a, **kw):
            return await loop.run_in_executor(
                None, lambda: cl.call(*a, **kw))

        async def ack(cl):
            while True:
                pkt = await cl.inbox.get()
                if pkt is None:
                    return
                if pkt.type == cl.C.PUBLISH and pkt.qos == 1:
                    cl.send(cl.C.Puback(packet_id=pkt.packet_id))

        try:
            admin.auth = await loop.run_in_executor(None, admin.login)
            keys = {}
            for role in ("administrator", "viewer", "publisher"):
                st, _, body = await call(admin, "POST", "/api/v5/api_key",
                                         {"name": f"k-{role}",
                                          "role": role})
                keys[role] = basic_auth(body["api_key"], body["api_secret"])
            st, _, _ = await call(admin, "POST", "/api/v5/users",
                                  {"username": "auditor",
                                   "password": "s3cret", "role": "viewer"})
            out["setup"] = st
            posted = []
            for rid, sql in make_rules(100, n_fallback=6):
                st, _, body = await call(admin, "POST", "/api/v5/rules",
                                         {"id": rid, "sql": sql})
                posted.append((st, body))
            out["rules_posted"] = posted
            for cid, flt, qos in MGMT_SUBS:
                cl = TransportClient(srv.listeners[0].port, cid)
                await cl.connect()
                await cl.subscribe(flt, qos)
                subs[cid] = cl
                acks.append(loop.create_task(ack(cl)))
            pub = TransportClient(srv.listeners[0].port, "mqpub")
            await pub.connect()
            eng.rebuild()  # the rules' and subscribers' filters too
            publisher = ApiClient(srv.api.port, keys["publisher"])
            clients.append(publisher)
            delivered = []
            for k, (topic, payload) in enumerate(zip(topics, payloads)):
                if k % 2 == 0:
                    st, _, body = await call(
                        publisher, "POST", "/api/v5/publish",
                        {"topic": topic, "payload": payload.decode(),
                         "qos": 1, "clientid": "restpub"})
                    delivered.append((st, body))
                else:
                    pub.send(pub.C.Publish(topic=topic, payload=payload,
                                           qos=1, packet_id=k))
                    await pub.expect(pub.C.PUBACK)
            out["delivered"] = delivered
            want = {cid: sum(T.match(t, flt) for t in topics)
                    for cid, flt, _ in MGMT_SUBS}
            deadline = loop.time() + 60
            for cid, cl in subs.items():
                while len(_publishes(cl)) < want[cid]:
                    if loop.time() > deadline:
                        raise AssertionError(
                            f"{cid}: {len(_publishes(cl))} of "
                            f"{want[cid]} messages")
                    await asyncio.sleep(0.01)
            out["subscriber_bytes"] = {cid: bytes(cl.raw)
                                       for cid, cl in subs.items()}
            reads = {}
            for path in ("/api/v5/rules", "/api/v5/metrics",
                         "/api/v5/stats", "/api/v5/clients",
                         "/api/v5/subscriptions", "/api/v5/topics",
                         "/api/v5/nodes", "/api/v5/alarms",
                         "/api/v5/banned", "/api/v5/api_key",
                         "/api/v5/users", "/api/v5/audit",
                         "/api/v5/schema_registry",
                         "/api/v5/mqtt/topic_metrics"):
                reads[path] = await call(admin, "GET", path)
            st, ct, prof = await call(admin, "GET",
                                      "/api/v5/profiler?windows=8")
            reads["/api/v5/profiler"] = (st, ct, sorted(prof))
            st, ct, text = await call(admin, "GET", "/metrics")
            reads["/metrics"] = (st, ct, prom_parse(text)[0])
            out["reads"] = reads
            anon = ApiClient(srv.api.port)
            viewer = ApiClient(srv.api.port, keys["viewer"])
            clients += [anon, viewer]
            out["refusals"] = [
                (await call(anon, "GET", "/api/v5/stats"))[0],
                (await call(viewer, "POST", "/api/v5/publish",
                            {"topic": "t"}))[0],
                (await call(publisher, "GET", "/api/v5/stats"))[0],
                (await call(admin, "GET", "/api/v5/olp"))[:3],
            ]
            out["engine"] = eng.stats()
        finally:
            for t in acks:
                t.cancel()
            for cl in subs.values():
                await cl.close()
            for cl in clients:
                cl.close()
            await srv.stop()
            shutil.rmtree(data_dir, ignore_errors=True)

    asyncio.run(asyncio.wait_for(run(), 300))
    return out


async def _ack_publishes(cl) -> None:
    """PUBACK every QoS 1 PUBLISH a `TransportClient` receives."""
    while True:
        pkt = await cl.inbox.get()
        if pkt is None:
            return
        if pkt.type == cl.C.PUBLISH and pkt.qos == 1:
            cl.send(cl.C.Puback(packet_id=pkt.packet_id))


def _publishes(cl):
    """The PUBLISH packets in a `TransportClient`'s raw bytes."""
    parser = cl.C.StreamParser(version=cl.version)
    return [p for p in parser.feed(bytes(cl.raw))
            if p.type == cl.C.PUBLISH]


def mgmt_outcome(world: dict) -> dict:
    """What `mgmt_world` on the card must equal on the CPU: everything
    but the times, the device-path split of the rule windows and the
    match engine's counters, normalised."""
    reads = dict(world["reads"])
    st, ct, rules = reads["/api/v5/rules"]
    stats = {k: v for k, v in rules["stats"].items()
             if k not in ("host_windows", "dev_windows")
             and not k.endswith("_us_ewma")}
    reads["/api/v5/rules"] = (st, ct, {**rules, "stats": stats})
    fams = reads["/metrics"][2]
    reads["/metrics"] = reads["/metrics"][:2] + ({
        n: k for n, k in fams.items()
        if not (n.startswith("emqx_engine_") and k == "gauge")},)
    return api_norm({k: v for k, v in world.items() if k != "engine"}
                    | {"reads": reads})


# ------------------------------------------- authentication back ends

class _TcpFixture:
    """A loopback TCP server whose ``stop`` also ends its connections;
    ``_serve(r, w)`` serves one connection."""

    port = 0
    _server = None

    async def start(self) -> None:
        self._conns: set = set()
        self._server = await asyncio.start_server(self._conn, "127.0.0.1", 0)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        self._server.close()
        for t in list(self._conns):
            t.cancel()
        await asyncio.gather(*self._conns, return_exceptions=True)
        await self._server.wait_closed()

    async def _conn(self, r, w) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            await self._serve(r, w)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            self._conns.discard(task)
            w.close()


class MongoFixture(_TcpFixture):
    """A loopback MongoDB stand-in speaking OP_MSG (opcode 2013):
    ``find`` over named collections, by equality on every field of the
    filter (``username`` indexed), with ``limit``; any other command
    answers ``ok: 0``.  Pipelined requests on one connection are
    answered in order.  ``finds`` counts requests by collection."""

    def __init__(self, collections, database: str = "mqtt",
                 index: str = "username") -> None:
        self.database = database
        self.index = index
        self._by = {}
        for name, docs in collections.items():
            by = self._by[name] = {}
            for d in docs:
                by.setdefault(d.get(index), []).append(d)
        self.finds: dict = {name: 0 for name in collections}
        self.connections = 0

    def _answer(self, doc: dict) -> dict:
        coll = doc.get("find")
        if coll not in self._by:
            return {"ok": 0.0, "errmsg": f"no such command or collection "
                                         f"{next(iter(doc), '')!r}"}
        self.finds[coll] += 1
        flt = doc.get("filter") or {}
        docs = self._by[coll].get(flt.get(self.index), ()) \
            if self.index in flt else \
            [d for ds in self._by[coll].values() for d in ds]
        batch = [d for d in docs
                 if all(d.get(k) == v for k, v in flt.items())]
        if doc.get("limit"):
            batch = batch[:int(doc["limit"])]
        return {"cursor": {"firstBatch": batch, "id": 0,
                           "ns": f"{self.database}.{coll}"}, "ok": 1.0}

    async def _serve(self, r, w) -> None:
        import struct

        from .auth_mongo import OP_MSG, bson_decode, bson_encode

        self.connections += 1
        while True:
            length, rid, _to, opcode = struct.unpack(
                "<iiii", await r.readexactly(16))
            payload = await r.readexactly(length - 16)
            if opcode != OP_MSG:
                return
            doc, _ = bson_decode(payload, 5)
            body = (struct.pack("<I", 0) + b"\x00"
                    + bson_encode(self._answer(doc)))
            w.write(struct.pack("<iiii", 16 + len(body), 0, rid, OP_MSG)
                    + body)
            await w.drain()


def _ber_read(buf: bytes, off: int):
    """(tag, content, next offset) of the BER element at ``off``."""
    tag, ln = buf[off], buf[off + 1]
    off += 2
    if ln & 0x80:
        n = ln & 0x7F
        ln = int.from_bytes(buf[off:off + n], "big")
        off += n
    if off + ln > len(buf):
        raise ValueError("truncated BER element")
    return tag, buf[off:off + ln], off + ln


class LdapFixture(_TcpFixture):
    """A loopback directory answering LDAPv3 simple binds: resultCode 0
    for an entry's password, 49 (invalidCredentials) for a wrong one,
    and 32 (noSuchObject) for a DN it does not hold, as a directory
    without that entry under its base does (so the authenticator passes
    the client on down the chain).  ``binds`` lists the (dn, password)
    pairs it was asked."""

    def __init__(self, entries) -> None:
        self.entries = dict(entries)  # dn -> password bytes
        self.binds: List[tuple] = []

    def _answer(self, msg: bytes) -> Optional[bytes]:
        from .auth_ldap import _ber, _ber_int

        _, seq, _ = _ber_read(msg, 0)
        _, mid, off = _ber_read(seq, 0)
        tag, op, _ = _ber_read(seq, off)
        if tag != 0x60:  # only BindRequest; an unbind ends the session
            return None
        _, _version, o = _ber_read(op, 0)
        _, dn, o = _ber_read(op, o)
        tag, pw, _ = _ber_read(op, o)
        dn_s = dn.decode("utf-8", "replace")
        self.binds.append((dn_s, pw))
        want = self.entries.get(dn_s)
        code = 32 if want is None else (0 if tag == 0x80 and pw == want
                                        else 49)
        resp = _ber(0x61, _ber(0x0A, bytes([code])) + _ber(0x04, b"")
                    + _ber(0x04, b""))
        return _ber(0x30, _ber_int(int.from_bytes(mid, "big")) + resp)

    async def _serve(self, r, w) -> None:
        while True:
            head = await r.readexactly(2)
            ext = b""
            ln = head[1]
            if ln & 0x80:
                ext = await r.readexactly(ln & 0x7F)
                ln = int.from_bytes(ext, "big")
            try:
                out = self._answer(head + ext + await r.readexactly(ln))
            except (ValueError, IndexError):  # not an LDAPMessage
                return
            if out is None:
                return
            w.write(out)
            await w.drain()


class HttpAuthFixture:
    """EMQX's HTTP authentication service on the port's own server
    (`httpd`): ``POST /auth`` with the authenticator's JSON answers
    ``{"result": "allow"}`` for a user's password, ``deny`` for a wrong
    one and ``ignore`` for a user it does not know.  ``requests`` lists
    the bodies it was sent."""

    def __init__(self, users) -> None:
        self.users = dict(users)  # username -> password
        self.requests: List[dict] = []
        self._http = None

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self._http.port}/auth"

    async def _auth(self, request):
        from . import httpd

        body = await request.json()
        self.requests.append(body)
        want = self.users.get(body.get("username"))
        result = ("ignore" if want is None
                  else "allow" if body.get("password") == want else "deny")
        return httpd.json_response({"result": result,
                                    "is_superuser": False})

    async def start(self) -> None:
        from . import httpd

        app = httpd.App()
        app.add_post("/auth", self._auth)
        self._http = httpd.HttpServer(app)
        await self._http.start()

    async def stop(self) -> None:
        await self._http.stop()


# users, keys and ACL rows from a seed

def salted_sha256_docs(rng: np.random.Generator, users) -> List[dict]:
    """EMQX's ``mqtt_user`` documents for ``[(username, password)]``:
    salted SHA-256, the salt before the password (EMQX's default)."""
    import hashlib

    docs = []
    for name, pw in users:
        salt = rng.bytes(8).hex()
        docs.append({"username": name, "salt": salt, "is_superuser": False,
                     "password_hash": hashlib.sha256(
                         (salt + pw).encode()).hexdigest()})
    return docs


def acl_docs(usernames) -> List[dict]:
    """Two ``mqtt_acl`` documents a user, with placeholders: publish on
    the user's own vehicle's sensors (``topics``) or its client's
    ``up`` topic, subscribe to every vehicle's sensors (``topic``); the
    broker's authz default denies the rest."""
    docs = []
    for u in usernames:
        docs.append({"username": u, "permission": "allow",
                     "action": "publish",
                     "topics": ["vehicles/${username}/sensors/#",
                                "${clientid}/up"]})
        docs.append({"username": u, "permission": "allow",
                     "action": "subscribe", "topic": "vehicles/+/sensors/#"})
    return docs


_PRIMORIAL: List[int] = []  # the product of the odd primes below 20,000


def _rand_int(rng: np.random.Generator, bits: int) -> int:
    return int.from_bytes(rng.bytes((bits + 7) // 8), "big") >> (
        -bits % 8)


def _probable_prime(rng: np.random.Generator, bits: int) -> int:
    """A random prime of ``bits`` bits (its top two bits set): odd
    candidates sieved by a gcd with `_PRIMORIAL`, then five
    Miller-Rabin rounds with random bases (enough for random candidates
    of 1,024 bits, FIPS 186-4 table C.2)."""
    import math

    if not _PRIMORIAL:
        sieve = bytearray([1]) * 20_000
        prod = 1
        for p in range(3, 20_000, 2):
            if sieve[p]:
                prod *= p
                sieve[p * p::2 * p] = bytes(len(range(p * p, 20_000, 2 * p)))
        _PRIMORIAL.append(prod)
    while True:
        n = _rand_int(rng, bits) | (3 << (bits - 2)) | 1
        if math.gcd(n, _PRIMORIAL[0]) != 1:
            continue
        d, s = n - 1, 0
        while not d & 1:
            d, s = d >> 1, s + 1
        for _ in range(5):
            x = pow(2 + _rand_int(rng, bits - 2) % (n - 3), d, n)
            if x in (1, n - 1):
                continue
            for _ in range(s - 1):
                x = x * x % n
                if x == n - 1:
                    break
            else:
                break
        else:
            return n


def rsa_key(rng: np.random.Generator, bits: int = 2048) -> dict:
    """An RSA key pair with e = 65537 from ``rng``: n, e and the CRT
    parts of d."""
    e = 65537
    while True:
        p = _probable_prime(rng, bits // 2)
        q = _probable_prime(rng, bits - bits // 2)
        if p == q or (p - 1) % e == 0 or (q - 1) % e == 0:
            continue
        n = p * q
        if n.bit_length() == bits:
            d = pow(e, -1, (p - 1) * (q - 1))
            return {"kty": "RSA", "n": n, "e": e, "p": p, "q": q,
                    "dp": d % (p - 1), "dq": d % (q - 1),
                    "qi": pow(q, -1, p)}


def _p256_times_g(k: int) -> Tuple[int, int]:
    """k * G on P-256, affine."""
    from .gcp_device import _G, _P, _mul2

    x, y, z = _mul2(k, (*_G, 1), 0, (*_G, 1))
    zi = pow(z, -1, _P)
    return x * zi * zi % _P, y * zi * zi * zi % _P


def p256_key(rng: np.random.Generator) -> dict:
    """A P-256 key pair from ``rng``: d and the point (x, y)."""
    from .gcp_device import _N

    d = 1 + _rand_int(rng, 256) % (_N - 1)
    x, y = _p256_times_g(d)
    return {"kty": "EC", "d": d, "x": x, "y": y}


def _der(tag: int, content: bytes) -> bytes:
    n = len(content)
    if n < 0x80:
        return bytes([tag, n]) + content
    ln = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([tag, 0x80 | len(ln)]) + ln + content


def _der_uint(v: int) -> bytes:
    return _der(0x02, v.to_bytes(v.bit_length() // 8 + 1, "big"))


def public_pem(key: dict) -> str:
    """The key's SubjectPublicKeyInfo as PEM (IoT Core's ``RSA_PEM`` and
    ``ES256_PEM``)."""
    import base64

    if key["kty"] == "RSA":
        alg = _der(0x30, bytes.fromhex("06092a864886f70d010101") +
                   b"\x05\x00")
        bits = _der(0x30, _der_uint(key["n"]) + _der_uint(key["e"]))
    else:
        alg = _der(0x30, bytes.fromhex("06072a8648ce3d0201"
                                       "06082a8648ce3d030107"))
        bits = (b"\x04" + key["x"].to_bytes(32, "big")
                + key["y"].to_bytes(32, "big"))
    der = _der(0x30, alg + _der(0x03, b"\x00" + bits))
    b64 = base64.b64encode(der).decode()
    lines = [b64[i:i + 64] for i in range(0, len(b64), 64)]
    return "\n".join(["-----BEGIN PUBLIC KEY-----", *lines,
                      "-----END PUBLIC KEY-----", ""])


def _b64url(data: bytes) -> str:
    import base64

    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def sign_jwt(key: dict, claims: dict) -> str:
    """A JWT over ``claims`` signed RS256 (an RSA key) or ES256 (a P-256
    key, a random per-signature secret)."""
    import hashlib
    import secrets

    from .gcp_device import _N

    alg = "RS256" if key["kty"] == "RSA" else "ES256"
    head = _b64url(json.dumps({"alg": alg, "typ": "JWT"}).encode())
    signing = f"{head}.{_b64url(json.dumps(claims).encode())}"
    digest = hashlib.sha256(signing.encode()).digest()
    if alg == "RS256":
        from .gcp_device import _SHA256_PREFIX

        k = (key["n"].bit_length() + 7) // 8
        t = _SHA256_PREFIX + digest
        m = int.from_bytes(b"\x00\x01" + b"\xff" * (k - len(t) - 3)
                           + b"\x00" + t, "big")
        p, q = key["p"], key["q"]
        m1, m2 = pow(m, key["dp"], p), pow(m, key["dq"], q)
        s = m2 + q * (key["qi"] * (m1 - m2) % p)
        sig = s.to_bytes(k, "big")
    else:
        e = int.from_bytes(digest, "big")
        r = s = 0
        while not (r and s):
            nonce = 1 + secrets.randbelow(_N - 1)
            r = _p256_times_g(nonce)[0] % _N
            s = pow(nonce, -1, _N) * (e + r * key["d"]) % _N
        sig = r.to_bytes(32, "big") + s.to_bytes(32, "big")
    return f"{signing}.{_b64url(sig)}"


AUTH_KINDS = ("gcp", "ldap", "http", "mongo")  # the chain's order
GCP_PREFIX = "projects/p1/locations/us-central1/registries/fleet/devices/"
LDAP_DN = "uid=${username},ou=users,dc=example,dc=com"


def authdb_script(seed: int, n_clients: int, n_mongo_users: int,
                  n_gcp: Tuple[int, int] = (4, 4), n_ldap: int = 16,
                  n_http: int = 16, n_msgs: int = 64,
                  rsa_bits: int = 2048,
                  rsa_keys: Optional[List[dict]] = None) -> dict:
    """A seeded world of the four authentication back ends, in the
    chain's order (`AUTH_KINDS`): GCP devices (``n_gcp`` RS256 and ES256
    keys, a JWT each, usernames v0...), LDAP users, HTTP users and
    ``n_mongo_users`` Mongo users (salted SHA-256), each named after a
    vehicle of the fleet filters (``v<j>``, disjoint ranges), with
    `acl_docs` for every one of them.

    ``connects``: ``n_clients`` CONNECTs round-robin over the kinds,
    ``(kind, clientid, username, password, accepted)``; the first of
    each kind is refused (a JWT of another key, a wrong password).
    The clients that stay connected are the last three of each kind
    whose clientid no later CONNECT reuses: two ``publishers`` and a
    ``subscriber``.  ``pubs``: ``n_msgs`` QoS 1 publishes ``(connect
    index, topic)`` round-robin over the publishers, each on its own
    vehicle's sensors but every 8th on the next vehicle's (outside its
    rows).  ``rsa_keys``, when given, are the RSA keys (`rsa_key`; a
    caller may make them in parallel), else they are made here."""
    rng = np.random.default_rng(seed)
    n_rsa, n_ec = n_gcp
    if rsa_keys is None:
        rsa_keys = [rsa_key(rng, rsa_bits) for _ in range(n_rsa)]
    keys = list(rsa_keys) + [p256_key(rng) for _ in range(n_ec)]
    wrong = p256_key(rng)
    base = {"gcp": 0}
    base["ldap"] = len(keys)
    base["http"] = base["ldap"] + n_ldap
    base["mongo"] = base["http"] + n_http
    sizes = {"gcp": len(keys), "ldap": n_ldap, "http": n_http,
             "mongo": n_mongo_users}

    def users(kind):
        return [(f"v{base[kind] + i}", rng.bytes(6).hex())
                for i in range(sizes[kind])]

    by_kind = {kind: users(kind) for kind in AUTH_KINDS[1:]}
    import time as _time

    exp = int(_time.time()) + 3600
    devices, tokens = [], []
    for i, key in enumerate(keys):
        devices.append({"deviceid": f"d{i}", "project": "p1",
                        "location": "us-central1", "registry": "fleet",
                        "keys": [{"key_type": "RSA_PEM" if key["kty"] == "RSA"
                                  else "ES256_PEM", "key": public_pem(key),
                                  "expires_at": 0}]})
        tokens.append(sign_jwt(key, {"aud": "p1", "exp": exp}))
    connects = []
    seen = dict.fromkeys(AUTH_KINDS, 0)
    for i in range(n_clients):
        kind = AUTH_KINDS[i % len(AUTH_KINDS)]
        j = seen[kind]
        seen[kind] += 1
        if kind == "gcp":
            d = j % len(keys)
            cid, name = f"{GCP_PREFIX}d{d}", f"v{d}"
            pw = tokens[d] if j else sign_jwt(wrong, {"exp": exp})
        else:
            name, pw = by_kind[kind][j % sizes[kind]]
            cid = f"{kind}-{j}"
            if not j:
                pw = "not-" + pw
        connects.append((kind, cid, name, pw.encode(), j > 0))
    keep = {kind: [] for kind in AUTH_KINDS}
    later: set = set()
    for i in range(n_clients - 1, -1, -1):
        kind, cid, _n, _p, ok = connects[i]
        if ok and cid not in later and len(keep[kind]) < 3:
            keep[kind].append(i)
        later.add(cid)
    if any(len(v) < 3 for v in keep.values()):
        raise ValueError(f"{n_clients} clients leave {keep}: each kind needs "
                         f"three that stay connected")
    publishers = [i for kind in AUTH_KINDS for i in keep[kind][:2]]
    pubs = []
    for k in range(n_msgs):
        i = publishers[k % len(publishers)]
        me = int(connects[i][2][1:])
        j = me + 1 if k % 8 == 7 else me
        pubs.append((i, f"vehicles/v{j}/sensors/temp"))
    all_users = [(f"v{i}", None) for i in range(len(keys))] + [
        u for kind in AUTH_KINDS[1:] for u in by_kind[kind]]
    return {
        "seed": seed, "devices": devices,
        "ldap": {LDAP_DN.replace("${username}", name): pw.encode()
                 for name, pw in by_kind["ldap"]},
        "http": dict(by_kind["http"]),
        "mongo_users": salted_sha256_docs(rng, by_kind["mongo"]),
        "acl": acl_docs(name for name, _ in all_users),
        "connects": connects, "pubs": pubs,
        "publishers": publishers,
        "subscribers": [keep[kind][2] for kind in AUTH_KINDS],
    }


def port_impl(device: str):
    """The port's modules as `authdb_world` and `exhook_world` drive
    them (``kernels``: the launch counters)."""
    from types import SimpleNamespace

    from . import auth_ldap, auth_mongo, auth_providers, config
    from .broker.listener import BrokerServer
    from .ops import match_kernel

    return SimpleNamespace(
        config=config, ldap=auth_ldap, providers=auth_providers,
        mongo=auth_mongo, kernels=match_kernel,
        server=lambda cfg: BrokerServer(cfg, device=device))


async def start_auth_backends(script: dict):
    """The script's Mongo, LDAP and HTTP fixtures, started."""
    mongo = MongoFixture({"mqtt_user": script["mongo_users"],
                          "mqtt_acl": script["acl"]})
    ldap = LdapFixture(script["ldap"])
    http = HttpAuthFixture(script["http"])
    for f in (mongo, ldap, http):
        await f.start()
    return mongo, ldap, http


def auth_chain(impl, broker, fixtures) -> None:
    """Append the LDAP, HTTP and Mongo authenticators behind the GCP one
    the broker made, and the Mongo ACL source, on one Mongo
    connection."""
    mongo, ldap, http = fixtures
    conn = impl.mongo.MongoConnector("127.0.0.1", mongo.port)
    broker.access.authenticators += [
        impl.ldap.LdapAuthenticator("127.0.0.1", ldap.port, bind_dn=LDAP_DN),
        impl.providers.HttpAuthenticator(http.url),
        impl.mongo.MongoAuthenticator(conn),
    ]
    broker.access.db_authz_sources.append(impl.mongo.MongoAuthorizer(conn))


def auth_config(impl, data_dir: str):
    """The auth world's server config: no anonymous clients, authz
    default deny, the GCP registry in ``data_dir``."""
    cfg = impl.config.BrokerConfig(listeners=[impl.config.ListenerConfig(
        bind="127.0.0.1", port=0)])
    cfg.auth.allow_anonymous = False
    cfg.auth.authz_default = "deny"
    cfg.gcp_device_enable = True
    cfg.gcp_device_file = os.path.join(data_dir, "gcp_devices.json")
    cfg.sys.enable = False
    return cfg


def authdb_world(device: str, script: dict, n_filters: int = 4000,
                 impl=None) -> dict:
    """Run `authdb_script`'s world through a `BrokerServer` on
    ``device`` over TCP (``impl``: the modules to drive, the port's by
    default): the fixtures started, ``n_filters`` fleet filters in the
    engine, the registry imported, the chain of `auth_chain`; each
    CONNECT in turn (MQTT 5, each CONNACK awaited), the subscribers on
    the vehicles' sensors and on a topic their rows do not allow, the
    publishes one at a time (each PUBACK awaited), the deliveries
    awaited.  Returns every client's bytes (by CONNECT index: a GCP
    device connects more than once), the broker's metrics and what each
    back end was asked."""
    import shutil
    import tempfile

    impl = impl or port_impl(device)
    filters, _ = make_filters(n_filters, 8)
    out: dict = {}

    async def run() -> None:
        data_dir = tempfile.mkdtemp(prefix="emqx-authdb-")
        fixtures = await start_auth_backends(script)
        srv = impl.server(auth_config(impl, data_dir))
        b = srv.broker
        imported = b.gcp_devices.import_devices(script["devices"])
        auth_chain(impl, b, fixtures)
        b.router.engine.insert_many(
            [("/".join(ws), fid) for fid, ws in filters])
        await srv.start()
        clients = {}
        keepers = set(script["publishers"]) | set(script["subscribers"])
        acks = []
        try:
            for i, (_k, cid, name, pw, ok) in enumerate(script["connects"]):
                cl = TransportClient(srv.listeners[0].port, cid,
                                     username=name, password=pw)
                await cl.connect(rc=0 if ok else 0x86)
                if i not in keepers:  # a refused client is never kept
                    if ok:
                        cl.send(cl.C.Disconnect())
                    await cl.eof()
                clients[i] = cl
            for i in script["subscribers"]:
                cl = clients[i]
                cl.send(cl.C.Subscribe(packet_id=1, subscriptions=[
                    cl.C.Subscription(topic_filter=f, qos=1)
                    for f in ("vehicles/+/sensors/#", "nomatch/#")]))
                await cl.expect(cl.C.SUBACK)
                acks.append(asyncio.get_running_loop().create_task(
                    _ack_publishes(cl)))
            b.router.engine.rebuild()
            asked = (dict(fixtures[0].finds), len(fixtures[1].binds),
                     len(fixtures[2].requests))
            for k, (i, topic) in enumerate(script["pubs"]):
                cl = clients[i]
                cl.send(cl.C.Publish(topic=topic, qos=1, packet_id=k + 1,
                                     payload=b"%d" % k))
                await cl.expect(cl.C.PUBACK)
            accepted = sum(
                1 for i, t in script["pubs"]
                if t.split("/")[1] == script["connects"][i][2])
            deadline = asyncio.get_running_loop().time() + 60
            for i in script["subscribers"]:
                while len(_publishes(clients[i])) < accepted:
                    if asyncio.get_running_loop().time() > deadline:
                        raise AssertionError(
                            f"subscriber {i}: {len(_publishes(clients[i]))} "
                            f"of {accepted} messages")
                    await asyncio.sleep(0.01)
            for i in script["publishers"]:
                await clients[i].quiet()
            out["bytes"] = {i: bytes(cl.raw) for i, cl in clients.items()}
            out["imported"] = imported
            out["asked"] = {
                "mongo": dict(fixtures[0].finds),
                "ldap": [dn for dn, _ in fixtures[1].binds],
                "http": [r["username"] for r in fixtures[2].requests],
                "before_publish": asked,
            }
            out["metrics"] = dict(b.metrics.all())
        finally:
            for t in acks:
                t.cancel()
            for cl in clients.values():
                await cl.close()
            await srv.stop()
            for f in fixtures:
                await f.stop()
            shutil.rmtree(data_dir, ignore_errors=True)

    asyncio.run(asyncio.wait_for(run(), 300))
    return out



# ------------------------------------------------------------- exhook

EXHOOK_KINDS = ("rw", "drop", "deny", "plain")  # the four topic families
EXHOOK_SUB_FILTERS = ("rw/#", "drop/+/t", "+/+/t", "#")


def exhook_verdicts(seed: int) -> dict:
    """A provider's seeded verdict table: payloads under ``rewrite``
    get ``suffix``, publishes under ``drop`` come back with
    allow_publish=false, usernames starting ``deny_user`` are refused
    at authenticate, publishes under ``deny_publish`` at authorize."""
    rng = np.random.default_rng([15, seed])
    return {"rewrite": "rw/", "drop": "drop/", "deny_user": "bad-",
            "deny_publish": "deny/",
            "suffix": b"!" + rng.integers(0, 256, 4, np.uint8)
            .tobytes().hex().encode()}


class ExhookProviderFixture:
    """A HookProvider on the port's own gRPC server (`grpc_util`) that
    answers from a verdict table (`exhook_verdicts`) and records every
    request it gets, in arrival order (``requests``: ``(rpc, request)``;
    ``counts`` by rpc).  ``delay`` (seconds) holds each verdict RPC.
    ``stop`` closes every connection it accepted."""

    HOOKS = ("message.publish", "client.authenticate", "client.authorize",
             "session.created", "message.delivered")

    def __init__(self, verdicts: dict, hooks: Sequence[str] = HOOKS,
                 max_workers: int = 8) -> None:
        import threading
        from collections import Counter

        from . import grpc_util
        from .exhook import pb

        self.pb = pb
        self.verdicts = verdicts
        self.hooks = list(hooks)
        self.delay = 0.0
        self.requests: List[Tuple[str, object]] = []
        self.counts: Counter = Counter()
        self._lock = threading.Lock()
        self._srv = grpc_util.Server(max_workers=max_workers)
        svc = pb.DESCRIPTOR.services[0]
        for m in svc.methods:
            req_cls = getattr(pb, m.input_type.rsplit(".", 1)[1])
            fn = getattr(self, "_" + m.name, None) or self._notify(m.name)
            self._srv.add_method(f"/{svc.full_name}/{m.name}",
                                 self._recorded(m.name, fn),
                                 req_cls.FromString,
                                 lambda r: r.SerializeToString())
        self.port = 0

    def _recorded(self, rpc: str, fn):
        def call(req, ctx):
            with self._lock:
                self.requests.append((rpc, req))
                self.counts[rpc] += 1
            return fn(req)

        return call

    def _notify(self, rpc: str):
        return lambda req: self.pb.EmptySuccess()

    def _wait(self) -> None:
        if self.delay:
            import time

            time.sleep(self.delay)

    def _OnProviderLoaded(self, req):
        pb = self.pb
        return pb.LoadedResponse(hooks=[pb.HookSpec(name=n, topics=["#"])
                                        for n in self.hooks])

    def _OnMessagePublish(self, req):
        pb, v = self.pb, self.verdicts
        self._wait()
        m = req.message
        if m.topic.startswith(v["drop"]):
            out = pb.Message()
            out.CopyFrom(m)
            out.headers["allow_publish"] = "false"
            return pb.ValuedResponse(type=pb.ValuedResponse.STOP_AND_RETURN,
                                     message=out)
        if m.topic.startswith(v["rewrite"]):
            out = pb.Message()
            out.CopyFrom(m)
            out.payload = m.payload + v["suffix"]
            return pb.ValuedResponse(type=pb.ValuedResponse.CONTINUE,
                                     message=out)
        return pb.ValuedResponse(type=pb.ValuedResponse.IGNORE)

    def _OnClientAuthenticate(self, req):
        pb = self.pb
        self._wait()
        ok = not req.clientinfo.username.startswith(
            self.verdicts["deny_user"])
        return pb.ValuedResponse(type=pb.ValuedResponse.STOP_AND_RETURN,
                                 bool_result=ok)

    def _OnClientAuthorize(self, req):
        pb = self.pb
        self._wait()
        ok = not (req.type == pb.ClientAuthorizeRequest.PUBLISH
                  and req.topic.startswith(self.verdicts["deny_publish"]))
        return pb.ValuedResponse(type=pb.ValuedResponse.STOP_AND_RETURN,
                                 bool_result=ok)

    def start(self) -> int:
        self.port = self._srv.add_insecure_port("127.0.0.1:0")
        self._srv.start()
        return self.port

    @property
    def url(self) -> str:
        return f"127.0.0.1:{self.port}"

    def stop(self) -> None:
        self._srv.stop(0.5).wait(10)

    def decoded(self) -> dict:
        """Every request recorded, by rpc, as the JSON mapping without
        the fields that differ run to run (message ids and timestamps,
        the uptime) or by package (the cluster name), sorted."""
        from .protobuf import to_dict

        out: dict = {}
        with self._lock:
            reqs = list(self.requests)
        for rpc, req in reqs:
            d = to_dict(req)
            msg = d.get("message")
            if msg is not None:
                msg.pop("id", None)
                msg.pop("timestamp", None)
            d.get("broker", {}).pop("uptime", None)
            d.get("meta", {}).pop("cluster_name", None)
            out.setdefault(rpc, []).append(json.dumps(d, sort_keys=True))
        return {k: sorted(v) for k, v in out.items()}


def exhook_script(seed: int, n_clients: int = 16, n_msgs: int = 64) -> dict:
    """A seeded exhook world: ``n_clients`` MQTT 5 clients (every 8th
    username refused by the provider), four subscribers on
    `EXHOOK_SUB_FILTERS`, the other accepted clients publishing
    ``n_msgs`` QoS 1 messages over the four topic families."""
    rng = np.random.default_rng([15, seed, 1])
    connects = []
    for i in range(n_clients):
        name = f"bad-{i}" if i % 8 == 7 else f"u-{i}"
        connects.append((f"ex-{i}", name, i % 8 != 7))
    ok = [i for i, c in enumerate(connects) if c[2]]
    subs = list(zip(ok[:len(EXHOOK_SUB_FILTERS)], EXHOOK_SUB_FILTERS))
    pubs_from = ok[len(EXHOOK_SUB_FILTERS):]
    pubs = []
    for k in range(n_msgs):
        kind = EXHOOK_KINDS[int(rng.integers(len(EXHOOK_KINDS)))]
        topic = f"{kind}/{int(rng.integers(5))}/t"
        pubs.append((pubs_from[k % len(pubs_from)], topic, b"m%d" % k))
    return {"seed": seed, "verdicts": exhook_verdicts(seed),
            "connects": connects, "subscribers": subs, "pubs": pubs}


def exhook_expected(script: dict) -> dict:
    """What each subscriber must receive, in order, under the verdict
    table: ``{client index: [(topic, payload), ...]}``."""
    from . import topic as T

    v = script["verdicts"]
    out = {i: [] for i, _ in script["subscribers"]}
    for _i, topic, payload in script["pubs"]:
        if topic.startswith((v["drop"], v["deny_publish"])):
            continue
        if topic.startswith(v["rewrite"]):
            payload = payload + v["suffix"]
        for i, flt in script["subscribers"]:
            if T.match(topic, flt):
                out[i].append((topic, payload))
    return out


def exhook_world(device: str, script: dict, n_filters: int = 4000,
                 impl=None) -> dict:
    """Run `exhook_script`'s world: an `ExhookProviderFixture` in front
    of a `BrokerServer` on ``device`` (``impl``: the modules to drive,
    the port's by default; the broker dials the fixture through its
    ``exhooks`` config, fail-closed), ``n_filters`` fleet filters in
    the engine, each CONNECT in turn over TCP, the subscribers, then
    each publish in turn (its PUBACK awaited), the deliveries and the
    provider's notifications awaited.  Returns the CONNACK and PUBACK
    codes, every client's bytes, the provider's requests decoded
    (`ExhookProviderFixture.decoded`), the broker's metrics, and on the
    port's broker the K1/K3 launches and decide windows."""
    impl = impl or port_impl(device)
    filters, _ = make_filters(n_filters, 8)
    want = exhook_expected(script)
    out: dict = {}

    async def run() -> None:
        fixture = ExhookProviderFixture(script["verdicts"])
        fixture.start()
        cfg = impl.config.BrokerConfig(listeners=[
            impl.config.ListenerConfig(bind="127.0.0.1", port=0)])
        cfg.sys.enable = False
        cfg.exhooks = [{"name": "fixture", "url": fixture.url,
                        "timeout": 10.0, "failure_action": "deny"}]
        srv = impl.server(cfg)
        b = srv.broker
        b.router.engine.insert_many(
            [("/".join(ws), fid) for fid, ws in filters])
        await srv.start()
        loop = asyncio.get_running_loop()
        clients = {}
        acks = []
        try:
            codes = []
            for i, (cid, name, ok) in enumerate(script["connects"]):
                cl = TransportClient(srv.listeners[0].port, cid,
                                     username=name, password=b"pw")
                codes.append((await cl.connect(rc=0 if ok else 0x86))
                             .reason_code)
                if not ok:
                    await cl.eof()
                clients[i] = cl
            for i, flt in script["subscribers"]:
                await clients[i].subscribe(flt, 1)
                acks.append(loop.create_task(_ack_publishes(clients[i])))
            b.router.engine.rebuild()
            kernels = getattr(impl, "kernels", None)
            if kernels is not None:
                kernels.reset_launches()
                decides = b.router.engine.counters["decide_windows"]
            pubacks = []
            for k, (i, topic, payload) in enumerate(script["pubs"]):
                cl = clients[i]
                cl.send(cl.C.Publish(topic=topic, qos=1, packet_id=k + 1,
                                     payload=payload))
                pubacks.append((await cl.expect(cl.C.PUBACK)).reason_code)
            deadline = loop.time() + 60
            for i, _ in script["subscribers"]:
                while len(_publishes(clients[i])) < len(want[i]):
                    if loop.time() > deadline:
                        raise AssertionError(
                            f"subscriber {i}: {len(_publishes(clients[i]))}"
                            f" of {len(want[i])} messages")
                    await asyncio.sleep(0.01)
                got = [(p.topic, p.payload) for p in _publishes(clients[i])]
                if got != want[i]:
                    raise AssertionError(f"subscriber {i} got {got[:4]}, "
                                         f"expected {want[i][:4]}")
            n_del = sum(len(x) for x in want.values())
            n_sessions = sum(1 for c in script["connects"] if c[2])
            while (fixture.counts["OnMessageDelivered"] < n_del
                   or fixture.counts["OnSessionCreated"] < n_sessions):
                if loop.time() > deadline:
                    raise AssertionError(
                        f"provider notified {dict(fixture.counts)}")
                await asyncio.sleep(0.01)
            if kernels is not None:
                out["launches"] = kernels.launches()
                out["decide_windows"] = \
                    b.router.engine.counters["decide_windows"] - decides
            out["connacks"] = codes
            out["pubacks"] = pubacks
            out["bytes"] = {i: bytes(cl.raw) for i, cl in clients.items()}
            out["requests"] = fixture.decoded()
            out["counts"] = dict(fixture.counts)
            m = b.metrics
            out["metrics"] = {k: m[k] if hasattr(m, "__getitem__")
                              else m.val(k) for k in (
                "messages.publish", "messages.delivered",
                "messages.dropped", "authorization.deny",
                "authorization.allow", "client.authenticate",
                "client.auth.failure", "client.connected")}
        finally:
            for t in acks:
                t.cancel()
            for cl in clients.values():
                await cl.close()
            await srv.stop()
            fixture.stop()

    asyncio.run(asyncio.wait_for(run(), 300))
    return out


def exhook_server_script(seed: int, n_rpcs: int) -> List[Tuple[str, dict]]:
    """Seeded HookProvider calls for an `ExhookServer`: mostly
    OnMessagePublish over the fleet topics and the rules' families
    (JSON payloads the rules read), with authenticate and authorize
    calls between them: ``[(rpc, request as the JSON mapping)]``."""
    rng = np.random.default_rng([15, seed, 2])
    pops = populations(4000, 8)
    topics = make_topics(rng, n_rpcs, pops)
    payloads = make_rule_payloads(rng, n_rpcs)
    out: List[Tuple[str, dict]] = []
    for k in range(n_rpcs):
        r = int(rng.integers(10))
        if r == 0:
            out.append(("OnClientAuthenticate", {"clientinfo": {
                "clientid": f"c{k}", "username": f"user{k % 7}",
                "password": "pw"}}))
        elif r == 1:
            out.append(("OnClientAuthorize", {
                "clientinfo": {"clientid": f"c{k}"}, "type": "PUBLISH",
                "topic": topics[k]}))
        else:
            out.append(("OnMessagePublish", {"message": {
                "topic": topics[k], "qos": k % 2, "id": f"{k:08x}",
                "payload": base64.b64encode(payloads[k]).decode()},
                "meta": {"node": "emqx@remote"}}))
    return out


def exhook_server_world(device: str, calls: Sequence[Tuple[str, dict]],
                        n_filters: int = 4000, filters=None) -> dict:
    """`ExhookServer` on a `Broker` on ``device`` with ``n_filters``
    fleet filters (or ``filters``) and config 4's 99 fleet rules (their
    actions record what fired), called once per entry of ``calls``
    (`exhook_server_script`) in turn through the port's gRPC client.
    Returns each response's bytes, the rules fired, the K1 launches, the
    OnMessagePublish count and each call's milliseconds."""
    import time

    from . import grpc_util
    from .broker.broker import Broker
    from .exhook import pb
    from .exhook.server import SERVICE, ExhookServer
    from .ops import match_kernel as mk
    from .protobuf import from_dict
    from .rules.engine import FunctionAction

    if filters is None:
        filters, _ = make_filters(n_filters, 8)
    b = Broker(device=device)
    b.router.engine.insert_many([("/".join(ws), fid) for fid, ws in filters])
    fired: list = []
    for rid, sql in make_rules(99, n_fallback=6):
        b.rules.add_rule(rid, sql, actions=[FunctionAction(
            lambda sel, msg, rid=rid: fired.append(
                (rid, msg.topic, msg.payload, sorted(sel.items()))))])
    b.router.engine.rebuild()
    srv = ExhookServer(broker=b)
    srv.start()
    ch = grpc_util.Channel(f"127.0.0.1:{srv.port}")
    responses, ms = [], []
    svc = pb.DESCRIPTOR.services[0]
    methods = {m.name: m for m in svc.methods}
    try:
        mk.reset_launches()
        for rpc, req in calls:
            m = methods[rpc]
            req_cls = getattr(pb, m.input_type.rsplit(".", 1)[1])
            resp_cls = getattr(pb, m.output_type.rsplit(".", 1)[1])
            fn = ch.unary_unary(f"/{SERVICE}/{rpc}",
                                lambda r: r.SerializeToString(),
                                resp_cls.FromString)
            body = from_dict(req, req_cls())
            t0 = time.perf_counter()
            resp = fn(body, timeout=30)
            ms.append((time.perf_counter() - t0) * 1e3)
            responses.append((rpc, resp.SerializeToString()))
        launches = mk.launches()
    finally:
        ch.close()
        srv.stop()
        b.shutdown()
    return {"responses": responses, "fired": fired, "launches": launches,
            "publishes": sum(1 for rpc, _ in calls
                             if rpc == "OnMessagePublish"), "ms": ms}


# ------------------------------------------------------- durable sessions

# the fleet's families, one wildcard filter a persistent session
DURABLE_FILTERS = ("vehicles/v{k}/sensors/#", "dev/g{k}/+/d1",
                   "site/+/floor/f{k}/#", "alerts/z{k}/+/+")
DURABLE_TOPICS = ("vehicles/v{k}/sensors/temp", "dev/g{k}/x/d1",
                  "site/s1/floor/f{k}/door", "alerts/z{k}/a/b")


def durable_script(seed: int, n_sessions: int, n_msgs: int,
                   n_keys: int = 16) -> dict:
    """Persistent sessions, each on one wildcard filter of the fleet's
    families over ``n_keys`` keys (MQTT 3.1.1 and 5.0, QoS 1 and 2,
    some with no-local), and ``n_msgs`` QoS 1/2 messages on topics those
    filters match, from three publishers (one of them a subscriber),
    with payloads, message ids and timestamps from the seed."""
    rng = np.random.default_rng(seed)
    sessions = []
    for i in range(n_sessions):
        fam = int(rng.integers(len(DURABLE_FILTERS)))
        sessions.append({
            "cid": f"ds-{i}",
            "flt": DURABLE_FILTERS[fam].format(k=int(rng.integers(n_keys))),
            "qos": int(rng.integers(1, 3)),
            "no_local": bool(rng.random() < 0.2),
            "version": 5 if rng.random() < 0.75 else 4,
        })
    t0 = 4_000_000_000.0 + seed  # after any checkpoint of the run
    msgs = []
    for j in range(n_msgs):
        fam = int(rng.integers(len(DURABLE_TOPICS)))
        msgs.append({
            "topic": DURABLE_TOPICS[fam].format(k=int(rng.integers(n_keys))),
            "qos": int(rng.integers(1, 3)),
            "payload": bytes(rng.integers(0, 256, int(rng.integers(0, 96)),
                                          dtype=np.uint8)),
            "from": str(rng.choice(["pub-a", "pub-b", "ds-0"])),
            "mid": bytes(rng.integers(0, 256, 16, dtype=np.uint8)),
            "timestamp": t0 + j * 1e-3,
        })
    return {"sessions": sessions, "msgs": msgs}


def durable_world(device: str, script: dict, windowed: bool = True,
                  n_filters: int = 20_000) -> dict:
    """`durable_script`'s world on the port's broker, loop-less: each
    session subscribes and disconnects (checkpointed), the messages go
    through ``publish_many`` in windows of 256 beside
    ``n_filters`` fleet filters (the host gate persists them), the
    broker restarts on its directory, every session reconnects and the
    resume scheduler drains the backlogs (``windowed``: replay windows
    decided by the decide kernel; else the scalar referee), each client
    acknowledging what it receives.  Returns every client's bytes, the
    broker's replay metrics and the kernels' launches in the replay."""
    import shutil
    import tempfile

    from .broker.broker import Broker
    from .broker.channel import Channel
    from .broker.session import SubOpts
    from .codec import mqtt as C
    from .config import BrokerConfig
    from .message import Message
    from .ops import match_kernel as mk

    data_dir = tempfile.mkdtemp(prefix="durable-world-")
    filters, _ = make_filters(n_filters, 8)

    def broker():
        cfg = BrokerConfig()
        cfg.sys.enable = False
        cfg.mqtt.max_inflight = 1024
        cfg.durable.enable = True
        cfg.durable.data_dir = data_dir
        cfg.durable.fsync = "always"
        cfg.durable.resume.windowed = windowed
        cfg.durable.resume.max_concurrent = 8
        cfg.durable.resume.chunk_msgs = 64
        b = Broker(config=cfg, device=device)
        b.router.engine.insert_many(
            [("/".join(ws), fid) for fid, ws in filters])
        b.router.engine.rebuild()
        return b

    class Wire(Channel):
        def __init__(self, b, version):
            self.writes = []

            def send(pkts):
                self.writes.append(b"".join(
                    C.serialize(p, self.version) for p in pkts))

            super().__init__(b, send=send, close=lambda r: None)
            self.version = version

    try:
        b = broker()
        for s in script["sessions"]:
            ch = Wire(b, s["version"])
            sess, _ = b.cm.open_session(False, s["cid"], ch,
                                        expiry_interval=3600.0)
            opts = SubOpts(qos=s["qos"], no_local=s["no_local"])
            sess.subscribe(s["flt"], opts)
            b.subscribe(s["cid"], s["flt"], opts)
            b.cm.disconnect(s["cid"], ch)
            b.channel_disconnected(s["cid"])
        msgs = [Message(topic=m["topic"], qos=m["qos"],
                        payload=m["payload"], from_client=m["from"],
                        mid=m["mid"], timestamp=m["timestamp"])
                for m in script["msgs"]]
        mk.reset_launches()
        for k in range(0, len(msgs), 256):
            b.publish_many(msgs[k:k + 256])
        publish_launches = mk.launches()
        captured = b.durable.gate.appended
        b.shutdown()

        b = broker()
        b.resume.running = True
        chans, sessions = {}, {}
        for s in script["sessions"]:
            ch = Wire(b, s["version"])
            sess, present = b.open_session(
                False, s["cid"], ch, expiry_interval=3600.0,
                max_inflight=1024)
            ch.session = sess
            ch.send_packets(sess.resume())
            chans[s["cid"]], sessions[s["cid"]] = ch, sess
        mk.reset_launches()
        rounds = 0
        while any(b.resume.pending(c) for c in chans):
            b.resume.drain_once()
            rounds += 1
            if rounds > 100_000:
                raise RuntimeError("durable world: the resume never ended")
            for cid, ch in chans.items():  # the clients acknowledge
                sess = sessions[cid]
                for pkt in C.StreamParser(version=ch.version).feed(
                        b"".join(ch.writes[getattr(ch, "_acked", 0):])):
                    if pkt.type != C.PUBLISH or pkt.packet_id is None:
                        continue
                    if pkt.qos == 1:
                        ch.send_packets(sess.puback(pkt.packet_id)[1])
                    else:
                        ch.send_packets(sess.pubrec(pkt.packet_id)[1])
                        ch.send_packets(sess.pubcomp(pkt.packet_id)[1])
                ch._acked = len(ch.writes)
        replay_launches = mk.launches()
        metrics = {k: b.metrics.val(k) for k in (
            "session.resumed", "session.replay.windows",
            "session.replay.messages", "messages.sent",
            "messages.qos1.sent", "messages.qos2.sent")}
        out = {
            "bytes": {cid: b"".join(ch.writes) for cid, ch in chans.items()},
            "metrics": metrics, "captured": captured, "rounds": rounds,
            "committed": b.resume.committed,
            "publish_launches": publish_launches,
            "replay_launches": replay_launches,
        }
        b.shutdown()
        return out
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
