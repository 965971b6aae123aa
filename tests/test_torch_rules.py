"""The port's rule engine, in its broker, against the JAX package's.

Seeded worlds of random rules (lowerable, arithmetic and interpreter
fallback, over overlapping topic filters) and random windows of JSON
messages run through the JAX package's `Broker` (host paths) and the
port's ``Broker(device="cpu")`` (the rules kernel's plain version).
Both must fire the same actions in the same order with the same
SELECT output, keep the same per-rule counters and ``rules.matched``,
and write the same republished PUBLISH bytes to a subscriber.  The
port's matrix path must also equal its own scalar referee.  Plus:
registry churn, the republish depth cap, the interpreter and function
library over the JAX package's corpus, and the counters the broker
keeps for rule-only messages.
"""

import json
import random

import numpy as np
import pytest

from emqx_tpu.broker.broker import Broker as RefBroker
from emqx_tpu.broker.channel import Channel as RefChannel
from emqx_tpu.codec import mqtt as C
from emqx_tpu.config import BrokerConfig as RefConfig
from emqx_tpu.message import Message as RefMessage
from emqx_tpu.rules import engine as ref_engine
from emqx_tpu.rules import runtime as ref_runtime
from emqx_tpu.rules.predicate import compile_where as ref_compile_where
from emqx_tpu.rules.sql import parse_sql as ref_parse

from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.broker.channel import Channel
from emqx_tpu_torch.codec import mqtt as PC
from emqx_tpu_torch.message import Message
from emqx_tpu_torch.rules import engine as port_engine
from emqx_tpu_torch.rules import runtime as port_runtime
from emqx_tpu_torch.rules.funcs import FUNCS
from emqx_tpu_torch.rules.predicate import compile_where
from emqx_tpu_torch.rules.sql import SqlError, parse_sql

# ------------------------------------------------ random rule worlds
# (the generators of tests/test_rules_columns.py)

_LOW_NOARITH = [
    "payload.a > 2",
    "payload.a >= payload.b",
    "payload.a = 3",
    "payload.s = 'x'",
    "payload.s != 'y'",
    "payload.s IN ('x', 'q')",
    "qos IN (1, 2)",
    "retain != 1",
    "is_null(payload.a)",
    "is_not_null(payload.s) AND payload.s != 'z'",
    "NOT (payload.a > 0) AND payload.b <= 2",
    "payload.missing = payload.gone",
    "payload.s > payload.s2",
    "topic > clientid",
    "payload.a = 1 OR payload.missing > 1",
    "payload.x != 1",
    "clientid = 'c1'",
    "payload.obj = payload.obj2",
]

_LOW_ARITH = [
    "payload.a + 1 >= payload.b * 2",
    "payload.a div 2 = 1",
    "payload.a mod 2 = 0",
    "payload.a / payload.b > 1",
    "payload.a - 0.5 < payload.b",
]

_FALLBACK = [
    "regex_match(payload.s, 'x.*')",
    "lower(clientid) = 'c1'",
    "CASE WHEN qos = 0 THEN true ELSE false END",
    "topic LIKE 't/%'",
]

_FILTERS = ["t/#", "t/+/x", "t/1/x", "t/2/#", "s/only"]
_TOPICS = ["t/1/x", "t/2/x", "t/2/y", "s/only", "q/none"]


def _rand_payload(rng, ints_only=False):
    payload = {}
    if rng.random() < 0.8:
        payload["a"] = (
            rng.randint(-5, 5) if ints_only or rng.random() < 0.7
            else round(rng.uniform(-5, 5), 2)
        )
    if rng.random() < 0.7:
        payload["b"] = rng.randint(0, 3)
    if rng.random() < 0.6:
        payload["s"] = rng.choice(["x", "y", "z", "xq"])
    if rng.random() < 0.5:
        payload["s2"] = rng.choice(["x", "y"])
    if rng.random() < 0.3:
        payload["x"] = rng.choice([1, "y"])
    if rng.random() < 0.3:
        payload["obj"] = rng.choice([{"k": 1}, {"k": 2}, [1, 2]])
    if rng.random() < 0.3:
        payload["obj2"] = rng.choice([{"k": 1}, [1, 2]])
    body = json.dumps(payload).encode()
    if rng.random() < 0.08:
        body = b"not json {"
    return body


def _build_world(seed, preds):
    """Rules and windows of message fields; ``mid`` and ``timestamp``
    are fixed, since ``id`` and ``timestamp`` are env fields."""
    rng = random.Random(seed)
    rules = []
    for i in range(rng.randint(6, 14)):
        flt = rng.choice(_FILTERS)
        pred = rng.choice(preds)
        rules.append((f"r{i}", f'SELECT * FROM "{flt}" WHERE {pred}'))
    windows = []
    ints_only = preds is _LOW_NOARITH
    k = 0
    for _ in range(5):
        win = []
        for _ in range(rng.randint(1, 10)):
            win.append(dict(
                topic=rng.choice(_TOPICS),
                payload=_rand_payload(rng, ints_only=ints_only),
                qos=rng.randint(0, 2),
                retain=bool(rng.getrandbits(1)),
                from_client=rng.choice(["c1", "c2"]),
                mid=k.to_bytes(16, "big"),
                timestamp=1.7e9 + k,
            ))
            k += 1
        windows.append(win)
    return rules, windows


# ------------------------------------------------------------ runners


class Wire:
    """One subscriber's channel, capturing the bytes its connection
    would write."""

    def __init__(self, chan_cls, codec, broker, flt):
        self.writes = []

        def send(pkts):
            self.writes.append(b"".join(
                codec.serialize(p, self.ch.version) for p in pkts))

        self.ch = chan_cls(broker, send=send, close=lambda reason: None)
        for pkt in (
            C.Connect(client_id="watcher", proto_ver=C.MQTT_V5,
                      keepalive=30, clean_start=True),
            C.Subscribe(packet_id=1, subscriptions=[
                C.Subscription(topic_filter=flt, qos=1)]),
        ):
            for p in codec.StreamParser().feed(
                    C.serialize(pkt, C.MQTT_V5)):
                self.ch.handle_in(p)


REPUBLISH = ("rp", 'SELECT payload.a AS a, topic, clientid FROM "t/+/x" '
             "WHERE payload.a > 0")


def _metric(b, name):
    m = b.metrics
    return m.val(name) if hasattr(m, "val") else m[name]


def _run(rules, windows, side, scalar=False):
    """One world through one broker: ``side`` is "ref" (the JAX
    package, host paths) or "port" (device "cpu")."""
    if side == "ref":
        cfg = RefConfig()
        cfg.engine.use_device = False
        b = RefBroker(config=cfg)
        R, msg_cls, chan, codec = ref_engine, RefMessage, RefChannel, C
    else:
        b = Broker(device="cpu")
        R, msg_cls, chan, codec = port_engine, Message, Channel, PC
    if scalar:
        b.rules.eval_force = "scalar"
    watcher = Wire(chan, codec, b, "out/#")
    fired = []
    for rid, sql in rules:
        b.rules.add_rule(rid, sql, actions=[R.FunctionAction(
            lambda sel, msg, rid=rid: fired.append(
                (rid, msg.topic, bytes(msg.payload), sorted(sel.items()))
            ))])
    b.rules.add_rule(REPUBLISH[0], REPUBLISH[1], actions=[R.RepublishAction(
        topic="out/${topic}", payload='{"a": ${a}, "c": "${clientid}"}',
        qos=1)])
    for win in windows:
        b.publish_many([msg_cls(**m) for m in win])
    counters = {
        rid: (r.matched, r.passed, r.failed, r.actions_success,
              r.actions_failed)
        for rid, r in b.rules.rules.items()
    }
    metrics = {k: _metric(b, k) for k in (
        "rules.matched", "actions.success", "actions.failed",
        "messages.dropped.no_subscribers", "messages.delivered")}
    return fired, counters, metrics, watcher.writes, b


def _assert_same(a, b, label):
    assert a[0] == b[0], (label, "action order and SELECT output")
    assert a[1] == b[1], (label, "per-rule counters")
    assert a[2] == b[2], (label, "metrics")
    assert a[3] == b[3], (label, "republished bytes")


@pytest.mark.parametrize("seed,kind", [
    (1, "mixed"), (2, "mixed"), (7, "mixed"), (23, "mixed"),
    (3, "noarith"), (11, "noarith"),
])
def test_worlds_equal_reference(seed, kind):
    preds = (_LOW_NOARITH if kind == "noarith"
             else _LOW_NOARITH + _LOW_ARITH + _FALLBACK)
    rules, windows = _build_world(seed, preds)
    ref = _run(rules, windows, "ref")
    port = _run(rules, windows, "port")
    _assert_same(ref, port, "port vs JAX package")
    assert port[3], "the republish rule delivered nothing"
    scalar = _run(rules, windows, "port", scalar=True)
    _assert_same(scalar, port, "port matrix vs port scalar referee")
    st = port[4].rules.stats()
    assert st["matrix_windows"] > 0 and st["host_windows"] > 0
    assert st["dev_windows"] == 0
    assert scalar[4].rules.stats()["matrix_windows"] == 0
    ref_st = ref[4].rules.stats()
    for k in ("rules", "lowered", "program_rows", "fallback"):
        assert st[k] == ref_st[k], k


def test_republish_depth_cap():
    out = {}
    for side in ("ref", "port"):
        b = (RefBroker() if side == "ref" else Broker(device="cpu"))
        R = ref_engine if side == "ref" else port_engine
        b.rules.add_rule("loop", 'SELECT topic FROM "loop/#"', actions=[
            R.RepublishAction(topic="loop/x", payload="again")])
        b.publish((RefMessage if side == "ref" else Message)(
            topic="loop/x", payload=b"start"))
        r = b.rules.rules["loop"]
        out[side] = (r.matched, r.passed, r.actions_success,
                     r.actions_failed)
    assert out["port"] == out["ref"]
    assert out["port"] == (9, 9, 8, 1)  # the cap hits at depth 8
    assert port_engine.MAX_REPUBLISH_DEPTH == 8


def test_rules_rev_churn_invalidates_caches():
    b = Broker(device="cpu")
    hits = []

    def act(name):
        return [port_engine.FunctionAction(lambda s, m: hits.append(name))]

    b.rules.add_rule("r1", 'SELECT * FROM "t/#" WHERE payload.v > 1',
                     actions=act("r1"))
    rev1 = b.rules.rules_rev
    stack1 = b.rules._stacked()
    assert b.rules._stacked() is stack1  # cached within a rev
    b.publish(Message(topic="t/a", payload=b'{"v": 5}'))
    assert hits == ["r1"]
    b.rules.add_rule("r2", 'SELECT * FROM "t/#" WHERE payload.v > 10',
                     actions=act("r2"))
    assert b.rules.rules_rev > rev1 and b.rules._stacked() is not stack1
    b.publish(Message(topic="t/b", payload=b'{"v": 50}'))
    assert hits == ["r1", "r1", "r2"]
    b.rules.enable_rule("r1", False)
    b.publish(Message(topic="t/c", payload=b'{"v": 50}'))
    assert hits == ["r1", "r1", "r2", "r2"]
    b.rules.remove_rule("r2")
    b.rules.enable_rule("r1", True)
    b.publish(Message(topic="t/d", payload=b'{"v": 50}'))
    assert hits == ["r1", "r1", "r2", "r2", "r1"]
    assert b.rules._flat_key == (b.rules.rules_rev, True)
    assert b.router.engine.match_batch(["t/x"])[0] == {("rule", "r1", 0)}
    b.rules.remove_rule("r1")
    assert b.router.engine.match_batch(["t/x"])[0] == set()


def test_one_regex_rule_degrades_per_rule_not_per_window():
    b = Broker(device="cpu")
    fired = []
    for i in range(20):
        b.rules.add_rule(
            f"low{i}", f'SELECT * FROM "t/#" WHERE payload.v > {i}',
            actions=[port_engine.FunctionAction(
                lambda s, m, i=i: fired.append(f"low{i}"))])
    b.rules.add_rule(
        "rx", "SELECT * FROM \"t/#\" WHERE regex_match(payload.s, 'ab.*')",
        actions=[port_engine.FunctionAction(lambda s, m: fired.append("rx"))])
    b.publish(Message(topic="t/1", payload=b'{"v": 10, "s": "abc"}'))
    st = b.rules.stats()
    assert (st["lowered"], st["fallback"]) == (20, 1)
    assert (st["matrix_windows"], st["scalar_windows"]) == (1, 0)
    assert st["fallback_rule_evals"] == 1
    assert sorted(fired) == sorted([f"low{i}" for i in range(10)] + ["rx"])
    assert b.router.engine.stats()["rules_host_windows"] == 1


def test_standalone_engine_and_matrix_switch_equal_reference():
    sql = 'SELECT payload.v AS v FROM "w/#" WHERE payload.v >= 2'
    payloads = [b'{"v": 1}', b'{"v": 2}', b'{"v": "x"}', b"{}"]
    got = {}
    for side, eng in (("ref", ref_engine.RuleEngine()),
                      ("port", port_engine.RuleEngine(device="cpu"))):
        eng.add_rule("r", sql)
        cls = RefMessage if side == "ref" else Message
        hits = eng.apply_batch(
            [(cls(topic="w/1", payload=p), ["r"]) for p in payloads])
        r = eng.rules["r"]
        got[side] = (hits, r.matched, r.passed, r.failed)
    assert got["port"] == got["ref"] == (1, 4, 1, 3)
    assert eng.stats()["host_windows"] == 1
    eng.eval_force = "scalar"  # the referee gives the same counts
    assert eng.apply_batch([(Message(topic="w/1", payload=p), ["r"])
                            for p in payloads]) == 1
    assert (r.matched, r.passed, r.failed) == (8, 2, 6)
    st = eng.stats()
    assert (st["matrix_windows"], st["scalar_windows"]) == (1, 1)
    assert st["host_windows"] == 1


def test_rule_only_messages_and_subscription_count():
    out = {}
    for side in ("ref", "port"):
        b = RefBroker() if side == "ref" else Broker(device="cpu")
        cls = RefMessage if side == "ref" else Message
        b.rules.add_rule("r", 'SELECT * FROM "only/#"')
        b.publish_many([cls(topic="only/x", payload=b"{}"),
                        cls(topic="none", payload=b"{}")])
        out[side] = (_metric(b, "messages.dropped.no_subscribers"),
                     _metric(b, "rules.matched"),
                     b.router.subscription_count())
    assert out["port"] == out["ref"] == (2, 1, 0)


# -------------------------------------------- interpreter and library

_ENV_PAYLOADS = [
    {"temp": 31.5, "ok": True, "tags": {"site": "x"}, "s": "Hello World",
     "xs": [1, 2, 3], "a": 3, "b": 2},
    {"a": -1.25, "b": 0, "s": "x", "xs": []},
    {},
]

_WHERE = [
    "payload.temp > 30", "payload.ok", "payload.tags.site = 'x'",
    "payload.missing > 1", "payload.a = 1 OR payload.missing > 1",
    "payload.missing > 1 OR payload.a = 1", "payload.a + 1 >= payload.b * 2",
    "qos = 1 AND retain = 1 OR payload.b = 0", "qos IN (1, 2)",
    "payload.a / payload.b > 1", "payload.a div 2 = 1",
    "payload.a mod 2 = 0", "topic LIKE 'dev/%/temp'",
    "topic LIKE 'dev/_/xx'", "NOT (payload.a > 0)",
    "CASE WHEN qos = 0 THEN true ELSE false END",
    "payload.s = payload.s", "payload.xs = payload.xs",
]

_SELECT = [
    "lower(payload.s)", "strlen(payload.s)", "substr(payload.s, 6)",
    "nth(2, payload.xs)", "concat('a', 'b', 1)", "topic(1, 'x')",
    "abs(0 - 5)", "round(3.7)", "max(1, 2, 3)", "json_encode(payload.xs)",
    "is_str(payload.s)", "contains(3, payload.xs)", "split('a,b,c', ',')",
    "md5('abc')", "sha256(topic)", "upper(username)", "payload.a * 2",
    "payload.tags", "str(payload.temp)", "int('42')", "float(payload.a)",
    "bool('true')", "base64_encode(clientid)", "bin2hexstr(topic)",
    "map_get('site', payload.tags)", "sprintf('~p-~s', qos, topic)",
    "pad(clientid, 5, 'leading', '0')", "payload.a - payload.b",
    "CASE WHEN payload.a > 0 THEN 'pos' ELSE 'neg' END", "id", "timestamp",
    "node", "flags", "pub_props",
]


def _env_pair(payload):
    kw = dict(topic="dev/d1/temp", payload=json.dumps(payload).encode(),
              qos=1, retain=False, from_client="c1", from_username="u1",
              mid=bytes(range(16)), timestamp=1752000000.125)
    return (ref_runtime.build_env(RefMessage(**kw)),
            port_runtime.build_env(Message(**kw)))


def test_interpreter_and_functions_equal_reference():
    for payload in _ENV_PAYLOADS:
        renv, penv = _env_pair(payload)
        for src in _WHERE:
            w = f'SELECT * FROM "t" WHERE {src}'
            assert port_runtime.eval_where(parse_sql(w).where, penv) == (
                ref_runtime.eval_where(ref_parse(w).where, renv)), src
        q = "SELECT " + ", ".join(
            f"{s} AS f{k}" for k, s in enumerate(_SELECT)) + ', * FROM "t"'
        assert port_runtime.eval_select(parse_sql(q), penv) == (
            ref_runtime.eval_select(ref_parse(q), renv))
        lazy = port_runtime.LazyEnv(Message(topic="dev/d1/temp",
                                            payload=b'{"v": 1}'))
        assert port_runtime.eval_where(
            parse_sql('SELECT * FROM "t" WHERE payload.v = 1').where, lazy)
        assert set(lazy) == {"payload"}


def test_parser_and_templates_equal_reference():
    for sql in ('SELECT payload.x AS x, clientid FROM "t/#" WHERE x > 10',
                "SELECT CASE WHEN qos = 0 THEN 'low' ELSE 'hi' END AS lvl "
                'FROM "t", "u/+" WHERE qos + 1 * 2 IN (1, 3) AND NOT retain'):
        a, b = parse_sql(sql), ref_parse(sql)
        assert (a.froms, a.where) == (b.froms, b.where)
        assert [(f.expr, f.alias, f.star) for f in a.fields] == [
            (f.expr, f.alias, f.star) for f in b.fields]
    for bad in ("SELECT", 'SELECT * FROM "t" WHERE a in 1'):
        with pytest.raises(SqlError):
            parse_sql(bad)
    data = {"a": {"b": 2}, "s": "x", "f": 3.0, "flag": True, "l": [1]}
    t = "${a.b}/${s}/${f}/${flag}/${nope}/${l}/%s"
    assert port_engine.render_template(t, data) == (
        ref_engine.render_template(t, data)) == "2/x/3/true/undefined/[1]/%s"


def test_predicate_program_device_path_equals_reference():
    rng = random.Random(4)
    msgs = [dict(topic="t/1", payload=_rand_payload(rng), qos=q,
                 retain=bool(q % 2), from_client="c1",
                 mid=bytes(16), timestamp=1.0) for q in (0, 1, 2, 1, 0)]
    renvs = [ref_runtime.build_env(RefMessage(**m)) for m in msgs]
    penvs = [port_runtime.build_env(Message(**m)) for m in msgs]
    for src in _LOW_NOARITH + _LOW_ARITH:
        w = f'SELECT * FROM "t" WHERE {src}'
        prog, ref = compile_where(parse_sql(w).where), ref_compile_where(
            ref_parse(w).where)
        if ref is None:
            assert prog is None
            continue
        want = ref.eval_batch(renvs)
        # K6 (its plain version on the CPU) against the reference's
        # numpy and jit paths
        got = prog.eval_batch(penvs, device="cpu")
        assert np.array_equal(got, want)
        assert np.array_equal(got, ref.eval_batch(renvs, use_jax=True))
    # the schema functions resolve names in the schema registry: an
    # unknown name raises as in the JAX package
    with pytest.raises(ValueError, match="unknown schema 's'"):
        FUNCS["schema_decode"]("s", b"{}")
