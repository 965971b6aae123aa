"""The port's schema registry against the JAX package's: the Avro codec
(round trips, known bytes, truncation, schema errors), protobuf schemas
(the JAX package compiles them with ``protoc``; the port with its own
proto3 parser, run here with ``protoc`` off ``PATH`` and
``google.protobuf`` and ``jsonschema`` unimportable), JSON schemas
(the port's own validator, its verdicts held to ``jsonschema``'s), the
registry's persistence, and ``schema_decode``/``schema_encode``/
``schema_check`` through rules on both brokers, in both SELECT lanes.

One deliberate difference is pinned here: the port's schema functions
read the env's ``payload`` as the message's bytes, so a binary (non
UTF-8) payload decodes; the JAX package passes the payload's UTF-8 text
(decoded with replacement), on which such a record fails or decodes
to wrong values.
"""

import contextlib
import json
import os
import sys

import jsonschema
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from emqx_tpu import schema_registry as ref_sr
from emqx_tpu.broker.broker import Broker as RefBroker
from emqx_tpu.config import BrokerConfig as RefConfig
from emqx_tpu.message import Message as RefMessage
from emqx_tpu.rules import engine as ref_engine
from emqx_tpu.rules.funcs import FUNCS as REF_FUNCS

from emqx_tpu_torch import schema_registry as port_sr
from emqx_tpu_torch import workload as W
from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.message import Message
from emqx_tpu_torch.rules import engine as port_engine
from emqx_tpu_torch.rules.funcs import FUNCS

SR = {"ref": ref_sr, "port": port_sr}


@contextlib.contextmanager
def port_alone(tmp_path):
    """What the port runs in here: no ``protoc`` on ``PATH``, and
    ``google.protobuf`` and ``jsonschema`` unimportable."""
    saved = os.environ.get("PATH", "")
    os.environ["PATH"] = str(tmp_path)
    blocked = {n: sys.modules.get(n) for n in (
        "jsonschema", "google.protobuf", "google.protobuf.json_format",
        "google.protobuf.descriptor_pool")}
    for n in blocked:
        sys.modules[n] = None
    try:
        yield
    finally:
        os.environ["PATH"] = saved
        for n, mod in blocked.items():
            if mod is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = mod


def on_side(side, tmp_path):
    return port_alone(tmp_path) if side == "port" else \
        contextlib.nullcontext()

AVRO_SCHEMA = {
    "type": "record", "name": "Telemetry", "fields": [
        {"name": "device", "type": "string"},
        {"name": "temp", "type": "double"},
        {"name": "t32", "type": "float"},
        {"name": "seq", "type": "long"},
        {"name": "ok", "type": "boolean"},
        {"name": "raw", "type": "bytes"},
        {"name": "mac", "type": {"type": "fixed", "name": "Mac", "size": 2}},
        {"name": "tags", "type": {"type": "array", "items": "string"}},
        {"name": "attrs", "type": {"type": "map", "values": "long"}},
        {"name": "note", "type": ["null", "string"]},
        {"name": "mode", "type": {"type": "enum", "name": "Mode",
                                  "symbols": ["AUTO", "MANUAL"]}},
        {"name": "prev", "type": ["null", "Mode"]},
        {"name": "opt", "type": "long", "default": 7},
    ],
}

PROTO_SRC = """
syntax = "proto3";
message SensorReading {
  string device = 1;
  double temp = 2;
  int64 seq = 3;
  repeated string tags = 4;
}
"""

PROTO_TWO = PROTO_SRC + """
message Other { int32 x = 1; }
"""

JSON_SCHEMA = {"type": "object", "required": ["mode"],
               "properties": {"mode": {"type": "string"}}}


def _value(**kw):
    v = {"device": "v-17", "temp": 21.5, "t32": 0.5, "seq": 12345678901,
         "ok": True, "raw": b"\x00\xff", "mac": b"\x01\x02",
         "tags": ["a", "b"], "attrs": {"x": 1, "y": -2}, "note": None,
         "mode": "MANUAL", "prev": "AUTO", "opt": 3}
    v.update(kw)
    return v


@pytest.mark.parametrize("value", [
    _value(), _value(note="hello", prev=None, tags=[], attrs={}),
    _value(seq=-1, attrs={"z": -(2 ** 40)}, ok=False, temp=-0.0),
    _value(seq=2 ** 62, t32=-3.25, raw=b"", device="ü" * 70),
])
def test_avro_round_trip_equals_reference(value):
    port = port_sr.AvroSchema(AVRO_SCHEMA)
    ref = ref_sr.AvroSchema(AVRO_SCHEMA)
    data = port.encode(value)
    assert data == ref.encode(value)
    assert port.decode(data) == ref.decode(data) == value
    # a missing field with a default takes it
    short = {k: v for k, v in value.items() if k != "opt"}
    assert port.encode(short) == ref.encode(short)
    assert port.decode(port.encode(short))["opt"] == 7


def test_avro_known_bytes_and_errors_equal_reference():
    rec = {"type": "record", "name": "R", "fields": [
        {"name": "a", "type": "long"}, {"name": "b", "type": "string"}]}
    for side in ("ref", "port"):
        s = SR[side].AvroSchema(rec)
        # long 1 -> 0x02; long -1 -> 0x01; "foo" -> 0x06 'f' 'o' 'o'
        assert s.encode({"a": 1, "b": "foo"}) == b"\x02\x06foo"
        assert s.encode({"a": -1, "b": ""}) == b"\x01\x00"
        assert s.decode(b"\x02\x06foo") == {"a": 1, "b": "foo"}
        full = SR[side].AvroSchema(AVRO_SCHEMA)
        for bad in (b"\x02", b"\x02\x06fo", b"\xff" * 11):
            with pytest.raises(ValueError):
                full.decode(bad)
        with pytest.raises(ValueError, match="missing field"):
            s.encode({"a": 1})
        with pytest.raises(ValueError, match="fits no union"):
            SR[side].AvroSchema(["null", "long"]).encode("x")
        for schema in ({"type": "record", "name": "X"},
                       {"type": "enum", "name": "E"},
                       {"type": "fixed", "name": "F"},
                       {"type": "array"}, {"type": "map"},
                       {"type": "decimal"},
                       {"type": "record", "name": "Y", "fields": [{"x": 1}]}):
            with pytest.raises(ValueError):
                SR[side].AvroSchema(schema)


def test_protobuf_compile_and_round_trip_equal_reference(tmp_path):
    ref = ref_sr.ProtobufSchema(PROTO_SRC)
    value = {"device": "d1", "temp": 3.5, "seq": "42", "tags": ["x", "y"]}
    with port_alone(tmp_path):
        port = port_sr.ProtobufSchema(PROTO_SRC)
        data = port.encode(value, "SensorReading")
        decoded = port.decode(data, "SensorReading")
    assert port.message_types() == ref.message_types() == ["SensorReading"]
    assert data == ref.encode(value, "SensorReading")
    assert data.startswith(b"\x0a\x02d1")  # field 1, "d1"
    assert decoded == ref.decode(data, "SensorReading")
    for side in ("ref", "port"):
        with on_side(side, tmp_path):
            # the JAX package's message names protoc, the port's its
            # own parser
            with pytest.raises(ValueError, match="rejected the schema"):
                SR[side].ProtobufSchema("syntax = nonsense;")
            with pytest.raises(ValueError, match="unknown message type"):
                SR[side].ProtobufSchema(PROTO_SRC).decode(data, "Nope")


def test_registry_persistence_and_dispatch_equal_reference(tmp_path):
    out = {}
    for side in ("ref", "port"):
        with on_side(side, tmp_path):
            out[side] = _registry_round(side, tmp_path)
    assert out["port"] == out["ref"]
    res, saved, dumped, info, _, none = out["port"]
    assert res[3:6] == [True, False, False] and res[6] == {"x": 5}
    assert sorted(saved) == ["cfg", "tele", "two"] and dumped == saved
    assert none == {}


def _registry_round(side, tmp_path):
    path = str(tmp_path / f"{side}.json")
    reg = SR[side].SchemaRegistry(persist_path=path)
    reg.add("tele", "avro", json.dumps(AVRO_SCHEMA))
    reg.add("sensor", "protobuf", PROTO_SRC)
    reg.add("two", "protobuf", PROTO_TWO)
    reg.add("cfg", "json", JSON_SCHEMA)
    with pytest.raises(ValueError, match="unknown schema type"):
        reg.add("x", "thrift", "{}")
    enc = reg.encode("sensor", {"device": "d9", "seq": "3"})
    res = [reg.decode("sensor", enc), reg.encode("cfg", {"mode": "on"}),
           reg.decode("cfg", b'{"mode": "on"}'),
           reg.check("cfg", b'{"mode": "on"}'),
           reg.check("cfg", b'{"other": 1}'),
           reg.check("tele", b"garbage"),
           reg.decode("two", reg.encode("two", {"x": 5}, "Other"),
                      "Other")]
    with pytest.raises(ValueError, match="2 message types"):
        reg.decode("two", enc)
    with pytest.raises(ValueError, match="unknown schema"):
        reg.decode("nope", b"")
    assert reg.remove("sensor") and not reg.remove("sensor")
    saved = json.load(open(path))
    again = SR[side].SchemaRegistry()
    again.load(path)
    missing = SR[side].SchemaRegistry()
    missing.load(str(tmp_path / "none.json"))  # absent: nothing
    return (res, saved, again.dump(), again.info(), reg.info(),
            missing.dump())


# ------------------------------------------------- through rules

class FakeWorker:
    def __init__(self):
        self.queries = []

    def enqueue(self, q):
        self.queries.append(q)
        return True

    def enqueue_batch(self, qs):
        self.queries.extend(qs)
        return 0


_TEXT_AVRO = {"type": "record", "name": "T", "fields": [
    {"name": "id", "type": "string"}, {"name": "n", "type": "long"},
    {"name": "on", "type": "boolean"}]}

_RULES = [
    ("dec", "SELECT schema_decode('tav', payload) AS d, topic "
            'FROM "avro/#"'),
    ("chk", "SELECT payload.mode AS m FROM \"cfg/#\" "
            "WHERE schema_check('cfg', payload)"),
    ("enc", "SELECT schema_encode('cfg', payload.inner) AS e "
            'FROM "cfg/#" WHERE is_not_null(payload.inner)'),
    ("bad", "SELECT schema_decode('nope', payload) AS d FROM \"cfg/#\""),
    ("all", 'SELECT * FROM "#"'),
]


def _messages():
    avro = port_sr.AvroSchema(_TEXT_AVRO)
    out = []
    for k in range(12):
        if k % 3 == 0:
            # small longs and short strings: every byte < 0x80, so the
            # record survives a UTF-8 text round trip in both packages
            body = avro.encode({"id": f"d{k}", "n": k, "on": k % 2 == 0})
            topic = f"avro/{k}"
        elif k % 3 == 1:
            body = json.dumps({"mode": f"m{k}",
                               "inner": {"mode": "x"}}).encode()
            topic = "cfg/a"
        else:
            body = b'{"other": 1}'
            topic = "cfg/b"
        out.append(dict(topic=topic, payload=body, qos=1, from_client="c",
                        mid=k.to_bytes(16, "big"), timestamp=1.7e9 + k))
    return out


def _rule_run(side, force):
    if side == "ref":
        cfg = RefConfig()
        cfg.engine.use_device = False
        b, R, M = RefBroker(config=cfg), ref_engine, RefMessage
    else:
        b, R, M = Broker(device="cpu"), port_engine, Message
    reg = SR[side].global_registry()
    reg.add("tav", "avro", _TEXT_AVRO)
    reg.add("cfg", "json", JSON_SCHEMA)
    try:
        b.rules.select_force = force
        sink = FakeWorker()
        b.resources._workers["s"] = sink
        for rid, sql in _RULES:
            b.rules.add_rule(rid, sql, actions=[R.SinkAction("s")])
        msgs = _messages()
        b.publish_many([M(**m) for m in msgs[:7]])
        b.publish_many([M(**m) for m in msgs[7:]])
        counters = {rid: (r.matched, r.passed, r.actions_success,
                          r.actions_failed)
                    for rid, r in b.rules.rules.items()}
        return sink.queries, counters
    finally:
        reg.remove("tav")
        reg.remove("cfg")


@pytest.mark.parametrize("force", ["batched", "scalar"])
def test_schema_functions_through_rules_equal_reference(force):
    port, ref = _rule_run("port", force), _rule_run("ref", force)
    assert port == ref
    queries, counters = port
    decoded = [json.loads(q)["d"] for q in queries
               if q.startswith('{"d": {')]
    assert decoded == [{"id": f"d{k}", "n": k, "on": k % 2 == 0}
                       for k in (0, 3, 6, 9)]
    assert counters["chk"][:2] == (8, 4)  # schema_check in WHERE
    # schema_encode's bytes go out through json.dumps(default=str)
    assert queries.count(json.dumps({"e": str(b'{"mode":"x"}')})) == 4
    assert sum(q == '{"d": null}' for q in queries) == 8  # unknown schema


def test_binary_payload_decodes_in_the_port_only():
    """The deliberate difference: a `workload.FLEET_AVRO` record (its
    double is not UTF-8 text) decodes through the port's schema_decode
    from the message's bytes; the JAX package's function gets the
    payload's text, whose replacement characters shift the fields after
    the double: this record decodes there to a wrong odometer."""
    rec = {"vin": "VIN00001", "speed": 88.25, "odometer": 1234,
           "gear": "D", "fault": None}
    body = port_sr.AvroSchema(W.FLEET_AVRO).encode(rec)
    with pytest.raises(UnicodeDecodeError):
        body.decode("utf-8")
    out = {}
    for side, B, M in (("ref", RefBroker, RefMessage),
                       ("port", Broker, Message)):
        reg = SR[side].global_registry()
        reg.add(W.FLEET_AVRO_NAME, "avro", W.FLEET_AVRO)
        try:
            if side == "ref":
                cfg = RefConfig()
                cfg.engine.use_device = False
                b = B(config=cfg)
                R = ref_engine
            else:
                b, R = B(device="cpu"), port_engine
            got = []
            b.rules.add_rule("avro", W.AVRO_SQL, actions=[R.FunctionAction(
                lambda sel, msg: got.append(sel["d"]))])
            b.publish(M(topic="avro/VIN00001/state", payload=body))
            out[side] = got
            direct = (FUNCS if side == "port" else REF_FUNCS)[
                "schema_check"](W.FLEET_AVRO_NAME, body)
            assert direct  # handed bytes, both decode
        finally:
            reg.remove(W.FLEET_AVRO_NAME)
    assert out["port"] == [rec]
    assert out["ref"][0]["speed"] == rec["speed"]
    assert out["ref"][0]["odometer"] != rec["odometer"]


# ----------------------------------------- JSON Schema against jsonschema

from emqx_tpu_torch import json_schema  # noqa: E402

KEYWORD_SCHEMAS = {
    "type": {"type": "integer"},
    "type_list": {"type": ["string", "null", "boolean"]},
    "type_number": {"type": "number"},
    "enum": {"enum": [1, "a", None, True, [1, 2], {"k": 1}, 2.5]},
    "const": {"const": [False, 1]},
    "min_max": {"minimum": 0, "maximum": 10},
    "exclusive": {"exclusiveMinimum": 0, "exclusiveMaximum": 1.5},
    "multiple_int": {"multipleOf": 3},
    "multiple_float": {"multipleOf": 0.75},
    "length": {"minLength": 2, "maxLength": 3},
    "pattern": {"pattern": "^a.*b$"},
    "items_count": {"minItems": 1, "maxItems": 3},
    "unique": {"uniqueItems": True},
    "prefix_closed": {"prefixItems": [{"type": "integer"},
                                      {"type": "string"}], "items": False},
    "prefix_items": {"prefixItems": [{"type": "integer"}],
                     "items": {"type": "string"}},
    "contains": {"contains": {"type": "integer"}, "minContains": 2,
                 "maxContains": 3},
    "contains_zero": {"contains": {"type": "string"}, "minContains": 0,
                      "maxContains": 1},
    "properties_count": {"minProperties": 1, "maxProperties": 2},
    "required": {"required": ["a", "b"]},
    "dependent_required": {"dependentRequired": {"a": ["b"]}},
    "dependent_schemas": {"dependentSchemas": {"a": {"required": ["c"]}}},
    "closed_object": {"properties": {"a": {"type": "integer"}},
                      "patternProperties": {"^b": {"type": "string"}},
                      "additionalProperties": False},
    "additional_schema": {"properties": {"a": True},
                          "additionalProperties": {"type": "boolean"}},
    "property_names": {"propertyNames": {"maxLength": 1}},
    "all_of": {"allOf": [{"type": "integer"}, {"minimum": 2}]},
    "any_of": {"anyOf": [{"type": "string"}, {"maximum": 0}]},
    "one_of": {"oneOf": [{"type": "integer"}, {"minimum": 2}]},
    "not": {"not": {"type": "array"}},
    "if_then_else": {"if": {"type": "integer"}, "then": {"minimum": 5},
                     "else": {"type": "string"}},
    "ref": {"$defs": {"pos": {"type": "integer", "minimum": 1}},
            "type": "array", "items": {"$ref": "#/$defs/pos"}},
    "ref_recursive": {"$defs": {"node": {
        "type": "object", "required": ["a"],
        "properties": {"b": {"type": "array",
                             "items": {"$ref": "#/$defs/node"}}}}},
        "$ref": "#/$defs/node"},
    "format_annotation": {"type": "string", "format": "email"},
    "boolean_schema": {"properties": {"a": False, "b": True}},
}

_KEYS = st.sampled_from(["a", "b", "c", "ab", "bz", "b1"])
_SCALARS = (st.none() | st.booleans() | st.integers(-4, 12)
            | st.floats(-4, 12, allow_nan=False).map(lambda f: round(f, 1))
            | st.sampled_from([1.0, 2.0, 1.5, 0.5, 10 ** 20, 3.0])
            | st.text(alphabet="abz1", max_size=4))
JSON_VALUES = st.recursive(
    _SCALARS, lambda kids: st.lists(kids, max_size=5)
    | st.dictionaries(_KEYS, kids, max_size=4), max_leaves=12)


# instances on both sides of every schema above, beside the generated
EDGE_VALUES = [
    None, True, False, 0, 1, 1.0, -1, 0.5, 1.5, 2, 3, 4.5, 6, 11, 10 ** 20,
    "", "a", "ab", "azb", "xb", [], [1], [1, 2], [1, 1.0], [1, True],
    [1, "a"], [1, "a", "b"], [1, 2, 3, 4], ["a"], ["a", "b"], [False, 1],
    [False, 1.0], [0, True], {}, {"a": 1}, {"a": 1, "b": 2},
    {"a": 1, "b": "x", "c": 3}, {"a": 1, "c": 3}, {"b1": "s"}, {"bz": 1},
    {"a": 1, "b": [{"a": 2}]}, {"a": 1, "b": [{}]}, {"a": True, "c": False},
]


@pytest.mark.parametrize("keyword", sorted(KEYWORD_SCHEMAS))
def test_json_schema_verdicts_equal_jsonschema(keyword):
    schema = KEYWORD_SCHEMAS[keyword]
    ref = jsonschema.Draft202012Validator(schema)
    port = json_schema.Validator(schema)
    seen = set()

    @settings(max_examples=60, deadline=None, derandomize=True,
              suppress_health_check=list(HealthCheck))
    @given(JSON_VALUES)
    def check(x):
        want = ref.is_valid(x)
        assert port.is_valid(x) == want, (schema, x)
        seen.add(want)
        if not want:
            with pytest.raises(json_schema.ValidationError):
                port.validate(x)

    check()
    for x in EDGE_VALUES:
        want = ref.is_valid(x)
        assert port.is_valid(x) == want, (schema, x)
        seen.add(want)
    assert seen == {True, False}, f"{keyword}: one verdict only"


@pytest.mark.parametrize("schema,word", [
    ({"$dynamicRef": "#meta"}, "$dynamicRef"),
    ({"properties": {"a": {"unevaluatedProperties": False}}},
     "unevaluatedProperties"),
    ({"unevaluatedItems": False}, "unevaluatedItems"),
    ({"$ref": "https://example.com/other.json"}, "$ref"),
    ({"$ref": "other.json#/$defs/missing"}, "$ref"),
])
def test_json_schema_refuses_what_it_does_not_implement(schema, word):
    """The deliberate difference: a keyword the port's validator does not
    implement raises at ``add``, naming it, where ``jsonschema`` would
    validate (or resolve a remote reference)."""
    with pytest.raises(ValueError, match=word.replace("$", r"\$")):
        port_sr.SchemaRegistry().add("x", "json", schema)


@pytest.mark.parametrize("side", ["ref", "port"])
def test_dangling_local_ref_fails_only_the_instances_reaching_it(side,
                                                                 tmp_path):
    """A local ``$ref`` resolves when an instance reaches it: a schema
    whose ``$ref`` points nowhere registers, and only the instances that
    reach the ``$ref`` fail (jsonschema raises PointerToNowhere there).
    The port's validator resolved every ``$ref`` at ``add`` and refused
    the schema."""
    with on_side(side, tmp_path):
        reg = SR[side].SchemaRegistry()
        reg.add("j", "json", {"properties": {"a": {"$ref": "#/$defs/none"}}})
        got = [reg.check("j", b) for b in (b"1", b'{"b": 1}', b'{"a": 1}')]
    assert got == [True, True, False]
    schema = {"properties": {"a": {"$ref": "#/$defs/none"}}}
    validator = jsonschema.Draft202012Validator(schema)
    for raw, want in ((1, True), ({"b": 1}, True)):
        assert validator.is_valid(raw) is want
    from referencing.exceptions import Unresolvable

    with pytest.raises(Unresolvable):
        validator.is_valid({"a": 1})
