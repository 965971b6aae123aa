"""The port's proto3 parser and codec (`emqx_tpu_torch.protobuf`) held to
``protoc`` and ``google.protobuf``: descriptors equal to protoc's,
deterministic bytes equal on generated messages of every
``exhook.proto`` type and of the registry's schemas, each side decoding
the other's bytes, the JSON mapping equal to ``json_format``, and
truncated or malformed input refused alike."""

import math
import os
import subprocess

import pytest
from google.protobuf import descriptor_pb2, json_format
from google.protobuf import message as gmessage
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from emqx_tpu import schema_registry as ref_sr
from emqx_tpu.exhook import pb as ref_pb
from emqx_tpu_torch import protobuf as P
from emqx_tpu_torch.exhook import PROTO_PATH, pb as port_pb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every scalar type, nested messages and enums, maps with integer, bool
# and string keys, a oneof, proto3 optional, an unpacked repeated
RICH_SRC = """
syntax = "proto3";
package fleet.v1;
// a vehicle's report
message Report {
  double d = 1; float f = 2; int64 i64 = 3; uint64 u64 = 4;
  int32 i32 = 5; fixed64 x64 = 6; fixed32 x32 = 7; bool b = 8;
  string s = 9; bytes raw = 12; uint32 u32 = 13; sfixed32 sx32 = 15;
  sfixed64 sx64 = 16; sint32 z32 = 17; sint64 z64 = 18;
  enum Mode { AUTO = 0; MANUAL = 1; SERVICE = 5; }
  Mode mode = 19;
  message Cell { int32 v = 1; repeated string tags = 2; }
  Cell cell = 20;
  repeated Cell cells = 21;
  repeated sint64 deltas = 22;
  repeated double temps = 23 [packed = false];
  map<string, int64> counters = 24;
  map<int32, Cell> by_id = 25;
  map<bool, string> flags = 26;
  oneof pos { string geohash = 27; Cell grid = 28; uint32 zone = 29; }
  optional int32 opt = 30;
  repeated Mode modes = 31;
  map<uint64, bytes> blobs = 32;
  /* a block
     comment */
  reserved 40 to 45;
  option deprecated = false;
}
enum Top { TOP_ZERO = 0; TOP_ONE = 1; }
message Wrapper { Report report = 1; Top top = 2; }
"""

REGISTRY_SRC = """
syntax = "proto3";
message SensorReading {
  string device = 1;
  double temp = 2;
  int64 seq = 3;
  repeated string tags = 4;
}
"""


def protoc_descriptor(src: str, name: str, tmp_path) -> dict:
    path = tmp_path / name
    path.write_text(src)
    out = tmp_path / (name + ".desc")
    subprocess.run(["protoc", f"--proto_path={tmp_path}",
                    f"--descriptor_set_out={out}", str(path)], check=True)
    fds = descriptor_pb2.FileDescriptorSet.FromString(out.read_bytes())
    return json_format.MessageToDict(fds.file[0],
                                     preserving_proto_field_name=True)


def strip_options(d):
    """protoc's dict without what the parser skips (options other than
    map_entry, reserved ranges and names)."""
    if isinstance(d, list):
        return [strip_options(x) for x in d]
    if not isinstance(d, dict):
        return d
    out = {}
    for k, v in d.items():
        if k in ("reserved_range", "reserved_name"):
            continue
        if k == "options":
            if v.get("map_entry"):
                out[k] = {"map_entry": True}
            continue
        out[k] = strip_options(v)
    return out


@pytest.mark.parametrize("which", ["exhook", "rich", "registry"])
def test_descriptors_equal_protoc(which, tmp_path):
    src = {"exhook": open(PROTO_PATH).read(), "rich": RICH_SRC,
           "registry": REGISTRY_SRC}[which]
    name = "exhook.proto" if which == "exhook" else f"{which}.proto"
    assert P.parse(src, name).to_dict() == strip_options(
        protoc_descriptor(src, name, tmp_path))


def test_port_proto_equals_repo_proto_byte_for_byte():
    """From its ``syntax`` line on, the package's own copy is
    ``proto/exhook.proto`` byte for byte; only the header comment
    differs (the repo file's points at a path outside the repository)."""
    with open(PROTO_PATH, "rb") as a, \
            open(os.path.join(REPO, "proto", "exhook.proto"), "rb") as b:
        mine, theirs = a.read(), b.read()
    start = b'syntax = "proto3";'
    assert mine[mine.index(start):] == theirs[theirs.index(start):]
    assert all(line.startswith(b"//") or not line.strip()
               for line in mine[:mine.index(start)].splitlines())
    assert P.parse(mine.decode()).to_dict() == P.parse(
        theirs.decode()).to_dict()


@pytest.mark.parametrize("src", [
    'syntax = "proto2"; message A { optional int32 x = 1; }',
    'message A { int32 x = 1; }',
    'syntax = "proto3"; import "other.proto";',
    'syntax = "proto3"; message A { required int32 x = 1; }',
    'syntax = "proto3"; message A { extensions 100 to 200; }',
    'syntax = "proto3"; extend A { int32 y = 2; }',
    'syntax = "proto3"; message A { B x = 1; }',
    'syntax = "proto3"; message A { int32 x = 1; int32 y = 1; }',
    'syntax = "proto3"; message A { int32 x = 0; }',
    'syntax = "proto3"; enum E { ONE = 1; }',
    'syntax = "proto3"; message A { map<float, int32> m = 1; }',
    'syntax = "proto3"; service S { rpc F(A) returns (A) { foo; } }'
    ' message A {}',
    'syntax = "proto3"; message A { int32 x = 1 }',
])
def test_parser_refuses_what_protoc_refuses_or_it_does_not_take(src,
                                                                 tmp_path):
    with pytest.raises(ValueError):
        P.parse(src)


# a type written through its package: every component of ``package a.b``
# resolves a name's first component, for fields and for rpc types
PKG_SRC = """syntax = "proto3"; package a.b;
message Inner { string s = 1; }
message User { a.b.Inner t = 1; b.Inner p = 2; }
service S { rpc Go (a.b.Inner) returns (Inner); rpc Back (b.User) returns (a.b.User); }
"""


def test_package_qualified_names_resolve_as_protoc(tmp_path):
    assert P.parse(PKG_SRC, "pkg.proto").to_dict() == strip_options(
        protoc_descriptor(PKG_SRC, "pkg.proto", tmp_path))
    src = ('syntax = "proto3"; package a.b; message Inner { string s = 1; }'
           ' message User { a.b.Inner t = 1; b.Inner p = 2; }')
    value = {"t": {"s": "x"}, "p": {"s": "y"}}
    port = port_sr_mod().SchemaRegistry()
    port.add("p", "protobuf", src)
    assert port.encode("p", value, "User").hex() == "0a030a017812030a0179"
    ref = ref_sr.SchemaRegistry()
    ref.add("p", "protobuf", src)
    assert ref.encode("p", value, "User") == port.encode("p", value, "User")
    assert port.info() == ref.info()


def port_sr_mod():
    from emqx_tpu_torch import schema_registry

    return schema_registry


# protoc's verdict on each: True when it compiles the schema
VERDICT_SRCS = [
    "enum E { A = 0; B = 1; C = 1; }",
    "enum E { option allow_alias = true; A = 0; B = 1; C = 1; }",
    "enum E { option allow_alias = true; A = 0; B = 1; }",
    "enum E { option allow_alias = false; A = 0; B = 1; }",
    "enum E { X = 0; } enum F { X = 0; }",
    "message M { enum E { X = 0; } enum F { X = 0; } }",
    "message M { enum E { X = 0; } } enum F { X = 0; }",
    "message X {} enum E { X = 0; }",
    "message M { enum E { x = 0; } int32 x = 1; }",
    "message M { message a {} int32 a = 1; }",
    "message M { int32 foo_bar = 1; int32 fooBar = 2; }",
    "message M { int32 foobar = 1; int32 fooBar = 2; }",
    "message M { int32 a_ = 1; int32 a = 2; }",
    "message M { oneof o { int32 foo_bar = 1; } int32 fooBar = 2; }",
    "message M { map<string, int32> foo_bar = 1; int32 fooBar = 2; }",
    'message M { int32 foo_bar = 1 [json_name = "q"]; int32 fooBar = 2; }',
    'message M { int32 a = 1 [json_name = "x"]; int32 b = 2 '
    '[json_name = "x"]; }',
    'message M { string s = 1 [default = "x"]; }',
    "message M { int32 s = 1 [default = 3]; }",
    "message M { reserved 2, 5 to 7; int32 a = 6; }",
    "message M { reserved 2, 5 to 7; int32 a = 8; }",
    "message M { reserved 10 to max; int32 a = 100; }",
    'message M { reserved "a"; int32 a = 1; }',
    'message M { reserved "a" "b"; int32 ab = 1; }',
    "message M { reserved 1 to 5, 3; }",
    "message M { reserved 1 to 3; reserved 2; }",
    "enum E { A = 0; reserved 1; B = 1; }",
    'enum E { A = 0; reserved "B"; B = 1; }',
    "enum E { A = 0; reserved -5 to -1; B = -3; }",
    'enum E { A = 0; reserved 2 to 3; reserved "Q"; }',
    'message M { int32 a = 1 [json_name = "x" "y"]; }',
]


@pytest.mark.parametrize("body", VERDICT_SRCS + [None])
def test_parser_verdicts_equal_protoc(body, tmp_path):
    """Each schema compiles under the port's parser exactly when protoc
    compiles it: enum aliases, C++ scoping of enum values, clashing
    default JSON names, explicit defaults, reserved numbers and names,
    and adjacent string literals (``syntax = "proto" "3";``, the last
    case)."""
    src = ('syntax = "proto" "3"; message M { int32 a = 1; }'
           if body is None else 'syntax = "proto3"; ' + body)
    path = tmp_path / "v.proto"
    path.write_text(src)
    protoc_ok = subprocess.run(
        ["protoc", f"--proto_path={tmp_path}",
         f"--descriptor_set_out={tmp_path / 'v.desc'}", str(path)],
        capture_output=True).returncode == 0
    try:
        fd = P.parse(src, "v.proto")
    except ValueError:
        port_ok = False
    else:
        port_ok = True
        if protoc_ok:
            assert fd.to_dict() == strip_options(
                protoc_descriptor(src, "v.proto", tmp_path))
    assert port_ok == protoc_ok


# ---------------------------------------------------- generated messages

_INTS = {
    P.TYPE_INT32: (-2 ** 31, 2 ** 31 - 1), P.TYPE_SINT32: (-2 ** 31,
                                                           2 ** 31 - 1),
    P.TYPE_SFIXED32: (-2 ** 31, 2 ** 31 - 1),
    P.TYPE_UINT32: (0, 2 ** 32 - 1), P.TYPE_FIXED32: (0, 2 ** 32 - 1),
    P.TYPE_INT64: (-2 ** 63, 2 ** 63 - 1), P.TYPE_SINT64: (-2 ** 63,
                                                           2 ** 63 - 1),
    P.TYPE_SFIXED64: (-2 ** 63, 2 ** 63 - 1),
    P.TYPE_UINT64: (0, 2 ** 64 - 1), P.TYPE_FIXED64: (0, 2 ** 64 - 1),
}


def scalar(f, key=False):
    t = f.type
    if t in _INTS:
        lo, hi = _INTS[t]
        return st.one_of(st.integers(lo, hi), st.sampled_from(
            [0, 1, lo, hi, -1 if lo < 0 else 2]))
    if t == P.TYPE_ENUM:
        return st.one_of(st.sampled_from(
            [v for _, v in f.enum_type.values]), st.integers(-5, 9))
    if t == P.TYPE_BOOL:
        return st.booleans()
    if t == P.TYPE_STRING:
        return st.text(max_size=8 if key else 20)
    if t == P.TYPE_BYTES:
        return st.binary(max_size=24)
    if t == P.TYPE_FLOAT:
        return st.floats(width=32, allow_nan=False)
    return st.floats(allow_nan=False)


def message_kwargs(desc, depth=0):
    """A strategy of constructor kwargs for ``desc``: each field maybe
    set, at most one member of each oneof."""
    parts = {}
    for f in desc.fields:
        if f.is_map:
            kf = f.message_type.fields_by_number[1]
            vf = f.message_type.fields_by_number[2]
            vals = (message_kwargs(vf.message_type, depth + 1)
                    if vf.type == P.TYPE_MESSAGE else scalar(vf))
            parts[f.name] = st.dictionaries(scalar(kf, key=True), vals,
                                            max_size=3 if depth < 2 else 0)
        elif f.type == P.TYPE_MESSAGE:
            sub = message_kwargs(f.message_type, depth + 1) if depth < 3 \
                else st.just({})
            parts[f.name] = st.lists(sub, max_size=3) if f.repeated else sub
        else:
            parts[f.name] = st.lists(scalar(f), max_size=4) if f.repeated \
                else scalar(f)
    names = [f.name for f in desc.fields]
    oneof_of = {f.name: f.oneof for f in desc.fields}

    @st.composite
    def build(draw):
        kw = {}
        used = set()
        for name in names:
            if not draw(st.booleans()):
                continue
            o = oneof_of[name]
            if o is not None:
                if o in used:
                    continue
                used.add(o)
            kw[name] = draw(parts[name])
        return kw

    return build()


def _ref_classes():
    out = {}
    for name in port_pb.DESCRIPTOR.messages:
        short = name.split(".")[-1]
        cls = getattr(ref_pb, short, None)
        if cls is not None and "." not in name[len("emqx.exhook.v2."):]:
            out[name] = (getattr(port_pb, short), cls)
    rich_ref = ref_sr.ProtobufSchema(RICH_SRC)._messages
    rich_port = P.load(RICH_SRC).message_types()
    reg_ref = ref_sr.ProtobufSchema(REGISTRY_SRC)._messages
    reg_port = P.load(REGISTRY_SRC).message_types()
    for n in ("Report", "Wrapper"):
        out["fleet.v1." + n] = (rich_port[n], rich_ref[n])
    out["SensorReading"] = (reg_port["SensorReading"],
                            reg_ref["SensorReading"])
    return out


CLASSES = _ref_classes()


def _same(port_msg, ref_msg):
    ref_bytes = ref_msg.SerializeToString(deterministic=True)
    assert port_msg.SerializeToString() == ref_bytes
    return ref_bytes


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_generated_messages_equal_google_protobuf(name):
    pcls, gcls = CLASSES[name]

    @settings(max_examples=40, deadline=None, derandomize=True,
              suppress_health_check=list(HealthCheck))
    @given(message_kwargs(pcls.DESCRIPTOR))
    def check(kw):
        pm, gm = pcls(**kw), gcls(**kw)
        data = _same(pm, gm)
        # each side decodes the other's bytes to an equal message
        assert pcls.FromString(data) == pm
        back = gcls.FromString(pm.SerializeToString())
        assert back == gm
        # the JSON mapping, both ways
        js = json_format.MessageToDict(gm, preserving_proto_field_name=True)
        assert P.to_dict(pm) == js
        assert P.from_dict(js, pcls()).SerializeToString() == \
            json_format.ParseDict(js, gcls()).SerializeToString(
                deterministic=True)
        # truncated input: refused by both, or both read the same prefix
        for cut in sorted({0, 1, len(data) // 2, len(data) - 1}):
            if 0 <= cut < len(data):
                _decode_alike(pcls, gcls, data[:cut])

    check()


def _decode_alike(pcls, gcls, data):
    try:
        g = gcls.FromString(data)
    except gmessage.DecodeError:
        with pytest.raises(P.DecodeError):
            pcls.FromString(data)
        return
    g.DiscardUnknownFields()
    assert pcls.FromString(data).SerializeToString() == \
        g.SerializeToString(deterministic=True), data


@pytest.mark.parametrize("name", ["emqx.exhook.v2.Message",
                                  "emqx.exhook.v2.ValuedResponse",
                                  "fleet.v1.Report"])
def test_malformed_bytes_refused_alike(name):
    pcls, gcls = CLASSES[name]

    @settings(max_examples=200, deadline=None, derandomize=True,
              suppress_health_check=list(HealthCheck))
    @given(st.binary(max_size=40))
    def check(data):
        _decode_alike(pcls, gcls, data)

    check()


@pytest.mark.parametrize("data", [
    b"\x0a\x05ab",  # length past the end
    b"\x08",  # a varint cut
    b"\x08" + b"\xff" * 10 + b"\x01",  # an 11-byte varint
    b"\x00\x01",  # field number 0
    b"\x0f",  # wire type 7
    b"\x0c",  # an end-group with no start
    b"\x2a\x02\xc3\x28",  # invalid UTF-8 in a string field (topic)
    b"\x1d\x01\x02",  # a fixed32 cut (unknown field 3, wire type 5)
])
def test_known_malformed_inputs_raise_on_both_sides(data):
    with pytest.raises(gmessage.DecodeError):
        ref_pb.Message.FromString(data)
    with pytest.raises(P.DecodeError):
        port_pb.Message.FromString(data)


def test_packed_and_unpacked_repeated_read_alike():
    pcls, gcls = CLASSES["fleet.v1.Report"]
    # deltas (22, sint64) unpacked; temps (23, double) packed: each the
    # other way from how it is written
    data = bytes([0xb0, 0x01, 0x03, 0xb0, 0x01, 0x04,
                  0xba, 0x01, 0x08]) + (2.5).hex().encode()[:0] + \
        __import__("struct").pack("<d", 2.5)
    g = gcls.FromString(data)
    p = pcls.FromString(data)
    assert list(p.deltas) == list(g.deltas) == [-2, 2]
    assert list(p.temps) == list(g.temps) == [2.5]
    assert p.SerializeToString() == g.SerializeToString(deterministic=True)


def test_special_floats_and_presence_equal_google_protobuf():
    pcls, gcls = CLASSES["fleet.v1.Report"]
    for kw in ({"d": -0.0}, {"f": math.inf}, {"d": -math.inf},
               {"f": 1e40}, {"opt": 0}, {"zone": 0}, {"geohash": ""},
               {"grid": {}}, {"b": False, "i32": 0},
               {"cell": {"tags": []}}, {"counters": {"": 0}},
               {"by_id": {0: {}}}, {"flags": {True: "", False: "x"}}):
        pm, gm = pcls(**kw), gcls(**kw)
        _same(pm, gm)
        js = json_format.MessageToDict(gm, preserving_proto_field_name=True)
        assert P.to_dict(pm) == js, kw
    nan = pcls(d=math.nan)
    assert P.to_dict(nan) == {"d": "NaN"}
    g = gcls()
    json_format.ParseDict({"d": "NaN", "f": "-Infinity"}, g)
    p = P.from_dict({"d": "NaN", "f": "-Infinity"}, pcls())
    assert p.SerializeToString() == g.SerializeToString(deterministic=True)


@pytest.mark.parametrize("js", [
    {"nope": 1},
    {"i32": "abc"},
    {"i32": 1.5},
    {"i32": True},
    {"i32": 2 ** 31},
    {"u32": -1},
    {"b": "true"},
    {"d": math.nan},
    {"f": 1e39},
    {"mode": "NOPE"},
    {"raw": 5},
    {"s": 7},
    {"geohash": "a", "zone": 3},
    {"cells": {"v": 1}},
    {"cells": [None]},
    {"counters": [1]},
    {"by_id": {"x": {}}},
    {"flags": {"yes": "a"}},
    {"cell": {"v": "1.5"}},
])
def test_bad_json_refused_alike(js):
    pcls, gcls = CLASSES["fleet.v1.Report"]
    with pytest.raises(json_format.ParseError):
        json_format.ParseDict(js, gcls())
    with pytest.raises(P.ParseError):
        P.from_dict(js, pcls())


@pytest.mark.parametrize("js", [
    {"i64": "12", "u64": 18446744073709551615, "i32": "7", "z32": 3.0},
    {"raw": "AP8=", "s": "ü", "mode": 5, "modes": ["MANUAL", 9]},
    {"f": "1.5", "d": "1e300", "counters": {"a": "-3"}, "zone": 0},
    {"by_id": {"-4": {"v": 2}}, "flags": {"true": "t"}, "opt": 0},
    {"cell": None, "geohash": None, "raw": "-_8"},
])
def test_lenient_json_accepted_alike(js):
    pcls, gcls = CLASSES["fleet.v1.Report"]
    g = json_format.ParseDict(js, gcls())
    p = P.from_dict(js, pcls())
    assert p.SerializeToString() == g.SerializeToString(deterministic=True)


def test_message_api_used_by_exhook():
    pb = port_pb
    m = pb.Message(topic="t", **{"from": "c1"})
    assert getattr(m, "from") == "c1"
    setattr(m, "from", "c2")
    m.headers["allow_publish"] = "false"
    assert dict(m.headers) == {"allow_publish": "false"}
    out = pb.Message()
    out.CopyFrom(m)
    assert out == m and out is not m
    v = pb.ValuedResponse(type=pb.ValuedResponse.STOP_AND_RETURN,
                          bool_result=False)
    assert v.WhichOneof("value") == "bool_result"
    assert pb.ValuedResponse().WhichOneof("value") is None
    v.message.topic = "x"  # setting a member switches the oneof
    assert v.WhichOneof("value") == "message"
    spec = pb.HookSpec(name="message.publish")
    spec.topics.extend(["#", "a/+"])
    assert ref_pb.HookSpec.FromString(spec.SerializeToString()).topics == \
        ["#", "a/+"]
    assert pb.ClientAuthorizeRequest.PUBLISH == 0
    assert pb.ClientAuthorizeRequest.SUBSCRIBE == 1
    assert pb.ValuedResponse.ResponsedType.Name(2) == "STOP_AND_RETURN"
    req = pb.MessagePublishRequest()
    assert req.meta.node == "" and not req.HasField("meta")
    req.meta.node = "n"
    assert req.HasField("meta")
    with pytest.raises(TypeError):
        pb.Message(payload="text")
    with pytest.raises(ValueError):
        pb.SubOpts(qos=-1)
    with pytest.raises(ValueError):
        pb.Message(nope=1)
