"""A proto3 parser and wire codec from the standard library.

`parse(text)` reads ``.proto`` source into descriptors shaped like
protoc's ``FileDescriptorProto`` (`FileDesc.to_dict` gives the same
dict as ``json_format.MessageToDict`` of protoc's, options and reserved
ranges left out, ``map_entry`` kept); `load(text)` also builds a message
class for every message, so code written against protoc's generated
modules reads the same:

    pb = load(open("exhook.proto").read())
    m = pb.Message(topic="t", payload=b"x", **{"from": "c1"})
    m.headers["allow_publish"] = "false"
    pb.Message.FromString(m.SerializeToString()) == m

What it takes: ``syntax = "proto3"``, ``package``, messages and enums
(nested too), ``repeated``, ``map<K, V>``, ``oneof``, every scalar type,
proto3 ``optional``, comments, services (their rpc names and types).
It skips ``option`` statements, field options other than ``packed``, and
``reserved``.  ``import``, ``extend``, ``extensions``, proto2 labels and
groups raise ValueError naming the construct.

The wire format is proto3's: varints, zigzag ``sint*``, ``fixed*``,
``float``/``double``, length-delimited fields; repeated scalars are
written packed and read packed or not; unknown fields are skipped;
truncated or malformed input raises `DecodeError`.  Fields are written
in field-number order and map entries (key and value always) in the
order of upb's ``SerializeToString(deterministic=True)``, whose bytes
these are.

`to_dict`/`from_dict` are the JSON mapping with proto field names (as
``json_format.MessageToDict(m, preserving_proto_field_name=True)`` and
``json_format.ParseDict``): 64-bit integers as strings, bytes as
base64, enums by name, fields without presence omitted at their
default, ``"NaN"``/``"Infinity"``/``"-Infinity"``.
"""

from __future__ import annotations

import base64
import functools
import math
import re
import struct
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

# descriptor.proto's FieldDescriptorProto.Type and .Label
TYPE_DOUBLE, TYPE_FLOAT, TYPE_INT64, TYPE_UINT64, TYPE_INT32 = 1, 2, 3, 4, 5
TYPE_FIXED64, TYPE_FIXED32, TYPE_BOOL, TYPE_STRING, TYPE_GROUP = 6, 7, 8, 9, 10
TYPE_MESSAGE, TYPE_BYTES, TYPE_UINT32, TYPE_ENUM = 11, 12, 13, 14
TYPE_SFIXED32, TYPE_SFIXED64, TYPE_SINT32, TYPE_SINT64 = 15, 16, 17, 18
LABEL_OPTIONAL, LABEL_REPEATED = 1, 3

SCALARS = {
    "double": TYPE_DOUBLE, "float": TYPE_FLOAT, "int64": TYPE_INT64,
    "uint64": TYPE_UINT64, "int32": TYPE_INT32, "fixed64": TYPE_FIXED64,
    "fixed32": TYPE_FIXED32, "bool": TYPE_BOOL, "string": TYPE_STRING,
    "bytes": TYPE_BYTES, "uint32": TYPE_UINT32, "sfixed32": TYPE_SFIXED32,
    "sfixed64": TYPE_SFIXED64, "sint32": TYPE_SINT32, "sint64": TYPE_SINT64,
}
TYPE_NAMES = {v: "TYPE_" + k.upper() for k, v in SCALARS.items()}
TYPE_NAMES.update({TYPE_MESSAGE: "TYPE_MESSAGE", TYPE_ENUM: "TYPE_ENUM"})
_MAP_KEYS = {TYPE_INT64, TYPE_UINT64, TYPE_INT32, TYPE_FIXED64, TYPE_FIXED32,
             TYPE_BOOL, TYPE_STRING, TYPE_UINT32, TYPE_SFIXED32,
             TYPE_SFIXED64, TYPE_SINT32, TYPE_SINT64}
_INT_RANGE = {
    TYPE_INT32: (-2 ** 31, 2 ** 31 - 1), TYPE_SINT32: (-2 ** 31, 2 ** 31 - 1),
    TYPE_SFIXED32: (-2 ** 31, 2 ** 31 - 1), TYPE_ENUM: (-2 ** 31, 2 ** 31 - 1),
    TYPE_UINT32: (0, 2 ** 32 - 1), TYPE_FIXED32: (0, 2 ** 32 - 1),
    TYPE_INT64: (-2 ** 63, 2 ** 63 - 1), TYPE_SINT64: (-2 ** 63, 2 ** 63 - 1),
    TYPE_SFIXED64: (-2 ** 63, 2 ** 63 - 1),
    TYPE_UINT64: (0, 2 ** 64 - 1), TYPE_FIXED64: (0, 2 ** 64 - 1),
}
_INT64S = {TYPE_INT64, TYPE_UINT64, TYPE_FIXED64, TYPE_SFIXED64, TYPE_SINT64}
_VARINTS = {TYPE_INT64, TYPE_UINT64, TYPE_INT32, TYPE_BOOL, TYPE_UINT32,
            TYPE_ENUM, TYPE_SINT32, TYPE_SINT64}
_FIXED32S = {TYPE_FIXED32, TYPE_SFIXED32, TYPE_FLOAT}
_FIXED64S = {TYPE_FIXED64, TYPE_SFIXED64, TYPE_DOUBLE}
_FMT = {TYPE_FIXED32: "<I", TYPE_SFIXED32: "<i", TYPE_FLOAT: "<f",
        TYPE_FIXED64: "<Q", TYPE_SFIXED64: "<q", TYPE_DOUBLE: "<d"}
WIRE_VARINT, WIRE_I64, WIRE_LEN, WIRE_SGROUP, WIRE_EGROUP, WIRE_I32 = range(6)
_FLOAT_MAX = struct.unpack("<f", b"\xff\xff\x7f\x7f")[0]


class DecodeError(ValueError):
    """Malformed or truncated wire bytes."""


class ParseError(ValueError):
    """A JSON value the message cannot take."""


def _wire_type(ftype: int) -> int:
    if ftype in _VARINTS:
        return WIRE_VARINT
    if ftype in _FIXED32S:
        return WIRE_I32
    if ftype in _FIXED64S:
        return WIRE_I64
    return WIRE_LEN


def json_name(name: str) -> str:
    """protoc's default JSON name: underscores dropped, the letter after
    each one upper-cased."""
    out, up = [], False
    for ch in name:
        if ch == "_":
            up = True
        elif up:
            out.append(ch.upper())
            up = False
        else:
            out.append(ch)
    return "".join(out)


# ------------------------------------------------------------ descriptors

class EnumDesc:
    def __init__(self, name: str, full_name: str) -> None:
        self.name = name
        self.full_name = full_name
        self.values: List[Tuple[str, int]] = []
        self.values_by_name: Dict[str, int] = {}
        self.values_by_number: Dict[int, str] = {}

    def to_dict(self) -> dict:
        return {"name": self.name, "value": [
            {"name": n, "number": v} for n, v in self.values]}


class FieldDesc:
    def __init__(self, name: str, number: int, label: int, ftype: int,
                 type_ref: str = "") -> None:
        self.name = name
        self.number = number
        self.label = label
        self.type = ftype
        self.type_ref = type_ref  # as written, resolved into type_name
        self.type_name = ""
        self.oneof_index: Optional[int] = None
        self.proto3_optional = False
        self.packed: Optional[bool] = None  # the [packed = ...] option
        self.json_name = json_name(name)
        self.message_type: Optional[MessageDesc] = None
        self.enum_type: Optional[EnumDesc] = None
        self.oneof: Optional[str] = None  # containing oneof's name

    @property
    def repeated(self) -> bool:
        return self.label == LABEL_REPEATED

    @property
    def is_map(self) -> bool:
        return (self.repeated and self.message_type is not None
                and self.message_type.map_entry)

    @property
    def has_presence(self) -> bool:
        return not self.repeated and (
            self.type == TYPE_MESSAGE or self.oneof is not None)

    @property
    def is_packed(self) -> bool:
        return (self.repeated and self.packed is not False
                and self.type not in (TYPE_STRING, TYPE_BYTES, TYPE_MESSAGE))

    def to_dict(self) -> dict:
        d: Dict[str, Any] = {
            "name": self.name, "number": self.number,
            "label": "LABEL_REPEATED" if self.repeated else "LABEL_OPTIONAL",
            "type": TYPE_NAMES[self.type]}
        if self.type_name:
            d["type_name"] = self.type_name
        if self.oneof_index is not None:
            d["oneof_index"] = self.oneof_index
        d["json_name"] = self.json_name
        if self.proto3_optional:
            d["proto3_optional"] = True
        return d


class MessageDesc:
    def __init__(self, name: str, full_name: str) -> None:
        self.name = name
        self.full_name = full_name
        self.fields: List[FieldDesc] = []
        self.fields_by_name: Dict[str, FieldDesc] = {}
        self.fields_by_number: Dict[int, FieldDesc] = {}
        self.nested_types: List[MessageDesc] = []
        self.enum_types: List[EnumDesc] = []
        self.oneofs: List[str] = []  # oneof_decl names, synthetic last
        self.map_entry = False
        self.cls: Optional[type] = None

    def to_dict(self) -> dict:
        d: Dict[str, Any] = {"name": self.name}
        if self.fields:
            d["field"] = [f.to_dict() for f in self.fields]
        if self.nested_types:
            d["nested_type"] = [m.to_dict() for m in self.nested_types]
        if self.enum_types:
            d["enum_type"] = [e.to_dict() for e in self.enum_types]
        if self.map_entry:
            d["options"] = {"map_entry": True}
        if self.oneofs:
            d["oneof_decl"] = [{"name": n} for n in self.oneofs]
        return d


class MethodDesc:
    def __init__(self, name: str, input_ref: str, output_ref: str,
                 client_streaming: bool, server_streaming: bool) -> None:
        self.name = name
        self.input_ref = input_ref
        self.output_ref = output_ref
        self.input_type = self.output_type = ""
        self.client_streaming = client_streaming
        self.server_streaming = server_streaming

    def to_dict(self) -> dict:
        d: Dict[str, Any] = {"name": self.name, "input_type": self.input_type,
                             "output_type": self.output_type}
        if self.client_streaming:
            d["client_streaming"] = True
        if self.server_streaming:
            d["server_streaming"] = True
        return d


class ServiceDesc:
    def __init__(self, name: str, full_name: str) -> None:
        self.name = name
        self.full_name = full_name
        self.methods: List[MethodDesc] = []

    def to_dict(self) -> dict:
        d: Dict[str, Any] = {"name": self.name}
        if self.methods:
            d["method"] = [m.to_dict() for m in self.methods]
        return d


class FileDesc:
    def __init__(self, name: str) -> None:
        self.name = name
        self.package = ""
        self.syntax = ""
        self.message_types: List[MessageDesc] = []
        self.enum_types: List[EnumDesc] = []
        self.services: List[ServiceDesc] = []
        self.messages: Dict[str, MessageDesc] = {}  # by full name
        self.enums: Dict[str, EnumDesc] = {}
        # every other name protoc declares in a scope: fields, oneofs
        # and enum values (C++ scoping: a value is its enum's sibling)
        self.symbols: Set[str] = set()

    def to_dict(self) -> dict:
        d: Dict[str, Any] = {"name": self.name}
        if self.package:
            d["package"] = self.package
        if self.message_types:
            d["message_type"] = [m.to_dict() for m in self.message_types]
        if self.enum_types:
            d["enum_type"] = [e.to_dict() for e in self.enum_types]
        if self.services:
            d["service"] = [s.to_dict() for s in self.services]
        d["syntax"] = self.syntax
        return d


# ----------------------------------------------------------------- parser

_TOKEN = re.compile(r"""
    (?P<ws>\s+)
  | (?P<line>//[^\n]*)
  | (?P<block>/\*.*?\*/)
  | (?P<str>"(?:[^"\\\n]|\\.)*"|'(?:[^'\\\n]|\\.)*')
  | (?P<num>(?:0[xX][0-9a-fA-F]+|\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?))
  | (?P<ident>\.?[A-Za-z_][\w]*(?:\.[A-Za-z_][\w]*)*)
  | (?P<sym>[{}\[\]()<>;=,:+\-])
""", re.X | re.S)

_REFUSED = {
    "import": "import", "extend": "extend", "extensions": "extensions",
    "required": "proto2 'required'", "group": "groups",
}


class _Tokens:
    def __init__(self, text: str) -> None:
        self.toks: List[Tuple[str, str, int]] = []
        pos, line = 0, 1
        while pos < len(text):
            m = _TOKEN.match(text, pos)
            if m is None:
                raise ValueError(
                    f"line {line}: unexpected character {text[pos]!r}")
            kind = m.lastgroup
            if kind == "block" or kind == "line" or kind == "ws":
                pass
            else:
                self.toks.append((kind, m.group(), line))
            line += m.group().count("\n")
            pos = m.end()
        if text[pos:pos + 2] == "/*":
            raise ValueError(f"line {line}: unterminated comment")
        self.i = 0

    def peek(self) -> str:
        return self.toks[self.i][1] if self.i < len(self.toks) else ""

    def line(self) -> int:
        if self.i < len(self.toks):
            return self.toks[self.i][2]
        return self.toks[-1][2] if self.toks else 1

    def next(self) -> Tuple[str, str]:
        if self.i >= len(self.toks):
            raise ValueError("unexpected end of the schema")
        kind, val, _ = self.toks[self.i]
        self.i += 1
        return kind, val

    def expect(self, val: str) -> None:
        line = self.line()
        _, got = self.next()
        if got != val:
            raise ValueError(f"line {line}: expected {val!r}, got {got!r}")

    def ident(self) -> str:
        line = self.line()
        kind, val = self.next()
        if kind != "ident":
            raise ValueError(f"line {line}: expected a name, got {val!r}")
        return val

    def string(self) -> str:
        """A string literal; adjacent literals concatenate, as in
        protoc (``"proto" "3"`` is ``"proto3"``)."""
        line = self.line()
        kind, val = self.next()
        if kind != "str":
            raise ValueError(f"line {line}: expected a string, got {val!r}")
        out = val[1:-1]
        while self.i < len(self.toks) and self.toks[self.i][0] == "str":
            out += self.next()[1][1:-1]
        return out

    def value(self) -> Tuple[str, str]:
        """An option's value token; a string comes back quoted, with
        adjacent literals concatenated."""
        if self.i < len(self.toks) and self.toks[self.i][0] == "str":
            return "str", '"' + self.string() + '"'
        return self.next()

    def reserved(self) -> Tuple[List[Tuple[int, int]], List[str]]:
        """The body of a ``reserved`` statement (after the keyword):
        inclusive number ranges (``max`` is the largest field number)
        or names."""
        ranges: List[Tuple[int, int]] = []
        names: List[str] = []
        while True:
            if self.i < len(self.toks) and self.toks[self.i][0] == "str":
                names.append(self.string())
            else:
                lo = self.integer()
                hi = lo
                if self.peek() == "to":
                    self.next()
                    if self.peek() == "max":
                        self.next()
                        hi = 536870911
                    else:
                        hi = self.integer()
                ranges.append((lo, hi))
            if self.peek() == ",":
                self.next()
                continue
            self.expect(";")
            return ranges, names

    def integer(self) -> int:
        line = self.line()
        neg = False
        if self.peek() == "-":
            self.next()
            neg = True
        kind, val = self.next()
        if kind != "num" or not re.fullmatch(r"0[xX][0-9a-fA-F]+|\d+", val):
            raise ValueError(f"line {line}: expected an integer, got {val!r}")
        n = int(val, 16) if val[:2] in ("0x", "0X") else (
            int(val, 8) if len(val) > 1 and val[0] == "0" else int(val))
        return -n if neg else n

    def skip_statement(self) -> None:
        """Skip to the ``;`` ending an option or reserved statement."""
        depth = 0
        while True:
            _, val = self.next()
            if val in ("{", "[", "("):
                depth += 1
            elif val in ("}", "]", ")"):
                depth -= 1
            elif val == ";" and depth <= 0:
                return


def _refuse(tok: _Tokens, word: str) -> None:
    if word in _REFUSED:
        raise ValueError(
            f"line {tok.line()}: {_REFUSED[word]} is not supported "
            "(proto3 messages, enums and services only)")


def parse(text: str, name: str = "schema.proto") -> FileDesc:
    """Parse proto3 source into a `FileDesc`; ValueError on anything
    outside the supported subset or on a schema protoc would refuse."""
    tok = _Tokens(text)
    fd = FileDesc(name)
    if tok.peek() != "syntax":
        raise ValueError("no syntax statement: only proto3 is supported "
                         "(a file without one is proto2)")
    tok.next()
    tok.expect("=")
    syntax = tok.string()
    tok.expect(";")
    if syntax != "proto3":
        raise ValueError(f"syntax {syntax!r}: only proto3 is supported")
    fd.syntax = syntax
    while tok.i < len(tok.toks):
        word = tok.peek()
        line = tok.line()
        if word == ";":
            tok.next()
        elif word == "package":
            tok.next()
            if fd.package:
                raise ValueError(f"line {line}: a second package statement")
            fd.package = tok.ident().lstrip(".")
            tok.expect(";")
        elif word == "option":
            tok.skip_statement()
        elif word == "message":
            tok.next()
            fd.message_types.append(_parse_message(tok, fd, fd.package))
        elif word == "enum":
            tok.next()
            fd.enum_types.append(_parse_enum(tok, fd, fd.package))
        elif word == "service":
            tok.next()
            fd.services.append(_parse_service(tok, fd))
        else:
            _refuse(tok, word)
            raise ValueError(f"line {line}: unexpected {word!r}")
    _resolve(fd)
    return fd


def _qualify(scope: str, name: str) -> str:
    return f"{scope}.{name}" if scope else name


def _declare(fd: FileDesc, full: str, obj: Any, line: int) -> None:
    if full in fd.messages or full in fd.enums or full in fd.symbols:
        raise ValueError(f"line {line}: {full!r} is already defined")
    if isinstance(obj, MessageDesc):
        fd.messages[full] = obj
    else:
        fd.enums[full] = obj


def _declare_symbol(fd: FileDesc, full: str, line: int) -> None:
    """Declare a field, oneof or enum value: its full name must be new
    among every name of the file."""
    if full in fd.messages or full in fd.enums or full in fd.symbols:
        raise ValueError(f"line {line}: {full!r} is already defined")
    fd.symbols.add(full)


def _add_reserved(tok: _Tokens, line: int, ranges: List[Tuple[int, int]],
                  names: List[str]) -> None:
    """Parse one ``reserved`` statement into ``ranges``/``names``;
    a range overlapping an earlier one is refused, as protoc does."""
    new, new_names = tok.reserved()
    for lo, hi in new:
        if lo > hi:
            raise ValueError(f"line {line}: reserved range {lo} to {hi} "
                             "is empty")
        for plo, phi in ranges:
            if lo <= phi and plo <= hi:
                raise ValueError(
                    f"line {line}: reserved range {lo} to {hi} overlaps "
                    f"with already-defined range {plo} to {phi}")
        ranges.append((lo, hi))
    names.extend(new_names)


def _check_reserved(what: str, name: str, number: int,
                    ranges: List[Tuple[int, int]], names: List[str]) -> None:
    if name in names:
        raise ValueError(f"{what} name {name!r} is reserved")
    for lo, hi in ranges:
        if lo <= number <= hi:
            raise ValueError(f"{what} {name!r} uses reserved number "
                             f"{number}")


def _parse_message(tok: _Tokens, fd: FileDesc, scope: str) -> MessageDesc:
    line = tok.line()
    name = tok.ident()
    msg = MessageDesc(name, _qualify(scope, name))
    _declare(fd, msg.full_name, msg, line)
    tok.expect("{")
    optionals: List[FieldDesc] = []
    res_ranges: List[Tuple[int, int]] = []
    res_names: List[str] = []
    while True:
        word = tok.peek()
        line = tok.line()
        if word == "}":
            tok.next()
            break
        if word == ";":
            tok.next()
        elif word == "option":
            tok.skip_statement()
        elif word == "reserved":
            tok.next()
            _add_reserved(tok, line, res_ranges, res_names)
        elif word == "message":
            tok.next()
            msg.nested_types.append(_parse_message(tok, fd, msg.full_name))
        elif word == "enum":
            tok.next()
            msg.enum_types.append(_parse_enum(tok, fd, msg.full_name))
        elif word == "oneof":
            tok.next()
            oname = tok.ident()
            _declare_symbol(fd, _qualify(msg.full_name, oname), line)
            msg.oneofs.append(oname)
            tok.expect("{")
            n_members = 0
            while tok.peek() != "}":
                if tok.peek() == "option":
                    tok.skip_statement()
                    continue
                if tok.peek() == ";":
                    tok.next()
                    continue
                if tok.peek() in ("repeated", "optional", "map"):
                    raise ValueError(
                        f"line {tok.line()}: a oneof member cannot be "
                        f"{tok.peek()!r}")
                f = _parse_field(tok, LABEL_OPTIONAL)
                f.oneof = oname
                f.oneof_index = len(msg.oneofs) - 1
                _add_field(msg, f, tok, fd)
                n_members += 1
            tok.next()
            if not n_members:
                raise ValueError(f"line {line}: oneof {oname!r} is empty")
        elif word == "map":
            tok.next()
            tok.expect("<")
            kline = tok.line()
            ktype = tok.ident()
            if SCALARS.get(ktype) not in _MAP_KEYS:
                raise ValueError(f"line {kline}: map key type {ktype!r}")
            tok.expect(",")
            vref = tok.ident()
            tok.expect(">")
            f = _parse_field_tail(tok, LABEL_REPEATED, TYPE_MESSAGE, "")
            entry = MessageDesc(
                f.json_name[:1].upper() + f.json_name[1:] + "Entry", "")
            entry.full_name = _qualify(msg.full_name, entry.name)
            entry.map_entry = True
            _declare(fd, entry.full_name, entry, line)
            kf = FieldDesc("key", 1, LABEL_OPTIONAL, SCALARS[ktype])
            vt = SCALARS.get(vref)
            vf = FieldDesc("value", 2, LABEL_OPTIONAL,
                           vt if vt is not None else TYPE_MESSAGE,
                           "" if vt is not None else vref)
            for x in (kf, vf):
                entry.fields.append(x)
                entry.fields_by_name[x.name] = x
                entry.fields_by_number[x.number] = x
            f.type_ref = "." + entry.full_name
            msg.nested_types.append(entry)
            _add_field(msg, f, tok, fd)
        else:
            _refuse(tok, word)
            label = LABEL_OPTIONAL
            optional = False
            if word == "repeated":
                tok.next()
                label = LABEL_REPEATED
            elif word == "optional":
                tok.next()
                optional = True
            f = _parse_field(tok, label)
            if optional:
                f.proto3_optional = True
                optionals.append(f)
            _add_field(msg, f, tok, fd)
    by_json: Dict[str, str] = {}
    for f in msg.fields:
        _check_reserved("field", f.name, f.number, res_ranges, res_names)
        # proto3 refuses two fields whose default JSON names clash,
        # compared as protoc does: lower case, underscores dropped (a
        # json_name option does not lift it)
        jn = f.name.replace("_", "").lower()
        if jn in by_json:
            raise ValueError(
                f"the JSON camel-case name of field {f.name!r} conflicts "
                f"with field {by_json[jn]!r} in {msg.full_name}")
        by_json[jn] = f.name
    for f in optionals:  # synthetic oneofs follow the declared ones
        oname = "_" + f.name
        while oname in msg.oneofs:
            oname = "X" + oname
        msg.oneofs.append(oname)
        f.oneof = oname
        f.oneof_index = len(msg.oneofs) - 1
    return msg


def _parse_field(tok: _Tokens, label: int) -> FieldDesc:
    tname = tok.ident()
    _refuse(tok, tname)
    ftype = SCALARS.get(tname)
    return _parse_field_tail(tok, label, ftype or TYPE_MESSAGE,
                             "" if ftype else tname)


def _parse_field_tail(tok: _Tokens, label: int, ftype: int,
                      ref: str) -> FieldDesc:
    line = tok.line()
    name = tok.ident()
    if "." in name:
        raise ValueError(f"line {line}: bad field name {name!r}")
    tok.expect("=")
    number = tok.integer()
    f = FieldDesc(name, number, label, ftype, ref)
    if tok.peek() == "[":
        tok.next()
        while True:
            oline = tok.line()
            oname = tok.ident() if tok.peek() != "(" else None
            if oname is None:  # a custom option: (name).sub = value
                depth = 0
                while True:
                    _, v = tok.next()
                    if v == "(":
                        depth += 1
                    elif v == ")":
                        depth -= 1
                        if depth == 0:
                            break
                while tok.peek() != "=":
                    tok.next()
            tok.expect("=")
            _kind, val = tok.value()
            if val == "-":
                _kind, val = tok.value()
            if oname == "default":
                raise ValueError(f"line {oline}: explicit default values "
                                 "are not allowed in proto3")
            if oname == "packed":
                if val not in ("true", "false"):
                    raise ValueError(f"line {oline}: packed = {val!r}")
                f.packed = val == "true"
            elif oname == "json_name":
                f.json_name = val[1:-1]
            if tok.peek() == ",":
                tok.next()
                continue
            tok.expect("]")
            break
    tok.expect(";")
    if not 1 <= number <= 536870911 or 19000 <= number <= 19999:
        raise ValueError(f"line {line}: field number {number} of {name!r} "
                         "is out of range")
    return f


def _add_field(msg: MessageDesc, f: FieldDesc, tok: _Tokens,
               fd: FileDesc) -> None:
    if f.name in msg.fields_by_name:
        raise ValueError(f"line {tok.line()}: field {f.name!r} of "
                         f"{msg.full_name} is already defined")
    _declare_symbol(fd, _qualify(msg.full_name, f.name), tok.line())
    if f.number in msg.fields_by_number:
        raise ValueError(f"line {tok.line()}: field number {f.number} of "
                         f"{msg.full_name} is already used")
    msg.fields.append(f)
    msg.fields_by_name[f.name] = f
    msg.fields_by_number[f.number] = f


def _parse_enum(tok: _Tokens, fd: FileDesc, scope: str) -> EnumDesc:
    line = tok.line()
    name = tok.ident()
    en = EnumDesc(name, _qualify(scope, name))
    _declare(fd, en.full_name, en, line)
    tok.expect("{")
    allow_alias: Optional[bool] = None
    res_ranges: List[Tuple[int, int]] = []
    res_names: List[str] = []
    while True:
        word = tok.peek()
        vline = tok.line()
        if word == "}":
            tok.next()
            break
        if word == ";":
            tok.next()
        elif word == "option":
            tok.next()
            if tok.peek() != "allow_alias":
                tok.i -= 1
                tok.skip_statement()
                continue
            tok.next()
            tok.expect("=")
            _k, val = tok.next()
            if val not in ("true", "false"):
                raise ValueError(f"line {vline}: allow_alias = {val!r}")
            tok.expect(";")
            allow_alias = val == "true"
        elif word == "reserved":
            tok.next()
            _add_reserved(tok, vline, res_ranges, res_names)
        else:
            vname = tok.ident()
            tok.expect("=")
            num = tok.integer()
            if tok.peek() == "[":
                while tok.next()[1] != "]":
                    pass
            tok.expect(";")
            if not en.values and num != 0:
                raise ValueError(f"line {vline}: the first value of enum "
                                 f"{name!r} must be zero in proto3")
            if vname in en.values_by_name:
                raise ValueError(f"line {vline}: enum value {vname!r} is "
                                 "already defined")
            if num in en.values_by_number and not allow_alias:
                raise ValueError(
                    f"line {vline}: {vname!r} uses the same enum value as "
                    f"{en.values_by_number[num]!r} and enum {name!r} does "
                    "not set allow_alias")
            _check_reserved("enum value", vname, num, res_ranges, res_names)
            # C++ scoping: the value is declared beside its enum
            _declare_symbol(fd, _qualify(scope, vname), vline)
            en.values.append((vname, num))
            en.values_by_name[vname] = num
            en.values_by_number.setdefault(num, vname)
    if not en.values:
        raise ValueError(f"line {line}: enum {name!r} has no values")
    if allow_alias is False:
        raise ValueError(f"line {line}: enum {name!r} declares "
                         "'option allow_alias = false;', which has no effect")
    if allow_alias and len(en.values_by_number) == len(en.values):
        raise ValueError(f"line {line}: enum {name!r} allows aliases but "
                         "no values share a number")
    return en


def _parse_service(tok: _Tokens, fd: FileDesc) -> ServiceDesc:
    name = tok.ident()
    svc = ServiceDesc(name, _qualify(fd.package, name))
    tok.expect("{")
    while True:
        word = tok.peek()
        line = tok.line()
        if word == "}":
            tok.next()
            break
        if word == ";":
            tok.next()
        elif word == "option":
            tok.skip_statement()
        elif word == "rpc":
            tok.next()
            mname = tok.ident()
            tok.expect("(")
            cs = tok.peek() == "stream"
            if cs:
                tok.next()
            inp = tok.ident()
            tok.expect(")")
            if tok.ident() != "returns":
                raise ValueError(f"line {line}: expected 'returns'")
            tok.expect("(")
            ss = tok.peek() == "stream"
            if ss:
                tok.next()
            out = tok.ident()
            tok.expect(")")
            if tok.peek() == "{":
                tok.next()
                while tok.peek() != "}":
                    if tok.peek() == "option":
                        tok.skip_statement()
                    elif tok.peek() == ";":
                        tok.next()
                    else:
                        raise ValueError(
                            f"line {tok.line()}: rpc bodies hold options "
                            f"only, got {tok.peek()!r}")
                tok.next()
            else:
                tok.expect(";")
            svc.methods.append(MethodDesc(mname, inp, out, cs, ss))
        else:
            _refuse(tok, word)
            raise ValueError(f"line {line}: a service holds rpcs and "
                             f"options only, got {word!r}")
    return svc


def _lookup(fd: FileDesc, scope: str, ref: str) -> Any:
    """protoc's scoping: the innermost scope whose first component
    resolves wins.  The first component resolves to a message, an enum
    or a component of the package (``a`` and ``a.b`` of ``package
    a.b``), so a name may be written through its package."""
    if ref.startswith("."):
        full = ref[1:]
        return fd.messages.get(full) or fd.enums.get(full)
    pkg = fd.package.split(".") if fd.package else []
    packages = {".".join(pkg[:k]) for k in range(1, len(pkg) + 1)}
    first = ref.split(".")[0]
    parts = scope.split(".") if scope else []
    while True:
        base = ".".join(parts)
        head = _qualify(base, first)
        if head in fd.messages or head in fd.enums or head in packages:
            full = _qualify(base, ref)
            return fd.messages.get(full) or fd.enums.get(full)
        if not parts:
            return None
        parts.pop()


def _resolve(fd: FileDesc) -> None:
    for msg in list(fd.messages.values()):
        for f in msg.fields:
            if f.type != TYPE_MESSAGE or f.message_type is not None:
                continue
            target = _lookup(fd, msg.full_name, f.type_ref)
            if target is None:
                raise ValueError(f"{f.type_ref!r} (field {f.name!r} of "
                                 f"{msg.full_name}) is not defined")
            f.type_name = "." + target.full_name
            if isinstance(target, EnumDesc):
                f.type = TYPE_ENUM
                f.enum_type = target
            else:
                f.message_type = target
    for msg in fd.messages.values():
        for f in msg.fields:
            if f.is_map and f.oneof is not None:
                raise ValueError(f"map field {f.name!r} in a oneof")
    for svc in fd.services:
        for m in svc.methods:
            for attr, ref in (("input_type", m.input_ref),
                              ("output_type", m.output_ref)):
                target = _lookup(fd, fd.package, ref)
                if not isinstance(target, MessageDesc):
                    raise ValueError(f"rpc {m.name}: {ref!r} is not a "
                                     "message type")
                setattr(m, attr, "." + target.full_name)


# ---------------------------------------------------------------- values

def _to_float32(v: float) -> float:
    try:
        return struct.unpack("<f", struct.pack("<f", v))[0]
    except OverflowError:
        return math.copysign(math.inf, v)


def _check(f: FieldDesc, v: Any, ftype: Optional[int] = None) -> Any:
    """The value a field of ``f``'s type stores for ``v``: TypeError for
    a wrong type, ValueError for an integer out of range."""
    t = f.type if ftype is None else ftype
    if t in _INT_RANGE:
        if isinstance(v, float) or not hasattr(v, "__index__"):
            raise TypeError(f"{f.name}: {v!r} has type "
                            f"{type(v).__name__}, but an integer is expected")
        v = v.__index__()
        lo, hi = _INT_RANGE[t]
        if not lo <= v <= hi:
            raise ValueError(f"{f.name}: value out of range: {v}")
        return int(v)
    if t == TYPE_DOUBLE or t == TYPE_FLOAT:
        if isinstance(v, (str, bytes)) or not isinstance(
                v, (int, float)) and not hasattr(v, "__float__"):
            raise TypeError(f"{f.name}: {v!r} is not a number")
        v = float(v)
        return _to_float32(v) if t == TYPE_FLOAT else v
    if t == TYPE_BOOL:
        if not hasattr(v, "__index__"):
            raise TypeError(f"{f.name}: {v!r} is not a bool")
        return bool(v)
    if t == TYPE_STRING:
        if isinstance(v, (bytes, bytearray)):
            try:
                return bytes(v).decode("utf-8")
            except UnicodeDecodeError as exc:
                raise ValueError(f"{f.name}: {v!r} is not UTF-8") from exc
        if not isinstance(v, str):
            raise TypeError(f"{f.name}: {v!r} is not a str")
        return v
    if t == TYPE_BYTES:
        if not isinstance(v, (bytes, bytearray, memoryview)):
            raise TypeError(f"{f.name}: expected bytes, "
                            f"{type(v).__name__} found")
        return bytes(v)
    raise TypeError(f"{f.name}: cannot assign to a message field")


def _default(f: FieldDesc) -> Any:
    t = f.type
    if t in (TYPE_DOUBLE, TYPE_FLOAT):
        return 0.0
    if t == TYPE_BOOL:
        return False
    if t == TYPE_STRING:
        return ""
    if t == TYPE_BYTES:
        return b""
    return 0


def _is_zero(f: FieldDesc, v: Any) -> bool:
    if f.type in (TYPE_DOUBLE, TYPE_FLOAT):
        return v == 0.0 and math.copysign(1.0, v) > 0
    return not v


class RepeatedScalar(list):
    """A repeated scalar field: a list that checks what it takes."""

    __slots__ = ("_owner", "_f")

    def __init__(self, owner: "Message", f: FieldDesc) -> None:
        super().__init__()
        self._owner = owner
        self._f = f

    def append(self, v: Any) -> None:
        super().append(_check(self._f, v))
        self._owner._modified()

    def extend(self, vs: Iterable[Any]) -> None:
        super().extend([_check(self._f, v) for v in vs])
        self._owner._modified()

    def insert(self, i: int, v: Any) -> None:
        super().insert(i, _check(self._f, v))
        self._owner._modified()

    def __setitem__(self, i, v) -> None:
        if isinstance(i, slice):
            super().__setitem__(i, [_check(self._f, x) for x in v])
        else:
            super().__setitem__(i, _check(self._f, v))

    def __iadd__(self, vs):
        self.extend(vs)
        return self

    def __eq__(self, other) -> bool:
        return list(self) == list(other)

    __hash__ = None  # type: ignore[assignment]


class RepeatedComposite(list):
    """A repeated message field: ``add(**kw)`` appends a new element."""

    __slots__ = ("_owner", "_f")

    def __init__(self, owner: "Message", f: FieldDesc) -> None:
        super().__init__()
        self._owner = owner
        self._f = f

    def _coerce(self, v: Any) -> "Message":
        cls = self._f.message_type.cls
        if isinstance(v, dict):
            return cls(**v)
        if not isinstance(v, cls):
            raise TypeError(f"{self._f.name}: expected {cls.__name__}, got "
                            f"{type(v).__name__}")
        c = cls()
        c.CopyFrom(v)
        return c

    def add(self, **kw: Any) -> "Message":
        c = self._f.message_type.cls(**kw)
        super().append(c)
        self._owner._modified()
        return c

    def append(self, v: Any) -> None:
        super().append(self._coerce(v))
        self._owner._modified()

    def extend(self, vs: Iterable[Any]) -> None:
        super().extend([self._coerce(v) for v in vs])
        self._owner._modified()

    def insert(self, i: int, v: Any) -> None:
        super().insert(i, self._coerce(v))
        self._owner._modified()

    def __eq__(self, other) -> bool:
        return list(self) == list(other)

    __hash__ = None  # type: ignore[assignment]


class MapField(dict):
    """A map field: a dict that checks its keys and values; a message
    map makes the entry a missing key names."""

    __slots__ = ("_owner", "_f", "_kf", "_vf")

    def __init__(self, owner: "Message", f: FieldDesc) -> None:
        super().__init__()
        self._owner = owner
        self._f = f
        entry = f.message_type
        self._kf = entry.fields_by_number[1]
        self._vf = entry.fields_by_number[2]

    def _value(self, v: Any) -> Any:
        vf = self._vf
        if vf.type != TYPE_MESSAGE:
            return _check(vf, v)
        cls = vf.message_type.cls
        if isinstance(v, dict):
            return cls(**v)
        if not isinstance(v, cls):
            raise TypeError(f"{self._f.name}: expected {cls.__name__}")
        c = cls()
        c.CopyFrom(v)
        return c

    def __setitem__(self, k: Any, v: Any) -> None:
        super().__setitem__(_check(self._kf, k), self._value(v))
        self._owner._modified()

    def __missing__(self, k: Any) -> Any:
        if self._vf.type != TYPE_MESSAGE:
            raise KeyError(k)
        c = self._vf.message_type.cls()
        super().__setitem__(_check(self._kf, k), c)
        self._owner._modified()
        return c

    def update(self, *args: Any, **kw: Any) -> None:
        for k, v in dict(*args, **kw).items():
            self[k] = v

    def setdefault(self, k: Any, v: Any = None) -> Any:
        if k not in self:
            self[k] = v
        return self[k]


# --------------------------------------------------------------- messages

class Message:
    """Base of every generated message class; ``DESCRIPTOR`` is the
    class's `MessageDesc`."""

    __slots__ = ("_v", "_oneof", "_parent", "_pname", "_live")
    DESCRIPTOR: MessageDesc

    def __init__(self, **kw: Any) -> None:
        object.__setattr__(self, "_v", {})
        object.__setattr__(self, "_oneof", {})
        object.__setattr__(self, "_parent", None)
        object.__setattr__(self, "_pname", None)
        object.__setattr__(self, "_live", False)
        desc = self.DESCRIPTOR
        for name, v in kw.items():
            f = desc.fields_by_name.get(name)
            if f is None:
                raise ValueError(f'Protocol message {desc.name} has no '
                                 f'"{name}" field.')
            if v is None:
                continue
            if f.is_map:
                getattr(self, name).update(v)
            elif f.repeated:
                getattr(self, name).extend(v)
            elif f.type == TYPE_MESSAGE:
                self._set_message(f, v)
            else:
                self._set_scalar(f, v)

    # presence: a message made by reading an unset field becomes part of
    # its parent the first time it, or anything under it, is written
    def _modified(self) -> None:
        if not self._live:
            object.__setattr__(self, "_live", True)
            p = self._parent
            if p is not None:
                p._child_set(self._pname, self)

    def _child_set(self, name: str, child: "Message") -> None:
        f = self.DESCRIPTOR.fields_by_name[name]
        if f.oneof is not None:
            self._switch_oneof(f)
        self._v[name] = child
        self._modified()

    def _switch_oneof(self, f: FieldDesc) -> None:
        cur = self._oneof.get(f.oneof)
        if cur is not None and cur != f.name:
            self._v.pop(cur, None)
        self._oneof[f.oneof] = f.name

    def _set_scalar(self, f: FieldDesc, v: Any) -> None:
        v = _check(f, v)
        if f.oneof is not None:
            self._switch_oneof(f)
        self._v[f.name] = v
        self._modified()

    def _set_message(self, f: FieldDesc, v: Any) -> None:
        cls = f.message_type.cls
        if isinstance(v, dict):
            c = cls(**v)
        elif isinstance(v, cls):
            c = cls()
            c.CopyFrom(v)
        else:
            raise TypeError(f"{f.name}: expected {cls.__name__}, got "
                            f"{type(v).__name__}")
        self._attach(f.name, c)

    def _attach(self, name: str, c: "Message") -> None:
        object.__setattr__(c, "_parent", self)
        object.__setattr__(c, "_pname", name)
        object.__setattr__(c, "_live", True)
        self._child_set(name, c)

    def _get(self, f: FieldDesc) -> Any:
        v = self._v.get(f.name)
        if v is not None:
            return v
        if f.is_map:
            v = self._v[f.name] = MapField(self, f)
            return v
        if f.repeated:
            v = (RepeatedComposite(self, f) if f.type == TYPE_MESSAGE
                 else RepeatedScalar(self, f))
            self._v[f.name] = v
            return v
        if f.type == TYPE_MESSAGE:
            lazy = self._lazy_children()
            c = lazy.get(f.name)
            if c is None:
                c = f.message_type.cls()
                object.__setattr__(c, "_parent", self)
                object.__setattr__(c, "_pname", f.name)
                lazy[f.name] = c
            return c
        return _default(f)

    def _lazy_children(self) -> Dict[str, "Message"]:
        lazy = self._v.get(None)
        if lazy is None:
            lazy = self._v[None] = {}
        return lazy

    def __setattr__(self, name: str, v: Any) -> None:
        f = self.DESCRIPTOR.fields_by_name.get(name)
        if f is None:
            raise AttributeError(
                f"{self.DESCRIPTOR.name} has no field {name!r}")
        if f.repeated:
            raise AttributeError(
                f"assignment to the repeated field {name!r}: use extend")
        if f.type == TYPE_MESSAGE:
            self._set_message(f, v)
        else:
            self._set_scalar(f, v)

    # ----------------------------------------------------- protobuf API

    def HasField(self, name: str) -> bool:
        desc = self.DESCRIPTOR
        f = desc.fields_by_name.get(name)
        if f is None:
            if name in desc.oneofs:
                return name in self._oneof
            raise ValueError(f'Protocol message {desc.name} has no field '
                             f'"{name}".')
        if not f.has_presence:
            raise ValueError(f'Field {desc.full_name}.{name} does not have '
                             'presence.')
        if f.oneof is not None and self._oneof.get(f.oneof) != name:
            return False
        return name in self._v

    def WhichOneof(self, oneof: str) -> Optional[str]:
        if oneof not in self.DESCRIPTOR.oneofs:
            raise ValueError(f'Protocol message has no oneof "{oneof}" '
                             'field.')
        return self._oneof.get(oneof)

    def ClearField(self, name: str) -> None:
        desc = self.DESCRIPTOR
        if name in desc.oneofs and name not in desc.fields_by_name:
            cur = self._oneof.pop(name, None)
            if cur is not None:
                self._v.pop(cur, None)
            return
        f = desc.fields_by_name.get(name)
        if f is None:
            raise ValueError(f'Protocol message {desc.name} has no "{name}" '
                             'field.')
        self._v.pop(name, None)
        lazy = self._v.get(None)
        if lazy:
            lazy.pop(name, None)
        if f.oneof is not None and self._oneof.get(f.oneof) == name:
            del self._oneof[f.oneof]

    def Clear(self) -> None:
        self._v.clear()
        self._oneof.clear()

    def SetInParent(self) -> None:
        self._modified()

    def ListFields(self) -> List[Tuple[FieldDesc, Any]]:
        """The set fields, by field number: a field without presence at
        its default (an empty repeated or map too) is not listed."""
        out = []
        for f in _by_number(self.DESCRIPTOR):
            v = self._v.get(f.name)
            if v is None:
                continue
            if f.repeated:
                if v:
                    out.append((f, v))
            elif f.has_presence:
                if f.oneof is None or self._oneof.get(f.oneof) == f.name:
                    out.append((f, v))
            elif f.proto3_optional or not _is_zero(f, v):
                out.append((f, v))
        return out

    def CopyFrom(self, other: "Message") -> None:
        if type(other) is not type(self):
            raise TypeError(f"CopyFrom: expected {type(self).__name__}, got "
                            f"{type(other).__name__}")
        if other is self:
            return
        self.Clear()
        self.MergeFrom(other)
        self._modified()

    def MergeFrom(self, other: "Message") -> None:
        if type(other) is not type(self):
            raise TypeError(f"MergeFrom: expected {type(self).__name__}")
        for f, v in other.ListFields():
            if f.is_map:
                getattr(self, f.name).update(v)
            elif f.repeated:
                getattr(self, f.name).extend(v)
            elif f.type == TYPE_MESSAGE:
                cur = self._v.get(f.name)
                if cur is None or (f.oneof is not None
                                   and self._oneof.get(f.oneof) != f.name):
                    self._set_message(f, v)
                else:
                    cur.MergeFrom(v)
            else:
                self._set_scalar(f, v)
        if other._live:
            self._modified()

    def SerializeToString(self, deterministic: bool = True) -> bytes:
        out = bytearray()
        _encode(self, out)
        return bytes(out)

    @classmethod
    def FromString(cls, data: bytes) -> "Message":
        m = cls()
        mv = memoryview(bytes(data))
        _decode_into(m, mv, 0, len(mv), 0)
        return m

    def __eq__(self, other: Any) -> bool:
        if type(other) is not type(self):
            return NotImplemented
        a = [(f.number, _cmp_value(f, v)) for f, v in self.ListFields()]
        b = [(f.number, _cmp_value(f, v)) for f, v in other.ListFields()]
        return a == b

    __hash__ = None  # type: ignore[assignment]

    def __repr__(self) -> str:
        parts = [f"{f.name}={v!r}" for f, v in self.ListFields()]
        return f"{self.DESCRIPTOR.name}({', '.join(parts)})"



def _cmp_value(f: FieldDesc, v: Any) -> Any:
    if f.is_map:
        return dict(v)
    if f.repeated:
        return list(v)
    if f.type in (TYPE_FLOAT, TYPE_DOUBLE) and v != v:
        return ("nan", struct.pack("<d", v))
    return v


def _by_number(desc: MessageDesc) -> List[FieldDesc]:
    order = desc.__dict__.get("_order")
    if order is None:
        order = desc._order = sorted(desc.fields, key=lambda f: f.number)
    return order


def _field_property(f: FieldDesc) -> property:
    def get(self):
        return self._get(f)

    def set_(self, v):
        Message.__setattr__(self, f.name, v)

    return property(get, set_)


class EnumType:
    """An enum's names and numbers (``Name``, ``Value``), each value
    also an attribute."""

    def __init__(self, desc: EnumDesc) -> None:
        self.DESCRIPTOR = desc
        for n, v in desc.values:
            setattr(self, n, v)

    def Name(self, number: int) -> str:
        try:
            return self.DESCRIPTOR.values_by_number[number]
        except KeyError:
            raise ValueError(f"Enum {self.DESCRIPTOR.name} has no name "
                             f"defined for value {number!r}") from None

    def Value(self, name: str) -> int:
        try:
            return self.DESCRIPTOR.values_by_name[name]
        except KeyError:
            raise ValueError(f"Enum {self.DESCRIPTOR.name} has no value "
                             f"defined for name {name!r}") from None



def _make_class(desc: MessageDesc) -> type:
    ns: Dict[str, Any] = {"__slots__": (), "DESCRIPTOR": desc,
                          "__qualname__": desc.name}
    for f in desc.fields:
        ns[f.name] = _field_property(f)
    for en in desc.enum_types:
        ns[en.name] = EnumType(en)
        for n, v in en.values:
            ns.setdefault(n, v)
    cls = type(desc.name, (Message,), ns)
    desc.cls = cls
    for sub in desc.nested_types:
        type.__setattr__(cls, sub.name, _make_class(sub))
    return cls


class Module:
    """What `load` returns: the file's top-level message classes and
    enums by name (enum values too), ``DESCRIPTOR`` the `FileDesc`."""

    def __init__(self, fd: FileDesc) -> None:
        self.DESCRIPTOR = fd
        for m in fd.message_types:
            setattr(self, m.name, _make_class(m))
        for en in fd.enum_types:
            setattr(self, en.name, EnumType(en))
            for n, v in en.values:
                if not hasattr(self, n):
                    setattr(self, n, v)

    def message_types(self) -> Dict[str, type]:
        return {m.name: m.cls for m in self.DESCRIPTOR.message_types}


def load(text: str, name: str = "schema.proto") -> Module:
    """Parse ``text`` and build its message classes."""
    return Module(parse(text, name))


# ---------------------------------------------------------------- encoder

def _varint(out: bytearray, v: int) -> None:
    v &= 0xFFFFFFFFFFFFFFFF
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _scalar(out: bytearray, t: int, v: Any) -> None:
    if t in _VARINTS:
        if t == TYPE_SINT32 or t == TYPE_SINT64:
            v = (v << 1) ^ (v >> 63)
        _varint(out, int(v))
    elif t in _FMT:
        out += struct.pack(_FMT[t], v)
    else:
        b = v.encode("utf-8") if t == TYPE_STRING else v
        _varint(out, len(b))
        out += b


def _tag(out: bytearray, number: int, wt: int) -> None:
    _varint(out, (number << 3) | wt)


def _map_order(t: int, m: dict) -> List[Any]:
    """The keys in ``SerializeToString(deterministic=True)``'s order
    (upb's): strings by their UTF-8 bytes, a key before its own
    prefixes; integers and bools by their unsigned value, largest
    first."""
    if t == TYPE_STRING:
        def cmp(a: bytes, b: bytes) -> int:
            n = min(len(a), len(b))
            if a[:n] != b[:n]:
                return -1 if a[:n] < b[:n] else 1
            return len(b) - len(a)

        enc = {k: k.encode("utf-8") for k in m}
        return sorted(m, key=functools.cmp_to_key(
            lambda a, b: cmp(enc[a], enc[b])))
    bits = 32 if t in (TYPE_INT32, TYPE_SINT32, TYPE_SFIXED32, TYPE_UINT32,
                       TYPE_FIXED32) else 64
    mask = (1 << bits) - 1
    return sorted(m, key=lambda k: int(k) & mask, reverse=True)


def _sub(out: bytearray, number: int, m: Message) -> None:
    body = bytearray()
    _encode(m, body)
    _tag(out, number, WIRE_LEN)
    _varint(out, len(body))
    out += body


def _encode(m: Message, out: bytearray) -> None:
    for f, v in m.ListFields():
        n = f.number
        if f.is_map:
            kf, vf = f.message_type.fields_by_number[1], \
                f.message_type.fields_by_number[2]
            for k in _map_order(kf.type, v):
                entry = bytearray()
                _tag(entry, 1, _wire_type(kf.type))
                _scalar(entry, kf.type, k)
                if vf.type == TYPE_MESSAGE:
                    _sub(entry, 2, v[k])
                else:
                    _tag(entry, 2, _wire_type(vf.type))
                    _scalar(entry, vf.type, v[k])
                _tag(out, n, WIRE_LEN)
                _varint(out, len(entry))
                out += entry
        elif f.repeated:
            if f.type == TYPE_MESSAGE:
                for x in v:
                    _sub(out, n, x)
            elif f.is_packed:
                body = bytearray()
                for x in v:
                    _scalar(body, f.type, x)
                _tag(out, n, WIRE_LEN)
                _varint(out, len(body))
                out += body
            else:
                wt = _wire_type(f.type)
                for x in v:
                    _tag(out, n, wt)
                    _scalar(out, f.type, x)
        elif f.type == TYPE_MESSAGE:
            _sub(out, n, v)
        else:
            _tag(out, n, _wire_type(f.type))
            _scalar(out, f.type, v)


# ---------------------------------------------------------------- decoder

def _read_varint(buf: memoryview, pos: int, end: int) -> Tuple[int, int]:
    result = shift = 0
    for _ in range(10):
        if pos >= end:
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result & 0xFFFFFFFFFFFFFFFF, pos
        shift += 7
    raise DecodeError("varint longer than 10 bytes")


def _skip(buf: memoryview, pos: int, end: int, wt: int, number: int,
          depth: int) -> int:
    if wt == WIRE_VARINT:
        return _read_varint(buf, pos, end)[1]
    if wt == WIRE_I64:
        pos += 8
    elif wt == WIRE_I32:
        pos += 4
    elif wt == WIRE_LEN:
        n, pos = _read_varint(buf, pos, end)
        pos += n
    elif wt == WIRE_SGROUP:
        if depth > 100:
            raise DecodeError("groups nested too deep")
        while True:
            key, pos = _read_varint(buf, pos, end)
            if key & 7 == WIRE_EGROUP:
                if key >> 3 != number:
                    raise DecodeError("mismatched end-group tag")
                return pos
            if key >> 3 == 0:
                raise DecodeError("field number 0")
            pos = _skip(buf, pos, end, key & 7, key >> 3, depth + 1)
    else:
        raise DecodeError(f"invalid wire type {wt}")
    if pos > end:
        raise DecodeError("truncated field")
    return pos


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _read_scalar(buf: memoryview, pos: int, end: int,
                 t: int) -> Tuple[Any, int]:
    if t in _VARINTS:
        v, pos = _read_varint(buf, pos, end)
        if t == TYPE_INT32 or t == TYPE_ENUM:
            v = _signed(v, 32)
        elif t == TYPE_INT64:
            v = _signed(v, 64)
        elif t == TYPE_UINT32:
            v &= 0xFFFFFFFF
        elif t == TYPE_BOOL:
            v = v != 0
        elif t == TYPE_SINT32:
            v &= 0xFFFFFFFF
            v = (v >> 1) ^ -(v & 1)
        elif t == TYPE_SINT64:
            v = (v >> 1) ^ -(v & 1)
        return v, pos
    if t in _FMT:
        size = 4 if t in _FIXED32S else 8
        if pos + size > end:
            raise DecodeError("truncated fixed-width field")
        return struct.unpack_from(_FMT[t], buf, pos)[0], pos + size
    n, pos = _read_varint(buf, pos, end)
    if pos + n > end:
        raise DecodeError("truncated length-delimited field")
    raw = bytes(buf[pos:pos + n])
    if t == TYPE_STRING:
        try:
            return raw.decode("utf-8"), pos + n
        except UnicodeDecodeError as exc:
            raise DecodeError("string field is not valid UTF-8") from exc
    return raw, pos + n


def _decode_into(m: Message, buf: memoryview, pos: int, end: int,
                 depth: int) -> None:
    if depth > 100:
        raise DecodeError("messages nested too deep")
    desc = m.DESCRIPTOR
    byn = desc.fields_by_number
    while pos < end:
        key, pos = _read_varint(buf, pos, end)
        number, wt = key >> 3, key & 7
        if number == 0:
            raise DecodeError("field number 0")
        if wt == WIRE_EGROUP or wt > WIRE_I32:
            raise DecodeError(f"invalid wire type {wt}")
        f = byn.get(number)
        want = None if f is None else _wire_type(f.type)
        if f is None or not (wt == want or (
                f.repeated and wt == WIRE_LEN and want != WIRE_LEN)):
            pos = _skip(buf, pos, end, wt, number, depth)
            continue
        if f.type == TYPE_MESSAGE:
            n, pos = _read_varint(buf, pos, end)
            if pos + n > end:
                raise DecodeError("truncated submessage")
            if f.is_map:
                _decode_entry(m, f, buf, pos, pos + n, depth)
            elif f.repeated:
                c = f.message_type.cls()
                _decode_into(c, buf, pos, pos + n, depth + 1)
                list.append(m._get(f), c)
            else:
                cur = m._v.get(f.name)
                if cur is None or (f.oneof is not None and
                                   m._oneof.get(f.oneof) != f.name):
                    cur = f.message_type.cls()
                    m._attach(f.name, cur)
                _decode_into(cur, buf, pos, pos + n, depth + 1)
            pos += n
        elif f.repeated:
            lst = m._get(f)
            if wt == WIRE_LEN and want != WIRE_LEN:  # packed
                n, pos = _read_varint(buf, pos, end)
                stop = pos + n
                if stop > end:
                    raise DecodeError("truncated packed field")
                while pos < stop:
                    v, pos = _read_scalar(buf, pos, stop, f.type)
                    list.append(lst, v)
                if pos != stop:
                    raise DecodeError("packed field overruns its length")
            else:
                v, pos = _read_scalar(buf, pos, end, f.type)
                list.append(lst, v)
        else:
            v, pos = _read_scalar(buf, pos, end, f.type)
            if f.oneof is not None:
                m._switch_oneof(f)
            m._v[f.name] = v
    if pos != end:
        raise DecodeError("field overruns the message")


def _decode_entry(m: Message, f: FieldDesc, buf: memoryview, pos: int,
                  end: int, depth: int) -> None:
    entry = f.message_type
    kf, vf = entry.fields_by_number[1], entry.fields_by_number[2]
    key = _default(kf)
    val: Any = None
    while pos < end:
        tag, pos = _read_varint(buf, pos, end)
        number, wt = tag >> 3, tag & 7
        if number == 0:
            raise DecodeError("field number 0")
        if wt == WIRE_EGROUP or wt > WIRE_I32:
            raise DecodeError(f"invalid wire type {wt}")
        x = kf if number == 1 else vf if number == 2 else None
        if x is None or wt != _wire_type(x.type):
            pos = _skip(buf, pos, end, wt, number, depth)
            continue
        if x is vf and vf.type == TYPE_MESSAGE:
            n, pos = _read_varint(buf, pos, end)
            if pos + n > end:
                raise DecodeError("truncated map value")
            if val is None:
                val = vf.message_type.cls()
            _decode_into(val, buf, pos, pos + n, depth + 1)
            pos += n
        elif x is kf:
            key, pos = _read_scalar(buf, pos, end, kf.type)
        else:
            val, pos = _read_scalar(buf, pos, end, vf.type)
    if pos != end:
        raise DecodeError("map entry overruns its length")
    if val is None:
        val = vf.message_type.cls() if vf.type == TYPE_MESSAGE \
            else _default(vf)
    dict.__setitem__(m._get(f), key, val)


# ------------------------------------------------------------ JSON mapping

def _shortest_float(v: float) -> float:
    prec = 6
    r = float(f"{v:.{prec}g}")
    while _to_float32(r) != v:
        prec += 1
        r = float(f"{v:.{prec}g}")
    return r


def _json_value(f: FieldDesc, v: Any) -> Any:
    t = f.type
    if t == TYPE_MESSAGE:
        return to_dict(v)
    if t == TYPE_ENUM:
        name = f.enum_type.values_by_number.get(v)
        return v if name is None else name
    if t == TYPE_BYTES:
        return base64.b64encode(v).decode("ascii")
    if t in _INT64S:
        return str(v)
    if t in (TYPE_FLOAT, TYPE_DOUBLE):
        if math.isinf(v):
            return "Infinity" if v > 0 else "-Infinity"
        if math.isnan(v):
            return "NaN"
        return _shortest_float(v) if t == TYPE_FLOAT else v
    return v


def to_dict(m: Message) -> dict:
    """``json_format.MessageToDict(m, preserving_proto_field_name=True)``."""
    out: Dict[str, Any] = {}
    for f, v in m.ListFields():
        if f.is_map:
            vf = f.message_type.fields_by_number[2]
            out[f.name] = {
                ("true" if k else "false") if isinstance(k, bool) else str(k):
                _json_value(vf, x) for k, x in v.items()}
        elif f.repeated:
            out[f.name] = [_json_value(f, x) for x in v]
        else:
            out[f.name] = _json_value(f, v)
    return out


def _from_json_int(v: Any) -> int:
    if isinstance(v, float) and not v.is_integer():
        raise ParseError(f"Couldn't parse integer: {v}")
    if isinstance(v, str) and " " in v:
        raise ParseError(f'Couldn\'t parse integer: "{v}"')
    if isinstance(v, bool):
        raise ParseError(f"Bool value {v} is not acceptable for integer "
                         "field")
    try:
        return int(v)
    except ValueError as exc:
        try:  # an integer-valued float's text
            x = float(v)
        except ValueError:
            raise ParseError(f"Couldn't parse integer: {v!r}") from exc
        if not x.is_integer():
            raise ParseError(f'Couldn\'t parse non-integer string: "{v}"'
                             ) from exc
        return int(x)
    except TypeError as exc:
        raise ParseError(f"Couldn't parse integer: {v!r}") from exc


def _from_json_float(v: Any, f: FieldDesc) -> float:
    if isinstance(v, float):
        if math.isnan(v):
            raise ParseError('Couldn\'t parse NaN, use quoted "NaN" instead')
        if math.isinf(v):
            raise ParseError("Couldn't parse an infinity, use a quoted "
                             '"Infinity" or "-Infinity" instead')
        if f.type == TYPE_FLOAT and not -_FLOAT_MAX <= v <= _FLOAT_MAX:
            raise ParseError("Float value too large")
    if v == "nan":
        raise ParseError('Couldn\'t parse float "nan", use "NaN" instead')
    if isinstance(v, bool):
        return float(v)
    try:
        return float(v)
    except (ValueError, TypeError) as exc:
        if v == "-Infinity":
            return -math.inf
        if v == "Infinity":
            return math.inf
        if v == "NaN":
            return math.nan
        raise ParseError(f"Couldn't parse float: {v!r}") from exc


_SURROGATE = re.compile("[\ud800-\udfff]")


def _from_json_scalar(f: FieldDesc, v: Any, key: bool = False) -> Any:
    t = f.type
    if t in _INT_RANGE and t != TYPE_ENUM:
        return _from_json_int(v)
    if t in (TYPE_FLOAT, TYPE_DOUBLE):
        return _from_json_float(v, f)
    if t == TYPE_BOOL:
        if key:
            if v == "true":
                return True
            if v == "false":
                return False
            raise ParseError(f'Expected "true" or "false", not {v}')
        if not isinstance(v, bool):
            raise ParseError("Expected true or false without quotes")
        return v
    if t == TYPE_BYTES:
        raw = v.encode("utf-8") if isinstance(v, str) else v
        if not isinstance(raw, (bytes, bytearray)):
            raise ParseError(f"bytes field {f.name}: {v!r}")
        try:
            return base64.urlsafe_b64decode(
                bytes(raw) + b"=" * (4 - len(raw) % 4))
        except ValueError as exc:
            raise ParseError(f"bytes field {f.name}: {exc}") from exc
    if t == TYPE_STRING:
        if not isinstance(v, str):
            raise ParseError(f"string field {f.name}: {v!r}")
        if _SURROGATE.search(v):
            raise ParseError("Unpaired surrogate")
        return v
    if t == TYPE_ENUM:
        en = f.enum_type
        if isinstance(v, str) and v in en.values_by_name:
            return en.values_by_name[v]
        try:
            return int(v)
        except (ValueError, TypeError) as exc:
            raise ParseError(f"Invalid enum value {v} for enum type "
                             f"{en.full_name}") from exc
    raise ParseError(f"field {f.name}: {v!r}")


def from_dict(js: Any, m: Message) -> Message:
    """``json_format.ParseDict(js, m)``: ParseError for a value or name
    the message cannot take."""
    try:
        _from_dict(js, m, 0)
    except ParseError:
        raise
    except (ValueError, TypeError, AttributeError) as exc:
        raise ParseError(str(exc)) from exc
    return m


def _from_dict(js: Any, m: Message, depth: int) -> None:
    if depth > 100:
        raise ParseError("Message too deep")
    desc = m.DESCRIPTOR
    if not isinstance(js, dict):
        raise ParseError(f"{desc.full_name}: expected a JSON object, got "
                         f"{type(js).__name__}")
    by_json = {f.json_name: f for f in desc.fields}
    seen: List[str] = []
    for name, v in js.items():
        f = by_json.get(name) or desc.fields_by_name.get(name)
        if f is None:
            raise ParseError(f'Message type "{desc.full_name}" has no field '
                             f'named "{name}".')
        if name in seen:
            raise ParseError(f'Message type "{desc.full_name}" should not '
                             f'have multiple "{name}" fields.')
        seen.append(name)
        if f.oneof is not None and v is not None:
            if f.oneof in seen:
                raise ParseError(f'Message type "{desc.full_name}" should '
                                 f'not have multiple "{f.oneof}" oneof '
                                 'fields.')
            seen.append(f.oneof)
        if v is None:
            m.ClearField(f.name)
            continue
        if f.is_map:
            m.ClearField(f.name)
            if not isinstance(v, dict):
                raise ParseError(f"Map field {f.name} must be in a dict")
            kf = f.message_type.fields_by_number[1]
            vf = f.message_type.fields_by_number[2]
            target = getattr(m, f.name)
            for k, x in v.items():
                kv = _from_json_scalar(kf, k, key=True)
                if vf.type == TYPE_MESSAGE:
                    _from_dict(x, target[kv], depth + 1)
                else:
                    target[kv] = _from_json_scalar(vf, x)
        elif f.repeated:
            m.ClearField(f.name)
            if not isinstance(v, list):
                raise ParseError(f"repeated field {f.name} must be in []")
            target = getattr(m, f.name)
            for x in v:
                if x is None:
                    raise ParseError("null is not allowed to be used as an "
                                     "element in a repeated field")
                if f.type == TYPE_MESSAGE:
                    _from_dict(x, target.add(), depth + 1)
                else:
                    target.append(_from_json_scalar(f, x))
        elif f.type == TYPE_MESSAGE:
            sub = getattr(m, f.name)
            sub.SetInParent()
            _from_dict(v, sub, depth + 1)
        else:
            setattr(m, f.name, _from_json_scalar(f, v))
