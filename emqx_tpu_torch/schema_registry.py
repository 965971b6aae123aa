"""Schema registry: named payload schemas for validation, decode, and
encode across the rule pipeline.

A port of the JAX package's ``schema_registry.py``, EMQX's
`emqx_schema_registry` role (apps/emqx_schema_registry/src/
emqx_schema_registry.erl: named avro / protobuf / json-schema entries
the rule engine's schema_decode/schema_encode functions resolve by
name).

  * json  — JSON Schema (Draft 2020-12), through the port's own
    validator (`json_schema.Validator`: ``jsonschema``'s verdicts on the
    keywords it implements; the others raise at ``add``).
  * protobuf — the schema SOURCE (.proto text) is compiled at
    registration by the port's proto3 parser (`protobuf.py`); messages
    decode/encode through its codec and JSON mapping.
  * avro — binary (single-object) encoding against a record schema,
    implemented directly (the spec's zig-zag varints + length-prefixed
    bytes); covers the primitive types plus records, arrays, maps,
    unions-with-null, and enums — the shapes IoT payload schemas use.

Nothing here needs ``protoc``, ``google.protobuf`` or ``jsonschema``.
"""

from __future__ import annotations

import io
import json
import logging
import os
import struct
from typing import Any, Dict, List, Optional, Tuple

from . import json_schema

log = logging.getLogger("emqx_tpu_torch.schema_registry")


# ------------------------------------------------------------- avro

def _zigzag_encode(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _zigzag_decode(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _write_long(out: io.BytesIO, n: int) -> None:
    n = _zigzag_encode(n)
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            return


def _read_long(buf: io.BytesIO) -> int:
    shift = 0
    acc = 0
    while True:
        raw = buf.read(1)
        if not raw:
            raise ValueError("truncated avro varint")
        b = raw[0]
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            return _zigzag_decode(acc)
        shift += 7
        if shift > 70:
            raise ValueError("avro varint too long")


class AvroSchema:
    """Avro binary codec for one parsed schema (no container files —
    the registry's payloads are raw datum bytes, as EMQX's
    schema_decode handles)."""

    _PRIMITIVES = {"null", "boolean", "int", "long", "float",
                   "double", "bytes", "string"}

    def __init__(self, schema: Any) -> None:
        self.schema = schema
        self._named: Dict[str, Any] = {}
        self._index_names(schema)
        self._check(schema)  # structural errors surface at REGISTRATION

    def _check(self, s: Any) -> None:
        s = self._resolve(s)
        if isinstance(s, list):
            for branch in s:
                self._check(branch)
            return
        t = s.get("type") if isinstance(s, dict) else s
        if t in self._PRIMITIVES:
            return
        if t == "record":
            fields = s.get("fields")
            if not isinstance(fields, list):
                raise ValueError("record schema needs a 'fields' list")
            for f in fields:
                if "name" not in f or "type" not in f:
                    raise ValueError(f"bad record field: {f!r}")
                self._check(f["type"])
        elif t == "enum":
            if not s.get("symbols"):
                raise ValueError("enum schema needs 'symbols'")
        elif t == "fixed":
            if not isinstance(s.get("size"), int):
                raise ValueError("fixed schema needs an int 'size'")
        elif t == "array":
            if "items" not in s:
                raise ValueError("array schema needs 'items'")
            self._check(s["items"])
        elif t == "map":
            if "values" not in s:
                raise ValueError("map schema needs 'values'")
            self._check(s["values"])
        else:
            raise ValueError(f"unsupported avro type: {t!r}")

    def _index_names(self, s: Any) -> None:
        if isinstance(s, dict):
            if s.get("type") in ("record", "enum", "fixed") and "name" in s:
                self._named[s["name"]] = s
            for v in s.values():
                self._index_names(v)
        elif isinstance(s, list):
            for v in s:
                self._index_names(v)

    def _resolve(self, s: Any) -> Any:
        if isinstance(s, str) and s in self._named:
            return self._named[s]
        return s

    # ------------------------------------------------------- decode

    def decode(self, data: bytes) -> Any:
        buf = io.BytesIO(data)
        out = self._read(self.schema, buf)
        return out

    def _read(self, s: Any, buf: io.BytesIO) -> Any:
        s = self._resolve(s)
        if isinstance(s, list):  # union: long index then value
            idx = _read_long(buf)
            if not 0 <= idx < len(s):
                raise ValueError(f"bad union index {idx}")
            return self._read(s[idx], buf)
        t = s["type"] if isinstance(s, dict) else s
        if t == "null":
            return None
        if t == "boolean":
            raw = buf.read(1)
            if not raw:
                raise ValueError("truncated boolean")
            return raw[0] != 0
        if t in ("int", "long"):
            return _read_long(buf)
        if t == "float":
            raw = buf.read(4)
            if len(raw) != 4:
                raise ValueError("truncated float")
            return struct.unpack("<f", raw)[0]
        if t == "double":
            raw = buf.read(8)
            if len(raw) != 8:
                raise ValueError("truncated double")
            return struct.unpack("<d", raw)[0]
        if t in ("bytes", "string"):
            n = _read_long(buf)
            if n < 0:
                raise ValueError("negative length")
            raw = buf.read(n)
            if len(raw) != n:
                raise ValueError("truncated bytes/string")
            return raw.decode() if t == "string" else raw
        if t == "enum":
            idx = _read_long(buf)
            symbols = s["symbols"]
            if not 0 <= idx < len(symbols):
                raise ValueError(f"bad enum index {idx}")
            return symbols[idx]
        if t == "fixed":
            size = int(s["size"])
            raw = buf.read(size)
            if len(raw) != size:
                raise ValueError("truncated fixed")
            return raw
        if t == "array":
            out = []
            while True:
                n = _read_long(buf)
                if n == 0:
                    return out
                if n < 0:  # block with byte size: skip the size
                    n = -n
                    _read_long(buf)
                for _ in range(n):
                    out.append(self._read(s["items"], buf))
        if t == "map":
            out = {}
            while True:
                n = _read_long(buf)
                if n == 0:
                    return out
                if n < 0:
                    n = -n
                    _read_long(buf)
                for _ in range(n):
                    k = self._read("string", buf)
                    out[k] = self._read(s["values"], buf)
        if t == "record":
            return {
                f["name"]: self._read(f["type"], buf)
                for f in s["fields"]
            }
        raise ValueError(f"unsupported avro type: {t!r}")

    # ------------------------------------------------------- encode

    def encode(self, value: Any) -> bytes:
        out = io.BytesIO()
        self._write(self.schema, value, out)
        return out.getvalue()

    def _write(self, s: Any, v: Any, out: io.BytesIO) -> None:
        s = self._resolve(s)
        if isinstance(s, list):  # union: pick the first matching branch
            for i, branch in enumerate(s):
                if self._matches(branch, v):
                    _write_long(out, i)
                    self._write(branch, v, out)
                    return
            raise ValueError(f"value fits no union branch: {v!r}")
        t = s["type"] if isinstance(s, dict) else s
        if t == "null":
            return
        if t == "boolean":
            out.write(b"\x01" if v else b"\x00")
        elif t in ("int", "long"):
            _write_long(out, int(v))
        elif t == "float":
            out.write(struct.pack("<f", float(v)))
        elif t == "double":
            out.write(struct.pack("<d", float(v)))
        elif t == "string":
            raw = str(v).encode()
            _write_long(out, len(raw))
            out.write(raw)
        elif t == "bytes":
            raw = bytes(v)
            _write_long(out, len(raw))
            out.write(raw)
        elif t == "enum":
            _write_long(out, s["symbols"].index(v))
        elif t == "fixed":
            out.write(bytes(v))
        elif t == "array":
            items = list(v)
            if items:
                _write_long(out, len(items))
                for item in items:
                    self._write(s["items"], item, out)
            _write_long(out, 0)
        elif t == "map":
            entries = dict(v)
            if entries:
                _write_long(out, len(entries))
                for k, val in entries.items():
                    self._write("string", k, out)
                    self._write(s["values"], val, out)
            _write_long(out, 0)
        elif t == "record":
            for f in s["fields"]:
                if f["name"] not in v and "default" not in f:
                    raise ValueError(f"missing field {f['name']!r}")
                self._write(
                    f["type"], v.get(f["name"], f.get("default")), out
                )
        else:
            raise ValueError(f"unsupported avro type: {t!r}")

    def _matches(self, s: Any, v: Any) -> bool:
        s = self._resolve(s)
        t = s["type"] if isinstance(s, dict) else s
        if t == "null":
            return v is None
        if t == "boolean":
            return isinstance(v, bool)
        if t in ("int", "long"):
            return isinstance(v, int) and not isinstance(v, bool)
        if t in ("float", "double"):
            return isinstance(v, (int, float)) and not isinstance(v, bool)
        if t == "string":
            return isinstance(v, str)
        if t in ("bytes", "fixed"):
            return isinstance(v, (bytes, bytearray))
        if t == "enum":
            return v in s.get("symbols", ())
        if t == "array":
            return isinstance(v, list)
        if t in ("map", "record"):
            return isinstance(v, dict)
        return False


# --------------------------------------------------------- protobuf

class ProtobufSchema:
    """Compile a .proto source with the port's proto3 parser
    (`protobuf.load`: no protoc, no ``google.protobuf``) and serve
    message decode/encode by top-level message-type name, through the
    JSON mapping (``json_format``'s, with proto field names)."""

    def __init__(self, source: str) -> None:
        from . import protobuf

        self.source = source
        try:
            module = protobuf.load(source, "schema.proto")
        except ValueError as exc:
            raise ValueError(
                f"the proto3 parser rejected the schema: {exc}") from exc
        self._messages: Dict[str, Any] = module.message_types()

    def message_types(self) -> List[str]:
        return sorted(self._messages)

    def decode(self, data: bytes, message_type: str) -> Dict:
        from . import protobuf

        cls = self._messages.get(message_type)
        if cls is None:
            raise ValueError(f"unknown message type {message_type!r}")
        return protobuf.to_dict(cls.FromString(data))

    def encode(self, value: Dict, message_type: str) -> bytes:
        from . import protobuf

        cls = self._messages.get(message_type)
        if cls is None:
            raise ValueError(f"unknown message type {message_type!r}")
        return protobuf.from_dict(value, cls()).SerializeToString()


# ---------------------------------------------------------- registry

class SchemaRegistry:
    """Named schemas; the rule-engine functions `schema_decode`/
    `schema_encode`/`schema_check` resolve entries here."""

    def __init__(self, persist_path: Optional[str] = None) -> None:
        self._schemas: Dict[str, Tuple[str, Any, Any]] = {}
        self.persist_path = persist_path

    def load(self, path: str) -> None:
        """Attach persistence and re-register entries saved there."""
        self.persist_path = path
        try:
            with open(path) as f:
                saved = json.load(f)
        except (OSError, json.JSONDecodeError):
            return
        for name, entry in saved.items():
            try:
                self.add(name, entry["type"], entry["source"])
            except Exception:
                log.exception("saved schema %r failed to load", name)

    def _persist(self) -> None:
        if self.persist_path is None:
            return
        try:
            tmp = self.persist_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.dump(), f, indent=1)
            os.replace(tmp, self.persist_path)
        except OSError:
            log.exception("schema registry persist failed")

    def dump(self) -> Dict[str, Dict]:
        """Name -> {type, source} (the backup/persistence shape)."""
        return {
            n: {"type": k, "source": src}
            for n, (k, _e, src) in self._schemas.items()
        }

    def add(self, name: str, schema_type: str, source) -> None:
        """Register (replaces an existing name).  ``source``: parsed
        JSON schema (json/avro) or .proto text (protobuf)."""
        if schema_type == "avro":
            if isinstance(source, str):
                source = json.loads(source)
            entry: Any = AvroSchema(source)
        elif schema_type == "protobuf":
            entry = ProtobufSchema(str(source))
        elif schema_type == "json":
            if isinstance(source, str):
                source = json.loads(source)
            entry = json_schema.Validator(source)
        else:
            raise ValueError(f"unknown schema type {schema_type!r}")
        self._schemas[name] = (schema_type, entry, source)
        self._persist()

    def remove(self, name: str) -> bool:
        ok = self._schemas.pop(name, None) is not None
        if ok:
            self._persist()
        return ok

    def get(self, name: str) -> Optional[Tuple[str, Any, Any]]:
        return self._schemas.get(name)

    def decode(self, name: str, data: bytes,
               message_type: Optional[str] = None) -> Any:
        kind, entry = self._require(name)
        if kind == "avro":
            return entry.decode(data)
        if kind == "protobuf":
            if message_type is None:
                types = entry.message_types()
                if len(types) != 1:
                    raise ValueError(
                        f"schema {name!r} has {len(types)} message "
                        "types; pass one explicitly"
                    )
                message_type = types[0]
            return entry.decode(data, message_type)
        value = json.loads(data)
        entry.validate(value)  # raises on schema violation
        return value

    def encode(self, name: str, value: Any,
               message_type: Optional[str] = None) -> bytes:
        kind, entry = self._require(name)
        if kind == "avro":
            return entry.encode(value)
        if kind == "protobuf":
            if message_type is None:
                types = entry.message_types()
                if len(types) != 1:
                    raise ValueError(
                        f"schema {name!r} has {len(types)} message "
                        "types; pass one explicitly"
                    )
                message_type = types[0]
            return entry.encode(value, message_type)
        return json.dumps(value, separators=(",", ":")).encode()

    def check(self, name: str, data: bytes) -> bool:
        """Does the payload parse under the schema (the validation
        hook's question)?"""
        try:
            self.decode(name, data)
            return True
        except Exception:
            return False

    def _require(self, name: str) -> Tuple[str, Any]:
        entry = self._schemas.get(name)
        if entry is None:
            raise ValueError(f"unknown schema {name!r}")
        return entry[0], entry[1]

    def info(self) -> List[Dict]:
        return [
            {"name": n, "type": k}
            for n, (k, _e, _s) in self._schemas.items()
        ]


# the node-global registry (EMQX keeps ONE schema table per node; rule
# functions resolve names against it)
_global: Optional[SchemaRegistry] = None


def global_registry() -> SchemaRegistry:
    global _global
    if _global is None:
        _global = SchemaRegistry()
    return _global
