"""MQTT 3.1 / 3.1.1 / 5.0 wire codec.

Functional parity with the reference's incremental parser/serializer
(EMQX apps/emqx/src/emqx_frame.erl:125-210 parse loop,
serialize_* emitters), re-designed as: immutable packet dataclasses, a
pull-free ``StreamParser`` that is fed byte chunks and yields complete
packets, and a pure ``serialize``.  Written from the OASIS MQTT 3.1.1 /
5.0 specifications.

The parser enforces a max remaining-length guard like the reference
(emqx_frame.erl:164-210) and carries the negotiated protocol version
(needed because v5 adds properties/reason codes to most packets).
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

# protocol versions (CONNECT 'Protocol Level' byte)
MQTT_V3 = 3  # MQIsdp, MQTT 3.1
MQTT_V4 = 4  # MQTT 3.1.1
MQTT_V5 = 5

# control packet types
CONNECT, CONNACK, PUBLISH, PUBACK, PUBREC, PUBREL, PUBCOMP = range(1, 8)
SUBSCRIBE, SUBACK, UNSUBSCRIBE, UNSUBACK, PINGREQ, PINGRESP = range(8, 14)
DISCONNECT, AUTH = 14, 15

MAX_PACKET_SIZE = 0xFFFFFFF  # max representable remaining length

# v5 reason codes used broker-side (full table in broker.reason_codes)
RC_SUCCESS = 0x00
RC_GRANTED_QOS_0, RC_GRANTED_QOS_1, RC_GRANTED_QOS_2 = 0x00, 0x01, 0x02
RC_NO_MATCHING_SUBSCRIBERS = 0x10
RC_UNSPECIFIED_ERROR = 0x80
RC_MALFORMED_PACKET = 0x81
RC_PROTOCOL_ERROR = 0x82


class MqttError(Exception):
    """Malformed frame / protocol violation detected by the codec."""

    def __init__(self, msg: str, reason_code: int = RC_MALFORMED_PACKET):
        super().__init__(msg)
        self.reason_code = reason_code


# ---------------------------------------------------------------------------
# properties (MQTT 5, spec §2.2.2)

# prop id -> (name, type); type in {byte,u16,u32,varint,utf8,bin,pair}
PROPERTIES: Dict[int, Tuple[str, str]] = {
    0x01: ("payload_format_indicator", "byte"),
    0x02: ("message_expiry_interval", "u32"),
    0x03: ("content_type", "utf8"),
    0x08: ("response_topic", "utf8"),
    0x09: ("correlation_data", "bin"),
    0x0B: ("subscription_identifier", "varint"),
    0x11: ("session_expiry_interval", "u32"),
    0x12: ("assigned_client_identifier", "utf8"),
    0x13: ("server_keep_alive", "u16"),
    0x15: ("authentication_method", "utf8"),
    0x16: ("authentication_data", "bin"),
    0x17: ("request_problem_information", "byte"),
    0x18: ("will_delay_interval", "u32"),
    0x19: ("request_response_information", "byte"),
    0x1A: ("response_information", "utf8"),
    0x1C: ("server_reference", "utf8"),
    0x1F: ("reason_string", "utf8"),
    0x21: ("receive_maximum", "u16"),
    0x22: ("topic_alias_maximum", "u16"),
    0x23: ("topic_alias", "u16"),
    0x24: ("maximum_qos", "byte"),
    0x25: ("retain_available", "byte"),
    0x26: ("user_property", "pair"),
    0x27: ("maximum_packet_size", "u32"),
    0x28: ("wildcard_subscription_available", "byte"),
    0x29: ("subscription_identifier_available", "byte"),
    0x2A: ("shared_subscription_available", "byte"),
}
_PROP_ID = {name: (pid, typ) for pid, (name, typ) in PROPERTIES.items()}
# properties that may repeat; collected into lists
_MULTI = {"user_property", "subscription_identifier"}

Properties = Dict[str, object]


# ---------------------------------------------------------------------------
# packet dataclasses


@dataclass
class Will:
    topic: str
    payload: bytes = b""
    qos: int = 0
    retain: bool = False
    properties: Properties = field(default_factory=dict)


@dataclass
class Connect:
    client_id: str = ""
    proto_ver: int = MQTT_V5
    proto_name: str = "MQTT"
    clean_start: bool = True
    keepalive: int = 60
    username: Optional[str] = None
    password: Optional[bytes] = None
    will: Optional[Will] = None
    properties: Properties = field(default_factory=dict)
    type: int = CONNECT


@dataclass
class Connack:
    session_present: bool = False
    reason_code: int = 0
    properties: Properties = field(default_factory=dict)
    type: int = CONNACK


@dataclass
class Publish:
    topic: str
    payload: bytes = b""
    qos: int = 0
    retain: bool = False
    dup: bool = False
    packet_id: Optional[int] = None
    properties: Properties = field(default_factory=dict)
    type: int = PUBLISH


@dataclass
class _PubAckLike:
    packet_id: int = 0
    reason_code: int = 0
    properties: Properties = field(default_factory=dict)


@dataclass
class Puback(_PubAckLike):
    type: int = PUBACK


@dataclass
class Pubrec(_PubAckLike):
    type: int = PUBREC


@dataclass
class Pubrel(_PubAckLike):
    type: int = PUBREL


@dataclass
class Pubcomp(_PubAckLike):
    type: int = PUBCOMP


@dataclass
class Subscription:
    topic_filter: str
    qos: int = 0
    no_local: bool = False
    retain_as_published: bool = False
    retain_handling: int = 0

    def opts_byte(self) -> int:
        return (
            (self.qos & 0x03)
            | (0x04 if self.no_local else 0)
            | (0x08 if self.retain_as_published else 0)
            | ((self.retain_handling & 0x03) << 4)
        )

    @classmethod
    def from_opts(cls, flt: str, opts: int) -> "Subscription":
        if opts & 0xC0:
            raise MqttError("reserved bits set in subscription options")
        return cls(
            topic_filter=flt,
            qos=opts & 0x03,
            no_local=bool(opts & 0x04),
            retain_as_published=bool(opts & 0x08),
            retain_handling=(opts >> 4) & 0x03,
        )


@dataclass
class Subscribe:
    packet_id: int
    subscriptions: List[Subscription]
    properties: Properties = field(default_factory=dict)
    type: int = SUBSCRIBE


@dataclass
class Suback:
    packet_id: int
    reason_codes: List[int]
    properties: Properties = field(default_factory=dict)
    type: int = SUBACK


@dataclass
class Unsubscribe:
    packet_id: int
    topic_filters: List[str]
    properties: Properties = field(default_factory=dict)
    type: int = UNSUBSCRIBE


@dataclass
class Unsuback:
    packet_id: int
    reason_codes: List[int] = field(default_factory=list)
    properties: Properties = field(default_factory=dict)
    type: int = UNSUBACK


@dataclass
class Pingreq:
    type: int = PINGREQ


@dataclass
class Pingresp:
    type: int = PINGRESP


@dataclass
class Disconnect:
    reason_code: int = 0
    properties: Properties = field(default_factory=dict)
    type: int = DISCONNECT


@dataclass
class Auth:
    reason_code: int = 0
    properties: Properties = field(default_factory=dict)
    type: int = AUTH


Packet = Union[
    Connect, Connack, Publish, Puback, Pubrec, Pubrel, Pubcomp,
    Subscribe, Suback, Unsubscribe, Unsuback, Pingreq, Pingresp,
    Disconnect, Auth,
]


# ---------------------------------------------------------------------------
# primitive readers over (buf, pos)


class _Reader:
    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf: bytes, pos: int = 0, end: Optional[int] = None):
        self.buf = buf
        self.pos = pos
        self.end = len(buf) if end is None else end

    def remaining(self) -> int:
        return self.end - self.pos

    def u8(self) -> int:
        self._need(1)
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u16(self) -> int:
        self._need(2)
        (v,) = struct.unpack_from(">H", self.buf, self.pos)
        self.pos += 2
        return v

    def u32(self) -> int:
        self._need(4)
        (v,) = struct.unpack_from(">I", self.buf, self.pos)
        self.pos += 4
        return v

    def varint(self) -> int:
        mult, val = 1, 0
        for _ in range(4):
            b = self.u8()
            val += (b & 0x7F) * mult
            if not b & 0x80:
                return val
            mult <<= 7
        raise MqttError("varint longer than 4 bytes")

    def bin(self) -> bytes:
        n = self.u16()
        self._need(n)
        v = self.buf[self.pos : self.pos + n]
        self.pos += n
        return bytes(v)

    def utf8(self) -> str:
        raw = self.bin()
        try:
            s = raw.decode("utf-8")
        except UnicodeDecodeError:
            raise MqttError("invalid UTF-8 string")
        if "\x00" in s:
            raise MqttError("NUL in UTF-8 string")
        return s

    def rest(self) -> bytes:
        v = bytes(self.buf[self.pos : self.end])
        self.pos = self.end
        return v

    def _need(self, n: int) -> None:
        if self.end - self.pos < n:
            raise MqttError("frame truncated")


def _read_properties(r: _Reader) -> Properties:
    total = r.varint()
    stop = r.pos + total
    if stop > r.end:
        raise MqttError("property length overruns frame")
    props: Properties = {}
    sub = _Reader(r.buf, r.pos, stop)
    while sub.pos < stop:
        pid = sub.varint()
        entry = PROPERTIES.get(pid)
        if entry is None:
            raise MqttError(f"unknown property id 0x{pid:02x}")
        name, typ = entry
        if typ == "byte":
            val: object = sub.u8()
        elif typ == "u16":
            val = sub.u16()
        elif typ == "u32":
            val = sub.u32()
        elif typ == "varint":
            val = sub.varint()
        elif typ == "utf8":
            val = sub.utf8()
        elif typ == "bin":
            val = sub.bin()
        else:  # pair
            val = (sub.utf8(), sub.utf8())
        if name in _MULTI:
            props.setdefault(name, []).append(val)  # type: ignore[union-attr]
        elif name in props:
            raise MqttError(f"duplicate property {name}")
        else:
            props[name] = val
    r.pos = stop
    return props


# ---------------------------------------------------------------------------
# primitive writers


def _varint(n: int) -> bytes:
    if n < 0 or n > MAX_PACKET_SIZE:
        raise MqttError("varint out of range")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _bin(b: bytes) -> bytes:
    if len(b) > 0xFFFF:
        raise MqttError("binary field too long")
    return struct.pack(">H", len(b)) + b


def _utf8(s: str) -> bytes:
    return _bin(s.encode("utf-8"))


def _write_properties(props: Properties) -> bytes:
    body = bytearray()
    for name, val in props.items():
        if name not in _PROP_ID:
            raise MqttError(f"unknown property {name}")
        pid, typ = _PROP_ID[name]
        vals = val if name in _MULTI else [val]
        for v in vals:  # type: ignore[union-attr]
            body += _varint(pid)
            if typ == "byte":
                body.append(int(v) & 0xFF)  # type: ignore[arg-type]
            elif typ == "u16":
                body += struct.pack(">H", v)
            elif typ == "u32":
                body += struct.pack(">I", v)
            elif typ == "varint":
                body += _varint(int(v))  # type: ignore[arg-type]
            elif typ == "utf8":
                body += _utf8(v)  # type: ignore[arg-type]
            elif typ == "bin":
                body += _bin(v)  # type: ignore[arg-type]
            else:
                k, s = v  # type: ignore[misc]
                body += _utf8(k) + _utf8(s)
    return _varint(len(body)) + bytes(body)


# ---------------------------------------------------------------------------
# parse (one complete frame body)


def _parse_connect(r: _Reader) -> Connect:
    proto_name = r.utf8()
    ver = r.u8()
    if (proto_name, ver) not in (("MQTT", 4), ("MQTT", 5), ("MQIsdp", 3)):
        raise MqttError(
            f"unsupported protocol {proto_name!r} v{ver}", 0x84
        )
    flags = r.u8()
    if flags & 0x01:
        raise MqttError("CONNECT reserved flag set")
    clean_start = bool(flags & 0x02)
    will_flag = bool(flags & 0x04)
    will_qos = (flags >> 3) & 0x03
    will_retain = bool(flags & 0x20)
    has_password = bool(flags & 0x40)
    has_username = bool(flags & 0x80)
    if not will_flag and (will_qos or will_retain):
        raise MqttError("will flags without will")
    if will_qos == 3:
        raise MqttError("will qos 3")
    if ver != MQTT_V5 and has_password and not has_username:
        raise MqttError("password without username")  # [MQTT-3.1.2-22]
    keepalive = r.u16()
    props: Properties = {}
    if ver == MQTT_V5:
        props = _read_properties(r)
    client_id = r.utf8()
    will = None
    if will_flag:
        wprops: Properties = {}
        if ver == MQTT_V5:
            wprops = _read_properties(r)
        wtopic = r.utf8()
        wpayload = r.bin()
        will = Will(wtopic, wpayload, will_qos, will_retain, wprops)
    username = r.utf8() if has_username else None
    password = r.bin() if has_password else None
    return Connect(
        client_id=client_id,
        proto_ver=ver,
        proto_name=proto_name,
        clean_start=clean_start,
        keepalive=keepalive,
        username=username,
        password=password,
        will=will,
        properties=props,
    )


def _parse_connack(r: _Reader, ver: int) -> Connack:
    ack = r.u8()
    if ack & 0xFE:
        raise MqttError("CONNACK reserved flags")
    rc = r.u8()
    props = _read_properties(r) if ver == MQTT_V5 else {}
    return Connack(session_present=bool(ack & 1), reason_code=rc, properties=props)


def _parse_publish(r: _Reader, flags: int, ver: int) -> Publish:
    qos = (flags >> 1) & 0x03
    if qos == 3:
        raise MqttError("PUBLISH qos 3")
    topic = r.utf8()
    pid = r.u16() if qos > 0 else None
    if pid == 0:
        raise MqttError("packet id 0")
    props = _read_properties(r) if ver == MQTT_V5 else {}
    return Publish(
        topic=topic,
        payload=r.rest(),
        qos=qos,
        retain=bool(flags & 0x01),
        dup=bool(flags & 0x08),
        packet_id=pid,
        properties=props,
    )


def _parse_puback_like(cls, r: _Reader, ver: int):
    pid = r.u16()
    rc, props = 0, {}
    if ver == MQTT_V5 and r.remaining():
        rc = r.u8()
        if r.remaining():
            props = _read_properties(r)
    return cls(packet_id=pid, reason_code=rc, properties=props)


def _parse_subscribe(r: _Reader, ver: int) -> Subscribe:
    pid = r.u16()
    props = _read_properties(r) if ver == MQTT_V5 else {}
    subs = []
    while r.remaining():
        flt = r.utf8()
        subs.append(Subscription.from_opts(flt, r.u8()))
    if not subs:
        raise MqttError("SUBSCRIBE with no filters", RC_PROTOCOL_ERROR)
    return Subscribe(packet_id=pid, subscriptions=subs, properties=props)


def _parse_suback(r: _Reader, ver: int) -> Suback:
    pid = r.u16()
    props = _read_properties(r) if ver == MQTT_V5 else {}
    return Suback(packet_id=pid, reason_codes=list(r.rest()), properties=props)


def _parse_unsubscribe(r: _Reader, ver: int) -> Unsubscribe:
    pid = r.u16()
    props = _read_properties(r) if ver == MQTT_V5 else {}
    filters = []
    while r.remaining():
        filters.append(r.utf8())
    if not filters:
        raise MqttError("UNSUBSCRIBE with no filters", RC_PROTOCOL_ERROR)
    return Unsubscribe(packet_id=pid, topic_filters=filters, properties=props)


def _parse_unsuback(r: _Reader, ver: int) -> Unsuback:
    pid = r.u16()
    props = _read_properties(r) if ver == MQTT_V5 else {}
    return Unsuback(packet_id=pid, reason_codes=list(r.rest()), properties=props)


def _parse_disconnect(r: _Reader, ver: int) -> Disconnect:
    rc, props = 0, {}
    if ver == MQTT_V5 and r.remaining():
        rc = r.u8()
        if r.remaining():
            props = _read_properties(r)
    return Disconnect(reason_code=rc, properties=props)


def _parse_auth(r: _Reader) -> Auth:
    rc, props = 0, {}
    if r.remaining():
        rc = r.u8()
        if r.remaining():
            props = _read_properties(r)
    return Auth(reason_code=rc, properties=props)


_FLAG_CHECK = {
    CONNECT: 0, CONNACK: 0, PUBACK: 0, PUBREC: 0, PUBCOMP: 0,
    PUBREL: 2, SUBSCRIBE: 2, SUBACK: 0, UNSUBSCRIBE: 2, UNSUBACK: 0,
    PINGREQ: 0, PINGRESP: 0, DISCONNECT: 0, AUTH: 0,
}


def _parse_publish_fast(body: bytes, flags: int, ver: int) -> Publish:
    """Inline decode of the overwhelmingly-common PUBLISH shape (no
    properties) — the broker's hottest parse.  Anything unusual falls
    back to the generic `_Reader` path, so semantics are identical."""
    qos = (flags >> 1) & 0x03
    if qos == 3:
        raise MqttError("PUBLISH qos 3")
    if len(body) < 2:
        raise MqttError("truncated packet")
    tl = (body[0] << 8) | body[1]
    pos = 2 + tl
    if len(body) < pos + (2 if qos else 0) + (1 if ver == MQTT_V5 else 0):
        raise MqttError("truncated packet")
    raw_topic = body[2:pos]
    try:
        topic = raw_topic.decode("utf-8")
    except UnicodeDecodeError:
        raise MqttError("invalid UTF-8 string")
    if "\x00" in topic:
        raise MqttError("NUL in UTF-8 string")
    pid = None
    if qos:
        pid = (body[pos] << 8) | body[pos + 1]
        if pid == 0:
            raise MqttError("packet id 0")
        pos += 2
    props: Properties = {}
    if ver == MQTT_V5:
        if body[pos] == 0:
            pos += 1
        else:  # non-empty properties: rare — take the generic path
            r = _Reader(body, pos)
            props = _read_properties(r)
            pos = r.pos
    return Publish(
        topic=topic,
        payload=body[pos:],
        qos=qos,
        retain=bool(flags & 0x01),
        dup=bool(flags & 0x08),
        packet_id=pid,
        properties=props,
    )


def parse_frame(ptype: int, flags: int, body: bytes, ver: int) -> Packet:
    """Parse one complete frame body (after the fixed header)."""
    if ptype == PUBLISH:
        return _parse_publish_fast(body, flags, ver)
    want = _FLAG_CHECK.get(ptype)
    if want is None:
        raise MqttError(f"invalid packet type {ptype}")
    if flags != want:
        raise MqttError(f"bad fixed-header flags for type {ptype}")
    if ptype == PUBACK and len(body) == 2:  # v3 shape / v5 rc omitted
        pid = (body[0] << 8) | body[1]
        return Puback(packet_id=pid)
    r = _Reader(body)
    if ptype == CONNECT:
        pkt: Packet = _parse_connect(r)
    elif ptype == CONNACK:
        pkt = _parse_connack(r, ver)
    elif ptype == PUBACK:
        pkt = _parse_puback_like(Puback, r, ver)
    elif ptype == PUBREC:
        pkt = _parse_puback_like(Pubrec, r, ver)
    elif ptype == PUBREL:
        pkt = _parse_puback_like(Pubrel, r, ver)
    elif ptype == PUBCOMP:
        pkt = _parse_puback_like(Pubcomp, r, ver)
    elif ptype == SUBSCRIBE:
        pkt = _parse_subscribe(r, ver)
    elif ptype == SUBACK:
        pkt = _parse_suback(r, ver)
    elif ptype == UNSUBSCRIBE:
        pkt = _parse_unsubscribe(r, ver)
    elif ptype == UNSUBACK:
        pkt = _parse_unsuback(r, ver)
    elif ptype == PINGREQ:
        pkt = Pingreq()
    elif ptype == PINGRESP:
        pkt = Pingresp()
    elif ptype == DISCONNECT:
        pkt = _parse_disconnect(r, ver)
    else:
        if ver != MQTT_V5:
            raise MqttError("AUTH before MQTT 5")
        pkt = _parse_auth(r)
    if ptype != PUBLISH and r.remaining():
        raise MqttError("trailing bytes in frame")
    return pkt


class StreamParser:
    """Incremental frame parser: feed byte chunks, iterate packets.

    Mirrors the reference's parse-state loop (emqx_frame.erl:125-210):
    buffers partial frames, decodes the varint remaining-length with the
    max-size guard, and parses each complete body.  The protocol version
    is locked in from the first CONNECT it sees (or set explicitly for
    client-side use)."""

    def __init__(self, max_packet_size: int = MAX_PACKET_SIZE + 5,
                 version: int = MQTT_V5):
        # max_packet_size bounds the WHOLE packet (fixed header included),
        # matching the MQTT 5 'Maximum Packet Size' property semantics;
        # default admits the largest representable frame.
        self._buf = bytearray()
        self._pos = 0
        self.max_packet_size = max_packet_size
        self.version = version

    def feed(self, data: bytes) -> Iterator[Packet]:
        # buffer eagerly (feed() must consume `data` even if the returned
        # iterator is never advanced), compact consumed prefix once per
        # feed rather than per frame
        if self._pos:
            del self._buf[: self._pos]
            self._pos = 0
        self._buf += data
        return self._drain()

    def _drain(self) -> Iterator[Packet]:
        while True:
            frame = self._try_frame()
            if frame is None:
                return
            ptype, flags, body = frame
            pkt = parse_frame(ptype, flags, body, self.version)
            if isinstance(pkt, Connect):
                self.version = pkt.proto_ver
            yield pkt

    def _try_frame(self) -> Optional[Tuple[int, int, bytes]]:
        buf, pos = self._buf, self._pos
        avail = len(buf) - pos
        if avail < 2:
            return None
        first = buf[pos]
        ptype, flags = first >> 4, first & 0x0F
        if ptype == 0:
            raise MqttError("packet type 0")
        # decode remaining length
        rlen, mult, i = 0, 1, 1
        while True:
            if i >= avail:
                if i > 4:
                    raise MqttError("remaining length too long")
                return None
            b = buf[pos + i]
            rlen += (b & 0x7F) * mult
            i += 1
            if not b & 0x80:
                break
            if i > 4:
                raise MqttError("remaining length too long")
            mult <<= 7
        if rlen + i > self.max_packet_size:
            raise MqttError("packet exceeds maximum size", 0x95)
        if avail < i + rlen:
            return None
        body = bytes(buf[pos + i : pos + i + rlen])
        self._pos = pos + i + rlen
        return ptype, flags, body


# ---------------------------------------------------------------------------
# serialize


def _ser_connect(p: Connect) -> Tuple[int, bytes]:
    ver = p.proto_ver
    flags = 0
    if p.clean_start:
        flags |= 0x02
    if p.will is not None:
        flags |= 0x04 | (p.will.qos << 3) | (0x20 if p.will.retain else 0)
    if p.password is not None:
        flags |= 0x40
    if p.username is not None:
        flags |= 0x80
    name = "MQIsdp" if ver == MQTT_V3 else "MQTT"
    body = _utf8(name) + bytes([ver, flags]) + struct.pack(">H", p.keepalive)
    if ver == MQTT_V5:
        body += _write_properties(p.properties)
    body += _utf8(p.client_id)
    if p.will is not None:
        if ver == MQTT_V5:
            body += _write_properties(p.will.properties)
        body += _utf8(p.will.topic) + _bin(p.will.payload)
    if p.username is not None:
        body += _utf8(p.username)
    if p.password is not None:
        body += _bin(p.password)
    return 0, body


def _ser_connack(p: Connack, ver: int) -> Tuple[int, bytes]:
    body = bytes([1 if p.session_present else 0, p.reason_code])
    if ver == MQTT_V5:
        body += _write_properties(p.properties)
    return 0, body


def _ser_publish(p: Publish, ver: int) -> Tuple[int, bytes]:
    if p.qos not in (0, 1, 2):
        raise MqttError("bad qos")
    flags = (0x08 if p.dup else 0) | (p.qos << 1) | (0x01 if p.retain else 0)
    body = _utf8(p.topic)
    if p.qos > 0:
        if not p.packet_id:
            raise MqttError("qos>0 publish without packet id")
        body += struct.pack(">H", p.packet_id)
    if ver == MQTT_V5:
        body += _write_properties(p.properties)
    return flags, body + p.payload


def _ser_puback_like(p, ver: int) -> Tuple[int, bytes]:
    flags = 2 if p.type == PUBREL else 0
    body = struct.pack(">H", p.packet_id)
    if ver == MQTT_V5 and (p.reason_code or p.properties):
        body += bytes([p.reason_code])
        if p.properties:
            body += _write_properties(p.properties)
    return flags, body


def _ser_subscribe(p: Subscribe, ver: int) -> Tuple[int, bytes]:
    body = struct.pack(">H", p.packet_id)
    if ver == MQTT_V5:
        body += _write_properties(p.properties)
    for s in p.subscriptions:
        opts = s.opts_byte() if ver == MQTT_V5 else (s.qos & 0x03)
        body += _utf8(s.topic_filter) + bytes([opts])
    return 2, body


def _ser_suback(p: Suback, ver: int) -> Tuple[int, bytes]:
    body = struct.pack(">H", p.packet_id)
    if ver == MQTT_V5:
        body += _write_properties(p.properties)
    return 0, body + bytes(p.reason_codes)


def _ser_unsubscribe(p: Unsubscribe, ver: int) -> Tuple[int, bytes]:
    body = struct.pack(">H", p.packet_id)
    if ver == MQTT_V5:
        body += _write_properties(p.properties)
    for f in p.topic_filters:
        body += _utf8(f)
    return 2, body


def _ser_unsuback(p: Unsuback, ver: int) -> Tuple[int, bytes]:
    body = struct.pack(">H", p.packet_id)
    if ver == MQTT_V5:
        body += _write_properties(p.properties) + bytes(p.reason_codes)
    return 0, body


def _ser_disconnect(p: Disconnect, ver: int) -> Tuple[int, bytes]:
    if ver != MQTT_V5:
        return 0, b""
    if not p.reason_code and not p.properties:
        return 0, b""
    body = bytes([p.reason_code])
    if p.properties:
        body += _write_properties(p.properties)
    return 0, body


def _ser_auth(p: Auth) -> Tuple[int, bytes]:
    if not p.reason_code and not p.properties:
        return 0, b""
    return 0, bytes([p.reason_code]) + _write_properties(p.properties)


def serialize(pkt: Packet, version: int = MQTT_V5) -> bytes:
    """Serialize a packet for the given negotiated protocol version."""
    wire = getattr(pkt, "_wire", None)
    if wire is not None and wire[0] == version:
        # pre-rendered by a DispatchEncoder (single-encode fan-out):
        # the frame was built once for this version and patched per
        # subscriber — bit-identical to the re-encode below
        return wire[1]
    t = pkt.type
    if t == PUBLISH and not pkt.properties:
        # hot path: a handful of C-level joins, no per-byte Python work
        qos = pkt.qos
        if qos not in (0, 1, 2):
            raise MqttError("bad qos")
        flags = (0x08 if pkt.dup else 0) | (qos << 1) | (
            0x01 if pkt.retain else 0
        )
        topic = pkt.topic.encode("utf-8")
        tl = len(topic)
        if tl > 65535:
            raise MqttError("string too long")
        if qos:
            if not pkt.packet_id:
                raise MqttError("qos>0 publish without packet id")
            mid = struct.pack(">H", pkt.packet_id)
        else:
            mid = b""
        tail = (b"\x00" + pkt.payload if version == MQTT_V5
                else pkt.payload)
        rlen = 2 + tl + len(mid) + len(tail)
        if rlen < 128:  # 1-byte varint: the common frame
            return b"".join((
                struct.pack(">BBH", (PUBLISH << 4) | flags, rlen, tl),
                topic, mid, tail,
            ))
        return b"".join((
            bytes(((PUBLISH << 4) | flags,)), _varint(rlen),
            struct.pack(">H", tl), topic, mid, tail,
        ))
    if t == PUBACK and not pkt.reason_code and not pkt.properties:
        pid = pkt.packet_id
        return bytes((PUBACK << 4, 2, pid >> 8, pid & 0xFF))
    if t == CONNECT:
        flags, body = _ser_connect(pkt)  # version taken from the packet
    elif t == CONNACK:
        flags, body = _ser_connack(pkt, version)
    elif t == PUBLISH:
        flags, body = _ser_publish(pkt, version)
    elif t in (PUBACK, PUBREC, PUBREL, PUBCOMP):
        flags, body = _ser_puback_like(pkt, version)
    elif t == SUBSCRIBE:
        flags, body = _ser_subscribe(pkt, version)
    elif t == SUBACK:
        flags, body = _ser_suback(pkt, version)
    elif t == UNSUBSCRIBE:
        flags, body = _ser_unsubscribe(pkt, version)
    elif t == UNSUBACK:
        flags, body = _ser_unsuback(pkt, version)
    elif t == PINGREQ or t == PINGRESP:
        flags, body = 0, b""
    elif t == DISCONNECT:
        flags, body = _ser_disconnect(pkt, version)
    elif t == AUTH:
        flags, body = _ser_auth(pkt)
    else:
        raise MqttError(f"cannot serialize {pkt!r}")
    return bytes([(t << 4) | flags]) + _varint(len(body)) + body


# ---------------------------------------------------------------------------
# single-encode fan-out

_PID_STRUCT = struct.Struct(">H")


class Raw:
    """Pre-assembled wire bytes riding the packet pipeline: one blob
    carries a whole delivery run (the native window assembly), and
    `serialize` returns it verbatim through the ``_wire`` contract.
    ``n_packets`` keeps packet counts honest (one blob = many
    PUBLISHes); ``type`` is the reserved packet type 0, so per-packet
    loops never take it for a PUBLISH."""

    __slots__ = ("_wire", "n_packets")
    type = 0
    qos = 0

    def __init__(self, data, version: int, n_packets: int) -> None:
        self._wire = (version, data)
        self.n_packets = n_packets


class DispatchEncoder:
    """Window-scoped encode-once cache for PUBLISH fan-out.

    Serializes each unique (message, effective QoS, retain, version)
    body once per window.  Two ways out:

      * packets whose ``_wire`` attribute carries the pre-rendered
        frame (`serialize` returns it verbatim when the negotiated
        version matches) — the per-delivery path: QoS 0 shares one
        ``Publish`` and one frame between subscribers; QoS > 0 splits
        the frame around the packet-id slot into shared ``memoryview``
        segments and patches only the packet id per subscriber;
      * an **arena** for the native window assembly
        (`ops.dispatchasm`): every unique body's frame appended to one
        bytearray, with per-body head/tail span tables around the
        2-byte packet-id slot (``slot_for``, ``key_slots``,
        ``span_arrays``, ``native_views``).

    Only the standard delivery shape qualifies (no per-subscriber
    subscription identifier); anything else takes the normal
    per-packet encode, so the wire is identical either way.  The cache
    keys on ``id(msg)``: the encoder must not outlive its dispatch
    window (messages do)."""

    __slots__ = ("_parts", "_q0", "arena", "slot_index", "head_lens",
                 "tail_lens", "_head_off", "_tail_off", "_span_np",
                 "_span_ptrs", "_arena_export", "_key_tbl")

    def __init__(self) -> None:
        self._parts: Dict[Tuple, Tuple] = {}
        self._q0: Dict[Tuple, Publish] = {}
        # the arena and its span tables (slot = list index);
        # slot_index: (id(msg), qos, retain, version) -> slot
        self.arena = bytearray()
        self.slot_index: Dict[Tuple, int] = {}
        self.head_lens: List[int] = []
        self.tail_lens: List[int] = []
        self._head_off: List[int] = []
        self._tail_off: List[int] = []
        self._span_np: Optional[Tuple] = None
        self._span_ptrs: Optional[Tuple] = None
        self._arena_export = None  # the pinned ctypes view of the arena
        # version -> numpy body-key -> slot table (key = msg_idx * 6 +
        # effective_qos * 2 + retain), the vectorized front of slot_for
        self._key_tbl: Dict[int, np.ndarray] = {}

    @staticmethod
    def _frame(msg, qos: int, retain: bool, version: int):
        """``(props, wire, head_len)``: the serialized PUBLISH (packet
        id 1 as a placeholder when qos > 0) and the length of the head
        before its packet-id slot (QoS 0: the whole frame)."""
        props: Properties = dict(msg.properties)
        left = msg.remaining_expiry()
        if left is not None:
            props["message_expiry_interval"] = left  # [MQTT-3.3.2-6]
        wire = serialize(
            Publish(
                topic=msg.topic,
                payload=msg.payload,
                qos=qos,
                retain=retain,
                packet_id=1 if qos else None,
                properties=props,
            ),
            version,
        )
        if qos == 0:
            return props, wire, len(wire)
        i = 1  # skip fixed header byte + remaining-length varint
        while wire[i] & 0x80:
            i += 1
        return props, wire, i + 1 + 2 + len(msg.topic.encode("utf-8"))

    # ------------------------------------------- native window assembly

    def slot_for(self, msg, qos: int, retain: bool, version: int) -> int:
        """Arena slot for one unique body: serialize once, append the
        frame to the arena, and record the head/tail spans around the
        packet-id slot."""
        key = (id(msg), qos, retain, version)
        s = self.slot_index.get(key)
        if s is None:
            _props, wire, hl = self._frame(msg, qos, retain, version)
            # release the pinned ctypes export BEFORE growing the
            # arena (a live export blocks bytearray resizing)
            self._arena_export = None
            off = len(self.arena)
            self.arena += wire
            if qos == 0:
                to, tl = 0, 0
            else:
                to, tl = off + hl + 2, len(wire) - hl - 2
            s = len(self._head_off)
            self._head_off.append(off)
            self.head_lens.append(hl)
            self._tail_off.append(to)
            self.tail_lens.append(tl)
            self._span_np = None
            self._span_ptrs = None
            self.slot_index[key] = s
        return s

    def key_slots(self, msgs, version: int, keys: np.ndarray) -> np.ndarray:
        """Arena slots of one run's body keys (``msg_idx * 6 +
        effective_qos * 2 + retain``): one table gather for the bodies
        the window already encoded, `slot_for` only for new ones.
        Returns the int64 ``body`` column."""
        tbl = self._key_tbl.get(version)
        need = 6 * len(msgs)
        if tbl is None or len(tbl) < need:
            tbl = self._key_tbl[version] = np.full(need, -1, np.int64)
        body = tbl[keys]
        if len(body) and body.min() < 0:
            for key in np.unique(keys[body < 0]).tolist():
                i, qr = divmod(key, 6)
                qos, retain = divmod(qr, 2)
                tbl[key] = self.slot_for(msgs[i], qos, bool(retain),
                                         version)
            body = tbl[keys]
        return body

    def span_arrays(self) -> Tuple:
        """``(head_off, head_len, tail_off, tail_len)`` as int64 arrays
        (rebuilt after new slots), indexed by a ``body`` column."""
        a = self._span_np
        if a is None:
            a = self._span_np = tuple(
                np.asarray(x, np.int64) for x in (
                    self._head_off, self.head_lens, self._tail_off,
                    self.tail_lens))
        return a

    def native_views(self) -> Tuple:
        """``(arena, head_off, head_len, tail_off, tail_len)`` as ctypes
        pointers for the native splice, cached until the next new slot
        (which releases the arena's export before it grows the
        arena)."""
        ptrs = self._span_ptrs
        if ptrs is None:
            i64p = ctypes.POINTER(ctypes.c_int64)
            ptrs = self._span_ptrs = tuple(
                a.ctypes.data_as(i64p) for a in self.span_arrays())
        if self._arena_export is None and self.arena:
            self._arena_export = (
                ctypes.c_uint8 * len(self.arena)).from_buffer(self.arena)
        return (self._arena_export,) + ptrs

    # -------------------------------------------- per-delivery packets

    def _parts_for(self, msg, qos: int, retain: bool, version: int):
        key = (id(msg), qos, retain, version)
        entry = self._parts.get(key)
        if entry is None:
            props, wire, hl = self._frame(msg, qos, retain, version)
            if qos == 0:
                entry = (props, wire, b"")
            else:
                mv = memoryview(wire)
                entry = (props, mv[:hl], mv[hl + 2:])
            self._parts[key] = entry
        return entry

    def publish_qos0(self, msg, retain: bool, version: int) -> Publish:
        key = (id(msg), retain, version)
        pkt = self._q0.get(key)
        if pkt is None:
            props, wire, _ = self._parts_for(msg, 0, retain, version)
            pkt = Publish(
                topic=msg.topic, payload=msg.payload, qos=0,
                retain=retain, properties=props,
            )
            pkt._wire = (version, wire)  # type: ignore[attr-defined]
            self._q0[key] = pkt
        return pkt

    def publish(self, msg, qos: int, retain: bool, pid: int,
                version: int) -> Publish:
        props, head, tail = self._parts_for(msg, qos, retain, version)
        pkt = Publish(
            topic=msg.topic, payload=msg.payload, qos=qos,
            retain=retain, packet_id=pid, properties=props,
        )
        pkt._wire = (  # type: ignore[attr-defined]
            version, b"".join((head, _PID_STRUCT.pack(pid), tail))
        )
        return pkt
