"""WebSocket transport for MQTT-over-WebSocket listeners (RFC 6455,
server side), on asyncio streams.

The `Connection` loop only needs a byte stream: `server_handshake`
performs the HTTP upgrade (echoing the ``mqtt`` subprotocol,
[MQTT-6.0.0-3]), then `WsServerStream` adapts frames: inbound masked
binary and continuation frames unmask and concatenate into the MQTT
byte stream, outbound writes go out as unmasked binary frames; a ping
is answered with a pong and a close with a close.  A copy of the JAX
package's module, which imports nothing but the standard library.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import struct
from typing import Optional, Tuple

_WS_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


class WsError(Exception):
    pass


async def server_handshake(
    reader: asyncio.StreamReader,
    writer: asyncio.StreamWriter,
    accept_protocols: Tuple[str, ...] = ("mqtt",),
    require_protocol: bool = False,
) -> str:
    """Read the HTTP upgrade request and reply 101; returns the request
    path.  The first requested subprotocol present in
    ``accept_protocols`` is echoed (MQTT listeners accept "mqtt", the
    OCPP gateway "ocpp1.6"); with ``require_protocol`` the upgrade is
    REJECTED when the client offers none of them (RFC 6455 §4.1 — a
    conforming client would fail the connection on a missing echo, a
    non-conforming one would speak the wrong framing).  Raises WsError
    (after sending an HTTP error) on a non-websocket request."""
    raw = await reader.readuntil(b"\r\n\r\n")
    lines = raw.decode("latin1").split("\r\n")
    request = lines[0].split(" ")
    headers = {}
    for line in lines[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    if (
        len(request) < 2
        or headers.get("upgrade", "").lower() != "websocket"
        or "sec-websocket-key" not in headers
    ):
        writer.write(b"HTTP/1.1 400 Bad Request\r\n\r\n")
        await writer.drain()
        raise WsError("not a websocket upgrade")
    accept = base64.b64encode(
        hashlib.sha1(
            headers["sec-websocket-key"].encode() + _WS_GUID
        ).digest()
    ).decode()
    protos = [
        p.strip()
        for p in headers.get("sec-websocket-protocol", "").split(",")
        if p.strip()
    ]
    resp = [
        "HTTP/1.1 101 Switching Protocols",
        "Upgrade: websocket",
        "Connection: Upgrade",
        f"Sec-WebSocket-Accept: {accept}",
    ]
    matched = next(
        (p for p in protos if p in accept_protocols), None
    )
    if matched is not None:
        resp.append(f"Sec-WebSocket-Protocol: {matched}")
    elif require_protocol:
        writer.write(
            b"HTTP/1.1 400 Bad Request\r\n\r\n"
        )
        await writer.drain()
        raise WsError(
            f"unsupported subprotocols {protos!r}, "
            f"need one of {accept_protocols!r}"
        )
    writer.write(("\r\n".join(resp) + "\r\n\r\n").encode())
    await writer.drain()
    return request[1]


def frame(opcode: int, payload: bytes, mask: Optional[bytes] = None) -> bytes:
    """Build one frame (FIN set).  ``mask`` (4 bytes) masks the payload
    — clients MUST mask; servers MUST NOT."""
    n = len(payload)
    head = bytes([0x80 | opcode])
    mbit = 0x80 if mask else 0
    if n < 126:
        head += bytes([mbit | n])
    elif n < 65536:
        head += bytes([mbit | 126]) + struct.pack(">H", n)
    else:
        head += bytes([mbit | 127]) + struct.pack(">Q", n)
    if mask:
        head += mask
        payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    return head + payload


async def read_frame(
    reader: asyncio.StreamReader, max_size: int = 0
) -> Tuple[int, bool, bytes]:
    """Read one frame; returns (opcode, fin, unmasked payload).
    ``max_size`` > 0 rejects attacker-declared lengths BEFORE buffering
    (the TCP path gets this from StreamParser's incremental size guard;
    a websocket frame would otherwise assemble fully in RAM first)."""
    h = await reader.readexactly(2)
    fin = bool(h[0] & 0x80)
    opcode = h[0] & 0x0F
    masked = bool(h[1] & 0x80)
    n = h[1] & 0x7F
    if n == 126:
        n = struct.unpack(">H", await reader.readexactly(2))[0]
    elif n == 127:
        n = struct.unpack(">Q", await reader.readexactly(8))[0]
    if max_size and n > max_size:
        raise WsError(f"frame of {n} bytes exceeds limit {max_size}")
    mask = await reader.readexactly(4) if masked else None
    payload = await reader.readexactly(n) if n else b""
    if mask:
        payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    return opcode, fin, payload


class WsServerStream:
    """Duck-types the reader/writer pair `Connection` consumes, framed
    over an upgraded websocket."""

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        max_size: int = 16 * 1024 * 1024,
    ) -> None:
        self._r = reader
        self._w = writer
        self._max = max_size
        self._closed = False
        self._frag = b""  # continuation accumulator

    # ------------------------------------------------------ reader API

    async def read(self, _n: int = -1) -> bytes:
        """Next chunk of MQTT bytes (one data frame's worth), or b'' at
        close — the contract asyncio.StreamReader.read gives the
        Connection loop."""
        while True:
            if self._closed:
                return b""
            try:
                opcode, fin, payload = await read_frame(
                    self._r, max_size=self._max
                )
            except (
                WsError,
                asyncio.IncompleteReadError,
                ConnectionError,
            ):
                self._closed = True
                return b""
            if opcode in (OP_BINARY, OP_TEXT, OP_CONT):
                self._frag += payload
                if len(self._frag) > self._max:
                    # fragmented flood: same bound as a single frame
                    self._closed = True
                    return b""
                if not fin:
                    continue
                data, self._frag = self._frag, b""
                if data:
                    return data
                continue
            if opcode == OP_PING:
                self._w.write(frame(OP_PONG, payload))
                continue
            if opcode == OP_CLOSE:
                if not self._w.is_closing():
                    self._w.write(frame(OP_CLOSE, payload[:2]))
                self._closed = True
                return b""
            # unsolicited PONG or unknown: ignore

    # ------------------------------------------------------ writer API

    def write(self, data: bytes) -> None:
        if data and not self._w.is_closing():
            self._w.write(frame(OP_BINARY, data))

    async def drain(self) -> None:
        await self._w.drain()

    def close(self) -> None:
        if not self._w.is_closing():
            try:
                self._w.write(frame(OP_CLOSE, b""))
            except ConnectionError:
                pass
            self._w.close()

    def is_closing(self) -> bool:
        return self._w.is_closing()

    async def wait_closed(self) -> None:
        await self._w.wait_closed()

    def get_extra_info(self, name: str):
        return self._w.get_extra_info(name)
