"""A small HTTP/1.1 client on asyncio streams, for the HTTP sink and the
HTTP authenticator.

The JAX package sends both with aiohttp's ``ClientSession``.  This
package sends them from the standard library alone (``ssl`` for
``https``):

- a keep-alive pool of idle connections per (scheme, host, port); a
  pooled connection the server closed while it sat idle is replaced by
  a fresh one once, before any byte of the response was read;
- ``Content-Length``, chunked and read-to-close response bodies, none for
  ``HEAD``, 1xx, 204 and 304;
- one total timeout over connect, send and the whole body, as aiohttp's
  ``ClientTimeout(total=...)``; a request that times out or fails closes
  its connection;
- request bodies as aiohttp encodes them: ``json=`` as ``json.dumps``
  with ``application/json``, a ``str`` as UTF-8 ``text/plain``, ``bytes``
  as ``application/octet-stream``; a ``Content-Type`` the caller gives
  wins;
- `Response.json` as aiohttp's: it refuses a body whose type is not
  ``application/json`` (or ``application/*+json``) and reads an empty
  body as None.

Redirects are not followed: a 3xx is the answer (EMQX's HTTP connector,
ehttpc, does not follow them either).
"""

from __future__ import annotations

import asyncio
import json
import re
import ssl as _ssl
import sys
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import urlsplit

from .httpd import Headers

USER_AGENT = "Python/%d.%d emqx_tpu_torch" % sys.version_info[:2]
MAX_LINE = 65536  # a status or header line
MAX_HEADERS = 128
MAX_IDLE = 100  # idle connections kept per (scheme, host, port)

_JSON_TYPE = re.compile(r"^application/(?:[\w.+-]+?\+)?json")

Key = Tuple[str, str, int]


class HttpClientError(Exception):
    """A response the client cannot read (a malformed status line,
    header block or chunk)."""


class ContentTypeError(ValueError):
    """`Response.json` on a body that is not JSON by its type."""


class Response:
    def __init__(self, status: int, reason: str, headers: Headers,
                 body: bytes) -> None:
        self.status = status
        self.reason = reason
        self.headers = headers
        self.body = body

    def charset(self) -> str:
        for part in (self.headers.get("content-type") or "").split(";")[1:]:
            k, _, v = part.strip().partition("=")
            if k.lower() == "charset" and v:
                return v.strip('"')
        return "utf-8"

    def text(self) -> str:
        return self.body.decode(self.charset(), "replace")

    def json(self) -> Any:
        ctype = (self.headers.get("content-type") or "").lower()
        if not _JSON_TYPE.match(ctype):
            raise ContentTypeError(
                f"attempt to decode JSON with unexpected mimetype: {ctype}")
        stripped = self.body.strip()
        if not stripped:
            return None
        return json.loads(stripped.decode(self.charset()))


class _Conn:
    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter) -> None:
        self.reader = reader
        self.writer = writer

    def usable(self) -> bool:
        return not (self.writer.is_closing() or self.reader.at_eof())

    def close(self) -> None:
        self.writer.close()


class _Stale(Exception):
    """A pooled connection ended before the response's first byte."""


class Client:
    """``request`` and the ``get``/``head``/``post``/``put`` shorthands;
    ``close`` closes the idle connections.  ``ssl`` is the context for
    ``https`` URLs (default: the system's trust store)."""

    def __init__(self, timeout: float = 5.0,
                 ssl: Optional[_ssl.SSLContext] = None) -> None:
        self.timeout = timeout
        self.ssl = ssl
        self._idle: Dict[Key, List[_Conn]] = {}
        self._busy: set = set()
        self.connections_opened = 0

    # ------------------------------------------------------- requests

    async def request(self, method: str, url: str, *, data=None,
                      json: Any = None,
                      headers: Optional[Dict[str, str]] = None) -> Response:
        """Send one request and read its whole response.  Raises
        ``asyncio.TimeoutError`` past the total timeout, ``OSError`` or
        ``ConnectionError`` on a transport failure and
        `HttpClientError` on a malformed response."""
        parts = urlsplit(url)
        scheme = parts.scheme.lower()
        if scheme not in ("http", "https") or not parts.hostname:
            raise ValueError(f"not an http(s) URL: {url!r}")
        port = parts.port or (443 if scheme == "https" else 80)
        key: Key = (scheme, parts.hostname, port)
        target = (parts.path or "/") + (f"?{parts.query}" if parts.query
                                        else "")
        default_port = port == (443 if scheme == "https" else 80)
        host = parts.hostname if ":" not in parts.hostname \
            else f"[{parts.hostname}]"
        hdrs = {"Host": host if default_port else f"{host}:{port}",
                "Accept": "*/*", "User-Agent": USER_AGENT}
        body, ctype = _encode_body(data, json)
        if ctype is not None:
            hdrs["Content-Type"] = ctype
        given = {k.lower(): (k, v) for k, v in (headers or {}).items()}
        for k in list(hdrs):
            if k.lower() in given:
                del hdrs[k]
        hdrs.update(dict(given.values()))
        if body or method.upper() not in ("GET", "HEAD", "OPTIONS",
                                          "DELETE"):
            hdrs["Content-Length"] = str(len(body))
        head = f"{method.upper()} {target} HTTP/1.1\r\n" + "".join(
            f"{k}: {v}\r\n" for k, v in hdrs.items()) + "\r\n"
        wire = head.encode("latin-1") + body
        return await asyncio.wait_for(
            self._exchange(key, method.upper(), wire), self.timeout)

    async def get(self, url: str, **kw) -> Response:
        return await self.request("GET", url, **kw)

    async def head(self, url: str, **kw) -> Response:
        return await self.request("HEAD", url, **kw)

    async def post(self, url: str, **kw) -> Response:
        return await self.request("POST", url, **kw)

    async def put(self, url: str, **kw) -> Response:
        return await self.request("PUT", url, **kw)

    async def close(self) -> None:
        for conns in self._idle.values():
            for c in conns:
                c.close()
        self._idle.clear()
        for c in list(self._busy):
            c.close()
        self._busy.clear()

    # ------------------------------------------------------ internals

    async def _exchange(self, key: Key, method: str,
                        wire: bytes) -> Response:
        conn = self._take(key)
        if conn is not None:
            try:
                return await self._on(key, conn, method, wire)
            except _Stale:
                pass  # the server closed it while idle: dial anew
        conn = await self._open(key)
        try:
            return await self._on(key, conn, method, wire)
        except _Stale as exc:
            raise ConnectionError(
                "server closed the connection without a response") from exc

    def _take(self, key: Key) -> Optional[_Conn]:
        idle = self._idle.get(key)
        while idle:
            conn = idle.pop()
            if conn.usable():
                return conn
            conn.close()
        return None

    async def _open(self, key: Key) -> _Conn:
        scheme, host, port = key
        ctx = None
        if scheme == "https":
            ctx = self.ssl or _ssl.create_default_context()
        reader, writer = await asyncio.open_connection(
            host, port, ssl=ctx, server_hostname=host if ctx else None,
            limit=MAX_LINE)
        self.connections_opened += 1
        return _Conn(reader, writer)

    async def _on(self, key: Key, conn: _Conn, method: str,
                  wire: bytes) -> Response:
        self._busy.add(conn)
        keep = False
        try:
            try:
                conn.writer.write(wire)
                await conn.writer.drain()
            except (ConnectionResetError, BrokenPipeError) as exc:
                raise _Stale() from exc
            resp, keep = await _read_response(conn.reader, method)
            return resp
        finally:
            self._busy.discard(conn)
            idle = self._idle.setdefault(key, [])
            if keep and conn.usable() and len(idle) < MAX_IDLE:
                idle.append(conn)
            else:
                conn.close()


def _encode_body(data, obj) -> Tuple[bytes, Optional[str]]:
    if data is not None and obj is not None:
        raise ValueError("data and json are exclusive")
    if obj is not None:
        return json.dumps(obj).encode(), "application/json"
    if data is None:
        return b"", None
    if isinstance(data, str):
        return data.encode(), "text/plain; charset=utf-8"
    if isinstance(data, (bytes, bytearray, memoryview)):
        return bytes(data), "application/octet-stream"
    raise TypeError(f"unsupported body type {type(data).__name__}")


async def _readline(reader: asyncio.StreamReader) -> bytes:
    try:
        line = await reader.readuntil(b"\n")
    except asyncio.LimitOverrunError as exc:
        raise HttpClientError("response line too long") from exc
    return line.rstrip(b"\r\n")


async def _read_response(reader: asyncio.StreamReader,
                         method: str) -> Tuple[Response, bool]:
    """The response and whether its connection may be reused."""
    try:
        status_line = await _readline(reader)
    except asyncio.IncompleteReadError as exc:
        if exc.partial:
            raise HttpClientError("truncated status line") from exc
        raise _Stale() from exc
    except (ConnectionResetError, BrokenPipeError) as exc:
        raise _Stale() from exc
    try:
        return await _read_rest(reader, method, status_line)
    except asyncio.IncompleteReadError as exc:
        raise ConnectionError("response truncated") from exc


async def _read_rest(reader: asyncio.StreamReader, method: str,
                     status_line: bytes) -> Tuple[Response, bool]:
    parts = status_line.decode("latin-1").split(" ", 2)
    if len(parts) < 2 or not parts[0].startswith("HTTP/1.") \
            or not parts[1].isdigit() or len(parts[1]) != 3:
        raise HttpClientError(f"bad status line {status_line[:80]!r}")
    version, status = parts[0], int(parts[1])
    reason = parts[2] if len(parts) > 2 else ""
    headers = Headers()
    for _ in range(MAX_HEADERS + 1):
        line = await _readline(reader)
        if not line:
            break
        name, sep, value = line.decode("latin-1").partition(":")
        if not sep or not name or name != name.strip():
            raise HttpClientError(f"bad header line {line[:80]!r}")
        headers.setdefault(name.lower(), value.strip())
    else:
        raise HttpClientError("too many response headers")
    conn_hdr = (headers.get("connection") or "").lower()
    keep = ("close" not in conn_hdr if version == "HTTP/1.1"
            else "keep-alive" in conn_hdr)
    if method == "HEAD" or status < 200 or status in (204, 304):
        return Response(status, reason, headers, b""), keep
    te = (headers.get("transfer-encoding") or "").lower()
    if "chunked" in te:
        body = await _read_chunked(reader)
    elif headers.get("content-length") is not None:
        cl = headers.get("content-length")
        if not cl.isdigit():
            raise HttpClientError(f"bad Content-Length {cl!r}")
        body = await reader.readexactly(int(cl))
    else:  # read to close
        body = await reader.read()
        keep = False
    return Response(status, reason, headers, body), keep


async def _read_chunked(reader: asyncio.StreamReader) -> bytes:
    out = bytearray()
    while True:
        line = await _readline(reader)
        size = line.split(b";", 1)[0].strip()
        try:
            n = int(size, 16)
        except ValueError as exc:
            raise HttpClientError(f"bad chunk size {line[:40]!r}") from exc
        if n == 0:
            while await _readline(reader):  # trailers
                pass
            return bytes(out)
        out += await reader.readexactly(n)
        if await reader.readexactly(2) != b"\r\n":
            raise HttpClientError("chunk not followed by CRLF")
