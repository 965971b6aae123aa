"""A small HTTP/1.1 server on asyncio streams, for the management API.

The JAX package serves its management API with aiohttp.  This package
serves the same routes from the standard library alone, and gives what
a client of that API can see the way aiohttp 3 does:

- routes by method and path template (``/api/v5/clients/{clientid}``,
  ``{name:regex}`` for a segment pattern), a ``GET`` route also answering
  ``HEAD``; an unknown path answers ``404: Not Found`` and a known path
  with another method ``405: Method Not Allowed`` with an ``Allow``
  header, both as ``text/plain; charset=utf-8``, raised inside the
  middleware chain (so a middleware runs for them too);
- path parameters are matched on the path with every escape decoded but
  ``%2F`` and ``%25``, which are decoded in the captured value only (so
  ``a%2F%2B%2Fb`` is one segment, ``a/+/b``); `Request.path` is the
  fully decoded path and `Request.query` the first value of each query
  key; invalid UTF-8 escapes stay as written;
- ``Content-Length`` and chunked request bodies, read when the handler
  asks (`Request.read`/`text`/`json`) and capped at 1 MiB with a 413,
  so an open route never buffers an unbounded body; a body the handler
  did not read is drained before the next request;
- keep-alive (HTTP/1.1 by default, HTTP/1.0 on ``Connection:
  keep-alive``), ``Connection: close``, ``Expect: 100-continue``;
- `json_response` bodies as ``application/json; charset=utf-8``,
  ``204`` with no body and no content type, ``HEAD`` with the headers
  alone;
- a malformed request line or header block answers 400 and closes that
  connection; an exception in a handler answers 500 and closes it.  The
  accept loop goes on either way.

The ``Server`` header is this package's own.
"""

from __future__ import annotations

import asyncio
import email.utils
import functools
import http
import json
import logging
import re
import sys
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qsl

log = logging.getLogger("emqx_tpu_torch.httpd")

CLIENT_MAX_SIZE = 1024 * 1024  # aiohttp's default request body cap
MAX_LINE = 8190  # request line and each header line, as aiohttp
MAX_HEADERS = 128
KEEPALIVE_TIMEOUT = 75.0
DRAIN_MAX = 64 * 1024 * 1024  # an unread body past this closes instead
LINGER_S = 10.0  # aiohttp's lingering_time
SERVER = "Python/%d.%d emqx_tpu_torch" % sys.version_info[:2]

_TOKEN = re.compile(r"^[!#$%&'*+\-.^_`|~0-9A-Za-z]+$")
_METHOD = re.compile(r"^[A-Z]+$")
_VERSION = re.compile(r"^HTTP/1\.([01])$")
_CHUNK_SIZE = re.compile(rb"[0-9A-Fa-f]{1,16}")

Handler = Callable[["Request"], Awaitable["Response"]]


class HTTPError(Exception):
    """Raised by a handler (or the router) to answer with ``status``
    and a text body (``text/plain`` unless ``content_type`` says
    otherwise), as aiohttp's ``web.HTTPException``."""

    def __init__(self, status: int, text: Optional[str] = None,
                 headers: Optional[Dict[str, str]] = None,
                 content_type: Optional[str] = None) -> None:
        self.status = status
        self.text = (text if text is not None
                     else f"{status}: {http.HTTPStatus(status).phrase}")
        self.headers = dict(headers or {})
        self.content_type = content_type
        super().__init__(self.text)

    def response(self) -> "Response":
        return Response(status=self.status, text=self.text,
                        content_type=self.content_type,
                        headers=self.headers)


class _BadRequest(Exception):
    pass


class Response:
    """``text`` is sent encoded in ``charset`` (utf-8) with a
    ``text/plain`` default type; ``body`` as it is; neither: no body."""

    def __init__(self, *, status: int = 200, body: Optional[bytes] = None,
                 text: Optional[str] = None,
                 content_type: Optional[str] = None,
                 charset: Optional[str] = None,
                 headers: Optional[Dict[str, str]] = None) -> None:
        self.status = status
        self.headers = dict(headers or {})
        if text is not None:
            charset = charset or "utf-8"
            body = text.encode(charset)
            content_type = content_type or "text/plain"
        elif body is not None and content_type is None:
            content_type = "application/octet-stream"
        self.body = body
        self.content_type = content_type
        self.charset = charset


def json_response(data: Any, status: int = 200,
                  headers: Optional[Dict[str, str]] = None) -> Response:
    return Response(status=status, text=json.dumps(data),
                    content_type="application/json", headers=headers)


class Headers(dict):
    """Request headers by lower-cased name (the first of repeated
    ones)."""

    def get(self, name: str, default=None):  # type: ignore[override]
        return super().get(name.lower(), default)


def _unquote(s: str, keep: Tuple[int, ...] = ()) -> str:
    """Decode ``%XX`` escapes as UTF-8; bytes in ``keep`` stay escaped
    (upper-case), and an escape that is not valid UTF-8 stays as
    written."""
    if "%" not in s:
        return s
    out: List[str] = []
    buf = bytearray()
    raw: List[str] = []  # the escapes of buf as written

    def flush() -> None:
        if not buf:
            return
        text = bytes(buf).decode("utf-8", "surrogateescape")
        if any("\udc80" <= ch <= "\udcff" for ch in text):
            # re-decode escape by escape: keep the invalid ones written
            text, pos = "", 0
            data = bytes(buf)
            while pos < len(data):
                for end in range(min(len(data), pos + 4), pos, -1):
                    try:
                        text += data[pos:end].decode("utf-8")
                        pos = end
                        break
                    except UnicodeDecodeError:
                        continue
                else:
                    text += raw[pos]
                    pos += 1
        out.append(text)
        buf.clear()
        raw.clear()

    i, n = 0, len(s)
    while i < n:
        ch = s[i]
        if ch == "%" and _is_hex(s[i + 1:i + 3]):
            b = int(s[i + 1:i + 3], 16)
            if b in keep:
                flush()
                out.append("%" + s[i + 1:i + 3].upper())
            else:
                buf.append(b)
                raw.append(s[i:i + 3])
            i += 3
        else:
            flush()
            out.append(ch)
            i += 1
    flush()
    return "".join(out)


def _is_hex(two: str) -> bool:
    return len(two) == 2 and all(c in "0123456789abcdefABCDEF" for c in two)


_SAFE_KEEP = (0x2F, 0x25)  # "/" and "%": kept escaped while routing


def _unquote_safe(value: str) -> str:
    return value.replace("%2F", "/").replace("%25", "%")


class Request:
    """What a handler and the middlewares see of one request."""

    def __init__(self, method: str, target: str, version: int,
                 headers: Headers, remote: Optional[str],
                 body: "_Body") -> None:
        self.method = method
        self.version = version  # the minor version: 0 or 1
        raw_path, _, qs = target.partition("?")
        self.raw_path = target
        self.path = _unquote(raw_path)
        self.path_safe = _unquote(raw_path, keep=_SAFE_KEEP)
        self.query: Dict[str, str] = {}
        for k, v in parse_qsl(qs, keep_blank_values=True):
            self.query.setdefault(k, v)
        self.headers = headers
        self.remote = remote
        self.match_info: Dict[str, str] = {}
        self._body = body
        self._read: Optional[bytes] = None
        self._state: Dict[str, Any] = {}

    def __getitem__(self, key: str) -> Any:
        return self._state[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._state[key] = value

    @property
    def can_read_body(self) -> bool:
        return self._body.length != 0

    @property
    def charset(self) -> Optional[str]:
        ctype = self.headers.get("Content-Type", "")
        m = re.search(r"charset=([^;\s]+)", ctype, re.I)
        return m.group(1).strip('"') if m else None

    async def read(self) -> bytes:
        if self._read is None:
            self._read = await self._body.read_all(CLIENT_MAX_SIZE)
        return self._read

    async def text(self) -> str:
        return (await self.read()).decode(self.charset or "utf-8")

    async def json(self) -> Any:
        return json.loads(await self.text())


class _Body:
    """One request's body on the connection's stream: ``length`` bytes,
    or chunked (``length`` None), read on demand."""

    def __init__(self, reader: asyncio.StreamReader,
                 length: Optional[int]) -> None:
        self.reader = reader
        self.length = length
        self.left = length  # bytes of a Content-Length body unread
        self.done = length == 0
        self._chunk_left = 0

    async def _chunk(self, limit: int) -> bytes:
        """The next piece of the body, at most ``limit`` bytes; b"" at
        its end."""
        if self.done:
            return b""
        if self.length is not None:
            data = await self.reader.read(min(limit, self.left))
            if not data:
                raise ConnectionError("body cut short")
            self.left -= len(data)
            self.done = self.left == 0
            return data
        if self._chunk_left == 0:
            size = (await self._line()).split(b";", 1)[0].strip()
            if not _CHUNK_SIZE.fullmatch(size):
                raise _BadRequest(f"Invalid chunk size: {size!r}")
            n = int(size, 16)
            if n == 0:  # the last chunk, then trailers to a blank line
                for _ in range(MAX_HEADERS + 1):
                    if await self._line() in (b"\r\n", b"\n"):
                        break
                else:
                    raise _BadRequest("Too many trailers")
                self.done = True
                return b""
            self._chunk_left = n
        data = await self.reader.read(min(limit, self._chunk_left))
        if not data:
            raise ConnectionError("body cut short")
        self._chunk_left -= len(data)
        if self._chunk_left == 0:
            if await self._line() not in (b"\r\n", b"\n"):
                raise _BadRequest("Bad chunk end")
        return data

    async def _line(self) -> bytes:
        """One line of the chunked framing, at most `MAX_LINE` bytes."""
        try:
            line = await self.reader.readline()
        except ValueError:  # past the stream's limit
            raise _BadRequest("Chunk line is too long") from None
        if not line:
            raise ConnectionError("body cut short")
        if not line.endswith(b"\n") or len(line) > MAX_LINE + 2:
            raise _BadRequest("Chunk line is too long or cut")
        return line

    async def read_all(self, cap: int) -> bytes:
        parts, size = [], 0
        while True:
            data = await self._chunk(1 << 16)
            if not data:
                return b"".join(parts)
            size += len(data)
            if size >= cap:
                raise HTTPError(
                    413, f"Maximum request body size {cap} exceeded, "
                    f"actual body size {size}")
            parts.append(data)

    async def drain(self) -> bool:
        """Discard what is left; False when that is more than
        `DRAIN_MAX` (the connection then closes)."""
        got = 0
        while not self.done:
            data = await self._chunk(1 << 16)
            got += len(data)
            if got > DRAIN_MAX:
                return False
        return True


class _Resource:
    def __init__(self, template: str) -> None:
        self.template = template
        self.routes: Dict[str, Handler] = {}
        pattern, pos = "", 0
        for m in re.finditer(r"\{(\w+)(?::([^{}]+))?\}", template):
            pattern += re.escape(template[pos:m.start()])
            pattern += f"(?P<{m.group(1)}>{m.group(2) or '[^{}/]+'})"
            pos = m.end()
        self.regex = re.compile(pattern + re.escape(template[pos:]) + "$")


class App:
    """The route table and the middleware chain.  A middleware is
    ``async def mw(request, handler) -> Response``; the first added
    runs outermost."""

    def __init__(self) -> None:
        self._resources: List[_Resource] = []
        self.middlewares: List[Callable[..., Awaitable[Response]]] = []

    def add_route(self, method: str, template: str,
                  handler: Handler) -> None:
        # consecutive routes of one template share a resource
        if not self._resources or self._resources[-1].template != template:
            self._resources.append(_Resource(template))
        self._resources[-1].routes[method] = handler

    def add_get(self, template: str, handler: Handler) -> None:
        self.add_route("GET", template, handler)
        self.add_route("HEAD", template, handler)

    def add_post(self, template: str, handler: Handler) -> None:
        self.add_route("POST", template, handler)

    def add_put(self, template: str, handler: Handler) -> None:
        self.add_route("PUT", template, handler)

    def add_delete(self, template: str, handler: Handler) -> None:
        self.add_route("DELETE", template, handler)

    def resolve(self, request: Request) -> Handler:
        """The route's handler with ``request.match_info`` filled, or a
        handler that raises 404 or 405."""
        allowed: set = set()
        for res in self._resources:
            m = res.regex.match(request.path_safe)
            if m is None:
                continue
            handler = res.routes.get(request.method)
            if handler is not None:
                request.match_info = {k: _unquote_safe(v)
                                      for k, v in m.groupdict().items()}
                return handler
            allowed |= set(res.routes)
        if allowed:
            err = HTTPError(405, headers={"Allow": ",".join(sorted(allowed))})
        else:
            err = HTTPError(404)

        async def raise_it(request: Request) -> Response:
            raise err

        return raise_it

    async def handle(self, request: Request) -> Response:
        handler = self.resolve(request)
        for mw in reversed(self.middlewares):
            handler = functools.partial(mw, handler=handler)
        return await handler(request)


class HttpServer:
    """Serves an `App` on ``bind:port`` (port 0: any free port)."""

    def __init__(self, app: App, bind: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.app = app
        self.bind = bind
        self._port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()

    @property
    def port(self) -> int:
        if self._server is None or not self._server.sockets:
            return self._port
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_conn, self.bind, self._port, limit=1 << 16)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
        for task in list(self._conns):
            task.cancel()
        if self._conns:
            await asyncio.gather(*self._conns, return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None

    async def _on_conn(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        peer = writer.get_extra_info("peername")
        remote = peer[0] if isinstance(peer, tuple) else None
        try:
            while True:
                try:
                    req = await asyncio.wait_for(
                        self._read_head(reader, remote), KEEPALIVE_TIMEOUT)
                except asyncio.TimeoutError:
                    break
                except _BadRequest as exc:
                    self._write(writer, 0, "GET", HTTPError(
                        400, str(exc)).response(), close=True)
                    break
                if req is None:
                    break
                if req.headers.get("Expect", "").lower() == "100-continue":
                    writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
                close = not self._keep_alive(req)
                try:
                    resp = await self.app.handle(req)
                except HTTPError as exc:
                    resp = exc.response()
                    close = close or exc.status == 413
                except _BadRequest as exc:
                    resp = HTTPError(400, str(exc)).response()
                    close = True
                except (ConnectionError, asyncio.IncompleteReadError):
                    break
                except Exception:
                    log.exception("error handling %s %s from %s",
                                  req.method, req.raw_path, remote)
                    resp = Response(
                        status=500, text="500 Internal Server Error\n\n"
                        "Server got itself in trouble")
                    close = True
                self._write(writer, req.version, req.method, resp, close)
                await writer.drain()
                if close:
                    if not req._body.done:
                        await self._linger(reader, writer)
                    break
                try:  # what the handler left of the body, if not too much
                    if not await req._body.drain():
                        break
                except _BadRequest:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._conns.discard(task)
            writer.close()

    @staticmethod
    async def _linger(reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        """Before closing on an unread body: end our side and discard
        what the client still sends (for at most `LINGER_S`), so its
        kernel does not reset the connection before it reads the
        response, as aiohttp's lingering close."""
        try:
            if writer.can_write_eof():
                writer.write_eof()
            loop = asyncio.get_running_loop()
            deadline = loop.time() + LINGER_S
            while loop.time() < deadline:
                data = await asyncio.wait_for(reader.read(1 << 16),
                                              deadline - loop.time())
                if not data:
                    break
        except (asyncio.TimeoutError, ConnectionError, OSError):
            pass

    @staticmethod
    def _keep_alive(req: Request) -> bool:
        conn = req.headers.get("Connection", "").lower()
        if req.version == 0:
            return conn == "keep-alive"
        return conn != "close"

    @staticmethod
    async def _read_head(reader: asyncio.StreamReader,
                         remote: Optional[str]) -> Optional[Request]:
        """The next request's line and headers; None at a clean EOF."""
        try:
            line = await reader.readline()
        except (asyncio.LimitOverrunError, ValueError):
            raise _BadRequest("Got more than 8190 bytes when reading "
                              "Status line is too long") from None
        if not line:
            return None
        if len(line) > MAX_LINE + 2 or not line.endswith(b"\n"):
            raise _BadRequest("Status line is too long")
        parts = line.rstrip(b"\r\n").decode(
            "utf-8", "surrogateescape").split(" ")
        if len(parts) != 3 or not _METHOD.match(parts[0]):
            raise _BadRequest(f"Invalid method encountered: {line!r}")
        method, target, version = parts
        vm = _VERSION.match(version)
        if vm is None:
            raise _BadRequest(f"Bad HTTP version: {line!r}")
        if not target.startswith("/"):
            raise _BadRequest(f"Invalid characters in url: {line!r}")
        headers = Headers()
        for _ in range(MAX_HEADERS + 1):
            try:
                hl = await reader.readline()
            except (asyncio.LimitOverrunError, ValueError):
                raise _BadRequest("Got more than 8190 bytes when "
                                  "reading a header") from None
            if not hl.endswith(b"\n") or len(hl) > MAX_LINE + 2:
                raise _BadRequest("Header line is too long or cut")
            if hl in (b"\r\n", b"\n"):
                break
            text = hl.rstrip(b"\r\n").decode("latin-1")
            name, sep, value = text.partition(":")
            if not sep or not _TOKEN.match(name):
                raise _BadRequest(f"Invalid header token: {hl!r}")
            headers.setdefault(name.lower(), value.strip(" \t"))
        else:
            raise _BadRequest("Too many headers")
        te = headers.get("Transfer-Encoding")
        cl = headers.get("Content-Length")
        if te is not None and cl is not None:
            raise _BadRequest("Transfer-Encoding can't be present with "
                              "Content-Length")
        if te is not None:
            if te.lower() != "chunked":
                raise _BadRequest("Request has invalid `Transfer-Encoding`")
            length = None
        elif cl is not None:
            if not cl.isdigit():
                raise _BadRequest("Invalid character in Content-Length")
            length = int(cl)
        else:
            length = 0
        return Request(method, target, int(vm.group(1)), headers, remote,
                       _Body(reader, length))

    @staticmethod
    def _write(writer: asyncio.StreamWriter, minor: int, method: str,
               resp: Response, close: bool) -> None:
        status = resp.status
        reason = http.HTTPStatus(status).phrase
        lines = [f"HTTP/1.{minor} {status} {reason}"]
        lines += [f"{k}: {v}" for k, v in resp.headers.items()]
        if resp.content_type is not None:
            ctype = resp.content_type
            if resp.charset:
                ctype += f"; charset={resp.charset}"
            lines.append(f"Content-Type: {ctype}")
        no_body = status == 204 or status == 304 or status < 200
        body = resp.body or b""
        if not no_body and not (method == "HEAD" and not body):
            lines.append(f"Content-Length: {len(body)}")
        lines.append(f"Date: {email.utils.formatdate(usegmt=True)}")
        lines.append(f"Server: {SERVER}")
        if close and minor == 1:
            lines.append("Connection: close")
        elif not close and minor == 0:
            lines.append("Connection: keep-alive")
        head = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
        if no_body or method == "HEAD":
            writer.write(head)
        else:
            writer.write(head + body)
