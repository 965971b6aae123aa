"""Unary gRPC over the port's own HTTP/2 (`h2.py`): a client `Channel`
and a `Server`, from the standard library.

Client::

    ch = Channel("127.0.0.1:9000")
    call = ch.unary_unary("/pkg.Svc/Method",
                          request_serializer=Req.SerializeToString,
                          response_deserializer=Resp.FromString)
    resp = call(req, timeout=5)          # RpcError on a failed call
    fut = call.future(req, timeout=5)    # concurrent.futures.Future
    ch.close()

Calls from any number of threads share one connection, each on its own
stream; the channel dials at the first call and again after the peer
closed or sent GOAWAY.  A call sends ``grpc-timeout``, frames its
message with the 5-byte prefix, and reads ``grpc-status`` and the
percent-decoded ``grpc-message`` from the trailers (or a trailers-only
reply).  `RpcError.code()` is a `StatusCode` with grpc's names:
UNAVAILABLE when the peer refuses the connection, closes or resets it,
or refuses the stream; DEADLINE_EXCEEDED past the timeout (the stream
is cancelled); a non-200 HTTP status maps as grpc maps it.

Server::

    srv = Server(max_workers=8)
    srv.add_method("/pkg.Svc/Method", fn, Req.FromString,
                   Resp.SerializeToString)   # fn(request, context)
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    srv.stop(grace=0.5).wait()

Handlers run on a pool of ``max_workers`` threads.  An unknown method
gets a trailers-only UNIMPLEMENTED; ``context.abort(code, details)``
ends the call with that status; any other exception out of a handler
is UNKNOWN, as in grpc.  `stop` closes the listening socket and every
connection it accepted (GOAWAY first), so nothing the server opened
stays open.  Only unary calls: streaming RPCs are not served.
"""

from __future__ import annotations

import base64
import concurrent.futures
import enum
import logging
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import h2

log = logging.getLogger("emqx_tpu_torch.grpc")

USER_AGENT = "emqx-tpu-torch-grpc/1.0"
FUTURE_THREADS = 8  # a channel's threads for `UnaryUnary.future` calls
CONNECT_TIMEOUT = 20.0  # the most a dial waits, whatever the call's timeout


class StatusCode(enum.Enum):
    OK = (0, "ok")
    CANCELLED = (1, "cancelled")
    UNKNOWN = (2, "unknown")
    INVALID_ARGUMENT = (3, "invalid argument")
    DEADLINE_EXCEEDED = (4, "deadline exceeded")
    NOT_FOUND = (5, "not found")
    ALREADY_EXISTS = (6, "already exists")
    PERMISSION_DENIED = (7, "permission denied")
    RESOURCE_EXHAUSTED = (8, "resource exhausted")
    FAILED_PRECONDITION = (9, "failed precondition")
    ABORTED = (10, "aborted")
    OUT_OF_RANGE = (11, "out of range")
    UNIMPLEMENTED = (12, "unimplemented")
    INTERNAL = (13, "internal")
    UNAVAILABLE = (14, "unavailable")
    DATA_LOSS = (15, "data loss")
    UNAUTHENTICATED = (16, "unauthenticated")


_BY_NUMBER = {c.value[0]: c for c in StatusCode}
_HTTP_STATUS = {400: StatusCode.INTERNAL, 401: StatusCode.UNAUTHENTICATED,
                403: StatusCode.PERMISSION_DENIED,
                404: StatusCode.UNIMPLEMENTED, 429: StatusCode.UNAVAILABLE,
                502: StatusCode.UNAVAILABLE, 503: StatusCode.UNAVAILABLE,
                504: StatusCode.UNAVAILABLE}
_RST_STATUS = {h2.REFUSED_STREAM: StatusCode.UNAVAILABLE,
               h2.CANCEL: StatusCode.CANCELLED,
               h2.ENHANCE_YOUR_CALM: StatusCode.RESOURCE_EXHAUSTED}


class RpcError(Exception):
    """A failed call: ``code()`` and ``details()`` as grpc's."""

    def __init__(self, code: StatusCode, details: str = "") -> None:
        super().__init__(f"{code.name}: {details}")
        self._code = code
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


# ------------------------------------------------------------ the wire

def encode_timeout(seconds: float) -> str:
    """``grpc-timeout``: at most 8 digits and a unit."""
    for unit, scale in (("u", 1e6), ("m", 1e3), ("S", 1.0), ("M", 1 / 60),
                        ("H", 1 / 3600)):
        n = int(-(-max(seconds, 0.0) * scale // 1))
        if n < 10 ** 8:
            return f"{max(n, 1)}{unit}"
    return "99999999H"


def percent_encode(msg: str) -> str:
    out = []
    for b in msg.encode("utf-8"):
        out.append(chr(b) if 0x20 <= b <= 0x7E and b != 0x25
                   else f"%{b:02X}")
    return "".join(out)


def percent_decode(text: str) -> str:
    raw = text.encode("latin-1")
    out = bytearray()
    i = 0
    while i < len(raw):
        if raw[i] == 0x25 and _hex2(raw[i + 1:i + 3]) is not None:
            out.append(_hex2(raw[i + 1:i + 3]))
            i += 3
        else:
            out.append(raw[i])
            i += 1
    return out.decode("utf-8", "replace")


def _hex2(b: bytes) -> Optional[int]:
    try:
        return int(b.decode("ascii"), 16) if len(b) == 2 else None
    except ValueError:
        return None


def frame_message(body: bytes) -> bytes:
    return b"\x00" + len(body).to_bytes(4, "big") + body


def read_message(data: bytes) -> Optional[bytes]:
    """The one length-prefixed message of a unary body; None when there
    is none.  ValueError for a compressed message or trailing bytes."""
    if not data:
        return None
    if len(data) < 5:
        raise ValueError("truncated message prefix")
    if data[0]:
        raise ValueError("compressed message without grpc-encoding")
    n = int.from_bytes(data[1:5], "big")
    if len(data) != 5 + n:
        raise ValueError(f"message of {len(data) - 5} bytes, prefix says {n}")
    return bytes(data[5:])


def _text(v: bytes) -> str:
    return v.decode("latin-1")


def metadata_out(metadata: Sequence[Tuple[str, Any]],
                 true_binary: bool = False) -> List[Tuple[str, bytes]]:
    """Custom metadata as header fields: a ``-bin`` key's bytes go
    base64 (unpadded, as grpc sends them) or, with ``true_binary``,
    raw behind a 0 byte."""
    out = []
    for k, v in metadata:
        k = k.lower()
        if k.endswith("-bin"):
            raw = v if isinstance(v, (bytes, bytearray)) else str(v).encode()
            out.append((k, b"\x00" + bytes(raw) if true_binary else
                        base64.b64encode(bytes(raw)).rstrip(b"=")))
        else:
            out.append((k, v.encode("latin-1") if isinstance(v, str)
                        else bytes(v)))
    return out


def metadata_in(headers: Sequence[Tuple[bytes, bytes]]
                ) -> Tuple[Tuple[str, Any], ...]:
    """The custom metadata of a header list (no pseudo-headers and no
    reserved ``grpc-``/transport fields), ``-bin`` values decoded."""
    out = []
    for k, v in headers:
        name = _text(k)
        if name.startswith(":") or name in _RESERVED or \
                name.startswith("grpc-") and name not in ("grpc-trace-bin",):
            continue
        if name.endswith("-bin"):
            if v[:1] == b"\x00":
                out.append((name, bytes(v[1:])))
            else:
                out.append((name, base64.b64decode(
                    v + b"=" * (-len(v) % 4))))
        else:
            out.append((name, _text(v)))
    return tuple(out)


_RESERVED = {"content-type", "te", "user-agent", "grpc-timeout",
             "grpc-encoding", "grpc-accept-encoding", "accept-encoding"}


# --------------------------------------------------------------- client

class Channel:
    """A client channel to ``target`` (``host:port``, an ``http://``
    prefix dropped)."""

    def __init__(self, target: str, huffman: str = "shorter",
                 true_binary: bool = False) -> None:
        target = target.replace("http://", "")
        host, _, port = target.rpartition(":")
        self.target = target
        self._addr = (host.strip("[]") or "127.0.0.1", int(port))
        self.huffman = huffman
        self.true_binary = true_binary
        self._conn: Optional[h2.Connection] = None
        self._old: List[h2.Connection] = []
        self._lock = threading.Lock()
        self._closed = False
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=FUTURE_THREADS, thread_name_prefix="grpc-future")

    def _connection(self, timeout: Optional[float]) -> h2.Connection:
        with self._lock:
            if self._closed:
                raise RpcError(StatusCode.CANCELLED, "channel closed")
            c = self._conn
            if c is not None and c.usable:
                return c
            if c is not None and not c.closed:
                self._old.append(c)  # drains its streams, then closes
            self._conn = None
            wait = CONNECT_TIMEOUT if timeout is None else \
                max(0.001, min(timeout, CONNECT_TIMEOUT))
            try:
                sock = socket.create_connection(self._addr, timeout=wait)
            except socket.timeout as exc:
                raise RpcError(StatusCode.UNAVAILABLE,
                               f"failed to connect to {self.target}: "
                               "timed out") from exc
            except OSError as exc:
                raise RpcError(StatusCode.UNAVAILABLE,
                               f"failed to connect to {self.target}: "
                               f"{exc}") from exc
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            c = h2.Connection(sock, client=True, huffman=self.huffman)
            try:
                c.start()
            except OSError as exc:
                c.close()
                raise RpcError(StatusCode.UNAVAILABLE, str(exc)) from exc
            self._conn = c
            return c

    def unary_unary(self, method: str,
                    request_serializer: Optional[Callable] = None,
                    response_deserializer: Optional[Callable] = None,
                    ) -> "UnaryUnary":
        return UnaryUnary(self, method, request_serializer,
                          response_deserializer)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conns = [c for c in (self._conn, *self._old) if c is not None]
            self._conn = None
            self._old = []
        for c in conns:
            c.close(h2.NO_ERROR)
            c.join(5.0)
        self._pool.shutdown(wait=False, cancel_futures=True)

    def _reap(self) -> None:
        with self._lock:
            keep = []
            for c in self._old:
                if c.closed:
                    continue
                if c.streams:
                    keep.append(c)
                else:
                    c.close(h2.NO_ERROR)
            self._old = keep


class UnaryUnary:
    """One method of a channel: call it, or ``.future`` it."""

    def __init__(self, channel: Channel, method: str,
                 serializer: Optional[Callable],
                 deserializer: Optional[Callable]) -> None:
        self._ch = channel
        self._method = method
        self._ser = serializer or (lambda b: b)
        self._de = deserializer or (lambda b: b)

    def __call__(self, request: Any, timeout: Optional[float] = None,
                 metadata: Optional[Sequence[Tuple[str, Any]]] = None
                 ) -> Any:
        return self._call(request, timeout, metadata)

    def future(self, request: Any, timeout: Optional[float] = None,
               metadata: Optional[Sequence[Tuple[str, Any]]] = None
               ) -> concurrent.futures.Future:
        try:
            return self._ch._pool.submit(self.__call__, request, timeout,
                                         metadata)
        except RuntimeError:  # the channel's pool is shut down
            fut: concurrent.futures.Future = concurrent.futures.Future()
            fut.set_exception(RpcError(StatusCode.CANCELLED,
                                       "channel closed"))
            return fut

    def _call(self, request: Any, timeout: Optional[float],
              metadata: Optional[Sequence[Tuple[str, Any]]]):
        ch = self._ch
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            body = self._ser(request)
        except Exception as exc:
            raise RpcError(StatusCode.INTERNAL,
                           "Exception serializing request!") from exc
        conn = ch._connection(timeout)
        headers: List[Tuple[str, Any]] = [
            (":method", "POST"), (":scheme", "http"),
            (":path", self._method), (":authority", ch.target),
            ("content-type", "application/grpc"), ("te", "trailers"),
            ("user-agent", USER_AGENT)]
        if timeout is not None:
            headers.append(("grpc-timeout", encode_timeout(timeout)))
        headers += metadata_out(metadata or (), ch.true_binary)
        framed = frame_message(body)
        try:
            stream, sent = conn.start_stream(headers, framed)
        except (h2.StreamClosed, OSError) as exc:
            raise RpcError(StatusCode.UNAVAILABLE, str(exc)) from exc
        try:
            try:
                left = None if deadline is None else \
                    deadline - time.monotonic()
                if not sent and not conn.send_data(
                        stream.id, framed, end_stream=True, timeout=left):
                    conn.send_rst(stream.id, h2.CANCEL)
                    raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                                   "Deadline Exceeded")
            except (h2.StreamClosed, OSError):
                if not stream.done.is_set():
                    stream.lost = True
                # the peer's answer (an early status) may be in already
            left = None if deadline is None else deadline - time.monotonic()
            if not stream.done.wait(left):
                conn.send_rst(stream.id, h2.CANCEL)
                raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                               "Deadline Exceeded")
            return self._result(stream)
        finally:
            conn.forget(stream.id)
            ch._reap()

    def _result(self, stream: h2.Stream):
        if stream.reset is not None:
            code = _RST_STATUS.get(stream.reset, StatusCode.INTERNAL)
            raise RpcError(code, f"stream reset by the peer (HTTP/2 error "
                                 f"{stream.reset})")
        if stream.headers is None or (stream.lost and not stream.ended):
            raise RpcError(StatusCode.UNAVAILABLE,
                           "the connection closed before the reply")
        head = {_text(k): _text(v) for k, v in stream.headers}
        status = head.get(":status", "")
        if status != "200":
            code = _HTTP_STATUS.get(int(status) if status.isdigit() else 0,
                                    StatusCode.UNKNOWN)
            raise RpcError(code, f"Received http2 header with status: "
                                 f"{status}")
        trailers = stream.trailers if stream.trailers is not None \
            else stream.headers
        tail = {_text(k): _text(v) for k, v in trailers}
        if "grpc-status" not in tail:
            raise RpcError(StatusCode.UNKNOWN if stream.ended else
                           StatusCode.UNAVAILABLE,
                           "the reply carried no grpc-status")
        num = int(tail["grpc-status"]) if tail["grpc-status"].isdigit() \
            else 2
        code = _BY_NUMBER.get(num, StatusCode.UNKNOWN)
        if code is not StatusCode.OK:
            raise RpcError(code, percent_decode(tail.get("grpc-message", "")))
        try:
            body = read_message(bytes(stream.data))
        except ValueError as exc:
            raise RpcError(StatusCode.INTERNAL, str(exc)) from exc
        if body is None:
            raise RpcError(StatusCode.UNIMPLEMENTED,
                           "the reply carried no message")
        try:
            return self._de(body)
        except Exception as exc:
            raise RpcError(StatusCode.INTERNAL,
                           "Exception deserializing response!") from exc


# --------------------------------------------------------------- server

class _Abort(Exception):
    def __init__(self, code: StatusCode, details: str) -> None:
        super().__init__(details)
        self.status = code
        self.details = details


class ServicerContext:
    """What a handler gets beside its request."""

    def __init__(self, headers: Sequence[Tuple[bytes, bytes]]) -> None:
        self._headers = headers

    def invocation_metadata(self) -> Tuple[Tuple[str, Any], ...]:
        return metadata_in(self._headers)

    def abort(self, code: StatusCode, details: str = "") -> None:
        raise _Abort(code, details)


Handler = Tuple[Callable, Optional[Callable], Optional[Callable]]


class Server:
    def __init__(self, max_workers: int = 8) -> None:
        self._handlers: Dict[str, Handler] = {}
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="grpc-server")
        self._socks: List[socket.socket] = []
        self._accepters: List[threading.Thread] = []
        self._conns: Dict[int, h2.Connection] = {}
        self._lock = threading.Lock()
        self._inflight = 0
        self._idle = threading.Condition(self._lock)
        self._running = False
        self._stopped = threading.Event()

    def add_method(self, path: str, fn: Callable,
                   request_deserializer: Optional[Callable] = None,
                   response_serializer: Optional[Callable] = None) -> None:
        self._handlers[path] = (fn, request_deserializer,
                                response_serializer)

    def add_service(self, service: str,
                    methods: Dict[str, Handler]) -> None:
        for name, h in methods.items():
            self._handlers[f"/{service}/{name}"] = h

    def add_insecure_port(self, bind: str) -> int:
        host, _, port = bind.rpartition(":")
        host = host.strip("[]") or "0.0.0.0"
        sock = socket.socket(socket.AF_INET6 if ":" in host
                             else socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            sock.bind((host, int(port)))
            sock.listen(128)
        except OSError:
            sock.close()
            raise
        sock.settimeout(0.1)
        self._socks.append(sock)
        return sock.getsockname()[1]

    @property
    def connections(self) -> List[h2.Connection]:
        with self._lock:
            return list(self._conns.values())

    def start(self) -> None:
        self._running = True
        for sock in self._socks:
            t = threading.Thread(target=self._accept_loop, args=(sock,),
                                 daemon=True, name="grpc-accept")
            t.start()
            self._accepters.append(t)

    def _accept_loop(self, lsock: socket.socket) -> None:
        while self._running:
            try:
                sock, _addr = lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            if not self._running:
                sock.close()
                return
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve, args=(sock,),
                             daemon=True, name="grpc-handshake").start()

    def _serve(self, sock: socket.socket) -> None:
        conn = h2.Connection(sock, client=False, on_request=self._on_request,
                             on_close=self._on_conn_close)
        with self._lock:
            if not self._running:
                sock.close()
                return
            self._conns[id(conn)] = conn
        try:
            conn.start(preface_timeout=10.0)
        except (OSError, h2.ProtocolError):
            conn.close()

    def _on_conn_close(self, conn: h2.Connection) -> None:
        with self._lock:
            self._conns.pop(id(conn), None)

    def _on_request(self, conn: h2.Connection, stream: h2.Stream) -> None:
        with self._lock:
            self._inflight += 1
        try:
            self._pool.submit(self._handle, conn, stream)
        except RuntimeError:  # stopping
            self._done_one()
            conn.send_rst(stream.id, h2.REFUSED_STREAM)

    def _done_one(self) -> None:
        with self._lock:
            self._inflight -= 1
            self._idle.notify_all()

    def _handle(self, conn: h2.Connection, stream: h2.Stream) -> None:
        try:
            self._respond(conn, stream)
        except (h2.StreamClosed, OSError):
            pass
        except Exception:
            log.exception("grpc server: answering stream %d failed",
                          stream.id)
        finally:
            conn.forget(stream.id)
            self._done_one()

    def _respond(self, conn: h2.Connection, stream: h2.Stream) -> None:
        head = {_text(k): _text(v) for k, v in stream.headers or ()}
        path = head.get(":path", "")
        entry = self._handlers.get(path)
        if entry is None or head.get(":method") != "POST":
            self._status_only(conn, stream, StatusCode.UNIMPLEMENTED,
                              "Method not found!" if entry is None else
                              "only POST is served")
            return
        fn, deser, ser = entry
        ctx = ServicerContext(stream.headers or ())
        try:
            raw = read_message(bytes(stream.data))
            if raw is None:
                raise ValueError("no request message")
            req = deser(raw) if deser is not None else raw
        except Exception:
            self._status_only(conn, stream, StatusCode.INTERNAL,
                              "Exception deserializing request!")
            return
        try:
            resp = fn(req, ctx)
        except _Abort as ab:
            self._status_only(conn, stream, ab.status, ab.details)
            return
        except Exception as exc:
            log.exception("grpc server: %s raised", path)
            self._status_only(conn, stream, StatusCode.UNKNOWN,
                              f"Exception calling application: {exc}")
            return
        try:
            body = ser(resp) if ser is not None else resp
        except Exception:
            log.exception("grpc server: %s response did not serialize",
                          path)
            self._status_only(conn, stream, StatusCode.INTERNAL,
                              "Failed to serialize response!")
            return
        conn.respond(stream.id, [(":status", "200"),
                                 ("content-type", "application/grpc")],
                     frame_message(body), [("grpc-status", "0")])

    @staticmethod
    def _status_only(conn: h2.Connection, stream: h2.Stream,
                     code: StatusCode, details: str) -> None:
        fields = [(":status", "200"), ("content-type", "application/grpc"),
                  ("grpc-status", str(code.value[0]))]
        if details:
            fields.append(("grpc-message", percent_encode(details)))
        conn.send_headers(stream.id, fields, end_stream=True)

    def stop(self, grace: Optional[float] = None) -> threading.Event:
        """Stop accepting, let calls in flight finish for up to
        ``grace`` seconds, then close every connection (GOAWAY first).
        Returns an event that is set once all of it is done."""
        self._running = False
        for sock in self._socks:
            try:
                sock.close()
            except OSError:
                pass
        for t in self._accepters:
            t.join(1.0)
        self._accepters = []
        if grace:
            end = time.monotonic() + grace
            with self._lock:
                while self._inflight > 0:
                    left = end - time.monotonic()
                    if left <= 0:
                        break
                    self._idle.wait(left)
        for conn in self.connections:
            conn.close(h2.NO_ERROR)
        for conn in list(self._conns.values()):
            conn.close()
        self._pool.shutdown(wait=False, cancel_futures=True)
        self._stopped.set()
        return self._stopped
