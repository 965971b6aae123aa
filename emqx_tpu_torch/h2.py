"""HTTP/2 framing (RFC 9113) over a plain socket: h2c with prior
knowledge, no TLS and no ALPN (exhook dials and serves insecure only).

A `Connection` owns one socket and a reader thread.  It sends the
preface and its SETTINGS, ACKs the peer's SETTINGS and PINGs, keeps
both flow-control windows (the connection's and each stream's) in both
directions, reads HEADERS with their CONTINUATION frames through one
HPACK decoder in arrival order, and collects each stream's headers,
DATA and trailers until END_STREAM or RST_STREAM.  Writers from any
thread share a write lock; a DATA writer waits for window credit.

The receive side gives credit back once half a window has arrived (a
WINDOW_UPDATE for the stream and one for the connection), and caps what
one stream may buffer (``MAX_STREAM_BYTES``): past it the stream is
reset.  A request or a response whose body the windows allow leaves in
one write (`start_stream` with its body, `respond`).  On a server, a stream whose request ended is handed to
``on_request``; on a client, `start_stream` opens one and the caller
waits on ``Stream.done``.  When the socket closes, every open stream
ends with ``lost`` set.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import hpack

log = logging.getLogger("emqx_tpu_torch.h2")

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS = 0, 1, 2, 3, 4
PUSH_PROMISE, PING, GOAWAY, WINDOW_UPDATE, CONTINUATION = 5, 6, 7, 8, 9

END_STREAM = ACK = 0x1
END_HEADERS, PADDED, PRIORITY_FLAG = 0x4, 0x8, 0x20

S_HEADER_TABLE_SIZE, S_ENABLE_PUSH, S_MAX_CONCURRENT_STREAMS = 1, 2, 3
S_INITIAL_WINDOW_SIZE, S_MAX_FRAME_SIZE, S_MAX_HEADER_LIST_SIZE = 4, 5, 6

NO_ERROR, PROTOCOL_ERROR, INTERNAL_ERROR, FLOW_CONTROL_ERROR = 0, 1, 2, 3
STREAM_CLOSED, FRAME_SIZE_ERROR, REFUSED_STREAM, CANCEL = 5, 6, 7, 8
COMPRESSION_ERROR, ENHANCE_YOUR_CALM = 9, 11

DEFAULT_WINDOW = 65535
MAX_WINDOW = 2 ** 31 - 1
# what this side advertises
RECV_WINDOW = 1 << 20
RECV_MAX_FRAME = 16384
MAX_STREAM_BYTES = 8 << 20


class ProtocolError(Exception):
    def __init__(self, code: int, msg: str) -> None:
        super().__init__(msg)
        self.code = code


class StreamClosed(Exception):
    """A write to a stream that was reset, or to a closed connection."""


class Stream:
    __slots__ = ("id", "headers", "trailers", "data", "ended", "reset",
                 "lost", "done", "send_window", "closed_local", "unacked")

    def __init__(self, sid: int, send_window: int) -> None:
        self.id = sid
        self.headers: Optional[List[hpack.Header]] = None
        self.trailers: Optional[List[hpack.Header]] = None
        self.data = bytearray()
        self.ended = False  # the peer's END_STREAM
        self.reset: Optional[int] = None  # the peer's RST_STREAM code
        self.lost = False  # the connection closed under it
        self.done = threading.Event()
        self.send_window = send_window
        self.closed_local = False
        self.unacked = 0  # DATA bytes not yet credited back


def _frame(ftype: int, flags: int, sid: int, payload: bytes = b"") -> bytes:
    n = len(payload)
    return struct.pack(">BHBBI", n >> 16, n & 0xFFFF, ftype, flags,
                       sid & 0x7FFFFFFF) + payload


class Connection:
    def __init__(self, sock: socket.socket, client: bool,
                 on_request: Optional[Callable[["Connection", Stream],
                                               None]] = None,
                 on_close: Optional[Callable[["Connection"], None]] = None,
                 huffman: str = "shorter") -> None:
        self.sock = sock
        self.client = client
        self.on_request = on_request
        self.on_close = on_close
        self.encoder = hpack.Encoder(huffman=huffman)
        self.decoder = hpack.Decoder()
        self.streams: Dict[int, Stream] = {}
        self._next_id = 1 if client else 2
        self._last_peer_id = 0
        self._lock = threading.Lock()  # streams, ids, windows
        self._flow = threading.Condition(self._lock)
        self._wlock = threading.Lock()  # socket writes, HPACK order
        self.send_window = DEFAULT_WINDOW  # the connection's, to the peer
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_frame = 16384
        self.closed = False
        self.goaway: Optional[int] = None  # the peer's last stream id
        self._reader: Optional[threading.Thread] = None
        self._rbuf = bytearray()
        # DATA bytes received and not yet credited back to the peer
        self._conn_unacked = 0

    # --------------------------------------------------------- lifecycle

    def start(self, preface_timeout: Optional[float] = None) -> None:
        """Send the preface (client) and SETTINGS, start the reader.  A
        server reads and checks the client's preface first, waiting at
        most ``preface_timeout`` seconds for it."""
        if not self.client:
            self.sock.settimeout(preface_timeout)
            try:
                got = self._recv_exact(len(PREFACE))
            finally:
                self.sock.settimeout(None)
            if got != PREFACE:
                self.close()
                raise ProtocolError(PROTOCOL_ERROR, "bad connection preface")
        settings = [(S_INITIAL_WINDOW_SIZE, RECV_WINDOW),
                    (S_MAX_FRAME_SIZE, RECV_MAX_FRAME)]
        if self.client:
            settings.append((S_ENABLE_PUSH, 0))
        else:
            settings.append((S_MAX_CONCURRENT_STREAMS, 1000))
        payload = b"".join(struct.pack(">HI", k, v) for k, v in settings)
        out = (PREFACE if self.client else b"") + _frame(SETTINGS, 0, 0,
                                                         payload)
        out += _frame(WINDOW_UPDATE, 0, 0,
                      struct.pack(">I", RECV_WINDOW - DEFAULT_WINDOW))
        self._send(out)
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"h2-{'client' if self.client else 'server'}-reader")
        self._reader.start()

    def close(self, code: Optional[int] = None) -> None:
        """Send GOAWAY (when ``code`` is given), shut the socket down and
        end every open stream."""
        if code is not None and not self.closed and \
                self._wlock.acquire(timeout=1.0):
            # a writer stuck on a peer that reads nothing must not hold
            # the close up: the shutdown below wakes it
            try:
                self.sock.sendall(_frame(GOAWAY, 0, 0, struct.pack(
                    ">II", self._last_peer_id, code)))
            except OSError:
                pass
            finally:
                self._wlock.release()
        with self._lock:
            was_closed = self.closed
            self.closed = True
            streams = list(self.streams.values())
            self._flow.notify_all()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        for s in streams:
            if not s.done.is_set():
                s.lost = True
                s.done.set()
        if not was_closed and self.on_close is not None:
            try:
                self.on_close(self)
            except Exception:
                log.exception("h2 on_close failed")

    def join(self, timeout: Optional[float] = None) -> None:
        if self._reader is not None and \
                self._reader is not threading.current_thread():
            self._reader.join(timeout)

    @property
    def usable(self) -> bool:
        return not self.closed and self.goaway is None

    # ------------------------------------------------------------ writes

    def _send(self, data: bytes) -> None:
        with self._wlock:
            self.sock.sendall(data)

    def start_stream(self, headers: Sequence[Tuple],
                     data: Optional[bytes] = None) -> Tuple[Stream, bool]:
        """Open a stream with its HEADERS (client); with ``data``, send
        it in the same write and end the stream when both windows allow
        it all.  Returns the stream and whether ``data`` went (if not,
        the caller sends it with `send_data`).  The id is taken under
        the write lock, so ids reach the wire in increasing order
        whatever the threads."""
        with self._wlock:
            with self._lock:
                if self.closed or self.goaway is not None:
                    raise StreamClosed("connection is closing")
                sid = self._next_id
                self._next_id += 2
                s = Stream(sid, self.peer_initial_window)
                self.streams[sid] = s
                sent = data is not None and self._take_all(s, len(data))
            out = self._header_frames(sid, headers, sent and not data)
            if sent and data:
                out += self._data_frames(sid, data, True)
            self.sock.sendall(out)
        if sent:
            self._local_end(sid)
        return s, sent

    def respond(self, sid: int, headers: Sequence[Tuple], data: bytes,
                trailers: Sequence[Tuple]) -> None:
        """A whole response: HEADERS, the body, trailers that end the
        stream; one write when the windows allow the body."""
        with self._wlock:
            with self._lock:
                s = self.streams.get(sid)
                if self.closed or s is None or s.reset is not None:
                    raise StreamClosed(f"stream {sid} closed")
                whole = self._take_all(s, len(data))
            out = self._header_frames(sid, headers, False)
            if whole:
                out += self._data_frames(sid, data, False)
                out += self._header_frames(sid, trailers, True)
            self.sock.sendall(out)
        if not whole:
            self.send_data(sid, data)
            self.send_headers(sid, trailers, end_stream=True)
        else:
            self._local_end(sid)

    def _take_all(self, s: Stream, n: int) -> bool:
        """Take ``n`` bytes of credit from both windows if both have it
        (caller holds ``_lock``)."""
        if n > self.send_window or n > s.send_window:
            return False
        self.send_window -= n
        s.send_window -= n
        return True

    def _data_frames(self, sid: int, data: bytes, end_stream: bool) -> bytes:
        limit = self.peer_max_frame
        out = bytearray()
        for k in range(0, max(len(data), 1), limit):
            last = k + limit >= len(data)
            out += _frame(DATA, END_STREAM if last and end_stream else 0,
                          sid, data[k:k + limit])
        return bytes(out)

    def send_headers(self, sid: int, headers: Sequence[Tuple],
                     end_stream: bool = False) -> None:
        if self.closed:
            raise StreamClosed("connection closed")
        with self._wlock:
            self.sock.sendall(self._header_frames(sid, headers, end_stream))
        if end_stream:
            self._local_end(sid)

    def _header_frames(self, sid: int, headers: Sequence[Tuple],
                       end_stream: bool) -> bytes:
        """HEADERS and its CONTINUATIONs (caller holds the write lock:
        the HPACK encoder's order is the wire's)."""
        block = self.encoder.encode(headers)
        limit = self.peer_max_frame
        first, rest = block[:limit], block[limit:]
        flags = END_STREAM if end_stream else 0
        if not rest:
            flags |= END_HEADERS
        out = bytearray(_frame(HEADERS, flags, sid, first))
        while rest:
            chunk, rest = rest[:limit], rest[limit:]
            out += _frame(CONTINUATION, 0 if rest else END_HEADERS, sid,
                          chunk)
        return bytes(out)

    def send_data(self, sid: int, data: bytes, end_stream: bool = False,
                  timeout: Optional[float] = None) -> bool:
        """Write ``data`` as DATA frames within the windows; False when
        ``timeout`` passed while waiting for credit."""
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        mv = memoryview(data)
        pos = 0
        while True:
            with self._lock:
                s = self.streams.get(sid)
                while True:
                    if self.closed or s is None or s.reset is not None:
                        raise StreamClosed(f"stream {sid} closed")
                    n = min(len(mv) - pos, self.send_window, s.send_window,
                            self.peer_max_frame)
                    if n > 0 or pos == len(mv):
                        break
                    wait = None if deadline is None else \
                        deadline - time.monotonic()
                    if wait is not None and wait <= 0:
                        return False
                    self._flow.wait(wait)
                self.send_window -= n
                s.send_window -= n
            last = pos + n == len(mv)
            flags = END_STREAM if (last and end_stream) else 0
            self._send(_frame(DATA, flags, sid, bytes(mv[pos:pos + n])))
            pos += n
            if last:
                break
        if end_stream:
            self._local_end(sid)
        return True

    def send_rst(self, sid: int, code: int) -> None:
        self._local_end(sid, drop=True)
        if not self.closed:
            try:
                self._send(_frame(RST_STREAM, 0, sid,
                                  struct.pack(">I", code)))
            except OSError:
                pass

    def _local_end(self, sid: int, drop: bool = False) -> None:
        with self._lock:
            s = self.streams.get(sid)
            if s is None:
                return
            s.closed_local = True
            if drop or s.done.is_set():
                self.streams.pop(sid, None)

    def forget(self, sid: int) -> None:
        with self._lock:
            self.streams.pop(sid, None)

    # ------------------------------------------------------------- reads

    def _recv_exact(self, n: int) -> bytes:
        """``n`` bytes, read ahead in 64 KiB gulps: several frames a
        system call."""
        buf = self._rbuf
        while len(buf) < n:
            chunk = self.sock.recv(max(65536, n - len(buf)))
            if not chunk:
                raise ConnectionError("peer closed the connection")
            buf += chunk
        out = bytes(buf[:n])
        del buf[:n]
        return out

    def _read_loop(self) -> None:
        code = None
        try:
            while True:
                head = self._recv_exact(9)
                n = (head[0] << 16) | (head[1] << 8) | head[2]
                ftype, flags = head[3], head[4]
                sid = struct.unpack(">I", head[5:9])[0] & 0x7FFFFFFF
                if n > RECV_MAX_FRAME:
                    raise ProtocolError(FRAME_SIZE_ERROR,
                                        f"frame of {n} bytes")
                payload = self._recv_exact(n) if n else b""
                self._on_frame(ftype, flags, sid, payload)
        except ProtocolError as exc:
            log.debug("h2 connection error: %s", exc)
            code = exc.code
        except (OSError, ConnectionError):
            pass
        except Exception:
            log.exception("h2 reader failed")
            code = INTERNAL_ERROR
        self.close(code)

    def _on_frame(self, ftype: int, flags: int, sid: int,
                  payload: bytes) -> None:
        if ftype == HEADERS:
            self._on_headers(flags, sid, payload)
        elif ftype == DATA:
            self._on_data(flags, sid, payload)
        elif ftype == SETTINGS:
            self._on_settings(flags, sid, payload)
        elif ftype == WINDOW_UPDATE:
            self._on_window_update(sid, payload)
        elif ftype == PING:
            if len(payload) != 8 or sid:
                raise ProtocolError(FRAME_SIZE_ERROR, "bad PING")
            if not flags & ACK:
                self._send(_frame(PING, ACK, 0, payload))
        elif ftype == RST_STREAM:
            if len(payload) != 4 or not sid:
                raise ProtocolError(PROTOCOL_ERROR, "bad RST_STREAM")
            code = struct.unpack(">I", payload)[0]
            with self._lock:
                s = self.streams.pop(sid, None)
                self._flow.notify_all()
            if s is not None:
                s.reset = code
                s.done.set()
        elif ftype == GOAWAY:
            if len(payload) < 8:
                raise ProtocolError(FRAME_SIZE_ERROR, "bad GOAWAY")
            last = struct.unpack(">I", payload[:4])[0] & 0x7FFFFFFF
            with self._lock:
                self.goaway = last
                gone = [s for i, s in self.streams.items()
                        if i > last and (i % 2 == 1) == self.client]
                for s in gone:
                    self.streams.pop(s.id, None)
                idle = not self.streams
            for s in gone:
                s.reset = REFUSED_STREAM
                s.done.set()
            if idle:
                raise ConnectionError("GOAWAY and nothing open")
        elif ftype == CONTINUATION:
            raise ProtocolError(PROTOCOL_ERROR, "CONTINUATION out of place")
        elif ftype == PUSH_PROMISE:
            raise ProtocolError(PROTOCOL_ERROR, "PUSH_PROMISE refused")
        # PRIORITY and unknown types are ignored

    @staticmethod
    def _unpad(flags: int, payload: bytes) -> bytes:
        if flags & PADDED:
            if not payload:
                raise ProtocolError(PROTOCOL_ERROR, "empty padded frame")
            pad = payload[0]
            if pad >= len(payload):
                raise ProtocolError(PROTOCOL_ERROR, "padding too long")
            return payload[1:len(payload) - pad]
        return payload

    def _on_headers(self, flags: int, sid: int, payload: bytes) -> None:
        if not sid:
            raise ProtocolError(PROTOCOL_ERROR, "HEADERS on stream 0")
        block = self._unpad(flags, payload)
        if flags & PRIORITY_FLAG:
            block = block[5:]
        block = bytearray(block)
        end_stream = bool(flags & END_STREAM)
        while not flags & END_HEADERS:
            head = self._recv_exact(9)
            n = (head[0] << 16) | (head[1] << 8) | head[2]
            ftype, flags = head[3], head[4]
            csid = struct.unpack(">I", head[5:9])[0] & 0x7FFFFFFF
            if ftype != CONTINUATION or csid != sid:
                raise ProtocolError(PROTOCOL_ERROR,
                                    "expected CONTINUATION")
            if n > RECV_MAX_FRAME:
                raise ProtocolError(FRAME_SIZE_ERROR, f"frame of {n} bytes")
            block += self._recv_exact(n)
        try:
            headers = self.decoder.decode(bytes(block))
        except hpack.HpackError as exc:
            raise ProtocolError(COMPRESSION_ERROR, str(exc)) from exc
        request = None
        with self._lock:
            s = self.streams.get(sid)
            if s is None:
                if self.client or sid % 2 == 0 or sid <= self._last_peer_id:
                    return  # a stream already closed here: drop the block
                self._last_peer_id = sid
                if self.closed or self.goaway is not None:
                    return
                s = self.streams[sid] = Stream(sid, self.peer_initial_window)
            if s.headers is None:
                s.headers = headers
            else:
                s.trailers = headers
            if end_stream:
                s.ended = True
                if self.client:
                    if s.closed_local:
                        self.streams.pop(sid, None)
                else:
                    request = s
        if end_stream:
            s.done.set()
            if request is not None and self.on_request is not None:
                self.on_request(self, request)

    def _on_data(self, flags: int, sid: int, payload: bytes) -> None:
        if not sid:
            raise ProtocolError(PROTOCOL_ERROR, "DATA on stream 0")
        n = len(payload)
        data = self._unpad(flags, payload)
        request = None
        over = False
        with self._lock:
            s = self.streams.get(sid)
            if s is not None and s.headers is not None and not s.ended:
                s.data += data
                over = len(s.data) > MAX_STREAM_BYTES
                if flags & END_STREAM and not over:
                    s.ended = True
                    if self.client:
                        if s.closed_local:
                            self.streams.pop(sid, None)
                    else:
                        request = s
            else:
                s = None
        if n:
            # credit back once half a window is used up: the connection
            # always, a stream while it is open
            out = b""
            self._conn_unacked += n
            if self._conn_unacked >= RECV_WINDOW // 2:
                out = _frame(WINDOW_UPDATE, 0, 0,
                             struct.pack(">I", self._conn_unacked))
                self._conn_unacked = 0
            if s is not None and not s.ended and not over:
                s.unacked += n
                if s.unacked >= RECV_WINDOW // 2:
                    out += _frame(WINDOW_UPDATE, 0, sid,
                                  struct.pack(">I", s.unacked))
                    s.unacked = 0
            if out:
                self._send(out)
        if over:
            self.send_rst(sid, ENHANCE_YOUR_CALM)
            s.reset = ENHANCE_YOUR_CALM
            s.done.set()
            return
        if s is not None and s.ended:
            s.done.set()
            if request is not None and self.on_request is not None:
                self.on_request(self, request)

    def _on_settings(self, flags: int, sid: int, payload: bytes) -> None:
        """Apply the peer's SETTINGS after the ACK is on the wire, under
        the write lock: a peer holds us to its old values until it has
        our ACK, so no frame sized by a new value may go before it."""
        if sid:
            raise ProtocolError(PROTOCOL_ERROR, "SETTINGS on a stream")
        if flags & ACK:
            return
        if len(payload) % 6:
            raise ProtocolError(FRAME_SIZE_ERROR, "bad SETTINGS")
        values = [struct.unpack(">HI", payload[k:k + 6])
                  for k in range(0, len(payload), 6)]
        for key, val in values:
            if key == S_INITIAL_WINDOW_SIZE and val > MAX_WINDOW:
                raise ProtocolError(FLOW_CONTROL_ERROR, "window too big")
            if key == S_MAX_FRAME_SIZE and not 16384 <= val <= 16777215:
                raise ProtocolError(PROTOCOL_ERROR, "bad MAX_FRAME_SIZE")
        with self._wlock:
            self.sock.sendall(_frame(SETTINGS, ACK, 0))
            with self._lock:
                for key, val in values:
                    if key == S_INITIAL_WINDOW_SIZE:
                        delta = val - self.peer_initial_window
                        self.peer_initial_window = val
                        for s in self.streams.values():
                            s.send_window += delta
                    elif key == S_MAX_FRAME_SIZE:
                        self.peer_max_frame = val
                    elif key == S_HEADER_TABLE_SIZE and \
                            val < self.encoder.table.max_size:
                        # this encoder adds nothing to the peer's dynamic
                        # table; a smaller table is announced all the same
                        self.encoder.set_max_table_size(val)
                self._flow.notify_all()

    def _on_window_update(self, sid: int, payload: bytes) -> None:
        if len(payload) != 4:
            raise ProtocolError(FRAME_SIZE_ERROR, "bad WINDOW_UPDATE")
        inc = struct.unpack(">I", payload)[0] & 0x7FFFFFFF
        if not inc:
            if not sid:
                raise ProtocolError(PROTOCOL_ERROR, "window increment 0")
            self.send_rst(sid, PROTOCOL_ERROR)
            return
        with self._lock:
            if not sid:
                self.send_window += inc
                if self.send_window > MAX_WINDOW:
                    raise ProtocolError(FLOW_CONTROL_ERROR,
                                        "connection window overflow")
            else:
                s = self.streams.get(sid)
                if s is None:
                    return
                s.send_window += inc
            self._flow.notify_all()
