"""The port's unary gRPC (`grpc_util.py` over `h2.py`) against grpcio,
both ways, and against itself: unary calls, ``.future``, a deadline, an
unknown method, a dead peer, 2 MiB messages across the flow-control
windows, 64 concurrent calls from threads on one channel; after
``stop()`` no connection the server accepted is left open.  Every call
has a timeout, so a fault fails the test instead of hanging it."""

import socket
import threading
import time
from concurrent import futures

import grpc
import pytest

from emqx_tpu_torch import grpc_util as G

PAIRINGS = ["port-client:grpcio-server", "grpcio-client:port-server",
            "port-client:port-server"]
BIG = bytes(range(256)) * (8 * 1024)  # 2 MiB


def echo(req, ctx):
    if req.startswith(b"sleep"):
        time.sleep(1.0)
    if req == b"fail":
        raise RuntimeError("boom")
    return req[::-1]


class Pair:
    """One client and one server of the pairing, an echo service on
    ``/t.Echo/Call``."""

    def __init__(self, pairing):
        client, server = pairing.split(":")
        self.port_server = server == "port-server"
        if self.port_server:
            self.srv = G.Server(max_workers=8)
            self.srv.add_method("/t.Echo/Call", echo)
        else:
            self.srv = grpc.server(futures.ThreadPoolExecutor(8))
            self.srv.add_generic_rpc_handlers((
                grpc.method_handlers_generic_handler("t.Echo", {
                    "Call": grpc.unary_unary_rpc_method_handler(echo)}),))
        self.port = self.srv.add_insecure_port("127.0.0.1:0")
        self.srv.start()
        self.port_client = client == "port-client"
        target = f"127.0.0.1:{self.port}"
        self.ch = G.Channel(target) if self.port_client else \
            grpc.insecure_channel(target)

    def method(self, path="/t.Echo/Call"):
        return self.ch.unary_unary(path)

    def code(self, exc):
        return exc.code().name

    @property
    def RpcError(self):
        return G.RpcError if self.port_client else grpc.RpcError

    def close(self):
        self.ch.close()
        if self.port_server:
            self.srv.stop(0.5).wait(10)
        else:
            self.srv.stop(0).wait(10)


@pytest.fixture(params=PAIRINGS)
def pair(request):
    p = Pair(request.param)
    yield p
    p.close()
    if p.port_server:
        assert p.srv.connections == []


def test_unary_call(pair):
    assert pair.method()(b"hello", timeout=10) == b"olleh"
    assert pair.method()(b"", timeout=10) == b""


def test_future(pair):
    futs = [pair.method().future(b"%d" % i, timeout=10) for i in range(8)]
    done = threading.Event()
    futs[0].add_done_callback(lambda f: done.set())
    assert [f.result(timeout=10) for f in futs] == [
        (b"%d" % i)[::-1] for i in range(8)]
    assert done.wait(10) and futs[0].exception() is None


def test_deadline_exceeded(pair):
    with pytest.raises(pair.RpcError) as err:
        pair.method()(b"sleep", timeout=0.2)
    assert pair.code(err.value) == "DEADLINE_EXCEEDED"
    # the channel still serves
    assert pair.method()(b"ab", timeout=10) == b"ba"


def test_unknown_method_unimplemented(pair):
    with pytest.raises(pair.RpcError) as err:
        pair.method("/t.Echo/Nope")(b"x", timeout=10)
    assert pair.code(err.value) == "UNIMPLEMENTED"


def test_handler_exception_is_unknown(pair):
    with pytest.raises(pair.RpcError) as err:
        pair.method()(b"fail", timeout=10)
    assert pair.code(err.value) == "UNKNOWN"
    assert "boom" in err.value.details()


def test_dead_peer_unavailable(pair):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()[1]
    s.close()  # nothing listens there now
    ch = G.Channel(f"127.0.0.1:{dead}") if pair.port_client else \
        grpc.insecure_channel(f"127.0.0.1:{dead}")
    try:
        with pytest.raises(pair.RpcError) as err:
            ch.unary_unary("/t.Echo/Call")(b"x", timeout=5)
        assert pair.code(err.value) == "UNAVAILABLE"
    finally:
        ch.close()


def test_peer_gone_mid_call_unavailable(pair):
    """The server goes away while a call waits: UNAVAILABLE (or
    CANCELLED from a grpcio server that cancels its calls)."""
    fut = pair.method().future(b"sleep", timeout=10)
    time.sleep(0.3)
    pair.srv.stop(0)
    with pytest.raises(pair.RpcError) as err:
        fut.result(timeout=10)
    assert pair.code(err.value) in ("UNAVAILABLE", "CANCELLED")


def test_two_mib_messages_across_the_windows(pair):
    assert pair.method()(BIG, timeout=30) == BIG[::-1]
    assert pair.method()(BIG[:70000], timeout=30) == BIG[:70000][::-1]


def test_64_concurrent_calls_from_threads_share_one_channel(pair):
    results = {}

    def call(i):
        body = (b"%03d" % i) * (1 + i * 97)
        results[i] = pair.method()(body, timeout=30) == body[::-1]

    threads = [threading.Thread(target=call, args=(i,)) for i in range(64)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert results == {i: True for i in range(64)}
    if pair.port_client:
        assert len([c for c in (pair.ch._conn, *pair.ch._old)
                    if c is not None]) == 1
    if pair.port_server:
        assert len(pair.srv.connections) == 1


def test_stop_closes_every_accepted_connection():
    srv = G.Server(max_workers=2)
    srv.add_method("/t.Echo/Call", echo)
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    chans = [G.Channel(f"127.0.0.1:{port}") for _ in range(3)]
    raw = socket.create_connection(("127.0.0.1", port), timeout=5)
    raw.sendall(b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n")
    try:
        for ch in chans:
            assert ch.unary_unary("/t.Echo/Call")(b"ab", timeout=10) == b"ba"
        deadline = time.monotonic() + 10
        while len(srv.connections) < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(srv.connections) == 4
        conns = srv.connections
        assert srv.stop(0.5).wait(10)
        assert srv.connections == []
        assert all(c.closed and c.sock.fileno() == -1 for c in conns)
        # the peers see the end: GOAWAY then EOF
        raw.settimeout(5)
        got = b""
        while True:
            chunk = raw.recv(4096)
            if not chunk:
                break
            got += chunk
        assert b"\x07\x00" in got  # a GOAWAY frame type among them
        with pytest.raises(G.RpcError) as err:
            chans[0].unary_unary("/t.Echo/Call")(b"x", timeout=5)
        assert err.value.code() is G.StatusCode.UNAVAILABLE
    finally:
        raw.close()
        for ch in chans:
            ch.close()


def test_timeout_and_message_encodings():
    assert G.encode_timeout(0.2) == "200000u"
    assert G.encode_timeout(3600 * 24) == "86400000m"
    assert G.encode_timeout(3600 * 24 * 10 ** 4) == "14400000M"
    assert G.percent_decode(G.percent_encode("a%b ü\n")) == "a%b ü\n"
    assert G.read_message(G.frame_message(b"xyz")) == b"xyz"
    with pytest.raises(ValueError):
        G.read_message(b"\x01\x00\x00\x00\x00")
