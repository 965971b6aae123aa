"""The port's own HTTP/1.1 client (`httpc`) against aiohttp servers and
raw sockets: Content-Length, chunked and read-to-close bodies, HEAD and
204, keep-alive on one connection, a pooled connection the server
closed while idle, the total timeout, request bodies encoded as aiohttp
encodes them, `Response.json` as aiohttp's, https with the test
certificate; and the HTTP sink delivering with aiohttp unimportable
(the F3 repair: the sink needs nothing outside the standard library).

Every scenario runs under `asyncio.wait_for` with its own limit.
"""

import asyncio
import os
import ssl
import sys

import pytest
from aiohttp import web

from emqx_tpu_torch import httpc
from emqx_tpu_torch import resources as R

LIMIT = 20.0
TLS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_tls")


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT))


class Site:
    """An aiohttp app on a loopback port, recording each request and the
    peer port it came from (one peer port: one connection)."""

    def __init__(self, ssl_context=None) -> None:
        self.seen = []
        self.ssl_context = ssl_context
        self.app = web.Application()
        self.app.router.add_route("*", "/{tail:.*}", self.handle)

    async def handle(self, request):
        body = await request.read()
        peer = request.transport.get_extra_info("peername")[1]
        self.seen.append((request.method, request.path_qs, dict(
            request.headers), body, peer))
        tail = request.match_info["tail"]
        if tail == "chunked":
            resp = web.StreamResponse(status=200)
            resp.enable_chunked_encoding()
            resp.content_type = "application/json"
            await resp.prepare(request)
            for part in (b'{"a": ', b"[1, 2", b"]}"):
                await resp.write(part)
            await resp.write_eof()
            return resp
        if tail == "slow":
            await asyncio.sleep(1.0)
        if tail == "nocontent":
            return web.Response(status=204)
        if tail == "text":
            return web.Response(text="héllo", charset="latin-1")
        if tail == "empty-json":
            return web.Response(body=b"  ", content_type="application/json")
        if tail == "problem":
            return web.Response(body=b'{"e": 1}',
                                content_type="application/problem+json")
        if tail == "close":
            return web.json_response({"closing": True},
                                     headers={"Connection": "close"})
        return web.json_response({"method": request.method, "n": len(body)})

    async def __aenter__(self):
        self.runner = web.AppRunner(self.app, access_log=None)
        await self.runner.setup()
        site = web.TCPSite(self.runner, "127.0.0.1", 0,
                           ssl_context=self.ssl_context)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1]
        scheme = "https" if self.ssl_context else "http"
        self.url = f"{scheme}://127.0.0.1:{self.port}"
        return self

    async def __aexit__(self, *exc):
        await self.runner.cleanup()


def test_bodies_keep_alive_and_json():
    async def t():
        async with Site() as s:
            c = httpc.Client(timeout=5)
            try:
                r1 = await c.get(s.url + "/plain?x=1&y=%2F")
                r2 = await c.post(s.url + "/chunked", json={"k": [1]})
                r3 = await c.head(s.url + "/plain")
                r4 = await c.put(s.url + "/nocontent", data=b"\x00\x01")
                r5 = await c.get(s.url + "/text")
                r6 = await c.get(s.url + "/empty-json")
                r7 = await c.get(s.url + "/problem")
                r8 = await c.request("DELETE", s.url + "/plain",
                                     data="ü", headers={"X-K": "v"})
                opened = c.connections_opened
            finally:
                await c.close()
            return [r1, r2, r3, r4, r5, r6, r7, r8], s.seen, opened

    rs, seen, opened = run(t())
    r1, r2, r3, r4, r5, r6, r7, r8 = rs
    assert (r1.status, r1.json()) == (200, {"method": "GET", "n": 0})
    assert (r2.status, r2.json()) == (200, {"a": [1, 2]})
    assert (r3.status, r3.body) == (200, b"")
    assert (r4.status, r4.body) == (204, b"")
    assert r5.text() == "héllo" and r5.charset() == "latin-1"
    with pytest.raises(httpc.ContentTypeError):
        r5.json()
    assert r6.json() is None and r7.json() == {"e": 1}
    assert r8.json() == {"method": "DELETE", "n": 2}
    assert opened == 1 and len({p for *_, p in seen}) == 1  # one connection
    assert seen[0][1] == "/plain?x=1&y=%2F"
    assert seen[1][2]["Content-Type"] == "application/json"
    assert seen[1][3] == b'{"k": [1]}'
    assert seen[3][2]["Content-Type"] == "application/octet-stream"
    assert seen[7][2]["Content-Type"] == "text/plain; charset=utf-8"
    assert seen[7][2]["X-K"] == "v" and seen[7][3] == "ü".encode()


def test_caller_content_type_wins_and_exclusive_bodies():
    async def t():
        async with Site() as s:
            c = httpc.Client()
            try:
                await c.post(s.url + "/x", data="a=1", headers={
                    "content-type": "application/x-www-form-urlencoded"})
                with pytest.raises(ValueError):
                    await c.post(s.url + "/x", data="a", json={})
                with pytest.raises(ValueError):
                    await c.get("ftp://127.0.0.1/x")
            finally:
                await c.close()
            return s.seen

    (seen,) = [run(t())]
    assert seen[0][2]["Content-Type"] == "application/x-www-form-urlencoded"


def test_server_closing_and_idle_drop_dial_anew():
    """``Connection: close`` is honoured, and a pooled connection that
    died while idle is left in the pool unused and replaced."""

    async def t():
        async with Site() as s:
            c = httpc.Client()
            try:
                a = await c.get(s.url + "/close")
                b = await c.get(s.url + "/x")
                # kill the pooled connection
                for conns in c._idle.values():
                    for conn in conns:
                        conn.writer.transport.abort()
                await asyncio.sleep(0.05)
                d = await c.get(s.url + "/x")
                opened = c.connections_opened
            finally:
                await c.close()
            return a, b, d, opened

    a, b, d, opened = run(t())
    assert a.json() == {"closing": True}
    assert b.status == d.status == 200
    assert opened == 3


def test_stale_pooled_connection_is_retried_once():
    """A server that answers one request a connection and then closes
    without saying so: the next request finds the pooled connection
    dead (EOF before the status line) and goes out on a fresh one."""

    async def t():
        served = []

        async def handler(r, w):
            await r.readuntil(b"\r\n\r\n")
            served.append(1)
            w.write(b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok")
            await w.drain()
            await asyncio.sleep(0.05)
            w.close()

        srv = await asyncio.start_server(handler, "127.0.0.1", 0)
        url = f"http://127.0.0.1:{srv.sockets[0].getsockname()[1]}/"
        c = httpc.Client()
        try:
            first = await c.get(url)
            await asyncio.sleep(0.2)
            second = await c.get(url)
            opened = c.connections_opened
        finally:
            await c.close()
            srv.close()
            await srv.wait_closed()
        return first.body, second.body, opened, len(served)

    assert run(t()) == (b"ok", b"ok", 2, 2)


def test_read_to_close_and_malformed_responses():
    async def t():
        answers = iter([
            b"HTTP/1.0 200 OK\r\nContent-Type: text/plain\r\n\r\nuntil eof",
            b"garbage\r\n\r\n",
            b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\nzz\r\n",
            b"HTTP/1.1 200 OK\r\nContent-Length: 10\r\n\r\nshort",
            b"",
        ])

        async def handler(r, w):
            await r.readuntil(b"\r\n\r\n")
            w.write(next(answers))
            await w.drain()
            w.close()

        srv = await asyncio.start_server(handler, "127.0.0.1", 0)
        url = f"http://127.0.0.1:{srv.sockets[0].getsockname()[1]}/"
        c = httpc.Client()
        out = [(await c.get(url)).body]
        for _ in range(4):
            try:
                await c.get(url)
                out.append("no error")
            except (httpc.HttpClientError, ConnectionError) as exc:
                out.append(type(exc).__name__)
        await c.close()
        srv.close()
        await srv.wait_closed()
        return out

    assert run(t()) == [b"until eof", "HttpClientError", "HttpClientError",
                        "ConnectionError", "ConnectionError"]


def test_total_timeout_closes_the_connection():
    async def t():
        async with Site() as s:
            c = httpc.Client(timeout=0.2)
            try:
                with pytest.raises(asyncio.TimeoutError):
                    await c.get(s.url + "/slow")
                idle = sum(len(v) for v in c._idle.values())
                ok = await c.get(s.url + "/x")
                return idle, ok.status, c.connections_opened
            finally:
                await c.close()

    assert run(t()) == (0, 200, 2)


def test_https_with_the_test_certificate():
    async def t():
        sctx = ssl.create_default_context(ssl.Purpose.CLIENT_AUTH)
        sctx.load_cert_chain(os.path.join(TLS, "cert.pem"),
                             os.path.join(TLS, "key.pem"))
        async with Site(ssl_context=sctx) as s:
            cctx = ssl.create_default_context(
                cafile=os.path.join(TLS, "cert.pem"))
            c = httpc.Client(ssl=cctx)
            try:
                r = await c.post(s.url + "/x", json={"a": 1})
                r2 = await c.get(s.url + "/x")
                untrusted = httpc.Client()
                with pytest.raises(ssl.SSLError):
                    await untrusted.get(s.url + "/x")
                await untrusted.close()
                return r.json(), r2.status, c.connections_opened
            finally:
                await c.close()

    assert run(t()) == ({"method": "POST", "n": 8}, 200, 1)


def test_http_sink_delivers_with_aiohttp_unimportable(monkeypatch):
    """F3: the HTTP sink starts, probes and delivers with no aiohttp to
    import (the server side here is aiohttp, imported before the block)."""

    async def t():
        async with Site() as s:
            monkeypatch.setitem(sys.modules, "aiohttp", None)
            sink = R.HttpSink(s.url + "/hook", headers={"X-K": "v"})
            w = R.BufferWorker(sink, retry_base=0.005)
            await w.start()
            try:
                status = w.status
                for q in ("a", b"b", {"j": 1}):
                    w.enqueue(q)
                for _ in range(500):
                    if w.stats["success"] == 3:
                        break
                    await asyncio.sleep(0.01)
            finally:
                await w.stop()
            return status, dict(w.stats), [
                (m, h.get("X-K"), b) for m, _p, h, b, _ in s.seen]

    status, stats, seen = run(t())
    assert status == "connected" and stats["success"] == 3
    assert seen == [("HEAD", "v", b""), ("POST", "v", b"a"),
                    ("POST", "v", b"b"), ("POST", "v", b'{"j": 1}')]
