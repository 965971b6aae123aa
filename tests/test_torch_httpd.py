"""The port's HTTP/1.1 server (`emqx_tpu_torch.httpd`) against the
JAX package's aiohttp app, in raw request bytes.

The same bytes go to both management APIs (tests/test_torch_mgmt.py's
pair of servers on one background loop); the responses are split and
compared by status line, content type, ``Allow``/``WWW-Authenticate``/
``Connection``/``Content-Length`` headers and body (JSON parsed and
normalised).  ``Date`` and ``Server`` are not compared.  Cases:
``Content-Length`` and chunked bodies, a body of 1 MiB and more (413),
HEAD, keep-alive across requests and pipelined ones, ``Connection:
close``, a malformed request line or header (400, and the server still
accepts the next connection), the percent-encoded topic-metrics path,
and `httpd`'s own path decoding.
"""

import json

import pytest

from emqx_tpu_torch import httpd

from test_torch_mgmt import (LIMIT, Loop, _token, araw, norm, start_pair,
                             stop_all)

COMPARED = ("content-type", "allow", "www-authenticate", "connection",
            "content-length")


@pytest.fixture(scope="module")
def L():
    lp = Loop()
    yield lp
    lp.close()


def split_responses(raw: bytes, head: bool = False):
    """[(status line, {header: value}, body)] of the raw bytes; a body
    runs for its Content-Length (none after HEAD, 204 or without
    one)."""
    out = []
    while raw:
        head_end = raw.index(b"\r\n\r\n")
        lines = raw[:head_end].decode("latin-1").split("\r\n")
        hdrs = {}
        for line in lines[1:]:
            k, _, v = line.partition(":")
            hdrs[k.strip().lower()] = v.strip()
        raw = raw[head_end + 4:]
        status = lines[0]
        n = 0 if head or " 204 " in status or " 100 " in status \
            else int(hdrs.get("content-length", 0) or 0)
        if "content-length" not in hdrs and not head and n == 0 \
                and " 204 " not in status and " 100 " not in status:
            n = len(raw)  # read to the close
        out.append((status, hdrs, raw[:n]))
        raw = raw[n:]
    return out


def comparable(responses):
    res = []
    for status, hdrs, body in responses:
        if hdrs.get("content-type", "").startswith("application/json") \
                and body:
            body = norm(json.loads(body))
        res.append((status, {k: hdrs.get(k) for k in COMPARED}, body))
    return res


async def both_raw(ref, prt, data: bytes, auth=True, head=False,
                   timeout=2.0):
    """Send ``data`` (``{auth}`` replaced by each server's Bearer
    header line) to both; their comparable responses."""
    outs = []
    for srv in (ref, prt):
        port = srv.api.port
        raw = data
        if auth:
            tok = (await _token(port))["Authorization"]
            raw = data.replace(b"{auth}", b"Authorization: " +
                               tok.encode())
        outs.append(comparable(split_responses(
            await araw(port, raw, timeout), head=head)))
    return outs


def req(method, path, body=b"", extra=b"", close=True):
    hdrs = b"Host: x\r\n{auth}\r\n" + extra
    if body:
        hdrs += b"Content-Length: %d\r\n" % len(body)
    if close:
        hdrs += b"Connection: close\r\n"
    return b"%s %s HTTP/1.1\r\n%s\r\n%s" % (method.encode(), path.encode(),
                                            hdrs, body)


def chunked(method, path, body: bytes, sizes=(3, 7, 1)):
    parts, pos = [], 0
    for n in sizes:
        if pos >= len(body):
            break
        piece = body[pos:pos + n]
        parts.append(b"%x;ext=1\r\n%s\r\n" % (len(piece), piece))
        pos += n
    if pos < len(body):
        parts.append(b"%x\r\n%s\r\n" % (len(body) - pos, body[pos:]))
    parts.append(b"0\r\nX-Trailer: 1\r\n\r\n")
    return (b"%s %s HTTP/1.1\r\nHost: x\r\n{auth}\r\nTransfer-Encoding: "
            b"chunked\r\nConnection: close\r\n\r\n" % (method.encode(),
                                                      path.encode())
            + b"".join(parts))


PUBLISH = json.dumps({"topic": "t/1", "payload": "hi", "qos": 0}).encode()


@pytest.mark.parametrize("name,data,head", [
    ("content-length body", req("POST", "/api/v5/publish", PUBLISH), False),
    ("chunked body", chunked("POST", "/api/v5/publish", PUBLISH), False),
    ("chunked rule", chunked("POST", "/api/v5/rules", json.dumps(
        {"id": "c1", "sql": 'SELECT * FROM "c/#"'}).encode(), (1, 2, 40)),
     False),
    ("empty body", req("POST", "/api/v5/publish", b"", b"Content-Length: "
                       b"0\r\n"), False),
    ("not json", req("POST", "/api/v5/rules", b"{nope"), False),
    ("head json", req("HEAD", "/api/v5/stats"), True),
    ("head dashboard", req("HEAD", "/dashboard"), True),
    ("head 404", req("HEAD", "/api/v5/none"), True),
    ("204", req("DELETE", "/api/v5/alarms"), False),
    ("404 empty", req("DELETE", "/api/v5/api_key/key-x"), False),
    ("405", req("PATCH", "/api/v5/stats"), False),
    ("401", b"GET /api/v5/stats HTTP/1.1\r\nHost: x\r\n"
            b"Connection: close\r\n\r\n", False),
    ("http/1.0", b"GET /api/v5/stats HTTP/1.0\r\n{auth}\r\n\r\n", False),
    ("http/1.0 keep-alive then close",
     b"GET /api/v5/stats HTTP/1.0\r\n{auth}\r\nConnection: keep-alive"
     b"\r\n\r\nGET /api/v5/stats HTTP/1.0\r\n{auth}\r\n\r\n", False),
    ("keep-alive, three requests",
     req("GET", "/api/v5/stats", close=False)
     + req("POST", "/api/v5/publish", PUBLISH, close=False)
     + req("GET", "/api/v5/banned"), False),
    ("keep-alive past an unread body",
     req("GET", "/api/v5/stats", b"x" * 70000, close=False)
     + req("GET", "/api/v5/stats"), False),
    ("expect 100-continue",
     req("POST", "/api/v5/publish", PUBLISH, b"Expect: 100-continue\r\n"),
     False),
    ("query string", req("GET", "/api/v5/alarms?activated=false&x=%ZZ&"
                         "activated=true"), False),
    ("escaped login path", b"POST /api/v5/log%69n HTTP/1.1\r\nHost: x\r\n"
     b"Content-Length: 40\r\nConnection: close\r\n\r\n"
     b'{"username":"admin","password":"public"}', False),
])
def test_raw_requests_equal_aiohttp(L, name, data, head):
    async def t():
        ref, prt = await start_pair()
        try:
            return await both_raw(ref, prt, data, head=head)
        finally:
            await stop_all(ref, prt)

    rr, pp = L.run(t(), LIMIT)
    if name == "escaped login path":  # a token each: compare the shape
        def shape(resps):  # the token's length varies
            return [(s, {k: v for k, v in h.items()
                         if k != "content-length"}, sorted(b))
                    for s, h, b in resps]

        assert shape(pp) == shape(rr) and pp[0][0].endswith("200 OK")
        return
    assert pp == rr and pp, (name, pp, rr)


@pytest.mark.parametrize("size,open_route", [
    (1024 * 1024 - 1, False), (1024 * 1024, False), (1024 * 1024 + 1, True),
    (3 * 1024 * 1024, True)])
def test_body_cap_413_like_aiohttp(L, size, open_route):
    """A body of 1 MiB or more answers 413 (aiohttp's default cap) and
    closes; one byte less is read.  The open login route reads at most
    the cap of an unauthenticated body."""
    path = "/api/v5/login" if open_route else "/api/v5/publish"
    body = b'{"topic": "t", "payload": "' + b"x" * (size - 29) + b'"}'
    assert len(body) == size
    data = req("POST", path, body)
    if open_route:
        data = data.replace(b"{auth}\r\n", b"")

    async def t():
        ref, prt = await start_pair()
        try:
            out = await both_raw(ref, prt, data, auth=not open_route,
                                 timeout=5.0)
            # the server still serves the next connection
            again = await both_raw(ref, prt, req("GET", "/api/v5/stats"))
            return out, again
        finally:
            await stop_all(ref, prt)

    (rr, pp), (ra, pa) = L.run(t(), LIMIT)
    want = "413" if size >= 1024 * 1024 else "200"
    assert rr[0][0].split(" ")[1] == pp[0][0].split(" ")[1] == want
    assert [h for _, h, _ in pp] == [h for _, h, _ in rr] or want == "413"
    assert pp[0][1]["content-type"] == rr[0][1]["content-type"]
    if want == "413":
        assert pp[0][2].startswith(b"Maximum request body size 1048576 "
                                   b"exceeded, actual body size ")
    assert pa == ra and pa[0][0].endswith("200 OK")


@pytest.mark.parametrize("data", [
    b"GARBAGE\r\n\r\n",
    b"get /api/v5/stats HTTP/1.1\r\nHost: x\r\n\r\n",
    b"GET /api/v5/stats HTTP/1.1\r\nbad header line\r\n\r\n",
    b"GET /api/v5/stats HTTP/1.1\r\n Host: x\r\n\r\n",
    b"GET api/v5/stats HTTP/1.1\r\nHost: x\r\n\r\n",
    b"GET /api/v5/stats HTTP/1.1\r\nContent-Length: 1\r\n"
    b"Transfer-Encoding: chunked\r\n\r\n0\r\n\r\n",
    b"GET /api/v5/stats HTTP/1.1\r\nContent-Length: abc\r\n\r\n",
    b"GET /api/v5/stats HTTP/1.1\r\nTransfer-Encoding: gzip\r\n\r\n",
    b"GET /" + b"a" * 9000 + b" HTTP/1.1\r\n\r\n",
])
def test_malformed_request_400_and_accept_loop_lives(L, data):
    """A malformed request line or header block answers 400 and closes
    the connection, in both; the next connection is served."""

    async def t():
        ref, prt = await start_pair()
        try:
            outs = []
            for srv in (ref, prt):
                outs.append(split_responses(await araw(srv.api.port, data)))
            again = await both_raw(ref, prt, req("GET", "/api/v5/stats"))
            return outs, again
        finally:
            await stop_all(ref, prt)

    (rr, pp), (ra, pa) = L.run(t(), LIMIT)
    assert len(pp) == len(rr) == 1
    assert pp[0][0] == rr[0][0] == "HTTP/1.0 400 Bad Request"
    assert pp[0][1]["content-type"] == rr[0][1]["content-type"]
    assert pa == ra and pa[0][0].endswith("200 OK")


def _chunked_raw(chunks: bytes) -> bytes:
    return (b"POST /api/v5/publish HTTP/1.1\r\nHost: x\r\n{auth}\r\n"
            b"Transfer-Encoding: chunked\r\n\r\n" + chunks)


@pytest.mark.parametrize("chunks", [
    b"1_0\r\n" + b"x" * 16 + b"\r\n0\r\n\r\n",
    b"zz\r\nxx\r\n0\r\n\r\n",
    b"+2\r\n{}\r\n0\r\n\r\n",
    b"2\r\n{}XX0\r\n\r\n",
])
def test_malformed_chunked_body_400_like_aiohttp(L, chunks):
    """A chunked body with a bad size line or a chunk not ended by CRLF
    answers 400 in both, and the next connection is served."""

    async def t():
        ref, prt = await start_pair()
        try:
            outs = await both_raw(ref, prt, _chunked_raw(chunks))
            again = await both_raw(ref, prt, req("GET", "/api/v5/stats"))
            return outs, again
        finally:
            await stop_all(ref, prt)

    (rr, pp), (ra, pa) = L.run(t(), LIMIT)
    assert [x[0].split(" ")[1] for x in pp] == \
        [x[0].split(" ")[1] for x in rr] == ["400"]
    assert pa == ra and pa[0][0].endswith("200 OK")


@pytest.mark.parametrize("encoded,topic", [
    ("a%2F%2B%2Fb", "a/+/b"),
    ("a%252F%252B%252Fb", "a/+/b"),
    ("a%2F%23", "a/#"),
    ("s%2F%C3%A9%2F%2B", "s/é/+"),
])
def test_topic_metrics_escaped_delete_reaches_the_same_topic(L, encoded,
                                                             topic):
    """``DELETE /api/v5/mqtt/topic_metrics/<escaped>`` in raw bytes: the
    server decodes the path parameter once and the handler once more,
    in both packages, so both unregister the same topic."""

    async def t():
        ref, prt = await start_pair()
        try:
            for srv in (ref, prt):
                srv.broker.topic_metrics.register(topic)
            out = await both_raw(ref, prt, req(
                "DELETE", f"/api/v5/mqtt/topic_metrics/{encoded}"))
            left = [len(srv.broker.topic_metrics.info())
                    for srv in (ref, prt)]
            return out, left
        finally:
            await stop_all(ref, prt)

    (rr, pp), left = L.run(t(), LIMIT)
    assert pp == rr
    assert pp[0][0].endswith("204 No Content"), pp
    assert left == [0, 0]


@pytest.mark.parametrize("raw,path,safe", [
    ("/t/a%2F%2B%2Fb", "/t/a/+/b", "/t/a%2F+%2Fb"),
    ("/t/a%252F", "/t/a%2F", "/t/a%252F"),
    ("/t/a+b%20c%25", "/t/a+b c%", "/t/a+b c%25"),
    ("/t/%C3%A9%FF", "/t/é%FF", "/t/é%FF"),
    ("/t/%e2%82%ac%2f", "/t/€/", "/t/€%2F"),
    ("/t/100%", "/t/100%", "/t/100%"),
])
def test_path_decoding(raw, path, safe):
    """`httpd` decodes the path as yarl does for aiohttp's
    ``request.path``, and keeps ``%2F``/``%25`` while routing."""
    assert httpd._unquote(raw) == path
    assert httpd._unquote(raw, keep=httpd._SAFE_KEEP) == safe
