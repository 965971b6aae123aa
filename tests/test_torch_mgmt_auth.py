"""Management-plane authentication in the port: the nine cases of
tests/test_mgmt_auth.py against `emqx_tpu_torch`'s API (401 without
credentials, JWT login, API keys with hashed secrets and roles, the
viewer's read-only rule and its own password change, the publisher
role, the audit log across a restart, the store's hashing and
refusals), driven with `http.client` from worker threads; then a
``data_dir`` written by either package's `MgmtAuth` logs in and
verifies on the other's.

Every test's coroutine runs under `asyncio.wait_for` with its own limit.
"""

import asyncio
import json

import pytest

from emqx_tpu.mgmt_auth import MgmtAuth as RefAuth

from emqx_tpu_torch.mgmt_auth import AuditLog, MgmtAuth

from mqtt_client import TestClient
from test_torch_mgmt import LIMIT, _token, acall, basic, port_server


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT))


def test_unauthenticated_requests_rejected(tmp_path):
    async def t():
        srv = port_server(str(tmp_path))
        await srv.start()
        port = srv.api.port
        c = TestClient(srv.listeners[0].port, "victim")
        await c.connect()
        try:
            for method, path, body in (
                ("DELETE", "/api/v5/clients/victim", None),
                ("POST", "/api/v5/publish", {"topic": "t", "payload": "x"}),
                ("PUT", "/api/v5/configs",
                 {"path": "mqtt.max_qos_allowed", "value": 1}),
                ("GET", "/api/v5/clients", None),
                ("GET", "/api/v5/audit", None),
                ("POST", "/api/v5/api_key", {"name": "x"}),
            ):
                st, *_ = await acall(port, method, path, body)
                assert st == 401, (method, path, st)
            st, *_ = await acall(port, "POST", "/api/v5/login",
                                 {"username": "admin", "password": "wrong"})
            assert st == 401
            for hdr in ("Bearer not.a.token", "Basic bm9wZTpub3Bl"):
                st, *_ = await acall(port, "GET", "/api/v5/clients", None,
                                     {"Authorization": hdr})
                assert st == 401, hdr
            assert srv.broker.cm.connected("victim")
        finally:
            await c.close()
            await srv.stop()

    run(t())


def test_login_token_and_api_key_flows(tmp_path):
    async def t():
        srv = port_server(str(tmp_path))
        await srv.start()
        port = srv.api.port
        try:
            adm = await _token(port)
            st, *_ = await acall(port, "GET", "/api/v5/clients", None, adm)
            assert st == 200
            st, *_ = await acall(port, "POST", "/api/v5/publish",
                                 {"topic": "t/x", "payload": "hi"}, adm)
            assert st == 200
            st, _, kd, _ = await acall(port, "POST", "/api/v5/api_key",
                                       {"name": "ci",
                                        "role": "administrator"}, adm)
            assert st == 201
            keyed = basic(kd["api_key"], kd["api_secret"])
            st, *_ = await acall(port, "GET", "/api/v5/stats", None, keyed)
            assert st == 200
            st, *_ = await acall(port, "DELETE",
                                 f"/api/v5/api_key/{kd['api_key']}", None,
                                 keyed)
            assert st == 204
            st, *_ = await acall(port, "GET", "/api/v5/stats", None, keyed)
            assert st == 401
        finally:
            await srv.stop()

    run(t())


def test_viewer_role_is_read_only(tmp_path):
    async def t():
        srv = port_server(str(tmp_path))
        await srv.start()
        port = srv.api.port
        try:
            st, *_ = await acall(port, "POST", "/api/v5/users", {
                "username": "auditor", "password": "s3cret",
                "role": "viewer"}, await _token(port))
            assert st == 201
            viewer = await _token(port, "auditor", "s3cret")
            st, *_ = await acall(port, "GET", "/api/v5/metrics", None,
                                 viewer)
            assert st == 200
            st, *_ = await acall(port, "POST", "/api/v5/publish",
                                 {"topic": "t", "payload": "x"}, viewer)
            assert st == 403
            st, *_ = await acall(port, "DELETE", "/api/v5/clients/any",
                                 None, viewer)
            assert st == 403
        finally:
            await srv.stop()

    run(t())


def test_audit_log_persists_across_restart(tmp_path):
    async def t():
        def published(entries):
            return any(e["path"] == "/api/v5/publish"
                       and e["actor"] == "admin" for e in entries)

        srv = port_server(str(tmp_path))
        await srv.start()
        port = srv.api.port
        try:
            adm = await _token(port)
            st, *_ = await acall(port, "POST", "/api/v5/publish",
                                 {"topic": "a/b", "payload": "x"}, adm)
            assert st == 200
            st, _, body, _ = await acall(port, "GET", "/api/v5/audit", None,
                                         adm)
            assert published(body["data"])
        finally:
            await srv.stop()
        srv2 = port_server(str(tmp_path))
        await srv2.start()
        try:
            st, _, body, _ = await acall(srv2.api.port, "GET",
                                         "/api/v5/audit", None,
                                         await _token(srv2.api.port))
            assert published(body["data"])
        finally:
            await srv2.stop()

    run(t())


def test_password_change_and_store_hashing(tmp_path):
    auth = MgmtAuth(str(tmp_path), default_password="public")
    raw = (tmp_path / "admins.json").read_text()
    assert "public" not in raw
    assert auth.login("admin", "public")
    assert not auth.change_password("admin", "wrong", "next")
    assert auth.change_password("admin", "public", "next")
    assert auth.login("admin", "public") is None
    assert auth.login("admin", "next")
    key, secret = auth.create_api_key("ci", role="viewer")
    raw = (tmp_path / "api_keys.json").read_text()
    assert secret not in raw
    ident = auth.verify_api_key(key, secret)
    assert ident is not None and ident.role == "viewer"
    assert auth.verify_api_key(key, "bad") is None
    key2, secret2 = auth.create_api_key("old", expires_in=-1)
    assert auth.verify_api_key(key2, secret2) is None
    auth.set_api_key_enabled(key, False)
    assert auth.verify_api_key(key, secret) is None


def test_deleted_user_token_invalidated(tmp_path):
    auth = MgmtAuth(str(tmp_path), default_password="public")
    auth.add_admin("temp", "pw", role="administrator")
    token = auth.login("temp", "pw")
    assert auth.verify_token(token) is not None
    auth.delete_admin("temp")
    assert auth.verify_token(token) is None
    with pytest.raises(ValueError):
        auth.add_admin("x", "pw", role="root")


def test_last_admin_undeletable_and_corrupt_store_refused(tmp_path):
    auth = MgmtAuth(str(tmp_path), default_password="public")
    with pytest.raises(ValueError):
        auth.delete_admin("admin")
    auth.add_admin("two", "pw", role="administrator")
    assert auth.delete_admin("admin")
    with pytest.raises(ValueError):
        auth.delete_admin("two")
    (tmp_path / "admins.json").write_text("{truncated")
    with pytest.raises(RuntimeError):
        MgmtAuth(str(tmp_path), default_password="public")


def test_viewer_can_rotate_own_password(tmp_path):
    async def t():
        srv = port_server(str(tmp_path))
        await srv.start()
        port = srv.api.port
        try:
            st, *_ = await acall(port, "POST", "/api/v5/users", {
                "username": "v", "password": "old", "role": "viewer"},
                await _token(port))
            assert st == 201
            viewer = await _token(port, "v", "old")
            st, *_ = await acall(port, "PUT",
                                 "/api/v5/users/admin/change_pwd",
                                 {"old_pwd": "public", "new_pwd": "x"},
                                 viewer)
            assert st == 403
            st, *_ = await acall(port, "PUT", "/api/v5/users/v/change_pwd",
                                 {"old_pwd": "old", "new_pwd": "new"},
                                 viewer)
            assert st == 204
            st, *_ = await acall(port, "GET", "/api/v5/stats", None, viewer)
            assert st == 401
            relog = await _token(port, "v", "new")
            st, *_ = await acall(port, "GET", "/api/v5/stats", None, relog)
            assert st == 200
        finally:
            await srv.stop()

    run(t())


def test_publisher_role_publish_only(tmp_path):
    async def t():
        srv = port_server(str(tmp_path))
        await srv.start()
        port = srv.api.port
        try:
            st, _, kd, _ = await acall(port, "POST", "/api/v5/api_key", {
                "name": "ingest", "role": "publisher"}, await _token(port))
            assert st == 201
            keyed = basic(kd["api_key"], kd["api_secret"])
            st, *_ = await acall(port, "POST", "/api/v5/publish",
                                 {"topic": "ingest/x", "payload": "hi"},
                                 keyed)
            assert st == 200
            for method, path in (
                ("GET", "/api/v5/clients"),
                ("GET", "/api/v5/stats"),
                ("POST", "/api/v5/users"),
                ("DELETE", "/api/v5/api_key/zzz"),
                ("POST", "/api/v5/data/export"),
            ):
                st, *_ = await acall(port, method, path, {}, keyed)
                assert st == 403, (method, path, st)
        finally:
            await srv.stop()

    run(t())


# ------------------------------------------- one store, both packages

@pytest.mark.parametrize("writer", ["reference", "port"])
def test_data_dir_written_by_one_package_works_on_the_other(tmp_path,
                                                            writer):
    """Admins (with a rotated password), API keys of each role, the
    token secret and the audit log: what one package's `MgmtAuth` and
    `AuditLog` write, the other's reads, logs in with and verifies."""
    W, R = (RefAuth, MgmtAuth) if writer == "reference" else \
        (MgmtAuth, RefAuth)
    from emqx_tpu.mgmt_auth import AuditLog as RefAudit

    WA, RA = (RefAudit, AuditLog) if writer == "reference" else \
        (AuditLog, RefAudit)
    d = str(tmp_path)
    w = W(d, default_password="public")
    w.add_admin("viewer1", "pw1", role="viewer")
    assert w.change_password("admin", "public", "rotated")
    keys = {role: w.create_api_key(f"k-{role}", role=role)
            for role in ("administrator", "viewer", "publisher")}
    off_key, off_secret = w.create_api_key("off")
    w.set_api_key_enabled(off_key, False)
    token = w.login("admin", "rotated")
    WA(d).append({"at": 1.0, "actor": "admin", "via": "token",
                  "method": "POST", "path": "/api/v5/publish",
                  "from": "127.0.0.1", "status": 200})

    r = R(d, default_password="public")  # no re-seed: the store exists
    assert r.secret == w.secret
    assert sorted(r.admins) == ["admin", "viewer1"]
    assert r.login("admin", "public") is None
    tok2 = r.login("admin", "rotated")
    assert tok2 is not None and w.verify_token(tok2).actor == "admin"
    ident = r.verify_token(token)
    assert (ident.actor, ident.role, ident.via) == ("admin",
                                                    "administrator",
                                                    "token")
    assert r.verify_token(r.login("viewer1", "pw1")).role == "viewer"
    for role, (key, secret) in keys.items():
        got = r.authenticate_header(basic(key, secret)["Authorization"])
        assert (got.actor, got.role, got.via) == (key, role, "api_key")
        assert r.verify_api_key(key, secret + "x") is None
    assert r.verify_api_key(off_key, off_secret) is None
    assert r.info() == w.info()
    assert RA(d).entries == WA(d).entries
    # what the reader writes back, the writer reads again
    r.add_admin("third", "pw3", role="viewer")
    w2 = W(d, default_password="public")
    assert w2.login("third", "pw3") is not None
    for name in ("admins.json", "api_keys.json"):
        json.loads((tmp_path / name).read_text())
