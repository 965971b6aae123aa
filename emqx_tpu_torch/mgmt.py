"""Management REST API and the Prometheus scrape.

A copy of the JAX package's ``mgmt.py`` (the role of EMQX's
``emqx_management`` REST handlers and ``emqx_prometheus``): read
endpoints for clients, subscriptions, routes, rules, stats and metrics,
write endpoints for publish, kick and rules, and ``/metrics`` in the
Prometheus text format.  It runs on the broker's event loop, served by
this package's own HTTP/1.1 server (`httpd`): the same routes, statuses,
content types and bodies as the JAX package's aiohttp app.

Routes of modules this package has not ported yet stay registered
behind the same authentication and answer 501 ``NOT_PORTED``, naming
the module and its ROADMAP.md item (`NOT_PORTED`): a 404 would tell a
client the route does not exist.
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from typing import Dict, Optional, Tuple

from . import httpd
from .httpd import Request, Response
from .message import Message

# the JAX package's routes whose modules are not ported, by path prefix:
# (the module, its item in ROADMAP.md section 1)
NOT_PORTED: Dict[str, Tuple[str, int]] = {
    "/api/v5/olp": ("overload protection", 7),
    "/api/v5/flight": ("the flight recorder", 8),
    "/api/v5/tracing": ("message lifecycle tracing", 8),
    "/api/v5/trace": ("the trace log", 8),
    "/api/v5/data": ("backup and restore", 11),
    "/api/v5/gateways": ("the gateways", 11),
    "/api/v5/plugins": ("plugins", 11),
    "/api/v5/load_rebalance": ("rebalance and evacuation", 10),
}

# every route, in the JAX package's order: (method, path, handler);
# handler None: a route of a module in NOT_PORTED
ROUTES = (
    ("POST", "/api/v5/login", "post_login"),
    ("GET", "/api/v5/api_key", "get_api_keys"),
    ("POST", "/api/v5/api_key", "post_api_key"),
    ("DELETE", "/api/v5/api_key/{key}", "delete_api_key"),
    ("GET", "/api/v5/users", "get_users"),
    ("POST", "/api/v5/users", "post_user"),
    ("DELETE", "/api/v5/users/{username}", "delete_user"),
    ("PUT", "/api/v5/users/{username}/change_pwd", "change_pwd"),
    ("GET", "/api/v5/clients", "get_clients"),
    ("GET", "/api/v5/clients/{clientid}", "get_client"),
    ("DELETE", "/api/v5/clients/{clientid}", "kick_client"),
    ("GET", "/api/v5/subscriptions", "get_subscriptions"),
    ("GET", "/api/v5/topics", "get_topics"),
    ("GET", "/api/v5/mqtt/topic_metrics", "get_topic_metrics"),
    ("POST", "/api/v5/mqtt/topic_metrics", "post_topic_metrics"),
    ("DELETE", "/api/v5/mqtt/topic_metrics/{topic}",
     "delete_topic_metrics"),
    ("GET", "/api/v5/stats", "get_stats"),
    ("GET", "/api/v5/metrics", "get_metrics"),
    ("GET", "/api/v5/nodes", "get_nodes"),
    ("GET", "/api/v5/rules", "get_rules"),
    ("POST", "/api/v5/rules", "post_rule"),
    ("DELETE", "/api/v5/rules/{rule_id}", "delete_rule"),
    ("POST", "/api/v5/publish", "post_publish"),
    ("GET", "/api/v5/alarms", "get_alarms"),
    ("DELETE", "/api/v5/alarms", "clear_alarms"),
    ("GET", "/api/v5/failpoints", "get_failpoints"),
    ("PUT", "/api/v5/failpoints/{name}", "put_failpoint"),
    ("DELETE", "/api/v5/failpoints/{name}", "delete_failpoint"),
    ("DELETE", "/api/v5/failpoints", "delete_failpoints"),
    ("GET", "/api/v5/banned", "get_banned"),
    ("POST", "/api/v5/banned", "post_banned"),
    ("DELETE", "/api/v5/banned/{kind}/{who}", "delete_banned"),
    ("GET", "/api/v5/slow_subscriptions", "get_slow_subs"),
    ("GET", "/api/v5/olp", None),
    ("GET", "/api/v5/flight", None),
    ("POST", "/api/v5/flight/dump", None),
    ("GET", "/api/v5/flight/{id}", None),
    ("GET", "/api/v5/profiler", "get_profiler"),
    ("GET", "/api/v5/profiler/trace", "get_profiler_trace"),
    ("DELETE", "/api/v5/profiler", "reset_profiler"),
    ("GET", "/api/v5/tracing", None),
    ("PUT", "/api/v5/tracing", None),
    ("DELETE", "/api/v5/tracing", None),
    ("GET", "/api/v5/tracing/traces", None),
    ("GET", "/api/v5/tracing/traces/{trace_id}", None),
    ("GET", "/api/v5/tracing/messages/{mid}", None),
    ("GET", "/api/v5/tracing/spans", None),
    ("GET", "/api/v5/tracing/trace", None),
    ("GET", "/api/v5/trace", None),
    ("POST", "/api/v5/trace", None),
    ("DELETE", "/api/v5/trace/{name}", None),
    ("GET", "/api/v5/trace/{name}/log", None),
    ("GET", "/api/v5/audit", "get_audit"),
    ("PUT", "/api/v5/configs", "put_config"),
    ("POST", "/api/v5/data/export", None),
    ("GET", "/api/v5/data/export/{name}", None),
    ("POST", "/api/v5/data/import", None),
    ("GET", "/api/v5/schema_registry", "get_schemas"),
    ("POST", "/api/v5/schema_registry", "post_schema"),
    ("DELETE", "/api/v5/schema_registry/{name}", "delete_schema"),
    ("GET", "/api/v5/gcp_devices", "get_gcp_devices"),
    ("POST", "/api/v5/gcp_devices", "post_gcp_devices"),
    ("GET", "/api/v5/gcp_devices/{deviceid:.+}", "get_gcp_device"),
    ("PUT", "/api/v5/gcp_devices/{deviceid:.+}", "put_gcp_device"),
    ("DELETE", "/api/v5/gcp_devices/{deviceid:.+}", "delete_gcp_device"),
    ("GET", "/api/v5/gateways", None),
    ("GET", "/api/v5/plugins", None),
    ("GET", "/", "dashboard"),
    ("GET", "/dashboard", "dashboard"),
    ("POST", "/api/v5/load_rebalance/evacuation/start", None),
    ("POST", "/api/v5/load_rebalance/evacuation/stop", None),
    ("POST", "/api/v5/load_rebalance/start", None),
    ("POST", "/api/v5/load_rebalance/stop", None),
    ("POST", "/api/v5/load_rebalance/purge/start", None),
    ("POST", "/api/v5/load_rebalance/purge/stop", None),
    ("GET", "/api/v5/load_rebalance/status", None),
    ("GET", "/metrics", "prometheus"),
)


def not_ported_module(path: str) -> Tuple[str, int]:
    """The (module, ROADMAP item) of an unported route's path."""
    for prefix, what in NOT_PORTED.items():
        if path == prefix or path.startswith(prefix + "/"):
            return what
    raise KeyError(path)


def _json(data, status: int = 200, headers=None) -> Response:
    return httpd.json_response(data, status=status, headers=headers)


class MgmtApi:
    # routes reachable without credentials: the login endpoint, the
    # status page (which degrades to a login hint when anonymous, the
    # way EMQX serves dashboard assets openly and gates the data), and
    # the Prometheus scrape (open by default in EMQX; gate it with
    # api.prometheus_auth=true)
    _OPEN = {
        ("POST", "/api/v5/login"),
        ("GET", "/"),
        ("GET", "/dashboard"),
    }

    def __init__(self, server, bind: str = "127.0.0.1", port: int = 0) -> None:
        self.server = server  # BrokerServer
        self.broker = server.broker
        self.bind = bind
        self.port = port
        self._http: Optional[httpd.HttpServer] = None
        from .mgmt_auth import AuditLog, MgmtAuth

        cfg = self.broker.config.api
        self.auth = MgmtAuth(
            cfg.data_dir,
            default_username=cfg.default_username,
            default_password=cfg.default_password,
            token_ttl=cfg.token_ttl,
        )
        self.prometheus_auth = cfg.prometheus_auth
        # audit trail of mutating API calls (emqx_audit's role),
        # persisted across restarts, surfaced at /api/v5/audit
        self.audit = AuditLog(cfg.data_dir)
        # schema registry persistence: REST-registered schemas reload
        # on restart (rules reference them by name)
        from .schema_registry import global_registry

        global_registry().load(
            os.path.join(cfg.data_dir, "schemas.json")
        )
        # failed-login throttle: remote -> recent failure monotonics
        self._login_failures: dict = {}

    @property
    def audit_log(self) -> list:
        return self.audit.entries

    async def _auth_middleware(self, request: Request, handler):
        """401 on every management route without credentials
        (emqx_mgmt_auth / emqx_dashboard authn+RBAC): Bearer admin
        token or Basic api-key; viewers are read-only."""
        path, method = request.path, request.method
        open_route = (
            (method, path) in self._OPEN
            or (path == "/metrics" and not self.prometheus_auth)
        )
        ident = self.auth.authenticate_header(
            request.headers.get("Authorization")
        )
        if not open_route:
            if ident is None:
                return _json(
                    {"code": "UNAUTHORIZED",
                     "message": "login or api key required"},
                    status=401,
                    headers={
                        # lets browsers/tools prompt for an api key
                        "WWW-Authenticate":
                        'Basic realm="emqx_tpu api key"',
                    },
                )
            if ident.publish_only:
                # the publisher role is an ingestion credential: the
                # publish endpoint and nothing else, reads included
                if method == "POST" and path in (
                    "/api/v5/publish", "/api/v5/publish/bulk"
                ):
                    request["identity"] = ident
                    return await self._audited(request, handler, ident)
                return _json(
                    {"code": "FORBIDDEN",
                     "message": "publisher role: publish only"},
                    status=403,
                )
            if path.startswith("/api/v5/data/") and not ident.can_write:
                # backup archives hold the full config (secrets
                # included): administrator-only, even for downloads
                return _json(
                    {"code": "FORBIDDEN",
                     "message": "administrator required"},
                    status=403,
                )
            self_pwd_change = (
                ident.via == "token"
                and method == "PUT"
                and path == f"/api/v5/users/{ident.actor}/change_pwd"
            )
            if (method not in ("GET", "HEAD") and not ident.can_write
                    and not self_pwd_change):
                # viewers are read-only — except rotating their OWN
                # password, which change_pwd re-verifies with old_pwd
                return _json(
                    {"code": "FORBIDDEN",
                     "message": "viewer role is read-only"},
                    status=403,
                )
        request["identity"] = ident
        return await self._audited(request, handler, ident)

    async def _audited(self, request, handler, ident):
        method, path = request.method, request.path
        resp = await handler(request)
        if method in ("POST", "PUT", "DELETE") and path != "/api/v5/login":
            self.audit.append(
                {
                    "at": time.time(),
                    "actor": ident.actor if ident else None,
                    "via": ident.via if ident else None,
                    "method": method,
                    "path": path,
                    "from": request.remote,
                    "status": resp.status,
                }
            )
        return resp

    # ------------------------------------------------------- lifecycle

    async def start(self) -> None:
        """Bind and serve; a port that cannot bind raises here."""
        app = httpd.App()  # 1 MiB body cap: the open login route must
        # not buffer attacker-sized bodies
        for method, path, name in ROUTES:
            handler = (getattr(self, name) if name is not None
                       else self._not_ported(path))
            if method == "GET":
                app.add_get(path, handler)
            else:
                app.add_route(method, path, handler)
        app.middlewares.append(self._auth_middleware)
        self._http = httpd.HttpServer(app, self.bind, self.port)
        await self._http.start()
        self.port = self._http.port

    async def stop(self) -> None:
        if self._http is not None:
            await self._http.stop()
            self._http = None

    @staticmethod
    def _not_ported(path: str):
        module, item = not_ported_module(path)
        body = {"code": "NOT_PORTED",
                "message": f"{module} is not ported to emqx_tpu_torch "
                           f"(ROADMAP.md section 1, item {item})"}

        async def handler(request: Request) -> Response:
            return _json(body, status=501)

        return handler

    # ------------------------------------------------------------ auth

    _LOGIN_WINDOW = 60.0
    _LOGIN_MAX_FAILURES = 10

    async def post_login(self, request: Request) -> Response:
        """Dashboard-style login: credentials -> Bearer token
        (emqx_dashboard_admin:sign_token). The only unauthenticated
        mutating route, so it is (a) throttled per remote after
        repeated failures and (b) runs its 50k-round PBKDF2 in a
        worker thread — on the event loop it would stall every
        connected MQTT client for tens of ms per attempt."""
        try:
            body = await request.json()
            username = str(body["username"])
            password = str(body["password"])
        except (KeyError, TypeError, json.JSONDecodeError):
            return _json({"code": "BAD_REQUEST"}, status=400)
        now = time.monotonic()
        remote = request.remote or "?"
        failures = [
            t for t in self._login_failures.get(remote, ())
            if now - t < self._LOGIN_WINDOW
        ]
        if len(failures) >= self._LOGIN_MAX_FAILURES:
            self._login_failures[remote] = failures
            return _json(
                {"code": "TOO_MANY_REQUESTS",
                 "message": "too many failed logins; retry later"},
                status=429,
            )
        token = await asyncio.get_running_loop().run_in_executor(
            None, self.auth.login, username, password
        )
        if token is None:
            failures.append(now)
            self._login_failures[remote] = failures
            if len(self._login_failures) > 10_000:
                self._login_failures.clear()  # bound the table
            return _json(
                {"code": "BAD_USERNAME_OR_PWD"}, status=401
            )
        self._login_failures.pop(remote, None)
        user = self.auth.admins[username]
        return _json({
            "token": token,
            "role": user["role"],
            "version": "5.8",
        })

    async def get_api_keys(self, request: Request) -> Response:
        return _json({"data": self.auth.info()})

    async def post_api_key(self, request: Request) -> Response:
        try:
            body = await request.json()
            key, secret = self.auth.create_api_key(
                body["name"],
                role=body.get("role", "administrator"),
                expires_in=body.get("expires_in"),
                enabled=bool(body.get("enable", True)),
            )
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as exc:
            return _json({"code": "BAD_REQUEST", "message": str(exc)}, 400)
        # the plaintext secret appears in this response and never again
        return _json({"api_key": key, "api_secret": secret}, status=201)

    async def delete_api_key(self, request: Request) -> Response:
        ok = self.auth.delete_api_key(request.match_info["key"])
        return Response(status=204 if ok else 404)

    async def get_users(self, request: Request) -> Response:
        return _json({"data": [
            {"username": u, "role": e["role"]}
            for u, e in self.auth.admins.items()
        ]})

    async def post_user(self, request: Request) -> Response:
        try:
            body = await request.json()
            username = str(body["username"])
            if username in self.auth.admins:
                return _json({"code": "ALREADY_EXISTS"}, status=409)
            self.auth.add_admin(
                username,
                str(body["password"]),
                role=body.get("role", "viewer"),
            )
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as exc:
            return _json({"code": "BAD_REQUEST", "message": str(exc)}, 400)
        return _json({"username": username}, status=201)

    async def delete_user(self, request: Request) -> Response:
        username = request.match_info["username"]
        ident = request["identity"]
        if ident is not None and ident.via == "token" \
                and ident.actor == username:
            return _json(
                {"code": "BAD_REQUEST",
                 "message": "cannot delete the logged-in user"}, 400
            )
        try:
            ok = self.auth.delete_admin(username)
        except ValueError as exc:
            # the last administrator is undeletable: it would lock the
            # plane and re-seed default credentials on restart
            return _json({"code": "BAD_REQUEST", "message": str(exc)}, 400)
        return Response(status=204 if ok else 404)

    async def change_pwd(self, request: Request) -> Response:
        username = request.match_info["username"]
        try:
            body = await request.json()
            ok = self.auth.change_password(
                username, str(body["old_pwd"]), str(body["new_pwd"])
            )
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as exc:
            return _json({"code": "BAD_REQUEST", "message": str(exc)}, 400)
        if not ok:
            return _json({"code": "BAD_USERNAME_OR_PWD"}, status=401)
        return Response(status=204)

    # --------------------------------------------------------- clients

    async def get_clients(self, request: Request) -> Response:
        cm = self.broker.cm
        out = []
        for cid in cm.clients():
            session = cm.lookup(cid)
            if session is None:
                continue
            out.append(
                {
                    "clientid": cid,
                    "connected": cm.connected(cid),
                    **session.info(),
                }
            )
        return _json({"data": out, "meta": {"count": len(out)}})

    async def get_client(self, request: Request) -> Response:
        cid = request.match_info["clientid"]
        session = self.broker.cm.lookup(cid)
        if session is None:
            return _json({"code": "NOT_FOUND"}, status=404)
        return _json(
            {
                "clientid": cid,
                "connected": self.broker.cm.connected(cid),
                **session.info(),
            }
        )

    async def kick_client(self, request: Request) -> Response:
        cid = request.match_info["clientid"]
        if not self.broker.cm.kick(cid):
            return _json({"code": "NOT_FOUND"}, status=404)
        return Response(status=204)

    # --------------------------------------------------- subscriptions

    async def get_subscriptions(self, request: Request) -> Response:
        out = []
        router = self.broker.router
        for cid in self.broker.cm.clients():
            for flt in sorted(router.subscriptions_of(cid)):
                out.append({"clientid": cid, "topic": flt})
        return _json({"data": out, "meta": {"count": len(out)}})

    async def get_topics(self, request: Request) -> Response:
        # the whole route table, unpaginated, as the JAX package serves
        # it: at a million filters this holds the loop for its sort and
        # its serialisation
        topics = sorted(self.broker.router.topics())
        node = self.broker.config.node_name
        return _json(
            {
                "data": [{"topic": t, "node": node} for t in topics],
                "meta": {"count": len(topics)},
            }
        )

    async def get_topic_metrics(self, request: Request) -> Response:
        return _json({"data": self.broker.topic_metrics.info()})

    async def post_topic_metrics(self, request: Request) -> Response:
        body = await request.json()
        topic = str(body.get("topic", ""))
        try:
            created = self.broker.topic_metrics.register(topic)
        except ValueError as exc:
            return _json({"code": "BAD_REQUEST",
                          "message": str(exc)}, status=400)
        if not created:
            return _json({"code": "ALREADY_EXISTS",
                          "message": "topic already registered"},
                         status=409)
        return _json({"topic": topic}, status=201)

    async def delete_topic_metrics(self, request: Request) -> Response:
        from urllib.parse import unquote

        # the path parameter is decoded once by the server and once more
        # here, as in the JAX package
        topic = unquote(request.match_info["topic"])
        if not self.broker.topic_metrics.unregister(topic):
            return _json({"code": "NOT_FOUND",
                          "message": "topic not registered"},
                         status=404)
        return Response(status=204)

    # ------------------------------------------------------ stats/meta

    async def get_stats(self, request: Request) -> Response:
        stats = self.broker.stats.all()
        stats["connections.count"] = len(self.broker.cm)
        stats["retained.count"] = len(self.broker.retainer)
        return _json(stats)

    async def get_metrics(self, request: Request) -> Response:
        return _json(self.broker.metrics.all())

    async def get_nodes(self, request: Request) -> Response:
        # this node's row; no cluster is ported (ROADMAP.md section 1,
        # item 10), so no peer rows and an empty cluster view
        return _json({"data": [self.broker.node_info()], "cluster": {}})

    # ----------------------------------------------------------- rules

    async def get_rules(self, request: Request) -> Response:
        # "stats" carries the columnar-eval surface: lowered-vs-
        # fallback registry split, matrix/scalar window counts, the
        # SELECT lane's split; "egress" the per-sink queue depth /
        # batch-size percentiles / breaker view
        return _json({
            "data": self.broker.rules.info(),
            "stats": self.broker.rules.stats(),
            "egress": self.broker.resources.info(),
        })

    async def post_rule(self, request: Request) -> Response:
        try:
            body = await request.json()
            rule = self.broker.rules.add_rule(
                body["id"],
                body["sql"],
                enabled=body.get("enable", True),
                description=body.get("description", ""),
            )
        except (KeyError, ValueError, json.JSONDecodeError) as exc:
            return _json({"code": "BAD_REQUEST", "message": str(exc)}, 400)
        return _json({"id": rule.rule_id, "sql": rule.sql}, status=201)

    async def delete_rule(self, request: Request) -> Response:
        if not self.broker.rules.remove_rule(request.match_info["rule_id"]):
            return _json({"code": "NOT_FOUND"}, status=404)
        return Response(status=204)

    # --------------------------------------------------------- publish

    async def post_publish(self, request: Request) -> Response:
        try:
            body = await request.json()
            msg = Message(
                topic=body["topic"],
                payload=str(body.get("payload", "")).encode(),
                qos=int(body.get("qos", 0)),
                retain=bool(body.get("retain", False)),
                from_client=body.get("clientid", "http_api"),
            )
        except (KeyError, ValueError, json.JSONDecodeError) as exc:
            return _json({"code": "BAD_REQUEST", "message": str(exc)}, 400)
        batcher = self.broker.batcher
        if batcher is not None:
            n = await batcher.publish(msg)
        else:
            n = self.broker.publish(msg)
        return _json({"delivered": n})

    # ------------------------------------------------- alarms / banned

    async def get_alarms(self, request: Request) -> Response:
        which = request.query.get("activated", "true") == "true"
        alarms = (
            self.broker.alarms.active()
            if which
            else self.broker.alarms.history()
        )
        return _json(
            {
                "data": [
                    {
                        "name": a.name,
                        "message": a.message,
                        "details": a.details,
                        "activated_at": a.activated_at,
                        "deactivated_at": a.deactivated_at,
                    }
                    for a in alarms
                ]
            }
        )

    async def clear_alarms(self, request: Request) -> Response:
        for a in self.broker.alarms.active():
            self.broker.alarms.deactivate(a.name)
        return Response(status=204)

    # ------------------------------------------------------ failpoints

    async def get_failpoints(self, request: Request) -> Response:
        from . import failpoints

        return _json({
            "enabled": failpoints.enabled,
            "data": failpoints.list_points(),
            "seams": list(failpoints.SEAMS),
            # the port's engine has no device->host breaker (it launches
            # or raises): it never opens and has never tripped
            "engine_breaker": {"open": False, "trips": 0},
        })

    async def put_failpoint(self, request: Request) -> Response:
        from . import failpoints

        try:
            body = await request.json() if request.can_read_body else {}
        except json.JSONDecodeError:
            body = {}
        action = body.get("action")
        if action not in failpoints.ACTIONS:
            return _json(
                {"error": f"action must be one of {failpoints.ACTIONS}"},
                status=400,
            )
        kw = {}
        try:
            for k in ("prob", "delay"):
                if body.get(k) is not None:
                    kw[k] = float(body[k])
            for k in ("after", "times", "seed"):
                if body.get(k) is not None:
                    kw[k] = int(body[k])
        except (TypeError, ValueError):
            return _json(
                {"error": "prob/delay must be numbers; "
                          "after/times/seed integers"},
                status=400,
            )
        if body.get("match") is not None:
            kw["match"] = str(body["match"])
        info = failpoints.configure(
            request.match_info["name"], action, **kw
        )
        return _json(info)

    async def delete_failpoint(self, request: Request) -> Response:
        from . import failpoints

        if not failpoints.clear(request.match_info["name"]):
            return _json({"error": "no such failpoint"}, status=404)
        return Response(status=204)

    async def delete_failpoints(self, request: Request) -> Response:
        from . import failpoints

        failpoints.clear()
        return Response(status=204)

    async def get_banned(self, request: Request) -> Response:
        return _json({"data": self.broker.banned.all()})

    async def post_banned(self, request: Request) -> Response:
        try:
            body = await request.json()
            self.broker.banned.ban(
                body["as"],
                body["who"],
                seconds=body.get("seconds"),
                reason=body.get("reason", ""),
            )
        except (KeyError, ValueError, json.JSONDecodeError) as exc:
            return _json({"code": "BAD_REQUEST", "message": str(exc)}, 400)
        return _json({"as": body["as"], "who": body["who"]}, status=201)

    async def delete_banned(self, request: Request) -> Response:
        ok = self.broker.banned.unban(
            request.match_info["kind"], request.match_info["who"]
        )
        return Response(status=204 if ok else 404)

    async def get_slow_subs(self, request: Request) -> Response:
        return _json({"data": self.broker.slow_subs.top()})

    # -------------------------------------------------------- profiler

    async def get_profiler(self, request: Request) -> Response:
        """Window-pipeline profiler dump: stage-latency histogram
        summaries, the engine's counters, and the most recent windows
        and engine events (``?windows=N`` bounds the dump)."""
        prof = self.broker.profiler
        try:
            limit = int(request.query.get("windows", 32))
        except ValueError:
            return _json({"code": "BAD_REQUEST",
                          "message": "windows must be an integer"}, 400)
        return _json({
            "enabled": prof.enabled,
            "histograms_us": prof.summary(),
            "engine": self.broker.router.engine.stats(),
            "slow_subs": self.broker.slow_subs.top(),
            "windows": prof.windows(limit),
            "events": prof.events(limit),
        })

    async def get_profiler_trace(self, request: Request) -> Response:
        """The window ring as Chrome trace-event JSON — loads directly
        in Perfetto (ui.perfetto.dev) or chrome://tracing."""
        prof = self.broker.profiler
        limit = None
        if "windows" in request.query:
            try:
                limit = int(request.query["windows"])
            except ValueError:
                return _json({"code": "BAD_REQUEST",
                              "message": "windows must be an integer"},
                             400)
        return _json(prof.chrome_trace(limit))

    async def reset_profiler(self, request: Request) -> Response:
        self.broker.profiler.reset()
        return Response(status=204)

    # ----------------------------------------------------- audit/config

    async def get_audit(self, request: Request) -> Response:
        return _json({"data": list(self.audit_log)})

    async def put_config(self, request: Request) -> Response:
        """Runtime config update of this node (no cluster journal: the
        cluster is not ported)."""
        try:
            body = await request.json()
            path, value = body["path"], body["value"]
            self.broker.apply_config(path, value)
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as exc:
            return _json({"code": "BAD_REQUEST", "message": str(exc)}, 400)
        return _json({"path": path})

    # ------------------------------------------------- schema registry

    async def get_schemas(self, request: Request) -> Response:
        from .schema_registry import global_registry

        return _json({"data": global_registry().info()})

    async def post_schema(self, request: Request) -> Response:
        from .schema_registry import global_registry

        try:
            body = await request.json()
            # protobuf registration shells out to protoc: keep that
            # (and the temp-file IO) off the event loop
            await asyncio.get_running_loop().run_in_executor(
                None, global_registry().add,
                body["name"], body["type"], body["source"],
            )
        except (KeyError, ValueError, TypeError, OSError,
                json.JSONDecodeError) as exc:
            return _json({"code": "BAD_REQUEST", "message": str(exc)},
                         status=400)
        return _json({"name": body["name"], "type": body["type"]},
                     status=201)

    async def delete_schema(self, request: Request) -> Response:
        from .schema_registry import global_registry

        ok = global_registry().remove(request.match_info["name"])
        return Response(status=204 if ok else 404)

    # -------------------------------------------------- gcp devices

    def _gcp_registry(self):
        reg = self.broker.gcp_devices
        if reg is None:
            raise httpd.HTTPError(
                501,
                text=json.dumps({
                    "code": "NOT_ENABLED",
                    "message": "set gcp_device_enable: true",
                }),
                content_type="application/json",
            )
        return reg

    async def get_gcp_devices(self, request: Request) -> Response:
        devices = self._gcp_registry().list_devices()
        return _json({"data": devices, "meta": {"count": len(devices)}})

    async def post_gcp_devices(self, request: Request) -> Response:
        """Bulk import (emqx_gcp_device:import_devices): a JSON list
        of device objects."""
        reg = self._gcp_registry()
        try:
            body = await request.json()
            if not isinstance(body, list):
                raise ValueError("expected a JSON list of devices")
        except (ValueError, json.JSONDecodeError) as e:
            return _json({"code": "BAD_REQUEST", "message": str(e)},
                         status=400)
        imported, errors = reg.import_devices(body)
        return _json({"imported": imported, "errors": errors})

    async def get_gcp_device(self, request: Request) -> Response:
        device = self._gcp_registry().get_device(
            request.match_info["deviceid"]
        )
        if device is None:
            return _json({"code": "NOT_FOUND"}, status=404)
        return _json(device)

    async def put_gcp_device(self, request: Request) -> Response:
        reg = self._gcp_registry()
        try:
            body = await request.json()
            body["deviceid"] = request.match_info["deviceid"]
            reg.put_device(body)
        except (KeyError, TypeError, ValueError,
                json.JSONDecodeError) as e:
            return _json({"code": "BAD_REQUEST", "message": str(e)},
                         status=400)
        return _json(reg.get_device(request.match_info["deviceid"]))

    async def delete_gcp_device(self, request: Request) -> Response:
        if not self._gcp_registry().remove_device(
            request.match_info["deviceid"]
        ):
            return _json({"code": "NOT_FOUND"}, status=404)
        return Response(status=204)

    async def dashboard(self, request: Request) -> Response:
        """The web dashboard: a single self-contained HTML app (see
        dashboard.py) that logs in against /api/v5/login and drives
        the same JSON API operators script against.  Served openly
        while every data route stays behind auth."""
        from .dashboard import DASHBOARD_HTML

        return Response(text=DASHBOARD_HTML, content_type="text/html")

    # ------------------------------------------------------ prometheus

    async def prometheus(self, request: Request) -> Response:
        """Prometheus text exposition (emqx_prometheus.erl's collect
        families): counters and gauges with sanitized names and one
        HELP/TYPE per family, the engine's counters, the rule engine's
        and the sinks' gauges, the merged sink batch-size histogram and
        the window profiler's stage-latency histograms as
        ``_bucket``/``_sum``/``_count`` families."""
        from .observability import prom_histogram_lines, prom_name

        lines: list = []
        seen: set = set()

        def emit(name: str, kind: str, value, help_text: str = "",
                 labels=None) -> None:
            metric = prom_name("emqx_" + name.replace(".", "_"))
            if metric not in seen:
                # one HELP/TYPE per FAMILY — a repeated TYPE line (or a
                # name colliding after sanitization) breaks strict
                # text-format parsers
                seen.add(metric)
                lines.append(f"# HELP {metric} {help_text or name}")
                lines.append(f"# TYPE {metric} {kind}")
            if labels:
                lab = ",".join(
                    f'{k}="{v}"' for k, v in sorted(labels.items())
                )
                lines.append(f"{metric}{{{lab}}} {value}")
            else:
                lines.append(f"{metric} {value}")

        for name, value in sorted(self.broker.metrics.all().items()):
            emit(name, "counter", value)
        stats = self.broker.stats.all()
        stats["connections.count"] = len(self.broker.cm)
        stats["retained.count"] = len(self.broker.retainer)
        for name, value in sorted(stats.items()):
            emit(name, "gauge", value)
        emit(
            "uptime_seconds",
            "gauge",
            int(time.time() - self.broker.metrics.start_time),
        )
        # the match engine's counters (this package's MatchEngine.stats:
        # its window counters and the rules evaluator's)
        for name, value in sorted(
            self.broker.router.engine.stats().items()
        ):
            if value is None:
                continue
            if isinstance(value, bool):
                value = int(value)
            if not isinstance(value, (int, float)):
                continue
            emit("engine_" + name, "gauge", value,
                 help_text=f"match engine {name}")
        # durable-store durability gauges (group-commit gate
        # watermarks, parked ack-windows, quarantine counts)
        if self.broker.durable is not None:
            ds_stats = self.broker.durable.sync_stats()
            for name, value in sorted(ds_stats.items()):
                if not isinstance(value, (int, float)) or isinstance(
                    value, bool
                ):
                    continue
                emit("ds_" + name, "gauge", value,
                     help_text=f"durable store {name}")
            # sharded store: per-shard breakdown as labeled gauges
            for row in ds_stats.get("per_shard") or ():
                shard = row.get("shard")
                for name, value in sorted(row.items()):
                    if name == "shard" or not isinstance(
                        value, (int, float)
                    ) or isinstance(value, bool):
                        continue
                    emit(
                        "ds_shard_" + name, "gauge", value,
                        labels={"shard": str(shard)},
                        help_text=f"durable store shard {name}",
                    )
        # rule-engine columnar-eval gauges (lowered/fallback registry
        # split, matrix vs scalar window counts, per-cell cost EWMAs)
        for name, value in sorted(self.broker.rules.stats().items()):
            if value is None:
                continue
            if isinstance(value, bool):
                value = int(value)
            if not isinstance(value, (int, float)):
                continue
            emit("rules_" + name, "gauge", value,
                 help_text=f"rule engine {name}")
        # sink egress: per-sink labeled gauges plus ONE merged
        # batch-size histogram family (prom_histogram_lines has no
        # label support; snapshots merge losslessly per bucket)
        batch_snap = None
        for rid, row in sorted(self.broker.resources.info().items()):
            for name, value in sorted(row.items()):
                if isinstance(value, bool):
                    value = int(value)
                if not isinstance(value, (int, float)):
                    continue
                emit("sink_" + name, "gauge", value,
                     labels={"sink": rid},
                     help_text=f"sink egress {name}")
            w = self.broker.resources.get(rid)
            if w is not None:
                snap = w.batch_hist.snapshot()
                batch_snap = (
                    snap if batch_snap is None
                    else batch_snap.merge(snap)
                )
        if batch_snap is not None and batch_snap.count:
            family = prom_name("emqx_sink_batch_size")
            if family not in seen:
                seen.add(family)
                lines.extend(prom_histogram_lines(
                    family, batch_snap,
                    help_text="records per flushed sink batch "
                              "(all sinks merged)",
                ))
        prof = self.broker.profiler
        for name, snap in sorted(prof.snapshots().items()):
            family = prom_name(f"emqx_profiler_{name}_us")
            if family in seen:
                continue
            seen.add(family)
            lines.extend(prom_histogram_lines(
                family, snap,
                help_text=f"window pipeline stage '{name}' latency "
                          "in microseconds",
            ))
        return Response(
            text="\n".join(lines) + "\n",
            content_type="text/plain",
            charset="utf-8",
        )
