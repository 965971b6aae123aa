"""Authentication + authorization entry points.

Mirrors `emqx_access_control` (EMQX apps/emqx/src/
emqx_access_control.erl), as the JAX package does: ``authenticate/1``
runs the authenticator chain, ``authorize/3`` consults the
authorization source chain with a default when no source decides.
Providers follow the chain contract of `emqx_authn_chains` /
`emqx_authz` (first decisive provider wins; ``ignore`` falls through).

Built-in providers re-create EMQX's file-based backends:
``DictAuthenticator`` ≈ the built-in-database password store (salted
SHA-256), ``AclProvider`` ≈ the file authz source (acl.conf) with
``%c``/``%u`` topic placeholders.  DB-backed authz sources
(``auth_db``, ``auth_mongo``) go in ``db_authz_sources``: their rows for
a client are fetched once at CONNECT into a per-client cache, which
``authorize`` evaluates after the file sources without waiting on IO.
"""

from __future__ import annotations

import hashlib
import hmac
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from . import topic as T

# decisions
ALLOW = "allow"
DENY = "deny"
IGNORE = "ignore"  # provider has no opinion; fall through the chain

PUBLISH = "publish"
SUBSCRIBE = "subscribe"
ALL_ACTIONS = "all"

ACL_CACHE_MAX = 100_000  # cached clients before `_evict_acl` runs


@dataclass
class ClientInfo:
    """The slice of channel state access control sees (EMQX's
    clientinfo map, emqx_types.erl)."""

    clientid: str
    username: Optional[str] = None
    password: Optional[bytes] = None
    peerhost: str = ""
    mountpoint: Optional[str] = None
    is_superuser: bool = False


class Authenticator:
    """Chain element: return (ALLOW|DENY|IGNORE, updates-dict)."""

    def authenticate(
        self, client: ClientInfo
    ) -> Tuple[str, Dict[str, object]]:
        raise NotImplementedError


class DictAuthenticator(Authenticator):
    """Username/password store with per-user salted SHA-256 hashes."""

    def __init__(self) -> None:
        self._users: Dict[str, Tuple[bytes, bytes, bool]] = {}

    def add_user(
        self, username: str, password: str, is_superuser: bool = False
    ) -> None:
        salt = os.urandom(16)
        digest = hashlib.sha256(salt + password.encode()).digest()
        self._users[username] = (salt, digest, is_superuser)

    def remove_user(self, username: str) -> None:
        self._users.pop(username, None)

    def authenticate(
        self, client: ClientInfo
    ) -> Tuple[str, Dict[str, object]]:
        if client.username is None:
            return IGNORE, {}
        entry = self._users.get(client.username)
        if entry is None:
            return IGNORE, {}
        salt, digest, is_superuser = entry
        given = hashlib.sha256(salt + (client.password or b"")).digest()
        if hmac.compare_digest(given, digest):
            return ALLOW, {"is_superuser": is_superuser}
        return DENY, {}


@dataclass
class AclRule:
    """One authorization rule: permission x who x action x topics.

    ``who`` selects by exact clientid (``("clientid", id)``), username
    (``("username", name)``) or everyone (``"all"``).  Topic entries may
    use MQTT wildcards and the placeholders ``%c`` (clientid) / ``%u``
    (username); an ``{"eq": topic}`` entry requires literal equality
    (no wildcard expansion), as in EMQX's acl.conf syntax.
    """

    permission: str  # ALLOW | DENY
    who: object = "all"
    action: str = ALL_ACTIONS
    topics: Sequence[object] = field(default_factory=lambda: ["#"])

    def applies_to(self, client: ClientInfo) -> bool:
        if self.who == "all":
            return True
        kind, val = self.who  # type: ignore[misc]
        if kind == "clientid":
            return client.clientid == val
        if kind == "username":
            return client.username == val
        return False

    def covers(self, client: ClientInfo, action: str, topic: str) -> bool:
        if self.action not in (ALL_ACTIONS, action):
            return False
        if not self.applies_to(client):
            return False
        for entry in self.topics:
            if isinstance(entry, dict) and "eq" in entry:
                if topic == self._expand(str(entry["eq"]), client):
                    return True
            else:
                flt = self._expand(str(entry), client)
                if T.match(topic, flt) or topic == flt:
                    return True
        return False

    @staticmethod
    def _expand(pattern: str, client: ClientInfo) -> str:
        out = pattern.replace("%c", client.clientid)
        if client.username is not None:
            out = out.replace("%u", client.username)
        return out


class AclProvider:
    """Ordered rule list; first covering rule decides."""

    def __init__(self, rules: Optional[Iterable[AclRule]] = None) -> None:
        self.rules: List[AclRule] = list(rules or ())

    def authorize(
        self, client: ClientInfo, action: str, topic: str
    ) -> str:
        for rule in self.rules:
            if rule.covers(client, action, topic):
                return rule.permission
        return IGNORE


class AccessControl:
    """authenticate/authorize facade wired into the hook registry.

    The ``client.authenticate`` / ``client.authorize`` hookpoints run
    *before* the provider chains, mirroring how EMQX's auth apps attach
    to those hooks (emqx_access_control.erl).
    """

    def __init__(
        self,
        hooks=None,
        allow_anonymous: bool = True,
        authz_default: str = ALLOW,
        deny_action: str = "ignore",  # 'ignore' pub, or 'disconnect'
    ) -> None:
        from .hooks import HookRegistry

        self.hooks: "HookRegistry" = hooks
        self.allow_anonymous = allow_anonymous
        self.authz_default = authz_default
        self.deny_action = deny_action
        self.authenticators: List[Authenticator] = []
        self.authz_sources: List[AclProvider] = []
        # DB-backed authz (auth_db.SqlAuthorizer/RedisAuthorizer,
        # auth_mongo.MongoAuthorizer): rows are prefetched per client
        # at CONNECT into _acl_cache
        self.db_authz_sources: List = []
        self._acl_cache: Dict[str, List[Dict]] = {}
        # liveness probe for cache eviction (wired by the broker to
        # its connection manager); None = no pressure-based cleanup
        self.is_live: Optional[Callable[[str], bool]] = None

    # ---------------------------------------------------------- authn

    def _hook_verdict(self, client: ClientInfo) -> Optional[bool]:
        if self.hooks is None:
            return None
        res = self.hooks.run_fold("client.authenticate", (client,), IGNORE)
        if res == DENY:
            return False
        if res == ALLOW:
            return True
        return None

    async def _hook_verdict_async(
        self, client: ClientInfo
    ) -> Optional[bool]:
        if self.hooks is None:
            return None
        res = await self.hooks.run_fold_async(
            "client.authenticate", (client,), IGNORE
        )
        if res == DENY:
            return False
        if res == ALLOW:
            return True
        return None

    @staticmethod
    def _apply_decision(
        decision: str, updates: Dict, client: ClientInfo
    ) -> Optional[bool]:
        if decision == ALLOW:
            for k, v in updates.items():
                setattr(client, k, v)
            return True
        if decision == DENY:
            return False
        return None

    def authenticate(self, client: ClientInfo) -> Tuple[bool, ClientInfo]:
        """Returns (ok, possibly-updated clientinfo).  Async providers
        (is_async=True, e.g. HTTP) are SKIPPED here — channels route
        through ``authenticate_async`` when any are registered."""
        verdict = self._hook_verdict(client)
        if verdict is not None:
            return verdict, client
        for auth in self.authenticators:
            out = self._apply_decision(*auth.authenticate(client), client)
            if out is not None:
                return out, client
        return self.allow_anonymous, client

    @property
    def has_async_authn(self) -> bool:
        return any(
            getattr(a, "is_async", False) for a in self.authenticators
        ) or (
            self.hooks is not None
            and self.hooks.has_async("client.authenticate")
        )

    async def authenticate_async(
        self, client: ClientInfo
    ) -> Tuple[bool, ClientInfo]:
        """Same chain walk, awaiting IO providers in order (the
        per-listener chain of emqx_authn_chains with IO providers)."""
        verdict = await self._hook_verdict_async(client)
        if verdict is not None:
            return verdict, client
        for auth in self.authenticators:
            if getattr(auth, "is_async", False):
                decision, updates = await auth.authenticate_async(client)
            else:
                decision, updates = auth.authenticate(client)
            out = self._apply_decision(decision, updates, client)
            if out is not None:
                return out, client
        return self.allow_anonymous, client

    async def close(self) -> None:
        """Release IO-backed providers (HTTP clients, DB connections)."""
        for auth in list(self.authenticators) + list(
            self.db_authz_sources
        ):
            closer = getattr(auth, "close", None)
            if closer is not None:
                await closer()

    # ---------------------------------------------------------- authz

    def authorize(
        self, client: ClientInfo, action: str, topic: str
    ) -> bool:
        if client.is_superuser:
            return True
        if self.hooks is not None:
            res = self.hooks.run_fold(
                "client.authorize", (client, action, topic), IGNORE
            )
            if res in (ALLOW, DENY):
                return res == ALLOW
        return self._authorize_local(client, action, topic)

    @property
    def has_async_authz_hooks(self) -> bool:
        """True when an IO-backed ``client.authorize`` hook (exhook) is
        registered: channels then defer publish/subscribe handling to
        an ordered async continuation instead of blocking the loop."""
        return self.hooks is not None and self.hooks.has_async(
            "client.authorize"
        )

    async def authorize_async(
        self, client: ClientInfo, action: str, topic: str
    ) -> bool:
        """`authorize` with the hook chain awaited off-loop (used by
        the channel's deferred publish/subscribe path when an exhook
        authorize provider is loaded)."""
        if client.is_superuser:
            return True
        if self.hooks is not None:
            res = await self.hooks.run_fold_async(
                "client.authorize", (client, action, topic), IGNORE
            )
            if res in (ALLOW, DENY):
                return res == ALLOW
        return self._authorize_local(client, action, topic)

    def _authorize_local(
        self, client: ClientInfo, action: str, topic: str
    ) -> bool:
        for src in self.authz_sources:
            decision = src.authorize(client, action, topic)
            if decision in (ALLOW, DENY):
                return decision == ALLOW
        # DB-backed sources: evaluate the rows prefetched at CONNECT
        # (EMQX's emqx_authz_cache role: authorize runs on the
        # publish/subscribe hot path and must never wait on IO)
        rows = self._acl_cache.get(client.clientid)
        if rows is not None:
            from .auth_db import evaluate_acl_rows

            decision = evaluate_acl_rows(rows, client, action, topic)
            if decision in (ALLOW, DENY):
                return decision == ALLOW
        return self.authz_default == ALLOW

    # -------------------------------------------- DB-backed ACL cache

    @property
    def has_async_authz(self) -> bool:
        return bool(self.db_authz_sources)

    async def prefetch_acl(self, client: ClientInfo) -> None:
        """Fetch the client's ACL rows from every DB source ONCE at
        CONNECT; `authorize` then evaluates them synchronously.  A
        fetch failure leaves no cache entry: the chain default applies
        (and with authz_default=deny, fails closed)."""
        if not self.db_authz_sources:
            return
        rows: List[Dict] = []
        try:
            for src in self.db_authz_sources:
                rows.extend(await src.fetch_rows(client))
        except Exception:
            import logging

            logging.getLogger("emqx_tpu_torch.access").exception(
                "acl prefetch failed for %s", client.clientid
            )
            self._acl_cache.pop(client.clientid, None)
            return
        if len(self._acl_cache) >= ACL_CACHE_MAX:
            self._evict_acl()
        self._acl_cache[client.clientid] = rows

    def _evict_acl(self) -> None:
        """Bound the cache WITHOUT clearing live clients' entries (a
        wholesale clear would deny every connected client under
        authz_default=deny until it reconnects): drop entries of dead
        sessions first, then the oldest tenth as a backstop."""
        if self.is_live is not None:
            dead = [
                cid for cid in self._acl_cache if not self.is_live(cid)
            ]
            for cid in dead:
                del self._acl_cache[cid]
        if len(self._acl_cache) >= ACL_CACHE_MAX:
            for cid in list(self._acl_cache)[: len(self._acl_cache) // 10]:
                del self._acl_cache[cid]

    def drop_acl(self, clientid: str) -> None:
        """Never called eagerly on disconnect or discard: a reconnecting
        client's NEW prefetch can land before the OLD channel's
        teardown runs, and an eager drop would wipe the fresh entry.
        Dead entries are reclaimed under cache pressure (`_evict_acl`)
        and overwritten at each CONNECT."""
        self._acl_cache.pop(clientid, None)
