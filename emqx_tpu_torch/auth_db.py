"""Database-backed authentication/authorization providers.

A copy of the JAX package's ``auth_db.py``, the role of EMQX's
`emqx_auth_mysql` / `emqx_auth_postgresql` / `emqx_auth_redis`
(emqx_authn_mysql.erl, emqx_authz_mysql.erl and siblings): credentials
and ACL rules live in an operator database, queried per client with
placeholder templates and verified against EMQX's password-hashing
suite (emqx_authn_password_hashing.erl: plain/md5/sha/sha256/sha512
with salt prefix/suffix, pbkdf2, bcrypt).

Three layers:
  * hashing   — `verify_password` implements the suite; bcrypt rides
    the system's crypt(3) ($2b$), where EMQX links a bcrypt NIF.
  * templating — `compile_query` turns ``${username}``-style
    placeholders (and legacy ``%u``/``%c``) into PREPARED-STATEMENT
    parameters, EMQX's injection-safety approach
    (emqx_auth_template.erl): client values never splice into SQL.
  * providers — `SqlAuthenticator`/`SqlAuthorizer` and
    `RedisAuthenticator`/`RedisAuthorizer` speak to a minimal
    connector interface (`SqlConnector.query` / `RedisConnector.cmd`,
    the ecpool role); the aiomysql/asyncpg/redis connectors raise at
    construction without their drivers, and tests drive the providers
    through fakes.
"""

from __future__ import annotations

import hashlib
import hmac
import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import topic as T
from .access import ALLOW, DENY, IGNORE, Authenticator, ClientInfo

log = logging.getLogger("emqx_tpu_torch.auth_db")


# --------------------------------------------------------------- hashing

def _crypt():
    """The stdlib crypt module (deprecated, removed in 3.13 — by then
    switch to the `bcrypt` wheel or a ctypes libxcrypt binding)."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        import crypt

    return crypt


def _bcrypt_verify(password: str, stored: str) -> bool:
    """bcrypt via the platform's crypt(3) ($2b$/$2a$/$2y$), the
    modular format EMQX's bcrypt NIF reads."""
    try:
        out = _crypt().crypt(password, stored)
        return out is not None and hmac.compare_digest(out, stored)
    except Exception:
        log.warning("bcrypt unavailable on this platform")
        return False


_bcrypt_ok: Optional[bool] = None


def bcrypt_supported() -> bool:
    """One-time platform probe: round-trip a known password through
    crypt(3) $2b$.  Used at authenticator CONSTRUCTION so an
    algorithm=bcrypt config on a platform without libxcrypt (or on
    Python >= 3.13, where stdlib crypt is gone) fails loudly at boot
    instead of silently DENYing every bcrypt credential at runtime."""
    global _bcrypt_ok
    if _bcrypt_ok is None:
        try:
            crypt = _crypt()
            salt = crypt.mksalt(crypt.METHOD_BLOWFISH)
            probe = crypt.crypt("probe", salt)
            _bcrypt_ok = bool(probe) and crypt.crypt("probe", probe) == probe
        except Exception:
            _bcrypt_ok = False
    return _bcrypt_ok


def check_algorithm_supported(algorithm: str) -> None:
    """Raise at construction time for algorithms this platform cannot
    verify (currently: bcrypt without a working crypt(3))."""
    if algorithm == "bcrypt" and not bcrypt_supported():
        raise RuntimeError(
            "password_hash algorithm 'bcrypt' is not supported on this "
            "platform (no stdlib crypt module or crypt(3) lacks $2b$); "
            "every bcrypt credential would silently fail closed"
        )


_SIMPLE = {
    "plain": None,
    "md5": hashlib.md5,
    "sha": hashlib.sha1,
    "sha256": hashlib.sha256,
    "sha512": hashlib.sha512,
}


def hash_password(
    password: str,
    algorithm: str = "sha256",
    salt: str = "",
    salt_position: str = "prefix",
    iterations: int = 50_000,
) -> str:
    """Produce a stored hash (tooling/tests; the verify twin below)."""
    if algorithm == "bcrypt":
        crypt = _crypt()
        stored_salt = salt or crypt.mksalt(crypt.METHOD_BLOWFISH)
        return crypt.crypt(password, stored_salt)
    if algorithm == "pbkdf2":
        return hashlib.pbkdf2_hmac(
            "sha256", password.encode(), salt.encode(), iterations
        ).hex()
    fn = _SIMPLE[algorithm]
    if fn is None:
        return password
    data = (salt + password) if salt_position == "prefix" \
        else (password + salt)
    return fn(data.encode()).hexdigest()


def verify_password(
    password: Optional[bytes],
    stored_hash: str,
    algorithm: str = "sha256",
    salt: str = "",
    salt_position: str = "prefix",
    iterations: int = 50_000,
) -> bool:
    """EMQX's hashing suite
    (emqx_authn_password_hashing.erl): simple algorithms concatenate
    the salt before/after the password; pbkdf2 uses it as the HMAC
    salt; bcrypt embeds it in the stored hash."""
    if password is None:
        return False
    pw = password.decode("utf-8", "replace")
    if algorithm == "bcrypt":
        return _bcrypt_verify(pw, stored_hash)
    got = hash_password(pw, algorithm, salt, salt_position, iterations)
    return hmac.compare_digest(got, stored_hash)


# ------------------------------------------------------------ templating

def _peer_ip(c) -> str:
    # peerhost is "host:port"; rsplit keeps IPv6 colons intact (same
    # rule as broker/channel.py's peer formatting)
    return (c.peerhost or "").rsplit(":", 1)[0]


_PLACEHOLDERS = {
    "${username}": lambda c: c.username or "",
    "${clientid}": lambda c: c.clientid or "",
    "${peerhost}": _peer_ip,
    "${password}": lambda c: (c.password or b"").decode("utf-8",
                                                        "replace"),
    # legacy 4.x placeholders, still widely deployed
    "%u": lambda c: c.username or "",
    "%c": lambda c: c.clientid or "",
    "%a": _peer_ip,
    "%P": lambda c: (c.password or b"").decode("utf-8", "replace"),
}


def compile_query(
    template: str, paramstyle: str = "format"
) -> Tuple[str, List[Callable[[ClientInfo], str]]]:
    """Compile a placeholder template into (sql, param extractors):
    each placeholder becomes a bind parameter (``%s`` for MySQL-style,
    ``$1..$n`` for PostgreSQL), so client-controlled values never
    splice into SQL text (emqx_auth_template.erl's prepared-statement
    rendering)."""
    out: List[str] = []
    getters: List[Callable[[ClientInfo], str]] = []
    i = 0
    n = len(template)
    while i < n:
        for ph, getter in _PLACEHOLDERS.items():
            if template.startswith(ph, i):
                getters.append(getter)
                if paramstyle == "numeric":
                    out.append(f"${len(getters)}")
                else:
                    out.append("%s")
                i += len(ph)
                break
        else:
            ch = template[i]
            if ch == "%" and paramstyle == "format":
                # literal % (e.g. SQL LIKE 'x/%') must not read as a
                # driver format directive
                out.append("%%")
            else:
                out.append(ch)
            i += 1
    return "".join(out), getters


def render_params(
    getters: Sequence[Callable[[ClientInfo], str]], client: ClientInfo
) -> Tuple[str, ...]:
    return tuple(g(client) for g in getters)


def render_topic(pattern: str, client: ClientInfo) -> str:
    """ACL rows may embed placeholders inside topic patterns
    (emqx_authz rule rendering): literal substitution is correct here
    — topics are data, not SQL."""
    for ph, getter in _PLACEHOLDERS.items():
        if ph in pattern:
            pattern = pattern.replace(ph, getter(client))
    return pattern


# ------------------------------------------------------------ connectors

class SqlConnector:
    """Minimal async SQL interface (the ecpool role): ``query`` returns
    rows as dicts.  Concrete drivers below; tests use fakes."""

    paramstyle = "format"

    async def query(self, sql: str, params: Sequence) -> List[Dict]:
        raise NotImplementedError

    async def close(self) -> None:
        pass


class MysqlConnector(SqlConnector):
    """aiomysql-backed pool (gated: constructing it without the driver
    raises with a clear message)."""

    paramstyle = "format"

    def __init__(self, host="127.0.0.1", port=3306, user="root",
                 password="", db="mqtt", pool_size=8):
        try:
            import aiomysql  # noqa: F401
        except ImportError as exc:
            raise RuntimeError(
                "MysqlConnector requires the 'aiomysql' driver"
            ) from exc
        self._cfg = dict(host=host, port=port, user=user,
                         password=password, db=db,
                         maxsize=pool_size, autocommit=True)
        self._pool = None

    async def _ensure(self):
        if self._pool is None:
            import aiomysql

            self._pool = await aiomysql.create_pool(**self._cfg)
        return self._pool

    async def query(self, sql: str, params: Sequence) -> List[Dict]:
        import aiomysql

        pool = await self._ensure()
        async with pool.acquire() as conn:
            async with conn.cursor(aiomysql.DictCursor) as cur:
                await cur.execute(sql, tuple(params))
                return list(await cur.fetchall())

    async def close(self) -> None:
        if self._pool is not None:
            self._pool.close()
            await self._pool.wait_closed()
            self._pool = None


class PostgresConnector(SqlConnector):
    """asyncpg-backed pool (gated like MysqlConnector)."""

    paramstyle = "numeric"

    def __init__(self, dsn="postgresql://localhost/mqtt", pool_size=8):
        try:
            import asyncpg  # noqa: F401
        except ImportError as exc:
            raise RuntimeError(
                "PostgresConnector requires the 'asyncpg' driver"
            ) from exc
        self._dsn = dsn
        self._size = pool_size
        self._pool = None

    async def _ensure(self):
        if self._pool is None:
            import asyncpg

            self._pool = await asyncpg.create_pool(
                self._dsn, max_size=self._size
            )
        return self._pool

    async def query(self, sql: str, params: Sequence) -> List[Dict]:
        pool = await self._ensure()
        rows = await pool.fetch(sql, *params)
        return [dict(r) for r in rows]

    async def close(self) -> None:
        if self._pool is not None:
            await self._pool.close()
            self._pool = None


class RedisConnector:
    """Minimal async Redis interface: ``cmd('HMGET', key, f1, f2)``."""

    def __init__(self, host="127.0.0.1", port=6379, db=0):
        try:
            import redis.asyncio  # noqa: F401
        except ImportError as exc:
            raise RuntimeError(
                "RedisConnector requires the 'redis' driver"
            ) from exc
        self._cfg = dict(host=host, port=port, db=db)
        self._client = None

    async def cmd(self, *args) -> Any:
        if self._client is None:
            import redis.asyncio as aredis

            self._client = aredis.Redis(
                **self._cfg, decode_responses=True
            )
        return await self._client.execute_command(*args)

    async def close(self) -> None:
        if self._client is not None:
            await self._client.aclose()
            self._client = None


# -------------------------------------------------------------- providers

class SqlAuthenticator(Authenticator):
    """SELECT-based authn (emqx_authn_mysql/postgresql): the query
    must yield at most one row with a ``password_hash`` column and
    optional ``salt`` / ``is_superuser``.  No row -> ignore (fall
    through the chain); wrong password -> deny."""

    is_async = True

    def __init__(
        self,
        connector: SqlConnector,
        query: str = (
            "SELECT password_hash, salt, is_superuser FROM mqtt_user "
            "WHERE username = ${username} LIMIT 1"
        ),
        algorithm: str = "sha256",
        salt_position: str = "prefix",
        iterations: int = 50_000,
    ) -> None:
        check_algorithm_supported(algorithm)
        self.connector = connector
        self.sql, self._getters = compile_query(
            query, connector.paramstyle
        )
        self.algorithm = algorithm
        self.salt_position = salt_position
        self.iterations = iterations

    def authenticate(self, client: ClientInfo):
        return IGNORE, {}  # async-only provider

    async def authenticate_async(self, client: ClientInfo):
        try:
            rows = await self.connector.query(
                self.sql, render_params(self._getters, client)
            )
        except Exception:
            log.exception("sql authn query failed")
            return IGNORE, {}  # DB down: fall through the chain
        if not rows:
            return IGNORE, {}
        row = rows[0]
        ok = verify_password(
            client.password,
            str(row.get("password_hash", "")),
            algorithm=self.algorithm,
            salt=str(row.get("salt") or ""),
            salt_position=self.salt_position,
            iterations=self.iterations,
        )
        if not ok:
            return DENY, {}
        return ALLOW, {
            "is_superuser": bool(row.get("is_superuser") or False)
        }

    async def close(self) -> None:
        await self.connector.close()


class SqlAuthorizer:
    """SELECT-based authz source (emqx_authz_mysql/postgresql): rows
    ``(permission, action, topic)`` evaluated in order; topics may
    embed placeholders and EMQX's ``eq_`` prefix pins a
    literal topic (no wildcard expansion)."""

    def __init__(
        self,
        connector: SqlConnector,
        query: str = (
            "SELECT permission, action, topic FROM mqtt_acl "
            "WHERE username = ${username}"
        ),
    ) -> None:
        self.connector = connector
        self.sql, self._getters = compile_query(
            query, connector.paramstyle
        )

    async def fetch_rows(self, client: ClientInfo) -> List[Dict]:
        """All ACL rows for this client (prefetched at CONNECT into
        AccessControl's per-client cache — the emqx_authz_cache
        role)."""
        return await self.connector.query(
            self.sql, render_params(self._getters, client)
        )

    async def authorize_async(
        self, client: ClientInfo, action: str, topic: str
    ) -> str:
        try:
            rows = await self.fetch_rows(client)
        except Exception:
            log.exception("sql authz query failed")
            return IGNORE
        return evaluate_acl_rows(rows, client, action, topic)

    def authorize(self, client: ClientInfo, action: str, topic: str):
        return IGNORE  # async-only source

    async def close(self) -> None:
        await self.connector.close()


def evaluate_acl_rows(
    rows: Sequence[Dict], client: ClientInfo, action: str, topic: str
) -> str:
    """First matching row decides (emqx_authz_rule semantics):
    ``action`` of a row may be publish/subscribe/all; ``topic``
    matches as an MQTT filter unless prefixed ``eq_``/``eq `` (exact
    literal, EMQX's <<"eq ...">> form)."""
    for row in rows:
        r_action = str(row.get("action", "all")).lower()
        if r_action not in ("all", action):
            continue
        pattern = render_topic(str(row.get("topic", "")), client)
        if pattern.startswith("eq "):
            hit = topic == pattern[3:]
        elif pattern.startswith("eq_"):
            hit = topic == pattern[3:]
        else:
            try:
                hit = T.match(topic, pattern)
            except ValueError:
                continue
        if hit:
            perm = str(row.get("permission", "allow")).lower()
            return ALLOW if perm == "allow" else DENY
    return IGNORE


class RedisAuthenticator(Authenticator):
    """HMGET-based authn (emqx_authn_redis): the command template
    names a key with placeholders and the fields to fetch, e.g.
    ``HMGET mqtt_user:${username} password_hash salt is_superuser``."""

    is_async = True

    def __init__(
        self,
        connector: RedisConnector,
        cmd: str = ("HMGET mqtt_user:${username} password_hash salt "
                    "is_superuser"),
        algorithm: str = "sha256",
        salt_position: str = "prefix",
        iterations: int = 50_000,
    ) -> None:
        check_algorithm_supported(algorithm)
        self.connector = connector
        parts = cmd.split()
        if not parts or parts[0].upper() != "HMGET" or len(parts) < 3:
            raise ValueError(
                "redis authn cmd must be 'HMGET <key> <field>...'"
            )
        self._key_tpl = parts[1]
        self.fields = parts[2:]
        self.algorithm = algorithm
        self.salt_position = salt_position
        self.iterations = iterations

    def authenticate(self, client: ClientInfo):
        return IGNORE, {}

    async def authenticate_async(self, client: ClientInfo):
        key = render_topic(self._key_tpl, client)
        try:
            vals = await self.connector.cmd("HMGET", key, *self.fields)
        except Exception:
            log.exception("redis authn failed")
            return IGNORE, {}
        row = dict(zip(self.fields, vals or ()))
        if not row.get("password_hash"):
            return IGNORE, {}
        ok = verify_password(
            client.password,
            str(row["password_hash"]),
            algorithm=self.algorithm,
            salt=str(row.get("salt") or ""),
            salt_position=self.salt_position,
            iterations=self.iterations,
        )
        if not ok:
            return DENY, {}
        return ALLOW, {
            "is_superuser": str(row.get("is_superuser") or "")
            in ("1", "true", "True")
        }

    async def close(self) -> None:
        await self.connector.close()


class RedisAuthorizer:
    """HGETALL-based authz (emqx_authz_redis): the hash at
    ``mqtt_acl:${username}`` maps topic filter -> action
    (publish|subscribe|all); present = allow (EMQX's Redis
    source is allow-only; denial comes from the chain default)."""

    def __init__(
        self,
        connector: RedisConnector,
        cmd: str = "HGETALL mqtt_acl:${username}",
    ) -> None:
        self.connector = connector
        parts = cmd.split()
        if len(parts) != 2 or parts[0].upper() != "HGETALL":
            raise ValueError("redis authz cmd must be 'HGETALL <key>'")
        self._key_tpl = parts[1]

    def authorize(self, client: ClientInfo, action: str, topic: str):
        return IGNORE  # async-only source

    async def fetch_rows(self, client: ClientInfo) -> List[Dict]:
        key = render_topic(self._key_tpl, client)
        table = await self.connector.cmd("HGETALL", key)
        if isinstance(table, dict):
            items = table.items()
        else:  # flat [k, v, k, v] reply shape
            items = zip(table[::2], table[1::2])
        return [
            {"permission": "allow", "action": v, "topic": k}
            for k, v in items
        ]

    async def authorize_async(
        self, client: ClientInfo, action: str, topic: str
    ) -> str:
        try:
            rows = await self.fetch_rows(client)
        except Exception:
            log.exception("redis authz failed")
            return IGNORE
        return evaluate_acl_rows(rows, client, action, topic)

    async def close(self) -> None:
        await self.connector.close()
