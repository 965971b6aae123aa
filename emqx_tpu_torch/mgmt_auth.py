"""Management-plane authentication: admin users with JWT login, API
keys, role-based access, all persisted to disk.

A copy of the JAX package's ``mgmt_auth`` (EMQX's ``emqx_mgmt_auth``
API-key table with hashed secrets, expiry and roles, and the
dashboard's admin users with ``sign_token`` and its RBAC check): every
/api/v5 route answers 401 without credentials; operators authenticate
either interactively (POST /api/v5/login -> Bearer JWT) or
programmatically (HTTP Basic with an API key/secret pair whose secret
is shown exactly once at creation, stored hashed).  The files under
``data_dir`` have the JAX package's format, so either package's
`MgmtAuth` reads a store the other wrote.

Roles:
  * ``administrator`` — full access.
  * ``viewer``        — read-only (GET/HEAD); mutations answer 403.
  * ``publisher``     — the publish endpoint and nothing else.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import logging
import os
import secrets
import time
from typing import Any, Dict, Optional, Tuple

from .auth_providers import make_jwt, _b64url_decode

log = logging.getLogger("emqx_tpu_torch.mgmt_auth")

ROLE_ADMIN = "administrator"
ROLE_VIEWER = "viewer"
# the EE dashboard/API rbac's third role: may POST the message-publish
# endpoints and NOTHING else — not even reads (an ingestion credential
# that leaks cannot enumerate the deployment)
ROLE_PUBLISHER = "publisher"
_ROLES = (ROLE_ADMIN, ROLE_VIEWER, ROLE_PUBLISHER)

_PBKDF2_ITERS = 50_000


def _hash_password(password: str, salt: Optional[bytes] = None
                   ) -> Tuple[str, str]:
    salt = salt if salt is not None else os.urandom(16)
    digest = hashlib.pbkdf2_hmac(
        "sha256", password.encode(), salt, _PBKDF2_ITERS
    )
    return salt.hex(), digest.hex()


def _verify_password(password: str, salt_hex: str, hash_hex: str) -> bool:
    digest = hashlib.pbkdf2_hmac(
        "sha256", password.encode(), bytes.fromhex(salt_hex), _PBKDF2_ITERS
    )
    return hmac.compare_digest(digest.hex(), hash_hex)


class Identity:
    """Who an authenticated management request is acting as."""

    __slots__ = ("actor", "role", "via")

    def __init__(self, actor: str, role: str, via: str) -> None:
        self.actor = actor  # username or api key id
        self.role = role
        self.via = via  # "token" | "api_key"

    @property
    def can_write(self) -> bool:
        return self.role == ROLE_ADMIN

    @property
    def publish_only(self) -> bool:
        return self.role == ROLE_PUBLISHER


class MgmtAuth:
    """Persisted admin-user + API-key stores and token mint/verify.

    State lives under ``data_dir``: ``admins.json``, ``api_keys.json``
    and ``jwt.secret`` (random per deployment, persisted so issued
    tokens survive a broker restart, like the dashboard's stored JWKS).
    """

    def __init__(
        self,
        data_dir: str,
        default_username: str = "admin",
        default_password: Optional[str] = "public",
        token_ttl: float = 3600.0,
    ) -> None:
        self.data_dir = data_dir
        self.token_ttl = token_ttl
        os.makedirs(data_dir, exist_ok=True)
        self._admins_path = os.path.join(data_dir, "admins.json")
        self._keys_path = os.path.join(data_dir, "api_keys.json")
        self._secret_path = os.path.join(data_dir, "jwt.secret")
        self.admins: Dict[str, Dict[str, Any]] = self._load(self._admins_path)
        self.api_keys: Dict[str, Dict[str, Any]] = self._load(self._keys_path)
        # api_key -> sha256(secret) after one successful slow verify
        self._fast: Dict[str, str] = {}
        self.secret = self._load_secret()
        if not self.admins and default_password is not None:
            # first boot: seed the default admin (EMQX ships
            # admin/public and forces a change at first dashboard login;
            # here operators change it via POST /api/v5/users/.../change_pwd)
            self.add_admin(default_username, default_password, ROLE_ADMIN)
            log.warning(
                "mgmt auth: bootstrapped default admin %r — change its "
                "password", default_username,
            )

    # ------------------------------------------------------ persistence

    @staticmethod
    def _load(path: str) -> Dict[str, Any]:
        """Absent file = first boot; a PRESENT but unreadable/corrupt
        store is a hard error — treating it as empty would silently
        re-bootstrap the default admin/public credentials over the
        operator's user table."""
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            return {}
        except (OSError, json.JSONDecodeError) as exc:
            raise RuntimeError(
                f"management auth store {path} is unreadable or corrupt "
                f"({exc}); refusing to start with default credentials — "
                "repair or remove the file explicitly"
            ) from exc

    @staticmethod
    def _save(path: str, data: Dict[str, Any]) -> None:
        # owner-only like the jwt secret: these stores hold credential
        # hashes/salts, and the default umask would leave them
        # world-readable
        tmp = path + ".tmp"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            json.dump(data, f, indent=1)
        os.replace(tmp, path)

    def _load_secret(self) -> bytes:
        """Same policy as _load: absent = generate; present-but-broken
        = hard error (a silently regenerated secret would invalidate
        every issued token while masking the underlying disk fault)."""
        try:
            with open(self._secret_path, "rb") as f:
                secret = f.read()
        except FileNotFoundError:
            secret = os.urandom(32)
            tmp = self._secret_path + ".tmp"
            fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
            with os.fdopen(fd, "wb") as f:
                f.write(secret)
            os.replace(tmp, self._secret_path)
            return secret
        except OSError as exc:
            raise RuntimeError(
                f"jwt secret {self._secret_path} unreadable ({exc})"
            ) from exc
        if len(secret) < 32:
            raise RuntimeError(
                f"jwt secret {self._secret_path} is truncated "
                f"({len(secret)} bytes); remove it explicitly to rotate"
            )
        return secret

    # ----------------------------------------------------- admin users

    def add_admin(self, username: str, password: str,
                  role: str = ROLE_ADMIN) -> None:
        if role not in _ROLES:
            raise ValueError(f"unknown role {role!r}")
        if not username or not password:
            raise ValueError("username and password required")
        salt, pw = _hash_password(password)
        self.admins[username] = {"salt": salt, "hash": pw, "role": role}
        self._save(self._admins_path, self.admins)

    def delete_admin(self, username: str) -> bool:
        user = self.admins.get(username)
        if user is None:
            return False
        if user["role"] == ROLE_ADMIN and sum(
            1 for u in self.admins.values() if u["role"] == ROLE_ADMIN
        ) == 1:
            # deleting the last administrator would lock the plane and,
            # worse, the next restart would re-seed default credentials
            raise ValueError("cannot delete the last administrator")
        del self.admins[username]
        self._save(self._admins_path, self.admins)
        return True

    def change_password(self, username: str, old: str, new: str) -> bool:
        user = self.admins.get(username)
        if user is None or not _verify_password(
            old, user["salt"], user["hash"]
        ):
            return False
        if not new:
            raise ValueError("empty password")
        user["salt"], user["hash"] = _hash_password(new)
        # token epoch: every Bearer token minted BEFORE this moment is
        # dead — rotating a compromised password must end the
        # attacker's session too (EMQX destroys tokens in
        # emqx_dashboard_admin on password change)
        user["pwd_changed_at"] = time.time()
        self._save(self._admins_path, self.admins)
        return True

    def login(self, username: str, password: str) -> Optional[str]:
        """Verify credentials; mint a Bearer token (sign_token)."""
        user = self.admins.get(username)
        if user is None or not _verify_password(
            password, user["salt"], user["hash"]
        ):
            return None
        now = time.time()
        return make_jwt(self.secret, {
            "sub": username,
            "role": user["role"],
            "iat": now,
            "exp": now + self.token_ttl,
        })

    def verify_token(self, token: str) -> Optional[Identity]:
        try:
            head_b64, body_b64, sig_b64 = token.split(".")
            header = json.loads(_b64url_decode(head_b64))
            if header.get("alg") != "HS256":
                return None
            expect = hmac.new(
                self.secret, f"{head_b64}.{body_b64}".encode(),
                hashlib.sha256,
            ).digest()
            if not hmac.compare_digest(expect, _b64url_decode(sig_b64)):
                return None
            claims = json.loads(_b64url_decode(body_b64))
        except (ValueError, json.JSONDecodeError):
            return None
        if time.time() > float(claims.get("exp", 0)):
            return None
        username = claims.get("sub", "")
        user = self.admins.get(username)
        if user is None:
            return None  # deleted since the token was minted
        if float(claims.get("iat", 0)) < float(
            user.get("pwd_changed_at", 0)
        ):
            return None  # minted before the last password rotation
        # role comes from the LIVE record, not the token: demoting a
        # user takes effect immediately
        return Identity(username, user["role"], "token")

    # -------------------------------------------------------- API keys

    def create_api_key(
        self,
        name: str,
        role: str = ROLE_ADMIN,
        expires_in: Optional[float] = None,
        enabled: bool = True,
    ) -> Tuple[str, str]:
        """Mint a key/secret pair; the plaintext secret is returned
        exactly once (emqx_mgmt_auth:create stores the hash)."""
        if role not in _ROLES:
            raise ValueError(f"unknown role {role!r}")
        if not name:
            raise ValueError("name required")
        api_key = "key-" + secrets.token_hex(8)
        api_secret = secrets.token_urlsafe(24)
        salt, sh = _hash_password(api_secret)
        self.api_keys[api_key] = {
            "name": name,
            "role": role,
            "salt": salt,
            "hash": sh,
            "enabled": enabled,
            "created_at": time.time(),
            "expired_at": (time.time() + expires_in)
            if expires_in is not None else None,
        }
        self._save(self._keys_path, self.api_keys)
        return api_key, api_secret

    def delete_api_key(self, api_key: str) -> bool:
        if self.api_keys.pop(api_key, None) is None:
            return False
        self._fast.pop(api_key, None)
        self._save(self._keys_path, self.api_keys)
        return True

    def set_api_key_enabled(self, api_key: str, enabled: bool) -> bool:
        entry = self.api_keys.get(api_key)
        if entry is None:
            return False
        entry["enabled"] = enabled
        if not enabled:
            self._fast.pop(api_key, None)
        self._save(self._keys_path, self.api_keys)
        return True

    def verify_api_key(self, api_key: str,
                       api_secret: str) -> Optional[Identity]:
        entry = self.api_keys.get(api_key)
        if entry is None or not entry.get("enabled", True):
            return None
        exp = entry.get("expired_at")
        if exp is not None and time.time() > float(exp):
            return None
        # the slow (on-disk) hash runs once per key; later requests on
        # the broker's event loop compare a cached in-memory digest —
        # 50k PBKDF2 rounds per Basic-authenticated request would stall
        # MQTT traffic sharing the loop
        fast = hashlib.sha256(api_secret.encode()).hexdigest()
        cached = self._fast.get(api_key)
        if cached is not None:
            if not hmac.compare_digest(cached, fast):
                return None
        else:
            if not _verify_password(
                api_secret, entry["salt"], entry["hash"]
            ):
                return None
            self._fast[api_key] = fast
        return Identity(api_key, entry["role"], "api_key")

    # ------------------------------------------------------ HTTP glue

    def authenticate_header(self, header: Optional[str]
                            ) -> Optional[Identity]:
        """Resolve an ``Authorization`` header to an identity:
        ``Bearer <jwt>`` (dashboard token) or ``Basic key:secret``
        (API key, as EMQX's API consumers send)."""
        if not header:
            return None
        scheme, _, rest = header.partition(" ")
        scheme = scheme.lower()
        if scheme == "bearer" and rest:
            return self.verify_token(rest.strip())
        if scheme == "basic" and rest:
            try:
                raw = base64.b64decode(rest.strip()).decode()
                key, _, secret = raw.partition(":")
            except (ValueError, UnicodeDecodeError):
                return None
            return self.verify_api_key(key, secret)
        return None

    def info(self) -> list:
        return [
            {
                "api_key": k,
                "name": e["name"],
                "role": e["role"],
                "enabled": e.get("enabled", True),
                "created_at": e.get("created_at"),
                "expired_at": e.get("expired_at"),
            }
            for k, e in self.api_keys.items()
        ]


class AuditLog:
    """Persisted audit trail of mutating API/CLI calls (EMQX
    persists these in mnesia, emqx_audit.erl; here an append-only JSONL
    file reloaded on boot — an audit trail must survive a restart)."""

    def __init__(self, data_dir: str, cap: int = 1000) -> None:
        self.cap = cap
        os.makedirs(data_dir, exist_ok=True)
        self.path = os.path.join(data_dir, "audit.jsonl")
        self.entries: list = []
        self._file_lines = 0
        try:
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        self._file_lines += 1
                        try:
                            self.entries.append(json.loads(line))
                        except json.JSONDecodeError:
                            continue
            self.entries = self.entries[-cap:]
        except OSError:
            pass

    def append(self, entry: Dict[str, Any]) -> None:
        self.entries.append(entry)
        del self.entries[: -self.cap]
        try:
            if self._file_lines >= self.cap * 10:
                # compact instead of growing without bound: rewrite the
                # retained window (EMQX's mnesia table is
                # similarly capped by emqx_audit's max_size)
                tmp = self.path + ".tmp"
                with open(tmp, "w") as f:
                    for e in self.entries:
                        f.write(json.dumps(e, separators=(",", ":"))
                                + "\n")
                os.replace(tmp, self.path)
                self._file_lines = len(self.entries)
            else:
                with open(self.path, "a") as f:
                    f.write(json.dumps(entry, separators=(",", ":"))
                            + "\n")
                self._file_lines += 1
        except OSError:
            log.exception("audit append failed")
