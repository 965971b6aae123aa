"""Additional authentication backends: pbkdf2 store, JWT, HTTP.

EMQX's per-backend provider apps (emqx_auth_jwt; password hashing per
the emqx_authn hash options), as the JAX package has them:

  * ``Pbkdf2Authenticator`` — username/password with PBKDF2-HMAC
    (stdlib ``hashlib.pbkdf2_hmac``: the strong hash that needs no
    dependency).
  * ``JwtAuthenticator`` — HS256 JWTs carried in the password field,
    verified with stdlib hmac (no JWT library); checks exp/nbf and
    optional required claims, honors an ``is_superuser`` claim.
  * ``HttpAuthenticator`` — asks an external HTTP service
    (emqx_auth_http); asynchronous, on this package's own HTTP client
    (`httpc`, the standard library alone), and therefore only
    used on the deferred connect path
    (`AccessControl.authenticate_async`), never blocking the loop.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time
from typing import Any, Dict, Optional, Tuple

from .access import ALLOW, DENY, IGNORE, Authenticator, ClientInfo


class Pbkdf2Authenticator(Authenticator):
    """Username/password store hashed with PBKDF2-HMAC-SHA256."""

    def __init__(self, iterations: int = 50_000) -> None:
        self.iterations = iterations
        self._users: Dict[str, Tuple[bytes, bytes, bool]] = {}

    def add_user(
        self, username: str, password: str, is_superuser: bool = False
    ) -> None:
        salt = os.urandom(16)
        digest = hashlib.pbkdf2_hmac(
            "sha256", password.encode(), salt, self.iterations
        )
        self._users[username] = (salt, digest, is_superuser)

    def authenticate(self, client: ClientInfo):
        if client.username is None:
            return IGNORE, {}
        entry = self._users.get(client.username)
        if entry is None:
            return IGNORE, {}
        salt, digest, is_superuser = entry
        given = hashlib.pbkdf2_hmac(
            "sha256", client.password or b"", salt, self.iterations
        )
        if hmac.compare_digest(given, digest):
            return ALLOW, {"is_superuser": is_superuser}
        return DENY, {}


def _b64url_decode(part: str) -> bytes:
    return base64.urlsafe_b64decode(part + "=" * (-len(part) % 4))


class JwtAuthenticator(Authenticator):
    """HS256 JWT in the password field (the emqx_auth_jwt core mode)."""

    def __init__(
        self,
        secret: bytes,
        required_claims: Optional[Dict[str, Any]] = None,
        leeway: float = 5.0,
    ) -> None:
        self.secret = secret
        self.required_claims = dict(required_claims or {})
        self.leeway = leeway

    def _verify(self, token: str) -> Optional[Dict[str, Any]]:
        try:
            head_b64, body_b64, sig_b64 = token.split(".")
            header = json.loads(_b64url_decode(head_b64))
            if header.get("alg") != "HS256":
                return None
            expect = hmac.new(
                self.secret,
                f"{head_b64}.{body_b64}".encode(),
                hashlib.sha256,
            ).digest()
            if not hmac.compare_digest(expect, _b64url_decode(sig_b64)):
                return None
            return json.loads(_b64url_decode(body_b64))
        except (ValueError, json.JSONDecodeError):
            return None

    def authenticate(self, client: ClientInfo):
        if not client.password:
            return IGNORE, {}
        claims = self._verify(client.password.decode("utf-8", "replace"))
        if claims is None:
            return IGNORE, {}  # not a (valid) JWT: let other providers try
        now = time.time()
        exp = claims.get("exp")
        if exp is not None and now > float(exp) + self.leeway:
            return DENY, {}
        nbf = claims.get("nbf")
        if nbf is not None and now < float(nbf) - self.leeway:
            return DENY, {}
        for k, want in self.required_claims.items():
            have = claims.get(k)
            # %c / %u placeholder matching as in EMQX's verify
            if want == "%c":
                want = client.clientid
            elif want == "%u":
                want = client.username
            if have != want:
                return DENY, {}
        return ALLOW, {"is_superuser": bool(claims.get("is_superuser"))}


def make_jwt(secret: bytes, claims: Dict[str, Any]) -> str:
    """Mint an HS256 JWT (test/tooling helper)."""

    def enc(obj) -> str:
        return (
            base64.urlsafe_b64encode(
                json.dumps(obj, separators=(",", ":")).encode()
            )
            .rstrip(b"=")
            .decode()
        )

    head, body = enc({"alg": "HS256", "typ": "JWT"}), enc(claims)
    sig = (
        base64.urlsafe_b64encode(
            hmac.new(secret, f"{head}.{body}".encode(), hashlib.sha256).digest()
        )
        .rstrip(b"=")
        .decode()
    )
    return f"{head}.{body}.{sig}"


class HttpAuthenticator(Authenticator):
    """POSTs credentials to an HTTP service (emqx_auth_http).  Response:
    200 with {"result": "allow"|"deny"|"ignore", "is_superuser": bool};
    any error => ignore (fall through the chain).  Async-only."""

    is_async = True

    def __init__(
        self, url: str, timeout: float = 5.0, method: str = "POST"
    ) -> None:
        self.url = url
        self.timeout = timeout
        self.method = method
        self._session = None

    def authenticate(self, client: ClientInfo):
        # sync chains skip async providers; the deferred connect path
        # (AccessControl.authenticate_async) awaits authenticate_async
        return IGNORE, {}

    async def authenticate_async(self, client: ClientInfo):
        from .httpc import Client

        if self._session is None:
            self._session = Client(timeout=self.timeout)
        try:
            resp = await self._session.request(
                self.method,
                self.url,
                json={
                    "clientid": client.clientid,
                    "username": client.username,
                    "password": (client.password or b"").decode(
                        "utf-8", "replace"
                    ),
                    "peerhost": client.peerhost,
                },
            )
            if resp.status != 200:
                return IGNORE, {}
            body = resp.json()
        except Exception:
            return IGNORE, {}
        result = body.get("result", "ignore")
        if result == ALLOW:
            return ALLOW, {
                "is_superuser": bool(body.get("is_superuser"))
            }
        if result == DENY:
            return DENY, {}
        return IGNORE, {}

    async def close(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None
