"""LDAP authentication backend — BER-encoded simple bind, no library.

A copy of the JAX package's ``auth_ldap.py``.  EMQX's emqx_auth_ldap
authenticates by binding to the directory as the client (bind method)
or by comparing a stored hash (search method).  This module implements the BIND method on a
hand-rolled subset of BER/LDAPv3: BindRequest with simple
authentication, BindResponse resultCode parsing.  resultCode 0 =
ALLOW, 49 (invalidCredentials) = DENY, anything else (including
transport failure) = IGNORE so the chain's remaining providers still
get a say.

Scope: simple bind only (no StartTLS, no SASL)."""

from __future__ import annotations

import asyncio
import logging
from typing import Optional, Tuple

from .access import ALLOW, DENY, IGNORE, Authenticator, ClientInfo

log = logging.getLogger("emqx_tpu_torch.auth_ldap")

RES_SUCCESS = 0
RES_INVALID_CREDENTIALS = 49

# RFC 4514 §2.4: characters that must be backslash-escaped inside an
# attribute value so a crafted username cannot rewrite the DN (e.g.
# 'x,ou=admins,dc=example,dc=com' escaping the intended subtree)
_DN_SPECIALS = set(',+"\\<>;=')


def escape_dn_value(value: str) -> str:
    """Escape one RDN attribute value per RFC 4514 before template
    substitution: specials get a backslash, a leading '#'/space and a
    trailing space are escaped positionally, NUL becomes ``\\00``."""
    out = []
    last = len(value) - 1
    for i, ch in enumerate(value):
        if ch == "\x00":
            out.append("\\00")
        elif ch in _DN_SPECIALS:
            out.append("\\" + ch)
        elif i == 0 and ch in "# ":
            out.append("\\" + ch)
        elif i == last and ch == " ":
            out.append("\\ ")
        else:
            out.append(ch)
    return "".join(out)


# ----------------------------------------------------------------- BER

def _ber_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(body)]) + body


def _ber(tag: int, content: bytes) -> bytes:
    return bytes([tag]) + _ber_len(len(content)) + content


def _ber_int(n: int) -> bytes:
    body = n.to_bytes(max((n.bit_length() + 8) // 8, 1), "big",
                      signed=True)
    return _ber(0x02, body)


def bind_request(msg_id: int, dn: str, password: bytes) -> bytes:
    """LDAPMessage{ messageID, BindRequest{ 3, dn, simple pw } }."""
    op = _ber(
        0x60,  # [APPLICATION 0] BindRequest
        _ber_int(3) + _ber(0x04, dn.encode())
        + _ber(0x80, password),  # [0] simple
    )
    return _ber(0x30, _ber_int(msg_id) + op)


def parse_bind_response(data: bytes) -> Tuple[int, int]:
    """Returns (messageID, resultCode); raises on malformed input."""

    def read_tlv(buf: bytes, off: int) -> Tuple[int, bytes, int]:
        tag = buf[off]
        ln = buf[off + 1]
        off += 2
        if ln & 0x80:
            n = ln & 0x7F
            ln = int.from_bytes(buf[off:off + n], "big")
            off += n
        return tag, buf[off:off + ln], off + ln

    tag, seq, _ = read_tlv(data, 0)
    if tag != 0x30:
        raise ValueError("not an LDAPMessage")
    tag, mid_b, off = read_tlv(seq, 0)
    if tag != 0x02:
        raise ValueError("missing messageID")
    msg_id = int.from_bytes(mid_b, "big")
    tag, op, _ = read_tlv(seq, off)
    if tag != 0x61:  # [APPLICATION 1] BindResponse
        raise ValueError(f"not a BindResponse (tag 0x{tag:02x})")
    tag, code_b, _ = read_tlv(op, 0)
    if tag != 0x0A:  # ENUMERATED
        raise ValueError("missing resultCode")
    return msg_id, int.from_bytes(code_b, "big")


# ------------------------------------------------------------- provider

class LdapAuthenticator(Authenticator):
    """Bind-method authentication: the client's credentials are tried
    as an LDAP simple bind on a templated DN."""

    is_async = True

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 389,
        bind_dn: str = "uid=${username},ou=users,dc=example,dc=com",
        timeout: float = 5.0,
    ) -> None:
        self.host = host
        self.port = port
        self.bind_dn = bind_dn
        self.timeout = timeout
        self._msg_id = 0

    def authenticate(self, client: ClientInfo):
        return IGNORE, {}  # async-only provider

    async def authenticate_async(self, client: ClientInfo):
        if not client.username or not client.password:
            # an empty password would be an RFC 4513 UNAUTHENTICATED
            # bind — many directories answer it resultCode 0, which
            # would turn "no credential" into ALLOW
            return IGNORE, {}
        # escaped substitution: the username is DATA inside the DN,
        # never structure (authorization-scope bypass otherwise)
        dn = self.bind_dn.replace(
            "${username}", escape_dn_value(client.username)
        )
        self._msg_id += 1
        try:
            r, w = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port),
                self.timeout,
            )
            try:
                w.write(bind_request(
                    self._msg_id, dn, client.password or b""
                ))
                await w.drain()
                # responses are < 128 bytes in practice; read the TLV
                head = await asyncio.wait_for(
                    r.readexactly(2), self.timeout
                )
                ln = head[1]
                if ln & 0x80:
                    n = ln & 0x7F
                    ext = await asyncio.wait_for(
                        r.readexactly(n), self.timeout
                    )
                    ln = int.from_bytes(ext, "big")
                    head += ext
                body = await asyncio.wait_for(
                    r.readexactly(ln), self.timeout
                )
            finally:
                w.close()
        except Exception:
            log.exception("ldap bind transport failed")
            return IGNORE, {}
        try:
            _mid, code = parse_bind_response(head + body)
        except ValueError:
            log.warning("ldap: malformed bind response")
            return IGNORE, {}
        if code == RES_SUCCESS:
            return ALLOW, {}
        if code == RES_INVALID_CREDENTIALS:
            return DENY, {}
        return IGNORE, {}

    async def close(self) -> None:
        pass
