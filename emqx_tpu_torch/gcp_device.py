"""GCP IoT-Core compatible device registry + authenticator.

A copy of the JAX package's ``gcp_device.py``, the role of EMQX's
`emqx_gcp_device` app (emqx_gcp_device.erl put/get/remove/
import_devices, emqx_gcp_device_authn.erl check logic): devices
migrated off Google Cloud IoT Core keep their clientid shape
``projects/P/locations/L/registries/R/devices/D`` and authenticate
with a JWT in the password field, signed by one of the device's
registered public keys (RS256/ES256, like IoT Core).  The registry is
persisted (the same JSON file as the JAX package's) and managed over
REST.

Decision ladder (authn.erl's check/1): non-GCP clientid or non-JWT
password -> IGNORE (next provider); expired JWT -> DENY; device
unknown -> IGNORE; no unexpired keys, or no key verifying the
signature -> DENY; a key verifies -> ALLOW.

The JAX package verifies signatures with the ``cryptography`` package.
This one has its own verifier, on the standard library alone: a DER reader for SubjectPublicKeyInfo, PKCS#1
RSAPublicKey and X.509 certificates, RSASSA-PKCS1-v1_5 with SHA-256
(RS256) and ECDSA over P-256 with SHA-256 (ES256, the JWS r||s form).
A key it cannot parse verifies nothing (DENY), as a key
``cryptography`` cannot load does in the JAX package.
"""

from __future__ import annotations

import base64
import binascii
import hashlib
import hmac
import json
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .access import ALLOW, DENY, IGNORE, Authenticator, ClientInfo
from .auth_providers import _b64url_decode


def deviceid_from_clientid(clientid: str) -> Optional[str]:
    """``projects/P/locations/L/registries/R/devices/D`` -> ``D``
    (authn.erl gcp_deviceid_from_clientid)."""
    parts = clientid.split("/")
    if (
        len(parts) == 8
        and parts[0] == "projects"
        and parts[2] == "locations"
        and parts[4] == "registries"
        and parts[6] == "devices"
        and parts[7]
    ):
        return parts[7]
    return None


# ----------------------------------------------------------- key parsing

class UnparsableKey(ValueError):
    """A key the verifier cannot parse."""


_PEM = re.compile(
    rb"-----BEGIN ([A-Z0-9 ]+)-----\s*(.*?)\s*-----END \1-----", re.S)
# DER of the OIDs: rsaEncryption, id-ecPublicKey, prime256v1
_OID_RSA = bytes.fromhex("2a864886f70d010101")
_OID_EC = bytes.fromhex("2a8648ce3d0201")
_OID_P256 = bytes.fromhex("2a8648ce3d030107")


def _pem(data: bytes) -> Tuple[str, bytes]:
    """The first PEM block's label and its DER bytes."""
    m = _PEM.search(data)
    if m is None:
        raise UnparsableKey("no PEM block")
    try:
        der = base64.b64decode(b"".join(m.group(2).split()), validate=True)
    except binascii.Error as exc:
        raise UnparsableKey("bad PEM base64") from exc
    return m.group(1).decode(), der


def _tlv(buf: bytes, off: int, tag: Optional[int] = None
         ) -> Tuple[int, int, int]:
    """(tag, content start, content end) of the DER element at
    ``off``; ``tag``, when given, must match."""
    if off + 2 > len(buf):
        raise UnparsableKey("truncated DER")
    t, ln = buf[off], buf[off + 1]
    off += 2
    if ln & 0x80:
        n = ln & 0x7F
        if n == 0 or n > 4 or off + n > len(buf):
            raise UnparsableKey("bad DER length")
        ln = int.from_bytes(buf[off:off + n], "big")
        off += n
    if off + ln > len(buf):
        raise UnparsableKey("truncated DER")
    if tag is not None and t != tag:
        raise UnparsableKey(f"DER tag 0x{t:02x}, expected 0x{tag:02x}")
    return t, off, off + ln


def _children(buf: bytes, start: int, end: int) -> List[Tuple[int, int, int]]:
    out = []
    while start < end:
        t, s, e = _tlv(buf, start)
        if e > end:
            raise UnparsableKey("DER element past its parent")
        out.append((t, s, e))
        start = e
    return out


def _uint(buf: bytes, el: Tuple[int, int, int]) -> int:
    t, s, e = el
    if t != 0x02 or s == e or buf[s] & 0x80:
        raise UnparsableKey("not a positive INTEGER")
    return int.from_bytes(buf[s:e], "big")


def _rsa_public(der: bytes) -> Tuple[str, Any]:
    """PKCS#1 RSAPublicKey: ("rsa", (n, e))."""
    _, s, e = _tlv(der, 0, 0x30)
    kids = _children(der, s, e)
    if len(kids) != 2:
        raise UnparsableKey("RSAPublicKey is not (n, e)")
    n, exp = _uint(der, kids[0]), _uint(der, kids[1])
    if n.bit_length() < 512 or exp < 3 or not exp & 1:
        raise UnparsableKey("bad RSA modulus or exponent")
    return "rsa", (n, exp)


def _spki(der: bytes, s: int, e: int) -> Tuple[str, Any]:
    """SubjectPublicKeyInfo: an RSA key or a P-256 point."""
    kids = _children(der, s, e)
    if len(kids) != 2 or kids[0][0] != 0x30 or kids[1][0] != 0x03:
        raise UnparsableKey("not a SubjectPublicKeyInfo")
    alg = _children(der, kids[0][1], kids[0][2])
    if not alg or alg[0][0] != 0x06:
        raise UnparsableKey("no algorithm OID")
    oid = der[alg[0][1]:alg[0][2]]
    _, bs, be = kids[1]
    if bs == be or der[bs] != 0:
        raise UnparsableKey("bit string with unused bits")
    key = der[bs + 1:be]
    if oid == _OID_RSA:
        return _rsa_public(key)
    if oid == _OID_EC:
        if len(alg) != 2 or alg[1][0] != 0x06 or \
                der[alg[1][1]:alg[1][2]] != _OID_P256:
            raise UnparsableKey("EC key not on P-256")
        return "p256", _p256_point(key)
    raise UnparsableKey("unsupported key algorithm")


def _certificate_spki(der: bytes) -> Tuple[str, Any]:
    """The subjectPublicKeyInfo of an X.509 certificate (its dates and
    signature are not checked, as IoT Core did not)."""
    _, s, e = _tlv(der, 0, 0x30)
    _, ts, te = _tlv(der, s, 0x30)  # tbsCertificate
    kids = _children(der, ts, te)
    if kids and kids[0][0] == 0xA0:  # [0] EXPLICIT version
        kids = kids[1:]
    # serial, signature, issuer, validity, subject, subjectPublicKeyInfo
    if len(kids) < 6 or kids[5][0] != 0x30:
        raise UnparsableKey("not a certificate")
    return _spki(der, kids[5][1], kids[5][2])


def load_public_key(pem: bytes) -> Tuple[str, Any]:
    """A registered key (PEM: a certificate, a SubjectPublicKeyInfo or a
    PKCS#1 RSA key) as ("rsa", (n, e)) or ("p256", (x, y)); raises
    `UnparsableKey` (a ValueError) for a key it cannot parse."""
    label, der = _pem(pem)
    if label == "CERTIFICATE":
        return _certificate_spki(der)
    if label == "PUBLIC KEY":
        _, s, e = _tlv(der, 0, 0x30)
        if e != len(der):
            raise UnparsableKey("trailing bytes after the key")
        return _spki(der, s, e)
    if label == "RSA PUBLIC KEY":
        return _rsa_public(der)
    raise UnparsableKey(f"unsupported PEM block {label!r}")


# -------------------------------------------------------------- RS256

# DER of DigestInfo{ sha256, NULL } before the 32-byte digest (RFC 8017
# section 9.2, note 1)
_SHA256_PREFIX = bytes.fromhex("3031300d060960864801650304020105000420")


def rs256_verify(n: int, e: int, signing: bytes, sig: bytes) -> bool:
    """RSASSA-PKCS1-v1_5 with SHA-256 (RFC 8017 section 8.2.2)."""
    k = (n.bit_length() + 7) // 8
    if len(sig) != k:
        return False
    s = int.from_bytes(sig, "big")
    if s >= n:
        return False
    em = pow(s, e, n).to_bytes(k, "big")
    t = _SHA256_PREFIX + hashlib.sha256(signing).digest()
    if k < len(t) + 11:
        return False
    want = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
    return hmac.compare_digest(em, want)


# -------------------------------------------------------------- ES256

# P-256 (SEC 2 secp256r1; FIPS 186-4 D.1.2.3)
_P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
_A = _P - 3
_B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
_N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
_G = (0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
      0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5)


def _on_curve(x: int, y: int) -> bool:
    return (0 <= x < _P and 0 <= y < _P
            and (y * y - (x * x * x + _A * x + _B)) % _P == 0)


def _p256_point(data: bytes) -> Tuple[int, int]:
    """An uncompressed (04 || X || Y) or compressed (02/03 || X) point,
    checked to lie on the curve."""
    if len(data) == 65 and data[0] == 4:
        x = int.from_bytes(data[1:33], "big")
        y = int.from_bytes(data[33:], "big")
    elif len(data) == 33 and data[0] in (2, 3):
        x = int.from_bytes(data[1:], "big")
        if x >= _P:
            raise UnparsableKey("point off the curve")
        y = pow((x * x * x + _A * x + _B) % _P, (_P + 1) // 4, _P)
        if y & 1 != data[0] & 1:
            y = _P - y
    else:
        raise UnparsableKey("bad EC point encoding")
    if not _on_curve(x, y):
        raise UnparsableKey("point off the curve")
    return x, y


# points in Jacobian coordinates (X, Y, Z): x = X/Z^2, y = Y/Z^3; Z = 0
# is the point at infinity

def _jdouble(p):
    x, y, z = p
    if z == 0 or y == 0:
        return (1, 1, 0)
    yy = y * y % _P
    s = 4 * x * yy % _P
    m = 3 * (x - z * z) * (x + z * z) % _P  # a = -3
    x3 = (m * m - 2 * s) % _P
    return (x3, (m * (s - x3) - 8 * yy * yy) % _P, 2 * y * z % _P)


def _jadd(p, q):
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1, z2z2 = z1 * z1 % _P, z2 * z2 % _P
    u1, u2 = x1 * z2z2 % _P, x2 * z1z1 % _P
    s1, s2 = y1 * z2 * z2z2 % _P, y2 * z1 * z1z1 % _P
    if u1 == u2:
        return _jdouble(p) if s1 == s2 else (1, 1, 0)
    h, r = (u2 - u1) % _P, (s2 - s1) % _P
    hh = h * h % _P
    hhh = h * hh % _P
    v = u1 * hh % _P
    x3 = (r * r - hhh - 2 * v) % _P
    return (x3, (r * (v - x3) - s1 * hhh) % _P, z1 * z2 * h % _P)


def _mul2(u1: int, p, u2: int, q):
    """u1 * p + u2 * q (Shamir's trick), Jacobian."""
    pq = _jadd(p, q)
    acc = (1, 1, 0)
    for i in range(max(u1.bit_length(), u2.bit_length()) - 1, -1, -1):
        acc = _jdouble(acc)
        b1, b2 = (u1 >> i) & 1, (u2 >> i) & 1
        if b1 and b2:
            acc = _jadd(acc, pq)
        elif b1:
            acc = _jadd(acc, p)
        elif b2:
            acc = _jadd(acc, q)
    return acc


def es256_verify(point: Tuple[int, int], signing: bytes,
                 sig: bytes) -> bool:
    """ECDSA over P-256 with SHA-256 (FIPS 186-4 section 6.4.2), the
    signature as JWS carries it: r || s, 32 bytes each."""
    if len(sig) != 64:
        return False
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    if not (0 < r < _N and 0 < s < _N):
        return False
    e = int.from_bytes(hashlib.sha256(signing).digest(), "big")
    w = pow(s, -1, _N)
    x, _y, z = _mul2(e * w % _N, (*_G, 1), r * w % _N, (*point, 1))
    if z == 0:
        return False
    return (x * pow(z * z, -1, _P) % _P) % _N == r


def _verify_sig(key_pem: bytes, alg: str, signing: bytes,
                sig: bytes) -> bool:
    """RS256/ES256 verification with a device's registered public key
    (PEM; certificates accepted too, as IoT Core allowed).  A key that
    does not parse, or of the other algorithm's type, verifies
    nothing."""
    try:
        kind, key = load_public_key(key_pem)
    except UnparsableKey:
        return False
    if alg == "RS256" and kind == "rsa":
        return rs256_verify(*key, signing, sig)
    if alg == "ES256" and kind == "p256":
        return es256_verify(key, signing, sig)
    return False


class GcpDeviceRegistry:
    """deviceid -> keys [{key_type, key, expires_at}] + location tuple
    (+extra), persisted as one JSON file (the mnesia table's role)."""

    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path
        self._devices: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    self._devices = json.load(f)
            except (OSError, json.JSONDecodeError):
                self._devices = {}

    def _flush(self) -> None:
        if not self.path:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._devices, f)
        os.replace(tmp, self.path)

    def put_device(self, device: Dict[str, Any]) -> None:
        """{"deviceid", "keys": [{"key_type","key","expires_at"}],
        "project","location","registry","extra"}"""
        if not isinstance(device, dict) or "deviceid" not in device:
            raise ValueError("device must be an object with deviceid")
        deviceid = str(device["deviceid"])
        raw_keys = device.get("keys", [])
        if not isinstance(raw_keys, list) or any(
            not isinstance(k, dict) or "key" not in k
            for k in raw_keys
        ):
            raise ValueError(
                f"device {deviceid}: keys must be objects with 'key'"
            )
        keys = [
            {
                "key_type": str(k.get("key_type", "RSA_PEM")),
                "key": str(k["key"]),
                "expires_at": float(k.get("expires_at", 0)),
            }
            for k in raw_keys
        ]
        with self._lock:
            self._devices[deviceid] = {
                "deviceid": deviceid,
                "keys": keys,
                "project": str(device.get("project", "")),
                "location": str(device.get("location", "")),
                "registry": str(device.get("registry", "")),
                "created_at": float(
                    device.get("created_at", time.time())
                ),
                "extra": device.get("extra", {}),
            }
            self._flush()

    def get_device(self, deviceid: str) -> Optional[Dict[str, Any]]:
        return self._devices.get(deviceid)

    def remove_device(self, deviceid: str) -> bool:
        with self._lock:
            found = self._devices.pop(deviceid, None) is not None
            if found:
                self._flush()
        return found

    def import_devices(
        self, devices: List[Dict[str, Any]]
    ) -> Tuple[int, int]:
        """Per-device fold that continues past bad entries, returning
        (imported, errors) — emqx_gcp_device:import_devices/1."""
        imported = errors = 0
        for d in devices:
            try:
                self.put_device(d)
                imported += 1
            except (ValueError, TypeError, KeyError):
                errors += 1
        return imported, errors

    def list_devices(self) -> List[Dict[str, Any]]:
        return list(self._devices.values())

    def clear(self) -> None:
        with self._lock:
            self._devices.clear()
            self._flush()

    def actual_keys(self, deviceid: str) -> Optional[List[str]]:
        """Unexpired key PEMs, or None when the device is unknown
        (emqx_gcp_device:get_device_actual_keys)."""
        device = self._devices.get(deviceid)
        if device is None:
            return None
        now = time.time()
        return [
            k["key"]
            for k in device["keys"]
            if not k["expires_at"] or k["expires_at"] >= now
        ]


class GcpDeviceAuthenticator(Authenticator):
    def __init__(self, registry: GcpDeviceRegistry,
                 leeway: float = 5.0) -> None:
        self.registry = registry
        self.leeway = leeway

    @staticmethod
    def _peek(
        token: str,
    ) -> Optional[Tuple[str, bytes, bytes, Dict[str, Any]]]:
        """(alg, signing_input, signature, claims) without
        verification, or None when the password is not JWT-shaped."""
        try:
            head_b64, body_b64, sig_b64 = token.split(".")
            header = json.loads(_b64url_decode(head_b64))
            alg = header.get("alg")
            if not isinstance(alg, str):
                return None
            claims = json.loads(_b64url_decode(body_b64))
            if not isinstance(claims, dict):
                return None
            return (alg, f"{head_b64}.{body_b64}".encode(),
                    _b64url_decode(sig_b64), claims)
        except (ValueError, json.JSONDecodeError):
            return None

    def authenticate(self, client: ClientInfo):
        deviceid = deviceid_from_clientid(client.clientid or "")
        if deviceid is None or not client.password:
            return IGNORE, {}
        peeked = self._peek(client.password.decode("utf-8", "replace"))
        if peeked is None:
            return IGNORE, {}  # not a JWT: let other providers try
        alg, signing, sig, claims = peeked
        exp = claims.get("exp")
        if isinstance(exp, (int, float)) and \
                time.time() > float(exp) + self.leeway:
            return DENY, {}
        keys = self.registry.actual_keys(deviceid)
        if keys is None:
            return IGNORE, {}  # unknown device: not ours to judge
        for pem in keys:
            if _verify_sig(pem.encode(), alg, signing, sig):
                return ALLOW, {}
        return DENY, {}
