"""The port's GCP IoT-Core device registry against the JAX package's:
clientid parsing, the authenticator's decision ladder with the port's
own RS256/ES256 verifier (standard library only) giving the verdicts
the JAX package gets from ``cryptography``, on public keys and
certificates, good, tampered, expired and wrong-key JWTs; the workload's
signer checked by ``cryptography``; the registry file read by either
package; and the REST CRUD (and 501 NOT_ENABLED with the registry off)
through one `workload.ApiClient` against both servers."""

import asyncio
import base64
import datetime
import json
import time

import numpy as np
import pytest
from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec, padding, rsa
from cryptography.hazmat.primitives.asymmetric.utils import (
    decode_dss_signature, encode_dss_signature)
from cryptography.x509.oid import NameOID

from emqx_tpu import access as RA
from emqx_tpu import gcp_device as RG
from emqx_tpu.broker.listener import BrokerServer as RefServer
from emqx_tpu.config import BrokerConfig as RefConfig
from emqx_tpu.config import ListenerConfig as RefListener

from emqx_tpu_torch import access as PA
from emqx_tpu_torch import gcp_device as PG
from emqx_tpu_torch import workload as W
from emqx_tpu_torch.broker.listener import BrokerServer
from emqx_tpu_torch.config import BrokerConfig, ListenerConfig

CLIENTID = "projects/p1/locations/us-central1/registries/reg1/devices/dev1"


def b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def jwt(key, claims, alg=None) -> str:
    alg = alg or ("RS256" if isinstance(key, rsa.RSAPrivateKey) else "ES256")
    head = b64url(json.dumps({"alg": alg, "typ": "JWT"}).encode())
    signing = f"{head}.{b64url(json.dumps(claims).encode())}".encode()
    if isinstance(key, rsa.RSAPrivateKey):
        sig = key.sign(signing, padding.PKCS1v15(), hashes.SHA256())
    else:
        r, s = decode_dss_signature(key.sign(signing,
                                             ec.ECDSA(hashes.SHA256())))
        sig = r.to_bytes(32, "big") + s.to_bytes(32, "big")
    return f"{signing.decode()}.{b64url(sig)}"


def spki(key, compressed=False) -> str:
    pub = key.public_key()
    if compressed:
        pt = pub.public_bytes(serialization.Encoding.X962,
                              serialization.PublicFormat.CompressedPoint)
        alg = bytes.fromhex("301306072a8648ce3d020106082a8648ce3d030107")
        bits = bytes([0x03, len(pt) + 1, 0]) + pt
        der = bytes([0x30, len(alg) + len(bits)]) + alg + bits
        return ("-----BEGIN PUBLIC KEY-----\n"
                + base64.encodebytes(der).decode()
                + "-----END PUBLIC KEY-----\n")
    return pub.public_bytes(serialization.Encoding.PEM,
                            serialization.PublicFormat.SubjectPublicKeyInfo
                            ).decode()


def pkcs1(key) -> str:
    return key.public_key().public_bytes(
        serialization.Encoding.PEM,
        serialization.PublicFormat.PKCS1).decode()


def cert(key, signer) -> str:
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "dev1")])
    now = datetime.datetime.now(datetime.timezone.utc)
    c = (x509.CertificateBuilder().subject_name(name).issuer_name(name)
         .public_key(key.public_key()).serial_number(7)
         .not_valid_before(now - datetime.timedelta(days=2))
         .not_valid_after(now - datetime.timedelta(days=1))  # expired
         .sign(signer, hashes.SHA256()))
    return c.public_bytes(serialization.Encoding.PEM).decode()


@pytest.fixture(scope="module")
def keys():
    rk = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    rk3 = rsa.generate_private_key(public_exponent=3, key_size=1024)
    ek = ec.generate_private_key(ec.SECP256R1())
    e384 = ec.generate_private_key(ec.SECP384R1())
    other_r = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    other_e = ec.generate_private_key(ec.SECP256R1())
    return dict(rsa=rk, rsa3=rk3, ec=ek, ec384=e384, other_rsa=other_r,
                other_ec=other_e)


def test_deviceid_parse_equals_reference():
    for cid in (CLIENTID, "ordinary-client", "projects/p/devices/d",
                "projects/p/locations/l/registries/r/devices/",
                "projects/p/locations/l/registries/r/devices/d/x",
                "Projects/p/locations/l/registries/r/devices/d",
                "projects//locations//registries//devices/d", ""):
        assert PG.deviceid_from_clientid(cid) == \
            RG.deviceid_from_clientid(cid)
    assert PG.deviceid_from_clientid(CLIENTID) == "dev1"


def _pems(k):
    return {
        "rsa_spki": spki(k["rsa"]), "rsa_pkcs1": pkcs1(k["rsa"]),
        "rsa_cert": cert(k["rsa"], k["other_rsa"]),
        "rsa_e3": spki(k["rsa3"]),
        "ec_spki": spki(k["ec"]), "ec_compressed": spki(k["ec"], True),
        "ec_cert": cert(k["ec"], k["rsa"]), "ec384": spki(k["ec384"]),
        "garbage": "-----BEGIN PUBLIC KEY-----\nAAAA\n"
                   "-----END PUBLIC KEY-----\n",
        "not_pem": "ssh-rsa AAAAB3NzaC1yc2E",
        "private": k["ec"].private_bytes(
            serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption()).decode(),
    }


def test_verifier_equals_cryptography(keys):
    """`_verify_sig` of both packages on every key form and every
    signature case: the same verdict, each signer's own key verifying."""
    msg = b"eyJhbGciOiJSUzI1NiJ9.eyJleHAiOjF9"
    sigs = {}
    for name in ("rsa", "rsa3", "ec", "ec384", "other_rsa", "other_ec"):
        k = keys[name]
        if isinstance(k, rsa.RSAPrivateKey):
            sigs[name] = ("RS256",
                          k.sign(msg, padding.PKCS1v15(), hashes.SHA256()))
        else:
            r, s = decode_dss_signature(k.sign(msg,
                                               ec.ECDSA(hashes.SHA256())))
            n = k.curve.key_size // 8 + (k.curve.key_size % 8 > 0)
            sigs[name] = ("ES256", r.to_bytes(n, "big") + s.to_bytes(n, "big"))
    rs, es = sigs["rsa"][1], sigs["ec"][1]
    sigs.update({
        "rsa_tampered": ("RS256", rs[:-1] + bytes([rs[-1] ^ 1])),
        "rsa_short": ("RS256", rs[1:]),
        "rsa_zero": ("RS256", bytes(len(rs))),
        "ec_tampered": ("ES256", es[:40] + bytes([es[40] ^ 4]) + es[41:]),
        "ec_high_s": ("ES256", es[:32] + (
            PG._N - int.from_bytes(es[32:], "big")).to_bytes(32, "big")),
        "ec_zero": ("ES256", bytes(64)),
        "ec_n": ("ES256", PG._N.to_bytes(32, "big") * 2),
        "alg_none": ("none", b""),
        "alg_hs": ("HS256", rs),
    })
    trues = 0
    for pname, pem in _pems(keys).items():
        for sname, (alg, sig) in sigs.items():
            for m in (msg, msg + b"x"):
                want = RG._verify_sig(pem.encode(), alg, m, sig)
                got = PG._verify_sig(pem.encode(), alg, m, sig)
                assert got == want, (pname, sname, m)
                trues += got
    # every key form verifies its own key's signature: rsa 3 forms + e3,
    # ec 3 forms (ec_high_s is valid ECDSA too: s and n - s both verify)
    assert trues == 4 + 3 * 2


def test_authenticator_ladder_equals_reference(keys, tmp_path):
    """Both packages' authenticators over registries holding the same
    devices: good, tampered, expired, wrong-key, non-JWT, unknown
    device, expired key, an ES256 device and a certificate key."""
    now = int(time.time())
    devices = [
        {"deviceid": "dev1", "keys": [{"key_type": "RSA_PEM",
                                       "key": spki(keys["rsa"])}]},
        {"deviceid": "dev2", "keys": [{"key_type": "ES256_PEM",
                                       "key": spki(keys["ec"])}]},
        {"deviceid": "dev3", "keys": [
            {"key_type": "RSA_PEM", "key": spki(keys["other_rsa"]),
             "expires_at": now - 10},
            {"key_type": "RSA_X509_PEM",
             "key": cert(keys["rsa"], keys["rsa"])}]},
        {"deviceid": "dev4", "keys": [{"key": spki(keys["rsa"]),
                                       "expires_at": now - 10}]},
    ]
    good = jwt(keys["rsa"], {"exp": now + 300})
    cases = [
        ("dev1", good), ("dev1", good[:-6] + "AAAAAA"),
        ("dev1", jwt(keys["rsa"], {"exp": now - 300})),
        ("dev1", jwt(keys["rsa"], {"exp": now - 3})),  # within the leeway
        ("dev1", jwt(keys["other_rsa"], {"exp": now + 300})),
        ("dev1", jwt(keys["rsa"], {"exp": now + 300}, alg="ES256")),
        ("dev1", "not-a-jwt"), ("dev1", ""), ("dev1", "a.b.c"),
        ("dev9", good), ("dev2", jwt(keys["ec"], {"aud": "p1"})),
        ("dev2", jwt(keys["other_ec"], {})), ("dev3", good),
        ("dev4", good),
    ]
    out = []
    for A, G in ((RA, RG), (PA, PG)):
        reg = G.GcpDeviceRegistry(str(tmp_path / f"{G.__name__}.json"))
        assert reg.import_devices(devices) == (4, 0)
        auth = G.GcpDeviceAuthenticator(reg)
        got = [auth.authenticate(A.ClientInfo(
            clientid=f"projects/p/locations/l/registries/r/devices/{d}",
            password=pw.encode() or None)) for d, pw in cases]
        got.append(auth.authenticate(A.ClientInfo(clientid="plain",
                                                  password=good.encode())))
        out.append(got)
    assert out[0] == out[1]
    verdicts = [d for d, _ in out[1]]
    assert verdicts == ["allow", "deny", "deny", "allow", "deny", "deny",
                        "ignore", "ignore", "ignore", "ignore", "allow",
                        "deny", "allow", "deny", "ignore"]


def test_workload_signer_verifies_under_cryptography():
    """The workload's own keys and JWTs (what chip_smoke's devices use)
    verify with ``cryptography`` and with both packages' verifiers."""
    rng = np.random.default_rng(3)
    for key in (W.rsa_key(rng, 1024), W.p256_key(rng)):
        pem = W.public_pem(key).encode()
        pub = serialization.load_pem_public_key(pem)
        token = W.sign_jwt(key, {"exp": 2 ** 31})
        head, body, sig = token.split(".")
        signing = f"{head}.{body}".encode()
        raw = base64.urlsafe_b64decode(sig + "=" * (-len(sig) % 4))
        if key["kty"] == "RSA":
            pub.verify(raw, signing, padding.PKCS1v15(), hashes.SHA256())
            alg = "RS256"
        else:
            pub.verify(encode_dss_signature(
                int.from_bytes(raw[:32], "big"),
                int.from_bytes(raw[32:], "big")), signing,
                ec.ECDSA(hashes.SHA256()))
            alg = "ES256"
        for G in (RG, PG):
            assert G._verify_sig(pem, alg, signing, raw)
            assert not G._verify_sig(pem, alg, signing + b"x", raw)


def test_registry_file_read_across_packages(keys, tmp_path):
    path = str(tmp_path / "gcp_devices.json")
    dev = {"deviceid": "d1", "keys": [{"key": spki(keys["ec"]),
                                       "expires_at": 0}],
           "project": "p1", "location": "l", "registry": "r",
           "created_at": 5.0, "extra": {"a": [1]}}
    for Writer, Reader in ((RG, PG), (PG, RG)):
        w = Writer.GcpDeviceRegistry(path)
        w.clear()
        w.put_device(dev)
        w.put_device({"deviceid": "d2", "keys": []})
        assert w.remove_device("d2") and not w.remove_device("d2")
        r = Reader.GcpDeviceRegistry(path)
        assert r.list_devices() == w.list_devices()
        assert r.get_device("d1")["keys"][0]["key_type"] == "RSA_PEM"
        assert r.actual_keys("d1") == [spki(keys["ec"])]
        assert r.actual_keys("nope") is None
    with open(path) as f:
        on_disk = json.load(f)
    assert list(on_disk) == ["d1"]
    # a corrupt file reads as empty in both
    with open(path, "w") as f:
        f.write("{not json")
    assert PG.GcpDeviceRegistry(path).list_devices() == \
        RG.GcpDeviceRegistry(path).list_devices() == []


def _servers(tmp_path, enable: bool):
    out = []
    for side, Cfg, Lst in (("ref", RefConfig, RefListener),
                           ("port", BrokerConfig, ListenerConfig)):
        cfg = Cfg(listeners=[Lst(bind="127.0.0.1", port=0)])
        cfg.api.enable, cfg.api.port = True, 0
        cfg.api.data_dir = str(tmp_path / f"{side}-api")
        cfg.sys.interval = float("inf")
        cfg.gcp_device_enable = enable
        cfg.gcp_device_file = str(tmp_path / side / "gcp" / "devices.json")
        if side == "ref":
            cfg.engine.use_device = False
            out.append(RefServer(cfg))
        else:
            out.append(BrokerServer(cfg, device="cpu"))
    return out


def test_rest_crud_and_not_enabled_equal_reference(keys, tmp_path):
    """One `workload.ApiClient` script against both servers: bulk import
    skipping bad entries, 400s, list, get, put, delete, 404; the audit
    trail; the registry file the port wrote restarts the port; and with
    the registry off every route answers 501 NOT_ENABLED."""
    pem = spki(keys["rsa"])
    script = [
        ("POST", "/api/v5/gcp_devices", [
            {"deviceid": "d1", "keys": [{"key": pem, "expires_at": 0}]},
            {"deviceid": "d2", "keys": []},
            {"keys": "not-a-device"},
            {"deviceid": "d4", "keys": [{"no": "key"}]}]),
        ("POST", "/api/v5/gcp_devices", {"not": "a list"}),
        ("PUT", "/api/v5/gcp_devices/dX", {"keys": ["bare-string"]}),
        ("PUT", "/api/v5/gcp_devices/dY", ["a list"]),
        ("GET", "/api/v5/gcp_devices", None),
        ("PUT", "/api/v5/gcp_devices/d3", {"keys": [{"key": pem}],
                                          "project": "p"}),
        ("GET", "/api/v5/gcp_devices/d3", None),
        ("GET", "/api/v5/gcp_devices/p%2Fd3", None),
        ("DELETE", "/api/v5/gcp_devices/d2", None),
        ("GET", "/api/v5/gcp_devices/d2", None),
        ("DELETE", "/api/v5/gcp_devices/d2", None),
        ("GET", "/api/v5/gcp_devices", None),
        ("GET", "/api/v5/audit", None),
    ]

    async def drive(servers, steps):
        loop = asyncio.get_running_loop()
        for s in servers:
            await s.start()
        outs = []
        try:
            for s in servers:
                cl = W.ApiClient(s.api.port)
                cl.auth = await loop.run_in_executor(None, cl.login)
                outs.append([W.api_norm(await loop.run_in_executor(
                    None, cl.call, m, p, b)) for m, p, b in steps])
                cl.close()
        finally:
            for s in servers:
                await s.stop()
        return outs

    ref, prt = asyncio.run(asyncio.wait_for(
        drive(_servers(tmp_path, True), script), 30))
    assert prt == ref
    assert prt[0][2] == {"imported": 2, "errors": 2}
    assert [st for st, _, _ in prt] == [200, 400, 400, 400, 200, 200, 200,
                                        404, 204, 404, 404, 200, 200]
    assert prt[-2][2]["meta"]["count"] == 2

    async def restart():
        srv = _servers(tmp_path, True)[1]
        await srv.start()
        try:
            return sorted(d["deviceid"]
                          for d in srv.broker.gcp_devices.list_devices())
        finally:
            await srv.stop()

    assert asyncio.run(restart()) == ["d1", "d3"]
    off = [(m, p, b) for m, p, b in script[:-1]]
    ref, prt = asyncio.run(asyncio.wait_for(
        drive(_servers(tmp_path / "off", False), off), 30))
    assert prt == ref
    assert {(st, body["code"]) for st, _, body in prt} == \
        {(501, "NOT_ENABLED")}
