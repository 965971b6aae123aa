"""The port's listeners against the JAX package's: one scripted MQTT
session over each of tcp, ssl, ws and wss gives the same bytes (for
WebSocket the raw socket bytes: the handshake response and the frames)
from a reference `BrokerServer` and from the port's, in process and
through ``python -m emqx_tpu_torch.broker --config``; plain HTTP on a
WebSocket listener gets the same 400; TLS with a CRL rejects a revoked
client, needs ``verify`` and reloads the CRL; ``max_connections`` closes
the connection over the cap; the outbound watermark reads a real
transport size on tcp and ssl; ``auto_subscribe`` works end to end.

The ssl and wss listeners use the committed test certificate under
``tests/torch_tls``; the CRL cases make their PKI with `cryptography`."""

import asyncio
import json
import os
import subprocess
import sys
import time

import pytest

from emqx_tpu import config as RC
from emqx_tpu.broker.listener import BrokerServer as RefServer

from emqx_tpu_torch import config as PCfg
from emqx_tpu_torch.broker.listener import BrokerServer
from emqx_tpu_torch.codec import mqtt as C
from emqx_tpu_torch.message import Message
from emqx_tpu_torch.workload import TransportClient

from mqtt_client import TestClient
from test_listeners import _make_pki, _mtls_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CERT = os.path.join(REPO, "tests", "torch_tls", "cert.pem")
KEY = os.path.join(REPO, "tests", "torch_tls", "key.pem")
KINDS = ("tcp", "ssl", "ws", "wss")


def _listeners(mod, **kw):
    out = []
    for kind in KINDS:
        tls = ({"certfile": CERT, "keyfile": KEY}
               if kind in ("ssl", "wss") else {})
        out.append(mod.ListenerConfig(name=f"{kind}_l", type=kind,
                                      bind="127.0.0.1", port=0, **tls, **kw))
    return out


def _ref_server():
    cfg = RC.BrokerConfig(listeners=_listeners(RC))
    cfg.engine.use_device = False
    return RefServer(cfg)


def _port_server():
    return BrokerServer(PCfg.BrokerConfig(listeners=_listeners(PCfg)),
                        device="cpu")


def RawClient(port, kind, client_id, version=C.MQTT_V5):
    """A port-codec client over ``kind`` that keeps every server byte
    (on WebSocket the handshake response and the frames)."""
    return TransportClient(port, client_id, kind, version, cafile=CERT)


async def _session(port, kind):
    """The scripted session on one transport; every client's bytes."""
    sub = RawClient(port, kind, f"sub-{kind}")
    pub = RawClient(port, kind, f"pub-{kind}", version=C.MQTT_V4)
    await sub.connect()
    await pub.connect()
    sub.send(C.Subscribe(packet_id=1, subscriptions=[
        C.Subscription(topic_filter=f"{kind}/s/#", qos=2),
        C.Subscription(topic_filter=f"{kind}/r/+", qos=1)]))
    await sub.expect(C.SUBACK)
    for k, (leaf, qos, retain) in enumerate((
            ("s/a", 0, False), ("s/b", 1, False), ("s/c", 2, False),
            ("r/1", 1, True), ("x/none", 1, False))):
        pid = 10 + k if qos else None
        pub.send(C.Publish(topic=f"{kind}/{leaf}", qos=qos, retain=retain,
                           payload=b"%s:%d" % (leaf.encode(), k),
                           packet_id=pid))
        if qos == 1:
            await pub.expect(C.PUBACK)
        elif qos == 2:
            await pub.expect(C.PUBREC)
            pub.send(C.Pubrel(packet_id=pid))
            await pub.expect(C.PUBCOMP)
        if leaf == "x/none":
            continue
        got = await sub.expect(C.PUBLISH)
        if got.qos == 1:
            sub.send(C.Puback(packet_id=got.packet_id))
        elif got.qos == 2:
            sub.send(C.Pubrec(packet_id=got.packet_id))
            await sub.expect(C.PUBREL)
            sub.send(C.Pubcomp(packet_id=got.packet_id))
    late = RawClient(port, kind, f"late-{kind}")
    await late.connect()
    late.send(C.Subscribe(packet_id=2, subscriptions=[
        C.Subscription(topic_filter=f"{kind}/r/#", qos=1)]))
    await late.expect(C.SUBACK)
    got = await late.expect(C.PUBLISH)
    assert got.retain and got.payload == b"r/1:3"
    late.send(C.Puback(packet_id=got.packet_id))
    sub.send(C.Pingreq())
    await sub.expect(C.PINGRESP)
    for c in (sub, pub, late):
        c.send(C.Disconnect())
        await c.eof(10)
    return {c.client_id: bytes(c.raw) for c in (sub, pub, late)}


async def _all_sessions(ports):
    return {kind: await _session(port, kind)
            for kind, port in zip(KINDS, ports)}


def test_four_transports_equal_reference():
    """The same session over tcp, ssl, ws and wss: the port's in-process
    server writes the reference's bytes to every client."""

    async def run():
        ref, port = _ref_server(), _port_server()
        try:
            await ref.start()
            await port.start()
            want = await _all_sessions([lst.port for lst in ref.listeners])
            got = await _all_sessions([lst.port for lst in port.listeners])
        finally:
            await ref.stop()
            await port.stop()
        assert got == want
        for kind in ("ws", "wss"):
            assert want[kind][f"sub-{kind}"].startswith(
                b"HTTP/1.1 101 Switching Protocols\r\n")

    asyncio.run(asyncio.wait_for(run(), 90))


def test_cli_serves_four_transports_equal_reference(tmp_path):
    """``python -m emqx_tpu_torch.broker --device cpu --config F`` with
    tcp, ssl, ws and wss listeners (and one ``EMQX_TPU_*`` override):
    one line a listener, and the reference server's bytes on each."""
    f = tmp_path / "broker.json"
    f.write_text(json.dumps({"listeners": [
        {"name": f"{k}_l", "type": k, "bind": "127.0.0.1", "port": 0,
         **({"certfile": CERT, "keyfile": KEY} if k in ("ssl", "wss")
            else {})} for k in KINDS]}))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("EMQX_TPU_")}
    env.update(PYTHONPATH=REPO, EMQX_TPU_MQTT__MAX_INFLIGHT="16")
    proc = subprocess.Popen(
        [sys.executable, "-m", "emqx_tpu_torch.broker", "--device", "cpu",
         "--config", str(f)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        lines = [proc.stdout.readline() for _ in KINDS]
        ports = []
        for kind, line in zip(KINDS, lines):
            assert f"listener {kind}_l ({kind}) listening on 127.0.0.1:" \
                in line and "(device cpu)" in line, (lines, proc.poll())
            ports.append(int(line.split("127.0.0.1:")[1].split()[0]))

        async def run():
            ref = _ref_server()
            ref.broker.config.mqtt.max_inflight = 16
            try:
                await ref.start()
                want = await _all_sessions(
                    [lst.port for lst in ref.listeners])
            finally:
                await ref.stop()
            assert await _all_sessions(ports) == want

        asyncio.run(asyncio.wait_for(run(), 90))
    finally:
        proc.terminate()
        proc.communicate(timeout=30)


def test_ws_plain_http_gets_the_reference_400():
    async def run():
        out = []
        for srv in (_ref_server(), _port_server()):
            try:
                await srv.start()
                port = [lst.port for lst in srv.listeners
                        if lst.cfg.type == "ws"][0]
                r, w = await asyncio.open_connection("127.0.0.1", port)
                w.write(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
                await w.drain()
                out.append(await asyncio.wait_for(r.read(), 10))
                w.close()
            finally:
                await srv.stop()
        assert out[0] == out[1] == b"HTTP/1.1 400 Bad Request\r\n\r\n"

    asyncio.run(asyncio.wait_for(run(), 60))


def _mtls_server(pki, **kw):
    return BrokerServer(PCfg.BrokerConfig(listeners=[PCfg.ListenerConfig(
        name="mtls", type="ssl", bind="127.0.0.1", port=0,
        certfile=pki["srv_cert"], keyfile=pki["srv_key"],
        cacertfile=pki["ca"], crlfile=pki["crl"], **kw)]), device="cpu")


def test_tls_crl_rejects_revoked_and_needs_verify(tmp_path):
    pki = _make_pki(tmp_path)

    async def run():
        srv = _mtls_server(pki, verify=True)
        try:
            await srv.start()
            port = srv.listeners[0].port
            assert await _mtls_probe(port, pki["ca"], pki["good_cert"],
                                     pki["good_key"])
            assert not await _mtls_probe(port, pki["ca"], pki["bad_cert"],
                                         pki["bad_key"])
        finally:
            await srv.stop()
        # crlfile without verify: start raises, never skips the check
        srv = _mtls_server(pki)
        try:
            with pytest.raises(ValueError, match="verify"):
                await srv.start()
        finally:
            await srv.stop()

    asyncio.run(asyncio.wait_for(run(), 60))


def test_tls_crl_hot_reload(tmp_path):
    """A CRL rewritten to revoke the good client too takes effect on new
    handshakes after `maybe_reload_crl`, without a restart."""
    import datetime

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.x509.oid import NameOID

    pki = _make_pki(tmp_path)

    async def run():
        srv = _mtls_server(pki, verify=True)
        try:
            await srv.start()
            lst = srv.listeners[0]
            assert not lst.maybe_reload_crl()  # unchanged
            assert await _mtls_probe(lst.port, pki["ca"], pki["good_cert"],
                                     pki["good_key"])
            now = datetime.datetime.now(datetime.timezone.utc)
            ca_key = serialization.load_pem_private_key(
                open(pki["ca_key"], "rb").read(), password=None)
            builder = (x509.CertificateRevocationListBuilder()
                       .issuer_name(x509.Name([x509.NameAttribute(
                           NameOID.COMMON_NAME, "test-ca")]))
                       .last_update(now)
                       .next_update(now + datetime.timedelta(days=1)))
            for name in ("good_cert", "bad_cert"):
                cert = x509.load_pem_x509_certificate(
                    open(pki[name], "rb").read())
                builder = builder.add_revoked_certificate(
                    x509.RevokedCertificateBuilder()
                    .serial_number(cert.serial_number)
                    .revocation_date(now).build())
            with open(pki["crl"], "wb") as f:
                f.write(builder.sign(ca_key, hashes.SHA256()).public_bytes(
                    serialization.Encoding.PEM))
            os.utime(pki["crl"], (0, 10**10))  # a new mtime
            assert lst.maybe_reload_crl()
            assert not await _mtls_probe(lst.port, pki["ca"],
                                         pki["good_cert"], pki["good_key"])
        finally:
            await srv.stop()

    asyncio.run(asyncio.wait_for(run(), 60))


def test_max_connections_closes_the_connection_over_the_cap():
    async def run():
        srv = BrokerServer(PCfg.BrokerConfig(listeners=[PCfg.ListenerConfig(
            bind="127.0.0.1", port=0, max_connections=1)]), device="cpu")
        try:
            await srv.start()
            port = srv.listeners[0].port
            first = TestClient(port, "first")
            await first.connect()
            r, w = await asyncio.open_connection("127.0.0.1", port)
            assert await asyncio.wait_for(r.read(), 10) == b""
            w.close()
            await first.disconnect()
            for _ in range(100):  # the handler ends after the DISCONNECT
                if not srv.listeners[0]._conns:
                    break
                await asyncio.sleep(0.01)
            again = TestClient(port, "again")
            assert (await again.connect()).reason_code == 0
            await again.disconnect()
        finally:
            await srv.stop()

    asyncio.run(asyncio.wait_for(run(), 60))


@pytest.mark.parametrize("kind", ["tcp", "ssl"])
def test_watermark_reads_the_real_transport_buffer(kind):
    """A subscriber that stops reading: once its transport (the TLS
    protocol's on ssl) holds the watermark, QoS 0 deliveries drop and
    count instead of growing the buffer; the broker stays responsive."""

    async def run():
        lc = PCfg.ListenerConfig(name=kind, type=kind, bind="127.0.0.1",
                                 port=0)
        if kind == "ssl":
            lc.certfile, lc.keyfile = CERT, KEY
        cfg = PCfg.BrokerConfig(listeners=[lc])
        cfg.engine.batch_publish = False
        cfg.mqtt.outbound_high_watermark = 64 * 1024
        srv = BrokerServer(cfg, device="cpu")
        try:
            await srv.start()
            sleeper = RawClient(srv.port, kind, "sleeper")
            await sleeper.connect()
            sleeper.send(C.Subscribe(packet_id=1, subscriptions=[
                C.Subscription(topic_filter="flood/#", qos=0)]))
            await sleeper.expect(C.SUBACK)
            sleeper.pause()  # it stops reading its socket
            await asyncio.sleep(0.05)
            broker = srv.broker
            payload = b"x" * 65536
            peak = 0
            for i in range(400):
                broker.publish(Message(topic="flood/a", payload=payload,
                                       timestamp=time.time()))
                ch = broker.cm.channel("sleeper")
                peak = max(peak, ch.out_buffered())
                if broker.metrics["delivery.dropped.out_buffer"]:
                    break
                if i % 16 == 15:
                    await asyncio.sleep(0)
            assert broker.metrics["delivery.dropped.out_buffer"] > 0
            assert peak >= 64 * 1024
            healthy = RawClient(srv.port, kind, "healthy")
            await healthy.connect()
            healthy.send(C.Pingreq())
            await healthy.expect(C.PINGRESP)
            await healthy.close()
            await sleeper.close()
        finally:
            await srv.stop()

    asyncio.run(asyncio.wait_for(run(), 60))


def test_auto_subscribe_through_the_server():
    """The JAX package's auto-subscribe case on the port's server."""

    async def run():
        cfg = PCfg.BrokerConfig(listeners=[PCfg.ListenerConfig(
            bind="127.0.0.1", port=0)])
        cfg.auto_subscribe = [{"topic": "inbox/%c", "qos": 1}]
        srv = BrokerServer(cfg, device="cpu")
        try:
            await srv.start()
            c = TestClient(srv.port, "dev9")
            await c.connect()
            pub = TestClient(srv.port, "p")
            await pub.connect()
            await pub.publish("inbox/dev9", b"auto", qos=1)
            assert (await c.recv_publish()).payload == b"auto"
            await pub.disconnect()
            await c.disconnect()
        finally:
            await srv.stop()

    asyncio.run(asyncio.wait_for(run(), 60))
