"""The port's Broker (plain kernels on the CPU) against the JAX
package's Broker: the same scripted MQTT session — wildcard subscribers
at QoS 0/1/2, no-local, retain-as-published, subscription identifiers,
MQTT 3.1.1 and 5.0 clients, the QoS handshakes, PINGREQ, UNSUBSCRIBE,
DISCONNECT — writes the same bytes to every client.  Then a round trip
over a real socket through ``python -m emqx_tpu_torch.broker``."""

import asyncio
import os
import subprocess
import sys

import pytest

from emqx_tpu.broker.broker import Broker as RefBroker
from emqx_tpu.broker.channel import Channel as RefChannel
from emqx_tpu.codec import mqtt as C

from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.broker.channel import Channel
from emqx_tpu_torch.codec import mqtt as PC

from mqtt_client import TestClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Wire:
    """One client's channel on one broker, capturing the wire bytes the
    connection would write (serialized at the channel's version)."""

    def __init__(self, chan_cls, codec, broker):
        self.writes = []
        self.packets = []
        self.codec = codec
        self.parser = codec.StreamParser()

        def send(pkts):
            self.packets.extend(pkts)
            self.writes.append(
                b"".join(codec.serialize(p, self.ch.version) for p in pkts)
            )

        self.closed = []
        self.ch = chan_cls(broker, send=send, close=self.closed.append)

    def feed(self, data: bytes):
        for pkt in self.parser.feed(data):
            self.ch.handle_in(pkt)
            if self.closed:
                break
        if self.closed:
            # the connection's read loop ends and reports the loss
            self.ch.connection_lost(self.closed[0])


class Pair:
    """The same client on both brokers."""

    def __init__(self, ref_broker, port_broker, version):
        self.version = version
        self.ref = Wire(RefChannel, C, ref_broker)
        self.port = Wire(Channel, PC, port_broker)
        self.seen = 0
        # parses what the client receives (server -> client bytes)
        self.inbound = C.StreamParser(version=version)

    def send(self, pkt):
        data = C.serialize(pkt, self.version)
        self.ref.feed(data)
        self.port.feed(data)

    def assert_same(self, name):
        assert self.ref.writes == self.port.writes, name

    def auto_ack(self):
        """Answer new PUBLISH (PUBACK / PUBREC) and PUBREL (PUBCOMP)
        packets; returns how many answers went out."""
        data = b"".join(self.ref.writes[self.seen:])
        self.seen = len(self.ref.writes)
        n = 0
        for p in list(self.inbound.feed(data)):
            if p.type == C.PUBLISH and p.qos == 1:
                self.send(C.Puback(packet_id=p.packet_id))
            elif p.type == C.PUBLISH and p.qos == 2:
                self.send(C.Pubrec(packet_id=p.packet_id))
            elif p.type == C.PUBREL:
                self.send(C.Pubcomp(packet_id=p.packet_id))
            else:
                continue
            n += 1
        return n


SUBS = {
    # clientid: (version, [(filter, qos, no_local, rap)], subid)
    "s1": (C.MQTT_V5, [("t/+/a", 1, False, False)], None),
    "s2": (C.MQTT_V4, [("t/#", 2, False, False)], None),
    "s3": (C.MQTT_V5, [("t/x/+", 0, False, False),
                       ("r/+", 2, False, True)], None),
    "p1": (C.MQTT_V5, [("t/x/a", 1, True, False)], None),
    "s4": (C.MQTT_V5, [("r/#", 2, False, False)], 7),
    "s5": (C.MQTT_V4, [("+/+/+", 1, False, False)], None),
    "s6": (C.MQTT_V5, [("#", 2, False, True)], None),
}

PUBS = [
    # (topic, qos, retain, payload)
    ("t/x/a", 0, False, b"q0"),
    ("t/x/a", 1, False, b"q1"),
    ("t/y/a", 2, False, b"q2"),
    ("r/1", 1, True, b"retained"),
    ("r/2", 2, True, b"retained2"),
    ("t/x/b", 2, False, b"q2b"),
    ("$SYS/x", 1, False, b"dollar"),
    ("nomatch", 1, False, b"none"),
]


@pytest.mark.parametrize("expiry", [0, 60])
def test_wire_bytes_equal_reference(expiry, monkeypatch):
    """The default broker: connected runs splice through the native
    window assembly."""
    from emqx_tpu_torch.ops import dispatchasm

    calls = []
    orig = dispatchasm.assemble_window
    monkeypatch.setattr(dispatchasm, "assemble_window",
                        lambda *a: calls.append(1) or orig(*a))
    _wire_world(expiry, native=True)
    assert calls


@pytest.mark.parametrize("expiry", [0, 60])
def test_wire_bytes_python_path_equal_reference(expiry, monkeypatch):
    """``Broker(native=False)``: the Python referees of the host path
    (host tries, topic encode, sorts, per-delivery encode) write the
    same bytes, and the native splice never runs."""
    from emqx_tpu_torch.ops import dispatchasm

    def refuse(*a):
        raise AssertionError("native assembly on the Python path")

    monkeypatch.setattr(dispatchasm, "assemble_window", refuse)
    _wire_world(expiry, native=False)


def _wire_world(expiry, native):
    ref, port = RefBroker(), Broker(device="cpu", native=native)
    clients = {}
    for cid, (ver, subs, subid) in SUBS.items():
        c = clients[cid] = Pair(ref, port, ver)
        props = ({"session_expiry_interval": expiry}
                 if ver == C.MQTT_V5 else {})
        c.send(C.Connect(client_id=cid, proto_ver=ver, keepalive=30,
                         clean_start=True, properties=props))
        sprops = ({"subscription_identifier": [subid]}
                  if subid is not None else {})
        c.send(C.Subscribe(
            packet_id=1,
            subscriptions=[
                C.Subscription(topic_filter=f, qos=q, no_local=nl,
                               retain_as_published=rap)
                for f, q, nl, rap in subs
            ],
            properties=sprops,
        ))
        c.assert_same(f"connect+subscribe {cid}")
    # matching goes through the automaton (kernel path) from here on
    port.router.engine.rebuild()
    ref.router.engine.rebuild()
    pub = clients["p1"]
    for k, (topic, qos, retain, payload) in enumerate(PUBS):
        pub.send(C.Publish(topic=topic, qos=qos, retain=retain,
                           payload=payload,
                           packet_id=(100 + k) if qos else None))
        if qos == 2:
            pub.send(C.Pubrel(packet_id=100 + k))
        # every subscriber answers its deliveries until quiet
        while sum(c.auto_ack() for c in clients.values()):
            pass
        for cid, c in clients.items():
            c.assert_same(f"publish {topic} -> {cid}")
    clients["s1"].send(C.Pingreq())
    clients["s2"].send(C.Unsubscribe(packet_id=9, topic_filters=["t/#",
                                                                 "zz"]))
    clients["s6"].send(C.Unsubscribe(packet_id=9, topic_filters=["#"]))
    clients["s3"].send(C.Disconnect())
    pub.send(C.Publish(topic="t/x/a", qos=1, packet_id=200,
                       payload=b"after"))
    pub.send(C.Publish(topic="r/9", qos=1, packet_id=201,
                       payload=b"queued"))
    while sum(c.auto_ack() for c in clients.values()):
        pass
    for cid, c in clients.items():
        c.assert_same(f"after unsubscribe {cid}")
    # every client saw real traffic
    assert all(len(c.port.writes) >= 2 for c in clients.values())
    # a late subscriber gets the retained r/1 and r/2 after its SUBACK
    late = clients["late"] = Pair(ref, port, C.MQTT_V5)
    late.send(C.Connect(client_id="late", proto_ver=C.MQTT_V5,
                        keepalive=30))
    late.send(C.Subscribe(packet_id=1, subscriptions=[
        C.Subscription(topic_filter="r/+", qos=2)]))
    while sum(c.auto_ack() for c in clients.values()):
        pass
    late.assert_same("late subscriber")
    replay = [p for p in C.StreamParser(version=C.MQTT_V5).feed(
        b"".join(late.port.writes)) if p.type == C.PUBLISH]
    assert [(p.topic, p.payload, p.retain) for p in replay] == [
        ("r/1", b"retained", True), ("r/2", b"retained2", True)]
    # s3 comes back: with a session expiry its queued QoS>0 deliveries
    # resume behind a session-present CONNACK; without one it starts
    # clean
    s3 = clients["s3"] = Pair(ref, port, C.MQTT_V5)
    s3.send(C.Connect(client_id="s3", proto_ver=C.MQTT_V5, keepalive=30,
                      clean_start=False,
                      properties={"session_expiry_interval": expiry}))
    while sum(c.auto_ack() for c in clients.values()):
        pass
    s3.assert_same("s3 reconnect")
    assert (b"queued" in b"".join(s3.port.writes)) == (expiry > 0)
    assert port.router.engine.counters["decide_windows"] > 0
    assert port.router.engine.counters["dev_windows"] > 0


def _start_cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "emqx_tpu_torch.broker", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )


def test_socket_round_trip_through_cli():
    proc = _start_cli("--device", "cpu", "--port", "0", "--bind",
                      "127.0.0.1")
    try:
        line = proc.stdout.readline()
        assert "listening on" in line, (line, proc.stderr.read())
        port = int(line.split("127.0.0.1:")[1].split()[0])

        async def run():
            sub = TestClient(port, "sub")
            pub = TestClient(port, "pub", version=C.MQTT_V4)
            await sub.connect()
            await pub.connect()
            ack = await sub.subscribe("rt/+", qos=1)
            assert ack.reason_codes == [1]
            assert await pub.publish("rt/x", b"hello", qos=1) is not None
            got = await sub.recv_publish()
            assert (got.topic, got.payload, got.qos) == ("rt/x", b"hello", 1)
            await sub.ping()
            await sub.disconnect()
            await pub.disconnect()

        asyncio.run(asyncio.wait_for(run(), 20))
    finally:
        proc.terminate()
        proc.wait(timeout=10)
