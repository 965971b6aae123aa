"""Backpressure in the port against the JAX package.

The outbound high-watermark: a connected subscriber whose transport
holds more than ``mqtt.outbound_high_watermark`` bytes (4 MiB by
default) is written nothing; its QoS 0 deliveries drop (counted
``delivery.dropped.out_buffer``), its QoS>0 ones park on the mqueue
behind ``out_parked`` until the channel's retry timer drains them in
order, and its own no-local publishes are neither queued nor counted.
The connection raises ``conn_congestion/<clientid>`` at 1 MiB buffered
and clears it below 256 KiB and on close.

The publish batcher's per-source lanes: each channel's publishes queue
in its own lane, windows take the lanes round-robin and close at 512
messages (the default ``batch_max`` of 4,096), a source is paused above
its lane's watermark or its fair share of the global bound while other
sources' reads go on, and ``publish_queue_congested`` is raised and
cleared.  Wire bytes, counts, queues and alarms equal the reference's
on the same inputs."""

import asyncio
import time

import pytest

from emqx_tpu.broker.broker import Broker as RefBroker
from emqx_tpu.broker.broker import PublishBatcher as RefBatcher
from emqx_tpu.broker.connection import Connection as RefConnection
from emqx_tpu.codec import mqtt as C
from emqx_tpu.message import Message as RefMessage

from emqx_tpu_torch.broker.broker import Broker, PublishBatcher
from emqx_tpu_torch.broker.connection import Connection
from emqx_tpu_torch.codec import mqtt as PC
from emqx_tpu_torch.config import BrokerConfig, ListenerConfig
from emqx_tpu_torch.broker.listener import BrokerServer
from emqx_tpu_torch.message import Message
from emqx_tpu_torch import workload as W

from mqtt_client import TestClient
from test_torch_broker import Pair

MIB = 1 << 20


def _connect(ref, port, cid, subs=(), version=C.MQTT_V5):
    c = Pair(ref, port, version)
    c.send(C.Connect(client_id=cid, proto_ver=version, keepalive=30))
    if subs:
        c.send(C.Subscribe(packet_id=1, subscriptions=[
            C.Subscription(topic_filter=f, qos=q, no_local=nl)
            for f, q, nl in subs]))
    c.assert_same(f"connect {cid}")
    return c


def _stall(c, buf):
    """Both brokers' channels of ``c`` report ``buf[0]`` bytes in their
    transport."""
    c.ref.ch.transport_buffered = lambda: buf[0]
    c.port.ch.transport_buffered = lambda: buf[0]


def _queued(broker, cid):
    return [(m.topic, m.payload, m.qos)
            for m in broker.cm.lookup(cid).mqueue]


def _parked(ref, port, cid):
    a = ref.cm.lookup(cid).out_parked
    assert a == port.cm.lookup(cid).out_parked, cid
    return a


def _metric(ref, port, name):
    a = ref.metrics.val(name)
    assert a == port.metrics[name], name
    return a


# ------------------------------------------------ outbound watermark


@pytest.mark.parametrize("native", [True, False])
def test_stalled_subscriber_drops_qos0_parks_qos1_then_drains(native):
    """ROADMAP's F1 input: a v5 ``w/#`` QoS 1 subscriber whose transport
    reports 8 MiB; ``w/a`` at QoS 0 and ``w/b`` at QoS 1.  Nothing is
    written to it, the QoS 0 delivery is dropped and counted, the QoS 1
    one parks; a later delivery queues behind it even once the buffer
    recovered, the retry timer flushes both in order, and the next
    delivery rides the wire again.  A healthy subscriber gets
    everything."""
    ref, port = RefBroker(), Broker(device="cpu", native=native)
    assert port.config.mqtt.outbound_high_watermark == 4 * MIB
    stalled = _connect(ref, port, "stalled", [("w/#", 1, False)])
    healthy = _connect(ref, port, "healthy", [("w/#", 1, False)])
    pub = _connect(ref, port, "pub")
    clients = (stalled, healthy, pub)
    for b in (ref, port):
        b.router.engine.rebuild()
    buf = [8 * MIB]
    _stall(stalled, buf)
    before = len(stalled.port.writes)

    def publish(topic, qos, payload, pid):
        pub.send(C.Publish(topic=topic, qos=qos, payload=payload,
                           packet_id=pid if qos else None))
        for c in (healthy, pub):
            c.auto_ack()
        for c in clients:
            c.assert_same(f"{topic} -> {c.port.ch.clientid}")

    publish("w/a", 0, b"a", None)
    publish("w/b", 1, b"b", 1)
    assert len(stalled.port.writes) == before
    assert _metric(ref, port, "delivery.dropped.out_buffer") == 1
    assert _queued(port, "stalled") == _queued(ref, "stalled") == [
        ("w/b", b"b", 1)]
    assert _parked(ref, port, "stalled")
    # the subscriber drained its buffer, but w/c queues behind w/b
    buf[0] = 0
    publish("w/c", 1, b"c", 2)
    assert len(stalled.port.writes) == before
    assert _queued(port, "stalled") == _queued(ref, "stalled") == [
        ("w/b", b"b", 1), ("w/c", b"c", 1)]
    # the 5 s timer flushes the parked queue in order
    stalled.ref.ch.retry_deliveries()
    stalled.port.ch.retry_deliveries()
    stalled.assert_same("drain")
    got = [p.payload for p in C.StreamParser(version=C.MQTT_V5).feed(
        b"".join(stalled.port.writes[before:])) if p.type == C.PUBLISH]
    assert got == [b"b", b"c"]
    assert not _parked(ref, port, "stalled")
    assert _queued(port, "stalled") == []
    stalled.auto_ack()
    publish("w/d", 1, b"d", 3)
    assert len(stalled.port.writes) == before + 2
    assert _metric(ref, port, "delivery.dropped.out_buffer") == 1


@pytest.mark.parametrize("native", [True, False])
def test_stalled_subscriber_own_publishes_stay_no_local(native):
    """[MQTT-3.8.3-3] on the stalled path: the subscriber's own
    publishes are neither queued back to it nor counted as drops."""
    ref, port = RefBroker(), Broker(device="cpu", native=native)
    c = _connect(ref, port, "selfpub", [("nl/#", 1, True)])
    _stall(c, [10 * MIB])
    c.send(C.Publish(topic="nl/t", qos=1, payload=b"own", packet_id=1))
    c.send(C.Publish(topic="nl/t", qos=0, payload=b"own0"))
    c.assert_same("own publishes")
    assert _queued(port, "selfpub") == _queued(ref, "selfpub") == []
    assert not _parked(ref, port, "selfpub")
    assert _metric(ref, port, "delivery.dropped.out_buffer") == 0


class _Transport:
    def __init__(self):
        self.size = 0

    def get_write_buffer_size(self):
        return self.size


class _Writer:
    """A stream writer whose transport reports a settable buffer."""

    def __init__(self):
        self.transport = _Transport()
        self.data = bytearray()
        self.closed = False

    def write(self, data):
        self.data += data

    def is_closing(self):
        return self.closed

    def close(self):
        self.closed = True

    def get_extra_info(self, name):
        return ("127.0.0.1", 50000) if name == "peername" else None


def test_congestion_alarm_raised_cleared_and_cleared_on_close():
    """``conn_congestion/<clientid>``: raised at 1 MiB buffered (once,
    counting ``connection.congested``), kept at 512 KiB, cleared below
    256 KiB, and cleared when the connection closes."""
    ref, port = RefBroker(), Broker(device="cpu")
    conns = []
    for b, cls, codec in ((ref, RefConnection, C), (port, Connection, PC)):
        conn = cls(b, None, _Writer())
        for pkt in codec.StreamParser().feed(C.serialize(
                C.Connect(client_id="slow", proto_ver=C.MQTT_V5))):
            conn.channel.handle_in(pkt)
        conns.append((b, conn, codec))

    def step(size, close=False):
        seen = []
        for b, conn, codec in conns:
            conn.writer.transport.size = size
            if close:
                conn._close("gone")
            else:
                conn._send_packets([codec.Pingresp()])
            seen.append(([a.name for a in b.alarms.active()],
                         b.metrics["connection.congested"]
                         if b is port else b.metrics.val(
                             "connection.congested")))
        assert seen[0] == seen[1], (size, seen)
        return seen[1]

    assert step(100) == ([], 0)
    assert step(2 * MIB) == (["conn_congestion/slow"], 1)
    assert step(3 * MIB) == (["conn_congestion/slow"], 1)
    assert step(512 * 1024) == (["conn_congestion/slow"], 1)
    assert step(100 * 1024) == ([], 1)
    assert step(2 * MIB) == (["conn_congestion/slow"], 2)
    assert step(2 * MIB, close=True) == ([], 2)


# ------------------------------------------------------ per-source lanes


def _windows(broker, name):
    """Record the size of every window the batcher prepares."""
    sizes = []
    orig = getattr(broker, name)

    def spy(msgs, *a, **kw):
        sizes.append(len(msgs))
        return orig(msgs, *a, **kw)

    setattr(broker, name, spy)
    return sizes


def test_light_client_rides_the_first_window_of_a_flood():
    """ROADMAP's F2 input: a QoS 0 subscriber on ``t/#``; client
    ``flood`` publishes 600 QoS 0 messages on ``t/f``, then client
    ``light`` one on ``t/l``, and only then do the batchers start.
    ``light``'s message is delivered 2nd, in windows of 512 and 89, and
    the subscriber's bytes equal the reference's."""

    async def run():
        ref, port = RefBroker(), Broker(device="cpu")
        ref.batcher = RefBatcher(ref)
        port.batcher = PublishBatcher(port)
        assert port.batcher._window_limit() == 512
        sizes = (_windows(ref, "publish_prepare_async"),
                 _windows(port, "publish_prepare"))
        sub = _connect(ref, port, "sub", [("t/#", 0, False)])
        flood = _connect(ref, port, "flood")
        light = _connect(ref, port, "light")
        for b in (ref, port):
            b.router.engine.rebuild()
        for k in range(600):
            flood.send(C.Publish(topic="t/f", qos=0, payload=b"%d" % k))
        light.send(C.Publish(topic="t/l", qos=0, payload=b"light"))
        try:
            await ref.batcher.start()
            await port.batcher.start()
            deadline = time.monotonic() + 60
            while True:
                got = [[p for p in C.StreamParser(version=C.MQTT_V5).feed(
                    b"".join(w.writes)) if p.type == C.PUBLISH]
                    for w in (sub.ref, sub.port)]
                if min(map(len, got)) >= 601:
                    break
                assert time.monotonic() < deadline, [len(g) for g in got]
                await asyncio.sleep(0.01)
        finally:
            await ref.batcher.stop()
            await port.batcher.stop()
        sub.assert_same("subscriber")
        assert [p.payload for p in got[1][:3]] == [b"0", b"light", b"1"]
        assert sizes[0] == sizes[1] == [512, 89]

    asyncio.run(asyncio.wait_for(run(), 120))


def test_lane_watermarks_fair_share_and_alarm_equal_reference():
    """A flooder past its lane's watermark is paused (its own event)
    and raises ``publish_queue_congested`` while another source is not
    paused; past the global bound every lane over its fair share is
    paused but a light one is not; draining releases the lanes and
    clears the alarm.  Step by step equal to the reference."""

    async def run():
        ref, port = RefBroker(), Broker(device="cpu")
        bats = (RefBatcher(ref, batch_max=64), PublishBatcher(port,
                                                              batch_max=64))
        msgs = (RefMessage, Message)
        assert bats[1].high_watermark == 64 and bats[1].global_high == 128

        def both(fn):
            out = [fn(b, m) for b, m in zip(bats, msgs)]
            assert out[0] == out[1], out
            return out[1]

        def alarms():
            return both(lambda b, m: sorted(
                a.name for a in b.broker.alarms.active()))

        both(lambda b, m: [b.publish_nowait(m(topic="f", payload=b"x"),
                                            source="flood")
                           for _ in range(64)] and None)
        both(lambda b, m: b.publish_nowait(m(topic="l", payload=b"x"),
                                           source="light"))
        assert both(lambda b, m: (b.congested("flood"),
                                  b.congested("light"))) == (True, False)
        assert alarms() == ["publish_queue_congested"]
        # flood waits on its own event; light's reads never wait
        waits = [asyncio.ensure_future(b.wait_uncongested("flood"))
                 for b in bats]
        await asyncio.sleep(0.01)
        assert not any(w.done() for w in waits)
        # past the global bound (128): with four lanes the fair share
        # is 32, so the 50-deep lanes are over it; the light lane is not
        for src in ("a", "b"):
            both(lambda b, m: [b.publish_nowait(m(topic=src, payload=b"x"),
                                                source=src)
                               for _ in range(50)] and None)
        assert both(lambda b, m: b._fair_share()) == 32
        assert both(lambda b, m: [b.congested(s) for s in
                                  ("flood", "a", "b", "light")]) == [
            True, True, True, False]
        # the collector takes the lanes round-robin
        assert both(lambda b, m: [b._rr_pop()[0].topic
                                  for _ in range(6)]) == [
            "f", "l", "a", "b", "f", "a"]
        both(lambda b, m: [b._rr_pop() for _ in range(150)] and None)
        both(lambda b, m: b._maybe_release())
        assert alarms() == []
        await asyncio.wait_for(asyncio.gather(*waits), 5)
        assert both(lambda b, m: (b._total, len(b._queues))) == (9, 1)

    asyncio.run(run())


def test_rate_limited_flooder_does_not_starve_others():
    """The JAX package's `tests/test_batching.py` case against the
    port's server: a listener with ``messages_rate`` throttles a
    flooding publisher by pausing its reads while a well-behaved client
    on the same listener keeps its latency."""

    async def t():
        cfg = BrokerConfig()
        cfg.listeners = [ListenerConfig(bind="127.0.0.1", port=0,
                                        messages_rate=50)]
        srv = BrokerServer(cfg, device="cpu")
        await srv.start()
        try:
            port = srv.listeners[0].port
            sub = TestClient(port, "watcher")
            await sub.connect()
            await sub.subscribe("flood/#")
            await sub.subscribe("calm/#")
            flooder = TestClient(port, "flood")
            await flooder.connect()

            async def blast():
                # fire-and-forget QoS 0, ~10x over the budget
                for _ in range(300):
                    try:
                        await flooder.send(C.Publish(
                            topic="flood/x", payload=b"f", qos=0))
                    except ConnectionError:
                        return

            task = asyncio.get_running_loop().create_task(blast())
            await asyncio.sleep(0.3)
            calm = TestClient(port, "calm")
            await calm.connect()
            t0 = time.perf_counter()
            await calm.publish("calm/ping", b"p", qos=1)
            assert time.perf_counter() - t0 < 0.5  # not starved
            n = srv.broker.metrics["messages.received"]
            assert n < 150, n
            assert srv.broker.metrics["connection.rate_limited"] > 0
            task.cancel()
            await calm.disconnect()
            await sub.close()
            await flooder.close()
        finally:
            await srv.stop()

    asyncio.run(asyncio.wait_for(t(), 60))


def test_fairness_world_splits_windows_on_cpu():
    """`workload.fairness_world` (what the card test and chip_smoke
    run): the light message 2nd, windows of 512 and 89."""
    raw, sizes = W.fairness_world("cpu")
    pubs = [p.payload for p in C.StreamParser(version=C.MQTT_V5).feed(raw)
            if p.type == C.PUBLISH]
    assert sizes == [512, 89]
    assert len(pubs) == 601 and pubs[:3] == [b"0", b"light", b"1"]
