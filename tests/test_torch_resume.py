"""Windowed resume on the port (`emqx_tpu_torch.broker.resume`) held to
the JAX package's on the wire.  Seeded worlds (random filters, QoS,
overlapping filters, a durable ``$share`` group, no-local, RAP,
subscription identifiers, upgrade_qos, MQTT 3.1.1 and 5.0, inflight
windows smaller than the backlog) go into both packages' stores; every
client reconnects to a fresh broker on its directory and the resume
scheduler drains the backlogs.  Windowed (one `_dispatch_window` with
``preexpanded`` columns a round, decided by the decide kernel's plain
version here) and scalar (``windowed = False``, the per-session mqueue
referee) resume put the same bytes on every connection as the JAX
package does, and as each other.  Then admission control (parking,
CONNACK 0x89 when saturated), a disconnect mid-replay that keeps the
checkpoint, and a ``session.resume.commit`` fault that retries."""

import time

import numpy as np
import pytest

from emqx_tpu import failpoints as RFP
from emqx_tpu.broker.broker import Broker as RefBroker
from emqx_tpu.broker.channel import Channel as RefChannel
from emqx_tpu.broker.session import SubOpts as RefSubOpts
from emqx_tpu.codec import mqtt as RC
from emqx_tpu.config import BrokerConfig as RefConfig
from emqx_tpu.message import Message as RefMessage

from emqx_tpu_torch import failpoints as PFP
from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.broker.channel import Channel
from emqx_tpu_torch.broker.resume import ResumeBusy
from emqx_tpu_torch.broker.session import SubOpts
from emqx_tpu_torch.codec import mqtt as PC
from emqx_tpu_torch.config import BrokerConfig
from emqx_tpu_torch.ds import atomicio
from emqx_tpu_torch.ds.persist import DurableSessions
from emqx_tpu_torch.message import Message

SIDE = {
    "ref": dict(Broker=RefBroker, Channel=RefChannel, SubOpts=RefSubOpts,
                C=RC, Config=RefConfig, Message=RefMessage, fp=RFP),
    "port": dict(Broker=Broker, Channel=Channel, SubOpts=SubOpts, C=PC,
                 Config=BrokerConfig, Message=Message, fp=PFP),
}


@pytest.fixture(autouse=True)
def _clean():
    PFP.clear()
    RFP.clear()
    yield
    PFP.clear()
    RFP.clear()


def wire_channel(side, broker, version):
    S = SIDE[side]
    C = S["C"]

    class WireChannel(S["Channel"]):
        def __init__(self):
            self.writes = []

            def send(pkts):
                self.writes.append(b"".join(
                    C.serialize(p, self.version) for p in pkts))

            super().__init__(broker, send=send, close=lambda r: None)
            self.version = version

        def wire(self):
            return b"".join(bytes(x) for x in self.writes)

    return WireChannel()


def make_broker(side, data_dir, windowed=True, **resume_kw):
    S = SIDE[side]
    cfg = S["Config"]()
    if side == "ref":
        cfg.engine.use_device = False
    cfg.sys.enable = False
    cfg.durable.enable = True
    cfg.durable.data_dir = str(data_dir)
    cfg.durable.resume.windowed = windowed
    for k, v in resume_kw.items():
        setattr(cfg.durable.resume, k, v)
    if side == "ref":
        return S["Broker"](config=cfg)
    return S["Broker"](config=cfg, device="cpu")


def build_world(seed):
    rng = np.random.default_rng(seed)
    clients = []
    for i in range(10):
        subs = []
        for f in range(int(rng.integers(1, 4))):
            flt = str(rng.choice(["t/#", "t/+/x", f"t/{f}/x", "s/only",
                                  "$share/g1/t/+/x"]))
            subs.append({
                "flt": flt, "qos": int(rng.integers(0, 3)),
                "rap": bool(rng.random() < 0.4),
                "no_local": bool(rng.random() < 0.3),
                "subid": (int(rng.integers(1, 10))
                          if rng.random() < 0.2 else None),
            })
        clients.append({
            "cid": f"c{i}",
            "version": int(rng.choice([RC.MQTT_V4, RC.MQTT_V5])),
            "upgrade": bool(rng.random() < 0.3),
            "max_inflight": int(rng.choice([2, 4, 32])),
            "subs": subs,
        })
    # after every checkpoint of the test, however slow the box
    t0 = time.time() + 3600.0
    msgs = []
    for j in range(int(rng.integers(10, 40))):
        msgs.append({
            "topic": str(rng.choice(["t/1/x", "t/2/x", "t/0/x", "s/only",
                                     "t/deep/x"])),
            "qos": int(rng.integers(0, 3)),
            "retain": bool(rng.random() < 0.3),
            "payload": bytes(rng.integers(0, 256, int(rng.integers(0, 120)),
                                          dtype=np.uint8)),
            "from": str(rng.choice(["c0", "c1", "pub"])),
            "mid": bytes(rng.integers(0, 256, 16, dtype=np.uint8)),
            "timestamp": t0 + j * 0.001,
        })
    return clients, msgs


def seed_dir(side, data_dir, clients, msgs):
    """Subscribe and checkpoint every client, then persist the backlog
    while they are away."""
    S = SIDE[side]
    b = make_broker(side, data_dir)
    chans = {}
    for c in clients:
        ch = wire_channel(side, b, c["version"])
        session, _ = b.cm.open_session(False, c["cid"], ch,
                                       expiry_interval=3600.0)
        session.upgrade_qos = c["upgrade"]
        for s in c["subs"]:
            opts = S["SubOpts"](qos=s["qos"], retain_as_published=s["rap"],
                                no_local=s["no_local"], subid=s["subid"])
            session.subscribe(s["flt"], opts)
            b.subscribe(c["cid"], s["flt"], opts)
        chans[c["cid"]] = ch
    for c in clients:
        b.cm.disconnect(c["cid"], chans[c["cid"]])
        b.channel_disconnected(c["cid"])
    b.publish_many([S["Message"](
        topic=m["topic"], qos=m["qos"], retain=m["retain"],
        payload=m["payload"], from_client=m["from"], mid=m["mid"],
        timestamp=m["timestamp"]) for m in msgs])
    b.durable.sync()
    b.durable.close()


def ack_until_quiet(side, clients, chans, sessions):
    C = SIDE[side]["C"]
    parsers = {c["cid"]: C.StreamParser(version=c["version"])
               for c in clients}
    seen = {c["cid"]: 0 for c in clients}
    progress = True
    while progress:
        progress = False
        for c in clients:
            cid = c["cid"]
            ch = chans[cid]
            wire = ch.wire()
            new = wire[seen[cid]:]
            if not new:
                continue
            seen[cid] = len(wire)
            session = sessions[cid]
            for pkt in parsers[cid].feed(new):
                if pkt.type != C.PUBLISH or pkt.packet_id is None:
                    continue
                progress = True
                if pkt.qos == 1:
                    ch.send_packets(session.puback(pkt.packet_id)[1])
                elif pkt.qos == 2:
                    ch.send_packets(session.pubrec(pkt.packet_id)[1])
                    ch.send_packets(session.pubcomp(pkt.packet_id)[1])


def resume_run(side, data_dir, clients, windowed):
    b = make_broker(side, data_dir, windowed=windowed, max_concurrent=3,
                    chunk_msgs=16)
    b.resume.running = True
    b.router.shared._rng.seed(1234)
    chans, sessions = {}, {}
    for c in clients:
        ch = wire_channel(side, b, c["version"])
        session, present = b.open_session(
            False, c["cid"], ch, expiry_interval=3600.0,
            max_inflight=c["max_inflight"])
        assert present, c["cid"]
        session.upgrade_qos = c["upgrade"]
        ch.session = session
        ch.send_packets(session.resume())
        chans[c["cid"]] = ch
        sessions[c["cid"]] = session
    rounds = 0
    while any(b.resume.pending(c["cid"]) for c in clients):
        b.resume.drain_once()
        rounds += 1
        assert rounds < 10_000
    ack_until_quiet(side, clients, chans, sessions)
    wires = {c["cid"]: chans[c["cid"]].wire() for c in clients}
    sent = {k: b.metrics.all().get(k, 0)
            for k in ("messages.sent", "messages.qos0.sent",
                      "messages.qos1.sent", "messages.qos2.sent",
                      "session.resumed", "session.replay.messages")}
    inflight = {c["cid"]: sorted((pid, e.qos) for pid, e in
                                 sessions[c["cid"]].inflight.items())
                for c in clients}
    b.durable.close()
    return wires, sent, inflight


@pytest.mark.parametrize("seed", range(5))
def test_resume_wire_equals_reference_windowed_and_scalar(seed, tmp_path,
                                                          monkeypatch):
    clients, msgs = build_world(seed)
    calls = []
    from emqx_tpu_torch.engine import MatchEngine

    orig = MatchEngine.decide_window

    def counted(self, *a, **kw):
        calls.append(len(a[2]))
        return orig(self, *a, **kw)

    monkeypatch.setattr(MatchEngine, "decide_window", counted)
    out = {}
    for side in ("ref", "port"):
        for windowed in (True, False):
            d = tmp_path / f"{side}-{windowed}"
            seed_dir(side, d, clients, msgs)
            if side == "port":
                calls.clear()
            out[side, windowed] = resume_run(side, d, clients, windowed)
            if side == "port" and windowed:
                replayed = out[side, windowed][1]["session.replay.messages"]
                # every replay window went through the decide kernel
                assert sum(calls) >= replayed
    for windowed in (True, False):
        assert out["port", windowed] == out["ref", windowed], windowed
    pw, ps = out["port", True], out["port", False]
    assert pw[1]["messages.sent"] == ps[1]["messages.sent"]
    assert pw[2] == ps[2]
    # the same packets in both modes; their interleaving may differ
    # where an effective-QoS 0 delivery meets a full inflight window
    # (it waits in the scalar referee's mqueue and goes straight out
    # in a window), in the JAX package as in the port
    for c in clients:
        pkts = {}
        for mode in (True, False):
            raw = out["port", mode][0][c["cid"]]
            pkts[mode] = sorted(PC.serialize(p, c["version"])
                                for p in PC.StreamParser(
                                    version=c["version"]).feed(raw))
        assert pkts[True] == pkts[False], c["cid"]
    assert any(pw[0].values())


def seed_simple(data_dir, cids, n_msgs=6):
    ds = DurableSessions(str(data_dir))
    t0 = time.time() - 30.0
    for cid in cids:
        ds.save(cid, {"q/" + cid + "/#": {"qos": 1}}, 3600.0, now=t0)
        ds.add_filter("q/" + cid + "/#")
    ds.persist([Message(topic=f"q/{cid}/{j}", qos=1,
                        payload=f"{cid}-{j}".encode(),
                        timestamp=time.time())
                for cid in cids for j in range(n_msgs)])
    ds.sync()
    ds.close()


def test_admission_parks_then_answers_server_busy(tmp_path):
    cids = [f"a{i}" for i in range(4)]
    seed_simple(tmp_path / "ds", cids)
    b = make_broker("port", tmp_path / "ds", max_concurrent=1,
                    park_queue_cap=2, chunk_msgs=4)
    b.resume.running = True
    chans = {}
    for cid in cids[:3]:
        ch = wire_channel("port", b, PC.MQTT_V5)
        _s, present = b.open_session(False, cid, ch,
                                     expiry_interval=3600.0)
        assert present
        chans[cid] = ch
    info = b.resume.info()
    assert info["active"] == 1 and info["parked"] == 2
    with pytest.raises(ResumeBusy):
        b.open_session(False, cids[3], wire_channel("port", b, PC.MQTT_V5),
                       expiry_interval=3600.0)
    assert b.metrics.val("session.resume.busy") == 1
    assert b.cm.lookup(cids[3]) is None
    assert b.durable.has_checkpoint(cids[3])

    # the same CONNECT through a channel: CONNACK server-busy (0x89)
    ch = wire_channel("port", b, PC.MQTT_V5)
    ch.handle_in(PC.Connect(client_id=cids[3], proto_ver=PC.MQTT_V5,
                            keepalive=30, clean_start=False,
                            properties={"session_expiry_interval": 3600}))
    pkts = list(PC.StreamParser(version=PC.MQTT_V5).feed(ch.wire()))
    assert pkts[0].type == PC.CONNACK and pkts[0].reason_code == 0x89
    rounds = 0
    while any(b.resume.pending(c) for c in cids[:3]):
        b.resume.drain_once()
        assert b.resume.info()["active"] <= 1
        rounds += 1
        assert rounds < 500
    assert b.resume.committed == 3
    assert b.metrics.val("session.replay.windows") >= 3
    for cid in cids[:3]:
        assert not b.durable.has_checkpoint(cid)
        assert chans[cid].wire()
    b.durable.close()


def test_disconnect_mid_replay_keeps_the_checkpoint(tmp_path):
    seed_simple(tmp_path / "ds", ["m0"], n_msgs=40)
    b = make_broker("port", tmp_path / "ds", chunk_msgs=5)
    b.resume.running = True
    ch1 = wire_channel("port", b, PC.MQTT_V5)
    session, present = b.open_session(False, "m0", ch1,
                                      expiry_interval=3600.0,
                                      max_inflight=1000)
    assert present
    ch1.send_packets(session.resume())
    b.resume.drain_once()  # partial: the first read of 40
    assert b.resume.pending("m0")
    path = b.durable._state_path("m0")
    before = atomicio.load_json(path)
    b.cm.disconnect("m0", ch1)
    b.channel_disconnected("m0")
    assert atomicio.load_json(path) == before  # not overwritten
    assert b.durable.has_checkpoint("m0")
    info = b.resume.info()
    assert info["paused"] == 1 and info["active"] == 0
    ch2 = wire_channel("port", b, PC.MQTT_V5)
    session2, present = b.open_session(False, "m0", ch2,
                                       expiry_interval=3600.0)
    assert present and session2 is session
    ch2.send_packets(session2.resume())
    while b.resume.pending("m0"):
        b.resume.drain_once()
    got = [p.payload for p in PC.StreamParser(version=PC.MQTT_V5).feed(
        ch1.wire() + ch2.wire()) if p.type == PC.PUBLISH]
    assert {f"m0-{j}".encode() for j in range(40)} <= set(got)
    assert not b.durable.has_checkpoint("m0")
    b.durable.close()


def test_commit_fault_keeps_the_checkpoint_and_retries(tmp_path):
    seed_simple(tmp_path / "ds", ["k0"], n_msgs=4)
    b = make_broker("port", tmp_path / "ds")
    b.resume.running = True
    PFP.configure("session.resume.commit", "error", times=2)
    ch = wire_channel("port", b, PC.MQTT_V5)
    s, _ = b.open_session(False, "k0", ch, expiry_interval=3600.0)
    ch.send_packets(s.resume())
    b.resume.drain_once()  # reads everything; the commit faults
    assert b.durable.has_checkpoint("k0") and b.resume.pending("k0")
    for _ in range(200):
        for job in b.resume._active.values():
            job.not_before = 0.0  # skip the backoff sleep
        b.resume.drain_once()
        if not b.resume.pending("k0"):
            break
    assert not b.resume.pending("k0")
    assert not b.durable.has_checkpoint("k0")
    assert [p["fires"] for p in PFP.list_points()] == [2]
    assert b.resume.committed == 1
    b.durable.close()


def _fail_decide_once(b, calls):
    """Make the broker's next decide launch raise, as a failed kernel
    launch does; later launches run again."""
    orig = b.router.engine.decide_window

    def failing(*a, **kw):
        calls.append(len(a[2]))
        if len(calls) == 1:
            raise RuntimeError("decide launch failed")
        return orig(*a, **kw)

    b.router.engine.decide_window = failing


def test_failed_decide_launch_loses_nothing_and_raises(tmp_path):
    """A decide launch that fails mid-replay raises out of the round;
    the window's job goes back to its checkpoint, so once launches work
    again every message still arrives (duplicates allowed, none lost)."""
    seed_simple(tmp_path / "ds", ["d0"], n_msgs=40)
    b = make_broker("port", tmp_path / "ds", chunk_msgs=5)
    b.resume.running = True
    ch = wire_channel("port", b, PC.MQTT_V5)
    session, present = b.open_session(False, "d0", ch,
                                      expiry_interval=3600.0,
                                      max_inflight=1000)
    assert present
    ch.send_packets(session.resume())
    b.resume.drain_once()  # the first window of 5 is delivered
    calls = []
    _fail_decide_once(b, calls)
    with pytest.raises(RuntimeError, match="decide launch failed"):
        b.resume.drain_once()
    assert b.resume.pending("d0") and b.durable.has_checkpoint("d0")
    rounds = 0
    while b.resume.pending("d0"):
        b.resume.drain_once()
        rounds += 1
        assert rounds < 100
    got = [p.payload for p in PC.StreamParser(version=PC.MQTT_V5).feed(
        ch.wire()) if p.type == PC.PUBLISH]
    assert set(got) == {f"d0-{j}".encode() for j in range(40)}
    assert len(calls) > 1 and b.resume.committed == 1
    assert not b.durable.has_checkpoint("d0")
    b.durable.close()


def test_failed_decide_launch_stops_the_drive_task(tmp_path):
    """Under the drive task the failed launch is not retried away: it
    ends the task, the job keeps its checkpoint, and a reconnect owed
    a replay afterwards raises the same error."""
    import asyncio

    seed_simple(tmp_path / "ds", ["e0", "e1"], n_msgs=12)
    b = make_broker("port", tmp_path / "ds", max_concurrent=1)
    calls = []
    _fail_decide_once(b, calls)

    async def main():
        await b.resume.start()
        ch = wire_channel("port", b, PC.MQTT_V5)
        session, present = b.open_session(False, "e0", ch,
                                          expiry_interval=3600.0,
                                          max_inflight=1000)
        assert present
        ch.send_packets(session.resume())
        task = b.resume._task
        await asyncio.wait([task], timeout=5.0)
        assert task.done()
        assert isinstance(task.exception(), RuntimeError)
        assert b.resume.error is task.exception()
        with pytest.raises(RuntimeError, match="decide launch failed"):
            b.open_session(False, "e1", wire_channel("port", b, PC.MQTT_V5),
                           expiry_interval=3600.0)
        await b.resume.stop()

    asyncio.run(main())
    assert b.metrics.val("session.resume.failed") == 1
    assert b.resume.pending("e0")
    assert b.durable.has_checkpoint("e0") and b.durable.has_checkpoint("e1")
    assert b.cm.lookup("e1") is None
    b.durable.close()


@pytest.mark.parametrize("shard", [(0, 2), (1, 2), (1, 1)])
def test_resume_sharding_is_refused(tmp_path, shard):
    """The multicore pool is not ported: a resume shard other than the
    single process's (0, 1) is refused at the boot check and by the
    broker, never used to skip checkpoints."""
    from emqx_tpu_torch.config import check_config

    cfg = BrokerConfig()
    cfg.durable.resume.shard_index, cfg.durable.resume.shard_count = shard
    assert [p for p in check_config(cfg) if "shard" in p] == [
        "durable.resume.shard_index/shard_count: multicore resume "
        "sharding is not ported to emqx_tpu_torch (ROADMAP.md section 1, "
        "item 9); only (0, 1) boots"]
    assert check_config(BrokerConfig()) == []
    cfg.durable.enable = True
    cfg.durable.data_dir = str(tmp_path / "ds")
    with pytest.raises(ValueError, match="multicore resume sharding"):
        Broker(config=cfg, device="cpu")


def test_resume_info_rides_node_info(tmp_path):
    seed_simple(tmp_path / "ds", ["n0"])
    b = make_broker("port", tmp_path / "ds", max_concurrent=7)
    info = b.node_info()
    assert info["resume"] == {
        "active": 0, "parked": 0, "paused": 0, "windowed": True,
        "max_concurrent": 7, "park_queue_cap": 4096,
        "replay_byte_budget": 4 * 1024 * 1024}
    assert info["durability"]["fsync"] == "interval"
    b.durable.close()


def test_durable_world_windowed_equals_scalar_on_cpu():
    """`workload.durable_world` (chip_smoke's parity world, smaller):
    the windowed replay's bytes equal the scalar referee's, every
    session commits, and the replay went through windows."""
    from emqx_tpu_torch import workload as W

    script = W.durable_script(16, 12, 400)
    win = W.durable_world("cpu", script, windowed=True, n_filters=2000)
    sca = W.durable_world("cpu", script, windowed=False, n_filters=2000)
    assert win["bytes"] == sca["bytes"]
    assert win["committed"] == sca["committed"] == 12
    assert win["metrics"]["session.replay.windows"] > 0
    assert sca["metrics"]["session.replay.windows"] == 0
    assert win["metrics"]["messages.sent"] == sca["metrics"]["messages.sent"]
