"""Group commit in the port (`emqx_tpu_torch.ds.durability`,
``durable.fsync``) held to the JAX package's: the `SyncGate` and
`GateGroup` watermarks, coalescing and fault retries give the same
counters on the same fault schedule; the atomic metadata writes and the
``ds.store.*``/``ds.meta.write`` seams; configuration from a file and
from the environment; and the broker's "acked means durable" contract
over TCP on ``device="cpu"`` — a PUBACK parks until the covering fsync,
a sync fault keeps it parked and retries (the error is counted, never
dropped), ``interval`` mode acks at once — with the durability surface
on ``/api/v5/nodes`` and the Prometheus scrape."""

import asyncio
import json
import os
import time

import numpy as np
import pytest

from emqx_tpu import failpoints as RFP
from emqx_tpu.ds import durability as rdur

from emqx_tpu_torch import failpoints as PFP
from emqx_tpu_torch.config import (
    BrokerConfig, ConfigHandler, ListenerConfig, apply_env_overrides,
    check_config,
)
from emqx_tpu_torch.ds import atomicio
from emqx_tpu_torch.ds import durability as pdur
from emqx_tpu_torch.ds.persist import DurableSessions
from emqx_tpu_torch.message import Message

from mqtt_client import TestClient

DUR = {"ref": rdur, "port": pdur}
LIMIT = 20


@pytest.fixture(autouse=True)
def _clean():
    PFP.clear()
    RFP.clear()
    yield
    PFP.clear()
    RFP.clear()


def _gate_run(mod, schedule, windows, group):
    """Windows park on a gate (or a 3-gate group) whose sync fails on
    the ``schedule``'s True entries; returns the counters."""
    calls = []

    def make_sync(i):
        def sync():
            k = len(calls)
            calls.append(i)
            if k < len(schedule) and schedule[k]:
                raise OSError("disk fault")
        return sync

    if group:
        gates = [mod.SyncGate(make_sync(i)) for i in range(3)]
        gate = mod.GateGroup(gates)
    else:
        gates = [mod.SyncGate(make_sync(0))]
        gate = gates[0]
    errors = []
    gate.on_error = errors.append

    async def main():
        async def window(i):
            gates[i % len(gates)].mark_appended(1 + i % 2)
            await gate.wait_durable()

        await asyncio.wait_for(
            asyncio.gather(*(window(i) for i in range(windows))), LIMIT)

    asyncio.run(main())
    return (gate.stats(), len(errors), gate.appended, gate.dirty,
            gate.parked)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("group", [False, True])
def test_gate_counters_equal_reference(seed, group):
    rng = np.random.default_rng(seed)
    schedule = [bool(x) for x in rng.random(3) < 0.5]
    windows = int(rng.integers(1, 9))
    ref = _gate_run(rdur, schedule, windows, group)
    port = _gate_run(pdur, schedule, windows, group)
    # windows that arrive while a flush runs ride the next one, so the
    # flush count is timing-bound; the rest is exact
    assert port[1:] == ref[1:]
    assert port[0]["sync_errors"] == ref[0]["sync_errors"]
    assert port[0]["unsynced"] == port[0]["parked"] == 0
    assert not port[3]


def test_gate_sync_now_and_stop():
    flushed = []
    gate = pdur.SyncGate(lambda: flushed.append(1))
    gate.sync_now()
    assert flushed == []
    gate.mark_appended(3)
    assert gate.dirty and gate.unsynced == 3
    gate.sync_now()
    assert flushed == [1] and not gate.dirty and gate.sync_count == 1

    stuck = pdur.SyncGate(lambda: time.sleep(10))

    async def main():
        stuck.mark_appended(1)
        loop = asyncio.get_running_loop()
        with stuck._lock:
            fut = loop.create_future()
            stuck._waiters.append((stuck._appended, fut))
        stuck.stop()
        assert fut.cancelled()

    asyncio.run(main())


def test_gate_error_reaches_the_caller_of_sync_now():
    """The blocking flush raises its fault on the caller's thread and
    counts it; nothing is marked synced."""
    gate = pdur.SyncGate(lambda: (_ for _ in ()).throw(OSError("eio")))
    gate.mark_appended(1)
    with pytest.raises(OSError, match="eio"):
        gate.sync_now()
    assert gate.sync_errors == 1 and gate.dirty


def test_atomic_write_and_corruption_are_distinct(tmp_path):
    p = str(tmp_path / "m.json")
    atomicio.atomic_write_json(p, {"a": [1, 2]})
    assert atomicio.load_json(p) == {"a": [1, 2]}
    with open(p, "r+") as f:
        raw = f.read()
        f.seek(0)
        f.write(raw.replace("[1,2]", "[7,2]"))
    with pytest.raises(atomicio.MetaCorruption):
        atomicio.load_json(p)
    assert atomicio.try_load_json(str(tmp_path / "none"), {}) == (
        {}, "missing")
    from emqx_tpu.ds import atomicio as ratomic

    doc = atomicio.dumps_checked({"x": 1, "y": [True, None]})
    assert doc == ratomic.dumps_checked({"x": 1, "y": [True, None]})
    frames = atomicio.pack_frame({"t": "wm", "ts": 5}) * 2
    assert atomicio.iter_frames(frames) == ratomic.iter_frames(frames)


@pytest.mark.parametrize("action", ["error", "drop", "duplicate"])
def test_store_seams(action, tmp_path):
    """``ds.store.append``: an error fails the persist loudly, a drop
    loses the record (the lying disk), a duplicate is deduplicated by
    replay; ``ds.meta.write`` errors keep the old checkpoint."""
    ds = DurableSessions(str(tmp_path / "d"), layout="hash")
    ds.save("c", {"a/#": {"qos": 1}}, 3600.0, now=time.time() - 5)
    ds.add_filter("a/#")
    PFP.configure("ds.store.append", action, times=1)
    m = Message(topic="a/1", payload=b"x", qos=1, timestamp=time.time())
    if action == "error":
        with pytest.raises(PFP.FailpointError):
            ds.persist([m])
    else:
        ds.persist([m])
    PFP.clear()
    ds.persist([Message(topic="a/2", payload=b"y", qos=1,
                        timestamp=time.time())])
    PFP.configure("ds.meta.write", "error")
    with pytest.raises(PFP.FailpointError):
        ds.save("c", {"b/#": {"qos": 1}}, 3600.0)
    PFP.clear()
    ds.close()
    again = DurableSessions(str(tmp_path / "d"))
    state = again._boot_states["c"]
    assert list(state.subs) == ["a/#"]  # the old checkpoint stands
    got = [msg.topic for _f, msg in again.replay(state)]
    assert got == {"error": ["a/2"], "drop": ["a/2"],
                   "duplicate": ["a/1", "a/2"]}[action]
    again.close()


def test_durable_config_from_file_and_environment(tmp_path):
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"durable": {
        "enable": True, "layout": "hash", "n_shards": 4, "fsync": "always",
        "resume": {"max_concurrent": 8, "windowed": False}}}))
    cfg = ConfigHandler.load(str(path)).root
    assert (cfg.durable.enable, cfg.durable.layout, cfg.durable.n_shards,
            cfg.durable.fsync) == (True, "hash", 4, "always")
    assert cfg.durable.resume.max_concurrent == 8
    assert cfg.durable.resume.windowed is False
    applied = apply_env_overrides(cfg, environ={
        "EMQX_TPU_DURABLE__FSYNC": "interval",
        "EMQX_TPU_DURABLE__RESUME__CHUNK_MSGS": "64",
        "EMQX_TPU_DURABLE__DATA_DIR": str(tmp_path / "ds")})
    assert cfg.durable.fsync == "interval"
    assert cfg.durable.resume.chunk_msgs == 64
    assert ("durable.resume.chunk_msgs", 64) in applied
    assert BrokerConfig().durable.enable is False  # off by default
    cfg.durable.fsync = "sometimes"
    cfg.durable.resume.max_concurrent = 0
    probs = check_config(cfg)
    assert any("durable.fsync" in p for p in probs)
    assert any("max_concurrent" in p for p in probs)


def _srv_cfg(tmp_path, mode):
    cfg = BrokerConfig()
    cfg.listeners = [ListenerConfig(port=0, bind="127.0.0.1")]
    cfg.durable.enable = True
    cfg.durable.data_dir = str(tmp_path / "ds")
    cfg.durable.fsync = mode
    cfg.sys.enable = False
    return cfg


async def _clients(port):
    sub = TestClient(port, "psub")
    await sub.connect(clean_start=True,
                      properties={"session_expiry_interval": 3600})
    await sub.subscribe("dur/+/q", qos=1)
    pub = TestClient(port, "pub")
    await pub.connect()
    return sub, pub


def _server_run(tmp_path, mode, body):
    from emqx_tpu_torch.broker.listener import BrokerServer

    async def main():
        srv = BrokerServer(_srv_cfg(tmp_path, mode), device="cpu")
        await srv.start()
        sub = pub = None
        try:
            sub, pub = await _clients(srv.listeners[0].port)
            return await asyncio.wait_for(body(srv, sub, pub), LIMIT)
        finally:
            for c in (sub, pub):
                if c is not None:
                    await c.close()
            await srv.stop()

    return asyncio.run(main())


def test_always_mode_parks_acks_until_the_flush(tmp_path):
    async def body(srv, sub, pub):
        broker = srv.broker
        base = broker.durable.gate.sync_count
        acks = await asyncio.gather(*(
            pub.publish(f"dur/{i}/q", b"x", qos=1, timeout=10)
            for i in range(16)))
        assert all(a is not None for a in acks)
        synced = broker.durable.gate.sync_count - base
        assert 1 <= synced < 16  # the 16 acks did not cost 16 fsyncs
        assert not broker.durable.gate.dirty  # acked => flushed
        assert broker.metrics.val("ds.sync.count") >= 1
        assert broker.durable.storage.stats()["messages"] == 16
        for _ in range(16):
            await sub.recv_publish(timeout=5)
        return True

    assert _server_run(tmp_path, "always", body)


def test_sync_fault_parks_the_puback_and_retries(tmp_path):
    async def body(srv, sub, pub):
        broker = srv.broker
        PFP.configure("ds.store.sync", "error", times=3)
        t0 = time.monotonic()
        ack = await pub.publish("dur/0/q", b"x", qos=1, timeout=10)
        elapsed = time.monotonic() - t0
        assert ack is not None
        assert elapsed > 0.3, elapsed  # three backed-off failed rounds
        assert broker.durable.gate.sync_errors >= 3
        assert broker.metrics.val("ds.sync.errors") >= 3
        assert not broker.durable.gate.dirty
        await sub.recv_publish(timeout=5)
        return True

    assert _server_run(tmp_path, "always", body)


def test_interval_mode_acks_before_the_flush(tmp_path):
    async def body(srv, sub, pub):
        broker = srv.broker
        PFP.configure("ds.store.sync", "error")
        ack = await pub.publish("dur/0/q", b"x", qos=1, timeout=5)
        assert ack is not None
        assert broker.durable.gate.dirty  # the flush is owed, the ack free
        PFP.clear()
        broker.durable.sync_soon()
        for _ in range(100):
            if not broker.durable.gate.dirty:
                break
            await asyncio.sleep(0.01)
        assert not broker.durable.gate.dirty
        return True

    assert _server_run(tmp_path, "interval", body)


def test_durability_surface_on_nodes_and_scrape(tmp_path):
    from emqx_tpu_torch.mgmt import MgmtApi

    async def body(srv, sub, pub):
        await pub.publish("dur/1/q", b"x", qos=1, timeout=5)
        node = srv.broker.node_info()
        assert node["durability"]["fsync"] == "always"
        assert {"unsynced", "corrupt_records", "sync_count"} <= set(
            node["durability"])
        assert node["resume"]["max_concurrent"] == 64
        api = MgmtApi(srv, bind="127.0.0.1", port=0)
        req = type("R", (), {"query": {}, "headers": {}})()
        resp = await api.prometheus(req)
        text = resp.body.decode() if isinstance(resp.body, bytes) else str(
            resp.body)
        for fam in ("emqx_ds_unsynced", "emqx_ds_sync_count",
                    "emqx_ds_parked"):
            assert fam in text, fam
        return True

    assert _server_run(tmp_path, "always", body)
