"""The port's window profiler against the JAX package's
`observability` module: the same recorded values give the same bucket
indices, percentiles, snapshots, summaries and exposition lines.  A
window through the port's broker carries every stage the port runs.
Equality is exact throughout."""

import asyncio

import numpy as np
import pytest

from emqx_tpu import observability as R

from emqx_tpu_torch import observability as P
from emqx_tpu_torch.broker.broker import Broker, PublishBatcher
from emqx_tpu_torch.broker.channel import Channel
from emqx_tpu_torch.codec import mqtt as C
from emqx_tpu_torch.config import BrokerConfig
from emqx_tpu_torch.message import Message

# the stages a port broker window runs (PublishBatcher windows also
# run batch_wait); the JAX package's other stages (replay_read,
# ds_sync) have no counterpart in the port yet
BROKER_LAPS = ["prepare", "match_submit", "match_wait", "dispatch_wait",
               "expand", "decide", "deliver", "flush", "rules"]


def _values(seed):
    rng = np.random.default_rng(seed)
    # microseconds across every bucket, with zeros, fractions and the
    # open-ended last bucket
    v = np.concatenate([
        rng.exponential(300.0, 400), rng.uniform(0, 3, 50),
        2.0 ** rng.integers(0, 40, 60), [0.0, 1.0, 2**31, 2**35 + 0.5],
    ])
    return v.tolist()


@pytest.mark.parametrize("seed", range(3))
def test_histogram_equals_reference(seed):
    vals = _values(seed)
    assert [P.Histogram.bucket_index(v) for v in vals] == [
        R.Histogram.bucket_index(v) for v in vals]
    assert P.BOUNDS == R.BOUNDS and P.N_BUCKETS == R.N_BUCKETS
    ph, rh = P.Histogram(), R.Histogram()
    ph.record_many(vals[:200])
    rh.record_many(vals[:200])
    for v in vals[200:]:
        ph.record(v)
        rh.record(v)
    ps, rs = ph.snapshot(), rh.snapshot()
    assert ps.counts == rs.counts and ps.sum == rs.sum
    assert ps.count == rs.count == len(vals)
    for q in (0, 1, 25, 50, 90, 95, 99, 99.9, 100, -5, 150):
        assert ps.percentile(q) == rs.percentile(q), q
    assert ps.to_dict() == rs.to_dict()
    assert ps.raw_dict() == rs.raw_dict()
    merged_p = ps.merge(P.HistogramSnapshot.from_dict(ps.raw_dict()))
    merged_r = rs.merge(R.HistogramSnapshot.from_dict(rs.raw_dict()))
    assert merged_p.to_dict() == merged_r.to_dict()
    assert P.prom_histogram_lines("x_us", ps, "h") == \
        R.prom_histogram_lines("x_us", rs, "h")
    assert P.prom_name("5xx.responses-a") == R.prom_name("5xx.responses-a")
    assert P.HistogramSnapshot((), 0.0, 0).percentile(50) == 0.0


def test_profiler_summary_equals_reference_on_the_same_windows():
    vals = _values(7)
    port, ref = P.Profiler(ring_size=4), R.Profiler(ring_size=4)
    assert P.Profiler.STAGES == R.Profiler.STAGES
    for k in range(6):
        pr, rr = port.begin(10 + k), ref.begin(10 + k)
        for j, name in enumerate(BROKER_LAPS):
            d = vals[(8 * k + j) % len(vals)] / 1e6
            # identical spans: the laps' clock reads are replaced by
            # the same durations on both sides
            pr.spans.append((name, 0.0, d))
            rr.spans.append((name, 0.0, d))
        pr.sub("assemble", 5e-6 * k)
        rr.sub("assemble", 5e-6 * k)
        pr.e2e_ms.extend([0.5, 1.5 * k])
        rr.e2e_ms.extend([0.5, 1.5 * k])
        port.commit(pr)
        ref.commit(rr)
        port.stage("tokenize", 1e-5 * (k + 1))
        ref.stage("tokenize", 1e-5 * (k + 1))
    port.event("rebuild", 0.25, n_filters=3)
    ref.event("rebuild", 0.25, n_filters=3)
    assert port.summary() == ref.summary()
    assert port.summary()["deliver"]["count"] == 6
    assert port.summary()["engine_rebuild"]["count"] == 1
    assert [w["seq"] for w in port.windows()] == [6, 5, 4, 3]  # the ring
    assert [w["stages_us"] for w in port.windows()] == [
        w["stages_us"] for w in ref.windows()]
    assert [e["kind"] for e in port.events()] == ["rebuild"]
    trace = port.chrome_trace()
    names = [e["name"] for e in trace["traceEvents"] if e["ph"] == "B"]
    assert names == BROKER_LAPS * 4
    port.reset()
    assert port.summary()["deliver"]["count"] == 0
    off = P.Profiler(enabled=False)
    assert off.begin(3) is None
    off.stage("tokenize", 1.0)
    assert off.summary()["tokenize"]["count"] == 0


def _subscriber(broker, cid, flt, qos):
    sent = []
    ch = Channel(broker, send=sent.extend, close=lambda reason: None)
    for pkt in (C.Connect(client_id=cid, proto_ver=C.MQTT_V5),
                C.Subscribe(packet_id=1, subscriptions=[
                    C.Subscription(topic_filter=flt, qos=qos)])):
        for q in C.StreamParser().feed(C.serialize(pkt, C.MQTT_V5)):
            ch.handle_in(q)
    return sent


@pytest.mark.parametrize("native", [True, False])
def test_broker_window_record_has_every_stage(native):
    broker = Broker(device="cpu", native=native)
    broker.rules.add_rule("r", 'SELECT * FROM "p/#" WHERE payload.v > 1')
    _subscriber(broker, "s0", "p/+", 1)
    _subscriber(broker, "s1", "p/#", 0)
    broker.router.engine.rebuild()
    prof = broker.profiler
    assert broker.router.engine.profiler is prof
    counts = broker.publish_many([
        Message(topic="p/a", payload=b'{"v": 2}', qos=1),
        Message(topic="p/b", payload=b'{"v": 0}', qos=0),
    ])
    assert counts == [2, 2]
    (win,) = prof.windows()
    # the nested sub-stages follow the spans: the native splice's share
    # of deliver, then the rules lap's column walk and matrix
    assert list(win["stages_us"]) == BROKER_LAPS + (
        ["assemble"] if native else []) + ["rules_extract", "rules_eval"]
    assert win["path"] == "dev" and win["n_deliveries"] == 4
    assert win["n_clients"] == 2 and len(win["e2e_ms"]) == 2
    summ = prof.summary()
    for name in BROKER_LAPS + ["tokenize", "e2e", "rules_extract",
                               "rules_eval"]:
        assert summ[name]["count"] >= 1, name
    for name in ("batch_wait", "replay_read", "ds_sync"):
        assert summ[name]["count"] == 0, name  # not faked
    assert summ["engine_rebuild"]["count"] == 1
    (up,) = [e for e in prof.events() if e["kind"] == "upload"]
    aut = broker.router.engine._aut
    assert up["bytes"] == aut.fp_rows.nbytes + aut.node_rows.nbytes
    # a disabled profiler records nothing and costs the engine nothing
    cfg = BrokerConfig()
    cfg.profiler.enable = False
    quiet = Broker(config=cfg, device="cpu", native=native)
    quiet.publish_many([Message(topic="p/a", payload=b"x")])
    assert quiet.profiler.windows() == []


def test_batcher_window_records_batch_wait():
    async def run():
        broker = Broker(device="cpu")
        sent = _subscriber(broker, "s", "b/#", 0)
        batcher = broker.batcher = PublishBatcher(broker, window=0.001)
        await batcher.start()
        try:
            futs = [batcher.publish(Message(topic=f"b/{i}", payload=b"x"))
                    for i in range(5)]
            assert await asyncio.wait_for(asyncio.gather(*futs), 10) == \
                [1] * 5
        finally:
            await batcher.stop()
        return broker, sent

    broker, sent = asyncio.run(run())
    assert sum(1 for p in sent if p.type == C.PUBLISH or p.type == 0) >= 1
    wins = broker.profiler.windows()
    assert wins and all(w["source"] == "batcher" for w in wins)
    assert sum(w["n_msgs"] for w in wins) == 5
    assert all(list(w["stages_us"])[:2] == ["batch_wait", "prepare"]
               for w in wins)
    assert broker.profiler.summary()["batch_wait"]["count"] == len(wins)


@pytest.mark.parametrize("native", [True, False])
def test_sharded_engine_reports_tokenize_rebuild_and_upload(native):
    from emqx_tpu_torch.parallel import sharded as sh

    eng = sh.ShardedMatchEngine(
        sh.make_mesh(8, sub=4, devices=["cpu"] * 8), max_levels=4,
        native=native)
    assert eng.profiler is None
    eng.insert_many([(f"s/{i}/+", i) for i in range(40)])
    eng.match_batch(["s/1/x"])  # no profiler: nothing recorded, no error
    prof = eng.profiler = P.Profiler()
    eng.rebuild()
    assert eng.match_batch(["s/3/x", "s/3/x", "t"]) == [{3}, {3}, set()]
    summ = prof.summary()
    assert summ["tokenize"]["count"] == 1
    assert summ["engine_rebuild"]["count"] == 1
    (up,) = [e for e in prof.events() if e["kind"] == "upload"]
    assert up["bytes"] == sum(t.nbytes for t in eng.index.tables)
