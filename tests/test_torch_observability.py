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


# ------------------------------------------ the scrape and profiler REST
# tests/test_observability.py:368, :436, :474 and :519 against the port's
# management API, beside the JAX package's on the same world


def _fanout_world(srv, cid, flt, topic, n_windows=3):
    """An in-process subscriber on ``flt`` and ``n_windows`` windows of
    4 QoS 0 messages on ``topic``, through either package's broker."""
    b = srv.broker
    if hasattr(b, "cm") and type(b).__module__.startswith("emqx_tpu_torch"):
        _subscriber(b, cid, flt, 0)
        msg = Message
    else:
        from emqx_tpu.broker.channel import Channel as RCh
        from emqx_tpu.broker.session import SubOpts
        from emqx_tpu.message import Message as RMsg

        ch = RCh(b, send=lambda pkts: None, close=lambda r: None)
        session, _ = b.cm.open_session(True, cid, ch)
        session.subscribe(flt, SubOpts(qos=0))
        b.subscribe(cid, flt, SubOpts(qos=0))
        msg = RMsg
    for _ in range(n_windows):
        b.publish_many([msg(topic=topic, payload=b"x")] * 4)


def test_prometheus_full_scrape_round_trips_like_reference():
    """One world through both brokers: both scrapes parse strictly (one
    TYPE a family, +Inf bucket == _count, cumulative buckets), carry the
    same families apart from the match engine's own (ROADMAP.md section
    3), the sanitised extra counter, and >= 4 sampled histograms; the
    port's engine families are its `MatchEngine.stats()` keys."""
    from test_torch_mgmt import (LIMIT, acall, families_apart_from_engine,
                                 parse_prometheus, start_pair, stop_all)

    async def t():
        ref, prt = await start_pair()
        try:
            texts = []
            for srv in (ref, prt):
                _fanout_world(srv, "pm", "p/#", "p/t")
                srv.broker.metrics.inc("5xx.responses-total")
                st, ct, text, _ = await acall(srv.api.port, "GET",
                                              "/metrics")
                assert (st, ct) == (200, "text/plain; charset=utf-8")
                texts.append(text)
            return texts, sorted(prt.broker.router.engine.stats())
        finally:
            await stop_all(ref, prt)

    (rtext, ptext), eng_keys = asyncio.run(asyncio.wait_for(t(), LIMIT))
    rtypes, _ = parse_prometheus(rtext)
    ptypes, psamples = parse_prometheus(ptext)
    assert families_apart_from_engine(ptypes) == \
        families_apart_from_engine(rtypes)
    assert ptypes["emqx_messages_received"] == "counter"
    assert ptypes["emqx_connections_count"] == "gauge"
    assert "emqx_5xx_responses_total" in ptypes  # sanitised
    assert {n for n, k in ptypes.items()
            if n.startswith("emqx_engine_") and k == "gauge"} == \
        {f"emqx_engine_{k}" for k in eng_keys}
    hist = [n for n, k in ptypes.items() if k == "histogram"]
    assert len(hist) >= 4
    counts = {n: int(v) for n, _, v in psamples if n.endswith("_count")}
    assert sum(counts[f + "_count"] for f in hist) > 0


def test_prometheus_one_type_and_help_line_per_family():
    from test_torch_mgmt import LIMIT, acall, port_server

    async def t():
        srv = port_server()
        await srv.start()
        try:
            return (await acall(srv.api.port, "GET", "/metrics"))[2]
        finally:
            await srv.stop()

    text = asyncio.run(asyncio.wait_for(t(), LIMIT))
    for kind in ("TYPE", "HELP"):
        names = [line.split(" ", 3)[2] for line in text.splitlines()
                 if line.startswith(f"# {kind} ")]
        assert names and len(names) == len(set(names)), kind


def test_profiler_rest_endpoints_like_reference():
    """A publish through the batcher, then the profiler's REST surface:
    the same statuses and shapes in both packages (the ``engine`` field
    is each package's own), the window's stages, the Chrome trace, the
    bad query's 400 and the reset."""
    from test_torch_mgmt import Both, LIMIT, start_pair, stop_all

    async def t():
        ref, prt = await start_pair()
        B = Both(ref, prt, [])
        try:
            B.auth = await B.login()
            await B.req("POST", "/api/v5/publish",
                        {"topic": "nope/t", "payload": "x"}, expect=200)
            rb, pb = await B.req("GET", "/api/v5/profiler", expect=200,
                                 keys_only=True)
            assert pb["enabled"] is True and pb["windows"]
            win = pb["windows"][0]
            assert win["source"] == "batcher" == rb["windows"][0]["source"]
            assert "batch_wait" in win["stages_us"]
            assert "prepare" in win["stages_us"]
            rb, pb = await B.req("GET", "/api/v5/profiler/trace",
                                 expect=200, keys_only=True)
            assert any(e["ph"] == "B" for e in pb["traceEvents"])
            await B.req("GET", "/api/v5/profiler/trace?windows=bogus",
                        expect=400)
            await B.req("DELETE", "/api/v5/profiler", expect=204)
            rb, pb = await B.req("GET", "/api/v5/profiler", expect=200,
                                 keys_only=True)
            assert pb["windows"] == [] == rb["windows"]
        finally:
            await stop_all(ref, prt)

    asyncio.run(asyncio.wait_for(t(), LIMIT))


def test_ctl_profiler_commands(tmp_path):
    """``python -m emqx_tpu_torch.ctl profiler`` (summary, trace, reset)
    against the port's live server, off the loop."""
    import json as _json
    import os
    import subprocess
    import sys as _sys

    from test_torch_mgmt import LIMIT, port_server

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    async def t():
        srv = port_server()
        await srv.start()
        try:
            _fanout_world(srv, "cc", "c/#", "c/t")
            api = f"http://127.0.0.1:{srv.api.port}"

            def ctl(*args):
                out = subprocess.run(
                    [_sys.executable, "-m", "emqx_tpu_torch.ctl", "--api",
                     api, *args], capture_output=True, text=True,
                    timeout=20, cwd=repo)
                assert out.returncode == 0, out.stderr
                return out.stdout

            loop = asyncio.get_running_loop()
            summary = await loop.run_in_executor(None, ctl, "profiler")
            assert "profiler on" in summary
            assert "deliver" in summary and "engine:" in summary
            path = str(tmp_path / "trace.json")
            traced = await loop.run_in_executor(None, ctl, "profiler",
                                                "trace", path)
            assert "perfetto" in traced
            with open(path) as f:
                assert _json.load(f)["traceEvents"]
            reset = await loop.run_in_executor(None, ctl, "profiler",
                                               "reset")
            assert "reset" in reset
        finally:
            await srv.stop()

    asyncio.run(asyncio.wait_for(t(), LIMIT))
