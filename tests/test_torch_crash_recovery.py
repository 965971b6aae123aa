"""The crash-point suite on the port's durable store.  ``tools/crashsim``
(the JAX package's harness, not edited) records a seeded persistent-
session workload's write trace through the port's own seams: its
``CrashRecorder`` callbacks are set on `emqx_tpu_torch.ds.native.DsLog.
recorder` and `emqx_tpu_torch.ds.atomicio.recorder`.  For every crash
point (clean cuts, records torn at byte granularity, metadata renames
landing old, tmp-partial or replaced-torn, a sidecar lost under later
appends) the on-disk state is materialized, the port's store recovers
it, and:

  * ``always`` mode loses ZERO acked QoS >= 1 messages (acked = covered
    by a completed fsync, the group-commit contract);
  * every mode replays every record that survived (at-least-once),
    never a message that was not written, and never hides a stream;
  * a torn sidecar is counted as corruption, never reset silently;
  * the JAX package's store recovers the same states to the same
    messages (the record and sidecar formats are shared).
"""

import numpy as np
import pytest

from emqx_tpu.ds.persist import DurableSessions as RefSessions

from emqx_tpu_torch import topic as T
from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.config import BrokerConfig
from emqx_tpu_torch.ds import atomicio
from emqx_tpu_torch.ds.native import DsLog
from emqx_tpu_torch.ds.persist import DurableSessions
from emqx_tpu_torch.message import Message
from tools.crashsim import CrashRecorder, materialize, sync_covered_index

FILTERS = ("fam0/+/t", "fam1/#", "fam2/dev1/t", "+/dev2/t")


class PortRecorder(CrashRecorder):
    """The harness's recorder on the port's seams."""

    def install(self):
        DsLog.recorder = self
        atomicio.recorder = self

    def uninstall(self):
        DsLog.recorder = None
        atomicio.recorder = None


def _matches(topic, flt):
    return T.match_words(T.words(topic), T.words(flt))


def run_workload(seed, base, mode):
    """Checkpointed (detached) sessions, a QoS 1 publisher the gate
    captures, interleaved group fsyncs and metadata checkpoints,
    possibly an unsynced tail.  ``captured`` aligns with the trace's
    appends."""
    rng = np.random.default_rng(seed)
    layout = "lts" if seed % 2 else "hash"
    sessions = {
        f"sub{i}": sorted(str(f) for f in rng.choice(
            FILTERS, int(rng.integers(1, 3)), replace=False))
        for i in range(int(rng.integers(1, 4)))
    }
    t0 = 1_700_000_000.0
    captured = []
    with PortRecorder() as rec:
        ds = DurableSessions(base, layout=layout, fsync=mode)
        for cid, flts in sessions.items():
            ds.save(cid, {f: {"qos": 1} for f in flts}, expiry=1e9, now=t0)
            for f in flts:
                ds.add_filter(f)
        t = t0 + 1.0
        for _phase in range(int(rng.integers(3, 6))):
            batch = []
            for _ in range(int(rng.integers(2, 7))):
                t += 0.001
                batch.append(Message(
                    topic=f"fam{int(rng.integers(3))}/"
                          f"dev{int(rng.integers(4))}/t",
                    payload=bytes(rng.integers(0, 256,
                                               int(rng.integers(3, 41)),
                                               dtype=np.uint8)),
                    qos=1, timestamp=t, from_client="pub"))
            ds.persist(batch)
            captured.extend(m for m in batch if ds._gate.match(m.topic))
            if rng.random() < 0.7:
                ds.gate.sync_now()  # the group commit: acks release here
            if rng.random() < 0.3:
                ds.checkpoint_meta()
        if rng.random() < 0.5:
            ds.gate.sync_now()
    ds.close()  # outside the recorder: not part of the crashed trace
    assert sum(1 for op in rec.ops if op.kind == "append") == len(captured)
    return rec.ops, layout, sessions, captured


def crash_states(ops):
    for k in range(len(ops) + 1):
        yield k, None, "old"
        if k < len(ops):
            op = ops[k]
            if op.kind == "append":
                n = 28 + len(op.data)
                for tb in (1, n // 2, n - 1):
                    yield k, tb, "old"
            elif op.kind == "meta":
                yield k, 7, "tmp-partial"
                if not op.fsynced:
                    yield k, max(1, len(op.data) // 2), "replaced-torn"


def check_recovery(out, layout, mode, sessions, acked, survived,
                   expect_meta_corruption=False, cls=DurableSessions):
    """Recover ``out`` and check the contract; returns each session's
    replayed mids."""
    ds2 = cls(str(out), layout=layout, fsync=mode)
    replayed = {}
    try:
        all_mids = {m.mid for m in survived}
        for cid, flts in sessions.items():
            want_acked = {m.mid for m in acked
                          if any(_matches(m.topic, f) for f in flts)}
            want_survived = {m.mid for m in survived
                             if any(_matches(m.topic, f) for f in flts)}
            state = ds2.load(cid)
            if mode == "always":
                assert state is not None or not want_acked, cid
            if state is None:
                continue
            got = {m.mid for _flt, m in ds2.replay(state)}
            if mode == "always":
                assert want_acked <= got, (cid, want_acked - got)
            assert want_survived <= got, (cid, want_survived - got)
            assert got <= all_mids
            replayed[cid] = got
        logh = ds2.storage._log
        for shard in logh.streams():
            prev = (0, 0)
            for ts, seq, _payload in logh.scan(shard, 0):
                assert (ts, seq) > prev, shard
                prev = (ts, seq)
        for m in survived:
            key = ds2.storage.stream_key(m.topic)
            assert key in {s.shard for s in
                           ds2.storage.get_streams(m.topic)}, m.topic
        if expect_meta_corruption:
            assert ds2.corruption_counts.get("meta", 0) >= 1
    finally:
        ds2.close()
    return replayed


@pytest.mark.parametrize("seed,mode", [
    (11, "always"), (12, "always"), (13, "always"), (14, "always"),
    (15, "interval"), (16, "never"),
])
def test_crash_point_enumeration(tmp_path, seed, mode):
    base = tmp_path / "live"
    ops, layout, sessions, captured = run_workload(seed, str(base), mode)
    append_idx = [i for i, op in enumerate(ops) if op.kind == "append"]
    n_states = 0
    for k, torn, variant in crash_states(ops):
        out = tmp_path / f"crash-{n_states}"
        materialize(ops, k, src_root=str(base), out_root=str(out),
                    torn_bytes=torn, meta_variant=variant)
        survived = captured[:sum(1 for i in append_idx if i < k)]
        j = sync_covered_index(ops, k)
        acked = captured[:sum(1 for i in append_idx if i < j)]
        got = check_recovery(out, layout, mode, sessions, acked, survived,
                             expect_meta_corruption=variant ==
                             "replaced-torn")
        if mode == "always" and n_states % 3 == 0:
            # the JAX package recovers the same state to the same set
            out2 = tmp_path / f"crash-{n_states}-ref"
            materialize(ops, k, src_root=str(base), out_root=str(out2),
                        torn_bytes=torn, meta_variant=variant)
            assert check_recovery(out2, layout, mode, sessions, acked,
                                  survived, cls=RefSessions) == got
        n_states += 1
    assert n_states > len(ops)


def test_cross_file_reordering_loses_sidecar_not_data(tmp_path):
    base = tmp_path / "live"
    ops, layout, sessions, captured = run_workload(21, str(base),
                                                   "interval")
    meta_idx = [i for i, op in enumerate(ops) if op.kind == "meta"]
    n_appends = sum(1 for op in ops if op.kind == "append")
    for n, mi in enumerate(meta_idx[1:]):  # keep the LAYOUT marker
        out = tmp_path / f"reorder-{n}"
        materialize(ops, len(ops), src_root=str(base), out_root=str(out),
                    skip_meta_index=mi)
        check_recovery(out, layout, "interval", sessions, [],
                       captured[:n_appends])


def test_durable_shared_group_crash_points(tmp_path):
    base = tmp_path / "live"
    rng = np.random.default_rng(31)
    flt = "$share/g/fam1/#"
    t = 1_700_000_001.0
    captured = []
    with PortRecorder() as rec:
        ds = DurableSessions(str(base), layout="hash", fsync="always")
        ds.save("sA", {flt: {"qos": 1}}, expiry=1e9, now=t - 1.0)
        ds.add_filter("fam1/#")
        ds.shared_join(flt, "sA")
        for _ in range(10):
            t += 0.001
            m = Message(topic=f"fam1/dev{int(rng.integers(4))}/t",
                        payload=b"x" * int(rng.integers(3, 21)), qos=1,
                        timestamp=t, from_client="pub")
            ds.persist([m])
            captured.append(m)
            if rng.random() < 0.5:
                ds.gate.sync_now()
    ds.close()
    append_idx = [i for i, op in enumerate(rec.ops) if op.kind == "append"]
    for k in range(len(rec.ops) + 1):
        out = tmp_path / f"crash-{k}"
        materialize(rec.ops, k, src_root=str(base), out_root=str(out))
        survived = captured[:sum(1 for i in append_idx if i < k)]
        j = sync_covered_index(rec.ops, k)
        acked = captured[:sum(1 for i in append_idx if i < j)]
        ds2 = DurableSessions(str(out), layout="hash", fsync="always")
        try:
            state = ds2.load("sA")
            assert state is not None or not acked
            if state is None:
                continue
            got = {m.mid for _f, m in ds2.replay(state)}
            assert {m.mid for m in acked} <= got
            assert {m.mid for m in survived} <= got
        finally:
            ds2.close()


def _broker_on(out, layout, mode="always"):
    cfg = BrokerConfig()
    cfg.sys.enable = False
    cfg.durable.enable = True
    cfg.durable.data_dir = str(out)
    cfg.durable.layout = layout
    cfg.durable.fsync = mode
    return Broker(config=cfg, device="cpu")


def test_broker_boots_on_a_materialized_crash(tmp_path):
    base = tmp_path / "live"
    ops, layout, sessions, captured = run_workload(11, str(base), "always")
    append_idx = [i for i, op in enumerate(ops) if op.kind == "append"]
    k = max((i for i, op in enumerate(ops) if op.kind == "sync"),
            default=len(ops))
    out = tmp_path / "crashed"
    materialize(ops, k + 1, src_root=str(base), out_root=str(out))
    b = _broker_on(out, layout)
    try:
        acked = captured[:sum(1 for i in append_idx if i < k)]
        for cid, flts in sessions.items():
            assert b.durable.has_checkpoint(cid)
            state = b.durable.load(cid)
            got = {m.mid for _f, m in b.durable.replay(state)}
            assert {m.mid for m in acked
                    if any(_matches(m.topic, f) for f in flts)} <= got
    finally:
        b.shutdown()


def test_broker_alarms_on_a_torn_sidecar(tmp_path):
    base = tmp_path / "live"
    ops, layout, _s, _c = run_workload(12, str(base), "interval")
    k = [i for i, op in enumerate(ops) if op.kind == "meta"][-1]
    out = tmp_path / "crashed"
    materialize(ops, k, src_root=str(base), out_root=str(out),
                torn_bytes=max(1, len(ops[k].data) // 2),
                meta_variant="replaced-torn")
    b = _broker_on(out, layout, "interval")
    try:
        assert "ds_meta_corruption" in {a.name for a in b.alarms.active()}
        assert b.metrics.val("ds.meta.corruption") >= 1
    finally:
        b.shutdown()
