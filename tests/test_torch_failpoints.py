"""The port's failpoints (`emqx_tpu_torch.failpoints`) held to the JAX
package's: spec parsing, the seeded per-point RNG, ``after``/``times``/
``match`` hit windows and every action give the same fire sequence in
both packages for the same seed; ``load_env``; the seams a ported
module carries (``resource.buffer.query``, ``resource.batch.flush``,
``exhook.call``) take the real recovery path, and an unarmed registry
is a no-op."""

import asyncio

import numpy as np
import pytest

from emqx_tpu import failpoints as RFP
from emqx_tpu import resources as ref_res

from emqx_tpu_torch import failpoints as PFP
from emqx_tpu_torch import resources as port_res

FP = {"ref": RFP, "port": PFP}


@pytest.fixture(autouse=True)
def _clean():
    for m in FP.values():
        m.clear()
    yield
    for m in FP.values():
        m.clear()


def test_constants_equal_reference():
    assert PFP.ACTIONS == RFP.ACTIONS
    assert PFP.SEAMS == RFP.SEAMS
    assert issubclass(PFP.FailpointError, ConnectionError)
    assert not issubclass(PFP.FailpointPanic, Exception)
    assert PFP.FailpointError("x").code() == "FAILPOINT"


@pytest.mark.parametrize("spec", [
    "",
    "engine.device_step=error",
    "a=drop,prob=0.3,seed=7; b=delay,delay=0.01,after=2,times=3",
    "x=duplicate,match=n0;;y=panic",
    " z = error , times = 1 ",
    "bad",
    "a=",
    "a=error,what=1",
    "a=error,prob=x",
])
def test_parse_spec_equals_reference(spec):
    out = {}
    for side, m in FP.items():
        try:
            out[side] = m.parse_spec(spec)
        except ValueError as exc:
            out[side] = ("ValueError", str(exc))
    assert out["port"] == out["ref"]


def _outcome(mod, name, key):
    try:
        return mod.evaluate(name, key=key)
    except mod.FailpointPanic:
        return "PANIC"
    except mod.FailpointError as exc:
        return ("ERROR", str(exc))


@pytest.mark.parametrize("seed", range(8))
def test_fire_sequences_equal_reference(seed):
    """Random points (action, prob, after, times, match, seed), the
    same hits with the same keys: the same fires, counters and infos."""
    rng = np.random.default_rng(seed)
    points = []
    for i in range(int(rng.integers(1, 5))):
        action = str(rng.choice(["error", "drop", "duplicate", "panic",
                                 "delay"]))
        kw = {"prob": float(rng.choice([1.0, 0.5, 0.25])),
              "after": int(rng.integers(0, 4)),
              "seed": int(rng.integers(0, 1000))}
        if action == "delay":
            kw["delay"] = 0.0
        if rng.random() < 0.5:
            kw["times"] = int(rng.integers(0, 5))
        if rng.random() < 0.3:
            kw["match"] = str(rng.choice(["n0", "k1"]))
        points.append((f"p{i}", action, kw))
    hits = [(f"p{int(rng.integers(0, len(points)))}",
             str(rng.choice(["n0/a", "k1", "zz", None])))
            for _ in range(120)]
    seqs, infos = {}, {}
    for side, m in FP.items():
        for name, action, kw in points:
            m.configure(name, action, **kw)
        assert m.enabled
        seqs[side] = [_outcome(m, name, key) for name, key in hits]
        infos[side] = m.list_points()
    assert seqs["port"] == seqs["ref"]
    assert infos["port"] == infos["ref"]


def test_async_evaluate_and_clear_equal_reference():
    async def run(m):
        m.configure("a", "drop", times=2)
        m.configure("b", "delay", delay=0.0)
        out = [await m.evaluate_async("a") for _ in range(3)]
        out.append(await m.evaluate_async("b"))
        out.append(m.clear("a"))
        out.append(m.clear("a"))
        out.append(m.enabled)
        out.append(m.clear())
        out.append(m.enabled)
        out.append(await m.evaluate_async("b"))
        return out

    got = {side: asyncio.run(run(m)) for side, m in FP.items()}
    assert got["port"] == got["ref"] == [
        "drop", "drop", None, None, True, False, True, True, False, None]


def test_load_env_equal_reference(monkeypatch):
    spec = "resource.buffer.query=error,times=2;exhook.call=drop,prob=0.5"
    assert PFP.load_env(spec) == RFP.load_env(spec) == 2
    assert PFP.list_points() == RFP.list_points()
    PFP.clear()
    RFP.clear()
    monkeypatch.delenv("EMQX_FAILPOINTS", raising=False)
    assert PFP.load_env() == 0 and not PFP.enabled
    monkeypatch.setenv("EMQX_FAILPOINTS", "ds.store.sync=drop")
    assert PFP.load_env() == 1
    assert [p["name"] for p in PFP.list_points()] == ["ds.store.sync"]
    # the two packages keep their own registries
    assert RFP.list_points() == [] and not RFP.enabled


def test_unarmed_registry_is_a_noop():
    assert not PFP.enabled
    fires = list(PFP.RECENT_FIRES)
    for seam in PFP.SEAMS:
        assert PFP.evaluate(seam, key="k") is None
    assert PFP.list_points() == []
    assert list(PFP.RECENT_FIRES) == fires  # nothing counted, nothing fired


class Flaky:
    """A duck-typed resource: records the batches it was given."""

    def __init__(self, max_batch=1):
        self.max_batch = max_batch
        self.got = []

    async def on_start(self):
        pass

    async def on_stop(self):
        pass

    async def on_query(self, q):
        self.got.append([q])

    async def on_query_batch(self, qs):
        self.got.append(list(qs))
        return len(qs)

    async def health_check(self):
        return True


def _worker_run(side, max_batch, points):
    mod = {"ref": ref_res, "port": port_res}[side]
    fp = FP[side]

    async def run():
        res = Flaky(max_batch)
        w = mod.BufferWorker(res, retry_base=0.001, retry_cap=0.002)
        w.name = "sink1"
        for name, action, kw in points:
            fp.configure(name, action, **kw)
        await w.start()
        for i in range(6):
            w.enqueue({"n": i})
        for _ in range(2000):
            if w.stats["success"] >= 6:
                break
            await asyncio.sleep(0.001)
        await w.stop()
        fp.clear()
        return res.got, dict(w.stats), [p for p in fp.list_points()]

    return asyncio.run(run())


@pytest.mark.parametrize("max_batch,points", [
    (1, [("resource.buffer.query", "error", {"times": 2})]),
    (4, [("resource.batch.flush", "drop", {"times": 1})]),
    (4, [("resource.batch.flush", "duplicate", {"times": 1})]),
    (4, [("resource.buffer.query", "error", {"after": 1, "times": 1}),
         ("resource.batch.flush", "drop", {"times": 1, "after": 1})]),
])
def test_buffer_worker_seams_equal_reference(max_batch, points):
    """An injected fault rides the worker's real retry path with every
    query still buffered: the same deliveries and counters."""
    ref = _worker_run("ref", max_batch, points)
    port = _worker_run("port", max_batch, points)
    assert port[0] == ref[0]
    # flush_deferred is overload protection's counter, not ported
    assert port[1] == {k: v for k, v in ref[1].items()
                       if k != "flush_deferred"}
    assert port[1]["success"] == 6
    if any(action == "duplicate" for _n, action, _kw in points):
        assert port[0][0] == port[0][1]  # the batch went out twice
    else:
        assert port[1]["retried"] >= 1


def test_exhook_call_seam_walks_the_breaker():
    """``exhook.call`` raises `FailpointError` before the RPC: the call
    counts as a transport failure, the breaker opens after its
    threshold, and the verdict is None (the failure policy's input)."""
    from emqx_tpu_torch.exhook.client import ExhookClient

    class NoBroker:
        pass

    client = ExhookClient(NoBroker(), name="prov", url="127.0.0.1:1",
                          timeout=0.1)
    PFP.configure("exhook.call", "error")
    outs = [client._call("OnMessagePublish", None, None, None)
            for _ in range(client.breaker_threshold + 1)]
    assert outs == [None] * (client.breaker_threshold + 1)
    assert client.stats["failures"] == client.breaker_threshold
    assert client.stats["fast_failed"] == 1
    fires = [p["fires"] for p in PFP.list_points()]
    assert fires == [client.breaker_threshold]
