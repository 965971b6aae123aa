#!/usr/bin/env python3
"""Smoke run of the emqx_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card.  It builds
the hand-written kernels from ``emqx_tpu_torch/ops/csrc``, holds each
one against its plain PyTorch version at the real sizes (10M wildcard
subscriptions, publish windows of 32,768 topics), times them, drives the
match engine with 1M subscriptions, and drives the broker — over TCP,
as a user would — with 1M background subscriptions: the publish path
whose kernel launches it counts.  Phases:

  device        the card's name and power limit (nvidia-smi)
  build         nvcc of the kernel source, with its seconds
  kernel_parity K1/K2/K3 against their plain versions, exactly
  kernel_times  CUDA-event times, plain times, bytes and bounds
  engine        MatchEngine on the card vs the host trie, 1M filters
  broker        CLI round trip, then the in-process broker under load
  kernels       one JSON line per kernel (launches from the broker run)

The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero before it.  Without CUDA, or without the package beside this
script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM non-tensor rate, proxy for int32 ALU
SOURCE = "emqx_tpu_torch/ops/csrc/match_kernels.cu"
REPLACES = {
    "match_batch_compact": "emqx_tpu/ops/match_kernel.py:190",
    "match_batch": "emqx_tpu/ops/match_kernel.py:159",
    "decide_batch": "emqx_tpu/ops/match_kernel.py:270",
}
N_FILTERS = 10_000_000
BATCH = 32_768
SHAPES = ((4, 16), (16, 128))  # (f_width, m_cap): bench, broker
DECIDE_N = 1 << 20


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


# --------------------------------------------------------------- timing


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def exact_equal(name: str, got, want) -> float:
    """Integer/boolean outputs: equality is the tolerance (0)."""
    import torch

    for k, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            diff = (g.to(torch.int64) - w.to(torch.int64)).abs().max()
            fail(f"{name} output {k} differs from the plain version "
                 f"(max abs err {int(diff)})")
    return 0.0


# ---------------------------------------------------------- mqtt client


class Client:
    """Minimal asyncio MQTT 3.1.1 client over the port's codec."""

    def __init__(self, port: int, client_id: str) -> None:
        from emqx_tpu_torch.codec import mqtt as C

        self.C = C
        self.port = port
        self.client_id = client_id
        self.parser = C.StreamParser(version=C.MQTT_V4)
        self.inbox: asyncio.Queue = asyncio.Queue()
        self.reader = self.writer = None
        self._pump = None

    async def connect(self) -> None:
        C = self.C
        self.reader, self.writer = await asyncio.open_connection(
            "127.0.0.1", self.port
        )
        self._pump = asyncio.get_running_loop().create_task(self._read())
        self.send(C.Connect(client_id=self.client_id, proto_ver=C.MQTT_V4))
        ack = await self.expect(C.CONNACK)
        if ack.reason_code != 0:
            fail(f"CONNACK {ack.reason_code} for {self.client_id}")

    async def _read(self) -> None:
        while True:
            data = await self.reader.read(65536)
            if not data:
                await self.inbox.put(None)
                return
            for pkt in self.parser.feed(data):
                await self.inbox.put(pkt)

    def send(self, pkt) -> None:
        self.writer.write(self.C.serialize(pkt, self.C.MQTT_V4))

    async def expect(self, ptype: int, timeout: float = 30.0):
        pkt = await asyncio.wait_for(self.inbox.get(), timeout)
        if pkt is None or pkt.type != ptype:
            fail(f"{self.client_id}: expected packet type {ptype}, "
                 f"got {pkt!r}")
        return pkt

    async def subscribe(self, flt: str, qos: int) -> None:
        C = self.C
        self.send(C.Subscribe(packet_id=1, subscriptions=[
            C.Subscription(topic_filter=flt, qos=qos)]))
        ack = await self.expect(C.SUBACK)
        if ack.reason_codes != [qos]:
            fail(f"SUBACK {ack.reason_codes} for {flt}")

    async def close(self) -> None:
        if self._pump is not None:
            self._pump.cancel()
        if self.writer is not None:
            self.writer.close()
            try:
                await self.writer.wait_closed()
            except ConnectionError:
                pass


# --------------------------------------------------------------- phases


def phase_device():
    import torch

    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    return card


def phase_build():
    from emqx_tpu_torch.ops import _kernels

    phase("build")
    t0 = time.perf_counter()
    _kernels.load()
    print(f"build: nvcc {_kernels.build_info['seconds']:.2f} s, load "
          f"{time.perf_counter() - t0:.2f} s -> {_kernels.build_info['path']}",
          flush=True)
    for line in _kernels.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip(), flush=True)


def build_tables(n_filters: int):
    """The fleet automaton at ``n_filters`` on the card."""
    import numpy as np

    from emqx_tpu_torch import workload as W
    from emqx_tpu_torch.engine import _pad_nodes_pow2
    from emqx_tpu_torch.ops.automaton import assemble_automaton
    from emqx_tpu_torch.ops.dictionary import TokenDict, encode_topics
    from emqx_tpu_torch.state import tables_from_reference

    t0 = time.perf_counter()
    td = TokenDict()
    mat, blen, ish, pops = W.fleet_encoded(n_filters, 8, td)
    aut = assemble_automaton(mat, blen, ish, range(n_filters),
                             max_levels=16)
    _pad_nodes_pow2(aut)
    tab = tables_from_reference(aut.fp_rows, aut.node_rows, aut.salt,
                                aut.code_off, aut.code_idx, "cuda")
    topics = W.make_topics(np.random.default_rng(0), BATCH, pops)
    tok, ln, dol = encode_topics(td, [tuple(t.split("/")) for t in topics],
                                 aut.kernel_levels)
    mb = (aut.fp_rows.nbytes + aut.node_rows.nbytes) / 2**20
    print(f"tables: {n_filters} filters, {aut.n_nodes} nodes, "
          f"{len(aut.fp_rows)} buckets, {mb:.1f} MiB on the card, salt "
          f"{aut.salt}, levels {aut.kernel_levels}, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return tab, tok, ln, dol


def match_bytes(tab, batch, f_width, c_cap=None, m_cap=None):
    """Bytes the match must move for this batch: each input read once —
    tokens, lengths, dollar, and the distinct bucket and node rows the
    scan touches — and each output written once."""
    import torch

    from emqx_tpu_torch.ops import match_kernel as mk

    tok, ln, dol = batch
    touched = ([], [])
    mk._match_core(tab.fp_rows, tab.node_rows, tab.salt, tok, ln, dol,
                   f_width, touched)
    buckets = torch.unique(torch.cat(touched[0])).numel()
    nodes = torch.unique(torch.cat(touched[1]).clamp(
        0, tab.node_rows.shape[0] - 1)).numel() + 1  # + the root row
    lanes = sum(t.numel() for t in touched[0])
    b, levels = tok.shape
    n_in = b * levels * 4 + b * 4 + b + buckets * 64 + nodes * 32
    if c_cap is not None:
        n_out = c_cap * 4 + b * 2 + 4
    else:
        n_out = b * m_cap * 4 + b * 4 + b
    # per live lane per level: two hashes, an 8-wide compare, a share of
    # the 2F sort and the F-wide edge check — ~64 integer operations
    ops = lanes * 64
    return n_in + n_out, ops, buckets, nodes, lanes


def bound(n_bytes: float, ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(results):
    import numpy as np
    import torch

    from emqx_tpu_torch.ops import match_kernel as mk

    phase("kernel_parity")
    tab, tok, ln, dol = build_tables(N_FILTERS)
    batch = tuple(torch.from_numpy(a).cuda() for a in (tok, ln, dol))
    args = (tab.fp_rows, tab.node_rows, tab.salt, *batch)
    timing = {}
    for f, m in SHAPES:
        dense = mk.match_batch(*args, f_width=f, m_cap=m)
        exact_equal(f"match_batch F={f} M={m}", dense,
                    mk.match_batch_plain(*args, f_width=f, m_cap=m))
        ovf = dense[2].float().mean().item()
        for c_cap in (BATCH, BATCH // 8):
            got = mk.match_batch_compact(*args, f_width=f, m_cap=m,
                                         c_cap=c_cap)
            exact_equal(
                f"match_batch_compact F={f} M={m} c_cap={c_cap}", got,
                mk.match_batch_compact_plain(*args, f_width=f, m_cap=m,
                                             c_cap=c_cap),
            )
            total = int(got[2].item())
            print(f"parity F={f} M={m} c_cap={c_cap}: K1 and K2 equal "
                  f"their plain versions; total codes {total} "
                  f"({'clipped' if total > c_cap else 'fits'}), "
                  f"overflow rows {ovf:.6f} of {BATCH}", flush=True)
            if c_cap == BATCH // 8 and total <= c_cap:
                fail("the forced clip did not clip")
        timing[(f, m)] = ovf

    rng = np.random.default_rng(1)
    r, b = 1 << 16, 4096
    dec_np = (
        rng.integers(0, 3, r).astype(np.int8), rng.random(r) < 0.3,
        rng.random(r) < 0.4, rng.random(r) < 0.1,
        rng.integers(0, r, DECIDE_N).astype(np.int32),
        rng.integers(-1, r, DECIDE_N).astype(np.int32),
        np.sort(rng.integers(0, b, DECIDE_N)).astype(np.int32),
        rng.integers(0, 3, b).astype(np.int8), rng.random(b) < 0.5,
        rng.integers(-1, r, b).astype(np.int32),
    )
    dec = tuple(torch.from_numpy(a).cuda() for a in dec_np)
    exact_equal("decide_batch", (mk.decide_batch(*dec),),
                (mk.decide_batch_plain(*dec),))
    print(f"parity decide N={DECIDE_N}: K3 equals its plain version",
          flush=True)

    phase("kernel_times")
    card = results["card"]
    for f, m in SHAPES:
        for name, fn, plain, kw, c_cap in (
            ("match_batch_compact", mk.match_batch_compact,
             mk.match_batch_compact_plain, {"c_cap": BATCH}, BATCH),
            ("match_batch", mk.match_batch, mk.match_batch_plain, {}, None),
        ):
            ms = cuda_ms(lambda: fn(*args, f_width=f, m_cap=m, **kw), 50, 10)
            plain_ms = cuda_ms(
                lambda: plain(*args, f_width=f, m_cap=m, **kw), 3, 1)
            n_bytes, ops, buckets, nodes, lanes = match_bytes(
                tab, batch, f, c_cap=c_cap, m_cap=m)
            b_ms, b_by = bound(n_bytes, ops)
            print(f"time {name} F={f} M={m} B={BATCH}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms by {b_by} "
                  f"({n_bytes} B: {buckets} bucket rows, {nodes} node rows, "
                  f"{lanes} live lane-levels; {ops} ops), no library call "
                  f"[{card}]", flush=True)
            if (f, m) == SHAPES[1]:
                results["kernels"][name] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    from emqx_tpu_torch.ops import _kernels

    out = torch.empty(DECIDE_N, dtype=torch.uint8, device="cuda")
    ms = cuda_ms(lambda: _kernels.decide(*dec, out), 50, 5)
    wrap_ms = cuda_ms(lambda: mk.decide_batch(*dec), 50, 5)
    plain_ms = cuda_ms(lambda: mk.decide_batch_plain(*dec), 10)
    n = DECIDE_N
    n_bytes = n * 12 + n + r * 4 + b * 6
    b_ms, b_by = bound(n_bytes, n * 12)
    print(f"time decide_batch N={n}: kernel {ms:.4f} ms (wrapper with its "
          f"index range check {wrap_ms:.4f} ms), plain {plain_ms:.4f} ms, "
          f"bound {b_ms:.5f} ms by {b_by} ({n_bytes} B), no library call "
          f"[{card}]", flush=True)
    results["kernels"]["decide_batch"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    del tab, batch, args, dec
    torch.cuda.empty_cache()


def phase_engine():
    import numpy as np

    from emqx_tpu_torch import topic as T
    from emqx_tpu_torch import workload as W
    from emqx_tpu_torch.engine import MatchEngine
    from emqx_tpu_torch.ops import match_kernel as mk

    phase("engine")
    filters, pops = W.make_filters(1_000_000, 8)
    eng = MatchEngine()
    t0 = time.perf_counter()
    eng.insert_many([("/".join(ws), fid) for fid, ws in filters])
    if eng._delta:
        eng.rebuild()
    print(f"engine: {len(filters)} filters inserted and built in "
          f"{time.perf_counter() - t0:.1f} s ({eng._aut.n_nodes} nodes)",
          flush=True)
    rng = np.random.default_rng(2)
    windows = [W.make_topics(rng, 4096, pops) for _ in range(50)]
    mk.reset_launches()
    t0 = time.perf_counter()
    results = [eng.match_batch(w) for w in windows]
    wall = time.perf_counter() - t0
    counts = mk.launches()
    bad = 0
    for w, res in zip(windows, results):
        for topic, got in zip(w, res):
            if got != eng.match_host(T.words(topic)):
                bad += 1
    if bad:
        fail(f"engine: {bad} topics differ from the host trie")
    if counts["match_batch_compact"] < 50:
        fail(f"engine: compact kernel launched {counts} times")
    # the decide step on each window's deliveries (its matched fids as
    # subscriber rows, random subscription options and messages)
    import torch

    r = 256
    cols = (rng.integers(0, 3, r).astype(np.int8), rng.random(r) < 0.3,
            rng.random(r) < 0.4, rng.random(r) < 0.1)
    n_dec = 0
    for w, res in zip(windows, results):
        fids = np.fromiter(itertools.chain.from_iterable(res), np.int64)
        msg_idx = np.repeat(np.arange(len(w)), [len(x) for x in res])
        m_qos = rng.integers(0, 3, len(w)).astype(np.int8)
        m_retain = rng.random(len(w)) < 0.5
        m_from = rng.integers(-1, 1000, len(w)).astype(np.int32)
        cl = (fids % 1000).astype(np.int32)
        got = eng.decide_window(cols, 1, fids % r, cl, msg_idx, m_qos,
                                m_retain, m_from)
        want = mk.decide_batch_plain(*(torch.from_numpy(np.asarray(a)) for a in (
            *cols, (fids % r).astype(np.int32), cl,
            msg_idx.astype(np.int32), m_qos, m_retain, m_from))).numpy()
        if not np.array_equal(got, want):
            fail("engine: decide_window differs from the plain version")
        n_dec += len(fids)
    counts = mk.launches()
    if counts["decide_batch"] < 50:
        fail(f"engine: decide kernel launched {counts} times")
    c = eng.counters
    print(f"engine: 50 windows x 4096 topics equal the host trie; "
          f"decide_window on their {n_dec} deliveries equals the plain "
          f"version; launches {counts}; overflow rows {c['ovf_rows']} of "
          f"{c['rows']} ({c['ovf_rows'] / c['rows']:.6f}); clip reruns "
          f"{c['clip_reruns']}; {50 * 4096 / wall:.0f} topics/s "
          f"match_batch end to end (sequential windows)", flush=True)


async def cli_round_trip() -> None:
    from emqx_tpu_torch.codec import mqtt as C

    env = dict(os.environ, PYTHONPATH=HERE)
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "emqx_tpu_torch.broker", "--port", "0",
        "--bind", "127.0.0.1", cwd=HERE, env=env,
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE,
    )
    try:
        line = (await asyncio.wait_for(proc.stdout.readline(), 300)).decode()
        if "listening on" not in line or "cuda" not in line:
            err = (await proc.stderr.read()).decode()[-2000:]
            fail(f"broker CLI did not start on the card: {line!r} {err}")
        port = int(line.split("127.0.0.1:")[1].split()[0])
        cl = Client(port, "cli-rt")
        await cl.connect()
        await cl.subscribe("smoke/+", 1)
        cl.send(C.Publish(topic="smoke/x", payload=b"hi", qos=1,
                          packet_id=7))
        got = set()
        for _ in range(2):
            pkt = await asyncio.wait_for(cl.inbox.get(), 30)
            got.add(pkt.type)
            if pkt.type == C.PUBLISH:
                if (pkt.topic, pkt.payload, pkt.qos) != ("smoke/x", b"hi", 1):
                    fail(f"CLI round trip delivered {pkt!r}")
                cl.send(C.Puback(packet_id=pkt.packet_id))
        if got != {C.PUBLISH, C.PUBACK}:
            fail(f"CLI round trip got packet types {got}")
        await cl.close()
        print(f"broker CLI: python -m emqx_tpu_torch.broker on the card: "
              f"CONNECT, SUBSCRIBE smoke/+, PUBLISH QoS 1, PUBACK and "
              f"delivery ok ({line.strip()})", flush=True)
    finally:
        if proc.returncode is None:
            proc.terminate()
            try:
                await asyncio.wait_for(proc.wait(), 20)
            except asyncio.TimeoutError:
                proc.kill()
                await proc.wait()


SUB_FILTERS = ("load/#", "load/+/#", "load/+/+", "+/+/+", "#", "+/#",
               "load/+/+/#", "+/+/+/#")
N_PUB, N_MSG = 4, 1000


async def broker_load(results) -> None:
    """The main path: 1M background subscriptions in the engine, 8
    subscribers (each filter matches every load topic, 8 distinct trie
    codes per topic) and 4 publishers sending 1,000 QoS 1 messages each
    over TCP through the batcher."""
    from emqx_tpu_torch import workload as W
    from emqx_tpu_torch.broker.listener import BrokerServer
    from emqx_tpu_torch.config import BrokerConfig
    from emqx_tpu_torch.ops import match_kernel as mk

    cfg = BrokerConfig(bind="127.0.0.1", port=0)
    # subscribers can fall behind the publishers' acked stream; a queue
    # that holds the whole run keeps every delivery (none may drop)
    cfg.mqtt.max_mqueue_len = 4 * N_PUB * N_MSG
    server = BrokerServer(cfg)
    eng = server.broker.router.engine
    filters, _pops = W.make_filters(1_000_000, 8)
    t0 = time.perf_counter()
    eng.insert_many([("/".join(ws), fid) for fid, ws in filters])
    await server.start()
    subs = []
    try:
        for j, flt in enumerate(SUB_FILTERS):
            cl = Client(server.port, f"sub{j}")
            await cl.connect()
            await cl.subscribe(flt, 1)
            subs.append(cl)
        eng.rebuild()  # the subscribers' filters onto the card as well
        print(f"broker: {len(filters)} background filters + "
              f"{len(SUB_FILTERS)} subscriber filters on the card "
              f"({eng._aut.n_nodes} nodes) in {time.perf_counter() - t0:.1f} s",
              flush=True)
        C = subs[0].C
        pubs = []
        for p in range(N_PUB):
            cl = Client(server.port, f"pub{p}")
            await cl.connect()
            pubs.append(cl)
        expected = N_PUB * N_MSG
        lat = []
        seen = [set() for _ in subs]

        async def consume(j, cl):
            while len(seen[j]) < expected:
                try:
                    pkt = await asyncio.wait_for(cl.inbox.get(), 60)
                except asyncio.TimeoutError:
                    fail(f"sub{j} stalled at {len(seen[j])} of {expected}; "
                         f"received {[len(x) for x in seen]}; broker "
                         f"metrics {dict(server.broker.metrics)}")
                if pkt is None:
                    fail(f"sub{j} disconnected")
                if pkt.type != C.PUBLISH:
                    continue
                cl.send(C.Puback(packet_id=pkt.packet_id))
                p, k, ts = pkt.payload.split(b":")
                key = (int(p), int(k))
                if key in seen[j]:
                    fail(f"sub{j} got message {key} twice")
                seen[j].add(key)
                lat.append(time.perf_counter() - float(ts))

        async def produce(p, cl):
            window = asyncio.Semaphore(32)
            pids = itertools.count(1)
            acked = asyncio.Event()
            n_acked = 0

            async def acks():
                nonlocal n_acked
                while n_acked < N_MSG:
                    pkt = await asyncio.wait_for(cl.inbox.get(), 60)
                    if pkt is None or pkt.type != C.PUBACK:
                        fail(f"pub{p}: expected PUBACK, got {pkt!r}")
                    n_acked += 1
                    window.release()
                acked.set()

            task = asyncio.get_running_loop().create_task(acks())
            for k in range(N_MSG):
                await window.acquire()
                payload = f"{p}:{k}:{time.perf_counter()!r}".encode()
                cl.send(C.Publish(topic=f"load/p{p}/m{k % 16}",
                                  payload=payload, qos=1,
                                  packet_id=next(pids)))
                if k % 32 == 0:
                    await cl.writer.drain()
            await acked.wait()
            await task

        mk.reset_launches()  # counts of the main path start here
        t0 = time.perf_counter()
        await asyncio.wait_for(asyncio.gather(
            *(consume(j, cl) for j, cl in enumerate(subs)),
            *(produce(p, cl) for p, cl in enumerate(pubs)),
        ), 600)
        wall = time.perf_counter() - t0
        launches = mk.launches()
        results["launches"] = launches
        for j in range(len(subs)):
            if len(seen[j]) != expected:
                fail(f"sub{j} got {len(seen[j])} of {expected}")
        if min(launches.values()) < 1:
            fail(f"a kernel of the publish path never launched: {launches}")
        dropped = server.broker.metrics["delivery.dropped"]
        if dropped:
            fail(f"broker dropped {dropped} deliveries")
        lat.sort()
        p50 = lat[len(lat) // 2] * 1e3
        p99 = lat[int(len(lat) * 0.99)] * 1e3
        c = eng.counters
        print(f"broker: {expected} QoS 1 messages from {N_PUB} publishers "
              f"each delivered exactly once to {len(subs)} subscribers "
              f"({expected * len(subs)} deliveries) in {wall:.3f} s: "
              f"{expected / wall:.1f} msgs/s in, "
              f"{expected * len(subs) / wall:.1f} deliveries/s; delivery "
              f"latency p50 {p50:.3f} ms p99 {p99:.3f} ms; "
              f"{c['dev_windows']} match windows, {c['clip_reruns']} clip "
              f"reruns, {c['decide_windows']} decide windows; launches "
              f"{launches} [{results['card']}]", flush=True)
        for cl in subs + pubs:
            await cl.close()
    finally:
        await server.stop()


def phase_broker(results):
    phase("broker")
    asyncio.run(cli_round_trip())
    asyncio.run(broker_load(results))


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "emqx_tpu_torch")):
        fail("the emqx_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    t_start = time.perf_counter()
    results = {"kernels": {}, "launches": {}}
    results["card"] = phase_device()
    phase_build()
    phase_kernels(results)
    phase_engine()
    phase_broker(results)

    phase("kernels")
    rows = []
    for name in ("match_batch_compact", "match_batch", "decide_batch"):
        k = results["kernels"][name]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": results["launches"][name], "max_abs_err": 0,
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None,
        })
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
