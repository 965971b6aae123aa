#!/usr/bin/env python3
"""Smoke run of the emqx_tpu_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card.  It builds
the hand-written kernels from ``emqx_tpu_torch/ops/csrc``, holds each
one against its plain PyTorch version at the real sizes (10M wildcard
subscriptions, publish windows of 32,768 topics; rule registries of 100
and 10,000 programs over windows of 4,096 messages), times them, drives
the match engine with 1M subscriptions, the sharded match engine with
the same subscriptions split over 4 shards of one card, and the broker
— over TCP, as a user would — with 1M background subscriptions: first
the publish path, then the publish path with config 4's 100 rules,
whose kernel launches it counts, then the same rules with sink and
aggregate actions and a schema-decoding rule, then shared subscriptions, the
retained store, the publish path behind authentication, the ACL,
a topic rewrite, delayed publish, topic metrics and $SYS, then behind
the GCP, LDAP, HTTP and Mongo authentication back ends with the
per-client ACL cache, the server booted from a config file with tcp, ssl, ws and wss listeners, and the
management API's REST publishes, rules, read-backs and scrape beside
MQTT traffic; then durable sessions: a QoS 1 backlog, a restart and a
reconnect storm whose replay windows the decide kernel decides.
Phases:

  device          the card's name and power limit (nvidia-smi)
  build           nvcc of the kernel sources, with its seconds, and each
                  kernel's ptxas registers, stack frame and spills;
                  fails if a lane-group scan kernel (K1, K2, K5, every
                  group width), K4 (both instances), K3 or K6 (its 2-,
                  4-, 8- and 16-register instances) has a stack frame
                  or spills
  native build    g++ of the four host libraries in emqx_tpu_torch/native
                  (trie, token dictionary, sorts, wire splice), all
                  together; fails on any compiler output
  native parity   each native helper against its Python referee on
                  random inputs, exactly
  kernel_parity   K1/K2/K3 against their plain versions, exactly; K1,
                  K2 and K5 also on `workload.full_frontier`, whose
                  frontiers fill and overflow 16 lanes
  kernel_times    CUDA-event times (K1: its one launch and two memsets),
                  plain times, bytes and bounds
  sharded kernel  K5 on the 10M filters split over 4 shards against its
                  plain version, exactly, and its union of fids per
                  topic against K1's on the unsharded table; times
  rules kernel    K4 (the program lowered once, as the engine does)
                  against its plain version and the stacked program's,
                  exactly; its times and issue slots a warp-step
  predicate kernel  K6 for each of config 4's rules that compiles, over
                  4,096 messages, against its plain version and the
                  rule interpreter (`eval_where`), exactly; the device
                  time of an empty launch; times of the longest rule
                  there and on that window tiled to 262,144 messages
                  (held against the plain version first)
  engine          MatchEngine on the card vs the host trie, 1M filters;
                  K1 at the median launch of its 50 windows, held
                  against its plain version, then timed
  native times    the native helpers against their Python referees at
                  the engine's sizes, in turns: one window's encode, the
                  engine window with native=True and native=False (before
                  and after a 2,000-filter residual), the host trie over
                  a window, the 1M-filter automaton build
  sharded engine  ShardedMatchEngine on a one-card 4-shard mesh vs the
                  host trie, 1M filters, before and after churn and a
                  rebuild (and on a 2-card mesh where there are two);
                  K5 at the median launch of its first 20 windows, held
                  against its plain version, then timed
  churn           the churn path: MatchEngine with 1M filters at the
                  default thresholds, 20,000 wildcard inserts in
                  insert_many batches of 256 (1 in 8 deleted again) with
                  a 4,096-topic window after each batch, every window
                  against the host trie: with the background rebuild
                  (launches counted), then the synchronous one; folds,
                  rebuilds, K1 launches on the delta automaton, the
                  insert_many and window p50/p99/max; K1 (and K2, the
                  clip rerun) on the delta automaton at the median
                  launch, held against the plain versions, then timed;
                  the sharded engine (4 shards on one card, and on 2
                  cards where there are two) under 5,120 inserts
  broker          CLI round trip, then the in-process broker under load
                  (the main path), then with native=False and native in
                  turns; each run's per-stage medians from
                  Broker.profiler.summary()
  window assembly one broker window's wire, native splice against the
                  per-delivery Python encoder
  rules broker    the broker with 100 rules under load, against a second
                  broker pinned to the scalar interpreter referee; its
                  per-stage medians
  sinks broker    the rules broker's world with the rule egress over TCP:
                  80 rules sink JSON rows and 13 a template into one
                  recording resource (batches of 512, 50 ms linger), 6
                  push into a JSONL aggregator, an Avro rule decodes a
                  fifth publisher's 256 records (scalar SELECT lane), a
                  # subscriber; msgs/s in, sink queries/s, the batches
                  and their sizes, the rules lap with its rules_extract
                  and rules_eval split, the EWMA gate; K1, K3 and K4
                  launched (K4 once a rules window), nothing dropped,
                  the breaker closed; then the same windows in process
                  on the scalar and the batched lane in turns, each
                  equal to the TCP run (queries, records, metrics,
                  counters), with their rules laps
  mgmt broker     the broker phase's world (1M filters, its 8 subscribers)
                  with the management API on: admin login (one PBKDF2),
                  an API key of each role and a viewer user, config 4's
                  100 rules over REST (no actions), then 4 MQTT
                  publishers x 1,000 QoS 1 fleet messages beside 2,000
                  POST /api/v5/publish from 4 keep-alive client threads
                  under the publisher key (each delivered count checked);
                  REST publishes/s with one request's p50/p99, MQTT
                  msgs/s in; K1, K3 and K4 launched (K4 once a rules
                  window); the read-back routes, the /metrics scrape
                  (ms, bytes, families; a strict parse); GET
                  /api/v5/topics over the 1M filters' routes beside a light
                  client's QoS 1 every 10 ms (its longest PUBACK wait);
                  401/403 by role, an unported route's 501; ctl status,
                  rules and stats as subprocesses; then
                  `workload.mgmt_world` on the card against the CPU,
                  response for response
  main-path shapes  the N of every K3 launch of the broker run and the
                  (R, W) of every K4 launch of the rules broker run,
                  with K3 and K4 timed on their median launch's window
  shared broker   the broker's world with $share groups over TCP: g1 (4
                  members on load/+/+), g2 (3 on load/#) and a direct
                  load/# subscriber, round_robin, 4,000 QoS 1 messages:
                  exactly one member of each group and the direct
                  subscriber take each message, the round_robin split,
                  K1 and K3 launched (K3 once a decide window); then a g1
                  member leaves and 256 more reach the other three; then
                  a seeded $share script in process on the card against
                  the CPU under the four order-free strategies, byte for
                  byte
  retained        100,000 retained last-known-state messages (one per
                  device of config 3's populations) stored through
                  publish_many windows of 4,096 with the 1M filters (K1
                  each window); replayed over TCP to 16 MQTT 5
                  subscribers, each replay equal to a brute-force
                  topic.match and every PUBLISH with retain=1;
                  retain_handling 1 and 2 and $share replay nothing; 10%
                  deleted by empty retained publishes and replayed again;
                  Retainer.match p50/p99 per filter class
  access broker   the broker's world behind the control surface over
                  TCP: 100,000 users (salted SHA-256, one superuser,
                  anonymous refused), EMQX's default ACL shape with a
                  %c publish subtree (authz_default deny), a rewrite of
                  raw/<client>/... onto load/..., TopicMetrics on
                  load/#, a 1 s $SYS heartbeat to a superuser watcher;
                  one bad password refused, # and $SYS/# refused (0x87);
                  4 MQTT 5 publishers x 1,000 QoS 1 messages, every 8th
                  outside the subtree (PUBACK 0x87, never matched),
                  after 64 $delayed/1/ messages the server's
                  housekeeping releases: each accepted and delayed
                  message exactly once to 7 subscribers, TopicMetrics
                  in/out equal to the counts, heartbeats received, K1
                  and K3 launched (K3 once a decide window); msgs/s
                  against the broker phase; 512 authenticated CONNECTs
                  in waves of 64, CONNECT->CONNACK p50/p99; then
                  `workload.access_script` in process on the card
                  against the CPU, byte for byte
  auth backends broker  the broker's 1M filters behind the chain GCP
                  (32 RS256 2,048-bit and 32 ES256 devices, the registry
                  file in a temporary directory), LDAP (64 users), HTTP
                  (64 users), Mongo (100,000 salted SHA-256 users in
                  `mqtt_user`) and the Mongo `mqtt_acl` rows as the ACL
                  (authz default deny, anonymous refused), loopback
                  servers of `workload`; 512 CONNECTs in waves of 64
                  (CONNECT->CONNACK p50/p99 per back end, bcrypt_supported,
                  the requests each back end served: exactly one ACL find
                  a client and one authn find a Mongo client); 4,000 QoS 1
                  publishes from 8 of those clients, every 8th outside its
                  rows (PUBACK 0x87, authorization.deny), to 4
                  subscribers: msgs/s in, deliveries, no back-end request
                  after CONNECT, K1 and K3 once a decide window; then
                  `workload.authdb_world` (4,000 filters, 64 clients) on
                  the card against the CPU, byte for byte
  durable broker  durable sessions on the 1M filters (lts, fsync
                  always, a temporary directory): (a) 512 persistent
                  sessions (clean_start 0, expiry 3,600 s, one
                  vehicles/v<k>/sensors/# filter each, 4 a vehicle)
                  subscribe and disconnect at receive_maximum and
                  max_inflight 1,024, 8 publishers send 50,000 QoS 1
                  messages of 256 B (PUBACK p50/p99 under the group
                  commit, msgs/s in, sync_stats); a restart; (b) all
                  512 reconnect at once (CONNACK p50/p99, CONNECT to the
                  last replayed PUBLISH, replayed msgs/s, each client's
                  whole backlog in each publisher's order, duplicates
                  counted, session.resumed 512, K3 launched by the
                  replay windows, their sizes, the share of deliveries
                  that rode them); (c) a second backlog of 16,384, a
                  restart at the default max_inflight of 32 (boot to
                  listening, each boot's 1M-filter load apart), 64
                  sessions replay it (the window share again);
                  (d) `workload.durable_world`
                  (20,000 filters, 32 sessions, 2,000 messages) on the
                  card against the CPU, windowed and scalar, byte for
                  byte
  listeners       a JSON config with a tcp, an ssl, a ws and a wss
                  listener (the committed test certificate) and one
                  EMQX_TPU_* override: --check-config on it (exit 0) and
                  on a broken copy (exit 1); `python -m
                  emqx_tpu_torch.broker --config` on the card, a QoS 1
                  round trip on each transport; then an in-process
                  BrokerServer from the file with the 1M filters: the
                  broker phase's load split over the transports (each
                  message exactly once to 8 subscribers, delivery p50/p99
                  by transport, K1 and K3 once a decide window); a flood
                  of 20,000 QoS 0 messages beside a light client's 50
                  QoS 1 messages (its PUBACK p50/p99, windows of at most
                  512, publish_queue_congested raised and cleared); a v5
                  subscriber that stops reading under 2,000 QoS 1
                  messages of 16 KiB (its transport buffer's peak under
                  the watermark plus one window, conn_congestion raised
                  and cleared, every message once and in order)
  kernels         one JSON line per kernel (launches from the runs of
                  each kernel's path)

The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero before it.  Without CUDA, or without the package beside this
script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TLS_CERT = os.path.join(HERE, "tests", "torch_tls", "cert.pem")  # test-only
TLS_KEY = os.path.join(HERE, "tests", "torch_tls", "key.pem")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM non-tensor rate, proxy for int32 ALU
FP64_OPS_PER_S = 34e12  # H100 SXM non-tensor float64 (data sheet)
MATCH_SOURCE = "emqx_tpu_torch/ops/csrc/match_kernels.cu"
RULES_SOURCE = "emqx_tpu_torch/ops/csrc/rules_kernels.cu"
PRED_SOURCE = "emqx_tpu_torch/ops/csrc/predicate_kernels.cu"
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "match_batch_compact": (MATCH_SOURCE,
                            "emqx_tpu/ops/match_kernel.py:190"),
    "match_batch": (MATCH_SOURCE, "emqx_tpu/ops/match_kernel.py:159"),
    # the wrappers that launch K3 and K4 are ops.match_kernel.
    # decide_packed and rules_eval_lowered
    "decide_batch": (MATCH_SOURCE, "emqx_tpu/ops/match_kernel.py:270"),
    "rules_eval_batch": (RULES_SOURCE, "emqx_tpu/ops/match_kernel.py:502"),
    # the wrapper is ops.match_kernel.sharded_match_local
    "sharded_match": (MATCH_SOURCE, "emqx_tpu/parallel/sharded.py:180"),
    "predicate_eval_batch": (PRED_SOURCE,
                             "emqx_tpu/rules/predicate.py:106"),
}
N_SHARDS = 4  # the sharded phases: sub = 4 on one card
N_FILTERS = 10_000_000
BATCH = 32_768
SHAPES = ((4, 16), (16, 128))  # (f_width, m_cap): bench, broker
DECIDE_N = 1 << 20
RULES_W = 4096  # config 4's batch_max: one publish window
RULES_SIZES = (100, 10_000)  # config 4's rules; a 10k-program registry


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


# --------------------------------------------------------------- timing

# the spin that holds the card while the host issues a timed loop: about
# 50 ms at the H100's clock, far more than 50 launches take to issue
QUEUE_SPIN_CYCLES = 100_000_000


def cuda_ms(fn, iters: int, warmup: int = 2, queued: bool = False) -> float:
    """CUDA-event time per call of ``fn`` over ``iters`` calls issued back
    to back.  A launch shorter than the host's issue time per call reads
    as that issue time.  With ``queued`` the calls wait behind a spin
    kernel until the host has issued them all, so the events time the
    card's work alone (the device time)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int, warmup: int = 2) -> float:
    """Host clock per call of ``fn``, which ends on a device sync (a
    download to the host)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


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


def Client(port: int, client_id: str, version: int = 4, username=None,
           password=None, kind: str = "tcp"):
    """A `workload.TransportClient` (MQTT 3.1.1, or 5.0 with
    ``version=5``; tcp unless ``kind`` says otherwise, TLS trusting the
    test certificate)."""
    from emqx_tpu_torch.workload import TransportClient

    return TransportClient(port, client_id, kind, version, cafile=TLS_CERT,
                           username=username, password=password)


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


SCAN_KERNELS = ("match_rows_kernel", "sharded_match_rows_kernel",
                "match_compact_kernel")  # K2, K5, K1: the lane-group body
GROUP_WIDTHS = (1, 2, 4, 8, 16)
# K4's two instances (planes staged in shared memory or read through L1),
# K3 and K6's four (2, 4, 8 and 16 numeric registers): their registers
# must hold the whole state
REGISTER_KERNELS = (("rules_eval_kernel", 1), ("rules_eval_kernel", 0),
                    ("decide_kernel", None),
                    *(("predicate_eval_kernel", n) for n in (2, 4, 8, 16)))


def ptxas_table(log: str) -> dict:
    """(kernel, template width or None) -> registers, stack frame and
    spill bytes, from the ``-Xptxas=-v`` lines of the build."""
    names = sorted(SCAN_KERNELS + ("decide_kernel", "rules_eval_kernel",
                                   "predicate_eval_kernel"),
                   key=len, reverse=True)
    table, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", line)
        if m:
            mangled = m.group(1)
            name = next((n for n in names if f"{len(n)}{n}" in mangled),
                        mangled)
            g = re.search(rf"{len(name)}{name}IL[ib](\d+)EE", mangled)
            cur = table.setdefault((name, int(g.group(1)) if g else None),
                                   {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)),
                       spill=int(m.group(2)) + int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["regs"] = int(m.group(1))
    return table


def phase_build(results):
    from emqx_tpu_torch.ops import _kernels

    phase("build")
    t0 = time.perf_counter()
    _kernels.load()
    print(f"build: nvcc {_kernels.build_info['seconds']:.2f} s, load "
          f"{time.perf_counter() - t0:.2f} s -> {_kernels.build_info['path']}",
          flush=True)
    table = ptxas_table(_kernels.build_info["log"])
    for (name, g), row in sorted(table.items(), key=str):
        print(f"  ptxas: {name}{'' if g is None else f'<G={g}>'}: "
              f"{row.get('regs')} registers, {row.get('stack')} B stack "
              f"frame, {row.get('spill')} B spills", flush=True)
    for name in SCAN_KERNELS:
        for g in GROUP_WIDTHS:
            row = table.get((name, g))
            if row is None or "stack" not in row:
                fail(f"ptxas printed nothing for {name}<G={g}>")
            if row["stack"] or row["spill"]:
                fail(f"{name}<G={g}> keeps a {row['stack']} B stack frame "
                     f"and {row['spill']} B of spills: the lane-group scan "
                     f"must live in registers")
    for name, g in REGISTER_KERNELS:
        row = table.get((name, g))
        if row is None or "stack" not in row:
            fail(f"ptxas printed nothing for {name}<{g}>")
        if row["stack"] or row["spill"]:
            fail(f"{name}<{g}> keeps a {row['stack']} B stack frame and "
                 f"{row['spill']} B of spills: its registers must hold "
                 f"its state")
    results["ptxas"] = table
    print(f"ptxas: the {len(SCAN_KERNELS) * len(GROUP_WIDTHS)} scan kernel "
          f"instantiations, K4's two, K3 and K6's four have no stack frame "
          f"and no spills", flush=True)


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
    return tab, tok, ln, dol, (mat, blen, ish)


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


def bound(n_bytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def full_frontier_parity() -> None:
    """K1, K2 and K5 against their plain versions, exactly, on
    `workload.full_frontier` (every filter over +/a/b/c up to 5 levels):
    a topic's frontier doubles each level, so it fills all 16 lanes at
    level 4 and overflows at level 5; B = BATCH topics."""
    import numpy as np
    import torch

    from emqx_tpu_torch import workload as W
    from emqx_tpu_torch.ops import match_kernel as mk
    from emqx_tpu_torch.ops.automaton import build_automaton
    from emqx_tpu_torch.ops.dictionary import TokenDict, encode_topics
    from emqx_tpu_torch.parallel.sharded import (
        build_sharded_index, make_mesh,
    )
    from emqx_tpu_torch.state import sharded_tables_from_reference

    flts, tops = W.full_frontier(np.random.default_rng(6), BATCH)
    items = [(fid, tuple(f.split("/"))) for fid, f in enumerate(flts)]
    words = [tuple(t.split("/")) for t in tops]
    td = TokenDict()
    aut = build_automaton(items, td, max_levels=16)
    batch = tuple(torch.from_numpy(a).cuda() for a in encode_topics(
        td, words, aut.kernel_levels))
    args = (torch.from_numpy(aut.fp_rows).cuda(),
            torch.from_numpy(aut.node_rows).cuda(), aut.salt, *batch)
    f = 16
    for m, c_cap in ((128, 8 * BATCH), (16, BATCH)):
        dense = mk.match_batch(*args, f_width=f, m_cap=m)
        exact_equal(f"full frontier match_batch F={f} M={m}", dense,
                    mk.match_batch_plain(*args, f_width=f, m_cap=m))
        got = mk.match_batch_compact(*args, f_width=f, m_cap=m, c_cap=c_cap)
        exact_equal(f"full frontier match_batch_compact F={f} M={m} "
                    f"c_cap={c_cap}", got, mk.match_batch_compact_plain(
                        *args, f_width=f, m_cap=m, c_cap=c_cap))
        print(f"parity full frontier F={f} M={m} c_cap={c_cap} B={BATCH}: "
              f"K1 and K2 equal their plain versions; {len(flts)} filters, "
              f"overflow rows {int(dense[2].sum())}, total codes "
              f"{int(got[2].item())}", flush=True)
    mesh = make_mesh(devices=[torch.device("cuda", 0)] * N_SHARDS,
                     sub=N_SHARDS)
    std = TokenDict()
    idx = build_sharded_index(items, std, N_SHARDS, max_levels=16)
    sbatch = tuple(torch.from_numpy(a).cuda() for a in encode_topics(
        std, words, idx.kernel_levels))
    placed = sharded_tables_from_reference(*idx.tables, mesh)
    (key,) = placed.fp_rows
    tabs = (placed.fp_rows[key], placed.node_rows[key], placed.salts[key])
    for f in (16, 8):  # a shard holds a quarter: F=8 overflows there
        got = mk.sharded_match_local(*tabs, *sbatch, f_width=f, m_cap=128)
        exact_equal(f"full frontier sharded_match K={N_SHARDS} F={f}", got,
                    mk.sharded_match_plain(*tabs, *sbatch, f_width=f,
                                           m_cap=128))
        print(f"parity full frontier sharded K={N_SHARDS} F={f} M=128: K5 "
              f"equals its plain version; overflow (row, shard) pairs "
              f"{int(got[2].sum())}", flush=True)


def decide_bytes(n, r, b):
    """Bytes K3 must move: per delivery its opts row, client row and
    message index in and its byte out, each opts row's four option
    bytes and each message's qos, retain and from row once; 12 integer
    operations a delivery."""
    return n * 12 + n + r * 4 + b * 6, n * 12


def decide_times(card, oa, cols, wrapper, what, label=""):
    """K3 held against its plain version on these inputs (``oa`` packed,
    ``cols`` the six delivery and message columns), then its times: the
    launch alone (CUDA events, then queued behind a spin: the device
    time), ``wrapper`` (a call that ends on the host, CUDA events as for
    the launch), the plain version and the bound."""
    import torch

    from emqx_tpu_torch.ops import _kernels
    from emqx_tpu_torch.ops import match_kernel as mk

    n, r, b = cols[0].shape[0], oa.shape[0], cols[3].shape[0]
    out = torch.empty(n, dtype=torch.uint8, device="cuda")
    err = torch.empty(1, dtype=torch.int32, device="cuda")

    def bare():  # the error word's memset and the launch
        _kernels.decide(oa, *cols, out, err)

    bare()
    exact_equal(f"decide_batch{label} N={n}", (out, err),
                mk.decide_packed_plain(oa, *cols))
    ms = cuda_ms(bare, 50, 5)
    dev_ms = cuda_ms(bare, 50, 5, queued=True)
    wrap_ms = cuda_ms(wrapper, 50, 5)
    plain_ms = cuda_ms(lambda: mk.decide_packed_plain(oa, *cols), 10)
    n_bytes, ops = decide_bytes(n, r, b)
    b_ms, b_by = bound(n_bytes, ops)
    print(f"parity decide_batch{label} N={n} R={r} B={b}: K3 equals its "
          f"plain version", flush=True)
    print(f"time decide_batch{label} N={n} R={r} B={b}: kernel {ms:.4f} ms "
          f"(device {dev_ms:.4f} ms, wrapper ({what}) {wrap_ms:.4f} ms), "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms by {b_by} "
          f"({n_bytes} B), no library call [{card}]", flush=True)
    return dict(ms=ms, device_ms=dev_ms, wrapper_ms=wrap_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def phase_kernels(results):
    import numpy as np
    import torch

    from emqx_tpu_torch.ops import match_kernel as mk

    phase("kernel_parity")
    tab, tok, ln, dol, enc = build_tables(N_FILTERS)
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
    # K1's fid set per topic at the broker's shape: what the sharded
    # match must reproduce from its shards (the fid is the position)
    from emqx_tpu_torch.ops.automaton import expand_codes_flat

    flat, counts16, total = mk.match_batch_compact(
        *args, f_width=16, m_cap=128, c_cap=8 * BATCH)
    if int(total.item()) > 8 * BATCH:
        fail("K1's codes do not fit 8 x B")
    counts = counts16.cpu().numpy().astype(np.int64)
    k1_ovf = counts < 0
    k1_rows, k1_fids = expand_codes_flat(
        tab.code_off, tab.code_idx, flat.cpu().numpy(),
        np.where(k1_ovf, -counts - 1, counts), np.arange(BATCH))

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
    oa = mk.pack_opts(*dec[:4])
    exact_equal("decide_batch", (mk.decide_batch(*dec),),
                (mk.decide_batch_plain(*dec),))
    exact_equal("decide_packed", mk.decide_packed(oa, *dec[4:]),
                mk.decide_packed_plain(oa, *dec[4:]))
    print(f"parity decide N={DECIDE_N}: K3 equals its plain version",
          flush=True)
    full_frontier_parity()

    phase("kernel_times")
    from emqx_tpu_torch.ops import _kernels

    card = results["card"]
    for f, m in SHAPES:
        # the launches alone, into buffers allocated once
        codes = torch.empty((BATCH, m), dtype=torch.int32, device="cuda")
        counts = torch.empty(BATCH, dtype=torch.int32, device="cuda")
        ovf = torch.empty(BATCH, dtype=torch.bool, device="cuda")
        flat = torch.empty(BATCH, dtype=torch.int32, device="cuda")
        counts16 = torch.empty(BATCH, dtype=torch.int16, device="cuda")
        total = torch.empty(1, dtype=torch.int32, device="cuda")
        scratch = torch.empty(_kernels.compact_scratch_words(
            BATCH, tok.shape[1], f, m), dtype=torch.int64, device="cuda")

        def rows_only(f=f, m=m):
            _kernels.match_rows(tab.fp_rows, tab.node_rows, tab.salt,
                                *batch, f, m, codes, counts, ovf)

        def compact_only(f=f, m=m):  # one launch and its two memsets
            _kernels.match_compact(tab.fp_rows, tab.node_rows, tab.salt,
                                   *batch, f, m, BATCH, flat, counts16,
                                   total, scratch)

        for name, fn, plain, kw, c_cap, bare in (
            ("match_batch_compact", mk.match_batch_compact,
             mk.match_batch_compact_plain, {"c_cap": BATCH}, BATCH,
             compact_only),
            ("match_batch", mk.match_batch, mk.match_batch_plain, {}, None,
             rows_only),
        ):
            ms = cuda_ms(bare, 50, 10)
            dev_ms = cuda_ms(bare, 50, 10, queued=True)
            wrap_ms = cuda_ms(
                lambda: fn(*args, f_width=f, m_cap=m, **kw), 50, 10)
            plain_ms = cuda_ms(
                lambda: plain(*args, f_width=f, m_cap=m, **kw), 3, 1)
            n_bytes, ops, buckets, nodes, lanes = match_bytes(
                tab, batch, f, c_cap=c_cap, m_cap=m)
            b_ms, b_by = bound(n_bytes, ops)
            print(f"time {name} F={f} M={m} B={BATCH}: kernel {ms:.4f} ms "
                  f"(device {dev_ms:.4f} ms, wrapper {wrap_ms:.4f} ms), "
                  f"plain {plain_ms:.4f} ms, "
                  f"bound {b_ms:.5f} ms by {b_by} ({n_bytes} B: {buckets} "
                  f"bucket rows, {nodes} node rows, {lanes} live "
                  f"lane-levels; {ops} ops), no library call [{card}]",
                  flush=True)
            if (f, m) == SHAPES[1]:
                results["kernels"][name] = dict(
                    ms=ms, device_ms=dev_ms, wrapper_ms=wrap_ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    results["kernels"]["decide_batch"] = decide_times(
        card, oa, dec[4:], lambda: mk.decide_batch(*dec),
        "decide_batch, its range check read with the 4 B error word")
    del tab, batch, args, dec
    torch.cuda.empty_cache()
    return enc, (tok, ln, dol), (k1_rows, k1_fids, k1_ovf)


def sharded_bytes(fp_rows, node_rows, salts, batch, f_width, m_cap):
    """Bytes K5 must move for this batch: the tokens, lengths and dollar
    flags once, each shard's salt and the distinct bucket and node rows
    its scan touches, and each output once (codes, counts, overflow
    flags per shard, the total); operations: ~64 integer ones per live
    lane-level (as `match_bytes`) and one atomic add per row and shard."""
    import torch

    from emqx_tpu_torch.ops import match_kernel as mk

    tok, ln, dol = batch
    k = fp_rows.shape[0]
    b, levels = tok.shape
    n_bytes = b * levels * 4 + b * 4 + b + k * 4
    lanes = 0
    for j, salt in enumerate(salts.cpu().to(torch.int64).tolist()):
        touched = ([], [])
        mk._match_core(fp_rows[j], node_rows[j], salt, tok, ln, dol,
                       f_width, touched)
        buckets = torch.unique(torch.cat(touched[0])).numel()
        nodes = torch.unique(torch.cat(touched[1]).clamp(
            0, node_rows.shape[1] - 1)).numel() + 1  # + the root row
        n_bytes += buckets * 64 + nodes * 32
        lanes += sum(t.numel() for t in touched[0])
    n_bytes += k * b * (m_cap * 4 + 4 + 1) + b * 4
    return n_bytes, lanes * 64 + k * b, lanes


def phase_sharded_kernel(results, enc, batch_np, k1) -> None:
    """K5 on config 4's 10M filters split by `shard_of` into N_SHARDS
    shards of one card, against its plain version, and its union of
    fids per topic against K1's on the unsharded table."""
    import numpy as np
    import torch

    from emqx_tpu_torch.ops import _kernels
    from emqx_tpu_torch.ops import match_kernel as mk
    from emqx_tpu_torch.ops.automaton import expand_codes_host
    from emqx_tpu_torch.parallel.sharded import (
        assemble_sharded, make_mesh, shard_of, sharded_match,
    )
    from emqx_tpu_torch.state import sharded_tables_from_reference

    phase("sharded kernel")
    card = results["card"]
    mat, blen, ish = enc
    t0 = time.perf_counter()
    fids = np.arange(N_FILTERS)
    if any(shard_of(int(f), N_SHARDS) != f % N_SHARDS for f in fids[:1000]):
        fail("shard_of of an int fid is not fid % shards")
    parts = [fids[fids % N_SHARDS == k] for k in range(N_SHARDS)]
    index = assemble_sharded([(mat[p], blen[p], ish[p], p) for p in parts],
                             max_levels=16)
    mesh = make_mesh(devices=[torch.device("cuda", 0)] * N_SHARDS,
                     sub=N_SHARDS)
    placed = sharded_tables_from_reference(*index.tables, mesh)
    tok, ln, dol = batch_np
    if index.kernel_levels != tok.shape[1]:
        fail(f"shards scan {index.kernel_levels} levels, the unsharded "
             f"table {tok.shape[1]}")
    mb = sum(t.nbytes for t in index.tables[:2]) / 2**20
    print(f"sharded tables: {N_FILTERS} filters over {N_SHARDS} shards of "
          f"one card ({[len(p) for p in parts]} filters, "
          f"{[a.n_nodes for a in index.shards]} nodes, common geometry "
          f"{index.tables[0].shape[1]} buckets x {index.tables[1].shape[1]} "
          f"node rows, {mb:.1f} MiB), built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    (key,) = placed.fp_rows
    tabs = (placed.fp_rows[key], placed.node_rows[key], placed.salts[key])
    batch = tuple(torch.from_numpy(a).cuda() for a in batch_np)
    f, m = SHAPES[1]
    got = mk.sharded_match_local(*tabs, *batch, f_width=f, m_cap=m)
    want = mk.sharded_match_plain(*tabs, *batch, f_width=f, m_cap=m)
    torch.cuda.synchronize()
    exact_equal(f"sharded_match K={N_SHARDS} F={f} M={m}", got, want)
    entry = sharded_match(mesh, *placed, tok, ln, dol, f_width=f, m_cap=m)
    exact_equal("sharded_match entry point", entry, got)
    # the sharding itself: per topic, the union of the shards' fids
    # equals K1's on the unsharded table (rows either flags excepted)
    codes, _, ovf, total = (t.cpu().numpy() for t in got)
    k1_rows, k1_fids, k1_ovf = k1
    skip = k1_ovf | ovf.any(axis=0)
    pairs = []
    for k, (aut, p) in enumerate(zip(index.shards, parts)):
        r, pos = expand_codes_host(aut.code_off, aut.code_idx, codes[k])
        pairs.append(r * N_FILTERS + p[pos])
    k5 = np.sort(np.concatenate(pairs))
    k5 = k5[~skip[k5 // N_FILTERS]]
    k1s = np.sort(k1_rows * N_FILTERS + k1_fids)
    k1s = k1s[~skip[k1s // N_FILTERS]]
    if not np.array_equal(k5, k1s):
        fail(f"sharded fid sets differ from K1's ({k5.size} vs {k1s.size} "
             f"pairs)")
    print(f"parity sharded K={N_SHARDS} F={f} M={m} B={BATCH}: K5 equals its "
          f"plain version and the entry point; per topic the union of the "
          f"shards' fids equals K1's on the unsharded table ({k5.size} "
          f"(topic, fid) pairs; {int(skip.sum())} overflow rows skipped); "
          f"total codes {int(total.sum())}", flush=True)

    b = BATCH
    codes_b = torch.empty((N_SHARDS, b, m), dtype=torch.int32, device="cuda")
    counts_b = torch.empty((N_SHARDS, b), dtype=torch.int32, device="cuda")
    ovf_b = torch.empty((N_SHARDS, b), dtype=torch.bool, device="cuda")
    total_b = torch.empty(b, dtype=torch.int32, device="cuda")

    def bare():
        total_b.zero_()
        _kernels.sharded_match_rows(*tabs, *batch, f, m, codes_b, counts_b,
                                    ovf_b, total_b)

    ms = cuda_ms(bare, 50, 10)
    dev_ms = cuda_ms(bare, 50, 10, queued=True)
    wrap_ms = cuda_ms(lambda: mk.sharded_match_local(
        *tabs, *batch, f_width=f, m_cap=m), 50, 10)
    plain_ms = cuda_ms(lambda: mk.sharded_match_plain(
        *tabs, *batch, f_width=f, m_cap=m), 3, 1)
    n_bytes, ops, lanes = sharded_bytes(*tabs, batch, f, m)
    b_ms, b_by = bound(n_bytes, ops)
    print(f"time sharded_match K={N_SHARDS} F={f} M={m} B={b}: kernel "
          f"{ms:.4f} ms (with its total zeroed; device {dev_ms:.4f} ms, "
          f"wrapper {wrap_ms:.4f} ms), "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms by {b_by} "
          f"({n_bytes} B; {lanes} live lane-levels; {ops} ops), no library "
          f"call [{card}]", flush=True)
    results["kernels"]["sharded_match"] = dict(
        ms=ms, device_ms=dev_ms, wrapper_ms=wrap_ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by)
    del placed, tabs, batch, got, want, entry
    torch.cuda.empty_cache()


def rules_window(n_rules: int):
    """A stacked registry of ``n_rules`` programs and one window of
    RULES_W fleet messages with JSON payloads, as the rule engine
    builds them.  100 rules: config 4's rule set (its lowerable part);
    10,000: distinct literals, so no two rules share a program."""
    import numpy as np

    from emqx_tpu_torch import workload as W
    from emqx_tpu_torch.message import Message
    from emqx_tpu_torch.rules.columns import WindowColumns
    from emqx_tpu_torch.rules.predicate import build_stack
    from emqx_tpu_torch.rules.sql import parse_sql

    if n_rules == RULES_SIZES[0]:
        sqls = [q for _, q in W.make_rules(n_rules)]
    else:
        sqls = [f'SELECT * FROM "t" WHERE {w}'
                for w in W.make_distinct_wheres(n_rules)]
    stack = build_stack([(str(i), parse_sql(q).where)
                         for i, q in enumerate(sqls)])
    if stack.fallback or stack.n_lowered != n_rules:
        fail(f"rules: {len(stack.fallback)} of {n_rules} did not lower")
    rng = np.random.default_rng(n_rules)
    pops = W.populations(1_000_000, 8)
    topics = W.make_topics(rng, RULES_W, pops)
    msgs = [Message(topic=t, payload=p, qos=1, from_client=f"pub{k % 4}",
                    timestamp=1752000000.0 + k / 1000)
            for k, (t, p) in enumerate(zip(
                topics, W.make_rule_payloads(rng, RULES_W)))]
    return stack, WindowColumns(msgs, stack.paths, stack.lit_strings)


def rules_work(stack, cols):
    """What K4 must do for this window: the bytes it must move (the
    program, the planes, the literal ranks and the [R, W] output, each
    once) and the least operations per message of the steps each rule
    runs up to its result register, counted per opcode: float64 for
    NaN tests, arithmetic and numeric comparisons; int32 for id and
    rank comparisons and the boolean pair algebra.  Loads, literals and
    presence reads count as bytes only."""
    import numpy as np

    from emqx_tpu_torch.rules import predicate as P

    r, s = stack.code.shape
    # the WHERE planes only: the rule engine's SELECT lane appends the
    # planes only a SELECT reads, which K4 never gets
    p, w = len(stack.paths), cols.n
    n_bytes = (r * s * (4 * 5 + 8) + r * 4 + p * w * (8 + 4 + 1 + 1)
               + cols.lit_ranks.size * 4 + r * w)
    # opcode -> (float64 ops, int32 ops) per message
    per_op = {
        P.R_NLOAD: (1, 0), P.R_NNEG: (1, 0), P.R_NADD: (1, 0),
        P.R_NSUB: (1, 0), P.R_NMUL: (1, 0),
        P.R_NDIV: (2, 0),  # zero test, divide
        P.R_NIDV: (5, 0),  # zero test, 2 truncs, divide, floor
        P.R_NMOD: (7, 0),  # div's 5, multiply, subtract
        P.R_BNOT: (0, 1), P.R_BAND: (0, 2), P.R_BOR: (0, 2),
        P.R_CGT: (1, 0), P.R_CLT: (1, 0), P.R_CGE: (1, 0),
        P.R_CLE: (1, 0),
        P.R_EQVV: (3, 2),  # 2 NaN tests, equal; id known, id equal
        P.R_EQVL: (2, 0),  # NaN test, equal
        P.R_EQSL: (0, 1), P.R_EQC: (1, 0),
    }
    f64 = np.zeros(64, np.int64)
    i32 = np.zeros(64, np.int64)
    for op, (f, i) in per_op.items():
        f64[op], i32[op] = f, i
    live = np.arange(s)[None, :] <= stack.last[:, None]
    code = np.where(live, stack.code, P.R_NOP)
    ranked = (live & (stack.code >= P.R_CGT) & (stack.code <= P.R_CLE)
              & (stack.a2 >= 0) & (stack.a3 >= 0))  # + a rank compare
    fp_ops = int(f64[code].sum()) * w
    int_ops = (int(i32[code].sum()) + int(ranked.sum())) * w
    return n_bytes, fp_ops, int_ops


def rules_times(card, stack, cols, low, wrapper, label):
    """K4 held against the plain version of the lowered program over one
    window, then its times: the launch alone (CUDA events, then queued
    behind a spin: the device time), ``wrapper`` (the engine's
    per-window path, ending on the host), the plain version of the
    lowered program and of the stacked one, and the bound computed from
    the stacked program's work (`rules_work`)."""
    import torch

    from emqx_tpu_torch.ops import _kernels
    from emqx_tpu_torch.ops import match_kernel as mk
    from emqx_tpu_torch.state import (
        columns_from_reference, rules_program_from_reference,
    )

    r, w, k = stack.n_rules, cols.n, len(stack.paths)
    pl = columns_from_reference(cols.num[:k], cols.sid[:k], cols.err[:k],
                                cols.prs[:k], cols.lit_ranks, "cuda")
    planes = (pl.lit_ranks, pl.num, pl.sid, pl.err, pl.prs)
    out = torch.empty((r, w), dtype=torch.bool, device="cuda")

    def bare():
        _kernels.rules_eval(*low[:3], *planes, out)

    bare()
    exact_equal(f"rules_eval_batch{label} R={r} W={w}", (out,),
                (mk.rules_eval_lowered_plain(*low[:3], *planes),))
    print(f"parity rules_eval_batch{label} R={r} W={w}: K4 equals the "
          f"plain version of the lowered program", flush=True)
    ms = cuda_ms(bare, 20, 3)
    dev_ms = cuda_ms(bare, 20, 3, queued=True)
    wrap_ms = host_ms(wrapper, 10, 2)
    plain_ms = cuda_ms(lambda: mk.rules_eval_lowered_plain(*low[:3],
                                                           *planes), 2, 1)
    prog = rules_program_from_reference(
        stack.code, stack.a0, stack.a1, stack.a2, stack.a3, stack.litn,
        stack.last, "cuda")
    stacked_ms = cuda_ms(lambda: mk.rules_eval_plain(
        *prog[:6], pl.lit_ranks, prog.last, pl.num, pl.sid, pl.err, pl.prs),
        2, 1)
    n_bytes, fp_ops, int_ops = rules_work(stack, cols)
    # the float64 and int32 pipes run side by side: the slower one
    # bounds the operations
    b_ms, b_by = max(bound(n_bytes, fp_ops, FP64_OPS_PER_S),
                     bound(n_bytes, int_ops, FP32_OPS_PER_S))
    print(f"time rules_eval_batch{label} R={r} W={w}: kernel {ms:.4f} ms "
          f"(device {dev_ms:.4f} ms), wrapper (planes up in one copy, kernel, "
          f"[R, W] down after one synchronise) {wrap_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms (of the stacked program {stacked_ms:.4f} "
          f"ms), bound {b_ms:.6f} ms by {b_by} ({n_bytes} B; {fp_ops} "
          f"float64 and {int_ops} int32 ops), no library call [{card}]",
          flush=True)
    return dict(ms=ms, device_ms=dev_ms, wrapper_ms=wrap_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def step_cost(card, n_rules, pl, slots_per_ms) -> None:
    """K4's time against the lowered step count, on ``n_rules`` copies of
    one synthetic program over the window's planes ``pl``: no step (a
    constant), one compare of a plane with a literal, and four such
    compares joined by three ANDs (7 steps); the difference of the last
    two over 6 is the cost of a step, in ms and in SM issue slots a
    (rule, 32-message) warp-step."""
    import numpy as np
    import torch

    from emqx_tpu_torch.ops import _kernels
    from emqx_tpu_torch.rules import predicate as P
    from emqx_tpu_torch.state import rules_lowered_from_reference

    def program(k):
        steps = [(P.R_BLIT, 1, -1)] if k == 0 else []
        for j in range(k):
            base = len(steps)
            steps += [(P.R_NLOAD, j % pl.num.shape[0], -1),
                      (P.R_NLIT, -1, -1), (P.R_CGT, base, base + 1)]
            if j:
                steps.append((P.R_BAND, base - 1, base + 2))
        arrs = [np.full((n_rules, len(steps)), -1, np.int32)
                for _ in range(5)]
        for s, (op, x, y) in enumerate(steps):
            arrs[0][:, s], arrs[1][:, s], arrs[2][:, s] = op, x, y
        litn = np.full((n_rules, len(steps)), 30.0)
        last = np.full(n_rules, len(steps) - 1, np.int32)
        return rules_lowered_from_reference(*arrs, litn, last, "cuda")

    out = torch.empty((n_rules, pl.num.shape[1]), dtype=torch.bool,
                      device="cuda")
    times = {}
    for k in (0, 1, 4):
        low = program(k)
        n = int(low.meta[0].item()) & 0xFF
        times[n] = cuda_ms(lambda: _kernels.rules_eval(
            *low[:3], pl.lit_ranks, pl.num, pl.sid, pl.err, pl.prs, out),
            20, 3, queued=True)
    per = (times[7] - times[1]) / 6
    warp_steps = n_rules * -(-pl.num.shape[1] // 32)
    print(f"K4 cost a lowered step, R={n_rules} W={pl.num.shape[1]}: "
          f"device {times[0]:.4f} ms with no step, {times[1]:.4f} ms with "
          f"one compare, {times[7]:.4f} ms with 7 steps: {per:.4f} ms a "
          f"step, {per * slots_per_ms / warp_steps:.1f} issue slots a "
          f"warp-step [{card}]", flush=True)


def phase_rules_kernel(results):
    import numpy as np
    import torch

    from emqx_tpu_torch.ops import match_kernel as mk
    from emqx_tpu_torch.rules.evaluator import RulesEvaluator
    from emqx_tpu_torch.state import (
        columns_from_reference, rules_program_from_reference,
    )

    phase("rules kernel")
    card = results["card"]
    for n_rules in RULES_SIZES:
        t0 = time.perf_counter()
        stack, cols = rules_window(n_rules)
        built = time.perf_counter() - t0
        ev = RulesEvaluator("cuda")
        t0 = time.perf_counter()
        mat, path = ev.eval_window(stack, 1, cols)  # lowers, uploads
        lowered = time.perf_counter() - t0
        low = ev._prog[1]
        prog = rules_program_from_reference(
            stack.code, stack.a0, stack.a1, stack.a2, stack.a3, stack.litn,
            stack.last, "cuda")
        pl = columns_from_reference(cols.num, cols.sid, cols.err, cols.prs,
                                    cols.lit_ranks, "cuda")
        planes = (pl.lit_ranks, pl.num, pl.sid, pl.err, pl.prs)
        got = mk.rules_eval_lowered(low, *planes)
        want = mk.rules_eval_lowered_plain(*low[:3], *planes)
        stacked = mk.rules_eval_plain(*prog[:6], pl.lit_ranks, prog.last,
                                      pl.num, pl.sid, pl.err, pl.prs)
        batch = mk.rules_eval_batch(*prog[:6], pl.lit_ranks, prog.last,
                                    pl.num, pl.sid, pl.err, pl.prs)
        torch.cuda.synchronize()
        exact_equal(f"rules_eval_lowered R={n_rules} W={RULES_W}", (got,),
                    (want,))
        exact_equal(f"rules_eval_lowered R={n_rules} W={RULES_W} against "
                    f"the stacked program", (got,), (stacked,))
        exact_equal(f"rules_eval_batch R={n_rules} W={RULES_W}", (batch,),
                    (stacked,))
        if path != "dev" or not np.array_equal(mat, got.cpu().numpy()):
            fail(f"rules evaluator R={n_rules}: its window differs")
        r, s = stack.code.shape
        n = low.meta.cpu().numpy() & 0xFF
        print(f"parity rules R={r} S={s} P={cols.num.shape[0]} "
              f"L={cols.lit_ranks.size} W={RULES_W}: K4 equals its plain "
              f"version and the stacked program's ({int(got.sum())} of "
              f"{got.numel()} cells pass; opcodes "
              f"{sorted(set(stack.code.ravel().tolist()))}; lowered to "
              f"{low.steps.shape[1]} record columns, {n.mean():.2f} steps a "
              f"rule on average against "
              f"{(stack.last + 1).mean():.2f} stacked; stack and window "
              f"built in {built:.1f} s, lowered in {lowered:.2f} s)",
              flush=True)
        row = rules_times(card, stack, cols, low,
                          lambda: ev.eval_window(stack, 1, cols), "")
        # the device time in SM issue slots a warp-step (a warp runs one
        # rule's steps over 32 messages)
        slices = -(-RULES_W // 32)
        lowered_ws, stacked_ws = (int(n.sum()) * slices,
                                  int((stack.last + 1).sum()) * slices)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout.split()
        mhz = float(smi[0]) if smi else float("nan")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        slots = row["device_ms"] * 1e-3 * mhz * 1e6 * sms * 4
        print(f"K4 R={r} W={RULES_W}: {lowered_ws} lowered warp-steps "
              f"({stacked_ws} stacked); at {mhz:.0f} MHz x {sms} SMs x 4 "
              f"schedulers the device time is {slots / lowered_ws:.1f} "
              f"issue slots a lowered warp-step ({slots / stacked_ws:.1f} "
              f"a stacked one)", flush=True)
        results["rules_sizes"][n_rules] = row
        if n_rules == RULES_SIZES[0]:
            results["kernels"]["rules_eval_batch"] = row
        else:
            step_cost(card, n_rules, pl, slots / row["device_ms"])
        del prog, pl, planes, got, want, stacked, batch, low, ev
        torch.cuda.empty_cache()


PRED_OPS = {  # K6 opcode -> (float64 ops, int32 ops) per message
    "P_NLOAD": (1, 0), "P_NNEG": (1, 0), "P_NADD": (1, 0),
    "P_NSUB": (1, 0), "P_NMUL": (1, 0),
    "P_NDIV": (2, 0),  # zero test, divide
    "P_NIDV": (5, 0),  # zero test, 2 truncs, divide, floor
    "P_NMOD": (7, 0),  # div's 5, multiply, subtract
    "P_BNOT": (0, 1), "P_BAND": (0, 2), "P_BOR": (0, 2),
    "P_CGT": (1, 0), "P_CLT": (1, 0), "P_CGE": (1, 0), "P_CLE": (1, 0),
    "P_EQN": (1, 2),  # equal; error lanes, id lanes
    "P_EQS": (0, 2),  # error lane, id equal
}


def predicate_work(code, n_vars, n_lits, w):
    """What K6 must do for one rule over ``w`` messages: the bytes it
    must move (the program, the var lanes, the literal ids and the
    verdicts, each once) and its float64 and int32 operations (loads
    and literals count as bytes only)."""
    from emqx_tpu_torch.rules import predicate as P

    n_bytes = (code.steps.nbytes + code.lit.nbytes + n_vars * w * (8 + 4 + 1)
               + n_lits * 4 + w)
    per_op = {getattr(P, k): v for k, v in PRED_OPS.items()}
    fp = it = 0
    for op in code.steps[:, 0].tolist():
        f, i = per_op.get(op, (0, 0))
        fp, it = fp + f * w, it + i * w
    return n_bytes, fp, it


def predicate_window():
    """Config 4's rules that `compile_where` accepts, as ``(rule id,
    PredicateProgram)``, and one window of RULES_W JSON telemetry
    messages as envs (millisecond timestamps and 2**24 + 1 among the
    values)."""
    import numpy as np

    from emqx_tpu_torch import workload as W
    from emqx_tpu_torch.message import Message
    from emqx_tpu_torch.rules import predicate as P
    from emqx_tpu_torch.rules.runtime import build_env
    from emqx_tpu_torch.rules.sql import parse_sql

    progs = [(rid, P.compile_where(parse_sql(q).where))
             for rid, q in W.make_rules(RULES_SIZES[0])]
    progs = [(rid, p) for rid, p in progs if p is not None]
    rng = np.random.default_rng(5)
    pops = W.populations(1_000_000, 8)
    envs = [build_env(Message(topic=t, payload=p, qos=1,
                              from_client=f"pub{k % 4}",
                              timestamp=1752000000.0 + k / 1000))
            for k, (t, p) in enumerate(zip(
                W.make_topics(rng, RULES_W, pops),
                W.make_rule_payloads(rng, RULES_W)))]
    return progs, envs


def predicate_args(p, cols, lit_ids):
    """K6's inputs for program ``p`` over extracted columns, on the card:
    ``(args, slots)``, ``args`` as `predicate_eval_batch` takes them."""
    from emqx_tpu_torch.rules import predicate as P
    from emqx_tpu_torch.state import (
        predicate_columns_from_reference, predicate_program_from_code,
    )

    pc = predicate_columns_from_reference(cols, lit_ids, "cuda")
    dc = predicate_program_from_code(
        P.lower_predicate(p.where, p.var_paths), "cuda")
    return (dc.steps, dc.lit, dc.result, pc.num, pc.sid, pc.err,
            pc.lit_ids), dc.slots


def predicate_times(card, label, p, code, cols, lit_ids) -> dict:
    """K6 on one rule's columns: held against its plain version, then
    timed: the launch alone (CUDA events, then queued behind a spin:
    the device time), the wrapper from the extracted columns to the
    numpy verdicts (`PredicateProgram.eval_columns`: columns packed and
    up in one copy, kernel, verdicts down; host clock), the plain
    version and the bound (`predicate_work`)."""
    import torch

    from emqx_tpu_torch.ops import _kernels
    from emqx_tpu_torch.ops import match_kernel as mk

    args, slots = predicate_args(p, cols, lit_ids)
    w = args[3].shape[1]
    out = torch.empty(w, dtype=torch.bool, device="cuda")

    def bare():
        _kernels.predicate_eval(*args, slots, out)

    bare()
    exact_equal(f"predicate_eval_batch {label} W={w}", (out,),
                (mk.predicate_eval_plain(*args),))
    ms = cuda_ms(bare, 50, 5)
    dev_ms = cuda_ms(bare, 50, 5, queued=True)
    wrap_ms = host_ms(lambda: p.eval_columns(cols, lit_ids, "cuda"), 20, 3)
    plain_ms = cuda_ms(lambda: mk.predicate_eval_plain(*args), 5, 1)
    n_bytes, fp_ops, int_ops = predicate_work(
        code, len(code.names), len(code.lits), w)
    b_ms, b_by = max(bound(n_bytes, fp_ops, FP64_OPS_PER_S),
                     bound(n_bytes, int_ops, FP32_OPS_PER_S))
    print(f"time predicate_eval_batch {label}: kernel {ms:.4f} ms (device "
          f"{dev_ms:.4f} ms; {slots} numeric registers), wrapper (columns "
          f"packed and up in one copy, kernel, verdicts down) "
          f"{wrap_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms "
          f"by {b_by} ({n_bytes} B; {fp_ops} float64 and {int_ops} int32 "
          f"ops), no library call [{card}]", flush=True)
    return dict(ms=ms, device_ms=dev_ms, wrapper_ms=wrap_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


PRED_STRESS_TILES = 64  # the stress window: 64 x 4,096 = 262,144 messages


def phase_predicate_kernel(results) -> None:
    """K6, one launch per rule: every rule of config 4's 100 that
    `compile_where` accepts, over one window of RULES_W messages, held
    against its plain version and the interpreter; the longest rule
    timed there and on a stress window of that window tiled
    PRED_STRESS_TILES times; an empty launch's device time beside."""
    import numpy as np
    import torch

    from emqx_tpu_torch.ops import match_kernel as mk
    from emqx_tpu_torch.rules import predicate as P
    from emqx_tpu_torch.rules.runtime import eval_where

    phase("predicate kernel")
    card = results["card"]
    t0 = time.perf_counter()
    progs, envs = predicate_window()
    built = time.perf_counter() - t0
    mk.reset_launches()  # counts of the K6 path start here
    t0 = time.perf_counter()
    got = {rid: p.eval_batch(envs, device="cuda") for rid, p in progs}
    wall = time.perf_counter() - t0
    launches = mk.launches()["predicate_eval_batch"]
    results["launches"]["predicate_eval_batch"] = launches
    if launches != len(progs):
        fail(f"predicate kernel: {launches} launches for {len(progs)} rules")
    longest, n_pass, ops, widths = None, 0, set(), {}
    for rid, p in progs:
        if not np.array_equal(got[rid], [eval_where(p.where, e)
                                         for e in envs]):
            fail(f"predicate kernel: {rid} differs from the interpreter")
        cols, sdict = p.extract_columns(envs)
        lit_ids = P._literal_ids(p.where, sdict)
        args, slots = predicate_args(p, cols, lit_ids)
        want = mk.predicate_eval_plain(*args)
        # the instance the program runs on, and the widest one
        for n in (slots, P.PRED_REGS):
            exact_equal(f"predicate_eval_batch {rid} slots={n}",
                        (mk.predicate_eval_batch(*args, slots=n),), (want,))
        code = P.lower_predicate(p.where, p.var_paths)
        n_pass += int(got[rid].sum())
        ops |= set(code.steps[:, 0].tolist())
        widths[slots] = widths.get(slots, 0) + 1
        if longest is None or len(code.steps) > len(longest[2].steps):
            longest = (rid, p, code, cols, lit_ids)
    print(f"parity predicate: {len(progs)} of {RULES_SIZES[0]} rules compile; "
          f"K6 equals its plain version and the interpreter for each "
          f"over W={RULES_W} ({n_pass} passes; opcodes {sorted(ops)}; "
          f"rules by numeric registers named {dict(sorted(widths.items()))}, "
          f"each also equal on the 16-register instance; window built in "
          f"{built:.1f} s; the {len(progs)} device evaluations took "
          f"{wall:.3f} s with column extraction)", flush=True)
    empty_ms = cuda_ms(lambda: torch.cuda._sleep(0), 50, 5, queued=True)
    print(f"empty launch (torch.cuda._sleep(0), queued the same way): device "
          f"{empty_ms:.4f} ms [{card}]", flush=True)
    rid, p, code, cols, lit_ids = longest
    sizes = f"S={len(code.steps)} V={len(code.names)}"
    row = predicate_times(card, f"{rid} {sizes} W={RULES_W}", p, code, cols,
                          lit_ids)
    big = {k: np.tile(v, PRED_STRESS_TILES) for k, v in cols.items()}
    w = RULES_W * PRED_STRESS_TILES
    row["stress"] = dict(predicate_times(
        card, f"stress W={w} {sizes}", p, code, big, lit_ids), w=w)
    row["empty_launch_ms"] = empty_ms
    results["kernels"]["predicate_eval_batch"] = row


def sharded_engine_run(mesh, filters, pops, label, log_into=None):
    """A ShardedMatchEngine on ``mesh`` with ``filters``: 20 windows of
    4,096 Zipf topics, churn (one insert, 2,048 insert_many, two
    deletes), a rebuild; every window against the host trie.  With
    ``log_into`` (a dict), the K5 launches of the 20 windows are
    recorded there by `MainPathLog` (with the engine, under "eng")."""
    import numpy as np

    from emqx_tpu_torch import topic as T
    from emqx_tpu_torch import workload as W
    from emqx_tpu_torch.ops import match_kernel as mk
    from emqx_tpu_torch.parallel.sharded import ShardedMatchEngine

    eng = ShardedMatchEngine(mesh, rebuild_threshold=10**9)
    t0 = time.perf_counter()
    eng.insert_many([("/".join(ws), fid) for fid, ws in filters])
    eng.rebuild()
    idx = eng.index
    print(f"{label}: {len(filters)} filters over mesh {mesh.shape} "
          f"({[len(a.filters) for a in idx.shards]} per shard, "
          f"{idx.tables[0].shape[1]} buckets x {idx.tables[1].shape[1]} "
          f"node rows each) inserted and built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(4)
    windows = [W.make_topics(rng, 4096, pops) for _ in range(20)]
    churn_topics = ([f"churn/{i % 101}/x/c{i}" for i in range(0, 2048, 4)]
                    + ["no/x/here", "no/here"] + windows[0][:1024])

    def check(wins, what):
        t = time.perf_counter()
        res = [eng.match_batch(w) for w in wins]
        wall = time.perf_counter() - t
        bad = sum(got != eng.match_host(T.words(topic))
                  for w, r in zip(wins, res) for topic, got in zip(w, r))
        if bad:
            fail(f"{label}: {bad} topics differ from the host trie {what}")
        return wall, sum(len(w) for w in wins)

    log = MainPathLog(eng, ("sharded_match_rows",)) if log_into is not None \
        else None
    mk.reset_launches()  # counts of the sharded path start here
    try:
        wall, n = check(windows, "before churn")
    finally:
        if log is not None:
            log.remove()
            log_into.update(log.log)
    eng.insert("no/+/here", 9_000_001)
    eng.insert_many([(f"churn/{i % 101}/+/c{i}", 9_100_000 + i)
                     for i in range(2048)])
    eng.delete(filters[0][0])
    eng.delete(filters[7][0])
    check([churn_topics] + windows[:2], "after churn")
    eng.rebuild()
    check([churn_topics] + windows[:2], "after the rebuild")
    launches = mk.launches()["sharded_match_local"]
    if launches < 1:
        fail(f"{label}: the sharded kernel never launched")
    c = eng.counters
    print(f"{label}: 20 windows x 4096 topics, then churn (1 insert, 2,048 "
          f"insert_many, 2 deletes) and a rebuild, equal the host trie; "
          f"K5 launches {launches} (one per window and device); overflow rows "
          f"{c['ovf_rows']} of {c['rows']}; {n / wall:.0f} topics/s "
          f"match_batch end to end before churn (sequential windows)",
          flush=True)
    return launches


def phase_sharded_engine(results, filters) -> None:
    import torch

    from emqx_tpu_torch import workload as W
    from emqx_tpu_torch.parallel.sharded import make_mesh

    phase("sharded engine")
    pops = W.populations(len(filters), 8)
    mesh = make_mesh(devices=[torch.device("cuda", 0)] * N_SHARDS,
                     sub=N_SHARDS)
    main = {}
    results["launches"]["sharded_match"] = sharded_engine_run(
        mesh, filters, pops, "sharded engine", main)
    results["kernels"]["sharded_match"]["main_path"] = match_main_path(
        results["card"], "sharded_match_rows", main["sharded_match_rows"],
        "ShardedMatchEngine.match_batch")
    del main
    if torch.cuda.device_count() >= 2:
        sharded_engine_run(make_mesh(2, sub=2), filters, pops,
                           "sharded engine, 2 cards")
    else:
        print("multi-card: skipped, 1 card", flush=True)


# ------------------------------------------------------------ churn path

CHURN_INSERTS, CHURN_BATCH = 20_000, 256
SHARDED_CHURN_INSERTS = 5_120


def churn_filters(n: int, pops):
    """``n`` wildcard filters of the churn, fids 9,000,000 on: new
    subscribers of the load's four families (`workload.make_filters`),
    each on a key drawn uniformly from its family's population (seeded),
    so that the churn adds to each topic's fan-out about what the same
    number of background filters would."""
    import numpy as np

    n_vehicles, n_dev, n_site, n_alert = pops
    rng = np.random.default_rng(17)
    out = []
    for k, r in enumerate(rng.integers(0, 1 << 30, n)):
        kind = k % 10
        if kind < 5:
            flt = f"vehicles/v{r % n_vehicles}/sensors/#"
        elif kind < 7:
            flt = f"dev/g{r % n_dev}/+/d{r % 7}"
        elif kind < 9:
            flt = f"site/+/floor/f{r % n_site}/#"
        else:
            flt = f"alerts/z{r % n_alert}/+/+"
        out.append((flt, 9_000_000 + k))
    return out


def pct(xs, q):
    import numpy as np

    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def churn_run(eng, pops, n_inserts, label, card, record=None) -> dict:
    """20 windows of 4,096 Zipf topics, then ``n_inserts`` churn filters
    in `insert_many` batches of 256, 1 in 8 deleted again right after,
    with a window after each batch; every window against the host trie
    in the same state.  With ``record`` (a list), the launches of K1 on
    the delta automaton (the pending handles of `_flat_dispatch` made
    outside `_flat_submit`) are kept there."""
    import numpy as np

    from emqx_tpu_torch import topic as T
    from emqx_tpu_torch import workload as W

    rng = np.random.default_rng(11)
    c0 = dict(eng.counters)
    unhook = []
    if record is not None:
        in_base = [False]
        disp, sub = eng._flat_dispatch, eng._flat_submit

        def flat_dispatch(tables, enc):
            out = disp(tables, enc)
            if not in_base[0]:
                record.append(out)
            return out

        def flat_submit(snap, enc):
            in_base[0] = True
            try:
                return sub(snap, enc)
            finally:
                in_base[0] = False

        eng._flat_dispatch, eng._flat_submit = flat_dispatch, flat_submit
        unhook = ["_flat_dispatch", "_flat_submit"]

    parts = []  # per churn window: (submit ms, finish ms, residual,
    # folded, matched fids)

    def window(acc, what):
        w = W.make_topics(rng, 4096, pops)
        st = eng.index_stats()
        t = time.perf_counter()
        pend = eng.match_batch_submit(w)
        t1 = time.perf_counter()
        got = eng.match_batch_finish(pend)
        t2 = time.perf_counter()
        acc.append((t2 - t) * 1e3)
        if acc is during:
            parts.append(((t1 - t) * 1e3, (t2 - t1) * 1e3, st["residual"],
                          st["folded"], sum(map(len, got))))
        bad = sum(g != eng.match_host(T.words(topic))
                  for topic, g in zip(w, got))
        if bad:
            fail(f"{label}: {bad} topics differ from the host trie {what}")

    before, during, ins, based, ins_flags = [], [], [], [], []
    # the interpreter's collector pauses every thread: its passes over
    # the engines' millions of host objects, timed
    import gc

    gc_t0, gc_pauses = [0.0], []

    def gc_timer(phase_, info):
        if phase_ == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_pauses.append((info["generation"],
                              (time.perf_counter() - gc_t0[0]) * 1e3))

    gc.callbacks.append(gc_timer)
    try:
        for _ in range(20):
            window(before, "before churn")
        pairs = churn_filters(n_inserts, pops)
        for i in range(0, n_inserts, CHURN_BATCH):
            batch = pairs[i:i + CHURN_BATCH]
            flags = (eng._building, eng._folding)
            t = time.perf_counter()
            eng.insert_many(batch)
            ins.append((time.perf_counter() - t) * 1e3)
            ins_flags.append(flags + (eng._building, eng._folding))
            for _, fid in batch[::8]:
                if not eng.delete(fid):
                    fail(f"{label}: delete of {fid} found nothing")
            window(during, "during churn")
        settle(eng, label)
        window(during, "after the last build")
        c = {k: eng.counters[k] - c0[k] for k in eng.counters}
        stats = eng.index_stats()
        # the same filters, every one in the base: the windows' cost
        # without the delta tiers, at the churned fan-out
        eng.rebuild()
        for _ in range(20):
            window(based, "after a full rebuild")
    finally:
        gc.callbacks.remove(gc_timer)
        for name in unhook:
            delattr(eng, name)
    sub, fin, res, fold, fids = (list(x) for x in zip(*parts))
    full = [ms for g, ms in gc_pauses if g == 2]
    print(f"{label}: garbage collector over the run: {len(gc_pauses)} "
          f"passes, {sum(ms for _, ms in gc_pauses):.1f} ms in all; "
          f"{len(full)} of the oldest generation, max "
          f"{max(full, default=0):.1f} ms, each "
          f"{[round(x, 1) for x in full]}", flush=True)
    big = [w for w, r in zip(during, res) if r >= 1024]
    small = [w for w, r in zip(during, res) if r < 1024]
    print(f"{label}: churn windows, submit (tokenize, launches) p50/max "
          f"{pct(sub, 50):.3f}/{max(sub):.3f} ms, finish (sync, expand, "
          f"overlay) p50/max {pct(fin, 50):.3f}/{max(fin):.3f} ms; "
          f"residual p50/max {pct(res, 50):.0f}/{max(res)}, folded p50 "
          f"{pct(fold, 50):.0f}; window p50 with residual >= 1024: "
          f"{pct(big, 50):.3f} ms ({len(big)} windows), below: "
          f"{pct(small, 50):.3f} ms ({len(small)}); matched fids a window "
          f"p50 {pct(fids, 50):.0f}; after a full rebuild (no delta tiers) "
          f"window p50/max {pct(based, 50):.3f}/{max(based):.3f} ms "
          f"[{card}]", flush=True)
    slow_w = sorted(zip(during, parts), key=lambda e: e[0])[-3:]
    slow_i = sorted(zip(ins, ins_flags), key=lambda e: e[0])[-3:]
    print(f"{label}: slowest churn windows (ms; submit, finish, residual, "
          f"folded, fids): {[(round(w, 3), *(round(x, 3) for x in p[:2]), *p[2:]) for w, p in slow_w]}; "
          f"slowest insert_many calls (ms; building, folding before and "
          f"after): {[(round(t, 3), *f) for t, f in slow_i]}", flush=True)
    out = {
        "folds": c["folds"], "rebuilds": c["rebuilds"],
        "daut_k1": c["daut_windows"], "clip_reruns": c["clip_reruns"],
        "insert_ms": [pct(ins, 50), pct(ins, 99), max(ins)],
        "window_before_ms": [pct(before, 50), pct(before, 99), max(before)],
        "window_during_ms": [pct(during, 50), pct(during, 99), max(during)],
        "windows": len(before) + len(during), "stats": stats,
        "window_rebuilt_ms": [pct(based, 50), pct(based, 99), max(based)],
        "submit_p50_ms": pct(sub, 50), "finish_p50_ms": pct(fin, 50),
        "residual_max": max(res), "fids_p50": pct(fids, 50),
        "gc_gen2_ms": full,
    }
    print(f"{label}: {n_inserts} wildcard inserts in insert_many batches of "
          f"{CHURN_BATCH}, 1 in 8 deleted again, {out['windows']} windows of "
          f"4096 topics equal the host trie; folds {out['folds']}, rebuilds "
          f"{out['rebuilds']}, K1 launches on the delta automaton "
          f"{out['daut_k1']}, clip reruns {out['clip_reruns']}; insert_many "
          f"p50/p99/max {out['insert_ms'][0]:.3f}/{out['insert_ms'][1]:.3f}/"
          f"{out['insert_ms'][2]:.3f} ms; window p50/p99/max before churn "
          f"{'/'.join(f'{x:.3f}' for x in out['window_before_ms'])} ms, "
          f"during {'/'.join(f'{x:.3f}' for x in out['window_during_ms'])} "
          f"ms; index {out['stats']}", flush=True)
    return out


def churn_events(label, prof) -> list:
    ev = [(e["kind"], e["dur_ms"], e.get("n_filters", e.get("n_new")))
          for e in prof.events(limit=256) if e["kind"] != "upload"]
    print(f"  {label} engine events (kind, ms, filters): {ev}", flush=True)
    return ev


def settle(eng, label) -> None:
    """Join the engine's builder and fold threads (bounded)."""
    for th in (eng._build_thread, eng._fold_thread):
        if th is not None:
            th.join(300)
            if th.is_alive():
                fail(f"{label}: a builder thread did not finish")


def load_filters(eng, filters, label) -> None:
    """The 1M filters into ``eng`` in one `insert_many`, built
    synchronously before the churn.  (With the background rebuild on,
    that one call would start a build and, since the whole delta is
    residual, a fold of all 1M filters, discarded at the swap but
    leaving the delta automaton's sticky capacity class at the 1M
    build's size: the churn would then fold into 131,072 nodes, not
    4,096.)"""
    from emqx_tpu_torch.observability import Profiler

    t0 = time.perf_counter()
    background, eng.background_rebuild = eng.background_rebuild, False
    eng.insert_many([("/".join(ws), fid) for fid, ws in filters])
    if eng._delta:
        eng.rebuild()
    eng.background_rebuild = background
    settle(eng, label)
    eng.profiler = Profiler()
    print(f"{label}: {len(filters)} filters built in "
          f"{time.perf_counter() - t0:.1f} s; thresholds rebuild "
          f"{eng.rebuild_threshold}, fold {eng.delta_aut_threshold}, factor "
          f"{eng.delta_fold_factor}", flush=True)


def churn_engine(filters, background: bool):
    """A MatchEngine on the card with the 1M filters, built, at the
    default thresholds."""
    from emqx_tpu_torch.engine import MatchEngine

    eng = MatchEngine(background_rebuild=background)
    load_filters(eng, filters,
                 f"churn engine (background_rebuild={background})")
    return eng


def churn_k1(card, log, f, m) -> dict:
    """K1 on the delta automaton at the median launch of the churn run
    (by its distinct topics), and K2 (the clip rerun) on the same
    window: each held against its plain version, exactly, then timed."""
    import types

    import torch

    from emqx_tpu_torch.ops import _kernels
    from emqx_tpu_torch.ops import match_kernel as mk

    entry = sorted(log, key=lambda e: e[5])[(len(log) - 1) // 2]
    tab, flat, _, _, batch, n_uniq, _ = entry
    tabs = (tab.fp_rows, tab.node_rows, tab.salt)
    c_cap = flat.shape[0]
    b, levels = batch[0].shape
    label = (f"match_batch_compact (delta automaton, churn, median launch) "
             f"B={b} N={tab.node_rows.shape[0]} L={levels}")
    exact_equal(label, mk.match_batch_compact(
        *tabs, *batch, f_width=f, m_cap=m, c_cap=c_cap),
        mk.match_batch_compact_plain(*tabs, *batch, f_width=f, m_cap=m,
                                     c_cap=c_cap))
    exact_equal(label.replace("match_batch_compact", "match_batch"),
                mk.match_batch(*tabs, *batch, f_width=f, m_cap=m),
                mk.match_batch_plain(*tabs, *batch, f_width=f, m_cap=m))
    dev = batch[0].device
    outs = (torch.empty(c_cap, dtype=torch.int32, device=dev),
            torch.empty(b, dtype=torch.int16, device=dev),
            torch.empty(1, dtype=torch.int32, device=dev),
            torch.empty(_kernels.compact_scratch_words(b, levels, f, m),
                        dtype=torch.int64, device=dev))

    def bare():
        _kernels.match_compact(*tabs, *batch, f, m, c_cap, *outs)

    def plain():
        mk.match_batch_compact_plain(*tabs, *batch, f_width=f, m_cap=m,
                                     c_cap=c_cap)

    ms = cuda_ms(bare, 50, 10)
    dev_ms = cuda_ms(bare, 50, 10, queued=True)
    plain_ms = cuda_ms(plain, 3, 1)
    n_bytes, ops, *_ = match_bytes(types.SimpleNamespace(
        fp_rows=tabs[0], node_rows=tabs[1], salt=tabs[2]), batch, f,
        c_cap=c_cap, m_cap=m)
    b_ms, b_by = bound(n_bytes, ops)
    print(f"parity {label}: K1 and K2 (the clip rerun) equal their plain "
          f"versions ({len(log)} launches on the delta automaton, "
          f"{n_uniq} distinct topics at the median)", flush=True)
    print(f"time {label} F={f} M={m}: kernel {ms:.4f} ms (device "
          f"{dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms "
          f"by {b_by} ({n_bytes} B; {ops} ops), no library call [{card}]",
          flush=True)
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, launches=len(log), b=int(b),
                nodes=int(tab.node_rows.shape[0]), levels=int(levels))


def phase_churn(results, filters) -> None:
    """The churn path at the broker load's size: 1M background filters,
    the default thresholds, 20,000 wildcard inserts interleaved with
    windows, with the background rebuild (the broker's default) and
    then, for its insert stall, the synchronous one.  The launches of
    the background run are counted with the counts zeroed just before
    it."""
    import torch

    from emqx_tpu_torch import workload as W
    from emqx_tpu_torch.ops import match_kernel as mk
    from emqx_tpu_torch.parallel.sharded import ShardedMatchEngine, make_mesh

    phase("churn")
    card = results["card"]
    pops = W.populations(len(filters), 8)
    out = results["churn"] = {}
    eng = churn_engine(filters, True)
    log = []
    mk.reset_launches()  # counts of the churn path start here
    out["background"] = churn_run(eng, pops, CHURN_INSERTS,
                                  "churn (background rebuild)", card, log)
    launches = mk.launches()
    out["background"]["events"] = churn_events("churn (background)",
                                               eng.profiler)
    if out["background"]["folds"] < 1 or out["background"]["rebuilds"] < 1:
        fail(f"churn: no fold or no rebuild: {out['background']}")
    if not log or launches["match_batch_compact"] < len(log):
        fail(f"churn: K1 on the delta automaton launched {len(log)} times "
             f"({launches})")
    out["launches"] = launches
    results["kernels"]["match_batch_compact"]["churn"] = churn_k1(
        card, log, eng.f_width, eng.m_cap)
    del eng, log
    eng = churn_engine(filters, False)
    out["synchronous"] = churn_run(eng, pops, CHURN_INSERTS,
                                   "churn (synchronous rebuild)", card)
    out["synchronous"]["events"] = churn_events("churn (synchronous)",
                                                eng.profiler)
    del eng
    print(f"churn insert_many stall (max): background rebuild "
          f"{out['background']['insert_ms'][2]:.3f} ms, synchronous "
          f"{out['synchronous']['insert_ms'][2]:.3f} ms; p99 "
          f"{out['background']['insert_ms'][1]:.3f} against "
          f"{out['synchronous']['insert_ms'][1]:.3f} ms [{card}]",
          flush=True)
    meshes = [("4 shards of one card", make_mesh(
        devices=[torch.device("cuda", 0)] * N_SHARDS, sub=N_SHARDS))]
    if torch.cuda.device_count() >= 2:
        meshes.append(("2 cards", make_mesh(2, sub=2)))
    else:
        print("sharded churn, multi-card: skipped, 1 card", flush=True)
    for what, mesh in meshes:
        eng = ShardedMatchEngine(mesh, background_rebuild=True)
        load_filters(eng, filters, f"sharded churn engine ({what})")
        out[f"sharded, {what}"] = churn_run(
            eng, pops, SHARDED_CHURN_INSERTS,
            f"sharded churn ({what}, background rebuild)", card)
        del eng


def phase_engine(run, filters):
    import numpy as np

    from emqx_tpu_torch import topic as T
    from emqx_tpu_torch import workload as W
    from emqx_tpu_torch.engine import MatchEngine
    from emqx_tpu_torch.ops import match_kernel as mk

    phase("engine")
    pops = W.populations(len(filters), 8)
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
    log = MainPathLog(eng, ("match_compact",))
    mk.reset_launches()
    t0 = time.perf_counter()
    try:
        results = [eng.match_batch(w) for w in windows]
    finally:
        log.remove()
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
    if counts["decide_packed"] < 50:
        fail(f"engine: decide kernel launched {counts} times")
    c = eng.counters
    print(f"engine: 50 windows x 4096 topics equal the host trie; "
          f"decide_window on their {n_dec} deliveries equals the plain "
          f"version; launches {counts}; overflow rows {c['ovf_rows']} of "
          f"{c['rows']} ({c['ovf_rows'] / c['rows']:.6f}); clip reruns "
          f"{c['clip_reruns']}; {50 * 4096 / wall:.0f} topics/s "
          f"match_batch end to end (sequential windows)", flush=True)
    run["kernels"]["match_batch_compact"]["main_path"] = match_main_path(
        run["card"], "match_compact", log.log["match_compact"],
        "MatchEngine.match_batch")
    # the same filters with the Python host path, for the native times
    py = MatchEngine(native=False)
    t0 = time.perf_counter()
    py.insert_many([("/".join(ws), fid) for fid, ws in filters])
    if py._delta:
        py.rebuild()
    print(f"engine (native=False): {len(filters)} filters inserted and "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    phase_native_times(run, eng, py, filters, windows)


def match_main_path(card, name, log, what) -> dict:
    """K1 (``name`` "match_compact") or K5 ("sharded_match_rows") at the
    median batch of an engine run's launches (``log``, from
    `MainPathLog`): that window's launch held against the plain version,
    exactly, then timed (CUDA events, then queued behind a spin: the
    device time), its engine entry ``what`` (the whole window, host
    clock), the plain version and the bound."""
    import types

    import numpy as np

    from emqx_tpu_torch.ops import _kernels
    from emqx_tpu_torch.ops import match_kernel as mk

    b = np.array([e[0][0] for e in log])
    shape, entry = MainPathLog.median(log, key=lambda sh: sh[0])
    call = MainPathLog.call(entry)
    args = MainPathLog.launch_args(name, call)
    tabs, batch, (f, m) = args[:3], args[3:6], args[6:8]
    if name == "match_compact":
        c_cap = args[8]
        label = f"match_batch_compact (main path, median launch) B={shape[0]}"

        def bare():  # the launch and its two memsets
            _kernels.match_compact(*args)

        bare()
        exact_equal(label, args[9:12], mk.match_batch_compact_plain(
            *tabs, *batch, f_width=f, m_cap=m, c_cap=c_cap))

        def plain():
            mk.match_batch_compact_plain(*tabs, *batch, f_width=f, m_cap=m,
                                         c_cap=c_cap)

        n_bytes, ops, *_ = match_bytes(types.SimpleNamespace(
            fp_rows=tabs[0], node_rows=tabs[1], salt=tabs[2]), batch, f,
            c_cap=c_cap, m_cap=m)
    else:
        label = (f"sharded_match (main path, median launch) B={shape[0]} "
                 f"K={shape[1]}")

        def bare():  # the launch with its total zeroed
            args[11].zero_()
            _kernels.sharded_match_rows(*args)

        bare()
        exact_equal(label, args[8:12], mk.sharded_match_plain(
            *tabs, *batch, f_width=f, m_cap=m))

        def plain():
            mk.sharded_match_plain(*tabs, *batch, f_width=f, m_cap=m)

        n_bytes, ops, _ = sharded_bytes(*tabs, batch, f, m)
    ms = cuda_ms(bare, 50, 10)
    dev_ms = cuda_ms(bare, 50, 10, queued=True)
    wrap_ms = host_ms(call, 5, 1)
    plain_ms = cuda_ms(plain, 3, 1)
    b_ms, b_by = bound(n_bytes, ops)
    print(f"parity {label} F={f} M={m}: equals its plain version "
          f"({len(log)} launches, B median {int(np.median(b))}, max "
          f"{int(b.max())})", flush=True)
    print(f"time {label} F={f} M={m}: kernel {ms:.4f} ms (device "
          f"{dev_ms:.4f} ms), wrapper ({what}: the whole window, host "
          f"clock) {wrap_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{b_ms:.6f} ms by {b_by} ({n_bytes} B; {ops} ops), no library "
          f"call [{card}]", flush=True)
    return dict(ms=ms, device_ms=dev_ms, wrapper_ms=wrap_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                launches=len(log), b=int(shape[0]))


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


class MainPathLog:
    """What the main path hands a kernel while installed: the shape of
    every launch of the named `ops._kernels` functions (the wrappers
    look them up at each call) and the engine-entry call that made it
    (`MatchEngine.decide_window` for K3, `RulesEvaluator.eval_window`
    for K4, `MatchEngine.match_batch` for K1 and, on a
    `ShardedMatchEngine`, K5), so that the shapes can be summarised and
    the median one timed after the run."""

    # launch function -> (the entry that reaches it, as an attribute
    # path from the engine; the launch's shape from its arguments)
    HOOKS = {
        "decide": ("decide_window",  # (N, B, R)
                   lambda a: (a[1].shape[0], a[4].shape[0], a[0].shape[0])),
        "rules_eval": ("rules_evaluator.eval_window",  # (R, W)
                       lambda a: (a[0].shape[0], a[4].shape[1])),
        "match_compact": ("match_batch",  # (B, L)
                          lambda a: tuple(a[3].shape)),
        "sharded_match_rows": ("match_batch",  # (B, K)
                               lambda a: (a[3].shape[0], a[0].shape[0])),
    }

    def __init__(self, eng, kernels) -> None:
        from emqx_tpu_torch.ops import _kernels

        # k -> [(shape, (entry, its args, its keywords))]
        self.log = {k: [] for k in kernels}
        self._undo = []
        entry = {}

        def hook(obj, name, fn):
            orig = getattr(obj, name)
            self._undo.append((obj, name, orig))
            setattr(obj, name, fn(orig))

        def at_entry(k):
            def wrap(orig):
                def run(*args, **kw):
                    entry[k] = (orig, args, kw)
                    return orig(*args, **kw)
                return run
            return wrap

        def at_launch(k, shape):
            def wrap(orig):
                def run(*args):
                    self.log[k].append((shape(args), entry.pop(k, None)))
                    return orig(*args)
                return run
            return wrap

        for k in kernels:
            path, shape = self.HOOKS[k]
            *owner, meth = path.split(".")
            obj = eng
            for attr in owner:
                obj = getattr(obj, attr)
            hook(obj, meth, at_entry(k))
            hook(_kernels, k, at_launch(k, shape))

    def remove(self) -> None:
        for obj, name, orig in reversed(self._undo):
            if isinstance(obj, type(sys)):  # a module
                setattr(obj, name, orig)
            else:  # the instance attribute over its method
                delattr(obj, name)

    @staticmethod
    def median(log, key):
        """The entry whose ``key(shape)`` is the (lower) median."""
        return sorted(log, key=lambda e: key(e[0]))[(len(log) - 1) // 2]

    @staticmethod
    def call(entry):
        """The recorded engine-entry call, to be made again."""
        fn, args, kw = entry
        return lambda: fn(*args, **kw)

    @staticmethod
    def launch_args(name, call):
        """The arguments `ops._kernels.<name>` gets when ``call()``
        runs: that window's own inputs, in the engine's buffers."""
        from emqx_tpu_torch.ops import _kernels

        orig, got = getattr(_kernels, name), []

        def run(*a):
            got.append(a)
            return orig(*a)

        setattr(_kernels, name, run)
        try:
            call()
        finally:
            setattr(_kernels, name, orig)
        return got[-1]


SUB_FILTERS = ("load/#", "load/+/#", "load/+/+", "+/+/+", "#", "+/#",
               "load/+/+/#", "+/+/+/#")
N_PUB, N_MSG = 4, 1000


async def publish_load(cl, p: int, n: int, k0: int = 0) -> None:
    """Publisher ``p`` sends QoS 1 messages ``k0 .. k0 + n - 1`` on
    ``load/p{p}/m{k % 16}``, each payload ``p:k:send time``, at most 32
    unacknowledged, and returns when every PUBACK is in."""
    C = cl.C
    window = asyncio.Semaphore(32)
    n_acked = 0

    async def acks():
        nonlocal n_acked
        while n_acked < n:
            pkt = await asyncio.wait_for(cl.inbox.get(), 60)
            if pkt is None or pkt.type != C.PUBACK:
                fail(f"pub{p}: expected PUBACK, got {pkt!r}")
            n_acked += 1
            window.release()

    task = asyncio.get_running_loop().create_task(acks())
    for k in range(k0, k0 + n):
        await window.acquire()
        payload = f"{p}:{k}:{time.perf_counter()!r}".encode()
        cl.send(C.Publish(topic=f"load/p{p}/m{k % 16}", payload=payload,
                          qos=1, packet_id=k % 65535 + 1))
        if k % 32 == 0:
            await cl.writer.drain()
    await task


async def broker_load(results, filters, native: bool = True,
                      main_path: bool = True) -> dict:
    """The main path: 1M background subscriptions in the engine, 8
    subscribers (each filter matches every load topic, 8 distinct trie
    codes per topic) and 4 publishers sending 1,000 QoS 1 messages each
    over TCP through the batcher.  ``native=False`` runs the broker's
    Python host path; only a ``main_path`` run records the launches.
    Returns msgs/s in and the per-stage medians."""
    from emqx_tpu_torch.broker.listener import BrokerServer
    from emqx_tpu_torch.config import BrokerConfig, ListenerConfig
    from emqx_tpu_torch.ops import match_kernel as mk

    label = "broker" if native else "broker (native=False)"
    cfg = BrokerConfig(listeners=[ListenerConfig(bind="127.0.0.1", port=0)])
    # subscribers can fall behind the publishers' acked stream; a queue
    # that holds the whole run keeps every delivery (none may drop)
    cfg.mqtt.max_mqueue_len = 4 * N_PUB * N_MSG
    server = BrokerServer(cfg, native=native)
    eng = server.broker.router.engine
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
        print(f"{label}: {len(filters)} background filters + "
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
                         f"metrics {server.broker.metrics.all()}")
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

        log = MainPathLog(eng, ("decide",))
        decides = eng.counters["decide_windows"]
        mk.reset_launches()  # counts of the main path start here
        t0 = time.perf_counter()
        try:
            await asyncio.wait_for(asyncio.gather(
                *(consume(j, cl) for j, cl in enumerate(subs)),
                *(publish_load(cl, p, N_MSG) for p, cl in enumerate(pubs)),
            ), 600)
        finally:
            log.remove()
        wall = time.perf_counter() - t0
        launches = mk.launches()
        if main_path:
            results["launches"].update(
                (k, launches[k]) for k in ("match_batch_compact",
                                           "match_batch"))
            results["launches"]["decide_batch"] = launches["decide_packed"]
            results["main_path"]["decide"] = log.log["decide"]
        for j in range(len(subs)):
            if len(seen[j]) != expected:
                fail(f"sub{j} got {len(seen[j])} of {expected}")
        if min(launches[k] for k in ("match_batch_compact", "match_batch",
                                     "decide_packed")) < 1:
            fail(f"a kernel of the publish path never launched: {launches}")
        decides = eng.counters["decide_windows"] - decides
        if launches["decide_packed"] != decides:
            fail(f"{launches['decide_packed']} K3 launches for {decides} "
                 f"decide windows")
        dropped = server.broker.metrics["delivery.dropped"]
        if dropped:
            fail(f"broker dropped {dropped} deliveries")
        lat.sort()
        p50 = lat[len(lat) // 2] * 1e3
        p99 = lat[int(len(lat) * 0.99)] * 1e3
        c = eng.counters
        print(f"{label}: {expected} QoS 1 messages from {N_PUB} publishers "
              f"each delivered exactly once to {len(subs)} subscribers "
              f"({expected * len(subs)} deliveries) in {wall:.3f} s: "
              f"{expected / wall:.1f} msgs/s in, "
              f"{expected * len(subs) / wall:.1f} deliveries/s; delivery "
              f"latency p50 {p50:.3f} ms p99 {p99:.3f} ms; "
              f"{c['dev_windows']} match windows, {c['clip_reruns']} clip "
              f"reruns, {c['decide_windows']} decide windows; launches "
              f"{launches} [{results['card']}]", flush=True)
        stages = stage_medians(label, server.broker.profiler)
        for cl in subs + pubs:
            await cl.close()
    finally:
        await server.stop()
    return {"msgs_per_s": expected / wall, "p50_ms": p50, "p99_ms": p99,
            "stages": stages}


RULES_PUB, RULES_MSG = 4, 1000


async def publish_items(cl, items) -> None:
    """Publish ``items`` (topic, payload) at QoS 1, at most 32
    unacknowledged, and return when every PUBACK is in."""
    C = cl.C
    window = asyncio.Semaphore(32)
    n_acked = 0

    async def acks():
        nonlocal n_acked
        while n_acked < len(items):
            pkt = await asyncio.wait_for(cl.inbox.get(), 60)
            if pkt is None or pkt.type != C.PUBACK:
                fail(f"{cl.client_id}: expected PUBACK, got {pkt!r}")
            n_acked += 1
            window.release()

    task = asyncio.get_running_loop().create_task(acks())
    for k, (topic, payload) in enumerate(items):
        await window.acquire()
        cl.send(C.Publish(topic=topic, payload=payload, qos=1,
                          packet_id=k % 65535 + 1))
        if k % 32 == 0:
            await cl.writer.drain()
    await task
REPUBLISH_SQL = ('SELECT payload.v AS v, topic, clientid FROM '
                 '"vehicles/+/sensors/#" WHERE payload.v >= 55')


class Capture:
    """An in-process MQTT 3.1.1 subscriber on a broker's channel: the
    bytes its connection would write, as the TCP client reads them.
    ``flt`` is one filter at QoS 0, or a list of ``(filter, qos)``."""

    def __init__(self, broker, client_id: str, flt) -> None:
        from emqx_tpu_torch.broker.channel import Channel
        from emqx_tpu_torch.codec import mqtt as C

        self.raw = bytearray()

        def send(pkts):
            for p in pkts:
                self.raw += C.serialize(p, self.ch.version)

        self.ch = Channel(broker, send=send, close=lambda reason: None)
        for pkt in (C.Connect(client_id=client_id, proto_ver=C.MQTT_V4),
                    C.Subscribe(packet_id=1, subscriptions=[
                        C.Subscription(topic_filter=f, qos=q)
                        for f, q in ([(flt, 0)] if isinstance(flt, str)
                                     else flt)])):
            for q in C.StreamParser(version=C.MQTT_V4).feed(
                    C.serialize(pkt, C.MQTT_V4)):
                self.ch.handle_in(q)


def add_fleet_rules(broker, fired):
    """Config 4's 100 rules: 99 fleet rules (6 of them not lowerable)
    with actions that record their calls, and one that republishes."""
    from emqx_tpu_torch import workload as W
    from emqx_tpu_torch.rules.engine import FunctionAction, RepublishAction

    for rid, sql in W.make_rules(99, n_fallback=6):
        broker.rules.add_rule(rid, sql, actions=[FunctionAction(
            lambda sel, msg, rid=rid: fired.append(
                (rid, msg.topic, msg.payload, sorted(sel.items()))))])
    broker.rules.add_rule("republish", REPUBLISH_SQL, actions=[
        RepublishAction(topic="fleet/alerts/${clientid}",
                        payload='{"v": ${v}, "from": "${topic}"}')])


async def rules_load(results, filters) -> None:
    """The rules path: the broker with 1M background filters and config
    4's 100 rules; 4 publishers send 1,000 QoS 1 JSON telemetry messages
    each over TCP; a subscriber holds the republish topic.  Then the
    same windows run through a second broker pinned to the scalar
    interpreter referee: action calls, per-rule counters and the
    republished bytes must be equal."""
    import dataclasses

    import numpy as np

    from emqx_tpu_torch import workload as W
    from emqx_tpu_torch.broker.broker import Broker
    from emqx_tpu_torch.broker.listener import BrokerServer
    from emqx_tpu_torch.config import BrokerConfig, ListenerConfig
    from emqx_tpu_torch.ops import match_kernel as mk

    cfg = BrokerConfig(listeners=[ListenerConfig(bind="127.0.0.1", port=0)])
    server = BrokerServer(cfg)
    broker = server.broker
    eng = broker.router.engine
    t0 = time.perf_counter()
    fired = []
    add_fleet_rules(broker, fired)
    # the bulk insert rebuilds the automaton: rule and background
    # filters go onto the card together
    eng.insert_many([("/".join(ws), fid) for fid, ws in filters])
    if eng._delta:
        eng.rebuild()
    # record each publish window as dispatch receives it (republished
    # messages are published from inside a window, the server's $SYS
    # heartbeats in windows of their own: neither recorded), and the
    # time the rule engine takes per window
    windows, lap = [], [0.0, 0]
    depth = [0]
    dispatch, apply_batch = broker.publish_dispatch, broker.rules.apply_batch

    def recording_dispatch(msgs, matched, rec=None):
        if depth[0] == 0 and not all(m.sys for m in msgs):
            windows.append([dataclasses.replace(m) for m in msgs])
        depth[0] += 1
        try:
            return dispatch(msgs, matched, rec)
        finally:
            depth[0] -= 1

    def timed_apply_batch(items, rec=None):
        t = time.perf_counter()
        try:
            return apply_batch(items, rec=rec)
        finally:
            lap[0] += time.perf_counter() - t
            lap[1] += 1

    broker.publish_dispatch = recording_dispatch
    broker.rules.apply_batch = timed_apply_batch
    await server.start()
    try:
        print(f"rules broker: {len(filters)} background filters + 100 rules "
              f"({broker.rules.stats()['lowered']} lowered) on the card "
              f"({eng._aut.n_nodes} nodes) in {time.perf_counter() - t0:.1f} s",
              flush=True)
        watcher = Client(server.port, "watcher")
        await watcher.connect()
        await watcher.subscribe("fleet/alerts/#", 0)
        pubs = []
        for p in range(RULES_PUB):
            cl = Client(server.port, f"rpub{p}")
            await cl.connect()
            pubs.append(cl)
        rng = np.random.default_rng(3)
        pops = W.populations(len(filters), 8)
        work = [list(zip(W.make_topics(rng, RULES_MSG, pops),
                         W.make_rule_payloads(rng, RULES_MSG)))
                for _ in pubs]
        log = MainPathLog(eng, ("rules_eval",))
        dev_windows = broker.rules.stats().get("dev_windows", 0)
        mk.reset_launches()  # counts of the rules path start here
        t0 = time.perf_counter()
        try:
            await asyncio.wait_for(asyncio.gather(
                *(publish_items(cl, items) for cl, items in zip(pubs, work))),
                600)
            wall = time.perf_counter() - t0
            launches = mk.launches()
            await asyncio.sleep(0.5)  # the watcher's last republishes
        finally:
            log.remove()
        results["launches"]["rules_eval_batch"] = launches[
            "rules_eval_lowered"]
        results["main_path"]["rules"] = log.log["rules_eval"]
        n_msgs = sum(len(w) for w in windows)
        if n_msgs != RULES_PUB * RULES_MSG:
            fail(f"rules broker: dispatched {n_msgs} messages")
        st = broker.rules.stats()
        dev_windows = st["dev_windows"] - dev_windows
        if launches["rules_eval_lowered"] < 1 or dev_windows < 1:
            fail(f"rules broker: the rules kernel never launched: "
                 f"{launches} {st}")
        if len(log.log["rules_eval"]) != dev_windows:
            fail(f"rules broker: {len(log.log['rules_eval'])} K4 launches for "
                 f"{dev_windows} rules windows")
        counters = {rid: (r.matched, r.passed, r.failed, r.actions_success,
                          r.actions_failed)
                    for rid, r in broker.rules.rules.items()}
        tcp_bytes = bytes(watcher.raw)
        print(f"rules broker: {n_msgs} QoS 1 messages in {len(windows)} "
              f"windows in {wall:.3f} s: {n_msgs / wall:.1f} msgs/s in; "
              f"rules lap {lap[0] * 1e3 / max(lap[1], 1):.3f} ms per window "
              f"({lap[1]} windows, {lap[0]:.3f} s); {len(fired)} action "
              f"calls; {sum(c[1] for c in counters.values())} rule passes "
              f"of {sum(c[0] for c in counters.values())} matches; "
              f"republished {counters['republish'][3]}; matrix windows "
              f"{st['matrix_windows']}, fallback rule evals "
              f"{st['fallback_rule_evals']}; launches {launches} "
              f"[{results['card']}]", flush=True)
        results["native"]["rules_broker"] = {
            "msgs_per_s": n_msgs / wall,
            "stages": stage_medians("rules broker", broker.profiler)}
        for cl in pubs + [watcher]:
            await cl.close()
    finally:
        await server.stop()

    # the referee: the same windows, the same rules, scalar interpreter
    ref_fired = []
    ref = Broker()
    ref.rules.eval_force = "scalar"
    add_fleet_rules(ref, ref_fired)
    ref_watch = Capture(ref, "watcher", "fleet/alerts/#")
    t0 = time.perf_counter()
    for w in windows:
        ref.publish_many(w)
    ref_counters = {rid: (r.matched, r.passed, r.failed, r.actions_success,
                          r.actions_failed)
                    for rid, r in ref.rules.rules.items()}
    if ref.rules.stats()["matrix_windows"]:
        fail("the referee broker used the matrix path")
    if ref_counters != counters:
        bad = [k for k in counters if counters[k] != ref_counters.get(k)]
        fail(f"rules broker: per-rule counters differ from the scalar "
             f"referee for {bad[:5]}")
    if ref_fired != fired:
        k = next(i for i, (a, b) in enumerate(zip(fired, ref_fired))
                 if a != b) if len(fired) == len(ref_fired) else -1
        fail(f"rules broker: action calls differ from the scalar referee "
             f"({len(fired)} vs {len(ref_fired)}, first at {k})")
    if bytes(ref_watch.raw) != tcp_bytes:
        fail(f"rules broker: republished bytes differ from the scalar "
             f"referee ({len(tcp_bytes)} vs {len(ref_watch.raw)} B)")
    print(f"rules broker: the scalar referee over the same {len(windows)} "
          f"windows ({time.perf_counter() - t0:.1f} s) gives the same "
          f"{len(fired)} action calls in the same order, the same per-rule "
          f"counters and the same {len(tcp_bytes)} bytes to the republish "
          f"subscriber", flush=True)


SINKS_AVRO = 256  # the fifth publisher's Avro records


async def sinks_load(results, filters) -> dict:
    """The rule egress: the rules broker's world (1M background filters,
    config 4's 99 fleet rules, every one ``SELECT *``) with sink and
    aggregate actions (`workload.add_sink_rules`: 80 rules sink JSON
    rows and 13 a template into the recording resource ``fleet``, 6
    push into a JSONL aggregator of 512 records) and the Avro rule; a
    subscriber on ``#``; 4 publishers send 1,000 QoS 1 JSON telemetry
    messages each and a fifth 256 Avro state records over TCP.  Then
    the same windows run through a second broker pinned to the scalar
    SELECT lane and the batched lane in process, in turns: their sink
    queries, aggregator records, action metrics and per-rule counters
    must equal the TCP run's."""
    import dataclasses
    import statistics

    import numpy as np

    from emqx_tpu_torch import workload as W
    from emqx_tpu_torch.broker.broker import Broker
    from emqx_tpu_torch.broker.listener import BrokerServer
    from emqx_tpu_torch.config import BrokerConfig, ListenerConfig
    from emqx_tpu_torch.ops import match_kernel as mk
    from emqx_tpu_torch.schema_registry import AvroSchema, global_registry

    global_registry().add(W.FLEET_AVRO_NAME, "avro", W.FLEET_AVRO)
    n_in = RULES_PUB * RULES_MSG + SINKS_AVRO
    cfg = BrokerConfig(listeners=[ListenerConfig(bind="127.0.0.1", port=0)])
    cfg.mqtt.max_mqueue_len = 2 * n_in
    server = BrokerServer(cfg)
    broker = server.broker
    eng = broker.router.engine
    t0 = time.perf_counter()
    bodies = []
    agg = W.sink_aggregator(bodies)
    broker.aggregators.append(agg)
    W.add_sink_rules(broker, agg)
    eng.insert_many([("/".join(ws), fid) for fid, ws in filters])
    if eng._delta:
        eng.rebuild()
    windows = []
    depth = [0]
    dispatch = broker.publish_dispatch

    def recording_dispatch(msgs, matched, rec=None):
        if depth[0] == 0 and not all(m.sys for m in msgs):
            windows.append([dataclasses.replace(m) for m in msgs])
        depth[0] += 1
        try:
            return dispatch(msgs, matched, rec)
        finally:
            depth[0] -= 1

    broker.publish_dispatch = recording_dispatch
    sink = W.RecordingSink()
    await server.start()
    try:
        worker = await broker.resources.create(
            W.SINK_ID, sink, batch_records=512, batch_age=0.05,
            max_buffer=1 << 20)
        print(f"sinks broker: {len(filters)} background filters + 100 "
              f"rules ({broker.rules.stats()['select_lowered']} with a "
              f"lowered SELECT) on the card ({eng._aut.n_nodes} nodes) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        watcher = Client(server.port, "sink-watch")
        await watcher.connect()
        await watcher.subscribe("#", 0)
        pubs = []
        for p in range(RULES_PUB + 1):
            cl = Client(server.port, f"spub{p}")
            await cl.connect()
            pubs.append(cl)
        rng = np.random.default_rng(12)
        pops = W.populations(len(filters), 8)
        work = [list(zip(W.make_topics(rng, RULES_MSG, pops),
                         W.make_rule_payloads(rng, RULES_MSG)))
                for _ in range(RULES_PUB)]
        avro = AvroSchema(W.FLEET_AVRO)
        work.append([(f"avro/{r['vin']}/state", avro.encode(r))
                     for r in W.make_avro_records(rng, SINKS_AVRO)])
        seen = [0]

        async def watch():
            while seen[0] < n_in:
                pkt = await asyncio.wait_for(watcher.inbox.get(), 60)
                if pkt is None:
                    fail("sinks broker: the watcher was disconnected")
                if pkt.type == watcher.C.PUBLISH:
                    seen[0] += 1

        st0 = broker.rules.stats()
        mk.reset_launches()  # counts of the sinks path start here
        t0 = time.perf_counter()
        await asyncio.wait_for(asyncio.gather(watch(), *(
            publish_items(cl, items) for cl, items in zip(pubs, work))), 600)
        wall = time.perf_counter() - t0
        launches = mk.launches()
        t_deadline = time.perf_counter() + 60
        while len(worker) or len(sink.queries) < worker.stats["matched"]:
            if time.perf_counter() > t_deadline:
                fail(f"sinks broker: the sink did not drain: {worker.stats}")
            await asyncio.sleep(0.005)
        wall_sink = time.perf_counter() - t0
        st = broker.rules.stats()
        wstats = dict(worker.stats)
        breaker = worker.breaker_open
        counters = {rid: (r.matched, r.passed, r.failed, r.actions_success,
                          r.actions_failed)
                    for rid, r in broker.rules.rules.items()}
        metrics = {k: broker.metrics[k] for k in (
            "actions.success", "actions.failed", "actions.batched")}
        stages = stage_medians("sinks broker", broker.profiler)
        for cl in pubs + [watcher]:
            await cl.close()
    finally:
        await server.stop()
    agg.flush()
    queries = list(sink.queries)
    n_msgs = sum(len(w) for w in windows)
    if n_msgs != n_in:
        fail(f"sinks broker: dispatched {n_msgs} of {n_in} messages")
    dev_windows = st["dev_windows"] - st0["dev_windows"]
    k4 = launches["rules_eval_lowered"]
    for k in ("match_batch_compact", "decide_packed", "rules_eval_lowered"):
        if launches[k] < 1:
            fail(f"sinks broker: {k} never launched: {launches}")
    if k4 != dev_windows:
        fail(f"sinks broker: {k4} K4 launches for {dev_windows} rules "
             f"windows")
    avro_hits = counters["avro"][1]
    if st["select_lowered"] != 99:
        fail(f"sinks broker: select_lowered {st['select_lowered']}")
    if not st["select_batched_rows"] > 0:
        fail("sinks broker: no row took the batched SELECT lane")
    scalar_rows = st["select_scalar_rows"] - st0["select_scalar_rows"]
    if scalar_rows != avro_hits or avro_hits != SINKS_AVRO:
        fail(f"sinks broker: {scalar_rows} scalar rows, {avro_hits} Avro "
             f"rule hits of {SINKS_AVRO}")
    if wstats["dropped"] or wstats["failed"] or breaker \
            or metrics["actions.failed"]:
        fail(f"sinks broker: the sink dropped or failed: {wstats}, "
             f"breaker {breaker}, {metrics}")
    if seen[0] != n_in:
        fail(f"sinks broker: the subscriber got {seen[0]} of {n_in}")
    if not any(q.startswith('{"d": {"vin"') for q in queries):
        fail("sinks broker: no Avro record decoded")
    hist = {}
    for b in sink.batches:
        hist[b] = hist.get(b, 0) + 1
    lap = stages.get("rules", {}).get("ring_median_ms")
    sub = {k: stages.get(k, {}).get("ring_median_ms")
           for k in ("rules_extract", "rules_eval")}
    tripped = bool(st["select_ewma_off"] or st["select_batch_disabled"])
    print(f"sinks broker: {n_in} QoS 1 messages ({SINKS_AVRO} Avro) in "
          f"{len(windows)} windows in {wall:.3f} s: {n_in / wall:.1f} msgs/s "
          f"in; {len(queries)} sink queries drained in {wall_sink:.3f} s: "
          f"{len(queries) / wall_sink:.1f} queries/s; {wstats['batches']} "
          f"batches flushed, sizes {dict(sorted(hist.items()))}; "
          f"{len(bodies)} aggregator objects; rules lap median {lap} ms "
          f"(rules_extract {sub['rules_extract']} ms, rules_eval "
          f"{sub['rules_eval']} ms); batched rows "
          f"{st['select_batched_rows']}, scalar rows {scalar_rows}; EWMA "
          f"gate tripped: {tripped} (batched {st['select_batched_us_ewma']} "
          f"us/row, scalar {st['select_scalar_us_ewma']} us/row); launches "
          f"{launches} [{results['card']}]", flush=True)

    # the same windows in process through fresh brokers on the card, in
    # turns: the scalar SELECT lane (the referee) and the batched lane.
    # Each must give the TCP run's output; their rules laps compare the
    # lanes on one thread (the TCP run's lap shares the GIL with the
    # next windows' match)
    async def replay(force):
        b = Broker()
        b.rules.select_force = force
        out_bodies = []
        b_agg = W.sink_aggregator(out_bodies)
        W.add_sink_rules(b, b_agg)
        b.router.engine.rebuild()
        b_sink = W.RecordingSink()
        w = await b.resources.create(W.SINK_ID, b_sink, batch_records=512,
                                     batch_age=0.05, max_buffer=1 << 20)
        for win in windows:
            b.publish_many([dataclasses.replace(m) for m in win])
        while len(b_sink.queries) < w.stats["matched"]:
            await asyncio.sleep(0.005)
        await b.resources.stop_all()
        b_agg.flush()
        ring = b.profiler.windows(limit=10**6)
        return {"queries": b_sink.queries, "records": b"".join(out_bodies),
                "counters": {rid: (r.matched, r.passed, r.failed,
                                   r.actions_success, r.actions_failed)
                             for rid, r in b.rules.rules.items()},
                "metrics": {k: b.metrics[k] for k in (
                    "actions.success", "actions.failed")},
                "stats": b.rules.stats(),
                # exact medians over the replay's windows, ms
                "lap": {k: statistics.median(
                    r["stages_us"].get(k, 0.0) for r in ring) / 1e3
                    for k in ("rules", "rules_extract", "rules_eval")}}

    t0 = time.perf_counter()
    laps = {"scalar": [], "batched": []}
    records = b"".join(bodies)
    for force in ("scalar", "batched", "batched", "scalar"):
        r = await asyncio.wait_for(replay(force), 120)
        what = f"the {force} lane in process"
        batched_rows = r["stats"]["select_batched_rows"]
        if (force == "scalar") != (batched_rows == 0):
            fail(f"sinks broker: {what} had {batched_rows} batched rows")
        if r["counters"] != counters:
            bad = [k for k in counters
                   if counters[k] != r["counters"].get(k)]
            fail(f"sinks broker: per-rule counters of {what} differ for "
                 f"{bad[:5]}")
        if r["queries"] != queries:
            k = next((i for i, (x, y) in enumerate(zip(queries,
                                                       r["queries"]))
                      if x != y), -1)
            fail(f"sinks broker: sink queries of {what} differ "
                 f"({len(queries)} vs {len(r['queries'])}, first at {k})")
        if r["records"] != records:
            fail(f"sinks broker: aggregator records of {what} differ")
        if {k: metrics[k] for k in r["metrics"]} != r["metrics"]:
            fail(f"sinks broker: action metrics {metrics} vs {what}'s "
                 f"{r['metrics']}")
        laps[force].append(r["lap"])
    n_records = records.count(b"\n")

    def lap_s(force, k):
        return ", ".join(f"{x.get(k, 0.0):.3f}" for x in laps[force])

    print(f"sinks broker: the same {len(windows)} windows in process on the "
          f"card, in turns (scalar, batched, batched, scalar; "
          f"{time.perf_counter() - t0:.1f} s), each give the same "
          f"{len(queries)} sink queries in the same order, the same "
          f"{n_records} aggregator records, the same action metrics and "
          f"per-rule counters; rules lap median ms scalar "
          f"{lap_s('scalar', 'rules')}"
          f", batched {lap_s('batched', 'rules')} (rules_extract scalar "
          f"{lap_s('scalar', 'rules_extract')}, batched "
          f"{lap_s('batched', 'rules_extract')}); the TCP run's "
          f"{stages.get('rules', {}).get('p50_ms')} ms [{results['card']}]",
          flush=True)
    for name, k in (("match_batch_compact", "match_batch_compact"),
                    ("decide_batch", "decide_packed"),
                    ("rules_eval_batch", "rules_eval_lowered")):
        results["kernels"][name]["sinks"] = {"launches": launches[k]}
    return {"msgs_per_s": n_in / wall, "queries_per_s":
            len(queries) / wall_sink, "queries": len(queries),
            "batches": wstats["batches"], "batch_sizes": hist,
            "aggregator_objects": len(bodies), "rules_lap_ms": lap,
            **{f"{k}_ms": v for k, v in sub.items()},
            "rules_lap_p50_ms": stages.get("rules", {}).get("p50_ms"),
            "in_process_laps": laps,
            "select_batched_rows": st["select_batched_rows"],
            "select_scalar_rows": scalar_rows, "ewma_tripped": tripped,
            "k4_launches": k4, "windows": len(windows)}


def phase_sinks_broker(results, filters) -> None:
    phase("sinks broker")
    results["sinks"] = asyncio.run(sinks_load(results, filters))


# ------------------------------------------------------- management API

MGMT_REST, MGMT_HTTP_THREADS = 2000, 4  # REST publishes, client threads
MGMT_LIGHT_GAP_S = 0.01  # the light client's publish gap during /topics


def mgmt_concrete(template: str) -> str:
    return re.sub(r"\{(\w+)(?::[^}]+)?\}", "x1", template)


async def mgmt_load(results, filters) -> dict:
    """The broker phase's world on the card (1M background filters, its
    8 subscribers) with the management API on: admin login (one
    PBKDF2), an API key of each role and a viewer user, config 4's 100
    rules over REST (no actions: K4 runs their WHERE), then 4 MQTT
    publishers x 1,000 QoS 1 fleet messages while 4 client threads send
    2,000 ``POST /api/v5/publish`` at QoS 1 under the publisher key;
    the read-back routes and the scrape; ``GET /api/v5/topics`` over
    the 1M filters beside a light client's QoS 1 every 10 ms; the roles'
    refusals, an unported route's 501 and three ctl subprocesses."""
    import tempfile
    import threading

    import numpy as np

    from emqx_tpu_torch import mgmt as PM
    from emqx_tpu_torch import topic as T
    from emqx_tpu_torch import workload as W
    from emqx_tpu_torch.broker.listener import BrokerServer
    from emqx_tpu_torch.broker.session import SubOpts
    from emqx_tpu_torch.config import BrokerConfig, ListenerConfig
    from emqx_tpu_torch.ops import match_kernel as mk

    card = results["card"]
    tmp = tempfile.mkdtemp(prefix="emqx-mgmt-")
    cfg = BrokerConfig(listeners=[ListenerConfig(bind="127.0.0.1", port=0)])
    cfg.mqtt.max_mqueue_len = 1 << 20
    cfg.sys.enable = False
    cfg.api.enable, cfg.api.port, cfg.api.data_dir = True, 0, tmp
    server = BrokerServer(cfg)
    broker = server.broker
    eng = broker.router.engine
    t0 = time.perf_counter()
    eng.insert_many([("/".join(ws), fid) for fid, ws in filters])
    await server.start()
    loop = asyncio.get_running_loop()
    port = server.api.port
    clients, subs, pubs = [], [], []

    def api(auth=None):
        cl = W.ApiClient(port, auth)
        clients.append(cl)
        return cl

    async def call(cl, *a, **kw):
        return await loop.run_in_executor(None, lambda: cl.call(*a, **kw))

    def expect(what, got, want):
        if got != want:
            fail(f"mgmt broker: {what}: {got!r}, expected {want!r}")

    try:
        admin = api()
        t1 = time.perf_counter()
        admin.auth = await loop.run_in_executor(None, admin.login)
        login_ms = (time.perf_counter() - t1) * 1e3
        keys = {}
        for role in ("administrator", "viewer", "publisher"):
            st, _, body = await call(admin, "POST", "/api/v5/api_key",
                                     {"name": f"k-{role}", "role": role})
            expect(f"POST api_key {role}", st, 201)
            keys[role] = (body["api_key"], body["api_secret"])
        st, _, _ = await call(admin, "POST", "/api/v5/users", {
            "username": "auditor", "password": "s3cret", "role": "viewer"})
        expect("POST users", st, 201)
        for rid, sql in W.make_rules(100, n_fallback=6):
            st, _, body = await call(admin, "POST", "/api/v5/rules",
                                     {"id": rid, "sql": sql})
            expect(f"POST rules {rid}", st, 201)
        st, _, body = await call(admin, "GET", "/api/v5/rules")
        if body["stats"]["lowered"] != 94:
            fail(f"mgmt broker: {body['stats']['lowered']} rules lowered")
        for j, flt in enumerate(SUB_FILTERS):
            cl = Client(server.port, f"msub{j}")
            await cl.connect()
            await cl.subscribe(flt, 1)
            subs.append(cl)
        eng.rebuild()  # subscribers' and rules' filters onto the card
        print(f"mgmt broker: {len(filters)} background filters + "
              f"{len(SUB_FILTERS)} subscribers + 100 rules over REST on the "
              f"card ({eng._aut.n_nodes} nodes) in "
              f"{time.perf_counter() - t0:.1f} s; login {login_ms:.3f} ms "
              f"(one PBKDF2) [{card}]", flush=True)
        for p in range(N_PUB):
            cl = Client(server.port, f"mpub{p}")
            await cl.connect()
            pubs.append(cl)
        rng = np.random.default_rng(21)
        pops = W.populations(len(filters), 8)
        work = [list(zip(W.make_topics(rng, N_MSG, pops),
                         W.make_rule_payloads(rng, N_MSG)))
                for _ in range(N_PUB)]
        rest = list(zip(W.make_topics(rng, MGMT_REST, pops),
                        W.make_rule_payloads(rng, MGMT_REST)))
        topics = [t for items in work for t, _ in items] + \
            [t for t, _ in rest] + ["warm/up"]
        want = [sum(T.match(t, f) for t in topics) for f in SUB_FILTERS]
        fan = {t: sum(T.match(t, f) for f in SUB_FILTERS)
               for t in set(topics)}
        pub_key = W.basic_auth(*keys["publisher"])
        # warm the publisher key: its first Basic request runs one
        # PBKDF2 on the loop; later ones compare a cached digest
        warm = api(pub_key)
        st, _, _ = await call(warm, "POST", "/api/v5/publish",
                              {"topic": "warm/up", "payload": "x"})
        expect("warm publish", st, 200)
        got = [0] * len(subs)

        async def consume(j, cl):
            while got[j] < want[j]:
                pkt = await asyncio.wait_for(cl.inbox.get(), 120)
                if pkt is None:
                    fail(f"mgmt broker: msub{j} disconnected")
                if pkt.type == cl.C.PUBLISH:
                    if pkt.qos:
                        cl.send(cl.C.Puback(packet_id=pkt.packet_id))
                    got[j] += 1

        lat, bad, ends = [], [], []

        def rest_thread(items):
            cl = W.ApiClient(port, pub_key)
            try:
                for topic, payload in items:
                    t = time.perf_counter()
                    st, _, body = cl.call("POST", "/api/v5/publish", {
                        "topic": topic, "payload": payload.decode(),
                        "qos": 1})
                    lat.append(time.perf_counter() - t)
                    if st != 200 or body["delivered"] != fan[topic]:
                        bad.append((topic, st, body))
            finally:
                ends.append(time.perf_counter())
                cl.close()

        st0 = broker.rules.stats()
        dec0 = eng.counters["decide_windows"]
        mk.reset_launches()  # counts of the mgmt path start here
        t0 = time.perf_counter()
        threads = [threading.Thread(target=rest_thread,
                                    args=(rest[i::MGMT_HTTP_THREADS],))
                   for i in range(MGMT_HTTP_THREADS)]
        for th in threads:
            th.start()

        async def mqtt_side():
            await asyncio.gather(*(publish_items(cl, items)
                                   for cl, items in zip(pubs, work)))
            return time.perf_counter() - t0

        mqtt_wall, *_ = await asyncio.wait_for(asyncio.gather(
            mqtt_side(), *(consume(j, cl) for j, cl in enumerate(subs)),
            loop.run_in_executor(None, lambda: [th.join()
                                                for th in threads])), 600)
        wall = time.perf_counter() - t0
        rest_wall = max(ends) - t0
        launches = mk.launches()
        st1 = broker.rules.stats()
        if bad:
            fail(f"mgmt broker: {len(bad)} REST publishes failed or "
                 f"delivered other counts, first {bad[0]}")
        if len(lat) != MGMT_REST:
            fail(f"mgmt broker: {len(lat)} of {MGMT_REST} REST publishes")
        if got != want:
            fail(f"mgmt broker: subscribers got {got}, expected {want}")
        rules_windows = st1["dev_windows"] - st0["dev_windows"]
        for k in ("match_batch_compact", "decide_packed",
                  "rules_eval_lowered"):
            if launches[k] < 1:
                fail(f"mgmt broker: {k} never launched: {launches}")
        if launches["rules_eval_lowered"] != rules_windows:
            fail(f"mgmt broker: {launches['rules_eval_lowered']} K4 "
                 f"launches for {rules_windows} rules windows")
        decides = eng.counters["decide_windows"] - dec0
        if launches["decide_packed"] != decides:
            fail(f"mgmt broker: {launches['decide_packed']} K3 launches "
                 f"for {decides} decide windows")
        lat.sort()
        p50, p99 = lat[len(lat) // 2] * 1e3, lat[int(len(lat) * .99)] * 1e3
        n_mqtt = N_PUB * N_MSG
        print(f"mgmt broker: {MGMT_REST} REST publishes (QoS 1, "
              f"{MGMT_HTTP_THREADS} keep-alive client threads, the publisher "
              f"key) beside {n_mqtt} MQTT QoS 1 messages from {N_PUB} "
              f"publishers, each delivered to the {sum(want)} expected "
              f"subscriptions: REST {MGMT_REST / rest_wall:.1f} publishes/s, "
              f"one request p50 {p50:.3f} ms p99 {p99:.3f} ms; MQTT "
              f"{n_mqtt / mqtt_wall:.1f} msgs/s in ({mqtt_wall:.3f} s; all "
              f"{wall:.3f} s); {rules_windows} rules windows, {decides} "
              f"decide windows; launches {launches} [{card}]", flush=True)

        # read back
        reads = {}
        for path in ("/api/v5/rules", "/api/v5/stats", "/api/v5/metrics",
                     "/api/v5/clients", "/api/v5/subscriptions",
                     "/api/v5/nodes", "/api/v5/profiler?windows=32",
                     "/api/v5/profiler/trace"):
            st, ct, body = await call(admin, "GET", path)
            expect(f"GET {path}", (st, ct),
                   (200, "application/json; charset=utf-8"))
            reads[path] = body
        matched = sum(r["matched"] for r in reads["/api/v5/rules"]["data"])
        if not matched or reads["/api/v5/metrics"]["messages.received"] \
                < n_mqtt:
            fail(f"mgmt broker: rules matched {matched}, metrics "
                 f"{reads['/api/v5/metrics']['messages.received']}")
        if len(reads["/api/v5/profiler?windows=32"]["windows"]) != 32 or \
                not reads["/api/v5/profiler/trace"]["traceEvents"]:
            fail("mgmt broker: the profiler routes are empty")
        t1 = time.perf_counter()
        st, ct, text = await call(admin, "GET", "/metrics")
        scrape_ms = (time.perf_counter() - t1) * 1e3
        expect("GET /metrics", (st, ct), (200, "text/plain; charset=utf-8"))
        fams, _ = W.prom_parse(text)
        hist = sum(k == "histogram" for k in fams.values())
        print(f"mgmt broker: /metrics scrape {scrape_ms:.3f} ms, "
              f"{len(text.encode())} bytes, {len(fams)} families ({hist} "
              f"histograms), strict parse ok (one TYPE a family, +Inf == "
              f"_count); rules matched {matched} [{card}]", flush=True)

        # GET /api/v5/topics over the 1M filters beside a light client:
        # the filters' distinct strings become routes, held by 1,000
        # offline clients (no fleet topic reaches light/x)
        t1 = time.perf_counter()
        routes = sorted({"/".join(ws) for _, ws in filters})
        for i, flt in enumerate(routes):
            broker.router.subscribe(f"bg{i % 1000}", flt, SubOpts(qos=0))
        eng.rebuild()
        print(f"mgmt broker: the {len(routes)} distinct routes of the "
              f"{len(filters)} filters subscribed by 1,000 offline clients "
              f"and rebuilt in {time.perf_counter() - t1:.1f} s [{card}]",
              flush=True)
        # the light client runs its own loop in a thread, so the broker
        # loop's stall shows in its PUBACK waits
        waits, errors = [], []
        stop, ready = threading.Event(), threading.Event()

        def light_thread():
            async def run():
                light = Client(server.port, "mlight")
                await light.connect()
                ready.set()
                k = 0
                while not stop.is_set():
                    k += 1
                    t = time.perf_counter()
                    light.send(light.C.Publish(
                        topic="light/x", payload=b"l", qos=1,
                        packet_id=k % 65535 + 1))
                    await light.expect(light.C.PUBACK, 60)
                    waits.append((t, time.perf_counter() - t))
                    await asyncio.sleep(MGMT_LIGHT_GAP_S)
                await light.close()

            try:
                asyncio.run(run())
            except Exception as exc:  # reported on the phase's thread
                errors.append(exc)
                ready.set()

        th = threading.Thread(target=light_thread)
        th.start()
        if not await loop.run_in_executor(None, ready.wait, 60) or errors:
            fail(f"mgmt broker: the light client did not connect: {errors}")
        await asyncio.sleep(0.3)
        t1 = time.perf_counter()
        st, ct, raw = await call(admin, "GET", "/api/v5/topics",
                                 parse=False)
        t2 = time.perf_counter()
        await asyncio.sleep(0.3)
        stop.set()
        await loop.run_in_executor(None, th.join, 60)
        if errors or th.is_alive():
            fail(f"mgmt broker: the light client failed: {errors}")
        topics_ms = (t2 - t1) * 1e3
        n_routes = len(broker.router.topics())
        if n_routes < len(routes):
            fail(f"mgmt broker: {n_routes} routes of {len(routes)}")
        body = await loop.run_in_executor(None, json.loads, raw)
        expect("GET /api/v5/topics", (st, ct, body["meta"]["count"]),
               (200, "application/json; charset=utf-8", n_routes))
        topics_bytes = len(raw)
        during = [w for t, w in waits if t <= t2 and t + w >= t1] or [0.0]
        before = [w for t, w in waits if t < t1 - 0.05]
        print(f"mgmt broker: GET /api/v5/topics over {n_routes} routes in "
              f"{topics_ms:.3f} ms, {topics_bytes} bytes; the light "
              f"client's longest PUBACK wait while it was served "
              f"{max(during) * 1e3:.3f} ms ({len(waits)} PUBACKs; before "
              f"it, max {max(before or [0.0]) * 1e3:.3f} ms) [{card}]",
              flush=True)
        del body, raw

        # the roles' refusals and an unported route
        anon, viewer = api(), api(W.basic_auth(*keys["viewer"]))
        expect("anonymous GET stats", (await call(anon, "GET",
                                                  "/api/v5/stats"))[0], 401)
        vuser = api()
        vuser.auth = await loop.run_in_executor(
            None, lambda: vuser.login("auditor", "s3cret"))
        for cl in (viewer, vuser):
            expect("viewer POST publish", (await call(
                cl, "POST", "/api/v5/publish", {"topic": "t"}))[0], 403)
        publisher = api(pub_key)
        refused = 0
        for method, template, name in PM.ROUTES:
            if (method, template) == ("POST", "/api/v5/publish"):
                continue
            if template in ("/", "/dashboard", "/metrics") and \
                    method == "GET":
                continue  # open routes
            if template == "/api/v5/login":
                continue
            st, _, _ = await call(publisher, method,
                                  mgmt_concrete(template), {})
            expect(f"publisher {method} {template}", st, 403)
            refused += 1
        st, _, body = await call(admin, "GET", "/api/v5/olp")
        expect("GET /api/v5/olp", (st, body["code"]), (501, "NOT_PORTED"))

        # the CLI, as subprocesses
        key = ":".join(keys["administrator"])
        base = f"http://127.0.0.1:{port}"
        ctl_out = {}
        for cmd in ("status", "rules", "stats"):
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "emqx_tpu_torch.ctl", "--api", base,
                "--api-key", key, cmd, cwd=HERE,
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.PIPE)
            out, err = await asyncio.wait_for(proc.communicate(), 60)
            if proc.returncode != 0:
                fail(f"mgmt broker: ctl {cmd} exited {proc.returncode}: "
                     f"{err.decode()[-500:]}")
            ctl_out[cmd] = out.decode()
        if "is running" not in ctl_out["status"] or \
                ctl_out["rules"].count("\n") != 100:
            fail(f"mgmt broker: ctl output {ctl_out['status']!r}")
        print(f"mgmt broker: no credentials 401, viewer POST 403, the "
              f"publisher key 403 on {refused} other routes, GET "
              f"/api/v5/olp 501 NOT_PORTED; ctl status, rules and stats "
              f"exit 0 [{card}]", flush=True)
    finally:
        for cl in clients:
            cl.close()
        for cl in subs + pubs:
            await cl.close()
        await server.stop()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    for name, k in (("match_batch_compact", "match_batch_compact"),
                    ("decide_batch", "decide_packed"),
                    ("rules_eval_batch", "rules_eval_lowered")):
        results["kernels"][name]["mgmt"] = {"launches": launches[k]}
    return {"rest_publishes_per_s": MGMT_REST / rest_wall,
            "rest_p50_ms": p50, "rest_p99_ms": p99,
            "mqtt_msgs_per_s": n_mqtt / mqtt_wall, "login_ms": login_ms,
            "scrape_ms": scrape_ms, "scrape_bytes": len(text.encode()),
            "scrape_families": len(fams), "topics_ms": topics_ms,
            "topics_bytes": topics_bytes, "topics_routes": n_routes,
            "route_filters": len(filters),
            "light_puback_max_ms_during_topics": max(during) * 1e3,
            "rules_windows": rules_windows, "decide_windows": decides,
            "launches": {k: launches[k] for k in (
                "match_batch_compact", "decide_packed",
                "rules_eval_lowered")}}


def mgmt_parity(results) -> None:
    """`workload.mgmt_world` on the card against the CPU: every
    normalised response equal; K1, K3 and K4 launched on the card."""
    from emqx_tpu_torch import workload as W
    from emqx_tpu_torch.ops import match_kernel as mk

    t0 = time.perf_counter()
    mk.reset_launches()
    card = W.mgmt_world("cuda")
    launches = mk.launches()
    cpu = W.mgmt_world("cpu")
    got, want = W.mgmt_outcome(card), W.mgmt_outcome(cpu)
    if got != want:
        bad = [k for k in want if got.get(k) != want[k]]
        if "reads" in bad:
            bad += [p for p in want["reads"]
                    if got["reads"].get(p) != want["reads"][p]]
        fail(f"mgmt broker: the card's mgmt_world differs from the CPU's "
             f"in {bad}")
    eng = card["engine"]
    if not (launches["match_batch_compact"] >= 1
            and launches["decide_packed"] == eng["decide_windows"] >= 1
            and launches["rules_eval_lowered"]
            == eng["rules_dev_windows"] >= 1):
        fail(f"mgmt broker: mgmt_world launches {launches}, engine {eng}")
    n_rest = len(card["delivered"])
    print(f"mgmt broker: workload.mgmt_world on the card equals the CPU "
          f"response for response ({n_rest} REST publishes' delivered, "
          f"100 rules' counters, {len(card['subscriber_bytes'])} "
          f"subscribers' bytes, metrics, {len(card['reads'])} read-backs, "
          f"the scrape's families) in {time.perf_counter() - t0:.1f} s; "
          f"launches {launches} [{results['card']}]", flush=True)


def phase_mgmt_broker(results, filters) -> None:
    phase("mgmt broker")
    t0 = time.perf_counter()
    results["mgmt"] = asyncio.run(mgmt_load(results, filters))
    mgmt_parity(results)
    results["mgmt"]["phase_s"] = time.perf_counter() - t0


def phase_main_shapes(results) -> None:
    """K3 and K4 at the shapes the main path gave them: the N of every
    K3 launch of the broker run and the (R, W) of every K4 launch of the
    rules broker run, their medians and maxima, and each kernel timed on
    the window of its median launch, the wrapper through the engine's
    own entry (`MatchEngine.decide_window`, `RulesEvaluator.
    eval_window`) on that window's arguments."""
    import numpy as np

    phase("main-path shapes")
    card = results["card"]
    dec, rules = (results["main_path"].pop(k) for k in ("decide", "rules"))
    n, b = (np.array([e[0][k] for e in dec]) for k in (0, 1))
    (mn, mb, mr), entry = MainPathLog.median(dec, key=lambda sh: sh)
    print(f"K3 launches in the broker run: {len(dec)}; N (padded) median "
          f"{int(np.median(n))}, max {int(n.max())}; deliveries median "
          f"{int(np.median([len(e[1][1][2]) for e in dec]))}; B (padded) "
          f"median {int(np.median(b))}, max {int(b.max())}; R {mr}",
          flush=True)
    call = MainPathLog.call(entry)
    args = MainPathLog.launch_args("decide", call)
    results["kernels"]["decide_batch"]["main_path"] = dict(
        decide_times(card, args[0], args[1:7], call,
                     "MatchEngine.decide_window: columns up in one copy, "
                     "kernel, decisions and error word down",
                     " (main path, median launch)"), n=int(mn), b=int(mb))
    r, w = (np.array([e[0][k] for e in rules]) for k in (0, 1))
    (rr, ww), entry = MainPathLog.median(rules, key=lambda sh: sh[1])
    print(f"K4 launches in the rules broker run: {len(rules)}; R median "
          f"{int(np.median(r))}, max {int(r.max())}; W median "
          f"{int(np.median(w))}, max {int(w.max())}", flush=True)
    call = MainPathLog.call(entry)
    args = MainPathLog.launch_args("rules_eval", call)
    stack, _, cols = entry[1][:3]
    results["kernels"]["rules_eval_batch"]["main_path"] = dict(
        rules_times(card, stack, cols, args[:3], call,
                    " (main path, median launch)"), r=int(rr), w=int(ww))


def phase_broker(results, filters):
    phase("broker")
    asyncio.run(cli_round_trip())
    # the main path (native host path), then native=False once: the
    # script stays within half its time limit
    runs = {True: [], False: []}
    for k, native in enumerate((True, False)):
        runs[native].append(asyncio.run(broker_load(
            results, filters, native=native, main_path=k == 0)))
    nat = results["native"]
    nat["broker"] = {"native": runs[True], "python": runs[False]}
    med = {k: sorted(r["msgs_per_s"] for r in v) for k, v in runs.items()}
    print(f"broker msgs/s in, in turns (native, Python): "
          f"native {', '.join(f'{x:.1f}' for x in med[True])}; native=False "
          f"{', '.join(f'{x:.1f}' for x in med[False])} "
          f"[{results['card']}]", flush=True)
    phase_window_assembly(results, runs[True][0]["stages"])
    phase("rules broker")
    asyncio.run(rules_load(results, filters))



# ------------------------------------------------- shared subscriptions

SHARED_GROUPS = (("$share/g1/load/+/+", 4), ("$share/g2/load/#", 3),
                 ("load/#", 1))  # (filter, members): two groups, one direct
SHARED_LEAVE_MSG = 256
ORDER_FREE = ("round_robin", "round_robin_per_group", "hash_clientid",
              "hash_topic")


async def shared_load(results, filters, device: str = "cuda") -> dict:
    """``$share`` groups on the broker phase's world: 1M background
    filters in the engine, group g1 (4 members on ``load/+/+``), group
    g2 (3 on ``load/#``) and one direct subscriber on ``load/#``, all QoS
    1, strategy ``round_robin``; 4 publishers send 1,000 QoS 1 messages
    each over TCP through the batcher.  Each message must reach exactly
    one member of each group and the direct subscriber, g1's members
    1,000 each, g2's 1,333 or 1,334; then a g1 member leaves with its
    clean session and 256 more messages reach the other three once."""
    from emqx_tpu_torch import topic as T
    from emqx_tpu_torch.broker.listener import BrokerServer
    from emqx_tpu_torch.config import BrokerConfig, ListenerConfig
    from emqx_tpu_torch.ops import match_kernel as mk

    cfg = BrokerConfig(listeners=[ListenerConfig(bind="127.0.0.1", port=0)])
    cfg.mqtt.max_mqueue_len = 4 * N_PUB * N_MSG
    server = BrokerServer(cfg, device=device)
    broker = server.broker
    broker.router.shared.strategy = "round_robin"
    eng = broker.router.engine
    t0 = time.perf_counter()
    eng.insert_many([("/".join(ws), fid) for fid, ws in filters])
    await server.start()
    subs = []  # (group index, client)
    try:
        for g, (flt, n) in enumerate(SHARED_GROUPS):
            for j in range(n):
                cl = Client(server.port, f"sh{g}-{j}")
                await cl.connect()
                await cl.subscribe(flt, 1)
                subs.append((g, cl))
        eng.rebuild()
        print(f"shared broker: {len(filters)} background filters + "
              f"{len(subs)} subscribers in {len(SHARED_GROUPS)} groups "
              f"({', '.join(f'{f} x{n}' for f, n in SHARED_GROUPS)}) on the "
              f"card ({eng._aut.n_nodes} nodes) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        C = subs[0][1].C
        pubs = []
        for p in range(N_PUB):
            cl = Client(server.port, f"shpub{p}")
            await cl.connect()
            pubs.append(cl)
        got = [[] for _ in subs]  # keys each subscriber received
        lat = []
        need = [0] * len(SHARED_GROUPS)  # deliveries still owed per group
        done = asyncio.Event()

        async def consume(i, g, cl):
            while True:
                pkt = await cl.inbox.get()
                if pkt is None:
                    fail(f"shared subscriber {cl.client_id} disconnected")
                if pkt.type != C.PUBLISH:
                    continue
                cl.send(C.Puback(packet_id=pkt.packet_id))
                p, k, ts = pkt.payload.split(b":")
                got[i].append((int(p), int(k)))
                lat.append(time.perf_counter() - float(ts))
                need[g] -= 1
                if not any(need):
                    done.set()

        async def run(n, k0, pubs_):
            for g in range(len(need)):
                need[g] += n * len(pubs_)
            done.clear()
            tasks = [asyncio.get_running_loop().create_task(
                consume(i, g, cl)) for i, (g, cl) in enumerate(subs)]
            try:
                await asyncio.wait_for(asyncio.gather(
                    *(publish_load(cl, p, n, k0) for p, cl in pubs_)), 600)
                await asyncio.wait_for(done.wait(), 60)
            except asyncio.TimeoutError:
                fail(f"shared broker: deliveries owed per group {need}; "
                     f"received {[len(x) for x in got]}; metrics "
                     f"{broker.metrics.all()}")
            finally:
                for t in tasks:
                    t.cancel()
            for _g, cl in subs:  # no extra delivery is on its way
                await cl.quiet()

        def check(label, keys, members):
            for g in range(len(SHARED_GROUPS)):
                mine = [got[i] for i in members if subs[i][0] == g]
                flat = [k for m in mine for k in m]
                if len(flat) != len(set(flat)) or set(flat) != keys:
                    fail(f"shared broker ({label}): group {g} got "
                         f"{len(flat)} deliveries, {len(set(flat))} "
                         f"distinct, of {len(keys)} messages")

        decides = eng.counters["decide_windows"]
        mk.reset_launches()  # counts of the shared path start here
        t0 = time.perf_counter()
        await run(N_MSG, 0, list(enumerate(pubs)))
        wall = time.perf_counter() - t0
        launches = mk.launches()
        decides = eng.counters["decide_windows"] - decides
        expected = N_PUB * N_MSG
        keys = {(p, k) for p in range(N_PUB) for k in range(N_MSG)}
        check("load", keys, range(len(subs)))
        split = {g: sorted(len(got[i]) for i, (gi, _) in enumerate(subs)
                           if gi == g) for g in range(len(SHARED_GROUPS))}
        if split[0] != [N_MSG] * 4 or split[1] != [1333, 1333, 1334]:
            fail(f"shared broker: round_robin split {split}")
        for k in ("match_batch_compact", "decide_packed"):
            if launches[k] < 1:
                fail(f"shared broker: {k} never launched: {launches}")
        if launches["decide_packed"] != decides:
            fail(f"shared broker: {launches['decide_packed']} K3 launches "
                 f"for {decides} decide windows")
        dropped = broker.metrics["delivery.dropped"]
        if dropped:
            fail(f"shared broker dropped {dropped} deliveries")
        n_del = sum(map(len, got))
        lat.sort()
        p50 = lat[len(lat) // 2] * 1e3
        p99 = lat[int(len(lat) * 0.99)] * 1e3
        c = eng.counters
        print(f"shared broker: {expected} QoS 1 messages from {N_PUB} "
              f"publishers each delivered exactly once to one member of "
              f"g1 and of g2 and to the direct subscriber ({n_del} "
              f"deliveries) in {wall:.3f} s: {expected / wall:.1f} msgs/s "
              f"in, {n_del / wall:.1f} deliveries/s; delivery latency p50 "
              f"{p50:.3f} ms p99 {p99:.3f} ms; round_robin split g1 "
              f"{split[0]}, g2 {split[1]}, direct {split[2]}; "
              f"{c['dev_windows']} match windows, {c['clip_reruns']} clip "
              f"reruns, {decides} decide windows; launches {launches} "
              f"[{results['card']}]", flush=True)
        stages = stage_medians("shared broker", broker.profiler)
        # a g1 member leaves with its clean session: the other three
        # take the next messages, each exactly once
        left = next(i for i, (g, _) in enumerate(subs) if g == 0)
        await subs[left][1].close()
        real = T.parse_share(SHARED_GROUPS[0][0]).topic
        for _ in range(1000):
            if len(broker.router.shared.members("g1", real)) == 3:
                break
            await asyncio.sleep(0.01)
        else:
            fail("shared broker: the leaving g1 member is still in g1")
        subs.pop(left)
        got.pop(left)
        for m in got:
            m.clear()
        await run(SHARED_LEAVE_MSG, N_MSG, [(0, pubs[0])])
        check("after a leave",
              {(0, k) for k in range(N_MSG, N_MSG + SHARED_LEAVE_MSG)},
              range(len(subs)))
        after = sorted(len(got[i]) for i, (g, _) in enumerate(subs)
                       if g == 0)
        print(f"shared broker: after one g1 member left with its clean "
              f"session, {SHARED_LEAVE_MSG} more messages reached the other "
              f"three g1 members exactly once ({after}) [{results['card']}]",
              flush=True)
        for _g, cl in subs:
            await cl.close()
        for cl in pubs:
            await cl.close()
    finally:
        await server.stop()
    for name, k in (("match_batch_compact", "match_batch_compact"),
                    ("decide_batch", "decide_packed")):
        results["kernels"][name]["shared"] = {"launches": launches[k]}
    return {"msgs_per_s": expected / wall, "deliveries_per_s": n_del / wall,
            "p50_ms": p50, "p99_ms": p99, "stages": stages}


def shared_wire(device: str, strategy: str, subs, msgs, window: int):
    """Every client's bytes after ``subs`` subscribe in process
    (`Capture`, MQTT 3.1.1) and ``msgs`` go through
    ``Broker.publish_many`` in windows of ``window``."""
    from emqx_tpu_torch.broker.broker import Broker
    from emqx_tpu_torch.message import Message

    b = Broker(device=device, shared_strategy=strategy)
    caps = {cid: Capture(b, cid, flts) for cid, flts in subs}
    b.router.engine.rebuild()
    for k in range(0, len(msgs), window):
        b.publish_many([Message(topic=t, qos=q, from_client=f,
                                payload=b"%d" % (k + i))
                        for i, (t, q, f) in enumerate(msgs[k:k + window])])
    return {cid: bytes(c.raw) for cid, c in caps.items()}


def shared_parity(results) -> None:
    """The same seeded script of ``$share`` groups and direct
    subscribers through ``Broker(device="cuda")`` and
    ``Broker(device="cpu")`` under each order-free strategy: equal wire
    bytes to every client."""
    import numpy as np

    from emqx_tpu_torch import workload as W

    subs, msgs = W.shared_script(np.random.default_rng(11), 200, 24, 4096)
    for strategy in ORDER_FREE:
        t0 = time.perf_counter()
        card = shared_wire("cuda", strategy, subs, msgs, 512)
        cpu = shared_wire("cpu", strategy, subs, msgs, 512)
        bad = [cid for cid in card if card[cid] != cpu[cid]]
        if bad:
            fail(f"shared parity ({strategy}): the card's bytes differ "
                 f"from the CPU's for {len(bad)} clients, e.g. {bad[:3]}")
        print(f"shared parity ({strategy}): {len(subs)} clients in 24 "
              f"groups, {len(msgs)} messages in windows of 512: the card's "
              f"broker writes the CPU broker's {sum(map(len, card.values()))} "
              f"bytes ({time.perf_counter() - t0:.1f} s) "
              f"[{results['card']}]", flush=True)


def phase_shared_broker(results, filters) -> None:
    phase("shared broker")
    results["shared"] = asyncio.run(shared_load(results, filters))
    shared_parity(results)


# ------------------------------------------------------------ retainer

RETAIN_WINDOW = 4096  # config 3's batch_max: one publish window


def retained_filters(pops):
    """16 subscriptions: ``(filter, qos, broad)``, 14 of the four
    families of `workload.make_filters` (one device, a few, none) and
    the two broad ones."""
    nv, nd, _ns, na = pops
    return [
        (f"vehicles/v0/sensors/#", 1, False),
        (f"vehicles/v17/sensors/#", 0, False),
        (f"vehicles/v{nv - 1}/sensors/#", 1, False),
        (f"vehicles/v{nv + 5}/sensors/#", 1, False),
        (f"dev/g3/+/d3", 1, False),
        (f"dev/g{nd - 1}/+/d{(nd - 1) % 7}", 0, False),
        (f"dev/g10/+/d0", 1, False),
        ("dev/+/+/d3", 1, False),
        (f"site/+/floor/f5/#", 1, False),
        (f"site/+/floor/f{na - 1}/#", 0, False),
        (f"site/+/floor/f{na + 5}/#", 1, False),
        ("site/s3/floor/+/a", 1, False),
        ("alerts/z1/+/+", 1, False),
        ("alerts/z2/+/+", 0, False),
        ("vehicles/+/sensors/state", 0, True),
        ("site/#", 1, True),
    ]


async def replay_all(port, flts, live, label, card) -> dict:
    """Each filter on a new MQTT 5 connection: SUBSCRIBE, then every
    replayed PUBLISH (acked), then a PINGREQ whose PINGRESP must come
    next.  The replayed topics must equal a brute-force `topic.match`
    over ``live`` (the stored topics), each once, all with retain=1.
    Returns the time from SUBSCRIBE to the last replayed PUBLISH of
    each broad filter."""
    from emqx_tpu_torch import topic as T

    words = [T.words(t) for t in live]
    out = {}
    for j, (flt, qos, broad) in enumerate(flts):
        fw = T.words(flt)
        want = {t for t, w in zip(live, words) if T.match_words(w, fw)}
        cl = Client(port, f"ret-{label}-{j}", version=5)
        await cl.connect()
        C = cl.C
        t0 = time.perf_counter()
        cl.send(C.Subscribe(packet_id=1, subscriptions=[
            C.Subscription(topic_filter=flt, qos=qos)]))
        ack = await cl.expect(C.SUBACK)
        if ack.reason_codes != [qos]:
            fail(f"retained ({label}): SUBACK {ack.reason_codes} for {flt}")
        seen = []
        t_last = t0
        while len(seen) < len(want):
            pkt = await cl.expect(C.PUBLISH)
            t_last = time.perf_counter()
            if not pkt.retain:
                fail(f"retained ({label}): {flt} replayed {pkt.topic} "
                     f"without the retain bit")
            if pkt.qos:
                cl.send(C.Puback(packet_id=pkt.packet_id))
            seen.append(pkt.topic)
        await cl.quiet()
        if len(set(seen)) != len(seen) or set(seen) != want:
            fail(f"retained ({label}): {flt} replayed {len(seen)} topics "
                 f"({len(set(seen))} distinct), the brute force "
                 f"{len(want)}")
        if broad:
            out[flt] = {"replayed": len(seen),
                        "subscribe_to_last_ms": (t_last - t0) * 1e3}
        await cl.close()
    print(f"retained ({label}): {len(flts)} MQTT 5 subscribers, every "
          f"replay equal to the brute force over the {len(live)} stored "
          f"topics, each PUBLISH with retain=1; broad filters "
          f"{json.dumps(out)} [{card}]", flush=True)
    return out


async def retained_load(results, filters, device: str = "cuda") -> dict:
    """One retained last-known-state message per device of config 3's
    populations: stored through ``Broker.publish_many`` windows of
    4,096 with the 1M filters in the engine (K1 every window), replayed
    over TCP to 16 MQTT 5 subscribers, then 10% deleted by empty
    retained publishes and replayed again; `Retainer.match` timed per
    filter class."""
    import numpy as np

    from emqx_tpu_torch import workload as W
    from emqx_tpu_torch.broker.listener import BrokerServer
    from emqx_tpu_torch.config import BrokerConfig, ListenerConfig
    from emqx_tpu_torch.message import Message
    from emqx_tpu_torch.ops import match_kernel as mk

    card = results["card"]
    pops = W.populations(len(filters), 8)
    topics = W.retained_topics(pops)
    cfg = BrokerConfig(listeners=[ListenerConfig(bind="127.0.0.1", port=0)])
    # the 62,500-message QoS 0 and 12,500-message QoS 1 replays queue
    # past the inflight window: a queue that holds them drops none
    cfg.mqtt.max_mqueue_len = len(topics)
    server = BrokerServer(cfg, device=device)
    broker = server.broker
    eng = broker.router.engine
    eng.insert_many([("/".join(ws), fid) for fid, ws in filters])
    eng.rebuild()
    await server.start()
    try:
        def store(msgs):
            n_win = 0
            for k in range(0, len(msgs), RETAIN_WINDOW):
                broker.publish_many(msgs[k:k + RETAIN_WINDOW])
                n_win += 1
            return n_win

        msgs = [Message(topic=t, qos=1, retain=True, from_client="fleet",
                        payload=(f'{{"state":"ok","v":{i % 61},"ts":'
                                 f'{1752000000000 + i},"seq":{i:06d}}}'
                                 ).encode())
                for i, t in enumerate(topics)]
        dev = eng.counters["dev_windows"]
        mk.reset_launches()
        t0 = time.perf_counter()
        n_win = store(msgs)
        wall = time.perf_counter() - t0
        launches = mk.launches()
        dev = eng.counters["dev_windows"] - dev
        if len(broker.retainer) != len(topics) or \
                broker.metrics["messages.retained"] != len(topics):
            fail(f"retained: {len(broker.retainer)} stored of {len(topics)}")
        if launches["match_batch_compact"] < n_win or dev < n_win:
            fail(f"retained: {n_win} windows, {dev} on the card, "
                 f"launches {launches}")
        size = sum(len(m.payload) for m in msgs) / len(msgs)
        print(f"retained: {len(topics)} retained messages (payload mean "
              f"{size:.1f} B) stored through {n_win} publish_many windows "
              f"of {RETAIN_WINDOW} on the card with {len(filters)} filters "
              f"in {wall:.3f} s: {len(topics) / wall:.1f} msgs/s; retainer "
              f"count {len(broker.retainer)}; K1 launches "
              f"{launches['match_batch_compact']} [{card}]", flush=True)
        # the store windows' stages: `prepare` is the retainer's trie
        store_stages = stage_medians("retained store", broker.profiler)
        flts = retained_filters(pops)
        broad = await replay_all(server.port, flts, topics, "stored", card)
        # a re-subscribe with retain_handling 1, and a new subscription
        # with 2, replay nothing; nor does a shared subscription
        cl = Client(server.port, "ret-rh", version=5)
        await cl.connect()
        for flt, rh in (("vehicles/v0/sensors/#", 0),
                        ("vehicles/v0/sensors/#", 1),
                        ("vehicles/v17/sensors/#", 2),
                        ("$share/g/vehicles/#", 0)):
            await cl.subscribe(flt, 1, rh)
            if rh == 0 and not flt.startswith("$share"):
                pkt = await cl.expect(cl.C.PUBLISH)  # the first replays
                cl.send(cl.C.Puback(packet_id=pkt.packet_id))
            await cl.quiet()
        await cl.close()
        print("retained: a re-subscribe with retain_handling 1, a new "
              "subscription with 2 and $share/g/vehicles/# replayed "
              "nothing", flush=True)
        # delete every tenth topic by an empty retained publish
        gone = set(topics[::10])
        t0 = time.perf_counter()
        store([Message(topic=t, qos=0, retain=True, from_client="fleet")
               for t in topics[::10]])
        wall_del = time.perf_counter() - t0
        live = [t for t in topics if t not in gone]
        if len(broker.retainer) != len(live) or \
                set(broker.retainer.topics()) != set(live):
            fail(f"retained: {len(broker.retainer)} left of {len(live)} "
                 f"after deleting {len(gone)}")
        print(f"retained: {len(gone)} deleted by empty retained publishes "
              f"in {wall_del:.3f} s; {len(broker.retainer)} left", flush=True)
        broad_after = await replay_all(server.port, flts, live, "after delete",
                                       card)
        # Retainer.match per filter class, in process
        rng = np.random.default_rng(5)
        nv, nd, _ns, na = pops
        classes = {
            "one vehicle": [f"vehicles/v{i}/sensors/#"
                            for i in rng.integers(0, nv, 200)],
            "one device group": [f"dev/g{j}/+/d{j % 7}"
                                 for j in rng.integers(0, nd, 200)],
            "one site": [f"site/+/floor/f{k}/#"
                         for k in rng.integers(0, na, 200)],
            "none (alerts)": [f"alerts/z{m}/+/+"
                              for m in rng.integers(0, na, 200)],
            "dev/+/+/d3": ["dev/+/+/d3"] * 20,
            "site/#": ["site/#"] * 20,
            "vehicles/+/sensors/state": ["vehicles/+/sensors/state"] * 20,
        }
        match = {}
        for name, fs in classes.items():
            ts = []
            for f in fs:
                t = time.perf_counter()
                broker.retainer.match(f)
                ts.append((time.perf_counter() - t) * 1e3)
            ts.sort()
            match[name] = {"n": len(ts), "p50_ms": ts[len(ts) // 2],
                           "p99_ms": ts[min(int(len(ts) * 0.99),
                                            len(ts) - 1)]}
        print(f"retained: Retainer.match per filter class over "
              f"{len(broker.retainer)} topics: {json.dumps(match)} [{card}]",
              flush=True)
    finally:
        await server.stop()
    return {"stored": len(topics), "store_msgs_per_s": len(topics) / wall,
            "windows": n_win, "k1_launches": launches["match_batch_compact"],
            "store_stages": store_stages,
            "broad": broad, "broad_after_delete": broad_after,
            "deleted": len(gone), "match": match}


def phase_retained(results, filters) -> None:
    phase("retained")
    results["retained"] = asyncio.run(retained_load(results, filters))


# ------------------------------------------------------- access broker

ACCESS_USERS = 100_000  # one of them the superuser
ACCESS_DELAYED = 64
ACCESS_CONNECTS, ACCESS_WAVE = 512, 64
ACCESS_SUBS = tuple(f for f in SUB_FILTERS if f != "#")  # "#" is refused


async def access_publish(cl, p: int, n: int) -> int:
    """Publisher ``p`` (client ``ap{p}``, MQTT 5) sends ``n`` QoS 1
    messages on ``raw/ap{p}/m{k % 16}``, every 8th on another client's
    subtree, each payload ``p:k:send time``, at most 32 unacknowledged;
    every refused one must come back PUBACK 0x87 and every other one
    PUBACK 0.  Returns the refused count."""
    C = cl.C
    window = asyncio.Semaphore(32)
    n_acked = refused = 0
    want = {}

    async def acks():
        nonlocal n_acked, refused
        while n_acked < n:
            pkt = await asyncio.wait_for(cl.inbox.get(), 60)
            if pkt is None or pkt.type != C.PUBACK:
                fail(f"ap{p}: expected PUBACK, got {pkt!r}")
            if pkt.reason_code != want.pop(pkt.packet_id):
                fail(f"ap{p}: PUBACK {pkt.reason_code:#x} for packet "
                     f"{pkt.packet_id}")
            refused += pkt.reason_code == 0x87
            n_acked += 1
            window.release()

    task = asyncio.get_running_loop().create_task(acks())
    for k in range(n):
        await window.acquire()
        out = k % 8 == 7
        topic = f"raw/{'x' if out else ''}ap{p}/m{k % 16}"
        want[k % 65535 + 1] = 0x87 if out else 0
        cl.send(C.Publish(topic=topic, qos=1, packet_id=k % 65535 + 1,
                          payload=f"{p}:{k}:{time.perf_counter()!r}".encode()))
        if k % 32 == 0:
            await cl.writer.drain()
    await task
    return refused


async def access_load(results, filters) -> dict:
    """The broker phase's world behind the control surface: 1M
    background filters, a `DictAuthenticator` of 100,000 users (one
    superuser) with anonymous clients refused, the default-ACL world of
    `workload.access_acl` (authz_default deny), the load rewrite
    (raw/<client>/... onto load/<client>/...), `TopicMetrics` on
    ``load/#`` and a 1 s ``$SYS`` heartbeat.  One bad password is
    refused; 7 subscribers (the load's filters but ``#``, which the ACL
    refuses) and a superuser ``$SYS/#`` watcher; 4 MQTT 5 publishers
    send 1,000 QoS 1 messages each, every 8th outside their subtree
    (PUBACK 0x87, never matched), after 64 ``$delayed/1/`` messages the
    server's housekeeping releases; then 512 authenticated CONNECTs in
    waves of 64, each timed to its CONNACK."""
    from emqx_tpu_torch import workload as W
    from emqx_tpu_torch.access import AclProvider, AclRule, DictAuthenticator
    from emqx_tpu_torch.broker.listener import BrokerServer
    from emqx_tpu_torch.config import BrokerConfig, ListenerConfig
    from emqx_tpu_torch.modules import RewriteRule
    from emqx_tpu_torch.ops import match_kernel as mk

    cfg = BrokerConfig(listeners=[ListenerConfig(bind="127.0.0.1", port=0)])
    cfg.mqtt.max_mqueue_len = 4 * N_PUB * N_MSG
    cfg.auth.allow_anonymous = False
    cfg.auth.authz_default = "deny"
    cfg.sys.interval = 1
    server = BrokerServer(cfg)
    broker = server.broker
    eng = broker.router.engine
    t0 = time.perf_counter()
    users = DictAuthenticator()
    for i in range(ACCESS_USERS - 1):
        users.add_user(f"u{i}", f"p{i}")
    users.add_user("root", "rootpw", is_superuser=True)
    broker.access.authenticators.append(users)
    broker.access.authz_sources.append(AclProvider(
        AclRule(*r) for r in W.access_acl(SUB_FILTERS)))
    broker.rewrite.add_rule(RewriteRule(*W.ACCESS_REWRITE))
    broker.topic_metrics.register("load/#")
    t_users = time.perf_counter() - t0
    eng.insert_many([("/".join(ws), fid) for fid, ws in filters])
    await server.start()
    clients = []
    try:
        C = None
        bad = Client(server.port, "bad", username="u1", password=b"nope")
        await bad.connect(rc=4)  # 3.1.1: bad user name or password
        await bad.close()
        subs = []
        for j, flt in enumerate(ACCESS_SUBS):
            cl = Client(server.port, f"as{j}", username=f"u{j}",
                        password=b"p%d" % j)
            await cl.connect()
            await cl.subscribe(flt, 1)
            subs.append(cl)
        C = subs[0].C
        probe = Client(server.port, "aprobe", version=5, username="u99",
                       password=b"p99")
        await probe.connect()
        probe.send(C.Subscribe(packet_id=1, subscriptions=[
            C.Subscription(topic_filter=f, qos=0)
            for f in ("#", "$SYS/#", "load/#")]))
        ack = await probe.expect(C.SUBACK)
        if ack.reason_codes != [0x87, 0x87, 0]:
            fail(f"access broker: SUBACK {ack.reason_codes} for #, $SYS/#, "
                 f"load/#")
        await probe.close()
        root = Client(server.port, "aroot", username="root",
                      password=b"rootpw")
        await root.connect()
        await root.subscribe("$SYS/#", 0)
        eng.rebuild()
        print(f"access broker: {ACCESS_USERS} users ({t_users:.1f} s), "
              f"{len(filters)} background filters + {len(subs)} subscriber "
              f"filters on the card ({eng._aut.n_nodes} nodes) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        pubs = []
        for p in range(N_PUB):
            cl = Client(server.port, f"ap{p}", version=5,
                        username=f"u{100 + p}", password=b"p%d" % (100 + p))
            await cl.connect()
            pubs.append(cl)
        accepted = N_PUB * (N_MSG - N_MSG // 8)
        expected = accepted + ACCESS_DELAYED
        seen = [set() for _ in subs]
        lat = []
        heartbeats = [0]

        async def consume(j, cl):
            while len(seen[j]) < expected:
                try:
                    pkt = await asyncio.wait_for(cl.inbox.get(), 60)
                except asyncio.TimeoutError:
                    fail(f"as{j} stalled at {len(seen[j])} of {expected}; "
                         f"metrics {broker.metrics.all()}")
                if pkt is None:
                    fail(f"as{j} disconnected")
                if pkt.type != C.PUBLISH:
                    continue
                cl.send(C.Puback(packet_id=pkt.packet_id))
                p, k, ts = pkt.payload.split(b":")
                key = (int(p), int(k))
                if key in seen[j]:
                    fail(f"as{j} got message {key} twice")
                if key[1] < N_MSG and key[1] % 8 == 7:
                    fail(f"as{j} got the refused message {key}")
                seen[j].add(key)
                if key[1] < N_MSG:
                    lat.append(time.perf_counter() - float(ts))

        async def watch():
            while True:
                pkt = await root.inbox.get()
                if pkt is None:
                    fail("the $SYS watcher disconnected")
                if pkt.type == C.PUBLISH and pkt.topic.endswith("/uptime"):
                    heartbeats[0] += 1

        watcher = asyncio.get_running_loop().create_task(watch())
        decides = eng.counters["decide_windows"]
        mk.reset_launches()  # counts of the access path start here
        t0 = time.perf_counter()
        # the delayed ones first: the housekeeping releases them while
        # the load runs
        for k in range(ACCESS_DELAYED):
            pubs[0].send(C.Publish(
                topic=f"$delayed/1/raw/ap0/d{k}", qos=1,
                packet_id=60000 + k,
                payload=f"0:{N_MSG + k}:{time.perf_counter()!r}".encode()))
        for k in range(ACCESS_DELAYED):
            ack = await pubs[0].expect(C.PUBACK)
            if ack.reason_code != 0x10:  # swallowed: no subscriber yet
                fail(f"access broker: $delayed PUBACK {ack.reason_code:#x}")
        refused = await asyncio.wait_for(asyncio.gather(
            *(consume(j, cl) for j, cl in enumerate(subs)),
            *(access_publish(cl, p, N_MSG) for p, cl in enumerate(pubs)),
        ), 600)
        wall = time.perf_counter() - t0
        launches = mk.launches()
        decides = eng.counters["decide_windows"] - decides
        n_refused = sum(r for r in refused if r is not None)
        if n_refused != N_PUB * (N_MSG // 8):
            fail(f"access broker: {n_refused} publishes refused")
        for k in ("match_batch_compact", "decide_packed"):
            if launches[k] < 1:
                fail(f"access broker: {k} never launched: {launches}")
        if launches["decide_packed"] != decides:
            fail(f"access broker: {launches['decide_packed']} K3 launches "
                 f"for {decides} decide windows")
        delayed = [sum(1 for _p, k in s if k >= N_MSG) for s in seen]
        if delayed != [ACCESS_DELAYED] * len(subs) or len(broker.delayed):
            fail(f"access broker: delayed deliveries {delayed}, "
                 f"{len(broker.delayed)} still held")
        tm = broker.topic_metrics.info()[0]
        if (tm["messages.in"] != expected
                or tm["messages.out"] != expected * len(subs)):
            fail(f"access broker: topic metrics {tm} for {expected} "
                 f"publishes and {expected * len(subs)} deliveries")
        m = broker.metrics
        if m["delivery.dropped"]:
            fail(f"access broker dropped {m['delivery.dropped']} deliveries")
        if not heartbeats[0]:
            fail("access broker: no $SYS heartbeat reached the watcher")
        lat.sort()
        p50, p99 = (lat[int(len(lat) * q)] * 1e3 for q in (0.5, 0.99))
        n_del = expected * len(subs)
        base = results["native"]["broker"]["native"][0]["msgs_per_s"]
        print(f"access broker: {N_PUB * N_MSG} QoS 1 publishes ({n_refused} "
              f"refused with PUBACK 0x87, never matched) and "
              f"{ACCESS_DELAYED} delayed in {wall:.3f} s: "
              f"{N_PUB * N_MSG / wall:.1f} publishes/s, "
              f"{accepted / wall:.1f} msgs/s in (the broker phase: "
              f"{base:.1f} msgs/s in, ratio {accepted / wall / base:.3f}), "
              f"{n_del / wall:.1f} deliveries/s; every accepted and every "
              f"delayed message delivered exactly once to {len(subs)} "
              f"subscribers; delivery latency p50 {p50:.3f} ms p99 "
              f"{p99:.3f} ms; TopicMetrics load/# in {tm['messages.in']} "
              f"out {tm['messages.out']}; $SYS heartbeats received "
              f"{heartbeats[0]}; {decides} decide windows; launches "
              f"{launches} [{results['card']}]", flush=True)
        print(f"access broker: authorization allow "
              f"{m['authorization.allow']} deny {m['authorization.deny']}, "
              f"messages.delayed {m['messages.delayed']}, connects refused "
              f"{m['client.connect'] - m['client.connected']}", flush=True)
        stages = stage_medians("access broker", broker.profiler)
        watcher.cancel()
        for cl in subs + pubs + [root]:
            await cl.close()
        # authenticated CONNECTs, timed CONNECT -> CONNACK
        conn_ms = []
        t0 = time.perf_counter()
        for w in range(0, ACCESS_CONNECTS, ACCESS_WAVE):
            wave = [Client(server.port, f"ac{i}", username=f"u{1000 + i}",
                           password=b"p%d" % (1000 + i))
                    for i in range(w, w + ACCESS_WAVE)]

            async def timed(cl):
                t = time.perf_counter()
                await cl.connect()
                conn_ms.append((time.perf_counter() - t) * 1e3)

            await asyncio.gather(*(timed(cl) for cl in wave))
            for cl in wave:
                await cl.close()
        conn_wall = time.perf_counter() - t0
        conn_ms.sort()
        c50, c99 = (conn_ms[int(len(conn_ms) * q)] for q in (0.5, 0.99))
        print(f"access broker: {ACCESS_CONNECTS} authenticated CONNECTs "
              f"(salted SHA-256 over {ACCESS_USERS} users) in waves of "
              f"{ACCESS_WAVE}: CONNECT->CONNACK p50 {c50:.3f} ms p99 "
              f"{c99:.3f} ms, {ACCESS_CONNECTS / conn_wall:.1f} connects/s "
              f"(closes included) [{results['card']}]", flush=True)
    finally:
        await server.stop()
    for name, k in (("match_batch_compact", "match_batch_compact"),
                    ("decide_batch", "decide_packed")):
        results["kernels"][name]["access"] = {"launches": launches[k]}
    return {"publishes_per_s": N_PUB * N_MSG / wall,
            "msgs_per_s": accepted / wall, "deliveries_per_s": n_del / wall,
            "broker_msgs_per_s": base, "p50_ms": p50, "p99_ms": p99,
            "connect_p50_ms": c50, "connect_p99_ms": c99,
            "connects_per_s": ACCESS_CONNECTS / conn_wall,
            "heartbeats": heartbeats[0], "topic_metrics": tm,
            "stages": stages}


def access_parity(results) -> None:
    """The same seeded access world (`workload.access_script`) through
    ``Broker(device="cuda")`` and ``Broker(device="cpu")``: equal wire
    bytes to every client and equal topic metrics."""
    import numpy as np

    from emqx_tpu_torch import workload as W

    subs, msgs = W.access_script(np.random.default_rng(13), 96, 1536)
    t0 = time.perf_counter()
    card, tm_card, _ = W.access_world("cuda", subs, msgs)
    cpu, tm_cpu, _ = W.access_world("cpu", subs, msgs)
    bad = [cid for cid in card if card[cid] != cpu[cid]]
    if bad or tm_card != tm_cpu:
        fail(f"access parity: the card's bytes differ from the CPU's for "
             f"{len(bad)} clients, e.g. {bad[:3]}; topic metrics "
             f"{tm_card} vs {tm_cpu}")
    print(f"access parity: {len(subs)} authenticated clients, {len(msgs)} "
          f"publishes through their channels (ACL, rewrite, delayed, topic "
          f"metrics {tm_card}): the card's broker writes the CPU broker's "
          f"{sum(map(len, card.values()))} bytes "
          f"({time.perf_counter() - t0:.1f} s) [{results['card']}]",
          flush=True)


def phase_access_broker(results, filters) -> None:
    phase("access broker")
    results["access"] = asyncio.run(access_load(results, filters))
    access_parity(results)


# ------------------------------------------------- auth backends broker

AUTH_MONGO_USERS = 100_000
AUTH_GCP = (32, 32)  # RS256 (2,048-bit) and ES256 devices
AUTH_LDAP = AUTH_HTTP = 64
AUTH_CONNECTS, AUTH_WAVE = 512, 64
AUTH_MSGS = 4000


def auth_rsa_keys(n: int) -> list:
    """``n`` 2,048-bit RSA keys (`workload.rsa_key`, seeded), made in
    worker processes: Python's big-integer prime search takes ~0.5 s a
    key."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from emqx_tpu_torch import workload as W

    rngs = [np.random.default_rng([14, i]) for i in range(n)]
    with ProcessPoolExecutor(
            min(8, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(W.rsa_key, rngs, [2048] * n))


async def auth_publish(cl, items, refused_want: int) -> None:
    """Publisher ``cl`` sends ``items`` (``(k, topic)``) at QoS 1, at
    most 32 unacknowledged; a publish outside its rows (every 8th) must
    come back PUBACK 0x87 and every other PUBACK 0."""
    C = cl.C
    window = asyncio.Semaphore(32)
    want = {}
    n_acked = refused = 0

    async def acks():
        nonlocal n_acked, refused
        while n_acked < len(items):
            pkt = await asyncio.wait_for(cl.inbox.get(), 60)
            if pkt is None or pkt.type != C.PUBACK:
                fail(f"{cl.client_id}: expected PUBACK, got {pkt!r}")
            if pkt.reason_code != want.pop(pkt.packet_id):
                fail(f"{cl.client_id}: PUBACK {pkt.reason_code:#x} for "
                     f"packet {pkt.packet_id}")
            refused += pkt.reason_code == 0x87
            n_acked += 1
            window.release()

    task = asyncio.get_running_loop().create_task(acks())
    for j, (k, topic) in enumerate(items):
        await window.acquire()
        pid = j % 65535 + 1
        want[pid] = 0x87 if k % 8 == 7 else 0
        cl.send(C.Publish(topic=topic, qos=1, packet_id=pid,
                          payload=f"{k}:{time.perf_counter()!r}".encode()))
        if j % 32 == 0:
            await cl.writer.drain()
    await task
    if refused != refused_want:
        fail(f"{cl.client_id}: {refused} publishes refused, "
             f"{refused_want} expected")


async def auth_load(results, filters, script) -> dict:
    """The broker phase's 1M filters behind the four authentication back
    ends of `workload.authdb_script` (anonymous refused, authz default
    deny): GCP devices (RS256 and ES256 JWTs, the registry file under a
    temporary directory), LDAP simple binds, the HTTP service, and Mongo
    (100,000 salted SHA-256 users) with its ``mqtt_acl`` rows as the
    ACL, all loopback servers of `workload` on this machine.  512
    CONNECTs in waves of 64 (the chain's order, each timed to its
    CONNACK), then 4,000 QoS 1 publishes from 8 of those clients, every
    8th outside the publisher's rows, to 4 subscribers."""
    import shutil
    import tempfile

    from emqx_tpu_torch import workload as W
    from emqx_tpu_torch.auth_db import bcrypt_supported
    from emqx_tpu_torch.ops import match_kernel as mk

    impl = W.port_impl("cuda")
    tmp = tempfile.mkdtemp(prefix="emqx-auth-")
    cfg = W.auth_config(impl, tmp)
    cfg.mqtt.max_mqueue_len = 4 * AUTH_MSGS
    server = impl.server(cfg)
    broker = server.broker
    eng = broker.router.engine
    t0 = time.perf_counter()
    fixtures = await W.start_auth_backends(script)
    mongo, ldap, http = fixtures
    imported = broker.gcp_devices.import_devices(script["devices"])
    if imported != (sum(AUTH_GCP), 0):
        fail(f"auth broker: GCP registry import {imported}")
    W.auth_chain(impl, broker, fixtures)
    eng.insert_many([("/".join(ws), fid) for fid, ws in filters])
    # settled before the timed CONNECTs: a background fold of the 1M
    # filters would hold the interpreter lock through the waves
    eng.rebuild()
    await server.start()
    port = server.listeners[0].port
    connects = script["connects"]
    keep = set(script["publishers"]) | set(script["subscribers"])
    kept = {}
    conn_ms = {kind: [] for kind in W.AUTH_KINDS}
    try:
        print(f"auth broker: {len(filters)} filters on the card, the back "
              f"ends up (GCP {AUTH_GCP[0]} RS256 + {AUTH_GCP[1]} ES256 "
              f"devices, LDAP {AUTH_LDAP}, HTTP {AUTH_HTTP}, Mongo "
              f"{AUTH_MONGO_USERS} users, {len(script['acl'])} ACL "
              f"documents) in {time.perf_counter() - t0:.1f} s; "
              f"bcrypt_supported() {bcrypt_supported()}", flush=True)

        async def one(i):
            kind, cid, name, pw, ok = connects[i]
            cl = Client(port, cid, version=5, username=name, password=pw)
            t = time.perf_counter()
            await cl.connect(rc=0 if ok else 0x86)
            conn_ms[kind].append((time.perf_counter() - t) * 1e3)
            if i in keep:
                kept[i] = cl
                return
            if ok:
                cl.send(cl.C.Disconnect())
            await cl.eof()

        t0 = time.perf_counter()
        for w in range(0, AUTH_CONNECTS, AUTH_WAVE):
            await asyncio.gather(*(one(i) for i in range(w, w + AUTH_WAVE)))
        conn_wall = time.perf_counter() - t0
        asked = (dict(mongo.finds), len(ldap.binds), len(http.requests))
        accepted = sum(ok for *_, ok in connects)
        by_kind = {k: sum(1 for c in connects if c[0] == k)
                   for k in W.AUTH_KINDS}
        want = ({"mqtt_user": by_kind["mongo"], "mqtt_acl": accepted},
                AUTH_CONNECTS - by_kind["gcp"],
                by_kind["http"] + by_kind["mongo"])
        if asked != want:
            fail(f"auth broker: back ends asked {asked}, expected {want} "
                 f"(Mongo: one ACL find a client, one authn find a Mongo "
                 f"client)")
        lat = {}
        for kind, xs in conn_ms.items():
            xs.sort()
            lat[kind] = [xs[int(len(xs) * q)] for q in (0.5, 0.99)]
            print(f"auth broker: {len(xs)} {kind} CONNECTs "
                  f"CONNECT->CONNACK p50 {lat[kind][0]:.3f} ms p99 "
                  f"{lat[kind][1]:.3f} ms [{results['card']}]", flush=True)
        print(f"auth broker: {AUTH_CONNECTS} CONNECTs in waves of "
              f"{AUTH_WAVE} ({accepted} accepted, 4 refused) in "
              f"{conn_wall:.3f} s, {AUTH_CONNECTS / conn_wall:.1f} "
              f"connects/s; Mongo finds {asked[0]}, LDAP binds {asked[1]}, "
              f"HTTP requests {asked[2]}", flush=True)
        subs = [kept[i] for i in script["subscribers"]]
        for cl in subs:
            C = cl.C
            cl.send(C.Subscribe(packet_id=1, subscriptions=[
                C.Subscription(topic_filter=f, qos=1)
                for f in ("vehicles/+/sensors/#", "nomatch/#")]))
            ack = await cl.expect(C.SUBACK)
            if ack.reason_codes != [1, 0x87]:
                fail(f"auth broker: SUBACK {ack.reason_codes}")
        eng.rebuild()
        items = {i: [] for i in script["publishers"]}
        for k, (i, topic) in enumerate(script["pubs"]):
            items[i].append((k, topic))
        n_ok = sum(1 for k in range(AUTH_MSGS) if k % 8 != 7)
        seen = [0] * len(subs)
        lat_d = []

        async def consume(j, cl):
            C = cl.C
            while seen[j] < n_ok:
                try:
                    pkt = await asyncio.wait_for(cl.inbox.get(), 60)
                except asyncio.TimeoutError:
                    fail(f"auth subscriber {j} stalled at {seen[j]} of "
                         f"{n_ok}")
                if pkt is None:
                    fail(f"auth subscriber {j} disconnected")
                if pkt.type != C.PUBLISH:
                    continue
                cl.send(C.Puback(packet_id=pkt.packet_id))
                k, ts = pkt.payload.split(b":")
                if int(k) % 8 == 7:
                    fail(f"auth subscriber {j} got refused message {k}")
                seen[j] += 1
                lat_d.append(time.perf_counter() - float(ts))

        m = broker.metrics
        deny0 = m["authorization.deny"]
        decides = eng.counters["decide_windows"]
        mk.reset_launches()  # counts of the auth path start here
        t0 = time.perf_counter()
        await asyncio.wait_for(asyncio.gather(
            *(consume(j, cl) for j, cl in enumerate(subs)),
            *(auth_publish(kept[i], its,
                           sum(1 for k, _ in its if k % 8 == 7))
              for i, its in items.items())), 600)
        wall = time.perf_counter() - t0
        launches = mk.launches()
        decides = eng.counters["decide_windows"] - decides
        denied = m["authorization.deny"] - deny0
        if denied != AUTH_MSGS // 8:
            fail(f"auth broker: authorization.deny +{denied}")
        if launches["match_batch_compact"] != decides or \
                launches["decide_packed"] != decides or decides < 1:
            fail(f"auth broker: K1 {launches['match_batch_compact']} and "
                 f"K3 {launches['decide_packed']} launches for {decides} "
                 f"decide windows")
        after = (dict(mongo.finds), len(ldap.binds), len(http.requests))
        if after != asked:
            fail(f"auth broker: back ends asked {after} after CONNECT, "
                 f"{asked} before")
        if m["delivery.dropped"]:
            fail(f"auth broker dropped {m['delivery.dropped']} deliveries")
        lat_d.sort()
        p50, p99 = (lat_d[int(len(lat_d) * q)] * 1e3 for q in (0.5, 0.99))
        n_del = n_ok * len(subs)
        base = results["native"]["broker"]["native"][0]["msgs_per_s"]
        print(f"auth broker: {AUTH_MSGS} QoS 1 publishes from "
              f"{len(items)} clients ({denied} refused, "
              f"authorization.deny {m['authorization.deny']}, PUBACK 0x87) "
              f"in {wall:.3f} s: {n_ok / wall:.1f} msgs/s in (the broker "
              f"phase: {base:.1f}), {n_del} deliveries, "
              f"{n_del / wall:.1f} deliveries/s, delivery p50 {p50:.3f} ms "
              f"p99 {p99:.3f} ms; no back-end request after CONNECT; "
              f"{decides} decide windows; launches {launches} "
              f"[{results['card']}]", flush=True)
        stages = stage_medians("auth broker", broker.profiler)
    finally:
        for cl in kept.values():
            await cl.close()
        await server.stop()
        for f in fixtures:
            await f.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    for name, k in (("match_batch_compact", "match_batch_compact"),
                    ("decide_batch", "decide_packed")):
        results["kernels"][name]["auth"] = {"launches": launches[k]}
    return {"connect_ms": lat, "connects_per_s": AUTH_CONNECTS / conn_wall,
            "asked": {"mongo": asked[0], "ldap": asked[1],
                      "http": asked[2]},
            "msgs_per_s": n_ok / wall, "deliveries": n_del,
            "deliveries_per_s": n_del / wall, "denied": denied,
            "p50_ms": p50, "p99_ms": p99, "decide_windows": decides,
            "broker_msgs_per_s": base, "bcrypt_supported":
            bcrypt_supported(), "stages": stages}


def auth_parity(results) -> None:
    """`workload.authdb_world` at 4,000 filters and 64 clients through
    the card's broker and the CPU's: equal bytes to every client, equal
    metrics, the back ends asked the same."""
    from emqx_tpu_torch import workload as W

    script = W.authdb_script(14, 64, 256, n_gcp=(4, 4), n_msgs=256)
    t0 = time.perf_counter()
    card = W.authdb_world("cuda", script)
    cpu = W.authdb_world("cpu", script)
    for key in ("bytes", "metrics", "asked"):
        if card[key] != cpu[key]:
            bad = [c for c in card[key] if card[key][c] != cpu[key].get(c)]
            fail(f"auth parity: the card's {key} differ from the CPU's "
                 f"at {bad[:3]}")
    print(f"auth parity: {len(script['connects'])} clients over the four "
          f"back ends, {len(script['pubs'])} publishes: the card's broker "
          f"writes the CPU broker's {sum(map(len, card['bytes'].values()))} "
          f"bytes, the same metrics, the back ends asked the same "
          f"{card['asked']['mongo']} ({time.perf_counter() - t0:.1f} s) "
          f"[{results['card']}]", flush=True)


def phase_auth_broker(results, filters) -> None:
    phase("auth backends broker")
    t0 = time.perf_counter()
    from emqx_tpu_torch import workload as W

    keys = auth_rsa_keys(AUTH_GCP[0])
    t_keys = time.perf_counter() - t0
    script = W.authdb_script(
        14, AUTH_CONNECTS, AUTH_MONGO_USERS, n_gcp=AUTH_GCP,
        n_ldap=AUTH_LDAP, n_http=AUTH_HTTP, n_msgs=AUTH_MSGS, rsa_keys=keys)
    print(f"auth broker: {AUTH_GCP[0]} RSA keys in {t_keys:.1f} s (worker "
          f"processes), the script in {time.perf_counter() - t0:.1f} s",
          flush=True)
    results["auth"] = asyncio.run(auth_load(results, filters, script))
    auth_parity(results)
    results["auth"]["phase_s"] = time.perf_counter() - t0


# ------------------------------------------------------- exhook broker

EXHOOK_CLIENTS = 64  # every 16th username refused by the provider
EXHOOK_SUBS = 8  # two on each of workload.EXHOOK_SUB_FILTERS
EXHOOK_MSGS = 2000
EXHOOK_SERVER_PUBLISHES = 500


async def exhook_publish(cl, items) -> None:
    """Publisher ``cl`` sends ``items`` (``(k, topic, want PUBACK
    code)``) at QoS 1, at most 32 unacknowledged, each PUBACK checked."""
    C = cl.C
    window = asyncio.Semaphore(32)
    want = {}
    n_acked = 0

    async def acks():
        nonlocal n_acked
        while n_acked < len(items):
            pkt = await asyncio.wait_for(cl.inbox.get(), 60)
            if pkt is None or pkt.type != C.PUBACK:
                fail(f"{cl.client_id}: expected PUBACK, got {pkt!r}")
            code = want.pop(pkt.packet_id)
            if pkt.reason_code != code:
                fail(f"{cl.client_id}: PUBACK {pkt.reason_code:#x} for "
                     f"packet {pkt.packet_id}, expected {code:#x}")
            n_acked += 1
            window.release()

    task = asyncio.get_running_loop().create_task(acks())
    for j, (k, topic, code) in enumerate(items):
        await window.acquire()
        pid = j % 65535 + 1
        want[pid] = code
        cl.send(C.Publish(topic=topic, qos=1, packet_id=pid,
                          payload=f"{k}:{time.perf_counter()!r}".encode()))
        if j % 32 == 0:
            await cl.writer.drain()
    await task


async def exhook_client_load(results, filters):
    """(a) The broker phase's 1M filters behind an `ExhookClient` that
    dials `workload.ExhookProviderFixture` (the port's own gRPC server,
    in this process) through the server's ``exhooks`` config: 64
    CONNECTs (4 refused at authenticate), 8 subscribers on the four
    wildcard filters, then 2,000 QoS 1 publishes over the verdict
    families from the other 52 (payloads rewritten under ``rw/``,
    dropped under ``drop/``, refused at authorize under ``deny/``).
    Returns the figures and the broker, which part (b) serves."""
    import statistics

    from emqx_tpu_torch import topic as T
    from emqx_tpu_torch import workload as W
    from emqx_tpu_torch.ops import match_kernel as mk

    verdicts = W.exhook_verdicts(15)
    fixture = W.ExhookProviderFixture(verdicts)
    fixture.start()
    impl = W.port_impl("cuda")
    cfg = impl.config.BrokerConfig(listeners=[impl.config.ListenerConfig(
        bind="127.0.0.1", port=0)])
    cfg.sys.enable = False
    cfg.mqtt.max_mqueue_len = 4 * EXHOOK_MSGS
    cfg.exhooks = [{"name": "fixture", "url": fixture.url, "timeout": 10.0,
                    "failure_action": "deny"}]
    server = impl.server(cfg)
    broker = server.broker
    eng = broker.router.engine
    t0 = time.perf_counter()
    eng.insert_many([("/".join(ws), fid) for fid, ws in filters])
    eng.rebuild()
    await server.start()
    client = server.exhook_clients[0]
    if not client.loaded:
        fail("exhook broker: the provider did not load")
    rpc_ms = []
    call = client._call

    def timed(*args):  # the verdict RPC as the broker waits on it
        t = time.perf_counter()
        try:
            return call(*args)
        finally:
            rpc_ms.append((time.perf_counter() - t) * 1e3)

    client._call = timed
    port = server.listeners[0].port
    kept, conn = {}, []
    try:
        print(f"exhook broker: {len(filters)} filters on the card behind "
              f"the provider at {fixture.url} ({client.info()['hooks']}) "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        for i in range(EXHOOK_CLIENTS):
            bad = i % 16 == 15
            cl = Client(port, f"ex-{i}", version=5,
                        username=f"bad-{i}" if bad else f"u-{i}",
                        password=b"pw")
            await cl.connect(rc=0x86 if bad else 0)
            if bad:
                await cl.eof()
            else:
                kept[i] = cl
        ok = sorted(kept)
        subs = ok[:EXHOOK_SUBS]
        pubs = ok[EXHOOK_SUBS:]
        flt_of = {i: W.EXHOOK_SUB_FILTERS[j % 4] for j, i in enumerate(subs)}
        for i in subs:
            await kept[i].subscribe(flt_of[i], 1)
        eng.rebuild()
        rng = __import__("numpy").random.default_rng([15, 3])
        items = {i: [] for i in pubs}
        want = {i: 0 for i in subs}
        for k in range(EXHOOK_MSGS):
            kind = W.EXHOOK_KINDS[k % 4]
            topic = f"{kind}/{int(rng.integers(50))}/t"
            code = 0x87 if kind == "deny" else 0x10 if kind == "drop" else 0
            items[pubs[k % len(pubs)]].append((k, topic, code))
            if code == 0:
                for i in subs:
                    want[i] += T.match(topic, flt_of[i])
        seen = {i: 0 for i in subs}
        lat = []

        async def consume(i):
            cl = kept[i]
            C = cl.C
            while seen[i] < want[i]:
                try:
                    pkt = await asyncio.wait_for(cl.inbox.get(), 60)
                except asyncio.TimeoutError:
                    fail(f"exhook subscriber {i} stalled at {seen[i]} of "
                         f"{want[i]}")
                if pkt is None:
                    fail(f"exhook subscriber {i} disconnected")
                if pkt.type != C.PUBLISH:
                    continue
                cl.send(C.Puback(packet_id=pkt.packet_id))
                kind = pkt.topic.split("/")[0]
                body = pkt.payload
                if kind in ("drop", "deny"):
                    fail(f"exhook subscriber {i} got {pkt.topic}")
                if kind == "rw":
                    if not body.endswith(verdicts["suffix"]):
                        fail(f"exhook subscriber {i}: {pkt.topic} payload "
                             f"{body!r} not rewritten")
                    body = body[:-len(verdicts["suffix"])]
                elif body.endswith(verdicts["suffix"]):
                    fail(f"exhook subscriber {i}: {pkt.topic} rewritten")
                seen[i] += 1
                lat.append(time.perf_counter() - float(body.split(b":")[1]))

        decides = eng.counters["decide_windows"]
        calls0 = dict(fixture.counts)
        rpc_ms.clear()
        mk.reset_launches()  # counts of the exhook path start here
        t0 = time.perf_counter()
        await asyncio.wait_for(asyncio.gather(
            *(consume(i) for i in subs),
            *(exhook_publish(kept[i], its) for i, its in items.items())),
            300)
        wall = time.perf_counter() - t0
        launches = mk.launches()
        decides = eng.counters["decide_windows"] - decides
        if launches["match_batch_compact"] != decides or \
                launches["decide_packed"] != decides or decides < 1:
            fail(f"exhook broker: K1 {launches['match_batch_compact']} and "
                 f"K3 {launches['decide_packed']} launches for {decides} "
                 f"decide windows")
        calls = {k: v - calls0.get(k, 0) for k, v in fixture.counts.items()}
        n_pub = sum(1 for its in items.values() for _k, _t, c in its
                    if c != 0x87)
        if calls.get("OnMessagePublish") != n_pub:
            fail(f"exhook broker: {calls.get('OnMessagePublish')} publish "
                 f"verdicts for {n_pub} authorized publishes")
        n_in = EXHOOK_MSGS
        rpc_ms.sort()
        p50, p99 = (rpc_ms[int(len(rpc_ms) * q)] for q in (0.5, 0.99))
        lat.sort()
        d50, d99 = (lat[int(len(lat) * q)] * 1e3 for q in (0.5, 0.99))
        n_del = sum(want.values())
        print(f"exhook broker: {n_in} QoS 1 publishes from {len(pubs)} "
              f"clients in {wall:.3f} s: {n_in / wall:.1f} msgs/s in, "
              f"{n_del} deliveries ({n_del / wall:.1f}/s, p50 {d50:.3f} "
              f"p99 {d99:.3f} ms), the verdict RPC p50 {p50:.3f} ms p99 "
              f"{p99:.3f} ms over {len(rpc_ms)} calls; provider calls "
              f"{calls}; {decides} decide windows; launches {launches} "
              f"[{results['card']}]", flush=True)
        stages = stage_medians("exhook broker", broker.profiler)
    finally:
        client._call = call
        for cl in kept.values():
            await cl.close()
        await server.stop()
        fixture.stop()
    if fixture._srv.connections:
        fail("exhook broker: the provider kept a connection open")
    return {"msgs_per_s": n_in / wall, "deliveries": n_del,
            "delivery_p50_ms": d50, "delivery_p99_ms": d99,
            "rpc_p50_ms": p50, "rpc_p99_ms": p99, "rpcs": len(rpc_ms),
            "provider_calls": calls, "decide_windows": decides,
            "launches": launches, "stages": stages,
            "wall_s": wall}, broker


def exhook_server_load(results, broker) -> dict:
    """(b) The port's `ExhookServer` on the phase's card broker (its
    exhook client stopped; config 4's 100 rules added), called through
    the port's gRPC client: 500 OnMessagePublish with authenticate and
    authorize calls between them, in turn.  K1 must launch once a
    publish (each runs `Router.match_batch`) and once a republish (the
    republish rule's action publishes on the broker)."""
    from emqx_tpu_torch import grpc_util as G
    from emqx_tpu_torch import workload as W
    from emqx_tpu_torch.exhook import pb
    from emqx_tpu_torch.exhook.server import SERVICE, ExhookServer
    from emqx_tpu_torch.ops import match_kernel as mk
    from emqx_tpu_torch.protobuf import from_dict

    calls, n = [], 0
    for rpc, req in W.exhook_server_script(16, 4 * EXHOOK_SERVER_PUBLISHES):
        if n == EXHOOK_SERVER_PUBLISHES:
            break
        calls.append((rpc, req))
        n += rpc == "OnMessagePublish"
    fired: list = []
    add_fleet_rules(broker, fired)
    broker.router.engine.rebuild()
    srv = ExhookServer(broker=broker)
    srv.start()
    ch = G.Channel(f"127.0.0.1:{srv.port}")
    ms = {}
    try:
        fns = {rpc: ch.unary_unary(
            f"/{SERVICE}/{rpc}", lambda r: r.SerializeToString(),
            pb.ValuedResponse.FromString) for rpc in
            ("OnMessagePublish", "OnClientAuthenticate", "OnClientAuthorize")}
        req_cls = {"OnMessagePublish": pb.MessagePublishRequest,
                   "OnClientAuthenticate": pb.ClientAuthenticateRequest,
                   "OnClientAuthorize": pb.ClientAuthorizeRequest}
        bodies = [(rpc, from_dict(req, req_cls[rpc]())) for rpc, req in calls]
        rep = broker.rules.rules["republish"]
        rep0 = rep.actions_success
        mk.reset_launches()  # counts of the server path start here
        t0 = time.perf_counter()
        for rpc, body in bodies:
            t = time.perf_counter()
            fns[rpc](body, timeout=30)
            ms.setdefault(rpc, []).append((time.perf_counter() - t) * 1e3)
        wall = time.perf_counter() - t0
        launches = mk.launches()
        republished = rep.actions_success - rep0
    finally:
        ch.close()
        srv.stop()
    if srv._grpc.connections:
        fail("exhook server: a connection stayed open after stop")
    if launches["match_batch_compact"] != n + republished or n < 1:
        fail(f"exhook server: K1 {launches['match_batch_compact']} launches "
             f"for {n} OnMessagePublish and {republished} republishes")
    lat = {}
    for rpc, xs in ms.items():
        xs.sort()
        lat[rpc] = [xs[int(len(xs) * q)] for q in (0.5, 0.99)]
        print(f"exhook server: {len(xs)} {rpc} p50 {lat[rpc][0]:.3f} ms p99 "
              f"{lat[rpc][1]:.3f} ms [{results['card']}]", flush=True)
    print(f"exhook server: {len(calls)} calls in {wall:.3f} s "
          f"({len(calls) / wall:.1f} RPCs/s), {len(fired)} rule actions "
          f"fired, {republished} republished, launches {launches} "
          f"[{results['card']}]", flush=True)
    return {"rpc_ms": lat, "rpcs_per_s": len(calls) / wall,
            "publishes": n, "republished": republished, "fired": len(fired),
            "launches": launches}


def exhook_parity(results) -> None:
    """`workload.exhook_world` (4,000 filters, 16 clients, 96 publishes
    through the exhook client) and `workload.exhook_server_world` (64
    calls to `ExhookServer`) on the card and on the CPU: equal CONNACK
    and PUBACK codes, client bytes, provider requests, metrics, server
    responses and rules fired."""
    from emqx_tpu_torch import workload as W

    t0 = time.perf_counter()
    script = W.exhook_script(15, n_clients=16, n_msgs=96)
    card = W.exhook_world("cuda", script)
    cpu = W.exhook_world("cpu", script)
    for key in ("connacks", "pubacks", "bytes", "requests", "counts",
                "metrics"):
        if card[key] != cpu[key]:
            fail(f"exhook parity: the card's {key} differ from the CPU's")
    calls = W.exhook_server_script(15, 64)
    scard = W.exhook_server_world("cuda", calls)
    scpu = W.exhook_server_world("cpu", calls)
    if scard["responses"] != scpu["responses"] or \
            scard["fired"] != scpu["fired"]:
        fail("exhook parity: ExhookServer's answers on the card differ "
             "from the CPU's")
    if scard["launches"]["match_batch_compact"] != scard["publishes"]:
        fail(f"exhook parity: K1 {scard['launches']} for "
             f"{scard['publishes']} publishes")
    print(f"exhook parity: the client world ({len(script['pubs'])} "
          f"publishes, {sum(map(len, card['bytes'].values()))} bytes to "
          f"{len(card['bytes'])} clients, provider calls {card['counts']}) "
          f"and {len(calls)} ExhookServer calls ({len(scard['fired'])} "
          f"rule actions): card = CPU "
          f"({time.perf_counter() - t0:.1f} s) [{results['card']}]",
          flush=True)


def phase_exhook_broker(results, filters) -> None:
    phase("exhook broker")
    t0 = time.perf_counter()
    out, broker = asyncio.run(exhook_client_load(results, filters))
    out["server"] = exhook_server_load(results, broker)
    del broker
    exhook_parity(results)
    out["phase_s"] = time.perf_counter() - t0
    results["exhook"] = out
    for name, k in (("match_batch_compact", "match_batch_compact"),
                    ("decide_batch", "decide_packed")):
        results["kernels"][name]["exhook"] = {
            "launches": out["launches"][k],
            "server_launches": out["server"]["launches"][k]}
    print(f"exhook broker: the phase in {out['phase_s']:.1f} s", flush=True)


# ------------------------------------------------------ durable broker

DUR_SUBS = 512  # persistent sessions, 4 on each vehicle
DUR_KEYS = 128  # vehicles/v{k}/sensors/# filters
DUR_PUBS = 8
DUR_MSGS = 50_000
DUR_PAYLOAD = 256
DUR_WAVE = 64  # CONNECTs in flight while the sessions are made
# mqtt.max_inflight and the clients' receive_maximum in (a) and (b): a
# backend consumer's setting, so a 390-message backlog fits one inflight
# window; (c) runs at the broker's default (32)
DUR_INFLIGHT = 1024
DUR_RESTART_MSGS = 16_384  # 128 a vehicle: over (c)'s inflight window
DUR_RESTART_CLIENTS = 64
DUR_PARITY = (16, 32, 2000)  # durable_script(seed, sessions, messages)


def durable_payload(p: int, j: int) -> bytes:
    head = f"{p}:{j}:".encode()
    return head + b"x" * (DUR_PAYLOAD - len(head))


def durable_topic(p: int, j: int, n_per: int) -> str:
    return f"vehicles/v{(p * n_per + j) % DUR_KEYS}/sensors/temp"


async def durable_boot(filters, data_dir, label, max_inflight=None):
    """A new card broker on ``data_dir`` (durable, lts, fsync always;
    ``mqtt.max_inflight`` set when given, else the default):
    constructed (the store recovers its checkpoints and indexes), the
    1M filters loaded into its engine, then started.  The 1M filters
    stand in for other clients' routes; every boot loads them into its
    own engine, and that load is reported apart from the recovery.
    Returns the server, the recovery time (construction and start) and
    the filter load's seconds."""
    from emqx_tpu_torch import workload as W

    impl = W.port_impl("cuda")
    cfg = impl.config.BrokerConfig(listeners=[impl.config.ListenerConfig(
        bind="127.0.0.1", port=0)])
    cfg.sys.enable = False
    if max_inflight is not None:
        cfg.mqtt.max_inflight = max_inflight
    cfg.durable.enable = True
    cfg.durable.data_dir = data_dir
    cfg.durable.layout = "lts"
    cfg.durable.fsync = "always"
    t0 = time.perf_counter()
    server = impl.server(cfg)
    t_construct = time.perf_counter() - t0
    t1 = time.perf_counter()
    eng = server.broker.router.engine
    eng.insert_many([("/".join(ws), fid) for fid, ws in filters])
    eng.rebuild()
    t_filters = time.perf_counter() - t1
    t2 = time.perf_counter()
    await server.start()
    recovery = t_construct + time.perf_counter() - t2
    boots = len(server.broker.durable.boot_states())
    print(f"durable broker: {label}: recovered {boots} checkpoints in "
          f"{recovery * 1e3:.1f} ms (construction {t_construct * 1e3:.1f} "
          f"ms, start {(recovery - t_construct) * 1e3:.1f} ms); the "
          f"{len(filters)} filters loaded apart in {t_filters:.1f} s "
          f"(max_inflight {cfg.mqtt.max_inflight})", flush=True)
    return server, recovery, t_filters


async def durable_publish(port, n_msgs, label):
    """``DUR_PUBS`` publishers send ``n_msgs`` QoS 1 messages of
    ``DUR_PAYLOAD`` bytes over ``DUR_KEYS`` vehicle topics, at most 64
    unacknowledged each, written 16 a burst; every PUBACK checked.
    Returns (wall s, PUBACK latencies in ms, per-vehicle counts)."""
    per = n_msgs // DUR_PUBS
    pubs = []
    for p in range(DUR_PUBS):
        cl = Client(port, f"dur-pub-{p}", version=5)
        await cl.connect()
        pubs.append(cl)
    lat = []
    per_key = [0] * DUR_KEYS

    async def run(p, cl):
        C = cl.C
        window = asyncio.Semaphore(64)
        sent_at = {}
        done = 0

        async def acks():
            nonlocal done
            while done < per:
                pkt = await asyncio.wait_for(cl.inbox.get(), 120)
                if pkt is None or pkt.type != C.PUBACK:
                    fail(f"{label}: publisher {p} expected PUBACK, got "
                         f"{pkt!r}")
                if pkt.reason_code != 0:
                    fail(f"{label}: PUBACK {pkt.reason_code:#x}")
                lat.append((time.perf_counter() - sent_at.pop(
                    pkt.packet_id)) * 1e3)
                done += 1
                window.release()

        task = asyncio.get_running_loop().create_task(acks())
        burst = []
        for j in range(per):
            await window.acquire()
            pid = j % 65535 + 1
            burst.append(C.Publish(topic=durable_topic(p, j, per), qos=1,
                                   packet_id=pid,
                                   payload=durable_payload(p, j)))
            sent_at[pid] = time.perf_counter()
            if len(burst) == 16 or j == per - 1:
                cl.send(*burst)
                burst = []
                await cl.writer.drain()
        await task

    for p in range(DUR_PUBS):
        for j in range(per):
            per_key[(p * per + j) % DUR_KEYS] += 1
    t0 = time.perf_counter()
    await asyncio.wait_for(asyncio.gather(
        *(run(p, cl) for p, cl in enumerate(pubs))), 600)
    wall = time.perf_counter() - t0
    for cl in pubs:
        cl.send(cl.C.Disconnect())
        await cl.close()
    return wall, lat, per_key, per


def durable_sub_filter(i: int) -> str:
    return f"vehicles/v{i % DUR_KEYS}/sensors/#"


async def durable_reconnect(port, ids, per_key, per, label, metrics,
                            receive_maximum=None):
    """Every client of ``ids`` reconnects at once (clean_start 0, with
    ``receive_maximum`` when given): its CONNACK must say session
    present, then it acknowledges every replayed PUBLISH (one write a
    read) until it holds its whole backlog.  Checks that each client
    got every message of its vehicle, in each publisher's order; counts
    duplicates, and the deliveries that rode a replay window (the
    broker's ``metrics``' ``session.replay.messages``; the rest took
    the per-session mqueue path, which runs no K3).  Returns the
    clients (still connected) and the figures."""
    clients = {i: Client(port, f"dur-{i}", version=5) for i in ids}
    connack_ms, last_ms, got = {}, {}, {i: [] for i in ids}
    props = ({} if receive_maximum is None
             else {"receive_maximum": receive_maximum})
    windowed0 = metrics.val("session.replay.messages")

    async def one(i):
        cl = clients[i]
        C = cl.C
        t0 = time.perf_counter()
        ack = await cl.connect(clean_start=False,
                               session_expiry_interval=3600, **props)
        connack_ms[i] = (time.perf_counter() - t0) * 1e3
        if not ack.session_present:
            fail(f"{label}: dur-{i} resumed without its session")
        want = per_key[i % DUR_KEYS]
        seen = got[i]
        while len(set(seen)) < want:
            try:
                pkt = await asyncio.wait_for(cl.inbox.get(), 120)
            except asyncio.TimeoutError:
                fail(f"{label}: dur-{i} stalled at {len(seen)} of {want}")
            batch = [pkt]
            while not cl.inbox.empty():
                batch.append(cl.inbox.get_nowait())
            acks = []
            for pkt in batch:
                if pkt is None:
                    fail(f"{label}: dur-{i} disconnected")
                if pkt.type != C.PUBLISH:
                    continue
                if pkt.qos:
                    acks.append(C.Puback(packet_id=pkt.packet_id))
                p, j = (int(x) for x in pkt.payload.split(b":")[:2])
                if pkt.topic != durable_topic(p, j, per):
                    fail(f"{label}: dur-{i} got {pkt.topic} for {p}:{j}")
                seen.append((p, j))
            if acks:
                cl.send(*acks)
            last_ms[i] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    await asyncio.wait_for(asyncio.gather(*(one(i) for i in ids)), 600)
    wall = time.perf_counter() - t0
    dups = 0
    for i in ids:
        seen = got[i]
        dups += len(seen) - len(set(seen))
        firsts = list(dict.fromkeys(seen))
        for p in range(DUR_PUBS):
            js = [j for q, j in firsts if q == p]
            if js != sorted(js):
                fail(f"{label}: dur-{i} got publisher {p}'s messages out "
                     f"of order")
            want = [j for j in range(per)
                    if (p * per + j) % DUR_KEYS == i % DUR_KEYS]
            if js != want:
                fail(f"{label}: dur-{i} got {len(js)} of publisher {p}'s "
                     f"{len(want)} messages")
    n = sum(len(v) for v in got.values())
    windowed = metrics.val("session.replay.messages") - windowed0
    return clients, {"connack_ms": connack_ms, "last_ms": last_ms,
                     "wall_s": wall, "replayed": n, "duplicates": dups,
                     "window_deliveries": windowed,
                     "window_share": windowed / (n - dups)}


def durable_pcts(xs) -> tuple:
    xs = sorted(xs)
    return tuple(xs[min(len(xs) - 1, int(len(xs) * q))] for q in (0.5, 0.99))


async def durable_load(results, filters):
    import shutil
    import tempfile

    from emqx_tpu_torch.ops import match_kernel as mk

    data_dir = tempfile.mkdtemp(prefix="durable-phase-")
    out = {}
    try:
        # (a) the backlog: 512 persistent sessions, then 50,000 QoS 1
        server, rec0, t_load = await durable_boot(
            filters, data_dir, "boot", max_inflight=DUR_INFLIGHT)
        broker = server.broker
        port = server.listeners[0].port
        t0 = time.perf_counter()
        for w in range(0, DUR_SUBS, DUR_WAVE):
            async def make(i):
                cl = Client(port, f"dur-{i}", version=5)
                await cl.connect(clean_start=False,
                                 session_expiry_interval=3600,
                                 receive_maximum=DUR_INFLIGHT)
                await cl.subscribe(durable_sub_filter(i), 1)
                cl.send(cl.C.Disconnect())
                await cl.close()
            await asyncio.gather(*(make(i) for i in range(
                w, min(w + DUR_WAVE, DUR_SUBS))))
        print(f"durable broker: (a) {DUR_SUBS} persistent sessions "
              f"subscribed and disconnected in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        mk.reset_launches()
        wall, lat, per_key, per = await durable_publish(port, DUR_MSGS,
                                                       "(a)")
        pub_launches = mk.launches()
        stats = broker.durable.sync_stats()
        captured = broker.durable.gate.appended
        p50, p99 = durable_pcts(lat)
        store = broker.durable.storage.stats()
        if captured != DUR_MSGS or stats["unsynced"] or stats["parked"]:
            fail(f"durable broker: (a) captured {captured} of {DUR_MSGS}, "
                 f"sync_stats {stats}")
        if pub_launches["match_batch_compact"] < 1:
            fail(f"durable broker: (a) launches {pub_launches}")
        out["a"] = {"msgs_per_s": DUR_MSGS / wall, "wall_s": wall,
                    "puback_p50_ms": p50, "puback_p99_ms": p99,
                    "sync_stats": stats, "store": store,
                    "launches": pub_launches, "filters_load_s": t_load}
        print(f"durable broker: (a) {DUR_MSGS} QoS 1 messages of "
              f"{DUR_PAYLOAD} B from {DUR_PUBS} publishers in {wall:.3f} s: "
              f"{DUR_MSGS / wall:.1f} msgs/s in, PUBACK p50 {p50:.3f} ms "
              f"p99 {p99:.3f} ms under the group commit; sync_stats "
              f"{stats}; store {store}; launches {pub_launches} "
              f"[{results['card']}]", flush=True)
        await server.stop()

        # (b) the restart and the reconnect storm
        server, rec1, t_load1 = await durable_boot(
            filters, data_dir, "(b) restart", max_inflight=DUR_INFLIGHT)
        broker = server.broker
        port = server.listeners[0].port
        sizes = []
        resume = broker.resume
        dispatch = resume._dispatch

        def counted(msgs, col_m, *a):
            sizes.append(len(col_m))
            return dispatch(msgs, col_m, *a)

        resume._dispatch = counted
        resumed0 = broker.metrics.val("session.resumed")
        mk.reset_launches()  # the replay's launches start here
        clients, fig = await durable_reconnect(
            port, list(range(DUR_SUBS)), per_key, per, "(b)",
            broker.metrics, receive_maximum=DUR_INFLIGHT)
        replay_launches = mk.launches()
        if resume.committed != DUR_SUBS:
            fail(f"durable broker: (b) {resume.committed} sessions "
                 f"committed of {DUR_SUBS}")
        if replay_launches["decide_packed"] < 1 or not sizes:
            fail(f"durable broker: (b) no replay window reached K3 "
                 f"({replay_launches}, windows {sizes})")
        c50, c99 = durable_pcts(fig["connack_ms"].values())
        l50, l99 = durable_pcts(fig["last_ms"].values())
        out["b"] = {
            "connack_p50_ms": c50, "connack_p99_ms": c99,
            "last_publish_p50_ms": l50, "last_publish_p99_ms": l99,
            "last_publish_max_ms": max(fig["last_ms"].values()),
            "replayed": fig["replayed"], "duplicates": fig["duplicates"],
            "replayed_per_s": fig["replayed"] / fig["wall_s"],
            "wall_s": fig["wall_s"], "session_resumed": resume.committed,
            "session_resumed_metric": broker.metrics.val(
                "session.resumed") - resumed0,
            "windows": len(sizes), "window_sizes": sizes,
            "window_deliveries": fig["window_deliveries"],
            "window_share": fig["window_share"],
            "launches": replay_launches, "recovery_ms": rec1 * 1e3,
            "filters_load_s": t_load1}
        print(f"durable broker: (b) {DUR_SUBS} sessions reconnected at "
              f"once (max_concurrent {resume.cfg.max_concurrent}): "
              f"CONNACK p50 {c50:.3f} ms p99 {c99:.3f} ms; CONNECT to the "
              f"last replayed PUBLISH p50 {l50:.1f} ms p99 {l99:.1f} ms; "
              f"{fig['replayed']} replayed in {fig['wall_s']:.3f} s "
              f"({out['b']['replayed_per_s']:.1f} msgs/s), "
              f"{fig['duplicates']} duplicates, none lost; "
              f"{fig['window_deliveries']} of the deliveries "
              f"({fig['window_share']:.4f}) rode a replay window, the rest "
              f"the mqueue path; session.resumed "
              f"{resume.committed}; {len(sizes)} replay windows of "
              f"{min(sizes)}-{max(sizes)} deliveries (median "
              f"{sorted(sizes)[len(sizes) // 2]}); launches "
              f"{replay_launches} [{results['card']}]", flush=True)
        out["b"]["stages"] = stage_medians("durable broker (b)",
                                           broker.profiler)
        # every session disconnects (checkpointed) and a second backlog
        # arrives
        for cl in clients.values():
            cl.send(cl.C.Disconnect())
            await cl.close()
        await asyncio.sleep(0.2)  # the server's teardowns run
        wall2, _lat, per_key2, per2 = await durable_publish(
            port, DUR_RESTART_MSGS, "(c)")
        await server.stop()

        # (c) a restart at the broker's default max_inflight (32): 64
        # sessions resume their second backlog (128 each, over the
        # inflight window)
        server, rec2, t_load2 = await durable_boot(
            filters, data_dir, "(c) restart")
        port = server.listeners[0].port
        mk.reset_launches()
        clients, fig = await durable_reconnect(
            port, list(range(DUR_RESTART_CLIENTS)), per_key2, per2, "(c)",
            server.broker.metrics)
        c_launches = mk.launches()
        if server.broker.resume.committed != DUR_RESTART_CLIENTS:
            fail(f"durable broker: (c) {server.broker.resume.committed} "
                 f"committed of {DUR_RESTART_CLIENTS}")
        out["c"] = {"recovery_ms": rec2 * 1e3,
                    "replayed": fig["replayed"],
                    "duplicates": fig["duplicates"],
                    "wall_s": fig["wall_s"], "launches": c_launches,
                    "window_deliveries": fig["window_deliveries"],
                    "window_share": fig["window_share"],
                    "max_inflight": server.broker.config.mqtt.max_inflight,
                    "filters_load_s": t_load2,
                    "boot_states": len(server.broker.durable.boot_states())}
        print(f"durable broker: (c) boot to listening {rec2 * 1e3:.1f} ms "
              f"over {DUR_SUBS} checkpoints (the filter load apart); "
              f"{DUR_RESTART_CLIENTS} sessions at max_inflight "
              f"{out['c']['max_inflight']} replayed {fig['replayed']} "
              f"messages ({fig['duplicates']} duplicates) in "
              f"{fig['wall_s']:.3f} s; {fig['window_deliveries']} of the "
              f"deliveries ({fig['window_share']:.4f}) rode a replay "
              f"window, the rest the mqueue path; launches {c_launches} "
              f"[{results['card']}]", flush=True)
        for cl in clients.values():
            await cl.close()
        await server.stop()
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    return out


def durable_parity(results) -> dict:
    """(d) `workload.durable_world` (20,000 filters, 32 persistent
    sessions, 2,000 messages, a restart, the resume drained loop-less)
    on the card and on the CPU, windowed and scalar: equal client bytes
    and replay metrics; the card's windowed replay launched K3 once a
    replay window."""
    from emqx_tpu_torch import workload as W

    t0 = time.perf_counter()
    script = W.durable_script(*DUR_PARITY)
    out = {}
    for windowed in (True, False):
        card = W.durable_world("cuda", script, windowed=windowed)
        cpu = W.durable_world("cpu", script, windowed=windowed)
        mode = "windowed" if windowed else "scalar"
        if card["bytes"] != cpu["bytes"]:
            fail(f"durable parity: the card's {mode} replay bytes differ "
                 f"from the CPU's")
        if card["metrics"] != cpu["metrics"]:
            fail(f"durable parity: {mode} metrics {card['metrics']} on "
                 f"the card, {cpu['metrics']} on the CPU")
        if card["committed"] != DUR_PARITY[1]:
            fail(f"durable parity: {card['committed']} sessions committed")
        if windowed and card["replay_launches"]["decide_packed"] != \
                card["metrics"]["session.replay.windows"]:
            fail(f"durable parity: K3 {card['replay_launches']} for "
                 f"{card['metrics']['session.replay.windows']} windows")
        out[mode] = {"bytes": sum(map(len, card["bytes"].values())),
                     "metrics": card["metrics"],
                     "replay_launches": card["replay_launches"]}
    print(f"durable parity: {DUR_PARITY[1]} sessions, {DUR_PARITY[2]} "
          f"messages, windowed and scalar replay: card = CPU "
          f"({out['windowed']['bytes']} bytes; windowed "
          f"{out['windowed']['metrics']}) "
          f"({time.perf_counter() - t0:.1f} s) [{results['card']}]",
          flush=True)
    return out


def phase_durable_broker(results, filters) -> None:
    phase("durable broker")
    t0 = time.perf_counter()
    out = asyncio.run(durable_load(results, filters))
    out["d"] = durable_parity(results)
    out["phase_s"] = time.perf_counter() - t0
    results["durable"] = out
    results["kernels"]["match_batch_compact"]["durable"] = {
        "publish_launches": out["a"]["launches"]["match_batch_compact"],
        "replay_launches": out["b"]["launches"]["match_batch_compact"]}
    results["kernels"]["decide_batch"]["durable"] = {
        "publish_launches": out["a"]["launches"]["decide_packed"],
        "replay_launches": out["b"]["launches"]["decide_packed"],
        "restart_replay_launches": out["c"]["launches"]["decide_packed"],
        "replay_window_share": out["b"]["window_share"],
        "restart_replay_window_share": out["c"]["window_share"],
        "replay_windows": out["b"]["windows"]}
    print(f"durable broker: the phase in {out['phase_s']:.1f} s", flush=True)


# ------------------------------------------------------------ listeners

LISTENER_KINDS = ("tcp", "ssl", "ws", "wss")
LISTENER_ENV = {"EMQX_TPU_MQTT__MAX_MQUEUE_LEN": str(4 * N_PUB * N_MSG)}
FAIR_FLOOD, FAIR_LIGHT, FAIR_GAP_S = 20_000, 50, 0.02
# light's PUBACK p50 bound: a few windows' time.  Behind one FIFO each
# light message would wait for the flood's backlog (20,000 messages at
# ~10,000 msgs/s on the H100: ~2 s)
FAIR_LIGHT_P50_MS = 250.0
STALL_MSGS, STALL_PAYLOAD = 2_000, 16 * 1024


def listeners_config(tmp: str) -> tuple:
    """A JSON config with a tcp, an ssl, a ws and a wss listener on
    127.0.0.1 port 0 (the TLS ones on the committed test certificate),
    and a copy broken by an ssl listener without its certificate."""
    conf = {"listeners": [
        {"name": f"{k}_smoke", "type": k, "bind": "127.0.0.1", "port": 0,
         **({"certfile": TLS_CERT, "keyfile": TLS_KEY}
            if k in ("ssl", "wss") else {})} for k in LISTENER_KINDS]}
    good = os.path.join(tmp, "broker.json")
    bad = os.path.join(tmp, "broken.json")
    with open(good, "w") as f:
        json.dump(conf, f)
    del conf["listeners"][1]["certfile"]
    with open(bad, "w") as f:
        json.dump(conf, f)
    return good, bad


async def listeners_cli(results, good: str, bad: str) -> None:
    """``--check-config`` on the config (exit 0) and on its broken copy
    (exit 1), then ``python -m emqx_tpu_torch.broker --config`` on the
    card: its four listening lines, one QoS 1 round trip on each
    transport, terminated."""
    from emqx_tpu_torch.codec import mqtt as C

    env = dict(os.environ, PYTHONPATH=HERE, **LISTENER_ENV)

    def start(*args):
        return asyncio.create_subprocess_exec(
            sys.executable, "-m", "emqx_tpu_torch.broker", "--config", *args,
            cwd=HERE, env=env, stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE)

    t0 = time.perf_counter()
    checks = [await start(good, "--check-config"),
              await start(bad, "--check-config")]
    proc = await start(good)
    try:
        for p, want, name in zip(checks, (0, 1), ("config", "broken copy")):
            out, err = await asyncio.wait_for(p.communicate(), 120)
            if p.returncode != want:
                fail(f"--check-config on the {name} exited {p.returncode}, "
                     f"expected {want}: {out.decode()} {err.decode()}")
            print(f"listeners: --check-config on the {name}: exit "
                  f"{p.returncode}, {(out or err).decode().strip()!r}",
                  flush=True)
        ports, lines = {}, []
        for _ in LISTENER_KINDS:
            line = (await asyncio.wait_for(proc.stdout.readline(), 300)
                    ).decode()
            lines.append(line.strip())
            if "listening on 127.0.0.1:" not in line or \
                    "(device cuda)" not in line:
                err = (await proc.stderr.read()).decode()[-2000:]
                fail(f"broker CLI did not start its listeners on the card: "
                     f"{line!r} {err}")
            kind = line.split("(")[1].split(")")[0]
            ports[kind] = int(line.split("127.0.0.1:")[1].split()[0])
        if sorted(ports) != sorted(LISTENER_KINDS):
            fail(f"broker CLI listeners {lines}")
        boot_s = time.perf_counter() - t0
        for kind in LISTENER_KINDS:
            sub = Client(ports[kind], f"cli-sub-{kind}", kind=kind)
            pub = Client(ports[kind], f"cli-pub-{kind}", kind=kind)
            await sub.connect()
            await pub.connect()
            await sub.subscribe(f"cli/{kind}/+", 1)
            pub.send(C.Publish(topic=f"cli/{kind}/x", payload=b"hi", qos=1,
                               packet_id=7))
            await pub.expect(C.PUBACK)
            got = await sub.expect(C.PUBLISH)
            if (got.topic, got.payload, got.qos) != (f"cli/{kind}/x", b"hi",
                                                     1):
                fail(f"CLI round trip over {kind} delivered {got!r}")
            sub.send(C.Puback(packet_id=got.packet_id))
            await sub.close()
            await pub.close()
        print(f"listeners: python -m emqx_tpu_torch.broker --config on the "
              f"card: {lines}; a QoS 1 round trip on each of "
              f"{', '.join(LISTENER_KINDS)} ok ({boot_s:.1f} s to the "
              f"listening lines) [{results['card']}]", flush=True)
    finally:
        for p in checks + [proc]:
            if p.returncode is None:
                p.terminate()
                try:
                    await asyncio.wait_for(p.wait(), 20)
                except asyncio.TimeoutError:
                    p.kill()
                    await p.wait()


async def listeners_transports(results, server, ports) -> dict:
    """The broker phase's load split over the four transports: 8
    subscribers (2 on each), 4 publishers (one on each) x 1,000 QoS 1
    messages; exactly once to every subscriber; K1 and K3 counted."""
    from emqx_tpu_torch.ops import match_kernel as mk

    eng = server.broker.router.engine
    subs, kinds = [], []
    for j, flt in enumerate(SUB_FILTERS):
        kind = LISTENER_KINDS[j % 4]
        cl = Client(ports[kind], f"lsub{j}", kind=kind)
        await cl.connect()
        await cl.subscribe(flt, 1)
        subs.append(cl)
        kinds.append(kind)
    eng.rebuild()  # the subscribers' filters onto the card as well
    pubs = []
    for p, kind in enumerate(LISTENER_KINDS):
        cl = Client(ports[kind], f"lpub{p}", kind=kind)
        await cl.connect()
        pubs.append(cl)
    C = subs[0].C
    expected = N_PUB * N_MSG
    lat = {k: [] for k in LISTENER_KINDS}
    seen = [set() for _ in subs]

    async def consume(j, cl):
        while len(seen[j]) < expected:
            try:
                pkt = await asyncio.wait_for(cl.inbox.get(), 60)
            except asyncio.TimeoutError:
                fail(f"lsub{j} ({kinds[j]}) stalled at {len(seen[j])} of "
                     f"{expected}; received {[len(x) for x in seen]}")
            if pkt is None:
                fail(f"lsub{j} ({kinds[j]}) disconnected")
            if pkt.type != C.PUBLISH:
                continue
            cl.send(C.Puback(packet_id=pkt.packet_id))
            p, k, ts = pkt.payload.split(b":")
            key = (int(p), int(k))
            if key in seen[j]:
                fail(f"lsub{j} ({kinds[j]}) got message {key} twice")
            seen[j].add(key)
            lat[kinds[j]].append(time.perf_counter() - float(ts))

    decides = eng.counters["decide_windows"]
    mk.reset_launches()  # this run's counts start here
    t0 = time.perf_counter()
    await asyncio.wait_for(asyncio.gather(
        *(consume(j, cl) for j, cl in enumerate(subs)),
        *(publish_load(cl, p, N_MSG) for p, cl in enumerate(pubs)),
    ), 600)
    wall = time.perf_counter() - t0
    launches = mk.launches()
    decides = eng.counters["decide_windows"] - decides
    for j in range(len(subs)):
        if len(seen[j]) != expected:
            fail(f"lsub{j} got {len(seen[j])} of {expected}")
    if launches["match_batch_compact"] != decides or \
            launches["decide_packed"] != decides:
        fail(f"listeners: K1 {launches['match_batch_compact']} and K3 "
             f"{launches['decide_packed']} launches for {decides} decide "
             f"windows")
    dropped = server.broker.metrics["delivery.dropped"]
    if dropped:
        fail(f"listeners: the broker dropped {dropped} deliveries")
    per = {}
    for kind, xs in lat.items():
        xs.sort()
        per[kind] = {"p50_ms": xs[len(xs) // 2] * 1e3,
                     "p99_ms": xs[int(len(xs) * 0.99)] * 1e3}
    print(f"listeners transports: {expected} QoS 1 messages from one "
          f"publisher on each of {', '.join(LISTENER_KINDS)} each delivered "
          f"exactly once to {len(subs)} subscribers (2 a transport) in "
          f"{wall:.3f} s: {expected / wall:.1f} msgs/s in, "
          f"{expected * len(subs) / wall:.1f} deliveries/s; delivery p50/p99 "
          f"ms by the subscriber's transport: "
          + ", ".join(f"{k} {v['p50_ms']:.3f}/{v['p99_ms']:.3f}"
                      for k, v in per.items())
          + f"; {decides} decide windows, launches K1 "
          f"{launches['match_batch_compact']} K3 {launches['decide_packed']}"
          f" [{results['card']}]", flush=True)
    for name, k in (("match_batch_compact", "match_batch_compact"),
                    ("decide_batch", "decide_packed")):
        results["kernels"][name]["listeners"] = {"launches": launches[k]}
    for cl in subs + pubs:
        await cl.close()
    return {"msgs_per_s": expected / wall,
            "deliveries_per_s": expected * len(subs) / wall,
            "latency": per, "decide_windows": decides}


def alarm_log(broker) -> list:
    """Every activate and deactivate of the broker's alarms, in order."""
    log_, reg = [], broker.alarms
    act, deact = reg.activate, reg.deactivate

    def activate(name, *a, **kw):
        log_.append(("raise", name))
        return act(name, *a, **kw)

    def deactivate(name, *a, **kw):
        log_.append(("clear", name))
        return deact(name, *a, **kw)

    reg.activate, reg.deactivate = activate, deactivate
    return log_


async def listeners_fairness(results, server, ports, windows, alarms,
                             gone) -> dict:
    """F2 on the card's server: ``flood`` sends 20,000 QoS 0 messages
    back to back while ``light`` sends 50 QoS 1 messages 20 ms apart,
    timing each PUBACK; a subscriber on ``fair/#`` gets all of them."""
    fsub = Client(ports["tcp"], "fair-sub")
    flood = Client(ports["tcp"], "flood")
    light = Client(ports["tcp"], "light")
    for cl in (fsub, flood, light):
        await cl.connect()
    C = fsub.C
    await fsub.subscribe("fair/#", 1)
    del windows[:]
    n_alarms = len(alarms)
    got = {"f": 0, "l": 0}
    t_flood_done, t_sent = [None], [None]

    def why() -> str:
        m = server.broker.metrics
        return (f"received {got}, {len(windows)} windows, disconnects "
                f"{gone}, metrics " + str({k: v for k, v in m.all().items()
                                          if v and ("dropped" in k or
                                                    "received" in k)}))

    async def consume():
        while got["f"] < FAIR_FLOOD or got["l"] < FAIR_LIGHT:
            try:
                pkt = await asyncio.wait_for(fsub.inbox.get(), 120)
            except asyncio.TimeoutError:
                fail(f"fair-sub stalled: {why()}")
            if pkt is None:
                fail(f"fair-sub disconnected: {why()}")
            if pkt.type != C.PUBLISH:
                continue
            if pkt.qos:
                fsub.send(C.Puback(packet_id=pkt.packet_id))
            got[pkt.topic[-1]] += 1
            if got["f"] == FAIR_FLOOD and t_flood_done[0] is None:
                t_flood_done[0] = time.perf_counter()

    async def blast():
        # 256 publishes a write, as a client library flushes a burst.
        # One publish a write crawls on the card's machine whether or
        # not the broker pauses its reads: 20,000 took 165-178 s with
        # ~1,630 segments resent, against 2 s at 256 a write
        # (tools/torch_flood_probe.py)
        for k in range(0, FAIR_FLOOD, 256):
            flood.send(*(C.Publish(topic="fair/f", payload=b"%d" % i, qos=0)
                         for i in range(k, min(k + 256, FAIR_FLOOD))))
            await flood.writer.drain()
        t_sent[0] = time.perf_counter()

    async def trickle():
        acks = []
        for k in range(FAIR_LIGHT):
            t = time.perf_counter()
            light.send(C.Publish(topic="fair/l", payload=b"%d" % k, qos=1,
                                 packet_id=k + 1))
            await light.expect(C.PUBACK, 60)
            acks.append((time.perf_counter() - t) * 1e3)
            await asyncio.sleep(max(0.0, FAIR_GAP_S - (time.perf_counter()
                                                       - t)))
        return acks

    t0 = time.perf_counter()
    _, _, acks = await asyncio.wait_for(asyncio.gather(
        consume(), blast(), trickle()), 300)
    flood_s = t_flood_done[0] - t0
    acks.sort()
    seen = alarms[n_alarms:]
    flaps = seen.count(("raise", "publish_queue_congested"))
    raised = flaps > 0
    cleared = raised and "publish_queue_congested" not in [
        a.name for a in server.broker.alarms.active()]
    largest = max(windows)
    if largest > 512:
        fail(f"fairness: a window of {largest} messages (the limit is 512)")
    if not (raised and cleared):
        fail(f"fairness: publish_queue_congested raised {raised}, cleared "
             f"{cleared} (both expected)")
    if acks[len(acks) // 2] > FAIR_LIGHT_P50_MS:
        fail(f"fairness: light's PUBACK p50 {acks[len(acks) // 2]:.3f} ms "
             f"(over {FAIR_LIGHT_P50_MS} ms: light waits behind the flood)")
    out = {"light_puback_p50_ms": acks[len(acks) // 2],
           "light_puback_p99_ms": acks[int(len(acks) * 0.99)],
           "largest_window": largest, "windows": len(windows),
           "congested_raised": raised, "congested_cleared": cleared,
           "congested_raises": flaps,
           "flood_msgs_per_s": FAIR_FLOOD / flood_s,
           "flood_sent_s": t_sent[0] - t0,
           "stages": stage_medians("listeners fairness",
                                   server.broker.profiler)}
    print(f"listeners fairness: flood {FAIR_FLOOD} QoS 0 back to back at "
          f"{out['flood_msgs_per_s']:.1f} msgs/s (to the subscriber's last "
          f"flood message; its socket took the last one after "
          f"{out['flood_sent_s']:.3f} s), light {FAIR_LIGHT} QoS 1 every "
          f"{FAIR_GAP_S * 1e3:.0f} ms: PUBACK p50 "
          f"{out['light_puback_p50_ms']:.3f} ms p99 "
          f"{out['light_puback_p99_ms']:.3f} ms; {len(windows)} windows, the "
          f"largest {largest} messages; publish_queue_congested raised "
          f"{raised} ({flaps} times), cleared {cleared} "
          f"[{results['card']}]", flush=True)
    for cl in (fsub, flood, light):
        await cl.close()
    return out


async def listeners_stall(results, server, ports, alarms) -> dict:
    """F1 on the card's server: a v5 QoS 1 subscriber on ``w/#`` (an
    inflight window and an mqueue that hold the whole run) stops reading
    while 2,000 QoS 1 messages of 16 KiB go to ``w/x``, then reads
    again.  Its transport buffer's peak while stalled stays under the
    watermark plus one window's bytes, ``conn_congestion/stall`` is
    raised and then cleared (at the next write, its PINGRESP), and every
    message arrives exactly once, in order."""
    from emqx_tpu_torch.config import ConfigHandler

    broker = server.broker
    # the inflight window must not be what holds the stalled deliveries
    ConfigHandler(broker.config).update("mqtt.max_inflight", 4096)
    stall = Client(ports["tcp"], "stall", version=5)
    await stall.connect(receive_maximum=4096)
    await stall.subscribe("w/#", 1)
    C = stall.C
    ch = broker.cm.channel("stall")
    session = broker.cm.lookup("stall")
    peak = {"stall": 0, "drain": 0}
    phase_ = ["stall"]
    send = ch._send

    def spy(pkts):
        send(pkts)
        peak[phase_[0]] = max(peak[phase_[0]], ch.out_buffered())

    ch._send = spy
    n_alarms = len(alarms)
    dropped0 = broker.metrics["delivery.dropped"]
    stall.pause()
    pub = Client(ports["tcp"], "stall-pub")
    await pub.connect()
    pad = b"x" * STALL_PAYLOAD
    window = asyncio.Semaphore(32)
    t0 = time.perf_counter()

    async def acks():
        for _ in range(STALL_MSGS):
            await pub.expect(C.PUBACK, 60)
            window.release()

    task = asyncio.get_running_loop().create_task(acks())
    for k in range(STALL_MSGS):
        await window.acquire()
        pub.send(C.Publish(topic="w/x", payload=b"%06d:" % k + pad, qos=1,
                           packet_id=k % 65535 + 1))
        if k % 32 == 0:
            await pub.writer.drain()
    await asyncio.wait_for(task, 300)
    pub_s = time.perf_counter() - t0
    parked = len(session.mqueue)
    was_parked = session.out_parked
    congested = ("raise", "conn_congestion/stall") in alarms[n_alarms:]
    phase_[0] = "drain"
    stall.resume()
    order = []
    while len(order) < STALL_MSGS:
        pkt = await asyncio.wait_for(stall.inbox.get(), 120)
        if pkt is None:
            fail("stall: the subscriber was disconnected")
        if pkt.type != C.PUBLISH:
            continue
        stall.send(C.Puback(packet_id=pkt.packet_id))
        order.append(int(pkt.payload[:6]))
    stall.send(C.Pingreq())
    while True:
        pkt = await asyncio.wait_for(stall.inbox.get(), 30)
        if pkt is None:
            fail("stall: the subscriber was disconnected")
        if pkt.type == C.PINGRESP:
            break
    drain_s = time.perf_counter() - t0 - pub_s
    cleared = "conn_congestion/stall" not in [
        a.name for a in broker.alarms.active()]
    wm = broker.config.mqtt.outbound_high_watermark
    one = len(C.serialize(C.Publish(topic="w/x", payload=b"%06d:" % 0 + pad,
                                    qos=1, packet_id=1), C.MQTT_V5))
    bound = wm + 512 * one
    if order != list(range(STALL_MSGS)):
        fail(f"stall: {len(order)} messages, {len(set(order))} distinct, "
             f"not in order: first break at "
             f"{next(i for i, k in enumerate(order) if k != i)}")
    if broker.metrics["delivery.dropped"] != dropped0:
        fail("stall: QoS 1 deliveries were dropped")
    if not (congested and cleared):
        fail(f"stall: conn_congestion/stall raised {congested}, cleared "
             f"{cleared}: {alarms[n_alarms:]}")
    if not (was_parked and parked) or peak["stall"] >= bound:
        fail(f"stall: {parked} parked (out_parked {was_parked}), transport "
             f"buffer peak {peak['stall']} B against {bound} B")
    out = {"peak_stall_bytes": peak["stall"], "bound_bytes": bound,
           "watermark_bytes": wm, "peak_drain_bytes": peak["drain"],
           "parked": parked, "publish_s": pub_s, "drain_s": drain_s,
           "out_buffer_drops": broker.metrics["delivery.dropped.out_buffer"],
           "congested": congested, "cleared": cleared}
    print(f"listeners stall: {STALL_MSGS} QoS 1 messages of {one} B to a "
          f"stalled v5 subscriber in {pub_s:.3f} s: transport buffer peak "
          f"{peak['stall']} B while stalled (watermark {wm} B + one window "
          f"{512 * one} B = {bound} B), {parked} parked on its mqueue; "
          f"conn_congestion/stall raised, then cleared at its PINGRESP; "
          f"after it read again every message arrived once, in order, in "
          f"{drain_s:.3f} s (the drain's peak {peak['drain']} B) "
          f"[{results['card']}]", flush=True)
    await stall.close()
    await pub.close()
    return out


async def listeners_load(results, filters, good: str) -> dict:
    """An in-process `BrokerServer` from the config file (with one
    environment override) on the card, the 1M filters in its engine:
    the transports, fairness and stall parts in turn."""
    from emqx_tpu_torch.broker.listener import BrokerServer
    from emqx_tpu_torch.config import ConfigHandler, apply_env_overrides

    cfg = ConfigHandler.load(good).root
    applied = apply_env_overrides(cfg, environ=dict(LISTENER_ENV))
    server = BrokerServer(cfg)
    eng = server.broker.router.engine
    t0 = time.perf_counter()
    eng.insert_many([("/".join(ws), fid) for fid, ws in filters])
    windows = []
    prepare = server.broker.publish_prepare
    server.broker.publish_prepare = lambda msgs: windows.append(
        len(msgs)) or prepare(msgs)
    alarms = alarm_log(server.broker)
    gone = []  # (client id, reason) of every connection that ended
    server.broker.hooks.add("client.disconnected", lambda client, reason:
                            gone.append((client.clientid, reason)))
    await server.start()
    try:
        ports = {lst.cfg.type: lst.port for lst in server.listeners}
        print(f"listeners: BrokerServer from {os.path.basename(good)} with "
              f"env overrides {applied}: {len(filters)} filters, listeners "
              f"{ports} ({time.perf_counter() - t0:.1f} s)", flush=True)
        out = {"transports": await listeners_transports(results, server,
                                                        ports)}
        out["transports"]["largest_window"] = max(windows)
        out["fairness"] = await listeners_fairness(results, server, ports,
                                                   windows, alarms, gone)
        out["stall"] = await listeners_stall(results, server, ports, alarms)
    finally:
        await server.stop()
    return out


def phase_listeners(results, filters) -> None:
    import tempfile

    phase("listeners")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        good, bad = listeners_config(tmp)
        asyncio.run(listeners_cli(results, good, bad))
        results["listeners"] = asyncio.run(listeners_load(results, filters,
                                                          good))
    results["listeners"]["phase_s"] = time.perf_counter() - t0


# ------------------------------------------------------ native host path


def phase_native_build(results) -> None:
    """The four host libraries from ``emqx_tpu_torch/native`` (one g++
    each, all started together); any compiler error or output fails."""
    from emqx_tpu_torch.ops import _native

    phase("native build")
    try:
        _native.build()
        _native.load_all()
    except RuntimeError as exc:
        fail(f"native build: {exc}")
    for name in _native.NAMES:
        info = _native.build_info[name]
        if info["log"].strip():
            fail(f"native build: {_native.CXX} reported on {name}:\n"
                 f"{info['log']}")
        print(f"native build: emqx_tpu_torch/native/{name}.cpp with "
              f"{_native.CXX} {' '.join(_native.CXX_FLAGS)}: no compiler "
              f"output, {info['seconds']:.2f} s (all four together) -> "
              f"{os.path.relpath(info['path'], HERE)}", flush=True)
    results["native"] = {}


def wire_builders(msgs, runs):
    """Two builders of one window's wire for the client ``runs``
    (``(version, msg idx, effective qos, retain)`` columns, packet ids
    1.. in each QoS>0 run): the native splice plan, assembled in one
    call, and the per-delivery Python encoder.  Each returns the bytes
    of every run, concatenated."""
    import numpy as np

    from emqx_tpu_torch.codec import mqtt as C
    from emqx_tpu_torch.ops import dispatchasm

    def native():
        enc = C.DispatchEncoder()
        bodies, pids = [], []
        for ver, sm, eff, ret in runs:
            bodies.append(enc.key_slots(msgs, ver, sm * 6 + eff * 2 + ret))
            pid = np.full(len(sm), -1, np.int64)
            pend = np.flatnonzero(eff > 0)
            pid[pend] = np.arange(1, len(pend) + 1)
            pids.append(pid)
        body, pid = np.concatenate(bodies), np.concatenate(pids)
        run_start = np.zeros(len(runs), np.int64)
        np.cumsum([len(b) for b in bodies][:-1], out=run_start[1:])
        _ho, hl, _to, tl = enc.span_arrays()
        sizes = np.add.reduceat(hl[body] + tl[body] + 2 * (pid >= 0),
                                run_start)
        run_out = np.zeros(len(runs), np.int64)
        np.cumsum(sizes[:-1], out=run_out[1:])
        out = bytearray(int(sizes.sum()))
        if dispatchasm.assemble_window(enc.native_views(), body, pid,
                                       run_start, run_out, out) != len(out):
            fail("native window assembly wrote a short window")
        return bytes(out)

    def python():
        enc = C.DispatchEncoder()
        parts = []
        for ver, sm, eff, ret in runs:
            pid = 0
            for i, q, r in zip(sm.tolist(), eff.tolist(), ret.tolist()):
                if q == 0:
                    pkt = enc.publish_qos0(msgs[i], r, ver)
                else:
                    pid += 1
                    pkt = enc.publish(msgs[i], q, r, pid, ver)
                parts.append(C.serialize(pkt, ver))
        return b"".join(parts)

    return native, python


def phase_native_parity() -> None:
    """Each native helper against its Python referee on this machine,
    on random inputs: exact equality."""
    import numpy as np

    from emqx_tpu_torch.codec import mqtt as C
    from emqx_tpu_torch.message import Message
    from emqx_tpu_torch.ops.automaton import encode_filters
    from emqx_tpu_torch.ops.dictionary import TokenDict, encode_topics
    from emqx_tpu_torch.ops.sortutil_native import (
        argsort_i64, unique_inverse_i64,
    )
    from emqx_tpu_torch.ops.trie_host import HostTrie
    from emqx_tpu_torch.ops.trie_native import NativeTrie

    phase("native parity")
    rng = np.random.default_rng(11)
    words = ["a", "b", "", "$SYS", "x", "dev", "é"]

    def rand_filter():
        ws = [str(rng.choice(words + ["+"]))
              for _ in range(rng.integers(0, 5))]
        if not ws or rng.random() < 0.3:
            ws.append("#")
        return "/".join(ws)

    nat, host = NativeTrie(), HostTrie()
    for step in range(5000):
        fid = int(rng.integers(0, 800)) if step % 3 else f"s{step % 97}"
        if rng.random() < 0.2:
            if nat.delete_id(fid) != host.delete_id(fid):
                fail(f"native trie: delete_id({fid!r}) differs")
        else:
            flt = rand_filter()
            if nat.insert(flt, fid) != host.insert(flt, fid):
                fail(f"native trie: insert({flt!r}, {fid!r}) differs")
    last = host.last_seq()
    n_topics = 3000
    for _ in range(n_topics):
        ws = tuple(str(rng.choice(words)) for _ in range(rng.integers(1, 6)))
        if nat.match_words(ws) != host.match_words(ws):
            fail(f"native trie: match_words({ws}) differs")
        w = int(rng.integers(0, last + 2))
        if nat.match_since_words(ws, w) != host.match_since_words(ws, w):
            fail(f"native trie: match_since_words({ws}, {w}) differs")
    items = [(i, tuple(rand_filter().split("/"))) for i in range(20000)]
    td_n, td_p = TokenDict(), TokenDict()
    a = encode_filters(items, td_n, 16, native=True)
    b = encode_filters(items, td_p, 16, native=False)
    if any(not np.array_equal(x, y) for x, y in zip(a[:3], b[:3])) or \
            list(td_n._ids.items()) != list(td_p._ids.items()):
        fail("native encoder: filter rows or token ids differ")
    topics = ["/".join(str(rng.choice(words + ["q"]))
                       for _ in range(rng.integers(1, 20)))
              for _ in range(20000)]
    for levels in (4, 17):
        got = (np.empty((len(topics), levels), np.int32),
               np.empty(len(topics), np.int32), np.empty(len(topics), bool))
        td_n.native().encode_topics_into(topics, levels, *got)
        want = encode_topics(td_p, [tuple(t.split("/")) for t in topics],
                             levels)
        if any(not np.array_equal(x, y) for x, y in zip(got, want)):
            fail(f"native encoder: topic rows differ at {levels} levels")
    for n in (0, 1, 1000, 1_000_000):
        keys = rng.integers(-1 << 40, 1 << 40, n) // 1024
        u, inv = unique_inverse_i64(keys)
        wu, winv = np.unique(keys, return_inverse=True)
        if not (np.array_equal(argsort_i64(keys),
                               np.argsort(keys, kind="stable"))
                and np.array_equal(u, wu)
                and np.array_equal(inv, winv.reshape(-1))):
            fail(f"native sorts differ from numpy at n = {n}")
    msgs = [Message(topic=f"p/{i % 9}/é", payload=bytes(i % 251 for _ in
                                                        range(i % 300)),
                    qos=i % 3, retain=i % 4 == 0,
                    properties={"user_property": [("k", str(i))]}
                    if i % 5 == 0 else {})
            for i in range(200)]
    runs = []
    for j in range(16):
        nd = int(rng.integers(1, 200))
        runs.append((C.MQTT_V5 if j % 2 else C.MQTT_V4,
                     np.sort(rng.integers(0, 200, nd)).astype(np.int64),
                     rng.integers(0, 3, nd).astype(np.int64),
                     rng.random(nd) < 0.5))
    native, python = wire_builders(msgs, runs)
    wire = native()
    if wire != python():
        fail("native window assembly differs from the Python encoder")
    print(f"native parity: NativeTrie = HostTrie over 5,000 inserts and "
          f"deletes, {n_topics} topics (match_words, match_since_words); "
          f"native filter encode = Python (20,000 filters, ids too); topic "
          f"encode = encode_topics (20,000 topics, 4 and 17 levels); "
          f"argsort/unique = numpy up to 1,000,000 keys; window assembly "
          f"= Python encoder ({sum(len(r[1]) for r in runs)} deliveries, "
          f"{len(wire)} B): all exact", flush=True)


def alternate(fa, fb, reps: int):
    """Host-clock ms of ``fa`` and ``fb`` called in turns (a, b, b, a),
    ``reps`` each: the medians."""
    import statistics

    ta, tb = [], []
    for k in range(reps):
        for fn, out in ((fa, ta), (fb, tb)) if k % 2 == 0 else \
                ((fb, tb), (fa, ta)):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ta), statistics.median(tb)


def phase_window_assembly(results, stages) -> None:
    """The wire of one broker window — the main-path broker run's
    median messages a window, each delivered at QoS 1 to its median
    clients (the load's shape: every subscriber gets every message) —
    through the native splice and through the per-delivery Python
    encoder, in turns; equal bytes."""
    import numpy as np

    from emqx_tpu_torch.codec import mqtt as C
    from emqx_tpu_torch.message import Message

    phase("window assembly")
    win = stages.get("window")
    if not win:
        fail("window assembly: the broker run committed no window")
    n, k = max(int(win["n_msgs"]), 1), max(int(win["n_clients"]), 1)
    msgs = [Message(topic=f"load/p{i % N_PUB}/m{i % 16}", qos=1,
                    payload=f"{i % N_PUB}:{i}:{time.perf_counter()!r}"
                    .encode()) for i in range(n)]
    sm = np.arange(n, dtype=np.int64)
    runs = [(C.MQTT_V4, sm, np.ones(n, np.int64), np.zeros(n, bool))] * k
    native, python = wire_builders(msgs, runs)
    if native() != python():
        fail("window assembly: the native splice differs from Python")
    t = alternate(native, python, 20)
    results["native"]["window_assembly_ms"] = {"n_msgs": n, "clients": k,
                                               "native": t[0],
                                               "python": t[1]}
    asm = stages.get("assemble")
    asm = (f"p50 {asm['p50_ms']:.4f} ms over {asm['count']} windows"
           if asm else "never ran: no run's QoS>0 deliveries fit its "
           "subscriber's inflight window")
    print(f"window assembly, {n} messages x {k} clients at QoS 1 (equal "
          f"bytes): native (slots, pids, one splice) {t[0]:.4f} ms, "
          f"Python per-delivery encoder {t[1]:.4f} ms; the broker run's "
          f"assemble stage (the splice alone) {asm} [{results['card']}]",
          flush=True)


def phase_native_times(results, eng, py, filters, windows) -> None:
    """Each native helper against its Python referee at the main path's
    sizes, on this machine's host, in turns: the encode of one
    4,096-topic window, the engine window (``MatchEngine.match_batch``),
    the host trie over a window's topics (the overflow re-match) and
    over the residual after churn, and the automaton build of the 1M
    filters.  ``eng`` and ``py`` hold the same filters, with the native
    host path and with ``native=False``."""
    import numpy as np

    from emqx_tpu_torch import topic as T
    from emqx_tpu_torch.observability import Profiler
    from emqx_tpu_torch.ops.automaton import (
        assemble_automaton, encode_filters,
    )
    from emqx_tpu_torch.ops.dictionary import TokenDict, encode_topics

    phase("native times")
    out = results["native"]
    card = results["card"]
    w = windows[0]
    words = [T.words(t) for t in w]
    levels = eng._aut.kernel_levels
    tdict = eng._tdict
    bufs = (np.empty((len(w), levels), np.int32), np.empty(len(w), np.int32),
            np.empty(len(w), bool))

    def enc_native():
        tdict.native().encode_topics_into(w, levels, *bufs)

    want = encode_topics(tdict, words, levels)
    enc_native()
    if any(not np.array_equal(x, y) for x, y in zip(bufs, want)):
        fail("native times: the window encode differs from encode_topics")
    out["encode_window_ms"] = alternate(
        enc_native, lambda: encode_topics(tdict, words, levels), 20)
    print(f"window encode, {len(w)} topics at {levels} levels (every "
          f"topic a row-cache miss): native {out['encode_window_ms'][0]:.4f} "
          f"ms, encode_topics {out['encode_window_ms'][1]:.4f} ms "
          f"[{card}]", flush=True)

    def engine_windows(label):
        eng.profiler, py.profiler = Profiler(), Profiler()
        tn, tp = [], []
        for k, win in enumerate(windows):
            order = ((eng, tn), (py, tp)) if k % 2 == 0 else \
                ((py, tp), (eng, tn))
            got = []
            for e, acc in order:
                t0 = time.perf_counter()
                got.append(e.match_batch(win))
                acc.append((time.perf_counter() - t0) * 1e3)
            if got[0] != got[1]:
                fail(f"native times: engine windows differ ({label})")
        tok = [e.profiler.summary()["tokenize"]["p50"] / 1e3
               for e in (eng, py)]
        eng.profiler = py.profiler = None
        med = float(np.median(tn)), float(np.median(tp))
        print(f"engine window ({label}), MatchEngine.match_batch over "
              f"{len(windows)} windows of {len(w)} topics, in turns: "
              f"native median {med[0]:.3f} ms (tokenize p50 {tok[0]:.3f}), "
              f"native=False {med[1]:.3f} ms (tokenize p50 {tok[1]:.3f}); "
              f"equal fid sets [{card}]", flush=True)
        return {"native_ms": med[0], "python_ms": med[1],
                "tokenize_p50_ms": tok}

    out["engine_window_warm"] = engine_windows("row cache warm")
    tries = (eng._wild, py._wild)
    got = [[t.match_words(ws) for ws in words] for t in tries]
    if got[0] != got[1]:
        fail("native times: the host tries' matches differ")
    out["trie_window_ms"] = alternate(
        lambda: [tries[0].match_words(ws) for ws in words],
        lambda: [tries[1].match_words(ws) for ws in words], 5)
    print(f"host trie match_words over one window's {len(w)} topics (the "
          f"re-match of overflowed rows), {len(filters)} filters: native "
          f"{out['trie_window_ms'][0]:.3f} ms, HostTrie "
          f"{out['trie_window_ms'][1]:.3f} ms [{card}]", flush=True)
    # churn below the rebuild threshold: a residual the window overlays
    # (matched on the host: no fold into the delta automaton here; the
    # churn phase drives that)
    rng = np.random.default_rng(5)
    churn = [(f"vehicles/v{int(v)}/sensors/+", f"churn{k}")
             for k, v in enumerate(rng.integers(0, 1000, 2000))]
    for e in (eng, py):
        e.delta_aut_threshold = 10**9
        e.insert_many(churn)
        if len(e._delta) != len(churn):
            fail("native times: the churn rebuilt the automaton")
    res = [e._snapshot()[3] for e in (eng, py)]
    if [res[0].match_words(ws) for ws in words] != \
            [res[1].match_words(ws) for ws in words]:
        fail("native times: the residual views differ")
    out["residual_window_ms"] = alternate(
        lambda: [res[0].match_words(ws) for ws in words],
        lambda: [res[1].match_words(ws) for ws in words], 5)
    print(f"residual match_since_words over one window ({len(churn)} "
          f"filters since the build): native "
          f"{out['residual_window_ms'][0]:.3f} ms, HostTrie "
          f"{out['residual_window_ms'][1]:.3f} ms [{card}]", flush=True)
    out["engine_window_churn"] = engine_windows(
        f"{len(churn)}-filter residual")
    # the automaton build of the 1M filters: encode, then assemble
    t0 = time.perf_counter()
    enc_n = encode_filters(filters, TokenDict(), 16, native=True)
    t1 = time.perf_counter()
    enc_p = encode_filters(filters, TokenDict(), 16, native=False)
    t2 = time.perf_counter()
    aut_n = assemble_automaton(*enc_n, max_levels=16, native=True)
    t3 = time.perf_counter()
    aut_p = assemble_automaton(*enc_p, max_levels=16, native=False)
    t4 = time.perf_counter()
    for x, y in zip(enc_n[:3], enc_p[:3]):
        if not np.array_equal(x, y):
            fail("native times: the filter encodes differ")
    for f in ("fp_rows", "node_rows", "code_off", "code_idx"):
        if not np.array_equal(getattr(aut_n, f), getattr(aut_p, f)):
            fail(f"native times: the automata differ in {f}")
    out["build_s"] = {"encode": (t1 - t0, t2 - t1),
                      "assemble": (t3 - t2, t4 - t3)}
    print(f"automaton build of {len(filters)} filters (equal tables): "
          f"encode native {t1 - t0:.3f} s, Python {t2 - t1:.3f} s; assemble "
          f"with native sorts {t3 - t2:.3f} s, numpy sorts {t4 - t3:.3f} s "
          f"[{card}]", flush=True)


def stage_medians(label, prof) -> dict:
    """Print and return the per-stage medians of a broker's windows:
    ``Profiler.summary()``'s p50 over every window (log2 buckets,
    interpolated) and the exact median over the ring's windows that the
    batcher made (not the one-message windows a rule's republish
    publishes); ``"window"`` holds those windows' median messages,
    deliveries and clients."""
    import statistics

    summ = prof.summary()
    ring = [r for r in prof.windows(limit=10**6) if r["source"] == "batcher"]
    rows = {}
    for name, h in summ.items():
        if not h["count"]:
            continue
        vals = [r["stages_us"][name] for r in ring if name in r["stages_us"]]
        rows[name] = {"p50_ms": h["p50"] / 1e3, "count": h["count"],
                      "ring_median_ms": statistics.median(vals) / 1e3
                      if vals else None, "ring_n": len(vals)}
    print(f"{label}: per-stage medians, Broker.profiler.summary() p50 "
          f"over all windows (ring: exact median of the last {len(ring)} "
          f"batcher windows)", flush=True)
    for name, r in rows.items():
        ring_s = (f"{r['ring_median_ms']:.3f}"
                  if r["ring_median_ms"] is not None else "-")
        print(f"  {label} stage {name}: {r['p50_ms']:.3f} ms (ring {ring_s} "
              f"ms over {r['ring_n']}; {r['count']} samples)", flush=True)
    if ring:
        rows["window"] = {k: statistics.median(r[k] for r in ring)
                          for k in ("n_msgs", "n_deliveries", "n_clients")}
        print(f"  {label} windows: median {rows['window']}", flush=True)
    # the engine's events, exactly (their histograms are log2 buckets)
    rows["events"] = [(e["kind"], e["dur_ms"], e.get("bytes"))
                      for e in prof.events()]
    print(f"  {label} engine events (kind, ms, bytes): {rows['events']}",
          flush=True)
    return rows


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "emqx_tpu_torch")):
        fail("the emqx_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    t_start = time.perf_counter()
    results = {"kernels": {}, "launches": {}, "rules_sizes": {},
               "main_path": {}}
    results["card"] = phase_device()
    phase_build(results)
    phase_native_build(results)
    phase_native_parity()
    enc, batch_np, k1 = phase_kernels(results)
    phase_sharded_kernel(results, enc, batch_np, k1)
    del enc, batch_np, k1
    phase_rules_kernel(results)
    phase_predicate_kernel(results)
    from emqx_tpu_torch import workload as W

    filters, _pops = W.make_filters(1_000_000, 8)
    phase_engine(results, filters)
    phase_sharded_engine(results, filters)
    phase_churn(results, filters)
    phase_broker(results, filters)
    phase_sinks_broker(results, filters)
    phase_mgmt_broker(results, filters)
    phase_main_shapes(results)
    phase_shared_broker(results, filters)
    phase_retained(results, filters)
    phase_access_broker(results, filters)
    phase_auth_broker(results, filters)
    phase_exhook_broker(results, filters)
    phase_durable_broker(results, filters)
    phase_listeners(results, filters)

    phase("kernels")
    rows = []
    for name, (source, replaces) in KERNELS.items():
        k = results["kernels"][name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": results["launches"][name], "max_abs_err": 0,
            "ms": k["ms"], "device_ms": k["device_ms"],
            "wrapper_ms": k["wrapper_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
            **{x: k[x] for x in ("main_path", "churn", "shared", "access",
                                 "auth", "exhook", "durable", "listeners",
                                 "sinks",
                                 "mgmt",
                                 "stress",
                                 "empty_launch_ms")
               if x in k},
        })
    print(f"native summary: {json.dumps(results['native'])}", flush=True)
    print(f"churn summary: {json.dumps(results['churn'])}", flush=True)
    print(f"shared summary: {json.dumps(results['shared'])}", flush=True)
    print(f"retained summary: {json.dumps(results['retained'])}", flush=True)
    print(f"access summary: {json.dumps(results['access'])}", flush=True)
    print(f"auth summary: {json.dumps(results['auth'])}", flush=True)
    print(f"exhook summary: {json.dumps(results['exhook'])}", flush=True)
    print(f"durable summary: {json.dumps(results['durable'])}", flush=True)
    print(f"listeners summary: {json.dumps(results['listeners'])}",
          flush=True)
    print(f"sinks summary: {json.dumps(results['sinks'])}", flush=True)
    print(f"mgmt summary: {json.dumps(results['mgmt'])}", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
