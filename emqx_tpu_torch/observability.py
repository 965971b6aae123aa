"""Hot-path window profiler: stage-latency histograms, a ring of the
most recent dispatch windows, and Chrome trace-event export.

The broker's hot path is batched (window assembly -> match kernel ->
CSR expand -> decide kernel -> encode-once -> native splice -> corked
flush), and a flat counter cannot say which stage of the window a
stall lives in.  Three pieces close that gap:

``Histogram``
    Fixed log2-bucket latency histogram: precomputed bounds, O(1)
    ``int.bit_length`` bucket index, mergeable snapshots.  The
    profiler takes ONE lock per committed window for all of the
    window's stage samples, not one per sample.

``Profiler`` / ``WindowRecord``
    Per-window stage spans (batch-wait, prepare, match submit/wait,
    CSR expand, decide, deliver with its native ``assemble`` share,
    cork flush, rules, end-to-end publish -> delivery) collected by
    the broker with two ``perf_counter`` calls per stage, plus engine
    events (automaton rebuilds, table uploads with their bytes).

The ring
    A fixed ring of the last N ``WindowRecord``s (``windows``), and
    ``chrome_trace`` renders it as Chrome trace-event JSON that loads
    in Perfetto.  ``Profiler.flight`` is the hook a flight recorder
    would take; nothing sets it yet.
"""

from __future__ import annotations

import os
import re
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

# log2 bucket upper bounds (inclusive), shared by every Histogram:
# bucket i holds integer values v with bit_length(v) == i, i.e.
# v <= 2**i - 1; the last bucket is +Inf.  31 finite bounds cover one
# microsecond to ~35 minutes when values are recorded in µs.
N_BUCKETS = 32
BOUNDS: Tuple[int, ...] = tuple((1 << i) - 1 for i in range(N_BUCKETS - 1))


class HistogramSnapshot:
    """Immutable point-in-time copy of a Histogram; snapshots merge
    (per-bucket add) so per-shard / per-process histograms aggregate
    without losing percentile fidelity."""

    __slots__ = ("counts", "sum", "count")

    def __init__(self, counts: Sequence[int], total: float, count: int):
        self.counts = tuple(counts)
        self.sum = total
        self.count = count

    def merge(self, other: "HistogramSnapshot") -> "HistogramSnapshot":
        return HistogramSnapshot(
            tuple(a + b for a, b in zip(self.counts, other.counts)),
            self.sum + other.sum,
            self.count + other.count,
        )

    def percentile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 100]): linear interpolation
        inside the containing bucket.  0.0 with no samples."""
        if self.count == 0:
            return 0.0
        target = self.count * min(max(q, 0.0), 100.0) / 100.0
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = 0 if i == 0 else BOUNDS[i - 1] + 1
                hi = (
                    BOUNDS[i]
                    if i < len(BOUNDS)
                    # open-ended last bucket: cap at the mean of what
                    # landed there (sum bounds it) or 2x the last edge
                    else max(BOUNDS[-1] * 2, lo)
                )
                frac = (target - cum) / c
                return lo + (hi - lo) * frac
            cum += c
        return float(BOUNDS[-1])

    def raw_dict(self) -> Dict[str, object]:
        """Lossless wire form (counts included): a process can ship
        these to another, which re-exposes real histograms (buckets,
        mergeable snapshots), not just point percentiles."""
        return {
            "counts": list(self.counts),
            "sum": self.sum,
            "count": self.count,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "HistogramSnapshot":
        counts = list(d.get("counts") or [])
        counts = (counts + [0] * N_BUCKETS)[:N_BUCKETS]
        return cls(counts, float(d.get("sum", 0.0)),
                   int(d.get("count", 0)))

    def to_dict(self) -> Dict[str, object]:
        return {
            "count": self.count,
            "sum": round(self.sum, 3),
            "p50": round(self.percentile(50), 3),
            "p95": round(self.percentile(95), 3),
            "p99": round(self.percentile(99), 3),
            "max_bucket_le": (
                BOUNDS[min(
                    max(i for i, c in enumerate(self.counts) if c),
                    len(BOUNDS) - 1,
                )]
                if self.count else 0
            ),
        }


class Histogram:
    """Fixed log2-bucket histogram.  ``record`` is O(1): the bucket
    index is ``int(value).bit_length()`` against precomputed bounds —
    no search, no allocation.  Thread-safe via its own lock unless the
    owner passes a shared one (the Profiler amortizes ONE lock across
    every histogram it owns, one acquisition per window)."""

    __slots__ = ("_counts", "_sum", "_count", "_lock")

    def __init__(self, lock: Optional[threading.Lock] = None) -> None:
        self._counts = [0] * N_BUCKETS
        self._sum = 0.0
        self._count = 0
        self._lock = lock if lock is not None else threading.Lock()

    @staticmethod
    def bucket_index(value: float) -> int:
        v = int(value)
        if v <= 0:
            return 0
        i = v.bit_length()
        return i if i < N_BUCKETS else N_BUCKETS - 1

    def _record_locked(self, value: float) -> None:
        """Caller holds the lock (bulk paths)."""
        self._counts[Histogram.bucket_index(value)] += 1
        self._sum += value
        self._count += 1

    def record(self, value: float) -> None:
        with self._lock:
            self._record_locked(value)

    def record_many(self, values: Sequence[float]) -> None:
        """Bulk record under ONE lock acquisition — per-window use."""
        if not values:
            return
        with self._lock:
            for v in values:
                self._record_locked(v)

    def snapshot(self) -> HistogramSnapshot:
        with self._lock:
            return HistogramSnapshot(
                list(self._counts), self._sum, self._count
            )

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * N_BUCKETS
            self._sum = 0.0
            self._count = 0


class WindowRecord:
    """One dispatch window's flight-record entry: stage spans plus
    sizes, the match path taken and the breaker state.  Mutated by
    exactly one window's happens-before chain (collector → executor →
    dispatch loop), so it needs no lock of its own."""

    __slots__ = (
        "seq", "wall0", "t0", "_t_last", "n_msgs", "n_deliveries",
        "n_clients", "path", "breaker_open", "source", "spans",
        "subs", "e2e_ms",
    )

    def __init__(self, seq: int, n_msgs: int, source: str) -> None:
        now = time.perf_counter()
        self.seq = seq
        self.wall0 = time.time()
        self.t0 = now
        self._t_last = now
        self.n_msgs = n_msgs
        self.n_deliveries = 0
        self.n_clients = 0
        self.path = ""  # "host" | "dev" | "host-fallback"
        self.breaker_open = False
        self.source = source  # "publish" | "batcher" | "forwarded"
        self.spans: List[Tuple[str, float, float]] = []  # (name, off, dur)
        # nested sub-stages: (name, dur) accumulated inside a parent
        # span (e.g. the native ``assemble`` share of ``deliver``) —
        # histogrammed like spans but kept out of the trace's B/E
        # track, whose spans must stay contiguous
        self.subs: List[Tuple[str, float]] = []
        self.e2e_ms: List[float] = []

    def lap(self, name: str) -> None:
        """Close the span running since the previous lap (or since
        construction) under ``name`` — two perf_counter reads per
        stage, nothing else on the hot path."""
        now = time.perf_counter()
        self.spans.append((name, self._t_last - self.t0, now - self._t_last))
        self._t_last = now

    def sub(self, name: str, dur_s: float) -> None:
        """Record a nested sub-stage total (caller-accumulated)."""
        self.subs.append((name, dur_s))

    def to_dict(self) -> Dict[str, object]:
        return {
            "seq": self.seq,
            "at": self.wall0,
            "source": self.source,
            "n_msgs": self.n_msgs,
            "n_deliveries": self.n_deliveries,
            "n_clients": self.n_clients,
            "path": self.path,
            "breaker_open": self.breaker_open,
            "stages_us": {
                **{
                    name: round(dur * 1e6, 1)
                    for name, _off, dur in self.spans
                },
                **{
                    name: round(dur * 1e6, 1)
                    for name, dur in self.subs
                },
            },
            "e2e_ms": [round(v, 3) for v in self.e2e_ms[:8]],
        }


class Profiler:
    """The broker's window profiler: named histograms (one shared
    lock, bulk-recorded per window), the flight-recorder ring, and an
    engine-event ring.  ``enabled=False`` turns the whole thing into
    a no-op (``begin`` returns None and every call site guards)."""

    # stage histograms pre-created so exposition order is stable
    STAGES = (
        "batch_wait", "prepare", "match_submit", "match_wait",
        "dispatch_wait", "replay_read", "expand", "decide", "deliver",
        "assemble", "flush", "rules", "tokenize", "ds_sync", "e2e",
    )

    def __init__(
        self,
        ring_size: int = 256,
        events_cap: int = 256,
        enabled: bool = True,
        process_label: str = "emqx_tpu_torch",
        pid: Optional[int] = None,
    ) -> None:
        self.enabled = enabled
        # explicit process identity for the trace export: without a
        # real pid + node label every node/worker's tracks land under
        # one implicit process and merged multi-node timelines
        # interleave into a single row group
        self.process_label = process_label
        self.pid = pid if pid is not None else os.getpid()
        self._hlock = threading.Lock()  # ONE lock for all histograms
        self._hist: Dict[str, Histogram] = {
            name: Histogram(lock=self._hlock) for name in self.STAGES
        }
        self._ring: List[Optional[WindowRecord]] = [None] * max(ring_size, 1)
        self._ring_lock = threading.Lock()
        self._seq = 0
        # engine lifecycle events: (kind, wall_ts, dur_s, meta)
        self._events: deque = deque(maxlen=max(events_cap, 1))
        # a flight recorder's hook: when set, every committed window is
        # handed to its ``on_window`` (no flight recorder exists yet)
        self.flight = None

    # ------------------------------------------------------- windows

    def begin(self, n_msgs: int, source: str = "publish"
              ) -> Optional[WindowRecord]:
        if not self.enabled:
            return None
        with self._ring_lock:
            self._seq += 1
            seq = self._seq
        return WindowRecord(seq, n_msgs, source)

    def commit(self, rec: WindowRecord) -> None:
        """Fold a finished window into the histograms (ONE lock for
        every stage sample + the e2e batch) and the ring."""
        hist = self._hist
        with self._hlock:
            for name, _off, dur in rec.spans:
                h = hist.get(name)
                if h is None:
                    h = hist[name] = Histogram(lock=self._hlock)
                h._record_locked(dur * 1e6)
            for name, dur in rec.subs:
                h = hist.get(name)
                if h is None:
                    h = hist[name] = Histogram(lock=self._hlock)
                h._record_locked(dur * 1e6)
            if rec.e2e_ms:
                e2e = hist["e2e"]
                for v in rec.e2e_ms:
                    e2e._record_locked(v * 1e3)  # ms -> µs
        with self._ring_lock:
            self._ring[rec.seq % len(self._ring)] = rec
        fl = self.flight
        if fl is not None:
            fl.on_window(rec)

    # -------------------------------------------------- stages/events

    def stage(self, name: str, dur_s: float) -> None:
        """One standalone stage sample (engine-internal stages like
        tokenize that cannot ride a WindowRecord across the engine
        API boundary)."""
        if not self.enabled:
            return
        with self._hlock:
            h = self._hist.get(name)
            if h is None:
                h = self._hist[name] = Histogram(lock=self._hlock)
            h._record_locked(dur_s * 1e6)

    def event(self, kind: str, dur_s: float, **meta) -> None:
        """Engine lifecycle event (automaton rebuild, table upload):
        histogrammed under ``engine_<kind>`` and kept in the event
        ring for the trace export."""
        if not self.enabled:
            return
        self.stage("engine_" + kind, dur_s)
        self._events.append((kind, time.time(), dur_s, meta))

    # ---------------------------------------------------- exposition

    def snapshots(self) -> Dict[str, HistogramSnapshot]:
        """Name -> snapshot for every histogram that saw samples,
        pre-created stage families included even when empty (stable
        scrape shape)."""
        with self._hlock:
            items = list(self._hist.items())
        out = {}
        for name, h in items:
            out[name] = h.snapshot()
        return out

    def summary(self) -> Dict[str, Dict[str, object]]:
        return {
            name: snap.to_dict()
            for name, snap in self.snapshots().items()
            if snap.count or name in self.STAGES
        }

    def windows(self, limit: int = 64) -> List[Dict[str, object]]:
        """Most recent committed windows, newest first."""
        return [r.to_dict() for r in self._recent(limit)]

    def _recent(self, limit: int) -> List[WindowRecord]:
        with self._ring_lock:
            recs = [r for r in self._ring if r is not None]
        recs.sort(key=lambda r: r.seq, reverse=True)
        return recs[: max(limit, 0)]

    def events(self, limit: int = 64) -> List[Dict[str, object]]:
        if limit <= 0:
            return []
        out = [
            {"kind": k, "at": ts, "dur_ms": round(d * 1e3, 3), **meta}
            for k, ts, d, meta in list(self._events)
        ]
        return out[-limit:][::-1]

    def reset(self) -> None:
        with self._hlock:
            for h in self._hist.values():
                h._counts = [0] * N_BUCKETS
                h._sum = 0.0
                h._count = 0
        with self._ring_lock:
            self._ring = [None] * len(self._ring)
        self._events.clear()

    # -------------------------------------------------- chrome trace

    def chrome_trace(self, limit: Optional[int] = None) -> Dict[str, object]:
        """The flight recorder as Chrome trace-event JSON (the format
        Perfetto and chrome://tracing load natively): every window is
        its own thread track with paired B/E events per stage (windows
        pipeline, so tracks may overlap in time — per-track events
        stay strictly nested), engine lifecycle events ride tid 0 as
        complete ("X") events."""
        recs = self._recent(limit if limit is not None else len(self._ring))
        recs.reverse()  # oldest first: ts ordering within each track
        engine_events = list(self._events)
        # export timestamps RELATIVE to the trace's own epoch: at
        # absolute epoch-µs magnitude (1.7e15) a float64 has ~0.25 µs
        # of quantization, enough to flip adjacent span edges out of
        # order; small relative values keep full sub-µs precision
        starts = [r.wall0 for r in recs] + [
            ts - dur for _k, ts, dur, _m in engine_events
        ]
        epoch = min(starts) if starts else 0.0
        pid = self.pid
        events: List[Dict[str, object]] = [
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": (
                 f"emqx_tpu_torch window pipeline [{self.process_label} "
                 f"pid={pid}]"
             )}},
            {"name": "process_sort_index", "ph": "M", "pid": pid,
             "tid": 0, "args": {"sort_index": pid}},
        ]
        for rec in recs:
            tid = rec.seq
            base_us = (rec.wall0 - epoch) * 1e6
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": f"window {rec.seq} ({rec.source})"},
            })
            cursor = base_us  # monotonic clamp: contiguous span
            # offsets are measured independently, so edge timestamps
            # can disagree by an ulp — never let E(k) > B(k+1)
            for name, off, dur in rec.spans:
                b_ts = max(base_us + off * 1e6, cursor)
                e_ts = b_ts + max(dur, 0.0) * 1e6
                cursor = e_ts
                args = {
                    "n_msgs": rec.n_msgs,
                    "path": rec.path,
                    "breaker_open": rec.breaker_open,
                }
                events.append({
                    "name": name, "ph": "B", "pid": pid, "tid": tid,
                    "ts": b_ts, "args": args,
                })
                events.append({
                    "name": name, "ph": "E", "pid": pid, "tid": tid,
                    "ts": e_ts,
                })
        for kind, ts, dur, meta in engine_events:
            events.append({
                "name": kind, "ph": "X", "pid": pid, "tid": 0,
                "ts": (ts - dur - epoch) * 1e6, "dur": dur * 1e6,
                "args": dict(meta),
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}


# ------------------------------------------------- prometheus helpers

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def prom_name(name: str) -> str:
    """Sanitize a dotted metric name into a valid Prometheus metric
    name: ``.``/``-`` and anything else outside [a-zA-Z0-9_:] become
    ``_``, and a leading digit gets a ``_`` prefix (counter names like
    ``5xx.responses`` would otherwise emit an unparseable family)."""
    out = _PROM_BAD.sub("_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def prom_histogram_lines(
    family: str, snap: HistogramSnapshot, help_text: str = ""
) -> List[str]:
    """One Prometheus text-format histogram family: cumulative
    ``_bucket`` samples with ``le`` labels, then ``_sum``/``_count``."""
    lines = [
        f"# HELP {family} {help_text or family}",
        f"# TYPE {family} histogram",
    ]
    cum = 0
    for i, c in enumerate(snap.counts):
        cum += c
        le = str(BOUNDS[i]) if i < len(BOUNDS) else "+Inf"
        lines.append(f'{family}_bucket{{le="{le}"}} {cum}')
    lines.append(f"{family}_sum {snap.sum}")
    lines.append(f"{family}_count {snap.count}")
    return lines
