"""Failpoint injection: deterministic, named fault seams.

The chaos-engineering counterpart of `tp.py`'s tracepoints (and the
role FreeBSD/TiKV ``fail::fail_point!`` macros play): production code
marks its real failure seams — cluster frame send/recv, raft RPCs,
replica-store writes, Kafka produce, resource buffer drains, exhook
verdict calls, the engine's device step — with a NAMED evaluation
point, and tests/operators arm those points with an action:

  * ``error``      raise (`FailpointError`, a ConnectionError — the
                   seams treat it exactly like a real transport fault)
  * ``delay``      sleep/await ``delay`` seconds, then proceed
  * ``drop``       the call site discards the unit of work silently
                   (a frame the network ate)
  * ``duplicate``  the call site performs the work twice (at-least-
                   once delivery duplication)
  * ``panic``      raise `FailpointPanic` (BaseException: flows
                   through ``except Exception`` recovery the way a
                   process death would)

Every point supports a firing probability with a SEEDED per-point RNG
(chaos runs reproduce bit-for-bit), hit-count windows (``after`` skips
the first N hits, ``times`` caps total fires), and an optional ``match``
substring filter against the call-site key (e.g. partition only the
traffic crossing ``"n0"``).

Zero-overhead when disabled: call sites guard with the module-level
``enabled`` bool (one attribute load per operation — the tp.py
philosophy), and `evaluate` itself short-circuits on the same flag, so
an unarmed broker's hot paths are behavior-identical with the
framework present or absent (tests/test_failpoints.py guards this).

Configuration surfaces:

  * env:   ``EMQX_FAILPOINTS="engine.device_step=error;
            cluster.transport.send=drop,prob=0.3,seed=7"``
            (parsed by `load_env`, called at BrokerServer.start)
  * REST:  ``GET/PUT/DELETE /api/v5/failpoints[/{name}]``
  * ctl:   ``python -m emqx_tpu_torch.ctl failpoints list|set|clear``
"""

from __future__ import annotations

import asyncio
import os
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional

ACTIONS = ("error", "delay", "drop", "duplicate", "panic")

# the instrumented seams (kept in sync with the call sites; the guard
# test iterates this list to prove each is a no-op when disabled)
SEAMS = (
    "engine.device_step",
    "dispatch.decide.device",
    "dispatch.rules.device",
    "cluster.transport.send",
    "cluster.transport.recv",
    "cluster.raft.rpc",
    "ds.replication.store",
    "kafka.produce",
    "resource.buffer.query",
    "exhook.call",
    "ds.beamformer.poll",
    "cluster.link.forward",
    "s3.request",
    "ds.replay.read",
    "ds.store.append",
    "ds.store.sync",
    "ds.meta.write",
    "session.resume.commit",
    "cluster.quic.send",
    "cluster.quic.recv",
    "cluster.forward.ack",
    "olp.sample",
    "olp.shed",
    "ds.journal.append",
    "ds.gc.reclaim",
    "multicore.ring.submit",
    "multicore.ring.complete",
    "multicore.service.restart",
    "resource.batch.flush",
    "bridge.mqtt.send",
)

enabled = False  # fast-path gate: disabled brokers pay one bool check

# last fires (wall_ts, name, action, key): the lifecycle tracer reads
# this ring to attach in-window failpoint hits as span events (chaos
# attribution); deque.append is atomic, so no lock is needed
RECENT_FIRES: "deque" = deque(maxlen=256)


def fires_since(ts: float):
    """Fires strictly newer than ``ts``, oldest first — the flight
    recorder drains these at its 1 Hz tick so injected faults land in
    the black-box timeline next to their consequences."""
    return [f for f in list(RECENT_FIRES) if f[0] > ts]


class FailpointError(ConnectionError):
    """Injected failure.  Subclasses ConnectionError so transport-layer
    seams recover through their real ``except (ConnectionError, ...)``
    paths — the injection exercises production error handling, not a
    parallel test-only one."""

    def code(self) -> str:  # grpc.RpcError duck-typing (exhook seam)
        return "FAILPOINT"


class FailpointPanic(BaseException):
    """Injected process-death stand-in: BaseException, so ordinary
    ``except Exception`` recovery does NOT absorb it."""


class _Point:
    __slots__ = ("name", "action", "prob", "delay", "after", "times",
                 "match", "exc", "rng", "seed", "hits", "fires")

    def __init__(self, name: str, action: str, prob: float, delay: float,
                 after: int, times: Optional[int], match: Optional[str],
                 exc: Optional[BaseException], seed: Optional[int]):
        if action not in ACTIONS:
            raise ValueError(f"unknown failpoint action {action!r}")
        self.name = name
        self.action = action
        self.prob = float(prob)
        self.delay = float(delay)
        self.after = int(after)
        self.times = None if times is None else int(times)
        self.match = match
        self.exc = exc
        self.seed = seed
        self.rng = random.Random(seed)
        self.hits = 0
        self.fires = 0

    def info(self) -> Dict:
        return {
            "name": self.name,
            "action": self.action,
            "prob": self.prob,
            "delay": self.delay,
            "after": self.after,
            "times": self.times,
            "match": self.match,
            "seed": self.seed,
            "hits": self.hits,
            "fires": self.fires,
        }


class FailpointRegistry:
    """Named injection points; one process-wide instance below."""

    def __init__(self) -> None:
        self._points: Dict[str, _Point] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------ configure

    def configure(
        self,
        name: str,
        action: str,
        prob: float = 1.0,
        delay: float = 0.05,
        after: int = 0,
        times: Optional[int] = None,
        match: Optional[str] = None,
        exc: Optional[BaseException] = None,
        seed: Optional[int] = None,
    ) -> Dict:
        """Arm (or re-arm, resetting counters) one failpoint."""
        point = _Point(name, action, prob, delay, after, times, match,
                       exc, seed)
        with self._lock:
            self._points[name] = point
            self._sync_enabled()
        return point.info()

    def clear(self, name: Optional[str] = None) -> bool:
        with self._lock:
            if name is None:
                had = bool(self._points)
                self._points.clear()
            else:
                had = self._points.pop(name, None) is not None
            self._sync_enabled()
        return had

    def _sync_enabled(self) -> None:
        global enabled
        enabled = bool(self._points)

    def list(self) -> List[Dict]:
        with self._lock:
            return [p.info() for p in self._points.values()]

    # ------------------------------------------------------- evaluate

    def _decide(self, name: str, key: Optional[str]):
        """Count the hit and pick the action tuple (or None) under the
        lock; the sleep/raise happens in the caller, outside it."""
        with self._lock:
            p = self._points.get(name)
            if p is None:
                return None
            if p.match is not None and (
                key is None or p.match not in str(key)
            ):
                return None
            p.hits += 1
            if p.hits <= p.after:
                return None
            if p.times is not None and p.fires >= p.times:
                return None
            if p.prob < 1.0 and p.rng.random() >= p.prob:
                return None
            p.fires += 1
            if p.action == "delay":
                return ("delay", p.delay)
            if p.action == "error":
                return ("error", p.exc or FailpointError(
                    f"failpoint {name}"
                ))
            if p.action == "panic":
                return ("panic",)
            return (p.action,)  # drop / duplicate

    def evaluate(self, name: str, key: Optional[str] = None):
        """Sync seam entry: returns None (proceed), ``"drop"`` or
        ``"duplicate"`` (the call site implements those), sleeps
        through a delay, raises on error/panic."""
        if not enabled:
            return None
        d = self._decide(name, key)
        if d is None:
            return None
        RECENT_FIRES.append((time.time(), name, d[0], key))
        if d[0] == "delay":
            time.sleep(d[1])
            return None
        if d[0] == "error":
            raise d[1]
        if d[0] == "panic":
            raise FailpointPanic(name)
        return d[0]

    async def evaluate_async(self, name: str, key: Optional[str] = None):
        """`evaluate` for coroutine seams: delays await instead of
        blocking the event loop."""
        if not enabled:
            return None
        d = self._decide(name, key)
        if d is None:
            return None
        RECENT_FIRES.append((time.time(), name, d[0], key))
        if d[0] == "delay":
            await asyncio.sleep(d[1])
            return None
        if d[0] == "error":
            raise d[1]
        if d[0] == "panic":
            raise FailpointPanic(name)
        return d[0]


_REG = FailpointRegistry()

configure = _REG.configure
clear = _REG.clear
evaluate = _REG.evaluate
evaluate_async = _REG.evaluate_async
list_points = _REG.list


# ------------------------------------------------------------------ env

def parse_spec(spec: str) -> List[Dict]:
    """``name=action[,k=v...]`` entries separated by ``;``.  Keys:
    prob, delay (floats), after, times, seed (ints), match (string)."""
    out: List[Dict] = []
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        head, _, tail = entry.partition("=")
        name = head.strip()
        parts = [s.strip() for s in tail.split(",") if s.strip()]
        if not name or not parts:
            raise ValueError(f"bad failpoint spec entry: {entry!r}")
        kw: Dict = {"name": name, "action": parts[0]}
        for kv in parts[1:]:
            k, _, v = kv.partition("=")
            k = k.strip()
            v = v.strip()
            if k in ("prob", "delay"):
                kw[k] = float(v)
            elif k in ("after", "times", "seed"):
                kw[k] = int(v)
            elif k == "match":
                kw[k] = v
            else:
                raise ValueError(f"unknown failpoint option {k!r}")
        out.append(kw)
    return out


def load_env(env: Optional[str] = None) -> int:
    """Arm failpoints from ``EMQX_FAILPOINTS`` (or an explicit spec);
    returns how many were configured.  Unset/empty is a no-op, so
    production boots stay untouched."""
    spec = os.environ.get("EMQX_FAILPOINTS", "") if env is None else env
    if not spec:
        return 0
    n = 0
    for kw in parse_spec(spec):
        configure(**kw)
        n += 1
    return n
