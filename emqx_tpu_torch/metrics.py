"""Named counters + gauges.

EMQX keeps a fixed-slot `counters` array referenced from persistent_term
(`emqx_metrics`, apps/emqx/src/emqx_metrics.erl) so hot-path increments
are lock-free.  The Python analogue, as in the JAX package: a flat list
of ints indexed by a frozen name->slot map; hot paths pre-resolve slots
with ``slots`` and bump several under one lock with ``inc_slots``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

# metric names mirror EMQX's ?BYTES_METRICS / ?PACKET_METRICS /
# ?MESSAGE_METRICS tables (emqx_metrics.erl), and the JAX package's
# registry name for name, so ``all()`` has the same keys
METRICS = (
    "bytes.received",
    "bytes.sent",
    "packets.received",
    "packets.sent",
    "packets.connect.received",
    "packets.connack.sent",
    "packets.publish.received",
    "packets.publish.sent",
    "packets.publish.dropped",
    "packets.publish.error",
    "packets.publish.auth_error",
    "packets.puback.received",
    "packets.puback.sent",
    "packets.pubrec.received",
    "packets.pubrec.sent",
    "packets.pubrel.received",
    "packets.pubrel.sent",
    "packets.pubcomp.received",
    "packets.pubcomp.sent",
    "packets.subscribe.received",
    "packets.suback.sent",
    "packets.subscribe.error",
    "packets.subscribe.auth_error",
    "packets.unsubscribe.received",
    "packets.unsuback.sent",
    "packets.pingreq.received",
    "packets.pingresp.sent",
    "packets.disconnect.received",
    "packets.disconnect.sent",
    "packets.auth.received",
    "messages.received",
    "messages.sent",
    "messages.qos0.received",
    "messages.qos0.sent",
    "messages.qos1.received",
    "messages.qos1.sent",
    "messages.qos2.received",
    "messages.qos2.sent",
    "messages.publish",
    "messages.delivered",
    "messages.acked",
    "messages.dropped",
    "messages.dropped.no_subscribers",
    "messages.dropped.await_pubrel_timeout",
    "messages.dropped.expired",
    "messages.dropped.queue_full",
    "messages.forward",
    "messages.forward.failed",
    "messages.forward.received",
    "messages.forward.dropped",
    "messages.forward.retx",
    "messages.forward.dup",
    "messages.retained",
    "cluster.nodes.down",
    "cluster.forward.breaker.open",
    "delivery.dropped",
    "delivery.dropped.no_local",
    "delivery.dropped.too_large",
    "delivery.dropped.queue_full",
    "delivery.dropped.expired",
    "delivery.dropped.olp_shed",
    "delivery.dropped.out_buffer",
    "messages.dropped.olp_shed",
    "olp.level.changed",
    "olp.deferred.resume",
    "olp.deferred.retained",
    "olp.deferred.rebuild",
    "olp.deferred.sink_flush",
    "olp.dropped.retained",
    "olp.refused.connect",
    "olp.shed.publish_qos0",
    "olp.killed.slow_subs",
    "session.created",
    "session.resumed",
    "session.resume.parked",
    "session.resume.busy",
    "session.resume.foreign_shard",
    "session.replay.windows",
    "session.replay.messages",
    "ds.sync.count",
    "ds.sync.errors",
    "ds.storage.corrupt_records",
    "ds.meta.corruption",
    "session.takenover",
    "session.discarded",
    "session.terminated",
    "client.connect",
    "client.connack",
    "client.connected",
    "client.disconnected",
    "client.authenticate",
    "client.auth.anonymous",
    "client.authorize",
    "authorization.allow",
    "authorization.deny",
    "rules.matched",
    "actions.success",
    "actions.failed",
    "messages.publish.error",
    "messages.delayed",
    "messages.validation_failed",
    "messages.transformation_failed",
    "session.imported",
    "session.purged",
    "session.replica_restored",
    "session.replica_merged",
    "session.takeover.requested",
    "client.evicted",
    "connection.congested",
    "connection.rate_limited",
    "engine.breaker.trip",
    "engine.breaker.clear",
    "ds.meta.rebuild",
    "cluster_link.ingress",
    "cluster_link.egress",
    "bridge.ingress",
    "bridge.egress",
    # flight recorder (flightrec.py)
    "flight.triggers",
    "flight.triggers.suppressed",
    "flight.dumps",
    "flight.dump.errors",
    "flight.remote_requests",
    # shared match service, service-side registry (ops/matchsvc.py)
    "matchsvc.windows",
    "matchsvc.topics",
    "matchsvc.decides",
    "matchsvc.route_ops",
    "matchsvc.errors",
    "matchsvc.flight_relayed",
    # per-worker shm window ring (broker/shmring.py via matchclient)
    "multicore.ring.full",
    "multicore.ring.oversize",
    "multicore.ring.quarantined",
)

_SLOT = {name: i for i, name in enumerate(METRICS)}


class Metrics:
    """One counter array; ``inc``/``val`` by name, ``counter`` returns a
    bound fast-path increment callable."""

    def __init__(self) -> None:
        self._c: List[int] = [0] * len(METRICS)
        # names outside the fixed slot registry (per-feature counters,
        # EMQX's emqx_metrics_worker role)
        self._extra: Dict[str, int] = {}
        # increments arrive from the event loop AND worker threads (the
        # batcher's executor); Python's += is not atomic, so counting is
        # locked
        self._lock = threading.Lock()
        self.start_time = time.time()

    def inc(self, name: str, by: int = 1) -> None:
        i = _SLOT.get(name)
        with self._lock:
            if i is None:
                self._extra[name] = self._extra.get(name, 0) + by
            else:
                self._c[i] += by

    def slots(self, *names: str) -> Tuple[int, ...]:
        """Pre-resolve registry names to slot indices for `inc_slots`
        (hot paths bump several counters per packet; one lock+loop
        beats N inc() calls)."""
        out = []
        for n in names:
            i = _SLOT.get(n)
            if i is None:
                raise KeyError(f"not a registry metric: {n}")
            out.append(i)
        return tuple(out)

    def inc_slots(self, slots: Tuple[int, ...], by: int = 1) -> None:
        c = self._c
        with self._lock:
            for i in slots:
                c[i] += by

    def inc_bulk(self, updates: Dict[str, int]) -> None:
        """Apply a batch of counter deltas under ONE lock acquisition —
        the dispatch window accumulates its per-delivery bookkeeping
        locally and flushes here once per window instead of locking
        per delivery."""
        if not updates:
            return
        c = self._c
        extra = self._extra
        with self._lock:
            for name, by in updates.items():
                i = _SLOT.get(name)
                if i is None:
                    extra[name] = extra.get(name, 0) + by
                else:
                    c[i] += by

    def val(self, name: str) -> int:
        i = _SLOT.get(name)
        return self._extra.get(name, 0) if i is None else self._c[i]

    __getitem__ = val  # ``metrics[name]`` reads like ``val``

    def all(self) -> Dict[str, int]:
        out = {name: self._c[i] for name, i in _SLOT.items()}
        out.update(self._extra)
        return out

    def reset(self) -> None:
        self._c = [0] * len(METRICS)
        self._extra = {}


class Stats:
    """Max-tracking gauges (`emqx_stats`): current + historical max."""

    def __init__(self) -> None:
        self._cur: Dict[str, int] = {}
        self._max: Dict[str, int] = {}

    def set(self, name: str, value: int) -> None:
        self._cur[name] = value
        if value > self._max.get(name + ".max", 0):
            self._max[name + ".max"] = value

    def update_delta(self, name: str, delta: int) -> None:
        self.set(name, self._cur.get(name, 0) + delta)

    def get(self, name: str) -> int:
        return self._cur.get(name, self._max.get(name, 0))

    def all(self) -> Dict[str, int]:
        out = dict(self._cur)
        out.update(self._max)
        return out
