"""Operational guards: alarms, banned clients, flapping detection,
slow-subscriber tracking.

The `emqx_alarm` / `emqx_banned` / `emqx_flapping` / `emqx_slow_subs`
slice of EMQX (apps/emqx/src/emqx_alarm.erl, emqx_banned.erl,
emqx_flapping.erl; apps/emqx_slow_subs), as in the JAX package:
alarms are an activate/deactivate registry published to ``$SYS``; bans
deny CONNECT by clientid/username/peerhost with expiry;
flapping detection bans clients that reconnect too fast; slow subs
keep a top-K table of delivery latency.
"""

from __future__ import annotations

import heapq
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple


@dataclass
class Alarm:
    name: str
    details: Dict = field(default_factory=dict)
    message: str = ""
    activated_at: float = 0.0
    deactivated_at: Optional[float] = None
    expires_at: Optional[float] = None  # auto-deactivate deadline

    @property
    def active(self) -> bool:
        return self.deactivated_at is None


class AlarmRegistry:
    """activate/deactivate with history (emqx_alarm.erl), publishing
    ``$SYS/brokers/<node>/alarms/...`` through the broker.

    Flap damping (per call, default off — legacy semantics hold):
    ``deactivate(name, hold=N)`` parks the deactivation for N seconds
    (processed by `tick`), and an ``activate``/``update`` inside the
    hold CANCELS it — a condition square-waving near its threshold
    costs one activate publish, one eventual deactivate, not one pair
    per oscillation.  ``update(..., min_reraise=N)`` refreshes a
    STANDING alarm's details with the re-publish throttled to one per
    N seconds.  A PUBLISHED deactivate always resets the throttle:
    state changes visible on $SYS are never suppressed — damping only
    thins refreshes of an already-raised alarm."""

    def __init__(self, broker=None, history_cap: int = 256) -> None:
        self.broker = broker
        self.history_cap = history_cap
        self._active: Dict[str, Alarm] = {}
        self._history: List[Alarm] = []
        # name -> wall ts of the last published *activate* (re-raise
        # throttling) / pending-deactivation deadlines (hysteresis)
        self._last_raise: Dict[str, float] = {}
        self._pending_deact: Dict[str, float] = {}

    def activate(
        self,
        name: str,
        details: Optional[Dict] = None,
        message: str = "",
        ttl: Optional[float] = None,
        min_reraise: float = 0.0,
        now: Optional[float] = None,
    ) -> bool:
        now = time.time() if now is None else now
        if name in self._active:
            # the condition re-asserted: a pending (held) deactivation
            # is cancelled without any $SYS churn
            self._pending_deact.pop(name, None)
            return False  # already active (duplicate activation ignored)
        alarm = Alarm(
            name=name,
            details=dict(details or {}),
            message=message or name,
            activated_at=now,
            expires_at=None if ttl is None else now + ttl,
        )
        self._active[name] = alarm
        if min_reraise > 0.0:
            # an inactive->active transition ALWAYS publishes (any
            # prior published deactivate cleared the throttle); the
            # stamp arms `update`'s refresh damping.  Only damped
            # alarms are tracked: per-client names (flapping/<cid>,
            # conn_congestion/<cid>) never pass min_reraise, so
            # client churn cannot grow this dict.
            self._last_raise[name] = now
        self._publish("alarms/activate", alarm)
        return True

    def update(
        self,
        name: str,
        details: Optional[Dict] = None,
        message: str = "",
        min_reraise: float = 0.0,
        now: Optional[float] = None,
    ) -> bool:
        """Refresh an ACTIVE alarm's details/message in place (or
        activate it): publishes an activate message, throttled by
        ``min_reraise`` — the olp ladder's level changes ride one
        standing alarm instead of a deactivate/activate pair."""
        now = time.time() if now is None else now
        alarm = self._active.get(name)
        if alarm is None:
            return self.activate(
                name, details=details, message=message,
                min_reraise=min_reraise, now=now,
            )
        self._pending_deact.pop(name, None)
        if details is not None:
            alarm.details = dict(details)
        if message:
            alarm.message = message
        if min_reraise > 0.0:
            if (
                now - self._last_raise.get(name, float("-inf"))
                < min_reraise
            ):
                return False  # updated silently (damped)
            self._last_raise[name] = now  # damped alarms only (churn)
        self._publish("alarms/activate", alarm)
        return True

    def deactivate(
        self,
        name: str,
        hold: float = 0.0,
        now: Optional[float] = None,
    ) -> bool:
        now = time.time() if now is None else now
        if hold > 0.0:
            if name not in self._active:
                return False
            # hysteresis: park the deactivation; `tick` completes it
            # unless an activate/update cancels it first.  setdefault:
            # repeated held deactivates never push the deadline out.
            self._pending_deact.setdefault(name, now + hold)
            return False
        self._pending_deact.pop(name, None)
        alarm = self._active.pop(name, None)
        if alarm is None:
            return False
        alarm.deactivated_at = now
        self._history.append(alarm)
        del self._history[: -self.history_cap]
        # a PUBLISHED deactivate resets the re-raise damping: the
        # alarm's published state is now "inactive", so the next
        # activation must publish whatever the damping window says —
        # else a flap could leave a live alarm looking cleared for
        # the rest of the episode.  (Also keeps `_last_raise` from
        # outliving its alarm.)
        self._last_raise.pop(name, None)
        self._publish("alarms/deactivate", alarm)
        return True

    def _publish(self, suffix: str, alarm: Alarm) -> None:
        if self.broker is None:
            return
        import json

        from .message import Message

        self.broker.metrics.inc("alarms." + suffix.rsplit("/", 1)[-1])
        node = self.broker.config.node_name
        self.broker.publish(
            Message(
                topic=f"$SYS/brokers/{node}/{suffix}",
                payload=json.dumps(
                    {"name": alarm.name, "message": alarm.message,
                     "details": alarm.details}
                ).encode(),
                sys=True,
            )
        )

    def tick(self, now: Optional[float] = None) -> None:
        """Auto-deactivate alarms past their ttl (per-client flapping
        alarms would otherwise accumulate forever) and complete held
        deactivations whose hysteresis hold elapsed un-cancelled."""
        now = now if now is not None else time.time()
        for name in [
            n
            for n, a in self._active.items()
            if a.expires_at is not None and now > a.expires_at
        ]:
            self.deactivate(name, now=now)
        for name in [
            n for n, at in self._pending_deact.items() if now >= at
        ]:
            self.deactivate(name, now=now)

    def active(self) -> List[Alarm]:
        return list(self._active.values())

    def history(self) -> List[Alarm]:
        return list(self._history)


class BannedList:
    """Deny CONNECT by clientid / username / peerhost until an expiry
    (emqx_banned.erl's mnesia table, node-local here)."""

    def __init__(self) -> None:
        # (kind, value) -> (until_ts | None, reason)
        self._entries: Dict[Tuple[str, str], Tuple[Optional[float], str]] = {}

    def ban(
        self,
        kind: str,
        value: str,
        seconds: Optional[float] = None,
        reason: str = "",
    ) -> None:
        until = None if seconds is None else time.time() + seconds
        self._entries[(kind, value)] = (until, reason)

    def unban(self, kind: str, value: str) -> bool:
        return self._entries.pop((kind, value), None) is not None

    def _check_one(self, kind: str, value: Optional[str]) -> bool:
        if value is None:
            return False
        entry = self._entries.get((kind, value))
        if entry is None:
            return False
        until, _ = entry
        if until is not None and time.time() > until:
            del self._entries[(kind, value)]
            return False
        return True

    def is_banned(
        self,
        clientid: Optional[str] = None,
        username: Optional[str] = None,
        peerhost: Optional[str] = None,
    ) -> bool:
        return (
            self._check_one("clientid", clientid)
            or self._check_one("username", username)
            or self._check_one("peerhost", peerhost)
        )

    def all(self) -> List[Dict]:
        now = time.time()
        return [
            {"as": k, "who": v, "until": until, "reason": reason}
            for (k, v), (until, reason) in self._entries.items()
            if until is None or until > now
        ]


class FlappingDetector:
    """Clients reconnecting more than ``max_count`` times inside
    ``window`` seconds get banned for ``ban_time`` (emqx_flapping.erl)."""

    def __init__(
        self,
        banned: BannedList,
        max_count: int = 15,
        window: float = 60.0,
        ban_time: float = 300.0,
        enable: bool = True,
    ) -> None:
        self.banned = banned
        self.max_count = max_count
        self.window = window
        self.ban_time = ban_time
        self.enable = enable
        # deque per client: trimming the window is popleft (O(1) per
        # expired hit) — list.pop(0) shifted the whole window on every
        # reconnect of a burst (O(window) per hit)
        self._hits: Dict[str, Deque[float]] = {}

    def on_disconnect(self, clientid: str) -> bool:
        """Record a connection cycle; returns True when it tripped the
        detector (client banned)."""
        if not self.enable:
            return False
        now = time.time()
        if len(self._hits) > 10_000:
            # amortized sweep: rotating clientids must not leak entries
            cutoff_all = now - self.window
            self._hits = {
                cid: ts
                for cid, ts in self._hits.items()
                if ts and ts[-1] >= cutoff_all
            }
        hits = self._hits.setdefault(clientid, deque())
        hits.append(now)
        cutoff = now - self.window
        while hits and hits[0] < cutoff:
            hits.popleft()
        if len(hits) >= self.max_count:
            self.banned.ban(
                "clientid",
                clientid,
                seconds=self.ban_time,
                reason="flapping",
            )
            del self._hits[clientid]
            return True
        return False


class SlowSubs:
    """Top-K delivery-latency table (emqx_slow_subs): every delivery
    reports (clientid, topic, latency); the slowest K stick — but only
    for ``expire_interval`` seconds (emqx_slow_subs' expire_interval):
    without expiry a one-off stall from hours ago shadows the board
    forever, until an operator ``clear()``."""

    def __init__(
        self,
        top_k: int = 10,
        threshold_ms: float = 500.0,
        expire_interval: float = 300.0,
    ) -> None:
        self.top_k = top_k
        self.threshold_ms = threshold_ms
        self.expire_interval = expire_interval
        # min-heap of (latency_ms, seq, clientid, topic, ts)
        self._heap: List[Tuple] = []
        self._seq = 0

    def record(self, clientid: str, topic: str, latency_ms: float,
               trace_id: str = "") -> None:
        """``trace_id``: a sampled message's lifecycle trace id, so a
        slow delivery is directly openable as a full trace (empty for
        unsampled deliveries).  Rides the END of the heap tuple —
        (latency, seq) stay the unique ordering keys."""
        if latency_ms < self.threshold_ms:
            return
        self._seq += 1
        item = (latency_ms, self._seq, clientid, topic, time.time(),
                trace_id)
        if len(self._heap) < self.top_k:
            heapq.heappush(self._heap, item)
        elif item > self._heap[0]:
            heapq.heapreplace(self._heap, item)

    def tick(self, now: Optional[float] = None) -> int:
        """Drop entries older than ``expire_interval``; returns the
        number expired.  Driven by the broker's 1 Hz housekeeping."""
        if not self._heap or self.expire_interval <= 0:
            return 0
        now = now if now is not None else time.time()
        cutoff = now - self.expire_interval
        live = [it for it in self._heap if it[4] >= cutoff]
        expired = len(self._heap) - len(live)
        if expired:
            heapq.heapify(live)
            self._heap = live
        return expired

    def top(self) -> List[Dict]:
        return [
            {
                "clientid": cid,
                "topic": topic,
                "latency_ms": round(lat, 3),
                "at": ts,
                "trace_id": trace_id,
            }
            for lat, _, cid, topic, ts, trace_id
            in sorted(self._heap, reverse=True)
        ]

    def clear(self) -> None:
        self._heap = []
