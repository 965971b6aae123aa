"""In-memory MQTT session: subscriptions, mqueue, inflight, awaiting_rel.

Re-creates `emqx_session_mem` (EMQX apps/emqx/src/
emqx_session_mem.erl) + the session facade contract (emqx_session.erl
callbacks :185-195): a channel-owned state machine holding QoS 1/2
delivery windows.  Like the reference, an incoming QoS 2 PUBLISH is
routed immediately and ``awaiting_rel`` only deduplicates until PUBREL
(emqx_session_mem publish path).

The session is detachable: on takeover the channel dies but the session
object moves to the new channel with its pending queue and inflight
window intact (emqx_session_mem:takeover/resume).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..codec import mqtt as C
from ..message import Message
from .inflight import Inflight
from .mqueue import MQueue

# inflight entry phases (server→client delivery)
_PUBLISHING = "publish"  # sent PUBLISH, awaiting PUBACK (q1) / PUBREC (q2)
_PUBREL = "pubrel"  # sent PUBREL, awaiting PUBCOMP


@dataclass
class SubOpts:
    """Per-subscription options (the reference's subopts map)."""

    qos: int = 0
    no_local: bool = False
    retain_as_published: bool = False
    retain_handling: int = 0
    subid: Optional[int] = None
    share_group: Optional[str] = None

    @classmethod
    def from_subscription(
        cls, sub: C.Subscription, share_group: Optional[str] = None
    ) -> "SubOpts":
        return cls(
            qos=sub.qos,
            no_local=sub.no_local,
            retain_as_published=sub.retain_as_published,
            retain_handling=sub.retain_handling,
            share_group=share_group,
        )

    def to_dict(self) -> dict:
        from dataclasses import asdict

        return asdict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "SubOpts":
        return cls(**data)


class _InflightEntry:
    """One inflight-window entry.  A plain __slots__ class (not a
    dataclass): fanout windows construct tens of thousands of these
    per second, and the generated dataclass __init__ was a measurable
    share of the deliver stage.  Entries are immutable by convention —
    every transition REPLACES the entry (`Inflight.update`), never
    mutates one — which is what lets the window dispatch share one
    entry across every subscriber of the same (msg, qos) delivery."""

    __slots__ = ("phase", "msg", "qos", "ts")

    def __init__(self, phase: str, msg: Optional[Message], qos: int,
                 ts: float) -> None:
        self.phase = phase
        self.msg = msg
        self.qos = qos
        self.ts = ts


class Session:
    """One client's session state.  Pure data + transitions: no IO; the
    channel turns returned ``Publish``/``Pubrel`` packets into bytes."""

    def __init__(
        self,
        clientid: str,
        clean_start: bool = True,
        max_inflight: int = 32,
        max_mqueue_len: int = 1000,
        max_awaiting_rel: int = 100,
        await_rel_timeout: float = 300.0,
        retry_interval: float = 30.0,
        expiry_interval: float = 0.0,
        upgrade_qos: bool = False,
        mqueue_priorities: Optional[Dict[str, int]] = None,
        mqueue_default_priority: str = "lowest",
        mqueue_store_qos0: bool = True,
    ) -> None:
        self.clientid = clientid
        self.clean_start = clean_start
        self.created_at = time.time()
        self.subscriptions: Dict[str, SubOpts] = {}
        self.mqueue = MQueue(
            max_len=max_mqueue_len,
            priorities=mqueue_priorities,
            default_priority=mqueue_default_priority,
            store_qos0=mqueue_store_qos0,
        )
        self.inflight = Inflight(max_inflight)
        self.awaiting_rel: Dict[int, float] = {}
        self.max_awaiting_rel = max_awaiting_rel
        self.await_rel_timeout = await_rel_timeout
        self.retry_interval = retry_interval
        self.expiry_interval = expiry_interval
        self.upgrade_qos = upgrade_qos
        self._next_pid = 0
        # True while this CONNECTED session holds mqueue entries parked
        # by the outbound watermark: dispatch keeps queueing its QoS>0
        # deliveries behind them (same-topic order must not invert), and
        # the channel's retry timer drains the queue once the buffer
        # recovers.  `_dequeue` clears it when the queue empties.
        self.out_parked = False
        # persistence-gate refs this session holds (kept by the broker;
        # released once on discard or termination)
        self.gate_filters: set = set()
        # wired by the broker: called with (dropped_msg, reason) when a
        # delivery is lost to queue overflow or expiry
        self.on_dropped: Optional[Callable[[Message, str], None]] = None

    # ------------------------------------------------------- packet ids

    def _alloc_packet_id(self) -> int:
        for _ in range(65535):
            self._next_pid = self._next_pid % 65535 + 1
            if self._next_pid not in self.inflight:
                return self._next_pid
        raise RuntimeError("no free packet id")

    def _consecutive_block(self, n: int) -> Optional[int]:
        """Claim the ``n`` packet ids after ``_next_pid`` when they are
        consecutive and free (away from the 65535 wrap, with a window
        that acks, they nearly always are) and return the first; None
        otherwise, and nothing is claimed.  The ids are those ``n``
        `_alloc_packet_id` calls would give."""
        pid = self._next_pid
        if pid + n <= 65535 and (
            len(self.inflight) == 0
            or self.inflight.free_range(pid + 1, pid + n)
        ):
            self._next_pid = pid + n
            return pid + 1
        return None

    # ------------------------------------------------------ subscribe

    def subscribe(self, flt: str, opts: SubOpts) -> bool:
        """Record the subscription; returns True if it is new (vs an
        option refresh of an existing one)."""
        is_new = flt not in self.subscriptions
        self.subscriptions[flt] = opts
        return is_new

    def unsubscribe(self, flt: str) -> Optional[SubOpts]:
        return self.subscriptions.pop(flt, None)

    # -------------------------------------------------- deliver (out)

    def deliver(
        self,
        deliveries: List[Tuple[Message, SubOpts]],
        encoder: Optional["C.DispatchEncoder"] = None,
        version: Optional[int] = None,
    ) -> List[C.Packet]:
        """Accept matched messages for this session; returns the wire
        packets that can go out now (window permitting) — the
        `emqx_session:deliver/3` path.  Makes the per-delivery
        decisions (no-local, effective QoS, retain-as-published) in
        Python; the broker's window path makes them in one column pass
        and calls `deliver_decided` directly."""
        cid = self.clientid
        upgrade = self.upgrade_qos
        decided = []
        for msg, opts in deliveries:
            if opts.no_local and msg.from_client == cid:
                continue  # [MQTT-3.8.3-3]
            mq, oq = msg.qos, opts.qos
            qos = (mq if mq > oq else oq) if upgrade else (
                mq if mq < oq else oq
            )
            decided.append(
                (msg, opts, qos, msg.retain and opts.retain_as_published)
            )
        return self.deliver_decided(decided, encoder, version)

    def deliver_decided(
        self,
        deliveries: List[Tuple[Message, SubOpts, int, bool]],
        encoder: Optional["C.DispatchEncoder"] = None,
        version: Optional[int] = None,
    ) -> List[C.Packet]:
        """Deliver ``(msg, opts, effective_qos, retain)`` entries whose
        no-local drop, QoS and retain flag are already decided.

        With a window ``encoder`` (and the channel's negotiated
        ``version``), standard deliveries come back as pre-rendered
        single-encode packets: the PUBLISH body is serialized once per
        window and only the packet id is patched per subscriber.
        Deliveries carrying a subscription identifier (per-subscriber
        properties) take the ordinary per-packet encode."""
        out: List[C.Packet] = []
        enc = encoder if version is not None else None
        now = time.time()  # one clock read per run
        for msg, opts, qos, retain in deliveries:
            if qos == 0:
                if enc is not None and opts.subid is None:
                    out.append(enc.publish_qos0(msg, retain, version))
                else:
                    out.append(self._publish_packet(msg, opts, 0, None))
                continue
            if self.inflight.is_full():
                evicted = self.mqueue.insert(self._queued(msg, opts, qos))
                if evicted is not None and self.on_dropped is not None:
                    self.on_dropped(evicted, "queue_full")
                continue
            pid = self._alloc_packet_id()
            self.inflight.insert(
                pid, _InflightEntry(_PUBLISHING, msg, qos, now)
            )
            if enc is not None and opts.subid is None:
                out.append(enc.publish(msg, qos, retain, pid, version))
            else:
                out.append(self._publish_packet(msg, opts, qos, pid))
        return out

    def deliver_run_native(
        self,
        msgs,
        sm: np.ndarray,
        eff: np.ndarray,
        retain: np.ndarray,
        drop: np.ndarray,
        encoder: "C.DispatchEncoder",
        version: int,
    ) -> Optional[Tuple[np.ndarray, np.ndarray, Tuple[int, int, int]]]:
        """The native window path for one client's run, from its
        decided columns (message index, effective QoS, retain flag,
        no-local drop; no delivery may carry a subscription
        identifier): the no-local mask, the encoder's arena slot of
        each kept delivery, and its packet ids as one block with one
        bulk inflight insert (away from the 65535 wrap) under a single
        clock read.  Returns the run's
        splice plan ``(body, pid, (n_qos0, n_qos1, n_qos2))`` — arena
        slots and packet ids (-1 for QoS 0) — which the broker
        assembles with the window's other runs in one native call
        (`ops.dispatchasm.assemble_window`); the wire equals
        `deliver_decided`'s.

        None when the inflight window cannot absorb every QoS>0
        delivery: the caller takes `deliver_decided`, which queues the
        overflow one delivery at a time."""
        keep = ~drop
        if not keep.all():
            sm, eff, retain = sm[keep], eff[keep], retain[keep]
        pend = np.flatnonzero(eff > 0)
        k = len(pend)
        if k and not self.inflight.room_for(k):
            return None
        keys = sm * 6 + eff * 2 + retain
        body = encoder.key_slots(msgs, version, keys)
        pid = np.full(len(body), -1, np.int64)
        n1 = 0
        if k:
            now = time.time()  # one clock read per run
            pq = eff[pend].tolist()
            entries = [_InflightEntry(_PUBLISHING, msgs[i], q, now)
                       for i, q in zip(sm[pend].tolist(), pq)]
            lo = self._consecutive_block(k)
            if lo is not None:  # one bulk insert
                pids = list(range(lo, lo + k))
                self.inflight.insert_seq(lo, entries)
            else:  # the wrap or a collision: the sequential allocator
                pids = []
                for entry in entries:
                    pids.append(self._alloc_packet_id())
                    self.inflight.insert(pids[-1], entry)
            pid[pend] = pids
            n1 = pq.count(1)
        return body, pid, (len(body) - k, n1, k - n1)

    def _effective_qos(self, msg_qos: int, opts: SubOpts) -> int:
        if self.upgrade_qos:
            return max(msg_qos, opts.qos)
        return min(msg_qos, opts.qos)

    def _queued(self, msg: Message, opts: SubOpts, qos: int) -> Message:
        # bake the effective qos + subopts into the queued copy so the
        # dequeue path needs no lookup (subscription may even be gone)
        q = Message(
            topic=msg.topic,
            payload=msg.payload,
            qos=qos,
            retain=msg.retain and opts.retain_as_published,
            from_client=msg.from_client,
            from_username=msg.from_username,
            mid=msg.mid,
            timestamp=msg.timestamp,
            properties=dict(msg.properties),
        )
        if opts.subid is not None:
            q.properties["subscription_identifier"] = [opts.subid]
        return q

    def _publish_packet(
        self,
        msg: Message,
        opts: Optional[SubOpts],
        qos: int,
        pid: Optional[int],
        dup: bool = False,
    ) -> C.Publish:
        props = dict(msg.properties)
        if opts is not None and opts.subid is not None:
            props["subscription_identifier"] = [opts.subid]
        left = msg.remaining_expiry()
        if left is not None:
            props["message_expiry_interval"] = left  # [MQTT-3.3.2-6]
        retain = msg.retain and (opts is None or opts.retain_as_published)
        return C.Publish(
            topic=msg.topic,
            payload=msg.payload,
            qos=qos,
            retain=retain,
            dup=dup,
            packet_id=pid,
            properties=props,
        )

    def _dequeue(self) -> List[C.Packet]:
        out: List[C.Packet] = []
        while not self.inflight.is_full():
            msg = self.mqueue.pop()
            if msg is None:
                break
            if msg.expired():
                if self.on_dropped is not None:
                    self.on_dropped(msg, "expired")
                continue
            if msg.qos == 0:
                out.append(self._publish_packet(msg, None, 0, None))
                continue
            pid = self._alloc_packet_id()
            self.inflight.insert(
                pid, _InflightEntry(_PUBLISHING, msg, msg.qos, time.time())
            )
            out.append(self._publish_packet(msg, None, msg.qos, pid))
        if not len(self.mqueue):
            # the parked backlog (if any) drained: deliveries may take
            # the wire path again
            self.out_parked = False
        return out

    # ------------------------------------------- client acks (out path)

    def puback(self, pid: int) -> Tuple[bool, List[C.Packet]]:
        """PUBACK for a QoS 1 delivery; returns (known, follow-ups)."""
        entry = self.inflight.get(pid)
        if entry is None or entry.qos != 1:
            return False, []
        self.inflight.delete(pid)
        return True, self._dequeue()

    def pubrec(self, pid: int) -> Tuple[bool, List[C.Packet]]:
        """PUBREC for a QoS 2 delivery: advance to PUBREL phase."""
        entry = self.inflight.get(pid)
        if entry is None or entry.qos != 2 or entry.phase != _PUBLISHING:
            return False, []
        self.inflight.update(
            pid, _InflightEntry(_PUBREL, None, 2, time.time())
        )
        return True, [C.Pubrel(packet_id=pid)]

    def pubcomp(self, pid: int) -> Tuple[bool, List[C.Packet]]:
        entry = self.inflight.get(pid)
        if entry is None or entry.phase != _PUBREL:
            return False, []
        self.inflight.delete(pid)
        return True, self._dequeue()

    # ------------------------------------------- incoming QoS 2 dedup

    def awaiting_rel_add(self, pid: int) -> str:
        """Register an incoming QoS 2 packet id.  Returns 'ok',
        'in_use' (duplicate), or 'full'."""
        if pid in self.awaiting_rel:
            return "in_use"
        if (
            self.max_awaiting_rel
            and len(self.awaiting_rel) >= self.max_awaiting_rel
        ):
            return "full"
        self.awaiting_rel[pid] = time.time()
        return "ok"

    def pubrel(self, pid: int) -> bool:
        return self.awaiting_rel.pop(pid, None) is not None

    def expire_awaiting_rel(self, now: Optional[float] = None) -> int:
        now = now if now is not None else time.time()
        stale = [
            pid
            for pid, ts in self.awaiting_rel.items()
            if now - ts > self.await_rel_timeout
        ]
        for pid in stale:
            del self.awaiting_rel[pid]
        return len(stale)

    # ------------------------------------------------- retry / resume

    def retry(self, now: Optional[float] = None) -> List[C.Packet]:
        """Retransmit timed-out inflight entries (emqx_session_mem
        retry timer)."""
        now = now if now is not None else time.time()
        out: List[C.Packet] = []
        for pid, entry in self.inflight.items():
            if now - entry.ts < self.retry_interval:
                continue
            if entry.phase == _PUBLISHING and entry.msg is not None:
                if entry.msg.expired(now):
                    self.inflight.delete(pid)
                    continue
                self.inflight.update(
                    pid,
                    _InflightEntry(_PUBLISHING, entry.msg, entry.qos, now),
                )
                out.append(
                    self._publish_packet(
                        entry.msg, None, entry.qos, pid, dup=True
                    )
                )
            elif entry.phase == _PUBREL:
                self.inflight.update(pid, _InflightEntry(_PUBREL, None, 2, now))
                out.append(C.Pubrel(packet_id=pid))
        return out

    def resume(self) -> List[C.Packet]:
        """Redeliver state to a reconnected client: all inflight
        PUBLISHes (dup=1) and PUBRELs in original order, then drain the
        queue into the window (emqx_session_mem:replay)."""
        out: List[C.Packet] = []
        now = time.time()
        for pid, entry in self.inflight.items():
            if entry.phase == _PUBLISHING and entry.msg is not None:
                self.inflight.update(
                    pid,
                    _InflightEntry(_PUBLISHING, entry.msg, entry.qos, now),
                )
                out.append(
                    self._publish_packet(
                        entry.msg, None, entry.qos, pid, dup=True
                    )
                )
            elif entry.phase == _PUBREL:
                out.append(C.Pubrel(packet_id=pid))
        out.extend(self._dequeue())
        return out

    def info(self) -> Dict[str, object]:
        return {
            "clientid": self.clientid,
            "created_at": self.created_at,
            "subscriptions_cnt": len(self.subscriptions),
            "mqueue_len": len(self.mqueue),
            "mqueue_dropped": self.mqueue.dropped,
            "inflight_cnt": len(self.inflight),
            "awaiting_rel_cnt": len(self.awaiting_rel),
        }
