"""Broker core: publish routing + fan-out dispatch.

``publish_many`` routes a window of messages through these stages:

  0. prepare — the ``message.publish`` hook fold of each message, on
     its own (`DelayedPublish` swallows ``$delayed/`` publishes,
     `TopicRewrite` rewrites topics, `TopicMetrics` counts; a message
     the fold swallows counts as dropped, one whose fold raises as a
     publish error), then ingress accounting and the retained store
     (`Retainer.store`) of every surviving retained publish: the
     fold's result, not the original, goes on to the retainer and the
     match.  The batcher awaits `publish_prepare_async`: when an
     IO-backed hook (an exhook verdict RPC) is registered, the folds of
     the window's messages await off the event loop concurrently;
  1. match — `MatchEngine.match_batch_submit/finish`: one compact match
     kernel launch for the window's distinct topics, codes expanded to
     filters on the host, the host tiers overlaid;
  2. decide — `Router.expand_window` CSR-expands the matched filters
     into flat ``(msg_idx, client_row, opts_row)`` delivery columns;
     each shared group a message matched adds its pick of one live
     member (`SharedSubManager.pick`) to the same columns, and
     `MatchEngine.decide_window` packs every delivery's effective
     QoS, no-local drop and retain flag in one kernel launch;
  3. deliver — one run per subscriber, in publish order, encoded once
     per window (`DispatchEncoder`): each connected run's decided
     columns become its arena slots and packet ids
     (`Session.deliver_run_native`), and ONE native call splices every
     such run's wire (`ops.dispatchasm.assemble_window`); runs the
     native path does not take (subscription identifiers, no inflight
     room, ``native=False``) go through `Session.deliver_decided`.
     Each connection gets one corked write.  A connected run's
     ``(msg, opts)`` list is built only when a ``message.delivered``
     hook or a ``delivered_batch_sinks`` entry is registered
     (`_materialize_run`), and its publishes older than the
     slow-subscriber threshold go to `SlowSubs`.  After the flush each
     sink gets one call with every connected run of the window
     (``[(clientid, [(msg, opts), ...]), ...]``; the exhook client's
     ``message.delivered`` bridge);
  4. rules — the window's rule hits (rule fids the match returned
     beside the subscriptions) run through `RuleEngine.apply_batch`:
     one rules x window WHERE matrix kernel launch, then the actions.

`PublishBatcher` is the live front: connections enqueue concurrently,
a collector closes a window every ``batch_window_ms`` or ``batch_max``
messages and launches its match off the event loop, and a dispatch loop
delivers windows strictly in order.

Every window is timed stage by stage into ``Broker.profiler``
(`observability.Profiler`): ``batch_wait`` (the batcher's
accumulation), ``prepare``, ``match_submit``, ``match_wait``,
``dispatch_wait``, ``expand``, ``decide``, ``deliver`` (with its
native ``assemble`` share), ``flush`` and ``rules``, plus the engine's
``tokenize`` and its rebuild and upload events;
``Broker.profiler.summary()`` reads them.

The broker's control surface sits beside the path: the hook registry
(``hooks``), ``metrics`` and ``stats``, ``access`` (authentication and
authorization, run by the channel; with ``gcp_device_enable`` the
GCP device registry, ``gcp_devices``), ``banned``, ``flapping``,
``alarms``, ``slow_subs``, the zone rate limiter, and the modules.
The rules' egress hangs off it: ``resources`` (the sinks' buffer
workers, by resource id) and ``aggregators`` (ticked by the server).
``tick(now)`` is the 1 Hz housekeeping: delayed wills, delayed
publishes, topic-metric rates, alarm expiry, slow-subscriber expiry,
session expiry and, with ``durable.enable``, the store's checkpoints,
retention and interval fsyncs.

With ``durable.enable`` the broker keeps persistent sessions in the
durable store (``ds.persist.DurableSessions``): ``prepare`` persists
the publishes a persistent subscription's filter matches (the host
gate), a disconnecting persistent session is checkpointed, and a
reconnect after a restart rebuilds the session and replays the missed
interval.  ``resume`` (`broker.resume.ResumeScheduler`) replays whole
windows of it through `_dispatch_window` with ``preexpanded`` delivery
columns, so a mass reconnect is decided by the decide kernel on the
card like live traffic.  In ``fsync = "always"`` mode the batcher parks
a window's acks until the fsync that covers its captures lands.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from collections import Counter, deque
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .. import topic as T
from ..access import AccessControl
from ..codec import mqtt as C
from ..config import RESUME_SHARD_REFUSED, BrokerConfig
from ..engine import MatchEngine
from ..hooks import HookRegistry
from ..limiter import ConnectionLimiter
from ..message import Message
from ..metrics import Metrics, Stats
from ..modules import DelayedPublish, ExclusiveSub, TopicMetrics, TopicRewrite
from ..observability import Profiler
from ..ops import dispatchasm
from ..ops.match_kernel import (
    DEC_DROP_BIT, DEC_QMAX_SHIFT, DEC_RETAIN_BIT, DEC_SUBID_BIT,
)
from ..ops_guard import AlarmRegistry, BannedList, FlappingDetector, SlowSubs
from ..resources import ResourceManager
from ..retainer import Retainer
from ..router import Router
from ..rules.engine import RuleEngine
from .cm import ConnectionManager
from .session import Session, SubOpts
from .shared import SharedSubManager

log = logging.getLogger("emqx_tpu_torch.broker")

# a fold that raised: counted as a publish error, never routed
_PREPARE_ERROR = object()

class Broker:
    """``native`` (the default) runs the C++ host path — the engine's
    trie tiers, window encode and automaton sorts, and the window's
    wire splice — and raises when its libraries do not build;
    ``native=False`` runs their Python referees.  ``shared_strategy``
    is the `SharedSubManager`'s pick strategy for ``$share/`` groups."""

    def __init__(
        self, config: Optional[BrokerConfig] = None, device="cuda",
        native: bool = True, shared_strategy: str = "random",
    ) -> None:
        self.config = config or BrokerConfig()
        self.hooks = HookRegistry()
        self.metrics = Metrics()
        self.stats = Stats()
        eng = self.config.engine
        self.native = native
        self.router = Router(MatchEngine(
            max_levels=eng.max_levels,
            f_width=eng.f_width,
            m_cap=eng.m_cap,
            rebuild_threshold=eng.rebuild_threshold,
            device=device,
            native=native,
            background_rebuild=eng.background_rebuild,
        ), shared=SharedSubManager(strategy=shared_strategy))
        prof = self.config.profiler
        self.profiler = Profiler(
            ring_size=prof.ring_size, events_cap=prof.events_cap,
            enabled=prof.enable,
        )
        # the engine's tokenize stage and its rebuild/upload events
        # land in the same profiler as the window stages
        self.router.engine.profiler = self.profiler
        ret = self.config.retainer
        self.retainer = Retainer(
            max_retained_messages=ret.max_retained_messages,
            max_payload_size=ret.max_payload_size,
            msg_expiry_interval=ret.msg_expiry_interval,
            enable=ret.enable,
        )
        auth = self.config.auth
        self.access = AccessControl(
            hooks=self.hooks,
            allow_anonymous=auth.allow_anonymous,
            authz_default=auth.authz_default,
            deny_action=auth.deny_action,
        )
        self.gcp_devices = None
        if self.config.gcp_device_enable:
            from ..gcp_device import GcpDeviceAuthenticator, GcpDeviceRegistry

            os.makedirs(
                os.path.dirname(self.config.gcp_device_file) or ".",
                exist_ok=True,
            )
            self.gcp_devices = GcpDeviceRegistry(self.config.gcp_device_file)
            self.access.authenticators.append(
                GcpDeviceAuthenticator(self.gcp_devices))
        self.cm = ConnectionManager(self._make_session)
        # ACL-cache eviction probes session liveness so pressure never
        # wipes a connected client's prefetched rows
        self.access.is_live = lambda cid: self.cm.lookup(cid) is not None
        self.cm.on_discarded = self._session_discarded
        self.cm.on_takenover = (
            lambda s: self.metrics.inc("session.takenover"))
        self.rules = RuleEngine(broker=self)
        # message.publish fold order: delayed (100), rewrite (90),
        # topic metrics (5)
        self.delayed = DelayedPublish(self)
        self.rewrite = TopicRewrite(self)
        self.exclusive = ExclusiveSub()
        self.topic_metrics = TopicMetrics(self)
        self.alarms = AlarmRegistry(self)
        # rule sinks: named buffer workers whose health flips and
        # breaker edges raise alarms here
        self.resources = ResourceManager(alarms=self.alarms)
        # aggregators attached by rules (emqx_connector_aggregator
        # buffers): ticked by the server's 1 Hz housekeeping
        self.aggregators: List = []
        # window-level ``message.delivered`` consumers: each is called
        # once per dispatch window, after the flush, with the window's
        # connected runs (the exhook client's bridge)
        self.delivered_batch_sinks: List[Callable] = []
        self.banned = BannedList()
        fl = self.config.flapping
        self.flapping = FlappingDetector(
            self.banned, max_count=fl.max_count, window=fl.window,
            ban_time=fl.ban_time, enable=fl.enable,
        )
        ss = self.config.slow_subs
        self.slow_subs = SlowSubs(
            top_k=ss.top_k,
            # disabled = a threshold no delivery reaches: the dispatch
            # path's one compare a window then never scans a run
            threshold_ms=ss.threshold_ms if ss.enable else float("inf"),
            expire_interval=ss.expire_interval,
        )
        # node/zone-aggregate ingress limiter (top of the hierarchy)
        self.zone_limiter: Optional[ConnectionLimiter] = None
        mq = self.config.mqtt
        if mq.zone_messages_rate > 0 or mq.zone_bytes_rate > 0:
            self.zone_limiter = ConnectionLimiter(
                messages_rate=mq.zone_messages_rate,
                bytes_rate=mq.zone_bytes_rate, shared=True,
            )
        # live micro-batcher, installed by the server (needs a loop);
        # without one, channels publish synchronously
        self.batcher: Optional[PublishBatcher] = None
        # the server's event loop, once it starts: callbacks from the
        # store's threads (corruption, census rebuild) run on it
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # durable storage + persistent sessions (emqx_persistent_message
        # gate + emqx_persistent_session_ds restore-on-reconnect)
        self.durable = None
        # mass-reconnect admission control + windowed replay: built
        # with the store, DRIVEN by BrokerServer (its task flips
        # `running`; a loop-less broker resumes with the scalar loop
        # inside open_session)
        self.resume = None
        if self.config.durable.enable:
            self._init_durable(native)
        # clientid -> (fire at, will message): MQTT 5 delayed wills,
        # fired by `tick`
        self._pending_wills: Dict[str, Tuple[float, Message]] = {}
        self._last_ds_sync = time.time()
        self._last_ds_fsync = time.time()

    def _init_durable(self, native: bool) -> None:
        from ..ds.persist import DurableSessions
        from .resume import ResumeScheduler

        cfg = self.config.durable
        if (int(cfg.resume.shard_index), int(cfg.resume.shard_count)) \
                != (0, 1):
            raise ValueError(RESUME_SHARD_REFUSED)
        self.durable = DurableSessions(
            cfg.data_dir,
            n_streams=cfg.n_streams,
            store_qos0=cfg.store_qos0,
            layout=cfg.layout,
            fsync=cfg.fsync,
            n_shards=cfg.n_shards,
            native=native,
        )
        # detected corruption (quarantined log records, unreadable
        # sidecars) surfaces as alarms + counters; the constructor
        # buffered what its own loads found
        self.durable.on_corruption = self._ds_corruption
        for evt in self.durable.corruption_events:
            self._ds_corruption(evt)
        self.durable.corruption_events = []
        # background census rebuild -> the ds_meta_rebuild alarm
        self.durable.on_rebuild = self._ds_rebuild
        for evt in self.durable.rebuild_events:
            self._ds_rebuild(evt)
        self.durable.rebuild_events = []
        # every group fsync is counted and timed (the profiler's
        # ds_sync stage)
        self.durable.gate.on_sync = self._ds_synced
        self.durable.gate.on_error = self._ds_sync_error
        # a dropped boot checkpoint retracts the routes advertised for
        # its detached session
        self.durable.on_drop = self.router.cleanup_client
        # checkpoints that expired while the broker was down go before
        # their filters are advertised
        self.durable.purge_expired()
        for state in self.durable.boot_states():
            # boot-state filters route (shared ones too), so publishes
            # in the restart -> reconnect window keep persisting
            for flt, opts_dict in state.subs.items():
                self.router.subscribe(
                    state.clientid, flt, SubOpts.from_dict(opts_dict))
        self.resume = ResumeScheduler(self, cfg.resume)
        # every channel detach releases a mid-replay session's slot;
        # the job and its boot checkpoint survive for the reconnect
        self.cm.on_detached = self.resume.pause

    # -------------------------------------------------- session setup

    def _make_session(self, clientid: str, clean_start: bool, **kw) -> Session:
        mqtt = self.config.mqtt
        self.metrics.inc("session.created")
        self.hooks.run("session.created", clientid)
        session = Session(
            clientid=clientid,
            clean_start=clean_start,
            max_inflight=kw.get("max_inflight", mqtt.max_inflight),
            max_mqueue_len=mqtt.max_mqueue_len,
            max_awaiting_rel=mqtt.max_awaiting_rel,
            await_rel_timeout=mqtt.await_rel_timeout,
            retry_interval=mqtt.retry_interval,
            expiry_interval=kw.get(
                "expiry_interval",
                0.0 if clean_start else mqtt.session_expiry_interval,
            ),
            upgrade_qos=mqtt.upgrade_qos,
            mqueue_priorities=mqtt.mqueue_priorities,
            mqueue_default_priority=mqtt.mqueue_default_priority,
            mqueue_store_qos0=mqtt.mqueue_store_qos0,
        )

        def on_dropped(msg: Message, reason: str) -> None:
            self.metrics.inc("delivery.dropped")
            self.metrics.inc(f"delivery.dropped.{reason}")
            self.hooks.run("delivery.dropped", clientid, msg, reason)

        session.on_dropped = on_dropped
        return session

    def _session_discarded(self, session: Session) -> None:
        self.metrics.inc("session.discarded")
        if self.resume is not None:
            # a discarded session is owed nothing: drop any replay job
            self.resume.cancel(session.clientid)
        if self.durable is not None:
            # the persistence gate must not outlive the session, or the
            # log grows for a subscriber that can never return
            self._release_gate(session)
            self.durable.discard(session.clientid)
        self.router.cleanup_client(session.clientid)
        self.exclusive.release_all(session.clientid)
        self.hooks.run("session.discarded", session.clientid)

    @staticmethod
    def _gate_real(flt: str) -> str:
        """The persistence gate matches MESSAGE TOPICS, so a $share
        filter contributes its real topic part."""
        share = T.parse_share(flt)
        return share.topic if share else flt

    def _release_gate(self, session: Session) -> None:
        """Release exactly the persistence-gate refs this session holds."""
        if self.durable is not None:
            for flt in session.gate_filters:
                self.durable.remove_filter(self._gate_real(flt))
                if T.parse_share(flt) is not None:
                    self.durable.shared_leave(flt, session.clientid)
            session.gate_filters.clear()

    def session_terminated(self, clientid: str, session: Session) -> None:
        """A session ending with expiry <= 0: drop its router state, its
        ``$exclusive/`` holds and its persistence-gate refs."""
        if self.resume is not None:
            # the client abandoned the session: nothing is owed, so the
            # replay job and the boot checkpoint it drained go (discard,
            # not drop_checkpoint: the boot state's gate refs moved to
            # the live session and `_release_gate` releases them once)
            self.resume.cancel(clientid)
            self.durable.discard(clientid)
        self._release_gate(session)
        self.router.cleanup_client(clientid)
        self.exclusive.release_all(clientid)
        self.metrics.inc("session.terminated")

    # ---------------------------------------------------- subscribe

    def subscribe(self, clientid: str, flt: str, opts: SubOpts,
                  is_new_sub: bool = True) -> List[Message]:
        """Register the subscription; returns the retained messages to
        replay per retain_handling ([MQTT-3.3.1-9..11])."""
        self.router.subscribe(clientid, flt, opts)
        # gate refcount: only a NEW subscription counts (an options
        # refresh must not inflate it); session.gate_filters records the
        # refs this session holds, released once on every teardown path
        if self.durable is not None:
            session = self.cm.lookup(clientid)
            if (
                session is not None
                and session.expiry_interval > 0
                and flt not in session.gate_filters
            ):
                self.durable.add_filter(self._gate_real(flt))
                session.gate_filters.add(flt)
                if opts.share_group is not None:
                    # durable group membership drives the replay-time
                    # stream assignment across restarts
                    self.durable.shared_join(flt, clientid)
        self.hooks.run("session.subscribed", clientid, flt, opts)
        self.stats.set("subscriptions.count",
                       self.router.subscription_count())
        if opts.share_group is not None:
            return []  # retained never replay to shared subs [MQTT-4.8.2-27]
        rh = opts.retain_handling
        if rh == 2 or (rh == 1 and not is_new_sub):
            return []
        return self.retainer.match(flt)

    def unsubscribe(self, clientid: str, flt: str) -> bool:
        ok = self.router.unsubscribe(clientid, flt)
        if ok:
            if self.durable is not None:
                session = self.cm.lookup(clientid)
                if session is not None and flt in session.gate_filters:
                    session.gate_filters.discard(flt)
                    self.durable.remove_filter(self._gate_real(flt))
                    if T.parse_share(flt) is not None:
                        self.durable.shared_leave(flt, clientid)
            self.hooks.run("session.unsubscribed", clientid, flt)
            self.stats.set("subscriptions.count",
                           self.router.subscription_count())
        return ok

    # --------------------------------------------- session open/close

    def open_session(
        self, clean_start: bool, clientid: str, channel, **session_kwargs
    ) -> Tuple[Session, bool]:
        """`emqx_cm:open_session` plus durable restore: when the broker
        restarted and the in-memory session is gone, a clean_start=false
        reconnect rebuilds the session from its checkpoint and replays
        the messages persisted since the disconnect
        (emqx_persistent_session_ds resume).

        Under a running server the replay is handed to the resume
        scheduler (CONNACK-then-drain: the backlog streams in as
        dispatch windows under admission control); with no scheduler
        running the scalar replay fills the mqueue before returning.
        Raises `ResumeBusy`, before any session state exists, when
        admission is saturated, so the channel answers CONNACK
        server-busy; and the error that stopped the scheduler (a failed
        decide launch) when a replay is owed after it."""
        resume = self.resume
        if (
            resume is not None
            and resume.error is not None
            and not clean_start
            and (
                resume.pending(clientid)
                or (
                    self.cm.lookup(clientid) is None
                    and self.durable.has_checkpoint(clientid)
                )
            )
        ):
            raise resume.error
        if (
            resume is not None
            and resume.running
            and not clean_start
            and self.cm.lookup(clientid) is None
            and self.durable.has_checkpoint(clientid)
            and not resume.pending(clientid)
            and resume.saturated()
        ):
            from .resume import ResumeBusy

            self.metrics.inc("session.resume.busy")
            raise ResumeBusy(clientid)
        session, present = self.cm.open_session(
            clean_start, clientid, channel, **session_kwargs
        )
        if present or clean_start or self.durable is None:
            if self.durable is not None and (clean_start or present):
                if (
                    present
                    and not clean_start
                    and resume is not None
                    and resume.pending(clientid)
                ):
                    # a session still mid-replay reconnected: the new
                    # channel takes over and the scheduler goes on from
                    # the cursors; the boot checkpoint stays until
                    # commit (its cursors are the crash story)
                    resume.reattach(clientid)
                else:
                    # a live resume or clean start invalidates the
                    # checkpoint (a later restart would double-replay),
                    # and releases the gate refs its boot state took
                    self.durable.drop_checkpoint(clientid)
            return session, present
        state = self.durable.load(clientid)
        if state is None:
            return session, False
        # rebuild the subscriptions, then replay the missed interval
        for flt, opts_dict in state.subs.items():
            opts = SubOpts.from_dict(opts_dict)
            session.subscribe(flt, opts)
            self.router.subscribe(clientid, flt, opts)
            # the boot state's gate refs move to the live session,
            # released once on its discard or termination
            session.gate_filters.add(flt)
        if resume is not None and resume.running:
            # CONNACK-then-drain: commit (checkpoint discard and
            # session.resumed) fires when the last window is handed off
            resume.admit(clientid, state, session)
            return session, True
        complete = self._resume_scalar(session, state)
        if complete:
            # an INCOMPLETE replay (a dropped read with no scheduler to
            # retry) keeps the checkpoint and is not a resume
            self.durable.discard(clientid)
            self.metrics.inc("session.resumed")
            self.hooks.run("session.resumed", clientid)
        return session, True

    def _resume_scalar(self, session: Session, state) -> bool:
        """The scalar per-session resume loop: chunked `replay_chunk`
        reads baked into the session's mqueue, drained into the send
        window after CONNACK by `session.resume()`.  The referee the
        windowed resume is held to (wire bytes, packet ids, inflight),
        and the path when no scheduler runs.  True when the whole
        interval was read; False when a blocked read stopped it (the
        checkpoint must survive).  The cursors are not checkpointed
        here: a chunk lives only in the in-memory mqueue until it is
        delivered."""
        while True:
            msgs, done = self.durable.replay_chunk(state)
            self._resume_enqueue(session, msgs)
            if done:
                return True
            if not msgs:
                return False

    def _resume_enqueue(self, session: Session, msgs) -> int:
        """Bake one replay chunk into a session's mqueue (the scalar
        resume's delivery half; the scheduler's scalar mode calls it
        per chunk).  The replay admission filters: the subscription
        must still exist, no-local ([MQTT-3.8.3-3]: a client's own
        publishes never replay to a no_local subscription), and the
        mqueue's QoS 0 store gate."""
        clientid = session.clientid
        store_q0 = self.config.mqtt.mqueue_store_qos0
        replayed = 0
        for flt, msg in msgs:
            opts = session.subscriptions.get(flt)
            if opts is None:
                continue
            if opts.no_local and msg.from_client == clientid:
                continue
            qos = session._effective_qos(msg.qos, opts)
            if qos == 0 and not store_q0:
                continue
            session.mqueue.insert(
                session._queued(msg, opts, max(qos, 0))
            )
            replayed += 1
        return replayed

    def channel_disconnected(self, clientid: str) -> None:
        """Checkpoint a persistent session at channel close so a broker
        restart can rebuild it (emqx_persistent_session_ds commit).  A
        stale close (a new channel already attached) does not
        checkpoint: a restart would double-replay what the live
        connection received."""
        session = self.cm.lookup(clientid)
        if (
            session is None
            or self.cm.channel(clientid) is not None
            or session.expiry_interval <= 0
            or not session.subscriptions
            or self.durable is None
        ):
            return
        if self.resume is not None and self.resume.pending(clientid):
            # disconnected MID-REPLAY: the boot checkpoint still covers
            # the whole interval and is kept (a fresh one would skip the
            # un-replayed tail after a restart); subscription changes of
            # the live window reach disk with the original cursors
            self.resume.pause(clientid)
            self.resume.refresh_checkpoint(clientid, session)
        else:
            try:
                self.durable.save(
                    clientid, session.subscriptions,
                    session.expiry_interval,
                )
            except Exception:
                # a failed write leaves the previous checkpoint: replay
                # starts from its older disconnect (at-least-once)
                log.exception("durable checkpoint failed for %s", clientid)

    # ------------------------------------------------------- wills

    def schedule_will(self, clientid: str, will: Message,
                      delay: float) -> None:
        """Hold a will for will_delay_interval seconds
        ([MQTT-3.1.3.2.2]); `tick` fires it, a reconnect cancels it."""
        self._pending_wills[clientid] = (time.time() + delay, will)

    def cancel_will(self, clientid: str) -> None:
        self._pending_wills.pop(clientid, None)

    # ------------------------------------------------- housekeeping

    def tick(self, now: Optional[float] = None) -> None:
        """The 1 Hz housekeeping (the server's timer, or a test's
        injected clock): due wills, due delayed publishes, topic-metric
        rates, alarm expiry, slow-subscriber expiry, session expiry,
        and the durable store's expiry, checkpoints, retention and
        interval fsyncs."""
        now = now if now is not None else time.time()
        due = [cid for cid, (at, _) in self._pending_wills.items()
               if now >= at]
        for cid in due:
            _, will = self._pending_wills.pop(cid)
            self.publish(will)
        self.delayed.tick(now)
        self.topic_metrics.tick(now)
        self.alarms.tick(now)
        self.slow_subs.tick(now)
        self.cm.expire_sessions(now)
        if self.durable is not None:
            self.durable.purge_expired(now)
            cfg = self.config.durable
            if now - self._last_ds_sync >= cfg.sync_interval:
                self._last_ds_sync = now
                self.durable.checkpoint_meta()  # census/index + progress
                self.durable.gc(
                    int((now - cfg.retention_hours * 3600.0) * 1e6))
            if cfg.fsync != "never" and (
                now - self._last_ds_fsync >= cfg.fsync_interval
            ):
                # the interval mode's group flush, and the `always`
                # mode's backstop for appends no barrier covered
                self._last_ds_fsync = now
                self.durable.sync_soon()

    # ------------------------------------------------------ publish

    def publish(self, msg: Message) -> int:
        """Route one message; returns the delivery count."""
        return self.publish_many([msg])[0]

    def publish_many(self, msgs: Sequence[Message]) -> List[int]:
        """Route a window: all topics matched in one kernel launch."""
        rec = self.profiler.begin(len(msgs))
        dur = self.durable
        always = dur is not None and dur.fsync_mode == "always"
        wm0 = dur.gate.appended if always else 0
        live, results = self.publish_prepare(msgs)
        if rec is not None:
            rec.lap("prepare")
        counts = merge_counts(results, self.publish_dispatch(
            live, self.publish_match_finish(
                self.publish_match_submit(live, rec)), rec))
        if always and dur.gate.appended > wm0 and dur.gate.dirty:
            # loop-less group commit: the caller acks after this
            # returns, so the covering flush runs here, once a window,
            # and only when THIS window captured something
            dur.gate.sync_now()
        return counts

    def publish_prepare(
        self, msgs: Sequence[Message]
    ) -> Tuple[List[Message], List[Optional[int]]]:
        """Stage 0 (loop thread): each message's ``message.publish``
        fold on its own (one failing hook does not fail the window).  A
        swallowed message is dropped (``message.dropped`` by_hook); the
        fold's result is stored when retained (an empty payload deletes)
        and goes on to the match.  Returns the messages that go on, and
        a count per input message: 0 where the fold swallowed it or
        failed, None where dispatch fills it in."""
        outs: List[object] = []
        for msg in msgs:
            try:
                outs.append(self.hooks.run_fold("message.publish", (), msg))
            except Exception:
                log.exception("publish prepare failed for %s", msg.topic)
                outs.append(_PREPARE_ERROR)
        return self._prepare_finish(msgs, outs)

    async def publish_prepare_async(
        self, msgs: Sequence[Message]
    ) -> Tuple[List[Message], List[Optional[int]]]:
        """`publish_prepare` for the batcher: when an IO-backed
        ``message.publish`` hook is registered (an exhook verdict RPC),
        the window's folds await off the event loop concurrently instead
        of blocking it one round trip after another; without one this
        is the synchronous path."""
        if not self.hooks.has_async("message.publish"):
            return self.publish_prepare(msgs)

        async def fold_one(msg: Message) -> object:
            try:
                return await self.hooks.run_fold_async(
                    "message.publish", (), msg)
            except Exception:
                log.exception("publish prepare failed for %s", msg.topic)
                return _PREPARE_ERROR

        outs = await asyncio.gather(*(fold_one(m) for m in msgs))
        return self._prepare_finish(msgs, list(outs))

    def _prepare_finish(
        self, msgs: Sequence[Message], outs: List[object]
    ) -> Tuple[List[Message], List[Optional[int]]]:
        """Stage 0's tail, shared by both folds: apply each verdict,
        count, store the retained survivors."""
        live: List[Message] = []
        results: List[Optional[int]] = []
        for msg, out in zip(msgs, outs):
            if out is _PREPARE_ERROR:
                self.metrics.inc("messages.publish.error")
                results.append(0)
                continue
            if out is None:
                self.metrics.inc("messages.dropped")
                self.hooks.run("message.dropped", msg, "by_hook")
                results.append(0)
                continue
            msg = out  # type: ignore[assignment]
            try:
                self.metrics.inc("messages.publish")
                if msg.retain and not msg.sys:
                    if self.retainer.store(msg) and msg.payload:
                        self.metrics.inc("messages.retained")
            except Exception:
                log.exception("publish prepare failed for %s", msg.topic)
                self.metrics.inc("messages.publish.error")
                results.append(0)
                continue
            live.append(msg)
            results.append(None)
        if live and self.durable is not None:
            try:
                self.durable.persist(live)
            except Exception:
                log.exception("durable persist failed for window")
        return live, results

    def publish_match_submit(self, msgs: Sequence[Message], rec=None):
        """Stage 1a (any thread): launch the window's match.  ``rec``,
        the window's profiler record, rides the handle to the finish."""
        pending = None
        if msgs:
            pending = self.router.engine.match_batch_submit(
                [m.topic for m in msgs])
        if rec is not None:
            rec.lap("match_submit")
        return pending, rec

    def publish_match_finish(self, handle) -> List[Set[str]]:
        """Stage 1b (any thread): wait for the match, overlay host tiers."""
        pending, rec = handle
        matched = (
            [] if pending is None
            else self.router.engine.match_batch_finish(pending)
        )
        if rec is not None:
            rec.lap("match_wait")
            if pending is not None:
                rec.path = "host" if pending[0] == "host" else "dev"
        return matched

    def publish_dispatch(
        self, msgs: Sequence[Message], matched: Sequence[Set[str]],
        rec=None,
    ) -> List[int]:
        """Stage 2 (loop thread): decide and deliver the whole window,
        then run all its rule hits in one pass.  Commits ``rec``
        whatever happens."""
        try:
            if rec is not None:
                # queued behind earlier windows in the ordered dispatch
                rec.lap("dispatch_wait")
            if not msgs:
                return []
            rule_sink: List[Tuple[Message, List[str]]] = []
            counts = self._dispatch_window(msgs, matched, rule_sink, rec)
            if rule_sink:
                # rec takes the rules_extract/rules_eval sub-stages
                try:
                    self.rules.apply_batch(rule_sink, rec=rec)
                except Exception:
                    log.exception("rule batch failed for window")
                if rec is not None:
                    rec.lap("rules")
            return counts
        finally:
            if rec is not None:
                self.profiler.commit(rec)

    # ----------------------------------------------------- dispatch

    def _dispatch_window(
        self, msgs: Sequence[Message],
        matched: Optional[Sequence[Set[str]]],
        rule_sink: List[Tuple[Message, List[str]]], rec=None,
        preexpanded: Optional[Tuple] = None, replay: bool = False,
    ) -> List[int]:
        """Fan a routed window out to subscriber sessions: CSR-expand,
        group per client with one stable sort (each client's deliveries
        keep publish order), decide every delivery in one column pass,
        deliver one run per client, splice the native runs' wire in one
        call.  A connected client's run counts every delivery (no-local
        drops included) toward its message's delivery count; a detached
        persistent session counts what it queued.  A message that only a
        shared group received was delivered.  Rule hits go to
        ``rule_sink`` as ``(message, raw rule ids)``; a message only
        rules matched counts as dropped for no subscribers, as in the
        JAX package.

        ``preexpanded`` (the durable replay window) supplies the
        ``(msg_idx, client_rows, opts_rows)`` delivery columns directly,
        client-contiguous with each client's entries in its replay
        order: route expansion and the per-client sort are skipped (the
        targets are the resuming clients, and their order is the replay
        cursors' order the scalar referee produces), and the decide
        kernel decides the window as it does live traffic.  ``replay``
        skips the accounting that means nothing for a backlog: no
        no-subscriber drops, no publish-to-delivery latency, no slow
        subscriber scan."""
        router = self.router
        n = len(msgs)
        cnt = np.zeros(n, np.int64)  # deliveries per message
        if preexpanded is None:
            msg_idx, rows, opts_rows, rules, shared = router.expand_window(
                matched)
        else:
            msg_idx, rows, opts_rows = preexpanded
            rules, shared = [], []
        if rec is not None:
            rec.lap("expand")
        for i, rids in rules:
            rule_sink.append((msgs[i], rids))
        if shared:
            # one live member per (msg, filter, group), appended AFTER
            # the direct deliveries: the stable sort below keeps direct
            # entries ahead of shared ones for equal keys, and one K3
            # launch decides both
            s_msg: List[int] = []
            s_rows: List[int] = []
            s_opts: List[int] = []
            for i, real, group in shared:
                self._shared_pick(msgs[i], i, real, group,
                                  s_msg, s_rows, s_opts)
            if s_rows:
                msg_idx = np.concatenate(
                    [msg_idx, np.asarray(s_msg, dtype=np.int64)])
                rows = np.concatenate(
                    [rows, np.asarray(s_rows, dtype=np.int64)])
                opts_rows = np.concatenate(
                    [opts_rows, np.asarray(s_opts, dtype=np.int64)])
        mloc: Counter = Counter()
        corked: List = []
        n_clients = 0
        assemble_s = 0.0
        # one registry probe a window: without a message.delivered hook
        # or a window sink no run builds its (msg, opts) list
        deliver_hook = self.hooks.has("message.delivered")
        delivered_runs: Optional[List] = (
            [] if self.delivered_batch_sinks else None)
        # one clock read a window; runs are scanned for slow deliveries
        # only when the window's oldest publish is past the threshold
        now_w = time.time()
        floor = now_w - self.slow_subs.threshold_ms / 1000.0
        ts_min = 0.0 if replay else min(
            (m.timestamp for m in msgs if m.timestamp), default=0.0)
        slow_floor = floor if ts_min and ts_min < floor else None
        try:
            if len(rows):
                if preexpanded is None:
                    order = np.lexsort((msg_idx, rows))
                    sra, sm_a, so_a = (
                        rows[order], msg_idx[order], opts_rows[order])
                else:
                    sra, sm_a, so_a = rows, msg_idx, opts_rows
                m_qos = np.fromiter((m.qos for m in msgs), np.int8, n)
                m_retain = np.fromiter((m.retain for m in msgs), bool, n)
                m_from = np.fromiter(
                    (self._from_row(m) for m in msgs), np.int32, n
                )
                packed = router.engine.decide_window(
                    router.opts_columns(), router.opts_rev,
                    so_a, sra, sm_a, m_qos, m_retain, m_from,
                )
                if rec is not None:
                    rec.lap("decide")
                dec = _Decided(packed, sm_a, so_a)
                cuts = np.flatnonzero(sra[1:] != sra[:-1]) + 1
                bounds = [0, *cuts.tolist(), len(sra)]
                enc = C.DispatchEncoder()
                # the window's splice plan: (body, pid, channel, counts
                # by QoS, k, e) of every run the native path took
                plan: Optional[List] = [] if self.native else None
                for k, e in zip(bounds[:-1], bounds[1:]):
                    clientid = router.client_of_row(int(sra[k]))
                    n_clients += 1
                    try:
                        kept = self._deliver_run(
                            clientid, msgs, k, e, dec, enc, mloc, corked,
                            plan, deliver_hook, now_w, slow_floor,
                            delivered_runs,
                        )
                    except Exception:
                        log.exception("dispatch to %s failed", clientid)
                        mloc["messages.publish.error"] += 1
                        continue
                    if kept is not None:  # planned runs count once spliced
                        np.add.at(cnt, sm_a[k:e], kept)
                if plan:
                    t0 = time.perf_counter()
                    try:
                        self._assemble_window(plan, enc)
                    finally:
                        assemble_s = time.perf_counter() - t0
                    for *_, k, e in plan:
                        np.add.at(cnt, sm_a[k:e], 1)
            if rec is not None:
                rec.lap("deliver")
                if assemble_s:
                    # the native splice's share of deliver
                    rec.sub("assemble", assemble_s)
        finally:
            # one concatenated write per connection for the whole window
            for ch in corked:
                ch.uncork()
        if delivered_runs:
            # one call a window a sink, after the flush: the wire never
            # waits on it
            for sink in self.delivered_batch_sinks:
                try:
                    sink(delivered_runs)
                except Exception:
                    log.exception("delivered batch sink failed")
        counts = cnt.tolist()
        delivered = sum(counts)
        if delivered:
            mloc["messages.delivered"] += delivered
        if rec is not None:
            rec.lap("flush")
            rec.n_deliveries = delivered
            rec.n_clients = n_clients
            if delivered and not replay:
                # publish -> delivery latency of each delivered message
                now = time.time()
                rec.e2e_ms.extend(
                    (now - m.timestamp) * 1e3
                    for m, c in zip(msgs, counts) if c and m.timestamp)
        touched = np.zeros(n, bool)
        touched[msg_idx] = True
        # a backlog entry filtered at window build was not a dropped
        # publish: replay windows count no "no subscribers"
        none = [] if replay else np.flatnonzero(~touched).tolist()
        if none:
            mloc["messages.dropped"] += len(none)
            mloc["messages.dropped.no_subscribers"] += len(none)
            if self.hooks.has("message.dropped"):
                for i in none:
                    self.hooks.run("message.dropped", msgs[i],
                                   "no_subscribers")
        self.metrics.inc_bulk(mloc)
        return counts

    def _shared_pick(
        self, msg: Message, msg_i: int, real: str, group: str,
        s_msg: List[int], s_rows: List[int], s_opts_rows: List[int],
    ) -> None:
        """Pick one live group member, skipping members whose session
        is gone (redispatch, emqx_shared_sub.erl:144-166), and append
        the pick to the window's shared delivery columns: the member's
        row and its subscription's opts-table slot.  With durable
        storage on, DETACHED persistent members are skipped too: their
        share of the group's traffic arrives by stream-assigned replay
        (durable shared subscriptions), and queueing it here as well
        would deliver the offline interval twice."""
        router = self.router
        tried: Set[str] = set()
        while True:
            picked = router.shared.pick(group, real, msg, exclude=tried)
            if picked is None:
                return
            session = self.cm.lookup(picked)
            if session is not None and (
                self.durable is None
                or self.cm.channel(picked) is not None
                or session.expiry_interval <= 0
            ):
                # a member's row and slot live as long as its membership
                s_msg.append(msg_i)
                s_rows.append(router.row_of_client(picked))
                s_opts_rows.append(router.shared_slot_of(real, group,
                                                         picked))
                return
            tried.add(picked)

    def _assemble_window(self, plan, enc: "C.DispatchEncoder") -> None:
        """Splice every planned run's wire in ONE native call
        (`ops.dispatchasm.assemble_window`), then hand each connection
        its slice of the buffer as one corked blob.  A run whose bytes
        would not land at their planned offset raises, and no run's
        bytes ship: a shifted buffer would put one client's frames in
        another's stream."""
        nruns = len(plan)
        body = np.concatenate([p[0] for p in plan])
        pid = np.concatenate([p[1] for p in plan])
        run_start = np.zeros(nruns, np.int64)
        np.cumsum([len(p[0]) for p in plan][:-1], out=run_start[1:])
        _ho, hl, _to, tl = enc.span_arrays()
        sizes = np.add.reduceat(hl[body] + tl[body] + 2 * (pid >= 0),
                                run_start)
        run_out = np.zeros(nruns, np.int64)
        np.cumsum(sizes[:-1], out=run_out[1:])
        total = int(sizes.sum())
        out = bytearray(total)
        wrote = dispatchasm.assemble_window(
            enc.native_views(), body, pid, run_start, run_out, out)
        if wrote != total:
            raise RuntimeError(
                f"native window assembly wrote {wrote} of {total} bytes "
                f"across {nruns} runs")
        mv = memoryview(out)
        for (_b, _p, channel, npub, _k, _e), o, ln in zip(
                plan, run_out.tolist(), sizes.tolist()):
            channel.send_wire(mv[o:o + ln], npub)

    def _from_row(self, msg: Message) -> int:
        r = (
            self.router.row_of_client(msg.from_client)
            if msg.from_client else None
        )
        return -1 if r is None else r

    def _deliver_run(
        self, clientid: str, msgs, k: int, e: int, dec: "_Decided",
        enc: "C.DispatchEncoder", mloc: Counter, corked: List,
        plan: Optional[List], deliver_hook: bool, now: float,
        slow_floor: Optional[float], delivered_runs: Optional[List] = None,
    ):
        """Deliver one client's slice ``[k, e)`` of the window from its
        decided columns.  Returns the 0/1 count per delivery (an array),
        1 when every delivery counts, or None when the run joined the
        native splice ``plan`` (it counts once the splice succeeds).  A
        connected run then feeds the ``message.delivered`` hook (only
        when ``deliver_hook``), joins ``delivered_runs`` (when the
        window has sinks) and, past ``slow_floor``, `SlowSubs`."""
        nd = e - k
        session = self.cm.lookup(clientid)
        if session is None:
            mloc["delivery.dropped"] += nd
            return np.zeros(nd, np.int64)
        eff = dec.qmax if session.upgrade_qos else dec.qmin
        channel = self.cm.channel(clientid)
        if channel is None:
            return self._queue_detached_run(
                session, clientid, dec.decided(msgs, self.router, eff, k, e),
                dec.drop[k:e], mloc)
        if self._stalled(session, channel):
            # past the outbound watermark: the queue path keeps the
            # subscriber's wire buffer bounded, and the run never joins
            # the splice plan
            return self._queue_stalled_run(
                session, clientid, dec.decided(msgs, self.router, eff, k, e),
                dec.drop[k:e], mloc)
        channel.cork()
        corked.append(channel)
        kept = 1
        run = None
        if plan is not None and not dec.subid[k:e].any():
            run = session.deliver_run_native(
                msgs, dec.sm[k:e], eff[k:e], dec.retain[k:e],
                dec.drop[k:e], enc, channel.version)
        if run is not None:
            body, pid, npub = run
            if len(body):  # else every delivery dropped: no wire
                plan.append((body, pid, channel, npub, k, e))
                kept = None
        else:
            channel.send_packets(session.deliver_decided(
                dec.decided(msgs, self.router, eff, k, e), encoder=enc,
                version=channel.version,
            ))
        if deliver_hook or delivered_runs is not None:
            deliveries = self._materialize_run(msgs, dec, k, e)
            if deliver_hook:
                self.hooks.run("message.delivered", clientid, deliveries)
            if delivered_runs is not None:
                delivered_runs.append((clientid, deliveries))
        if slow_floor is not None:
            self._slow_scan_run(clientid, map(msgs.__getitem__,
                                              dec.sm[k:e].tolist()),
                                now, slow_floor)
        return kept

    def _materialize_run(self, msgs, dec: "_Decided", k: int, e: int):
        """One connected run's ``[(msg, opts)]`` list, every delivery of
        ``[k, e)`` (no-local drops included), for the
        ``message.delivered`` hook: built only when one is registered."""
        opts_at = self.router.opts_at
        return [(msgs[i], opts_at(o)) for i, o in zip(
            dec.sm[k:e].tolist(), dec.so[k:e].tolist())]

    def _slow_scan_run(self, clientid: str, run_msgs, now: float,
                       floor: float) -> None:
        """Record the run's deliveries published before ``floor``."""
        slow = self.slow_subs
        for m in run_msgs:
            if m.timestamp and m.timestamp < floor:
                slow.record(clientid, m.topic, (now - m.timestamp) * 1e3)

    def _stalled(self, session: Session, channel) -> bool:
        """Is this connected channel past its outbound watermark, or
        still draining a backlog the watermark parked?"""
        out_wm = self.config.mqtt.outbound_high_watermark
        if not out_wm:
            return False
        ob = getattr(channel, "out_buffered", None)
        return ob is not None and (session.out_parked or ob() >= out_wm)

    def _queue_stalled_run(
        self, session: Session, clientid: str, decided, drop: np.ndarray,
        mloc: Counter,
    ) -> np.ndarray:
        """A stalled subscriber's run: QoS 0 dropped (counted
        ``delivery.dropped.out_buffer``), QoS>0 parked on the mqueue
        with ``out_parked`` set, so later deliveries queue behind it
        until `Channel.retry_deliveries` drains it."""
        kept = self._queue_detached_run(session, clientid, decided, drop,
                                        mloc, q0_reason="out_buffer")
        if kept.any():
            session.out_parked = True
        return kept

    def _queue_detached_run(
        self, session: Session, clientid: str, decided, drop: np.ndarray,
        mloc: Counter, q0_reason: Optional[str] = None,
    ) -> np.ndarray:
        """Queue a DETACHED persistent session's run: QoS>0 queued (the
        effective QoS and subscription options baked into the queued
        copy), QoS0 dropped (also counted under
        ``delivery.dropped.<q0_reason>`` when given)."""
        kept = np.zeros(len(drop), np.int64)
        slots = np.flatnonzero(~drop).tolist()
        for t, (m, opts, qos, _retain) in zip(slots, decided):
            if qos == 0:
                mloc["delivery.dropped"] += 1
                if q0_reason is not None:
                    mloc["delivery.dropped." + q0_reason] += 1
                continue
            dropped = session.mqueue.insert(session._queued(m, opts, qos))
            if dropped is not None:
                mloc["delivery.dropped.queue_full"] += 1
                self.hooks.run("delivery.dropped", clientid, dropped,
                               "queue_full")
            kept[t] = 1
        return kept

    def shutdown(self) -> None:
        """Drop held wills, flush and close the durable store."""
        self._pending_wills.clear()
        if self.durable is not None:
            self.durable.close()

    # ------------------------------------------------ ds durability

    def _on_loop(self, fn) -> None:
        """Run ``fn`` on the server's event loop when one is live (the
        store's callbacks may fire on its census-rebuild thread), else
        inline (a loop-less broker)."""
        loop = self._loop
        if loop is not None and not loop.is_closed():
            try:
                loop.call_soon_threadsafe(fn)
                return
            except RuntimeError:
                pass
        fn()

    def _ds_corruption(self, evt: Dict) -> None:
        """Detected corruption (a quarantined log suffix, an unreadable
        sidecar): a counter and an alarm.  The store already recovered
        conservatively; this is the never-silent half."""
        kind = evt.get("kind", "meta")
        if kind == "storage":
            self.metrics.inc(
                "ds.storage.corrupt_records", int(evt.get("records", 1)))
            name = "ds_storage_corruption"
            msg = "dslog quarantined unreadable records"
        else:
            self.metrics.inc("ds.meta.corruption")
            name = "ds_meta_corruption"
            msg = ("DS metadata sidecar unreadable; recovered "
                   "conservatively (at-least-once)")
        self._on_loop(lambda: self.alarms.activate(
            name, details=dict(evt), message=msg))

    def _ds_rebuild(self, evt: Dict) -> None:
        """Census rebuild: the alarm is up while a background rebuild
        runs (reads serve correct-but-wider from the log), cleared when
        the scan lands; an aborted rebuild leaves it up."""
        event = evt.get("event")
        if event == "start":
            self.metrics.inc("ds.meta.rebuild")
            self._on_loop(lambda: self.alarms.activate(
                "ds_meta_rebuild", details=dict(evt),
                message=("DS census rebuilding in background; "
                         "reads serve unpruned from the log")))
        elif event == "done":
            self._on_loop(
                lambda: self.alarms.deactivate("ds_meta_rebuild"))

    def _ds_synced(self, dur_s: float) -> None:
        self.metrics.inc("ds.sync.count")
        self.profiler.stage("ds_sync", dur_s)

    def _ds_sync_error(self, exc: BaseException) -> None:
        self.metrics.inc("ds.sync.errors")

    # ------------------------------------------- management surface

    def node_info(self) -> Dict:
        """This node's row for ``GET /api/v5/nodes``: node, uptime,
        connections, status, with durable storage the resume queue and
        the durability surface, and once sinks exist the egress roll-up.
        The JAX package's olp, flight and multicore rows come with their
        modules (ROADMAP.md section 1)."""
        node: Dict = {
            "node": self.config.node_name,
            "uptime": int(time.time() - self.metrics.start_time),
            "connections": len(self.cm),
            "node_status": "running",
        }
        if self.resume is not None:
            # resume-queue depth (mass-reconnect admission control)
            node["resume"] = self.resume.info()
        if self.durable is not None:
            # fsync mode, group-commit counters, unsynced and parked
            # backlog, corruption
            node["durability"] = self.durable.sync_stats()
        egress = self.resources.summary()
        if egress["sinks"]:
            # buffered depth, batch count, breaker state at a glance
            node["egress"] = egress
        return node

    def apply_config(self, path: str, value) -> None:
        """Apply one dotted-path update to the live config tree (the
        emqx_config_handler runtime-update role), coercing the value to
        the existing leaf's type, then run the ``config.updated`` hook.
        Raises ValueError for an unknown path segment and for a path
        under `config.NOT_PORTED`, as a config file does."""
        from ..config import NOT_PORTED, _not_ported

        parts = path.split(".")
        for k in range(1, len(parts) + 1):
            if ".".join(parts[:k]) in NOT_PORTED:
                raise _not_ported(".".join(parts[:k]))
        obj = self.config
        for part in parts[:-1]:
            if isinstance(obj, dict):
                if part not in obj:
                    raise ValueError(f"unknown config key: {path}")
                obj = obj[part]
            else:
                if not hasattr(obj, part):
                    raise ValueError(f"unknown config key: {path}")
                obj = getattr(obj, part)
        leaf = parts[-1]
        if isinstance(obj, dict):
            obj[leaf] = value
        else:
            if not hasattr(obj, leaf):
                raise ValueError(f"unknown config key: {path}")
            old = getattr(obj, leaf)
            # coerce to the existing leaf's type (JSON loses int/float)
            if old is not None and not isinstance(value, type(old)):
                value = type(old)(value)
            setattr(obj, leaf, value)
        self.hooks.run("config.updated", path, value)

    def info(self) -> Dict[str, object]:
        return {
            "connections": len(self.cm),
            "subscriptions": self.router.subscription_count(),
            "retained": len(self.retainer),
            "metrics": self.metrics.all(),
        }


def merge_counts(results: List[Optional[int]],
                 counts: Sequence[int]) -> List[int]:
    """A window's delivery count per input message: ``results`` from
    `Broker.publish_prepare`, each None (a message that went on to the
    match) filled with the next of ``counts``, dispatch's counts for
    those messages in order."""
    it = iter(counts)
    return [next(it) if r is None else r for r in results]


class _Decided:
    """One window's decision columns, unpacked from the decide kernel's
    packed byte per delivery, beside the sorted message and options
    columns."""

    __slots__ = ("sm", "so", "qmin", "qmax", "drop", "retain", "subid")

    def __init__(self, packed: np.ndarray, sm: np.ndarray,
                 so: np.ndarray) -> None:
        self.sm, self.so = sm, so
        self.qmin = (packed & 3).astype(np.int64)
        self.qmax = ((packed >> DEC_QMAX_SHIFT) & 3).astype(np.int64)
        self.drop = (packed & DEC_DROP_BIT) != 0
        self.retain = (packed & DEC_RETAIN_BIT) != 0
        self.subid = (packed & DEC_SUBID_BIT) != 0

    def decided(self, msgs, router, eff: np.ndarray, k: int, e: int):
        """The run's kept deliveries as ``(msg, opts, effective_qos,
        retain)`` entries, for `Session.deliver_decided`."""
        opts_at = router.opts_at
        return [
            (msgs[i], opts_at(o), q, r)
            for i, o, q, r, d in zip(
                self.sm[k:e].tolist(), self.so[k:e].tolist(),
                eff[k:e].tolist(), self.retain[k:e].tolist(),
                self.drop[k:e].tolist())
            if not d
        ]


class PublishBatcher:
    """Micro-batching front of `Broker.publish_many`: producers enqueue,
    a collector closes a window every ``window`` seconds or
    `_window_limit` messages (at once when the broker is idle) and
    launches its match in an executor thread, keeping up to
    ``pipeline_windows`` windows in flight; the dispatch loop delivers
    them strictly in window order on the event loop and resolves the
    publishers' futures (their PUBACK/PUBREC).

    Queueing is per source (each channel passes ``source=self``; wills
    and housekeeping releases share the ``None`` lane), and the
    collector takes the lanes round-robin: a flooding connection fills
    its own lane and is read-paused at its own watermark, while a light
    client's publish rides the next window."""

    def __init__(
        self,
        broker: Broker,
        window: float = 0.001,
        batch_max: int = 4096,
        pipeline_windows: int = 4,
    ) -> None:
        self.broker = broker
        self.window = window
        self.batch_max = batch_max
        self.pipeline_windows = max(pipeline_windows, 1)
        # per-source lanes and their round-robin order
        self._queues: Dict[object, deque] = {}
        self._rr: deque = deque()
        self._total = 0
        self._arrival = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._dispatch_task: Optional[asyncio.Task] = None
        # messages popped from the lanes but not yet dispatched (the
        # collector's batch and the pipelined windows), bounded: four
        # windows of `_window_limit` keep the pipeline deep enough to
        # hide the device round trip, and more is queueing delay
        self._inflight_count = 0
        self.inflight_max = max(batch_max // 2, 512)
        self._inflight_drain = asyncio.Event()
        # a source's reads pause above ITS lane's high watermark, or,
        # once the total crosses the global bound, above its fair share
        # of it; they resume below the matching low marks
        self.high_watermark = batch_max
        self.low_watermark = batch_max // 4
        self.global_high = batch_max * 2
        self._uncongested = asyncio.Event()
        self._uncongested.set()
        self._source_waits: Dict[object, asyncio.Event] = {}

    def depth(self) -> int:
        return self._total + self._inflight_count

    def _lane_depth(self, source: object = None) -> int:
        q = self._queues.get(source)
        return len(q) if q is not None else 0

    def _fair_share(self) -> int:
        return max(32, self.global_high // max(len(self._queues), 1))

    def congested(self, source: object = None) -> bool:
        lane = self._lane_depth(source)
        if lane >= self.high_watermark or (
            self._total >= self.global_high
            and lane >= self._fair_share()
        ):
            # a no-op while active; an operator-cleared alarm comes back
            # while the congestion lasts
            self.broker.alarms.activate(
                "publish_queue_congested",
                details={"depth": self.depth()},
                message="publish micro-batch queue above high watermark",
            )
            ev = self._source_waits.get(source)
            if ev is None:
                ev = self._source_waits[source] = asyncio.Event()
            ev.clear()
            self._uncongested.clear()
            return True
        return False

    async def wait_uncongested(self, source: object = None) -> None:
        ev = self._source_waits.get(source)
        if ev is not None:
            await ev.wait()
        else:
            await self._uncongested.wait()

    def _maybe_release(self) -> None:
        """Wake paused sources whose lanes drained to half their fair
        share (or whose pressure cleared); clear the alarm once the
        total is down to the low watermark."""
        if self._source_waits:
            share = self._fair_share()
            for source, ev in list(self._source_waits.items()):
                lane = self._lane_depth(source)
                if not ev.is_set() and lane < self.high_watermark and (
                    self._total < self.global_high // 2
                    or lane <= share // 2
                ):
                    ev.set()
                if lane == 0:
                    del self._source_waits[source]
        if not self._uncongested.is_set() and (
            self._total <= self.low_watermark
        ):
            self._uncongested.set()
            self.broker.alarms.deactivate("publish_queue_congested")

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    def _enqueue(self, source: object, entry: tuple) -> None:
        q = self._queues.get(source)
        if q is None:
            q = self._queues[source] = deque()
            self._rr.append(source)
        q.append(entry)
        self._total += 1
        self._arrival.set()

    def _rr_pop(self) -> tuple:
        src = self._rr[0]
        q = self._queues[src]
        entry = q.popleft()
        self._total -= 1
        if q:
            self._rr.rotate(-1)  # the next source's turn
        else:
            self._rr.popleft()
            del self._queues[src]
        return entry

    def _window_limit(self) -> int:
        """The most messages one window collects: the pipeline-depth
        bound (512 at the default ``batch_max`` of 4,096)."""
        return min(self.batch_max, max(self.inflight_max // 4, 256))

    def publish(self, msg: Message,
                source: object = None) -> "asyncio.Future[int]":
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._enqueue(source, (msg, fut, source))
        return fut

    def publish_nowait(self, msg: Message, source: object = None) -> None:
        """Fire-and-forget enqueue (QoS 0)."""
        self._enqueue(source, (msg, None, source))

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        inflight: asyncio.Queue = asyncio.Queue(maxsize=self.pipeline_windows)
        self._dispatch_task = loop.create_task(self._dispatch_loop(inflight))
        try:
            while True:
                while self._total == 0:
                    self._arrival.clear()
                    await self._arrival.wait()
                while self._inflight_count >= self.inflight_max:
                    self._inflight_drain.clear()
                    await self._inflight_drain.wait()
                limit = self._window_limit()
                # the window's profiler record opens at collection
                # start, so the accumulation shows up as its own stage
                rec = self.broker.profiler.begin(0, source="batcher")
                batch = [self._rr_pop()]
                if self._total or self._inflight_count:
                    # busy: accumulate up to the window deadline
                    deadline = loop.time() + self.window
                    while len(batch) < limit:
                        if self._total:
                            batch.append(self._rr_pop())
                            continue
                        timeout = deadline - loop.time()
                        if timeout <= 0:
                            break
                        self._arrival.clear()
                        try:
                            await asyncio.wait_for(
                                self._arrival.wait(), timeout
                            )
                        except asyncio.TimeoutError:
                            break
                msgs = [m for m, _f, _s in batch]
                if rec is not None:
                    rec.n_msgs = len(batch)
                    rec.lap("batch_wait")
                self._inflight_count += len(batch)
                try:
                    # the publish fold and the retained store mutate
                    # broker state: loop thread, window order (an
                    # IO-backed publish hook awaits off the loop inside)
                    live, results = (
                        await self.broker.publish_prepare_async(msgs))
                    if rec is not None:
                        rec.lap("prepare")
                    match_fut = loop.run_in_executor(
                        None, self.broker.publish_match_submit, live, rec
                    )
                except Exception as exc:
                    self._inflight_count -= len(batch)
                    self._inflight_drain.set()
                    log.exception("publish window of %d failed in prepare",
                                  len(batch))
                    self._fail(batch, exc)
                    # a failed last window must still wake paused reads
                    self._maybe_release()
                    continue
                await inflight.put((batch, live, results, match_fut, rec))
        finally:
            self._dispatch_task.cancel()
            try:
                await self._dispatch_task
            except asyncio.CancelledError:
                pass
            exc = ConnectionError("broker stopping")
            while not inflight.empty():
                batch, _live, _res, match_fut, _rec = inflight.get_nowait()
                match_fut.cancel()
                self._fail(batch, exc)
            # entries still in the lanes were never collected
            for q in self._queues.values():
                self._fail(q, exc)
            self._queues.clear()
            self._rr.clear()
            self._total = 0
            self._inflight_count = 0

    @staticmethod
    def _fail(batch, exc: BaseException) -> None:
        for _m, fut, _s in batch:
            if fut is not None and not fut.done():
                fut.set_exception(exc)

    async def _dispatch_loop(self, inflight: asyncio.Queue) -> None:
        loop = asyncio.get_running_loop()
        while True:
            batch, live, results, match_fut, rec = await inflight.get()
            try:
                try:
                    handle = await match_fut
                    matched = await loop.run_in_executor(
                        None, self.broker.publish_match_finish, handle
                    )
                finally:
                    # leave the ledger on every path, or the depth never
                    # drains
                    self._inflight_count -= len(batch)
                    self._inflight_drain.set()
                counts = merge_counts(results, self.broker.publish_dispatch(
                    live, matched, rec))
                dur = self.broker.durable
                if (
                    dur is not None
                    and dur.fsync_mode == "always"
                    and dur.gate.dirty
                ):
                    # group-commit barrier: the window's acks park until
                    # the fsync covering its captures lands (one fsync a
                    # window, concurrent windows coalesced by the gate's
                    # worker).  A sync fault keeps them parked and
                    # retries: never an un-durable ack
                    await dur.wait_durable()
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                log.exception("publish window of %d failed", len(batch))
                self._fail(batch, exc)
                self._maybe_release()
                continue
            try:
                # cork each publisher's channel before resolving its
                # futures: the acks' callbacks run first (call_soon is
                # FIFO), then one write a connection flushes them
                corked: List = []
                seen: Set[int] = set()
                for _m, fut, src in batch:
                    if fut is None or src is None or id(src) in seen:
                        continue
                    seen.add(id(src))
                    src.cork()
                    corked.append(src)
                try:
                    for (_m, fut, _s), n in zip(batch, counts):
                        if fut is not None and not fut.done():
                            fut.set_result(n)
                finally:
                    if corked:
                        loop.call_soon(self._uncork_all, corked)
                self._maybe_release()
            except Exception:
                # the dispatcher must outlive a failing tail: a dead one
                # wedges every publish
                log.exception("publish window post-dispatch failed")

    @staticmethod
    def _uncork_all(channels: List) -> None:
        for ch in channels:
            try:
                ch.uncork()
            except Exception:
                log.exception("ack uncork failed")
