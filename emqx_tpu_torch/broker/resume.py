"""Resume admission control + windowed durable-session replay.

The mass-reconnect scheduler: after an outage, every persistent
session reconnects at once, each with a QoS1 backlog in durable
storage.  The naive shape — each CONNECT synchronously draining its
whole backlog on the event loop — is unbounded memory and event-loop
starvation exactly when the broker is busiest.  This module makes
outage recovery a first-class, bounded, crash-safe scenario
(emqx_persistent_session_ds resume + the reference's session
bootstrapping backpressure, recast for the windowed pipeline):

* **Admission control**: at most ``max_concurrent`` sessions replay
  at a time; reconnects beyond that park in a FIFO
  (CONNACK-then-drain: the client is connected and receives live
  traffic immediately, its backlog streams in when a slot frees);
  past ``park_queue_cap`` the broker answers CONNACK server-busy
  (`ResumeBusy`) so clients back off instead of piling state up.

* **Windowed replay**: each scheduler round batch-reads the active
  sessions' cursors through `DurableSessions.replay_chunk_many`
  (shared per-stream reads across coherently-positioned sessions),
  then dispatches ALL their backlogs as ONE window through the same
  pipeline live fan-out rides — the decide kernel on the card,
  encode-once `DispatchEncoder` slots, the native window splice —
  instead of per-message mqueue appends.  A round reads at
  most ``replay_byte_budget`` payload bytes, then yields the loop
  back to live traffic (the cooperative-yield contract the scalar
  resume loop lacked).

* **Crash safety**: a session's boot checkpoint — whose on-disk
  cursors still cover the whole offline interval — is discarded only
  at COMMIT (`_commit`, the ``session.resume.commit`` failpoint
  seam), after its last window is in the inflight/mqueue handoff.
  In-memory cursor advances are never persisted mid-replay (the
  `replay_chunk` docstring contract), so a broker death at ANY point
  before commit re-replays the full interval on restart: duplicates
  within at-least-once bounds, never QoS1 loss.  Disconnect
  mid-replay pauses the job and keeps the checkpoint; the next
  reconnect re-attaches and continues.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Set

import numpy as np

from .. import failpoints
from ..aio import cancel_and_wait

log = logging.getLogger("emqx_tpu_torch.broker.resume")

# seconds between forced event-loop yields while backlogs drain; one
# round reads <= replay_byte_budget bytes, so this bounds how long the
# loop can be held by replay work regardless of backlog depth
_ROUND_YIELD = 0.0
# retry backoff for a job whose read/commit faulted (doubles per
# consecutive failure, capped) — parked/faulted sessions self-drain
# when the fault clears
_BACKOFF_BASE = 0.05
_BACKOFF_CAP = 2.0


class ResumeBusy(Exception):
    """Resume admission is saturated (active slots full AND the park
    FIFO at ``park_queue_cap``): the CONNECT is refused with CONNACK
    server-busy so the client retries with backoff instead of the
    broker buffering yet another session's worth of state."""

    def __init__(self, clientid: str) -> None:
        super().__init__(f"resume admission saturated for {clientid}")
        self.clientid = clientid


class _Job:
    """One resuming session's replay progress."""

    __slots__ = ("clientid", "state", "session", "attempts",
                 "not_before", "windows", "replayed", "done_reading")

    def __init__(self, clientid: str, state, session) -> None:
        self.clientid = clientid
        self.state = state  # ds.persist.SessionState (live cursors)
        self.session = session
        self.attempts = 0  # consecutive read/commit failures
        self.not_before = 0.0  # backoff deadline
        self.windows = 0
        self.replayed = 0
        self.done_reading = False  # cursors exhausted, commit pending


class ResumeScheduler:
    """Bounded drain of resuming sessions' durable backlogs.

    Driven by an async task (`run`) under a live server, or manually
    (`drain_once`) by tests/benches — `drain_once` is synchronous and
    deterministic, which is what lets the windowed wire be
    property-tested byte-identical against the scalar referee."""

    def __init__(self, broker, cfg) -> None:
        self.broker = broker
        self.cfg = cfg
        # True while the server's drive task runs: open_session routes
        # restores through the scheduler instead of the synchronous
        # scalar loop (tests without a loop keep the legacy shape)
        self.running = False
        self._active: Dict[str, _Job] = {}
        self._parked: Deque[_Job] = deque()
        self._parked_ids: Set[str] = set()
        # disconnected mid-replay: slot released, checkpoint kept, job
        # continues when the client re-attaches
        self._paused: Dict[str, _Job] = {}
        self._wake: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        # sessions whose replay committed (their checkpoint discarded)
        self.committed = 0
        # the fault that ended the drive task (a failed kernel launch):
        # a replay owed after it raises this instead of waiting on a
        # scheduler nobody drives
        self.error: Optional[BaseException] = None

    # ------------------------------------------------------ lifecycle

    async def start(self) -> None:
        if self._task is None:
            self._wake = asyncio.Event()
            self._task = asyncio.get_running_loop().create_task(
                self.run()
            )
            self.running = True

    async def stop(self) -> None:
        # the running/_task pair transitions BEFORE the await: a
        # start() scheduled while cancel_and_wait is parked must see
        # the stopped state (running False, no task), not a torn
        # running=False with a still-registered task it then leaks
        self.running = False
        task, self._task = self._task, None
        if task is not None:
            await cancel_and_wait(task)
        # uncommitted jobs keep their boot checkpoints: a restart
        # replays their intervals from disk (at-least-once, no loss)

    # ------------------------------------------------------ admission

    def saturated(self) -> bool:
        return (
            len(self._active) >= int(self.cfg.max_concurrent)
            and len(self._parked) >= int(self.cfg.park_queue_cap)
        )

    def pending(self, clientid: str) -> bool:
        """Is a replay still owed to this client (active, parked, or
        paused)?  While True, the boot checkpoint must survive — its
        on-disk cursors are the crash-recovery story."""
        return (
            clientid in self._active
            or clientid in self._parked_ids
            or clientid in self._paused
        )

    def admit(self, clientid: str, state, session) -> str:
        """Admit a resuming session: ``"active"`` (replay slot held)
        or ``"parked"`` (FIFO, drains when a slot frees).  The caller
        has already rejected the saturated case via `ResumeBusy`."""
        job = self._paused.pop(clientid, None)
        if job is None or job.state is not state:
            # a paused job may only continue when the caller holds the
            # SAME state object (the live boot state whose already-read
            # prefix sits in the surviving session's mqueue/inflight).
            # In the normal flow `durable.load` returns exactly that
            # cached object; a different one means the checkpoint was
            # torn down and re-created under us — start over from it.
            # (The dead-session case is handled at the source: the
            # drain loop RESETS a job whose session vanished.)
            job = _Job(clientid, state, session)
        else:
            job.session = session  # channel moved; cursors continue
        verdict = self._place(job)
        self._kick()
        return verdict

    def reattach(self, clientid: str) -> bool:
        """A mid-replay session reconnected (its detached in-memory
        session took the new channel): move the paused job back into
        the queue and keep draining where it left off."""
        job = self._paused.pop(clientid, None)
        if job is None:
            return self.pending(clientid)
        self._place(job)
        self._kick()
        return True

    def _place(self, job: _Job) -> str:
        """Put a job into a free replay slot, else the park FIFO
        (counted) — the ONE home of the placement rule."""
        if len(self._active) < int(self.cfg.max_concurrent):
            self._active[job.clientid] = job
            return "active"
        self._parked.append(job)
        self._parked_ids.add(job.clientid)
        self.broker.metrics.inc("session.resume.parked")
        return "parked"

    def _take_parked(self, clientid: str) -> Optional[_Job]:
        """Remove and return a job from the park FIFO (linear scan —
        parking is the exceptional path)."""
        if clientid not in self._parked_ids:
            return None
        self._parked_ids.discard(clientid)
        # scan a snapshot: remove() under a live deque iterator only
        # avoids RuntimeError today because we return immediately —
        # don't leave that landmine for the next edit
        for j in list(self._parked):
            if j.clientid == clientid:
                self._parked.remove(j)
                return j
        return None

    def pause(self, clientid: str) -> None:
        """Channel lost mid-replay: release the slot but keep the job
        (and, at the broker level, the boot checkpoint) so the replay
        continues on reconnect — or from disk after a restart."""
        job = self._active.pop(clientid, None)
        if job is None:
            job = self._take_parked(clientid)
        if job is not None:
            self._paused[clientid] = job
            self._unpark()

    def refresh_checkpoint(self, clientid: str, session) -> None:
        """A mid-replay session disconnected: the boot checkpoint must
        keep its ORIGINAL disconnected_at and virgin cursors (they are
        the crash story for the un-replayed tail), but its SUBS must
        reflect changes the live window made — a filter subscribed (or
        dropped) while connected would otherwise vanish from (or
        resurrect in) the session a restart rebuilds, losing every
        QoS1 message the new filter gated into storage."""
        job = self._active.get(clientid) or self._paused.get(clientid)
        if job is None and clientid in self._parked_ids:
            job = next(
                (j for j in self._parked if j.clientid == clientid),
                None,
            )
        if job is None:
            return
        from .session import SubOpts

        current = {
            flt: opts.to_dict()
            for flt, opts in session.subscriptions.items()
        }
        # normalize: checkpoints may carry sparse opts dicts; a mere
        # serialization difference must not rewrite the file
        prior = {
            flt: SubOpts.from_dict(d).to_dict()
            for flt, d in job.state.subs.items()
        }
        if current == prior:
            return  # unchanged: the on-disk checkpoint already matches
        from ..ds.persist import SessionState

        self.broker.durable.save_state(SessionState(
            clientid=clientid,
            subs=current,
            expiry=session.expiry_interval,
            disconnected_at=job.state.disconnected_at,
            iters=None,  # full re-replay from the outage — never the
            # advanced in-memory cursors (their prefix is only in the
            # in-memory mqueue; persisting them would skip it)
        ))
        # the live continuation must see the same subs: a filter gone
        # from the session must stop replaying into it
        job.state.subs = current

    def cancel(self, clientid: str) -> None:
        """Session discarded (clean start, kick, expiry): drop the job
        outright — the checkpoint teardown is the caller's business."""
        self._active.pop(clientid, None)
        self._paused.pop(clientid, None)
        self._take_parked(clientid)
        self._unpark()

    def _unpark(self) -> None:
        while self._parked and (
            len(self._active) < int(self.cfg.max_concurrent)
        ):
            job = self._parked.popleft()
            self._parked_ids.discard(job.clientid)
            self._active[job.clientid] = job

    def _kick(self) -> None:
        if self._wake is not None:
            self._wake.set()

    # ---------------------------------------------------------- drive

    async def run(self) -> None:
        """Drive loop: drain one bounded round, yield the event loop,
        repeat; sleep on the wake event when nothing is owed.  The
        yield between rounds is the cooperative-scheduling contract —
        live publish windows interleave with replay windows instead of
        starving behind one giant backlog."""
        assert self._wake is not None
        backoff = 0.0
        while True:
            if not self._active and not self._parked:
                # clear-before-wait, and the emptiness check and the
                # clear are loop-atomic (no await between): a _kick()
                # either lands before the clear (we re-check via the
                # loop) or sets the event we are about to wait on —
                # no lost wakeup
                self._wake.clear()
                await self._wake.wait()
                continue
            try:
                progressed = self.drain_once()
            except Exception as exc:
                # launch-or-raise: the decide kernel has no host
                # fallback, so a failed launch (or any fault a round
                # does not expect) is not retried here.  The round put
                # its window's jobs back to their checkpoints; the
                # error ends the drive task, and `Broker.open_session`
                # raises it for every replay owed from now on
                self.error = exc
                self.broker.metrics.inc("session.resume.failed")
                log.exception("resume drain round failed; the resume "
                              "scheduler stops")
                raise
            if progressed:
                backoff = 0.0
                await asyncio.sleep(_ROUND_YIELD)
            else:
                # every job blocked (backoff after faults, channels
                # gone): idle briefly instead of spinning
                backoff = min(
                    max(backoff * 2, _BACKOFF_BASE), _BACKOFF_CAP
                )
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(), backoff)
                except asyncio.TimeoutError:
                    pass

    # ----------------------------------------------------- one round

    def drain_once(self) -> int:
        """One bounded replay round: promote parked jobs into free
        slots, batch-read every ready active job's next chunk
        (<= ``replay_byte_budget`` payload bytes total), dispatch ALL
        chunks as ONE window through the live pipeline, and commit
        jobs whose cursors are exhausted.  Returns the number of jobs
        that made progress (0 = nothing ready; the drive loop backs
        off).  Synchronous and deterministic: tests and the scalar/
        windowed A/B bench drive it directly."""
        self._unpark()
        if not self._active:
            return 0
        broker = self.broker
        cm = broker.cm
        now = time.time()
        ready: List[_Job] = []
        for job in list(self._active.values()):
            if cm.lookup(job.clientid) is None:
                # session vanished without a discard callback reaching
                # us (defensive): the already-read prefix lived only in
                # that session's mqueue and died with it, so RESET the
                # job to the checkpoint — the eventual reconnect
                # re-replays the full interval (at-least-once) instead
                # of continuing past messages nobody holds (loss)
                self._reset(job)
                self._active.pop(job.clientid, None)
                self._paused[job.clientid] = job
                continue
            if job.not_before > now:
                continue
            ready.append(job)
        if not ready:
            return 0
        progressed = 0
        commit_ready = [j for j in ready if j.done_reading]
        read_jobs = [j for j in ready if not j.done_reading]
        if read_jobs:
            progressed += self._drain_window(read_jobs)
        for job in commit_ready:
            if self._commit(job):
                progressed += 1
        return progressed

    def _drain_window(self, jobs: List[_Job]) -> int:
        """Read one chunk per job and dispatch the lot as one window.
        The per-client message ORDER is each job's own `replay_chunk`
        order, preserved through the (client-contiguous, unsorted)
        pre-expanded columns — which is what the bit-identity property
        test against the scalar referee leans on."""
        broker = self.broker
        cfg = self.cfg
        rec = broker.profiler.begin(0, source="replay")
        chunks, done, _nbytes, errors = (
            broker.durable.replay_chunk_many(
                [j.state for j in jobs],
                max_msgs=int(cfg.chunk_msgs),
                byte_budget=int(cfg.replay_byte_budget),
            )
        )
        if rec is not None:
            rec.lap("replay_read")
        now = time.time()
        progressed = 0
        windowed = bool(cfg.windowed)
        # window accumulators: unique messages + client-contiguous
        # delivery columns in per-client replay order
        msgs: List = []
        midx: Dict[int, int] = {}
        col_m: List[int] = []
        col_r: List[int] = []
        col_o: List[int] = []
        col_up: List[bool] = []
        dispatched: List[_Job] = []
        for job in jobs:
            cid = job.clientid
            err = errors.get(cid)
            chunk = chunks.get(cid)
            if chunk is None and err is None:
                continue  # byte budget: next round
            if err is not None or (not chunk and not done.get(cid)):
                # faulted or blocked read: back the session off before
                # the NEXT read — a persistent fault must not busy-spin
                # the drive loop.  A partial chunk that rode along with
                # the fault is still real progress and is dispatched
                # below (its dedup/cursor state is already committed;
                # dropping it would re-deliver it as duplicates at
                # best).
                job.attempts += 1
                job.not_before = now + min(
                    _BACKOFF_BASE * (2 ** job.attempts), _BACKOFF_CAP
                )
                if err is not None:
                    log.warning(
                        "replay read for %s failed (attempt %d): %s",
                        cid, job.attempts, err,
                    )
            else:
                job.attempts = 0
            if chunk or done.get(cid):
                progressed += 1
            if done.get(cid):
                job.done_reading = True
            if chunk:
                job.replayed += len(chunk)
                if windowed:
                    n0 = len(col_m)
                    self._append_run(job, chunk, msgs, midx,
                                     col_m, col_r, col_o, col_up)
                    if len(col_m) > n0:
                        dispatched.append(job)
                else:
                    # scalar referee mode: the per-session mqueue path
                    # (chunked + scheduler-paced, keeping the
                    # cooperative-yield contract the old inline resume
                    # loop broke)
                    self._queue_scalar(job, chunk)
        if windowed and col_m:
            try:
                self._dispatch(msgs, col_m, col_r, col_o, col_up, rec)
            except Exception:
                # the window's chunks were read but never delivered:
                # its jobs go back to their checkpoints before the error
                # propagates, so a later round re-replays their
                # intervals (at-least-once) instead of reading on past
                # messages nobody holds (loss)
                for job in dispatched:
                    self._reset(job)
                raise
            broker.metrics.inc("session.replay.windows")
            broker.metrics.inc("session.replay.messages", len(col_m))
            for job in dispatched:
                job.windows += 1
        # commit strictly AFTER the window is in the inflight/mqueue
        # handoff — the checkpoint-discipline half of the crash story
        for job in jobs:
            if job.done_reading and job.clientid in self._active:
                self._commit(job)
        if rec is not None:
            rec.n_msgs = len(msgs)
            broker.profiler.commit(rec)
        return progressed

    @staticmethod
    def _reset(job: _Job) -> None:
        """Rewind a job's in-memory read state to its boot checkpoint
        (whose on-disk cursors still cover the whole interval)."""
        job.state.iters = None
        job.state._replay_seen.clear()
        job.done_reading = False

    def _append_run(self, job: _Job, chunk, msgs, midx,
                    col_m, col_r, col_o, col_up) -> None:
        """Append one client's chunk to the window columns: resolve
        each (filter, message) to the client's interned router row +
        opts slot, applying the same admission filters the scalar
        referee applies (the subscription is still present).
        No-local drops and effective QoS ride the decision columns —
        the same vectorized pass live fan-out uses.

        Inflight-pressure discipline: the window path delivers runs
        straight to the wire, so a run the session cannot absorb WHOLE
        (pending QoS>0 count past the inflight room, or a non-empty
        mqueue from an earlier overflow) takes the mqueue path
        instead — `Session.deliver` would let effective-QoS0
        deliveries overtake the queued overflow, while the scalar
        referee's queue preserves total order; the fallback keeps the
        two paths bit-identical under pressure, and a session that
        acks keeps riding the fast path."""
        broker = self.broker
        router = broker.router
        cid = job.clientid
        session = job.session
        row = router.row_of_client(cid)
        if row is None:  # defensive: routes cleaned under us
            return
        slot_of = router.opts_slot_of
        upgrade = session.upgrade_qos
        ent_msgs: List = []
        ent_slots: List[int] = []
        # a chunk's entries overwhelmingly repeat one filter (the
        # replay walk emits per-filter runs), so the slot resolves
        # once per filter IDENTITY, not once per delivery
        last_flt: Optional[str] = None
        slot: Optional[int] = None
        for flt, msg in chunk:
            if flt is not last_flt:
                slot = slot_of(cid, flt)
                last_flt = flt
            if slot is None:
                continue  # unsubscribed since the checkpoint
            ent_msgs.append(msg)
            ent_slots.append(slot)
        ne = len(ent_msgs)
        if not ne:
            return
        # pending (effective QoS > 0, not no-local-dropped) count for
        # the absorption gate — vectorized over the router's attribute
        # columns, never a per-delivery Python opts read
        oa_qos, oa_nl, _rap, _sid = router.opts_columns()
        slots_arr = np.asarray(ent_slots, dtype=np.int64)
        mqv = np.fromiter(
            (m.qos for m in ent_msgs), np.int8, ne
        ).astype(np.int64)
        oq = oa_qos[slots_arr].astype(np.int64)
        eff = np.maximum(mqv, oq) if upgrade else np.minimum(mqv, oq)
        pend = eff > 0
        nlv = oa_nl[slots_arr]
        if nlv.any():
            selfpub = np.fromiter(
                (m.from_client == cid for m in ent_msgs), bool, ne
            )
            pend &= ~(nlv & selfpub)
        kq = int(pend.sum())
        if len(session.mqueue) or not session.inflight.room_for(kq):
            self._queue_scalar(job, chunk)
            return
        for msg, slot in zip(ent_msgs, ent_slots):
            mi = midx.get(id(msg))
            if mi is None:
                mi = midx[id(msg)] = len(msgs)
                msgs.append(msg)
            col_m.append(mi)
            col_r.append(row)
            col_o.append(slot)
            col_up.append(upgrade)

    def _dispatch(self, msgs, col_m, col_r, col_o, col_up, rec) -> int:
        """Dispatch the assembled replay window through the live
        pipeline (`Broker._dispatch_window` with pre-expanded,
        client-contiguous columns): one decide kernel launch, encode-
        once slots, one native splice, per-connection corked writes —
        overflow past each session's inflight window queues in its
        mqueue exactly as live fan-out does."""
        broker = self.broker
        mi = np.asarray(col_m, dtype=np.int64)
        rows = np.asarray(col_r, dtype=np.int64)
        orows = np.asarray(col_o, dtype=np.int64)
        if not broker.config.mqtt.mqueue_store_qos0:
            # scalar-referee parity: a replayed delivery whose
            # EFFECTIVE QoS is 0 is dropped when the mqueue would not
            # store QoS0 (the resume path's store gate) — vectorized
            # over the opts columns, never a per-delivery Python read
            oa_qos = broker.router.opts_columns()[0]
            m_qos = np.fromiter(
                (m.qos for m in msgs), np.int8, len(msgs)
            ).astype(np.int64)
            mq = m_qos[mi]
            oq = oa_qos[orows].astype(np.int64)
            up = np.asarray(col_up, dtype=bool)
            eff = np.where(up, np.maximum(mq, oq), np.minimum(mq, oq))
            keep = eff > 0
            if not keep.all():
                mi, rows, orows = mi[keep], rows[keep], orows[keep]
                if not len(mi):
                    return 0
        # no rule runs on a replayed message: the rule sink is dropped
        counts = broker._dispatch_window(
            msgs, None, [], rec,
            preexpanded=(mi, rows, orows), replay=True,
        )
        return sum(counts)

    def _queue_scalar(self, job: _Job, chunk) -> None:
        """The scalar referee's delivery half for one chunk: bake the
        messages into the session's mqueue (`Broker._resume_enqueue`,
        the loop the legacy in-line resume ran), then drain the send
        window to the live channel — post-CONNACK the channel's
        `session.resume()` has already run, so nothing else would ever
        flush the queue (acks only drain what was already sent)."""
        broker = self.broker
        session = job.session
        broker._resume_enqueue(session, chunk)
        channel = broker.cm.channel(job.clientid)
        if channel is not None:
            packets = session._dequeue()
            if packets:
                channel.send_packets(packets)

    # --------------------------------------------------------- commit

    def _commit(self, job: _Job) -> bool:
        """Resume-commit boundary (failpoint seam
        ``session.resume.commit``): the session's whole interval is in
        the inflight/mqueue handoff, so the boot checkpoint — the
        crash-recovery cursor set — may now be discarded.  A fault
        here keeps the checkpoint and retries (duplicates on a crash
        are at-least-once; losing the checkpoint early would be
        loss)."""
        broker = self.broker
        cid = job.clientid
        try:
            act = failpoints.evaluate(
                "session.resume.commit", key=cid
            )
            if act == "drop":
                raise failpoints.FailpointError(
                    "session.resume.commit dropped"
                )
        except failpoints.FailpointPanic:
            raise  # process-death stand-in: never absorbed
        except Exception as exc:
            job.attempts += 1
            job.not_before = time.time() + min(
                _BACKOFF_BASE * (2 ** job.attempts), _BACKOFF_CAP
            )
            log.warning("resume commit for %s failed (attempt %d): %r",
                        cid, job.attempts, exc)
            return False
        broker.durable.discard(cid)
        self._active.pop(cid, None)
        self._unpark()
        self._kick()
        self.committed += 1
        broker.metrics.inc("session.resumed")
        broker.hooks.run("session.resumed", cid)
        return True

    # ---------------------------------------------------------- info

    def info(self) -> Dict[str, object]:
        """Operator surface (REST ``/api/v5/nodes``, ``ctl status``):
        queue depths + drain totals."""
        return {
            "active": len(self._active),
            "parked": len(self._parked),
            "paused": len(self._paused),
            "windowed": bool(self.cfg.windowed),
            "max_concurrent": int(self.cfg.max_concurrent),
            "park_queue_cap": int(self.cfg.park_queue_cap),
            "replay_byte_budget": int(self.cfg.replay_byte_budget),
        }
