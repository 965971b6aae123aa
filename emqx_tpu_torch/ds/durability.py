"""Group-commit fsync gate: the "acked means durable" machinery.

EMQX's durable sessions get crash safety from RocksDB's WAL + ra raft
commit; our dslog engine appends without fsync on the hot path, so
before this gate an acked QoS1 publish could evaporate at power fail.
The naive fix — fsync per message — costs a disk round trip (~3-4 ms
on commodity ext4) per publish.  The house answer is the same shape as
every other hot-path cost in this repo: batch it onto the dispatch
window.  `SyncGate` amortizes ONE fsync per window, coalescing
concurrent windows onto the same disk flush:

  * every persisted append advances the ``appended`` watermark;
  * a window whose PUBACKs must imply durability parks on
    `wait_durable` — the gate snapshots the watermark, runs ONE
    ``dslog_sync`` in an executor, and releases every parked window
    whose appends that flush covered (windows that arrive while a
    flush is in flight simply ride the next one: two disk flushes
    bound ANY number of concurrent windows);
  * a sync fault (disk error, `ds.store.sync` chaos) keeps the parked
    windows parked and retries with backoff — PUBACKs are delayed,
    never issued un-durably and never dropped;
  * `sync_now` is the synchronous entry for the loop-less paths (the
    non-batched publish path, the broker tick's interval flush,
    shutdown).

The gate is mode-agnostic: `DurableSessions` always owns one (the
watermarks feed the ``ds.unsynced`` gauge in every mode); only the
``always`` fsync mode parks acks on it.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Callable, List, Optional, Tuple

_RETRY_BASE = 0.05
_RETRY_MAX = 1.0


class SyncGate:
    def __init__(
        self,
        sync_fn: Callable[[], None],
        on_sync: Optional[Callable[[float], None]] = None,
        on_error: Optional[Callable[[BaseException], None]] = None,
    ) -> None:
        self._sync_fn = sync_fn
        # fired with the flush duration (seconds) after every
        # successful sync — the broker wires ds.sync.count + the
        # profiler's ds_sync stage here
        self.on_sync = on_sync
        self.on_error = on_error
        self._lock = threading.Lock()
        self._appended = 0  # records persisted (watermark)
        self._synced = 0    # watermark covered by a completed fsync
        self._waiters: List[Tuple[int, "asyncio.Future"]] = []
        self._task: Optional["asyncio.Task"] = None
        self.sync_count = 0
        self.sync_errors = 0
        self._closed = False

    # ------------------------------------------------------ watermarks

    def mark_appended(self, n: int) -> int:
        """Record ``n`` appended records; returns the new watermark."""
        with self._lock:
            self._appended += n
            return self._appended

    @property
    def appended(self) -> int:
        """The append watermark (callers snapshot it around a window
        to ask "did THIS window capture anything?")."""
        return self._appended

    @property
    def dirty(self) -> bool:
        """Records appended that no completed fsync covers yet."""
        return self._appended > self._synced

    @property
    def unsynced(self) -> int:
        return max(0, self._appended - self._synced)

    @property
    def parked(self) -> int:
        """Windows currently parked on `wait_durable` (their acks are
        owed to publishers but held for the covering flush)."""
        return len(self._waiters)

    def stats(self) -> dict:
        with self._lock:
            return {
                "sync_count": self.sync_count,
                "sync_errors": self.sync_errors,
                "unsynced": max(0, self._appended - self._synced),
                "parked": len(self._waiters),
            }

    # ----------------------------------------------------- sync paths

    def sync_now(self) -> None:
        """Blocking group flush: everything appended so far is durable
        when this returns.  Thread-safe against the async worker (the
        underlying fsync serializes on the store's own mutex)."""
        with self._lock:
            target = self._appended
            if target <= self._synced:
                return
        t0 = time.perf_counter()
        try:
            self._sync_fn()
        except Exception:
            with self._lock:
                self.sync_errors += 1
            raise
        self._finish(target, time.perf_counter() - t0)

    def sync_soon(self) -> None:
        """Kick an asynchronous flush if anything is unsynced: the
        broker tick's interval-mode entry.  Falls back to the blocking
        flush when no event loop is running (tests driving tick()
        synchronously)."""
        if not self.dirty:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            self.sync_now()
            return
        with self._lock:
            if self._task is None or self._task.done():
                self._task = loop.create_task(self._drain())

    async def wait_durable(self) -> None:
        """Park until a flush covers every record appended before this
        call — the dispatch loop's group-commit barrier (``always``
        mode).  Returns immediately when nothing is unsynced, so
        non-persistent traffic pays one watermark compare."""
        loop = asyncio.get_running_loop()
        # lock-ownership: watermark/waiter-list mutations only — every
        # critical section is a few integer/list ops, never IO (the
        # fsync itself runs OUTSIDE the lock, in the executor), so a
        # thread holding it cannot stall the loop measurably
        with self._lock:
            target = self._appended
            if target <= self._synced:
                return
            fut: asyncio.Future = loop.create_future()
            self._waiters.append((target, fut))
            if self._task is None or self._task.done():
                self._task = loop.create_task(self._drain())
        await fut

    async def _drain(self) -> None:
        """The sync worker: one executor fsync per round, covering
        every waiter parked at round start; a fault backs off and
        retries with the waiters still parked."""
        backoff = _RETRY_BASE
        loop = asyncio.get_running_loop()
        idle_flushed = False  # one no-waiter round per kick (interval
        # mode: the next tick re-kicks; without this a steady append
        # stream would fsync back-to-back instead of per interval)
        while True:
            # lock-ownership: see wait_durable — integer/list ops only
            with self._lock:
                if self._closed or (
                    not self._waiters and (not self.dirty or idle_flushed)
                ):
                    self._task = None
                    return
                idle_flushed = not self._waiters
                target = self._appended
            t0 = time.perf_counter()
            try:
                await loop.run_in_executor(None, self._sync_fn)
            except Exception as exc:
                # lock-ownership: see wait_durable — counter bump only
                with self._lock:
                    self.sync_errors += 1
                if self.on_error is not None:
                    self.on_error(exc)
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, _RETRY_MAX)
                continue
            backoff = _RETRY_BASE
            self._finish(target, time.perf_counter() - t0)

    def _finish(self, target: int, dur_s: float) -> None:
        done = []
        with self._lock:
            if target > self._synced:
                self._synced = target
            self.sync_count += 1
            keep = []
            for wm, fut in self._waiters:
                (done if wm <= self._synced else keep).append((wm, fut))
            self._waiters = keep
        if self.on_sync is not None:
            self.on_sync(dur_s)
        for _wm, fut in done:
            # sync_now may run off-loop (tick fallback, shutdown):
            # futures resolve on their owning loop either way
            try:
                fut.get_loop().call_soon_threadsafe(
                    _resolve_waiter, fut
                )
            except RuntimeError:
                pass  # owning loop already closed

    # ------------------------------------------------------- lifecycle

    def stop(self) -> None:
        """Cancel the worker and fail any parked windows (broker
        shutdown: their batch futures are being failed anyway)."""
        with self._lock:
            self._closed = True
            task, self._task = self._task, None
            waiters, self._waiters = self._waiters, []
        if task is not None and not task.done():
            task.cancel()
        for _wm, fut in waiters:
            # cancel (not fail): an abandoned window's barrier must not
            # leave a never-retrieved exception behind
            fut.cancel()


def _resolve_waiter(fut: "asyncio.Future") -> None:
    if not fut.done():
        fut.set_result(None)


class GateGroup:
    """Facade over the per-shard SyncGates of a sharded store, keeping
    the broker's single-gate contract (``dur.gate.*``) intact.

    Each shard owns an independent append watermark and fsync barrier
    — that independence is the whole point of sharding (N disks' worth
    of group-commit concurrency) — but ACK CONSISTENCY is cross-shard:
    a dispatch window's barrier must cover every shard its appends
    touched.  `wait_durable` gathers ALL member gates' barriers; a
    clean gate returns immediately (one watermark compare), so the
    cost is one parked future per DIRTY shard and the window's acks
    can never straddle shards inconsistently (crash-suite-tested: a
    crash between two shards' fsyncs un-acks the whole window).

    There is deliberately no `mark_appended` here: the store's
    persist path marks each shard's own gate with that shard's count —
    the group only aggregates.
    """

    def __init__(self, gates: List[SyncGate]) -> None:
        self._gates = list(gates)

    def __iter__(self):
        return iter(self._gates)

    def __len__(self) -> int:
        return len(self._gates)

    @property
    def gates(self) -> List[SyncGate]:
        return self._gates

    # ---------------------------------------------------- aggregates

    @property
    def appended(self) -> int:
        return sum(g.appended for g in self._gates)

    @property
    def dirty(self) -> bool:
        return any(g.dirty for g in self._gates)

    @property
    def unsynced(self) -> int:
        return sum(g.unsynced for g in self._gates)

    @property
    def parked(self) -> int:
        return sum(g.parked for g in self._gates)

    @property
    def sync_count(self) -> int:
        return sum(g.sync_count for g in self._gates)

    @property
    def sync_errors(self) -> int:
        return sum(g.sync_errors for g in self._gates)

    def stats(self) -> dict:
        return {
            "sync_count": self.sync_count,
            "sync_errors": self.sync_errors,
            "unsynced": self.unsynced,
            "parked": self.parked,
        }

    # ----------------------------------------------------- callbacks

    @property
    def on_sync(self):
        return self._gates[0].on_sync if self._gates else None

    @on_sync.setter
    def on_sync(self, fn) -> None:
        for g in self._gates:
            g.on_sync = fn

    @property
    def on_error(self):
        return self._gates[0].on_error if self._gates else None

    @on_error.setter
    def on_error(self, fn) -> None:
        for g in self._gates:
            g.on_error = fn

    # ---------------------------------------------------- sync paths

    def sync_now(self) -> None:
        """Blocking flush of every dirty shard (tick fallback,
        shutdown).  Per-shard: a clean shard costs one compare."""
        for g in self._gates:
            g.sync_now()

    def sync_soon(self) -> None:
        for g in self._gates:
            g.sync_soon()

    async def wait_durable(self) -> None:
        """The cross-shard group-commit barrier: resolve only when a
        flush on EVERY shard covers the records appended to it before
        this call.  Dirty shards park concurrently — wall time is the
        slowest single fsync, not the sum."""
        dirty = [g for g in self._gates if g.dirty]
        if not dirty:
            return
        if len(dirty) == 1:
            await dirty[0].wait_durable()
            return
        await asyncio.gather(*(g.wait_durable() for g in dirty))

    def stop(self) -> None:
        for g in self._gates:
            g.stop()
