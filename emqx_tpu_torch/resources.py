"""Resource framework: buffered, health-checked sinks for rule actions.

A port of the JAX package's ``resources.py``, a compact analogue of
EMQX's `emqx_resource` (apps/emqx_resource/src/emqx_resource.erl:169-253
behavior callbacks; emqx_resource_manager.erl health state machine;
emqx_resource_buffer_worker.erl replayq buffering): every external IO
target is a Resource with start/stop/query/health callbacks, fronted by
a BufferWorker that absorbs bursts and outages — queries queue in a
bounded buffer, failures retry with backoff while the resource is
marked disconnected, and nothing is lost within the buffer bound.

`HttpSink` is the built-in HTTP action target (the emqx_bridge_http
role), sent with this package's own client (`httpc`), so the sink
needs nothing outside the standard library.

The worker has the ``resource.buffer.query`` and
``resource.batch.flush`` failpoint seams, and no overload-protection
flush deferral: this package has no such module yet.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

from . import failpoints
from .aio import cancel_and_wait
from .observability import Histogram

log = logging.getLogger("emqx_tpu_torch.resources")

CONNECTING = "connecting"
CONNECTED = "connected"
DISCONNECTED = "disconnected"


def _qsize(q: Any) -> int:
    """Approximate in-buffer byte cost of one query (drives the
    ``batch_bytes`` flush threshold; exactness doesn't matter, only
    monotonic accounting that returns the same figure on enqueue and
    dequeue)."""
    if isinstance(q, (bytes, str)):
        return len(q)
    if isinstance(q, tuple):
        return 16 + sum(
            len(x) for x in q if isinstance(x, (bytes, str))
        )
    return 64


class Resource:
    """Callback behavior (emqx_resource.erl:169-253)."""

    async def on_start(self) -> None: ...

    async def on_stop(self) -> None: ...

    async def on_query(self, query: Any) -> None:
        """Deliver one query; raise on failure (triggers retry)."""
        raise NotImplementedError

    async def health_check(self) -> bool:
        return True


class HttpSink(Resource):
    """POST each query's body to a URL (emqx_bridge_http essentials)."""

    def __init__(
        self,
        url: str,
        method: str = "POST",
        headers: Optional[Dict[str, str]] = None,
        timeout: float = 5.0,
    ) -> None:
        self.url = url
        self.method = method
        self.headers = dict(headers or {})
        self.timeout = timeout
        self._session = None

    async def on_start(self) -> None:
        from .httpc import Client

        self._session = Client(timeout=self.timeout)

    async def on_stop(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None

    async def on_query(self, query: Any) -> None:
        body = query if isinstance(query, (bytes, str)) else None
        json_body = None if body is not None else query
        resp = await self._session.request(
            self.method,
            self.url,
            data=body,
            json=json_body,
            headers=self.headers,
        )
        if resp.status >= 300:
            raise RuntimeError(f"http sink status {resp.status}")

    async def health_check(self) -> bool:
        try:
            resp = await self._session.head(self.url, headers=self.headers)
            return resp.status < 500
        except Exception:
            return False


class BufferWorker:
    """Bounded replay buffer + retrying drain loop per resource
    (emqx_resource_buffer_worker.erl): queries survive sink outages up
    to ``max_buffer``; beyond it the OLDEST drops (counted).

    Micro-batching (the window-shaped egress): with ``batch_age > 0``
    the drain loop lingers until a count (``batch_records``), byte
    (``batch_bytes``) or age threshold is crossed before flushing — so
    a window of rule actions leaves as ONE ``on_query_batch`` call
    instead of per-record round-trips.  All three default OFF
    (immediate drain).

    Circuit breaker (``breaker_threshold`` consecutive failures):
    while open, the drain loop parks — buffered batches are retained
    for replay, intake keeps absorbing up to the bound — and the
    periodic health probe re-closes it.  Edges fire
    ``on_breaker_edge`` (ResourceManager wires the alarm)."""

    def __init__(
        self,
        resource: Resource,
        max_buffer: int = 10_000,
        max_retries: Optional[int] = None,
        retry_base: float = 0.05,
        retry_cap: float = 5.0,
        health_interval: float = 1.0,
        batch_records: int = 0,
        batch_bytes: int = 0,
        batch_age: float = 0.0,
        breaker_threshold: int = 0,
    ) -> None:
        self.resource = resource
        self.name = ""  # resource_id when owned by a ResourceManager
        self.max_buffer = max_buffer
        self.max_retries = max_retries
        self.retry_base = retry_base
        self.retry_cap = retry_cap
        self.health_interval = health_interval
        self.batch_records = batch_records
        self.batch_bytes = batch_bytes
        self.batch_age = batch_age
        self.breaker_threshold = breaker_threshold
        self.status = CONNECTING
        self.breaker_open = False
        self.stats = {
            "matched": 0,
            "success": 0,
            "failed": 0,
            "dropped": 0,
            "retried": 0,
            "batches": 0,
            "breaker_opens": 0,
        }
        self.batch_hist = Histogram()  # flushed batch sizes
        self._buf: deque = deque()
        self._buf_bytes = 0
        self._oldest_ts = 0.0
        self._fail_streak = 0
        self._q_full_edge = False
        self._wake = asyncio.Event()
        self._task: Optional[asyncio.Task] = None

    # ------------------------------------------------------- lifecycle

    async def start(self) -> None:
        await self.resource.on_start()
        self.status = CONNECTED if await self._health() else DISCONNECTED
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            # cancel_and_wait: the drain loop's wait_for can swallow a
            # cancel that lands as the wake future resolves (bpo-37658)
            await cancel_and_wait(self._task)
            self._task = None
        await self.resource.on_stop()

    async def _health(self) -> bool:
        try:
            return await self.resource.health_check()
        except Exception:
            return False

    # hooks, wired by the ResourceManager when a broker owns this
    # worker: status alarm, breaker open/close edge, queue-full edge —
    # all optional, all exception-isolated
    on_status_alarm = None
    on_breaker_edge: Optional[Callable[[bool], None]] = None
    on_queue_full: Optional[Callable[[int], None]] = None

    def _alarm(self, down: bool) -> None:
        if self.on_status_alarm is not None:
            try:
                self.on_status_alarm(down)
            except Exception:
                pass

    def _set_status(self, new: str) -> None:
        """EVERY status flip goes through here so the alarm fires on
        the drain path too (a sink failing under sustained traffic
        never reaches the idle probe)."""
        if new == self.status:
            return
        self.status = new
        if new == DISCONNECTED:
            self._alarm(True)
        elif new == CONNECTED:
            self._alarm(False)

    # --------------------------------------------------------- intake

    def enqueue(self, query: Any) -> bool:
        """Queue one query (non-blocking; called from rule actions).
        Returns False when the buffer had to drop its oldest entry."""
        self.stats["matched"] += 1
        if not self._buf:
            self._oldest_ts = time.monotonic()
        ok = True
        if len(self._buf) >= self.max_buffer:
            old = self._buf.popleft()
            self._buf_bytes -= _qsize(old)
            self.stats["dropped"] += 1
            self._note_queue_full(1)
            ok = False
        elif self._q_full_edge and (
            len(self._buf) < self.max_buffer // 2
        ):
            self._q_full_edge = False  # re-arm the edge event
        self._buf.append(query)
        self._buf_bytes += _qsize(query)
        self._wake.set()
        return ok

    def enqueue_batch(self, queries: list) -> int:
        """Queue a whole action window in one call (the batched rule
        egress).  Returns how many OLDEST entries dropped to hold the
        ``max_buffer`` bound (0 = nothing lost)."""
        n = len(queries)
        if not n:
            return 0
        self.stats["matched"] += n
        if not self._buf:
            self._oldest_ts = time.monotonic()
        buf = self._buf
        buf.extend(queries)
        self._buf_bytes += sum(map(_qsize, queries))
        dropped = len(buf) - self.max_buffer
        if dropped > 0:
            for _ in range(dropped):
                old = buf.popleft()
                self._buf_bytes -= _qsize(old)
            self.stats["dropped"] += dropped
            self._note_queue_full(dropped)
        else:
            dropped = 0
            if self._q_full_edge and len(buf) < self.max_buffer // 2:
                self._q_full_edge = False
        self._wake.set()
        return dropped

    def _note_queue_full(self, dropped: int) -> None:
        """Edge-triggered queue-full event: one event per excursion to
        the bound, re-armed once the buffer drains below half."""
        if not self._q_full_edge:
            self._q_full_edge = True
            if self.on_queue_full is not None:
                try:
                    self.on_queue_full(dropped)
                except Exception:
                    pass

    def __len__(self) -> int:
        return len(self._buf)

    # ---------------------------------------------------------- drain

    def _linger_remaining(self) -> float:
        """Seconds the drain loop should still linger before flushing
        the pending micro-batch (0.0 = flush now).  Count and byte
        thresholds release immediately; otherwise the batch rides
        until ``batch_age``."""
        if self.batch_age <= 0.0:
            return 0.0
        if self.batch_records and len(self._buf) >= self.batch_records:
            return 0.0
        if self.batch_bytes and self._buf_bytes >= self.batch_bytes:
            return 0.0
        age = time.monotonic() - self._oldest_ts
        return max(0.0, self.batch_age - age)

    def _trip_breaker(self, exc: Exception) -> None:
        self.breaker_open = True
        self.stats["breaker_opens"] += 1
        log.warning(
            "sink %s breaker OPEN after %d consecutive failures "
            "(%d queries parked): %s",
            self.name or type(self.resource).__name__,
            self._fail_streak, len(self._buf), exc,
        )
        if self.on_breaker_edge is not None:
            try:
                self.on_breaker_edge(True)
            except Exception:
                pass

    async def _breaker_probe(self) -> None:
        """While the breaker is open the drain loop parks here:
        buffered batches are retained for replay, and a successful
        health probe re-closes the breaker."""
        await asyncio.sleep(self.health_interval)
        if await self._health():
            self.breaker_open = False
            self._fail_streak = 0
            self._set_status(CONNECTED)
            if self.on_breaker_edge is not None:
                try:
                    self.on_breaker_edge(False)
                except Exception:
                    pass
        else:
            self._set_status(DISCONNECTED)

    async def _flush_once(self) -> None:
        """Deliver the buffer head: one query, or — for batching
        sinks — up to ``resource.max_batch`` queries as ONE
        ``on_query_batch`` call, which returns how many it consumed;
        a partial consume leaves the tail at the head for the retry
        path (EMQX's buffer workers batch the same way).

        Failpoint seams (both inside the caller's try, so an injected
        fault rides the real retry, backoff and replay path with every
        query still buffered): ``resource.buffer.query`` a delivery
        attempt, ``resource.batch.flush`` a multi-record flush, where
        ``drop`` is a flush lost in flight (the records stay at the
        head and replay) and ``duplicate`` delivers the batch twice."""
        buf = self._buf
        n_batch = getattr(self.resource, "max_batch", 1)
        if failpoints.enabled:
            await failpoints.evaluate_async(
                "resource.buffer.query",
                key=self.name or type(self.resource).__name__,
            )
        if n_batch > 1 and hasattr(self.resource, "on_query_batch"):
            batch = [
                buf[i] for i in range(min(n_batch, len(buf)))
            ]
            if failpoints.enabled:
                act = await failpoints.evaluate_async(
                    "resource.batch.flush",
                    key=self.name or type(self.resource).__name__,
                )
                if act == "drop":
                    raise RuntimeError(
                        "batch flush dropped in flight (failpoint)"
                    )
                if act == "duplicate":
                    await self.resource.on_query_batch(list(batch))
            done = await self.resource.on_query_batch(batch)
            done = len(batch) if done is None else int(done)
            for _ in range(done):
                self._buf_bytes -= _qsize(buf.popleft())
            self.stats["success"] += done
            self.stats["batches"] += 1
            self.batch_hist.record(len(batch))
            if done < len(batch):
                raise RuntimeError(
                    f"sink consumed {done}/{len(batch)}"
                )
        else:
            query = buf[0]  # keep at head until delivered
            await self.resource.on_query(query)
            self._buf_bytes -= _qsize(buf.popleft())
            self.stats["success"] += 1
        # the flushed batch's linger window is spent; the tail (if
        # any) starts a fresh age budget
        self._oldest_ts = time.monotonic()

    async def _run(self) -> None:
        backoff = self.retry_base
        retries = 0
        while True:
            if not self._buf:
                self._wake.clear()
                try:
                    await asyncio.wait_for(
                        self._wake.wait(), self.health_interval
                    )
                except asyncio.TimeoutError:
                    # periodic probe in EVERY state (EMQX's resource
                    # manager health-checks while connected too — a
                    # silently dead sink must flip to disconnected
                    # before traffic piles into it, not when the next
                    # query fails)
                    healthy = await self._health()
                    self._set_status(
                        CONNECTED if healthy else DISCONNECTED
                    )
                    continue
            if self.breaker_open:
                await self._breaker_probe()
                continue
            rem = self._linger_remaining()
            if rem > 0.0:
                # micro-batch linger: wake early if intake crosses a
                # count/byte threshold, else sleep out the age budget
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(), rem)
                except asyncio.TimeoutError:
                    pass
                continue
            try:
                await self._flush_once()
                self._set_status(CONNECTED)
                backoff = self.retry_base
                retries = 0
                self._fail_streak = 0
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                self._set_status(DISCONNECTED)
                self.stats["retried"] += 1
                retries += 1
                self._fail_streak += 1
                if (
                    self.breaker_threshold
                    and self._fail_streak >= self.breaker_threshold
                    and not self.breaker_open
                ):
                    # park instead of hot-retrying a dead sink; the
                    # buffered queries replay after the probe re-close
                    self._trip_breaker(exc)
                    retries = 0
                    backoff = self.retry_base
                    continue
                if (
                    self.max_retries is not None
                    and retries > self.max_retries
                ):
                    self._buf_bytes -= _qsize(self._buf.popleft())
                    self.stats["failed"] += 1
                    retries = 0
                    backoff = self.retry_base  # next query starts fresh
                    log.warning(
                        "sink query dropped after %d retries: %s",
                        self.max_retries,
                        exc,
                    )
                    continue
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, self.retry_cap)


class ResourceManager:
    """Registry of named resources and their buffer workers
    (emqx_resource_manager's lifecycle role).  When a broker owns the
    manager it wires ``alarms``, so every worker's health flips raise
    ``resource_down:<id>`` and its breaker edges ``sink_breaker:<id>``."""

    def __init__(self, alarms=None) -> None:
        self._workers: Dict[str, BufferWorker] = {}
        self.alarms = alarms  # broker AlarmRegistry (optional)

    async def create(
        self, resource_id: str, resource: Resource, **worker_kw
    ) -> BufferWorker:
        await self.remove(resource_id)
        worker = BufferWorker(resource, **worker_kw)
        worker.name = resource_id
        if self.alarms is not None:
            def status_alarm(down: bool, rid=resource_id):
                if down:
                    self.alarms.activate(
                        f"resource_down:{rid}",
                        details={"resource": rid},
                        message=f"resource {rid} health check failing",
                    )
                else:
                    self.alarms.deactivate(f"resource_down:{rid}")
            worker.on_status_alarm = status_alarm

        def breaker_edge(opened: bool, rid=resource_id):
            if self.alarms is not None:
                if opened:
                    self.alarms.activate(
                        f"sink_breaker:{rid}",
                        details={"resource": rid},
                        message=(
                            f"sink {rid} circuit breaker open "
                            "(batches parked for replay)"
                        ),
                    )
                else:
                    self.alarms.deactivate(f"sink_breaker:{rid}")
        worker.on_breaker_edge = breaker_edge

        await worker.start()
        self._workers[resource_id] = worker
        return worker

    def get(self, resource_id: str) -> Optional[BufferWorker]:
        return self._workers.get(resource_id)

    async def remove(self, resource_id: str) -> bool:
        worker = self._workers.pop(resource_id, None)
        if worker is None:
            return False
        # a deleted resource must not leave its alarms behind
        worker._alarm(False)
        if worker.breaker_open and worker.on_breaker_edge is not None:
            try:
                worker.on_breaker_edge(False)
            except Exception:
                pass
        await worker.stop()
        return True

    async def stop_all(self) -> None:
        for rid in list(self._workers):
            await self.remove(rid)

    def info(self) -> Dict[str, Dict]:
        out: Dict[str, Dict] = {}
        for rid, w in self._workers.items():
            snap = w.batch_hist.snapshot()
            out[rid] = {
                "status": w.status,
                "buffered": len(w),
                "breaker_open": w.breaker_open,
                "batch_size": {
                    "count": snap.count,
                    "p50": snap.percentile(50),
                    "p95": snap.percentile(95),
                    "p99": snap.percentile(99),
                },
                **w.stats,
            }
        return out

    def summary(self) -> Dict[str, int]:
        """Node-info roll-up across every sink worker."""
        ws = self._workers.values()
        return {
            "sinks": len(self._workers),
            "buffered": sum(len(w) for w in ws),
            "batches": sum(w.stats["batches"] for w in ws),
            "breakers_open": sum(1 for w in ws if w.breaker_open),
        }
