"""Beamformer: grouped long-poll over DS iterators.

The `emqx_ds_beamformer` role (EMQX apps/
emqx_durable_storage/src/emqx_ds_beamformer.erl:16-60): many readers
waiting for NEW data on the same streams are served together — a
store_batch triggers ONE sweep ("beam") that answers every coherent
parked poll, instead of each reader burning its own timer/poll cycle.

`poll(iterator, n, timeout)` returns immediately when data already
exists past the cursor, otherwise parks until the owning stream
receives an append (or the timeout elapses, returning the unchanged
iterator and no messages — the reference's poll timeout shape).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, List, Set, Tuple

from .. import failpoints
from ..message import Message
from .api import IterRef

log = logging.getLogger("emqx_tpu_torch.ds.beamformer")


class Beamformer:
    def __init__(self, storage) -> None:
        self.storage = storage
        # shard -> parked pollers' wakeup events
        self._parked: Dict[int, List[asyncio.Event]] = {}
        self.stats = {"polls": 0, "parked": 0, "beams": 0, "woken": 0}

    async def poll(
        self, it: IterRef, n: int = 256, timeout: float = 10.0
    ) -> Tuple[IterRef, List[Message]]:
        """Long-poll one iterator: (advanced iterator, messages);
        empty after `timeout` with no new matching data."""
        if failpoints.enabled:
            # chaos seam: `delay` injects long-poll latency, `drop`
            # answers this poll empty immediately (the timeout shape —
            # a beam the reader missed; callers re-poll), `error`
            # raises out to the poller's own recovery
            act = await failpoints.evaluate_async(
                "ds.beamformer.poll", key=str(it.stream.shard)
            )
            if act == "drop":
                return it, []
        self.stats["polls"] += 1
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while True:
            it2, msgs = self.storage.next(it, n)
            if msgs:
                return it2, msgs
            it = it2  # cursor may advance past non-matching records
            remaining = deadline - loop.time()
            if remaining <= 0:
                return it, []
            ev = asyncio.Event()
            shard = it.stream.shard
            self._parked.setdefault(shard, []).append(ev)
            self.stats["parked"] += 1
            try:
                await asyncio.wait_for(ev.wait(), remaining)
            except asyncio.TimeoutError:
                return it, []
            finally:
                waiters = self._parked.get(shard)
                if waiters is not None and ev in waiters:
                    waiters.remove(ev)
                    if not waiters:
                        self._parked.pop(shard, None)
            # woken by a beam: loop re-reads the stream (the data may
            # not match THIS reader's filter — it re-parks then)

    def has_parked(self) -> bool:
        """Cheap guard for the hot persist path: shard-set building and
        notify are skipped entirely while no reader is parked."""
        return bool(self._parked)

    def notify(self, shards: Set[int]) -> None:
        """A store_batch landed in `shards`: fire one beam per shard,
        waking every parked reader of it at once."""
        for shard in shards:
            waiters = self._parked.pop(shard, None)
            if not waiters:
                continue
            self.stats["beams"] += 1
            self.stats["woken"] += len(waiters)
            for ev in waiters:
                ev.set()

    def info(self) -> Dict:
        return {
            **self.stats,
            "parked_now": sum(len(v) for v in self._parked.values()),
        }
