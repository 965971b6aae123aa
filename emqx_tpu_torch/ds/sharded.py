"""Sharded DS store: N independent segment-log + metadata pairs.

One dslog directory serializes every append through one segment file
and ONE fsync barrier — fine for thousands of sessions, a wall at a
million: the group-commit gate amortizes fsyncs per window, but all
windows still share a single disk queue, and restart scans one giant
segment chain.  `ShardedStorage` splits the store by STREAM HASH into
``n_shards`` inner stores (``shard-00/ .. shard-NN/``), each a full
LocalStorage/LtsStorage with its own segment chain, its own journal +
snapshot metadata, its own append watermark and its own SyncGate
(persist.py pairs one gate per shard and fronts them with
`durability.GateGroup`):

  * WRITES — a message routes by ``crc32(first STREAM_LEVELS topic
    levels) % n_shards`` — the same prefix family the in-shard stream
    hash and `filter_streams` use, so a CONCRETE filter routes to
    exactly one shard and a wildcard-in-prefix fans out to all;
  * FSYNC — shards flush independently (N disks' worth of group
    commit); cross-shard ACK consistency is the GateGroup's barrier,
    not the storage's problem;
  * RECOVERY — shards recover independently (quarantine in one shard
    never widens to another) and in O(delta) each via their metadata
    journals;
  * GC — generation pins are per-shard: `gc_pinned` takes a
    ``{store: floor}`` map because generation numbers only mean
    something within one shard's segment chain.

The shard index travels in ``StreamRef.store`` (serialized only when
nonzero, so single-shard checkpoints are byte-identical to the old
format) and every read routes by it.  ``n_shards`` is pinned by the
data directory's LAYOUT marker — it defines where records LIVE, so a
config change cannot quietly re-route reads away from old data.
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import Dict, List, Optional, Sequence, Tuple

from ..message import Message
from .api import (
    DurableStorage,
    IterRef,
    StreamRef,
    filter_streams,
    stream_of,
)
from .builtin_local import LocalStorage
from .lts import LtsStorage


class ShardedStorage(DurableStorage):
    def __init__(
        self,
        directory: str,
        n_shards: int,
        layout: str = "lts",
        n_streams: int = 16,
        seg_bytes: int = 0,
    ) -> None:
        self.directory = directory
        self.n_shards = n_shards
        self.layout = layout
        self.on_corruption = None
        self.corruption_events: List[Dict] = []
        self.on_rebuild = None
        self.rebuild_events: List[Dict] = []
        self.stores: List[DurableStorage] = []
        for i in range(n_shards):
            sub = os.path.join(directory, f"shard-{i:02d}")
            os.makedirs(sub, exist_ok=True)
            if layout == "lts":
                st: DurableStorage = LtsStorage(sub, seg_bytes=seg_bytes)
            else:
                st = LocalStorage(
                    sub, n_streams=n_streams, seg_bytes=seg_bytes
                )
            self.stores.append(st)
        # adopt whatever the inner loads detected, then route their
        # later events through this facade (same funnel discipline as
        # DurableSessions over its storage)
        for st in self.stores:
            for evt in st.corruption_events:
                self._forward_corruption(evt)
            st.corruption_events = []
            st.on_corruption = self._forward_corruption
            for evt in getattr(st, "rebuild_events", ()):
                self._forward_rebuild(evt)
            if hasattr(st, "rebuild_events"):
                st.rebuild_events = []
            if hasattr(st, "on_rebuild"):
                st.on_rebuild = self._forward_rebuild

    def _forward_corruption(self, evt: Dict) -> None:
        if self.on_corruption is not None:
            self.on_corruption(evt)
        else:
            self.corruption_events.append(evt)

    def _forward_rebuild(self, evt: Dict) -> None:
        if self.on_rebuild is not None:
            self.on_rebuild(evt)
        else:
            self.rebuild_events.append(evt)

    # metadata fsync propagates to the inner stores (they own the
    # sidecar writes)
    @property
    def meta_fsync(self) -> bool:
        return bool(self.stores and self.stores[0].meta_fsync)

    @meta_fsync.setter
    def meta_fsync(self, val: bool) -> None:
        for st in self.stores:
            st.meta_fsync = val

    # ---------------------------------------------------------- routing

    def shard_for(self, topic: str) -> int:
        return stream_of(topic, self.n_shards)

    def _route_filter(self, flt: str) -> List[int]:
        only = filter_streams(flt, self.n_shards)
        if only is not None:
            return [only]
        return list(range(self.n_shards))

    # ------------------------------------------------------------ write

    def store_batch(
        self, msgs: Sequence[Message], sync: bool = False
    ) -> Optional[Dict[int, int]]:
        """Partition the batch by shard hash and append to each inner
        store in arrival order.  Returns {store index: records
        appended} so the owner can mark each shard's OWN SyncGate —
        the per-shard watermark is what keeps one shard's fsync from
        covering (or blocking) another's."""
        parts: Dict[int, List[Message]] = {}
        for msg in msgs:
            parts.setdefault(self.shard_for(msg.topic), []).append(msg)
        for idx, batch in parts.items():
            self.stores[idx].store_batch(batch, sync=sync)
        return {idx: len(batch) for idx, batch in parts.items()}

    def stream_key(self, topic: str) -> int:
        # the beamformer's park/notify key: must equal the key of the
        # stream the topic's records land in, i.e. the INNER store's.
        # Keys may collide ACROSS shards — harmless: a spurious wakeup
        # polls, reads nothing, re-parks.
        return self.stores[self.shard_for(topic)].stream_key(topic)

    # ------------------------------------------------------------- read

    def get_streams(
        self, topic_filter: str, start_time_us: int = 0
    ) -> List[StreamRef]:
        out: List[StreamRef] = []
        for idx in self._route_filter(topic_filter):
            for s in self.stores[idx].get_streams(
                topic_filter, start_time_us
            ):
                out.append(replace(s, store=idx) if idx else s)
        return out

    def next(self, it: IterRef, n: int) -> Tuple[IterRef, List[Message]]:
        # inner stores only read it.stream.shard and rebuild IterRefs
        # around the SAME StreamRef, so the store tag round-trips
        return self.stores[it.stream.store].next(it, n)

    # -------------------------------------------------------- lifecycle

    def sync_data(self) -> None:
        for st in self.stores:
            st.sync_data()

    def save_meta(self) -> None:
        for st in self.stores:
            st.save_meta()

    def save_meta_full(self) -> None:
        for st in self.stores:
            st.save_meta_full()

    def gc(self, cutoff_ts_us: int,
           pin_floor: Optional[int] = None) -> int:
        # a single scalar floor cannot be right across shards (each
        # shard numbers its own generations) — only sensible unpinned
        return sum(
            st.gc(cutoff_ts_us, pin_floor=pin_floor)
            for st in self.stores
        )

    def gc_pinned(self, cutoff_ts_us: int,
                  floors: Dict[int, int]) -> int:
        """Retention with per-shard generation pins: ``floors`` maps
        store index -> lowest generation a live replay cursor in that
        shard still needs."""
        return sum(
            st.gc(cutoff_ts_us, pin_floor=floors.get(i))
            for i, st in enumerate(self.stores)
        )

    def seg_for(self, stream: StreamRef, ts: int, seq: int) -> int:
        return self.stores[stream.store].seg_for(stream, ts, seq)

    def generation(self) -> int:
        return max(st.generation() for st in self.stores)

    # ------------------------------------------------- rebuild surface

    @property
    def rebuilding(self) -> bool:
        return any(st.rebuilding for st in self.stores)

    @property
    def rebuild_progress(self) -> Dict[str, int]:
        scanned = total = 0
        for st in self.stores:
            p = st.rebuild_progress
            scanned += p.get("scanned", 0)
            total += p.get("total", 0)
        return {"scanned": scanned, "total": total}

    def rebuild_now(self) -> None:
        for st in self.stores:
            st.rebuild_now()

    # ----------------------------------------------------------- stats

    def corruption_stats(self) -> Dict[str, int]:
        out = {"corrupt_records": 0, "quarantined_segments": 0}
        for st in self.stores:
            for k, v in st.corruption_stats().items():
                out[k] = out.get(k, 0) + v
        return out

    def shard_stats(self) -> List[Dict[str, int]]:
        """Per-shard stats rows (the ops surface's breakdown)."""
        return [
            {"shard": i, **st.corruption_stats()}
            for i, st in enumerate(self.stores)
        ]

    def stats(self) -> Dict[str, int]:
        out: Dict[str, int] = {"shards": self.n_shards}
        for st in self.stores:
            for k, v in st.stats().items():
                if isinstance(v, int):
                    out[k] = out.get(k, 0) + v
        return out

    def close(self) -> None:
        for st in self.stores:
            st.close()
