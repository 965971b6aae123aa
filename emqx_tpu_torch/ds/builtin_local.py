"""Single-node durable storage on the native dslog engine.

The `emqx_ds_builtin_local` analogue (EMQX apps/
emqx_ds_builtin_local/src/) with the storage layer in C++
(native/dslog.cpp) instead of RocksDB: messages append to a
(stream, time)-indexed log, streams are topic-prefix hash shards, and
a learned topic set per stream prunes `get_streams` for concrete
filters (the LTS idea, emqx_ds_lts.erl:100-143, without the adaptive
wildcard discovery — the topic census spills to 'opaque' past a bound
and the stream then serves every filter).

The census is maintained INCREMENTALLY (ds/journal.py): each new
(stream, topic) sighting appends one delta record to
``census.journal``, a watermark record per metadata flush asserts
coverage up to a log timestamp, and the ``census.json`` snapshot is
only rewritten by the journal FOLD (close / size threshold).  Recovery
is O(delta since the last flush) — snapshot + journal replay + a per-
stream scan from the watermark — instead of the whole-store rebuild a
stale count used to force.  Only a store with NO usable snapshot pays
the full rebuild, and that now runs in the BACKGROUND: an empty census
never prunes, so reads serve correct-but-wider from the log while the
scan proceeds (progress + the ``ds_meta_rebuild`` alarm surface it).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .. import topic as T
from ..message import Message
from . import atomicio
from .api import (
    DurableStorage,
    IterRef,
    StreamRef,
    decode_message,
    encode_message,
    filter_streams,
    stream_of,
)
from .journal import MetaJournal
from .native import DsLog

log = logging.getLogger("emqx_tpu_torch.ds")

_TOPIC_CENSUS_MAX = 8192
# journal size that triggers a fold into the snapshot at the next
# metadata flush (bounds replay work AND journal growth)
_FOLD_BYTES = 256 * 1024


class LocalStorage(DurableStorage):
    def __init__(
        self,
        directory: str,
        n_streams: int = 16,
        seg_bytes: int = 0,
        background_rebuild: bool = True,
    ) -> None:
        self.directory = directory
        self.n_streams = n_streams
        self.on_corruption = None
        self.corruption_events: List[Dict] = []
        # census-rebuild progress surface (the `ds_meta_rebuild` alarm
        # + gauge): events buffer until the owner wires `on_rebuild`
        self.on_rebuild = None
        self.rebuild_events: List[Dict] = []
        self.rebuilding = False
        self.rebuild_progress = {"scanned": 0, "total": 0}
        self._background_rebuild = background_rebuild
        self._rebuild_lock = threading.Lock()
        self._rebuild_live: List[Tuple[int, str]] = []
        self._rebuild_stop = False
        self._rebuild_thread: Optional[threading.Thread] = None
        self._log = DsLog(directory, seg_bytes=seg_bytes)
        ncorrupt = self._log.corrupt_records()
        if ncorrupt:
            # the log recovery quarantined unreadable record suffixes:
            # the intact data keeps serving, and the owner raises the
            # ds_storage_corruption alarm — never a silent loss
            self._report_corruption(
                "storage", directory,
                f"{ncorrupt} record(s) quarantined in "
                f"{self._log.quarantined_count()} segment(s)",
                records=ncorrupt,
            )
        # learned topic structure: stream -> topics seen (None = opaque)
        self._census: Dict[int, Optional[Set[str]]] = {}
        self._census_path = os.path.join(directory, "census.json")
        self._journal = MetaJournal(
            os.path.join(directory, "census.journal")
        )
        # pending delta records (flushed by save_meta), the on-disk
        # coverage watermark, and the max append ts seen (the next
        # watermark candidate)
        self._jbuf: List[Dict] = []
        self._wm = 0
        self._max_ts_us = 0
        self._need_fold = False
        self._load_census()

    # ------------------------------------------------------------ write

    def store_batch(self, msgs: Sequence[Message], sync: bool = False) -> None:
        for msg in msgs:
            shard = stream_of(msg.topic, self.n_streams)
            ts_us = int(msg.timestamp * 1e6)
            self._log.append(shard, ts_us, encode_message(msg))
            if ts_us > self._max_ts_us:
                self._max_ts_us = ts_us
            if self.rebuilding:
                # census is being rebuilt in the background: defer the
                # update through the handoff list (the worker merges it
                # under the lock before declaring the census complete)
                with self._rebuild_lock:
                    if self.rebuilding:
                        self._rebuild_live.append((shard, msg.topic))
                        continue
            census = self._census.setdefault(shard, set())
            if census is not None and msg.topic not in census:
                census.add(msg.topic)
                if len(census) > _TOPIC_CENSUS_MAX:
                    self._census[shard] = None  # opaque from now on
                    self._jbuf.append({"t": "opaque", "s": shard})
                elif ts_us < self._wm:
                    # time-traveling append (clock step): a record
                    # BELOW the flushed watermark would be skipped by
                    # the delta scan, so its delta cannot wait for the
                    # next flush — journal it immediately
                    self._journal.append(
                        [{"t": "topic", "s": shard, "topic": msg.topic}],
                        fsync=self.meta_fsync,
                    )
                else:
                    self._jbuf.append(
                        {"t": "topic", "s": shard, "topic": msg.topic}
                    )
        if sync:
            self._log.sync()
            self.save_meta()

    # ------------------------------------------------------------- read

    def get_streams(
        self, topic_filter: str, start_time_us: int = 0
    ) -> List[StreamRef]:
        only = filter_streams(topic_filter, self.n_streams)
        present = set(self._log.streams()) | set(self._census)
        if only is not None:
            return [StreamRef(shard=only)] if only in present else []
        fwords = T.words(topic_filter)
        out = []
        rebuilding = self.rebuilding
        for shard in sorted(present):
            census = None if rebuilding else self._census.get(shard)
            if census is not None and not any(
                T.match_words(T.words(t), fwords) for t in census
            ):
                continue  # provably no matching topic in this stream
            out.append(StreamRef(shard=shard))
        return out

    def next(self, it: IterRef, n: int) -> Tuple[IterRef, List[Message]]:
        out: List[Message] = []
        ts, seq = it.ts, it.seq
        fwords = T.words(it.topic_filter)
        for ets, eseq, payload in self._log.scan(it.stream.shard, ts):
            if (ets, eseq) <= (ts, seq):
                continue
            if len(out) >= n:
                break
            msg = decode_message(payload)
            if T.match_words(T.words(msg.topic), fwords):
                out.append(msg)
            ts, seq = ets, eseq
        return IterRef(it.stream, it.topic_filter, ts, seq), out

    # ------------------------------------------------------- lifecycle

    def _total_count(self) -> int:
        return sum(self._log.stream_count(s) for s in self._log.streams())

    def _load_census(self) -> None:
        """Load the census: snapshot + journal replay + a per-stream
        delta scan from the watermark (O(records since the last flush),
        the log stays the source of truth).  Missing/corrupt snapshot
        falls back to the full rebuild — now backgrounded — with the
        corrupt case counted and alarmed, never silently absorbed."""
        raw = None
        try:
            raw = atomicio.load_json(self._census_path)
        except FileNotFoundError:
            pass
        except atomicio.MetaCorruption as exc:
            self._report_corruption("meta", exc.path, exc.detail)
        jrecs, jdetail = self._journal.load()
        if jdetail:
            # interior journal break: the valid prefix (and its last
            # watermark) still applies; the lost suffix's deltas are
            # re-learned by the scan from that earlier watermark
            self._report_corruption("meta", self._journal.path, jdetail)
        streams: Optional[Dict[int, Optional[Set[str]]]] = None
        snap_wm: Optional[int] = None
        if raw is not None:
            try:
                streams = {
                    int(k): (None if v is None else set(v))
                    for k, v in raw["streams"].items()
                }
                if "wm" in raw:
                    snap_wm = int(raw["wm"])
            except (ValueError, KeyError, AttributeError, TypeError):
                streams = None
        if streams is None:
            if raw is None and jrecs:
                # never folded: the journal holds EVERY delta since the
                # store was created (fold is the only truncation, and
                # it writes the snapshot first) — replay from empty
                streams = {}
            else:
                self._start_rebuild()
                return
        wm = snap_wm
        for r in jrecs:
            t = r.get("t")
            if t == "topic":
                c = streams.setdefault(int(r["s"]), set())
                if c is not None:
                    c.add(r["topic"])
                    if len(c) > _TOPIC_CENSUS_MAX:
                        streams[int(r["s"])] = None
            elif t == "opaque":
                streams[int(r["s"])] = None
            elif t == "wm":
                ts = int(r["ts"])
                if wm is None or ts > wm:
                    wm = ts
        if wm is None:
            # legacy snapshot (no watermark anywhere): the old count
            # check — matching means complete, stale means the full
            # rebuild the watermark scheme exists to avoid
            if raw is not None and raw.get("n") == self._total_count():
                self._census = streams
                return
            self._start_rebuild()
            return
        self._census = streams
        maxts = wm
        for shard in self._log.streams():
            if self._census.get(shard) is None and shard in self._census:
                continue  # opaque: trivially covered at any ts
            census = self._census.setdefault(shard, set())
            for ets, _seq, payload in self._log.scan(shard, wm):
                if census is not None:
                    census.add(decode_message(payload).topic)
                    if len(census) > _TOPIC_CENSUS_MAX:
                        census = self._census[shard] = None
                if ets > maxts:
                    maxts = ets
        self._wm = wm
        self._max_ts_us = maxts
        if maxts > wm or jrecs:
            self._need_fold = True  # boot fold: compact what replay
            # and the delta scan accumulated (next save_meta)

    # ------------------------------------------------- full rebuild

    def _start_rebuild(self) -> None:
        """Census lost (fresh dir, corrupt snapshot, stale legacy
        snapshot): rebuild from the log.  The store SERVES during the
        rebuild — an absent census entry never prunes, so reads are
        correct-but-wider until the scan lands."""
        self._census = {}
        total = len(self._log.streams())
        self.rebuild_progress = {"scanned": 0, "total": total}
        if total == 0:
            return  # nothing to scan (fresh directory)
        self.rebuilding = True
        self._rebuild_live = []
        self._rebuild_stop = False
        self._notify_rebuild("start")
        if self._background_rebuild:
            t = threading.Thread(
                target=self._rebuild_worker,
                name="ds-census-rebuild",
                daemon=True,
            )
            self._rebuild_thread = t
            t.start()
        else:
            self._rebuild_worker()

    def _rebuild_worker(self) -> None:
        built: Dict[int, Optional[Set[str]]] = {}
        maxts = 0
        ok = True
        try:
            for shard in self._log.streams():
                if self._rebuild_stop:
                    ok = False
                    break
                census: Optional[Set[str]] = set()
                for ets, _seq, payload in self._log.scan(shard, 0):
                    if census is not None:
                        census.add(decode_message(payload).topic)
                        if len(census) > _TOPIC_CENSUS_MAX:
                            census = None
                    if ets > maxts:
                        maxts = ets
                built[shard] = census
                self.rebuild_progress["scanned"] += 1
        except Exception:
            log.exception("census rebuild failed for %s", self.directory)
            ok = False
        if not ok:
            # aborted/faulted: census stays empty (never prunes — reads
            # remain correct), the next open retries the rebuild
            self.rebuilding = False
            self._notify_rebuild("aborted")
            return
        with self._rebuild_lock:
            # merge topics appended while the scan ran, then flip the
            # flag under the lock — store_batch's deferred path also
            # holds it, so no sighting can fall between list and census
            for shard, topic in self._rebuild_live:
                c = built.setdefault(shard, set())
                if c is not None:
                    c.add(topic)
                    if len(c) > _TOPIC_CENSUS_MAX:
                        built[shard] = None
            self._census = built
            self._rebuild_live = []
            self.rebuilding = False
        if maxts > self._max_ts_us:
            self._max_ts_us = maxts
        # the rebuilt census exists only in memory: the next metadata
        # flush folds it into the snapshot (broker-thread-serialized —
        # the worker never races the tick on the snapshot file)
        self._need_fold = True
        self._notify_rebuild("done")

    def rebuild_now(self) -> None:
        """Block until any in-flight background rebuild completes (the
        loop-less test/bench entry)."""
        t = self._rebuild_thread
        if t is not None and t.is_alive():
            t.join()

    def _notify_rebuild(self, event: str) -> None:
        evt = {
            "event": event,
            "path": self.directory,
            **self.rebuild_progress,
        }
        if self.on_rebuild is not None:
            self.on_rebuild(evt)
        else:
            self.rebuild_events.append(evt)

    # --------------------------------------------------- metadata flush

    def save_meta(self) -> None:
        """The metadata-flush cadence (broker tick / sync): O(delta) —
        append the pending census records + a watermark frame; fold
        into the snapshot only past the size threshold (or after a
        rebuild/boot replay made the journal redundant)."""
        if self.rebuilding:
            return  # incomplete census: no snapshot/watermark may
            # assert coverage until the scan lands
        if self._need_fold or self._journal.size() >= _FOLD_BYTES:
            self._fold_census()
            return
        if not self._jbuf and self._max_ts_us <= self._wm:
            return  # nothing new since the last flush
        recs = self._jbuf + [{"t": "wm", "ts": self._max_ts_us}]
        self._journal.append(recs, fsync=self.meta_fsync)
        self._jbuf = []
        self._wm = self._max_ts_us

    def _fold_census(self) -> None:
        """Compact the journal into the ``census.json`` snapshot (the
        ONE place the census snapshot is rewritten)."""
        self._journal.fold(
            self._census_path,
            {
                "n": self._total_count(),
                "wm": self._max_ts_us,
                "streams": {
                    str(k): (None if v is None else sorted(v))
                    for k, v in self._census.items()
                },
            },
            fsync=self.meta_fsync,
        )
        self._jbuf = []
        self._wm = self._max_ts_us
        self._need_fold = False

    def gc(self, cutoff_ts_us: int,
           pin_floor: Optional[int] = None) -> int:
        """Retention: reclaim segments wholly older than the cutoff,
        except generations at/above ``pin_floor`` (a live replay
        cursor's generation pin).  The census may now overstate topics
        (harmless: it only prunes when a topic is provably absent)."""
        return self._log.gc(cutoff_ts_us, pin_floor=pin_floor)

    def seg_for(self, stream: StreamRef, ts: int, seq: int) -> int:
        """Generation the cursor (stream, ts, seq) pins; -1 if
        exhausted."""
        return self._log.seg_for(stream.shard, ts, seq)

    def generation(self) -> int:
        return self._log.generation()

    def sync_data(self) -> None:
        self._log.sync()

    def save_meta_full(self) -> None:
        """Force a fold (shutdown / tests)."""
        if not self.rebuilding:
            self._fold_census()

    # sync() is the base composition: sync_data() + save_meta()

    def corruption_stats(self) -> Dict[str, int]:
        return {
            "corrupt_records": self._log.corrupt_records(),
            "quarantined_segments": self._log.quarantined_count(),
        }

    def stats(self) -> Dict[str, int]:
        return {
            "streams": len(self._log.streams()),
            "messages": sum(
                self._log.stream_count(s) for s in self._log.streams()
            ),
            **self.corruption_stats(),
        }

    def close(self) -> None:
        if self._log._h:  # idempotent: second close is a no-op
            if self.rebuilding:
                # abort the scan: folding a half-built census would
                # persist a snapshot that wrongly prunes — the next
                # open rebuilds instead
                self._rebuild_stop = True
                t = self._rebuild_thread
                if t is not None and t.is_alive():
                    t.join(timeout=5.0)
            if not self.rebuilding:
                self._fold_census()
            self._log.close()
