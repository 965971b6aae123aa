"""ctypes binding for the native dslog storage engine.

``emqx_tpu_torch/native/dslog.cpp`` (the format is described there) is
built with g++ at first use by `ops._native`, like the package's other
host libraries, into ``ops/build/``.  A build that fails raises
RuntimeError: there is no store without it.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

from .. import failpoints
from ..ops import _native


def load():
    """The bound dslog library, built at first use (raises RuntimeError
    when it does not build)."""
    return _native.load("dslog")


class DsLog:
    """Thin OO wrapper over the C ABI.

    The two write-side methods are the broker's deepest storage IO
    seams: ``ds.store.append`` and ``ds.store.sync`` (chaos: a disk
    failing/stalling/lying exactly under the durable hot path).  The
    class-level ``recorder`` hook is the crash-point simulation
    harness's tap (tools/crashsim): when set, every successful
    open/append/sync is journaled so any crash prefix of the write
    trace can be materialized and recovered (ALICE-style).
    """

    # crashsim write-trace tap (None in production: one attr test per op)
    recorder = None

    def __init__(self, directory: str, seg_bytes: int = 0) -> None:
        self._lib = load()
        os.makedirs(directory, exist_ok=True)
        self._dir = directory
        self._seg_bytes = seg_bytes
        self._h = self._lib.dslog_open(directory.encode(), seg_bytes)
        if not self._h:
            raise OSError(f"dslog_open failed for {directory}")
        if DsLog.recorder is not None:
            DsLog.recorder.on_open(directory, seg_bytes)

    def append(self, stream: int, ts: int, data: bytes) -> int:
        """Append one record; the ``ds.store.append`` failpoint seam.

        * ``error``/``panic`` raise (callers see the same OSError path
          a full disk produces);
        * ``delay`` stalls the write (slow disk);
        * ``drop`` silently loses the record (a lying disk whose write
          never lands — what the crash-recovery property suite guards
          the replay contract against);
        * ``duplicate`` appends the record twice under distinct seqs
          (replay-side mid dedup absorbs it: at-least-once).
        """
        if failpoints.enabled:
            act = failpoints.evaluate("ds.store.append", key=str(stream))
            if act == "drop":
                return 0
            if act == "duplicate":
                self._append_raw(stream, ts, data)
        return self._append_raw(stream, ts, data)

    def _append_raw(self, stream: int, ts: int, data: bytes) -> int:
        seq = self._lib.dslog_append(self._h, stream, ts, data, len(data))
        if seq < 0:
            raise OSError(f"dslog_append failed: {seq}")
        if DsLog.recorder is not None:
            DsLog.recorder.on_append(self._dir, stream, ts, seq, data)
        return seq

    def sync(self) -> None:
        """fsync the current segment; the ``ds.store.sync`` failpoint
        seam.  ``error`` exercises the group-commit gate's
        park-and-retry path (PUBACKs stay parked until a sync lands);
        ``drop`` skips the fsync while reporting success — the lying
        disk the crashsim harness models; ``duplicate`` fsyncs twice
        (idempotent)."""
        if failpoints.enabled:
            act = failpoints.evaluate("ds.store.sync", key=self._dir)
            if act == "drop":
                return
        rc = self._lib.dslog_sync(self._h)
        if rc != 0:
            raise OSError(f"dslog_sync failed: {rc}")
        if DsLog.recorder is not None:
            DsLog.recorder.on_sync(self._dir)

    def streams(self) -> list:
        cap = 1024
        while True:
            buf = (ctypes.c_uint32 * cap)()
            n = self._lib.dslog_streams(self._h, buf, cap)
            if n <= cap:
                return list(buf[: max(n, 0)])
            cap = n

    def stream_count(self, stream: int) -> int:
        return self._lib.dslog_stream_count(self._h, stream)

    def corrupt_records(self) -> int:
        """Estimated records in quarantined suffixes (interior CRC
        breaks the recovery preserved instead of serving)."""
        return self._lib.dslog_corrupt_records(self._h)

    def quarantined_count(self) -> int:
        return self._lib.dslog_quarantined_count(self._h)

    def gc(self, cutoff_ts: int, pin_floor: Optional[int] = None) -> int:
        """Reclaim whole segments older than cutoff_ts (microseconds);
        returns records dropped.  ``pin_floor`` is the lowest GENERATION
        (segment id) a live replay cursor still needs — generations at
        or above it survive whatever their age (None = nothing pinned).

        The ``ds.gc.reclaim`` failpoint seam: ``error``/``panic`` raise
        out to the retention pass's recovery (the pass fails loudly and
        reclaims nothing — data is never at risk from a gc fault);
        ``delay`` stalls the reclaim (slow unlink on a loaded disk);
        ``drop`` skips the pass silently (a gc that never runs: the
        store only GROWS, which retention monitoring must surface);
        ``duplicate`` runs it twice (idempotent — the second pass finds
        nothing to reclaim)."""
        if failpoints.enabled:
            act = failpoints.evaluate("ds.gc.reclaim", key=self._dir)
            if act == "drop":
                return 0
            if act == "duplicate":
                self._gc_raw(cutoff_ts, pin_floor)
        return self._gc_raw(cutoff_ts, pin_floor)

    def _gc_raw(self, cutoff_ts: int, pin_floor: Optional[int]) -> int:
        floor = 0xFFFFFFFF if pin_floor is None else pin_floor
        return self._lib.dslog_gc2(self._h, cutoff_ts, floor)

    def seg_for(self, stream: int, ts: int, seq: int) -> int:
        """Generation (segment id) of the first record of ``stream``
        strictly after cursor (ts, seq) — what a live replay cursor
        pins; -1 when the cursor is exhausted."""
        return self._lib.dslog_seg_for(self._h, stream, ts, seq)

    def generation(self) -> int:
        """The current generation (segment new appends land in)."""
        return self._lib.dslog_cur_seg(self._h)

    def scan(self, stream: int, ts_from: int):
        """Generator over (ts, seq, payload) from ts_from (inclusive)."""
        it = self._lib.dslog_iter_new(self._h, stream, ts_from)
        cap = 64 * 1024
        buf = ctypes.create_string_buffer(cap)
        ts = ctypes.c_uint64()
        seq = ctypes.c_uint64()
        try:
            while True:
                n = self._lib.dslog_iter_next(
                    it, buf, cap, ctypes.byref(ts), ctypes.byref(seq)
                )
                if n == 0:
                    return
                if n == -7:  # -E2BIG: grow and retry
                    cap *= 4
                    buf = ctypes.create_string_buffer(cap)
                    continue
                if n < 0:
                    raise OSError(f"dslog_iter_next failed: {n}")
                yield ts.value, seq.value, buf.raw[:n]
        finally:
            self._lib.dslog_iter_free(it)

    def close(self) -> None:
        if self._h:
            self._lib.dslog_close(self._h)
            self._h = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass
