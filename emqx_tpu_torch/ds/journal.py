"""Incremental metadata journal + fold (the O(delta) recovery core).

Census and LTS checkpoints used to be whole-file atomicio rewrites
whose cost grows with store size — and a store that crashed after its
last save paid a FULL log scan on the next open (12.7 s at 1M messages
vs 0.78 s for the segment-scan itself).  This module replaces both
with the classic journal + snapshot shape (the same recovery algebra
as the dslog segment log, applied to the metadata layer):

  * MUTATE — every metadata delta (a stream's first sighting of a
    topic, a census spill to opaque, a new LTS structure pattern) is
    an append-only RECORD in ``<sidecar>.journal``, written through
    checksummed binary frames (``atomicio.pack_frame``) — O(1) per
    delta, never O(store);
  * WATERMARK — a ``{"t": "wm", "ts": ...}`` record asserts "the
    snapshot plus every journal record before me covers the log up to
    ts" — recovery scans each stream only FROM the last watermark
    (learning is idempotent, so the overlap re-learns harmlessly);
  * FOLD — at idle/boot/close the snapshot is rewritten ONCE from the
    in-memory state (through ``atomicio.atomic_write_json``, the
    ``ds.meta.write`` seam) and the journal truncates.  The ordering
    makes a crash at ANY point idempotent: snapshot-then-truncate
    means a crash between the two leaves records in the journal that
    the snapshot already holds — replaying them is a no-op, and a
    re-fold produces the identical snapshot (property-tested).

Failure algebra mirrors the segment log: a torn journal TAIL is the
normal crash artifact (silently dropped — the watermark scan covers
it); an INTERIOR break means a once-valid suffix was flipped on disk —
its records are gone, so the loader reports corruption (alarm) and the
delta scan conservatively widens to the last watermark the valid
prefix asserts.

``MetaJournal.append`` is the ``ds.journal.append`` failpoint seam;
the fold's snapshot write rides the existing ``ds.meta.write`` seam.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Tuple

from .. import failpoints
from . import atomicio


class MetaJournal:
    """One append-only delta journal next to a metadata snapshot."""

    def __init__(self, path: str) -> None:
        self.path = path

    def size(self) -> int:
        """Journal byte size (the owner's fold trigger)."""
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    # ------------------------------------------------------- mutation

    def append(self, recs: List[Any], fsync: bool = False) -> None:
        """Append delta records as checksummed frames — the
        ``ds.journal.append`` failpoint seam:

          * ``error``/``panic`` raise out to the metadata flush (the
            tick logs it loudly; the deltas stay buffered in memory and
            the next flush retries — on a crash before one lands, the
            watermark scan re-learns them);
          * ``delay`` stalls the append (slow disk under the tick);
          * ``drop`` silently loses the frames (torn-power analogue:
            recovery must come out correct from the watermark scan —
            crash-suite-tested);
          * ``duplicate`` appends everything twice (replay is
            idempotent).
        """
        if not recs:
            return
        act = None
        if failpoints.enabled:
            act = failpoints.evaluate("ds.journal.append", key=self.path)
            if act == "drop":
                return
        blob = b"".join(atomicio.pack_frame(r) for r in recs)
        self._write(blob, fsync)
        if act == "duplicate":
            self._write(blob, fsync)
        rec = atomicio.recorder
        if rec is not None:
            on_jappend = getattr(rec, "on_jappend", None)
            if on_jappend is not None:
                on_jappend(self.path, blob)

    def _write(self, blob: bytes, fsync: bool) -> None:
        fresh = not os.path.exists(self.path)
        with open(self.path, "ab") as f:
            f.write(blob)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        if fresh and fsync:
            atomicio._fsync_dir(os.path.dirname(self.path) or ".")

    # ------------------------------------------------------- recovery

    def load(self) -> Tuple[List[Any], Optional[str]]:
        """``(records, corrupt_detail)`` — the valid record prefix
        plus None (clean or torn tail: the normal crash artifact) or a
        detail string (interior break: alarm + conservative
        fallback)."""
        try:
            with open(self.path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            return [], None
        except OSError as exc:
            return [], f"{self.path}: unreadable: {exc}"
        return atomicio.iter_frames(blob, self.path)

    # ----------------------------------------------------------- fold

    def fold(
        self,
        snapshot_path: str,
        obj: Any,
        fsync: bool = False,
        extra: Optional[List[Tuple[str, Any]]] = None,
    ) -> None:
        """Compact: write the full snapshot atomically (plus any
        ``extra`` companion snapshots — e.g. the LTS pattern registry
        folds together with its index), THEN truncate the journal.
        Crash-idempotent in every ordering a power cut can leave:
        old-snapshot+journal (nothing happened), new-snapshot+journal
        (replaying the journal over the new snapshot is a no-op —
        records are already folded in, and loaders dedup), or
        new-snapshot+empty (the completed fold)."""
        atomicio.atomic_write_json(snapshot_path, obj, fsync=fsync)
        for path, eobj in extra or ():
            atomicio.atomic_write_json(path, eobj, fsync=fsync)
        self.truncate(fsync)

    def truncate(self, fsync: bool = False) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "wb") as f:
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        rec = atomicio.recorder
        if rec is not None:
            on_jtrunc = getattr(rec, "on_jtrunc", None)
            if on_jtrunc is not None:
                on_jtrunc(self.path)
