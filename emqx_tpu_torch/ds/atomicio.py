"""Checksummed atomic metadata writes for the DS sidecar files.

Every JSON sidecar the durable-session stack keeps next to the message
log (session checkpoints, ``share_progress.json``/
``share_members.json``, the topic census, the LTS index/pattern
registry) used to be written with a bare ``open(path, "w")`` or a
tmp+``os.replace`` WITHOUT file/dir fsync or any integrity check — a
power failure could leave a torn file that the loader's
``except (OSError, JSONDecodeError): {}`` silently turned into "fresh
start", resetting replay progress and losing acked QoS1 backlogs with
no alarm.  This module is the one write path for all of them:

  * WRITE — serialize with a CRC32 trailer, write to ``<path>.tmp``,
    fsync the tmp file, ``os.replace`` it over the target, fsync the
    directory (the crash-consistency literature's full atomic-rename
    recipe: ALICE, Pillai et al. OSDI '14).  ``fsync=False`` keeps the
    atomicity + CRC (process-crash safety) but skips the two fsyncs —
    the ``never``/``interval`` durability modes' metadata discipline.
  * LOAD — parse and verify.  A missing file raises
    ``FileNotFoundError`` ("fresh start" — fine); anything unreadable
    (IO error, broken JSON, CRC mismatch, truncation) raises
    `MetaCorruption` so the caller can raise the ``ds_meta_corruption``
    alarm and fall back CONSERVATIVELY (replay from the checkpoint,
    at-least-once) — never a silent reset to ``{}``.

Wrapped format: ``{"__dsmeta__": 1, "crc": <crc32>, "data": <obj>}``
where the crc covers the compact-canonical dump of ``data``.  Legacy
raw-JSON files (pre-PR data dirs) still load: parse success without the
wrapper is accepted as-is (there is nothing to verify them against).

``atomic_write_json`` is the ``ds.meta.write`` failpoint seam: chaos
runs inject write faults, lost writes, and duplicate writes at every
metadata boundary in one place.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Any, List, Optional, Tuple

from .. import failpoints

_MAGIC = "__dsmeta__"


class MetaCorruption(RuntimeError):
    """A metadata sidecar exists but cannot be trusted (torn write,
    bit rot, garbage).  Deliberately NOT an OSError: the legacy
    ``except OSError`` blocks this module replaces must never swallow
    it back into a silent empty-state reset."""

    def __init__(self, path: str, detail: str) -> None:
        super().__init__(f"{path}: {detail}")
        self.path = path
        self.detail = detail


def _canonical(obj: Any) -> str:
    return json.dumps(obj, separators=(",", ":"))


def dumps_checked(obj: Any) -> str:
    """The wrapped on-disk document for ``obj``."""
    payload = _canonical(obj)
    crc = zlib.crc32(payload.encode())
    return '{"%s":1,"crc":%d,"data":%s}' % (_MAGIC, crc, payload)


# crashsim write-trace tap (tools/crashsim): records every completed
# metadata replace so crash prefixes can be materialized
recorder = None


def atomic_write_json(path: str, obj: Any, fsync: bool = True) -> None:
    """Atomically (and, with ``fsync``, durably) replace ``path`` with
    the checksummed document for ``obj``.

    The ``ds.meta.write`` failpoint seam: ``error``/``panic`` raise
    before anything is written (the old file survives untouched),
    ``delay`` stalls the write, ``drop`` silently loses it (the torn-
    power scenario where the rename never persisted — recovery sees
    the previous checkpoint: conservative, at-least-once), and
    ``duplicate`` performs the replace twice (idempotent)."""
    doc = dumps_checked(obj)
    act = None
    if failpoints.enabled:
        act = failpoints.evaluate("ds.meta.write", key=path)
        if act == "drop":
            return
    _replace(path, doc, fsync)
    if act == "duplicate":
        _replace(path, doc, fsync)
    if recorder is not None:
        recorder.on_meta(path, doc.encode(), fsync)


def _replace(path: str, doc: str, fsync: bool) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(doc)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        _fsync_dir(os.path.dirname(path) or ".")


def _fsync_dir(dirpath: str) -> None:
    try:
        dfd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return  # platform without directory opens: best effort
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def loads_checked(raw: str, path: str = "<mem>") -> Any:
    """Parse a sidecar document: verified wrapped format, or legacy
    raw JSON (accepted unverified).  Raises `MetaCorruption`."""
    try:
        obj = json.loads(raw)
    except (json.JSONDecodeError, UnicodeDecodeError) as exc:
        raise MetaCorruption(path, f"unparseable: {exc}") from exc
    if isinstance(obj, dict) and obj.get(_MAGIC) == 1:
        if "crc" not in obj or "data" not in obj:
            raise MetaCorruption(path, "wrapper missing crc/data")
        payload = _canonical(obj["data"])
        crc = zlib.crc32(payload.encode())
        if crc != obj["crc"]:
            raise MetaCorruption(
                path, f"crc mismatch (stored {obj['crc']}, computed {crc})"
            )
        return obj["data"]
    return obj  # legacy raw JSON: parseable = accepted


def load_json(path: str) -> Any:
    """Load a sidecar.  ``FileNotFoundError`` = missing (fresh start);
    `MetaCorruption` = present but unreadable — the caller MUST alarm
    and fall back conservatively, never silently reset."""
    try:
        with open(path) as f:
            raw = f.read()
    except FileNotFoundError:
        raise
    except OSError as exc:
        raise MetaCorruption(path, f"unreadable: {exc}") from exc
    return loads_checked(raw, path)


# ------------------------------------------------------ journal frames
#
# Binary frames for the incremental metadata journals (ds/journal.py):
# ``[u32 len][u32 crc32(payload)][payload]`` where payload is compact
# JSON.  Same discipline as the dslog record format: a frame whose
# damage reaches EOF is the torn tail of a crashed append (stop
# silently — the delta scan re-learns it); damage with intact bytes
# AFTER it is interior corruption (stop AND report — the suffix's
# records are lost, so recovery must widen to the snapshot watermark
# and the alarm must fire).

_FRAME_HDR = struct.Struct("<II")
_MAX_FRAME_LEN = 16 << 20


def pack_frame(obj: Any) -> bytes:
    """One journal frame for ``obj``."""
    payload = _canonical(obj).encode()
    return _FRAME_HDR.pack(len(payload), zlib.crc32(payload)) + payload


def iter_frames(
    blob: bytes, path: str = "<mem>"
) -> Tuple[List[Any], Optional[str]]:
    """Decode a journal: ``(records, corrupt_detail)``.  The record
    list is always the valid prefix; ``corrupt_detail`` is None for a
    clean read OR a torn tail (the normal crash artifact), and a
    description when the break is INTERIOR (bytes follow the damage —
    a once-valid suffix was flipped on disk and its records are gone:
    the caller must alarm and fall back conservatively)."""
    out: List[Any] = []
    off, total = 0, len(blob)
    while off + _FRAME_HDR.size <= total:
        ln, crc = _FRAME_HDR.unpack_from(blob, off)
        end = off + _FRAME_HDR.size + ln
        if ln > _MAX_FRAME_LEN:
            # implausible length: flipped header.  Bytes beyond the
            # bare header mean data followed it — interior corruption.
            if total - off > _FRAME_HDR.size:
                return out, f"{path}: frame length {ln} implausible"
            return out, None
        if end > total:
            return out, None  # extends past EOF: torn tail
        payload = blob[off + _FRAME_HDR.size:end]
        if zlib.crc32(payload) != crc:
            if end < total:
                return out, f"{path}: interior frame crc break at {off}"
            return out, None  # torn tail of the crashed append
        try:
            out.append(json.loads(payload.decode()))
        except (json.JSONDecodeError, UnicodeDecodeError) as exc:
            # crc passed but payload unparseable: the frame was
            # WRITTEN corrupt — never a crash artifact, always report
            return out, f"{path}: frame at {off} unparseable: {exc}"
        off = end
    if off < total:
        return out, None  # partial header at EOF: torn tail
    return out, None


def try_load_json(path: str, default: Any) -> Tuple[Any, str]:
    """``(value, status)`` where status is ``ok`` | ``missing`` |
    ``corrupt``; ``default`` is returned for the last two.  The caller
    still owns reporting the ``corrupt`` case."""
    try:
        return load_json(path), "ok"
    except FileNotFoundError:
        return default, "missing"
    except MetaCorruption:
        return default, "corrupt"
