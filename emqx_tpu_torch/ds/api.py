"""Durable storage API: the `emqx_ds` behavior surface.

Mirrors the reference's callback set (EMQX apps/
emqx_durable_storage/src/emqx_ds.erl:39-48 — store_batch, get_streams,
make_iterator, next; :255-261 behavior callbacks) with value-typed,
serializable iterators so persistent sessions can checkpoint replay
progress and resume after restart.

Stream partitioning is the bitfield-LTS idea reduced to its core
(emqx_ds_storage_bitfield_lts.erl / emqx_ds_lts.erl:100-143 learned
topic structure): a message's stream is a hash of its first topic
levels, and each backend tracks which concrete topics a stream holds so
`get_streams` can prune non-matching streams for concrete filters.
"""

from __future__ import annotations

import base64
import json
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .. import topic as T
from ..message import Message

# hash this many leading topic levels into the stream id
STREAM_LEVELS = 2


def stream_of(topic: str, n_streams: int) -> int:
    words = topic.split("/")[:STREAM_LEVELS]
    return zlib.crc32("/".join(words).encode()) % n_streams


def filter_streams(flt: str, n_streams: int) -> Optional[int]:
    """Stream that could hold matches for `flt`, or None = all streams
    (wildcard inside the hashed prefix)."""
    words = T.words(flt)[:STREAM_LEVELS]
    if any(w in ("+", "#") for w in words):
        return None
    if len(words) < STREAM_LEVELS:
        # filter shorter than the hashed prefix: only an exact topic of
        # the same depth hashes the same way; a trailing '#' widens it
        if not flt.endswith("#"):
            return zlib.crc32("/".join(words).encode()) % n_streams
        return None
    return zlib.crc32("/".join(words).encode()) % n_streams


@dataclass(frozen=True)
class StreamRef:
    """Opaque-but-serializable stream handle (emqx_ds stream).

    ``store`` addresses the physical shard in a sharded store (the
    index of the inner segment-log + SyncGate pair); the single-shard
    layouts leave it 0 and serialize without it, so checkpoints from
    pre-sharded data dirs load unchanged."""

    shard: int
    store: int = 0

    def to_json(self) -> Dict:
        if self.store:
            return {"shard": self.shard, "store": self.store}
        return {"shard": self.shard}

    @staticmethod
    def from_json(obj: Dict) -> "StreamRef":
        return StreamRef(shard=obj["shard"], store=obj.get("store", 0))


@dataclass(frozen=True)
class IterRef:
    """Value-typed iterator: replay cursor into one stream.  ``ts`` is
    in integer microseconds; (ts, seq) orders records totally."""

    stream: StreamRef
    topic_filter: str
    ts: int = 0
    seq: int = 0

    def to_json(self) -> Dict:
        return {
            "stream": self.stream.to_json(),
            "filter": self.topic_filter,
            "ts": self.ts,
            "seq": self.seq,
        }

    @staticmethod
    def from_json(obj: Dict) -> "IterRef":
        return IterRef(
            stream=StreamRef.from_json(obj["stream"]),
            topic_filter=obj["filter"],
            ts=obj["ts"],
            seq=obj["seq"],
        )


def encode_message(msg: Message) -> bytes:
    """Binary message record: length-prefixed topic/payload/meta, MQTT 5
    properties as JSON (bytes values b64-wrapped by the cluster codec
    convention)."""
    topic = msg.topic.encode()
    from_client = msg.from_client.encode()
    from_username = (msg.from_username or "").encode()
    props = json.dumps(
        _props_jsonable(msg.properties), separators=(",", ":")
    ).encode()
    flags = (
        (1 if msg.retain else 0)
        | (2 if msg.sys else 0)
        | (4 if msg.dup else 0)
        | (8 if msg.from_username is not None else 0)
    )
    return (
        struct.pack(
            ">BBdH",
            msg.qos,
            flags,
            msg.timestamp,
            len(topic),
        )
        + topic
        + struct.pack(">16s", msg.mid)
        + struct.pack(">H", len(from_client))
        + from_client
        + struct.pack(">H", len(from_username))
        + from_username
        + struct.pack(">I", len(props))
        + props
        + struct.pack(">I", len(msg.payload))
        + msg.payload
    )


def decode_message(data: bytes) -> Message:
    qos, flags, timestamp, tlen = struct.unpack_from(">BBdH", data, 0)
    off = 12
    topic = data[off : off + tlen].decode()
    off += tlen
    mid = struct.unpack_from(">16s", data, off)[0]
    off += 16
    (clen,) = struct.unpack_from(">H", data, off)
    off += 2
    from_client = data[off : off + clen].decode()
    off += clen
    (ulen,) = struct.unpack_from(">H", data, off)
    off += 2
    from_username = data[off : off + ulen].decode()
    off += ulen
    (plen,) = struct.unpack_from(">I", data, off)
    off += 4
    props = _props_restore(json.loads(data[off : off + plen].decode()))
    off += plen
    (paylen,) = struct.unpack_from(">I", data, off)
    off += 4
    payload = data[off : off + paylen]
    return Message(
        topic=topic,
        payload=payload,
        qos=qos,
        retain=bool(flags & 1),
        sys=bool(flags & 2),
        dup=bool(flags & 4),
        from_client=from_client,
        from_username=from_username if flags & 8 else None,
        mid=mid,
        timestamp=timestamp,
        properties=props,
    )


def _props_jsonable(props: Dict) -> Dict:
    """MQTT 5 properties JSON-safely: bytes values (correlation_data,
    authentication_data) wrap as {"$b64": ...}, user-property pairs as
    lists (the cluster codec's convention, which the record format
    shares)."""
    out: Dict = {}
    for k, v in props.items():
        if isinstance(v, (bytes, bytearray)):
            out[k] = {"$b64": base64.b64encode(bytes(v)).decode("ascii")}
        elif isinstance(v, list):
            out[k] = [list(p) if isinstance(p, tuple) else p for p in v]
        else:
            out[k] = v
    return out


def _props_restore(props: Dict) -> Dict:
    out: Dict = {}
    for k, v in props.items():
        if isinstance(v, dict) and set(v) == {"$b64"}:
            out[k] = base64.b64decode(v["$b64"].encode("ascii"))
        elif isinstance(v, list):
            out[k] = [tuple(p) if isinstance(p, list) else p for p in v]
        else:
            out[k] = v
    return out


class DurableStorage:
    # metadata sidecars fsync on every write only in the `always`
    # durability mode (DurableSessions sets this from durable.fsync);
    # atomic replace + CRC apply in every mode
    meta_fsync = False

    def stream_key(self, topic: str) -> int:
        """The write-side stream a topic maps to — the key layer
        callers (the beamformer's store-notify) must share with
        `store_batch`.  Layouts override; the default is the 2-level
        hash partitioning."""
        return stream_of(topic, getattr(self, "n_streams", 16))

    def _report_corruption(self, kind: str, path: str, detail: str,
                           records: int = 0) -> None:
        """Surface detected corruption (never swallow it): through
        ``on_corruption`` when the owner wired one, else buffered in
        ``corruption_events`` for the owner to drain after
        construction (loads run inside ``__init__``, before any
        callback can exist).  ``kind`` is ``storage`` (quarantined log
        records) or ``meta`` (unreadable sidecar)."""
        evt = {"kind": kind, "path": path, "detail": detail}
        if records:
            evt["records"] = records
        cb = getattr(self, "on_corruption", None)
        if cb is not None:
            cb(evt)
        else:
            self.corruption_events.append(evt)

    """Backend behavior (emqx_ds.erl:255-261 callback set)."""

    def store_batch(
        self, msgs: Sequence[Message], sync: bool = False
    ) -> None:
        raise NotImplementedError

    def get_streams(
        self, topic_filter: str, start_time_us: int = 0
    ) -> List[StreamRef]:
        raise NotImplementedError

    def make_iterator(
        self, stream: StreamRef, topic_filter: str, start_time_us: int = 0
    ) -> IterRef:
        return IterRef(
            stream=stream, topic_filter=topic_filter, ts=start_time_us
        )

    def next(
        self, it: IterRef, n: int
    ) -> Tuple[IterRef, List[Message]]:
        raise NotImplementedError

    def sync_data(self) -> None:
        """fsync the message log ONLY — the group-commit gate's flush
        (metadata checkpoints ride their own cadence via
        `save_meta`).  In-memory backends no-op."""

    def save_meta(self) -> None:
        """Checkpoint the layout's metadata caches (atomic + CRC; no
        fsync unless ``meta_fsync``)."""

    def sync(self) -> None:
        self.sync_data()
        self.save_meta()

    def save_meta_full(self) -> None:
        """Force a full metadata compaction (journal fold) where the
        layout keeps incremental metadata; plain checkpoint
        otherwise."""
        self.save_meta()

    def gc(self, cutoff_ts_us: int,
           pin_floor: Optional[int] = None) -> int:
        """Reclaim records older than the cutoff; generations at/above
        ``pin_floor`` survive (a replay cursor pins them).  In-memory
        backends no-op."""
        return 0

    def gc_pinned(self, cutoff_ts_us: int,
                  floors: Dict[int, int]) -> int:
        """Retention with per-shard generation pins (``floors``: store
        index -> lowest pinned generation).  Single-store backends use
        store 0's floor; sharded storage overrides."""
        return self.gc(cutoff_ts_us, pin_floor=floors.get(0))

    def seg_for(self, stream: StreamRef, ts: int, seq: int) -> int:
        """Generation the replay cursor (stream, ts, seq) pins; -1 if
        exhausted (or the backend has no generations)."""
        return -1

    def generation(self) -> int:
        """Current write generation (0 for ungenerational backends)."""
        return 0

    # ---------------------------------------------- census rebuild
    # surface (layouts that background their metadata rebuild
    # override; everything else reports "not rebuilding")

    rebuilding = False
    rebuild_progress = {"scanned": 0, "total": 0}

    def rebuild_now(self) -> None:
        """Block until any in-flight background metadata rebuild
        completes."""

    def corruption_stats(self) -> Dict[str, int]:
        return {"corrupt_records": 0, "quarantined_segments": 0}

    def close(self) -> None:
        pass
