"""Learned-topic-structure (LTS) storage layout + bitmask keymapper.

The reference's storage moat is `emqx_ds_lts`
(EMQX apps/emqx_durable_storage/src/emqx_ds_lts.erl:100-143):
a trie learned from observed topics discovers which levels are
"wildcard-worthy" (high-variability — device ids, session ids), and
`emqx_ds_bitmask_keymapper.erl:20-70` composes storage keys from the
static topic structure, the varying-level hashes, and time, so replay
touches only the key ranges a filter can match.

Same idea, TPU-repo shape, on the native dslog engine:

  * LEARNING — a trie counts distinct children per level; a level
    whose branching exceeds ``var_threshold`` flips (stickily) to
    VARYING.  A topic's STRUCTURE is the topic with varying levels
    replaced by '+': ``vehicles/v123/sensors/temp`` under a varying
    level 1 has structure ``vehicles/+/sensors/temp``.
  * KEYMAPPER — the dslog stream id is the composite
    ``structure_id << VAR_BITS | crc32(varying words) & VAR_MASK``:
    one structure spreads over up to 2^VAR_BITS sub-streams keyed by
    its varying words, and (stream, ts) keys order records in time.
  * REPLAY — a CONCRETE filter maps to exactly one composite stream
    (structure + var hash).  A wildcard filter scans only the
    sub-streams of the structures it OVERLAPS — sub-linear in the
    total record count because non-matching structures are never
    touched, where the flat hash layout decodes and match-tests every
    record of a 2-level hash shard.

Structure evolution is append-only: when a level flips to varying,
records already written keep their old (concrete-structure) streams
and new writes use the '+' structure; replay consults every structure
overlapping the filter, so nothing is rewritten and nothing is lost.
"""

from __future__ import annotations

import os
import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .. import topic as T
from ..message import Message
from . import atomicio
from .api import (
    DurableStorage,
    IterRef,
    StreamRef,
    decode_message,
    encode_message,
)
from .journal import MetaJournal
from .native import DsLog

VAR_BITS = 12
VAR_MASK = (1 << VAR_BITS) - 1

# journal size that triggers a fold into the snapshots at the next
# metadata flush
_FOLD_BYTES = 256 * 1024


def _overlaps(fw: Sequence[str], pw: Sequence[str]) -> bool:
    """Can filter `fw` match any topic of structure `pw`?  Patterns
    contain only literals and '+' (never '#')."""
    i = 0
    while True:
        if i == len(fw):
            return i == len(pw)
        if fw[i] == "#":
            return True
        if i == len(pw):
            return False
        if fw[i] != "+" and pw[i] != "+" and fw[i] != pw[i]:
            return False
        i += 1


class LtsIndex:
    """The learned trie + structure registry + keymapper."""

    def __init__(self, var_threshold: int = 32) -> None:
        self.var_threshold = var_threshold
        self._root = self._node()
        self._sids: Dict[str, int] = {}  # pattern -> structure id
        self._patterns: List[str] = []   # sid -> pattern
        # fired with the pattern whenever a NEW structure id is
        # minted: the storage journals it IMMEDIATELY (one O(1) delta
        # frame, not a registry rewrite) — sids are baked into on-disk
        # stream keys, so the sid->pattern mapping must never be
        # reconstructed by re-learning (a rebuild after gc could
        # assign shifted ids and silently mis-prune replay)
        self.on_new_pattern = None

    @staticmethod
    def _node() -> Dict:
        return {"c": {}, "v": False, "p": None}

    def _sid(self, pattern: str) -> int:
        sid = self._sids.get(pattern)
        if sid is None:
            sid = self._sids[pattern] = len(self._patterns)
            self._patterns.append(pattern)
            if self.on_new_pattern is not None:
                self.on_new_pattern(pattern)
        return sid

    def seed_patterns(self, patterns: List[str]) -> None:
        """Adopt a persisted sid->pattern table (authoritative: ids
        must match the ones already baked into stream keys)."""
        self._patterns = list(patterns)
        self._sids = {p: i for i, p in enumerate(self._patterns)}

    def learn(self, words: Sequence[str]) -> Tuple[int, List[str]]:
        """Insert a topic; returns (structure id, varying words)."""
        node = self._root
        pattern: List[str] = []
        varw: List[str] = []
        for w in words:
            if not node["v"]:
                child = node["c"].get(w)
                if child is None:
                    if len(node["c"]) >= self.var_threshold:
                        # flip (sticky): this level is wildcard-worthy.
                        # Existing concrete children stay reachable as
                        # their OLD structures (append-only evolution);
                        # new descents merge under the '+' child.
                        node["v"] = True
                        node["p"] = self._node()
                        node["c"] = {}
                    else:
                        child = node["c"][w] = self._node()
            if node["v"]:
                pattern.append("+")
                varw.append(w)
                node = node["p"]
            else:
                pattern.append(w)
                node = node["c"][w]
        return self._sid("/".join(pattern)), varw

    def key_of(self, topic: str) -> int:
        sid, varw = self.learn(T.words(topic))
        vh = (
            zlib.crc32("/".join(varw).encode()) & VAR_MASK
            if varw else 0
        )
        return (sid << VAR_BITS) | vh

    def shards_for_filter(
        self, flt: str, present: Iterable[int]
    ) -> List[int]:
        """Composite streams that could hold matches for `flt` —
        concrete var words collapse a structure to ONE sub-stream."""
        fw = T.words(flt)
        present = sorted(set(present))
        by_sid: Dict[int, List[int]] = {}
        for shard in present:
            by_sid.setdefault(shard >> VAR_BITS, []).append(shard)
        out: List[int] = []
        for sid, shards in by_sid.items():
            if sid >= len(self._patterns):
                out.extend(shards)  # unknown structure: cannot prune
                continue
            pw = self._patterns[sid].split("/")
            if not _overlaps(fw, pw):
                continue
            varw: Optional[List[str]] = []
            for i, p in enumerate(pw):
                if p != "+":
                    continue
                # positions at/after a trailing '#' (or beyond the
                # filter, only reachable under one) are unconstrained
                if i >= len(fw) or fw[i] in ("+", "#"):
                    varw = None  # wildcard over a varying level
                    break
                varw.append(fw[i])
            if varw is None:
                out.extend(shards)
            else:
                vh = (
                    zlib.crc32("/".join(varw).encode()) & VAR_MASK
                    if varw else 0
                )
                key = (sid << VAR_BITS) | vh
                if key in shards:
                    out.append(key)
        return sorted(out)

    # --------------------------------------------------- persistence

    def to_json(self) -> Dict:
        return {
            "var_threshold": self.var_threshold,
            "patterns": self._patterns,
            "trie": self._root,
        }

    @classmethod
    def from_json(cls, obj: Dict) -> "LtsIndex":
        idx = cls(var_threshold=int(obj.get("var_threshold", 32)))
        idx._patterns = list(obj.get("patterns", ()))
        idx._sids = {p: i for i, p in enumerate(idx._patterns)}
        idx._root = obj.get("trie") or cls._node()
        return idx


class LtsStorage(DurableStorage):
    """dslog-backed storage with the LTS layout (drop-in sibling of
    builtin_local.LocalStorage; differential-tested against
    ds/reference.py)."""

    def __init__(
        self,
        directory: str,
        var_threshold: int = 32,
        seg_bytes: int = 0,
    ) -> None:
        self.directory = directory
        self.on_corruption = None
        self.corruption_events: List[Dict] = []
        self._log = DsLog(directory, seg_bytes=seg_bytes)
        ncorrupt = self._log.corrupt_records()
        if ncorrupt:
            self._report_corruption(
                "storage", directory,
                f"{ncorrupt} record(s) quarantined in "
                f"{self._log.quarantined_count()} segment(s)",
                records=ncorrupt,
            )
        self._index_path = os.path.join(directory, "lts_index.json")
        # the sid->pattern registry persists SEPARATELY from the trie
        # cache: stream keys embed sids, so this mapping is append-only
        # ground truth that must survive any crash/gc combination the
        # trie does not.  New patterns journal as O(1) delta frames
        # (the registry file itself is only rewritten by the fold)
        self._patterns_path = os.path.join(
            directory, "lts_patterns.json"
        )
        self._journal = MetaJournal(os.path.join(directory, "lts.journal"))
        self._wm = 0
        self._max_ts_us = 0
        self._need_fold = False
        self.index = self._load_index(var_threshold)
        self.index.on_new_pattern = self._journal_pattern

    # ----------------------------------------------------------- write

    def store_batch(
        self, msgs: Sequence[Message], sync: bool = False
    ) -> None:
        for msg in msgs:
            key = self.index.key_of(msg.topic)
            ts_us = int(msg.timestamp * 1e6)
            self._log.append(key, ts_us, encode_message(msg))
            if ts_us > self._max_ts_us:
                self._max_ts_us = ts_us
        if sync:
            self._log.sync()
            self.save_meta()

    def stream_key(self, topic: str) -> int:
        return self.index.key_of(topic)

    # ------------------------------------------------------------ read

    def get_streams(
        self, topic_filter: str, start_time_us: int = 0
    ) -> List[StreamRef]:
        shards = self.index.shards_for_filter(
            topic_filter, self._log.streams()
        )
        return [StreamRef(shard=s) for s in shards]

    def next(self, it: IterRef, n: int) -> Tuple[IterRef, List[Message]]:
        # the layout prunes WHICH streams are scanned; each record is
        # still filter-checked, so correctness never rests on the
        # learned structure being right
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

    # ------------------------------------------------------ lifecycle

    def _load_patterns(self) -> List[str]:
        """Missing = fresh dir; unreadable = alarm + empty seed.  The
        empty fallback is CONSERVATIVE for replay: an unknown sid can
        never be pruned (`shards_for_filter` serves every stream of an
        unregistered structure and `next` filter-checks each record),
        so corruption degrades to wider scans, not loss."""
        try:
            return list(atomicio.load_json(self._patterns_path))
        except FileNotFoundError:
            return []
        except atomicio.MetaCorruption as exc:
            self._report_corruption("meta", exc.path, exc.detail)
            return []
        except (TypeError, ValueError):
            self._report_corruption(
                "meta", self._patterns_path, "pattern registry not a list"
            )
            return []

    def _journal_pattern(self, pattern: str) -> None:
        """A new structure id was minted: journal it NOW (one delta
        frame) — the sid is about to be baked into stream keys, so it
        cannot wait for the flush cadence the trie cache rides."""
        self._journal.append(
            [{"t": "pattern", "p": pattern}], fsync=self.meta_fsync
        )

    def _load_index(self, var_threshold: int) -> LtsIndex:
        """Snapshot + journal replay + delta re-learn from the
        watermark (O(records since the last flush)).  Only a store
        with no usable watermark pays the full re-learn — which stays
        SYNCHRONOUS (unlike the hash census): the trie and the sid
        table feed `key_of` on the write path, so serving writes
        against a half-learned trie would mint unstable structures."""
        try:
            obj = atomicio.load_json(self._index_path)
        except FileNotFoundError:
            obj = None
        except atomicio.MetaCorruption as exc:
            # the trie is a cache over the log: re-learning (below) is
            # full recovery, but a torn index is still counted/alarmed
            self._report_corruption("meta", exc.path, exc.detail)
            obj = None
        jrecs, jdetail = self._journal.load()
        if jdetail:
            self._report_corruption("meta", self._journal.path, jdetail)
        patterns = self._load_patterns()
        if not patterns and obj is not None:
            # pre-registry data dir: the stale index's table is still
            # a better sid seed than renumbering from scratch
            patterns = list(obj["index"].get("patterns", ()))
        wm: Optional[int] = None
        if obj is not None and "wm" in obj:
            wm = int(obj["wm"])
        for r in jrecs:
            t = r.get("t")
            if t == "pattern":
                # minted after the registry was last folded; dedup
                # absorbs a crash between the fold's two writes
                if r["p"] not in patterns:
                    patterns.append(r["p"])
            elif t == "wm":
                ts = int(r["ts"])
                if wm is None or ts > wm:
                    wm = ts
        if obj is not None and wm is not None:
            idx = LtsIndex.from_json(obj["index"])
            if len(patterns) > len(idx._patterns):
                idx.seed_patterns(patterns)  # registry ran ahead
            maxts = wm
            for shard in self._log.streams():
                for ets, _seq, payload in self._log.scan(shard, wm):
                    idx.learn(T.words(decode_message(payload).topic))
                    if ets > maxts:
                        maxts = ets
            self._wm = wm
            self._max_ts_us = maxts
            if maxts > wm or jrecs:
                # compact what replay accumulated — and persist any
                # sid minted by the delta re-learn (deterministic
                # until then: a crash re-learns the identical tail)
                self._need_fold = True
            return idx
        if obj is not None and obj.get("count") == self._record_count():
            # legacy snapshot (no watermark anywhere): the old count
            # check — matching means the trie is complete
            idx = LtsIndex.from_json(obj["index"])
            if len(patterns) > len(idx._patterns):
                idx.seed_patterns(patterns)
            return idx
        # stale-legacy or absent: re-learn the TRIE from the log, but
        # seed sid assignments from the persisted registry first —
        # re-learning must never renumber structures whose ids are
        # baked into on-disk stream keys (post-gc, an early
        # structure's records may be gone entirely and a fresh
        # numbering would shift every later sid)
        idx = LtsIndex(var_threshold)
        if patterns:
            idx.seed_patterns(patterns)
        rebuilt = False
        maxts = 0
        for shard in self._log.streams():
            for ets, _seq, payload in self._log.scan(shard, 0):
                idx.learn(T.words(decode_message(payload).topic))
                rebuilt = True
                if ets > maxts:
                    maxts = ets
        self._max_ts_us = maxts
        if rebuilt or obj is not None:
            self.index = idx
            self._fold_index()
        return idx

    def _record_count(self) -> int:
        return sum(
            self._log.stream_count(s) for s in self._log.streams()
        )

    def _fold_index(self) -> None:
        """Compact journal + registry + trie snapshot (the ONE place
        the LTS sidecars are rewritten)."""
        self._journal.fold(
            self._index_path,
            {"count": self._record_count(),
             "wm": self._max_ts_us,
             "index": self.index.to_json()},
            fsync=self.meta_fsync,
            extra=[(self._patterns_path, self.index._patterns)],
        )
        self._wm = self._max_ts_us
        self._need_fold = False

    def gc(self, cutoff_ts_us: int,
           pin_floor: Optional[int] = None) -> int:
        return self._log.gc(cutoff_ts_us, pin_floor=pin_floor)

    def seg_for(self, stream: StreamRef, ts: int, seq: int) -> int:
        return self._log.seg_for(stream.shard, ts, seq)

    def generation(self) -> int:
        return self._log.generation()

    def sync_data(self) -> None:
        self._log.sync()

    def save_meta(self) -> None:
        """O(delta) metadata flush: a watermark frame (new patterns
        already journaled at mint time); fold only past the size
        threshold or when boot replay flagged a compaction."""
        if self._need_fold or self._journal.size() >= _FOLD_BYTES:
            self._fold_index()
            return
        if self._max_ts_us <= self._wm:
            return  # nothing new since the last flush
        self._journal.append(
            [{"t": "wm", "ts": self._max_ts_us}], fsync=self.meta_fsync
        )
        self._wm = self._max_ts_us

    def save_meta_full(self) -> None:
        self._fold_index()

    # sync() is the base composition: sync_data() + save_meta()

    def corruption_stats(self) -> Dict[str, int]:
        return {
            "corrupt_records": self._log.corrupt_records(),
            "quarantined_segments": self._log.quarantined_count(),
        }

    def stats(self) -> Dict[str, int]:
        n = self._record_count()
        return {
            "streams": len(self._log.streams()),
            "structures": len(self.index._patterns),
            "messages": n,
            "records": n,
            **self.corruption_stats(),
        }

    def close(self) -> None:
        if getattr(self, "_closed", False):
            return  # idempotent: server stop + explicit close both land
        self._closed = True
        try:
            self._fold_index()
        except OSError:
            pass
        self._log.close()
