"""Durable (persistent) sessions over the DS storage engine.

The `emqx_persistent_session_ds` + `emqx_persistent_message` slice
(EMQX apps/emqx/src/emqx_persistent_session_ds.erl,
emqx_persistent_message.erl:98-113): messages matching a persistent
session's subscriptions are persisted to DS, session metadata is
checkpointed on disconnect, and a reconnect after a broker restart
rebuilds the session and replays the missed interval from storage.

Division of labor with the in-memory session: while the broker stays
up, a detached session's messages queue in its mqueue (fast path).  DS
replay serves the case the mqueue cannot: the broker process restarted
and in-memory state is gone.  The persistence *gate* mirrors
emqx_persistent_message:persist/1 — a message is stored only when some
persistent session's filter matches it.

The gate matches on the host, through the package's own trie
(`ops.trie_native.NativeTrie`, or `trie_host.HostTrie` with
``native=False``), with the same refcounted filters: the match engine
launches on the card, and one launch per captured message is not a
gate.
"""

from __future__ import annotations

import hashlib
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

from .. import failpoints
from .. import topic as T
from ..message import Message
from ..ops.trie_native import make_trie
from . import atomicio
from .api import IterRef, StreamRef
from .builtin_local import LocalStorage
from .durability import GateGroup, SyncGate

log = logging.getLogger("emqx_tpu_torch.ds")


def rendezvous_pick(key: str, nodes: List[str], k: int = 1) -> List[str]:
    """Highest-random-weight hashing: a stable choice among ``nodes``
    that moves only the keys of a node that joined or left (the durable
    ``$share`` group's stream assignment)."""
    scored = sorted(
        nodes,
        key=lambda n: hashlib.blake2b(
            f"{key}\x00{n}".encode(), digest_size=8
        ).digest(),
        reverse=True,
    )
    return scored[:k]


def _stream_pkey(s: StreamRef) -> str:
    """Stable progress/rendezvous key for a stream: the bare in-store
    shard for store 0 (byte-compatible with pre-sharded progress
    files), ``store:shard`` otherwise — shard numbers repeat across
    stores, so the store index must disambiguate or two shards'
    progress would clobber each other."""
    return str(s.shard) if not s.store else f"{s.store}:{s.shard}"


class SessionState:
    """One checkpointed session (the state emqx_persistent_session_ds
    keeps in DS session tables)."""

    def __init__(
        self,
        clientid: str,
        subs: Dict[str, Dict],
        expiry: float,
        disconnected_at: float,
        iters: Optional[Dict[str, List[Dict]]] = None,
    ) -> None:
        self.clientid = clientid
        self.subs = subs  # filter -> SubOpts-as-dict
        self.expiry = expiry
        self.disconnected_at = disconnected_at
        # replay progress: filter -> list of IterRef json cursors.
        # None = replay not started; persisted mid-replay so a crash
        # resumes from the cursors instead of re-reading from
        # disconnected_at (the reference persists per-stream progress
        # the same way, emqx_persistent_session_ds_stream_scheduler).
        self.iters = iters
        # transient: message-id dedup across overlapping filters within
        # ONE replay run (lost on crash — replay is at-least-once)
        self._replay_seen: set = set()

    def expired(self, now: float) -> bool:
        return now - self.disconnected_at > self.expiry

    def to_json(self) -> Dict:
        out = {
            "clientid": self.clientid,
            "subs": self.subs,
            "expiry": self.expiry,
            "disconnected_at": self.disconnected_at,
        }
        if self.iters is not None:
            out["iters"] = self.iters
        return out

    @staticmethod
    def from_json(obj: Dict) -> "SessionState":
        return SessionState(
            clientid=obj["clientid"],
            subs=obj["subs"],
            expiry=obj["expiry"],
            disconnected_at=obj["disconnected_at"],
            iters=obj.get("iters"),
        )


class DurableSessions:
    def __init__(
        self,
        directory: str,
        n_streams: int = 16,
        store_qos0: bool = False,
        layout: str = "lts",
        fsync: str = "interval",
        n_shards: int = 1,
        native: bool = True,
    ) -> None:
        # durability mode (config `durable.fsync`): `never` = no
        # fsyncs, `interval` = periodic group flush off the broker
        # tick, `always` = group-commit — QoS>=1 acks for captured
        # messages park until the covering dslog_sync lands, ONE fsync
        # amortized per dispatch window.  Metadata sidecars fsync on
        # every write only in `always` (atomic replace + CRC apply in
        # every mode).
        self.fsync_mode = fsync
        self.meta_fsync = fsync == "always"
        # detected-corruption surface: events buffer here until the
        # broker wires `on_corruption` (alarm + counter); counts feed
        # sync_stats either way
        self.on_corruption = None
        self.corruption_events: List[Dict] = []
        self.corruption_counts = {"storage": 0, "meta": 0}
        msg_dir = os.path.join(directory, "messages")
        os.makedirs(msg_dir, exist_ok=True)
        # the layout is a property of the DATA: records written under
        # one keymapper are unreadable under another, so a directory
        # marker pins it and wins over a changed config (with a loud
        # log) instead of silently orphaning the history.  Pre-marker
        # directories (older builds) are the hash layout — their
        # census.json gives them away.
        marker = os.path.join(msg_dir, "LAYOUT")
        on_layout, on_shards = self._read_layout_marker(marker, msg_dir)
        if on_layout and on_layout != layout:
            log.warning(
                "durable layout pinned to %r by existing data "
                "(config asked for %r)", on_layout, layout,
            )
            layout = on_layout
        # the shard count is ALSO a property of the data: it decides
        # which shard directory a topic's records live in, so existing
        # data pins it the same way the keymapper layout is pinned
        if on_shards is not None and on_shards != n_shards:
            log.warning(
                "durable shard count pinned to %d by existing data "
                "(config asked for %d)", on_shards, n_shards,
            )
            n_shards = on_shards
        if on_layout is None:
            atomicio.atomic_write_json(
                marker,
                layout if n_shards == 1
                else {"layout": layout, "shards": n_shards},
                fsync=self.meta_fsync,
            )
        self.layout = layout
        self.n_shards = n_shards
        if n_shards > 1:
            from .sharded import ShardedStorage

            self.storage = ShardedStorage(
                msg_dir, n_shards=n_shards, layout=layout,
                n_streams=n_streams,
            )
        elif layout == "lts":
            from .lts import LtsStorage

            self.storage = LtsStorage(msg_dir)
        else:
            self.storage = LocalStorage(msg_dir, n_streams=n_streams)
        self.storage.meta_fsync = self.meta_fsync
        # adopt corruption the storage detected during ITS load, then
        # route everything after through our reporter
        for evt in self.storage.corruption_events:
            self._report_corruption(**evt)
        self.storage.corruption_events = []
        self.storage.on_corruption = (
            lambda evt: self._report_corruption(**evt)
        )
        # census-rebuild surface (the ds_meta_rebuild alarm): same
        # adoption shape — events buffer until the broker wires it
        self.on_rebuild = None
        self.rebuild_events: List[Dict] = []
        for evt in getattr(self.storage, "rebuild_events", ()):
            self._forward_rebuild(evt)
        if hasattr(self.storage, "rebuild_events"):
            self.storage.rebuild_events = []
        if hasattr(self.storage, "on_rebuild"):
            self.storage.on_rebuild = self._forward_rebuild
        # the group-commit fsync gate (see ds/durability.py): persist()
        # advances its watermark, the broker's dispatch loop parks acks
        # on it in `always` mode, the tick flushes through it in
        # `interval` mode — so every fsync is counted/attributed once.
        # Sharded: ONE gate per shard (independent append watermarks +
        # fsync barriers — the scaling point) fronted by a GateGroup
        # that keeps the broker's single-gate contract, including the
        # cross-shard ack barrier.
        if n_shards > 1:
            self._shard_gates: Optional[List[SyncGate]] = [
                SyncGate(st.sync_data) for st in self.storage.stores
            ]
            self.gate = GateGroup(self._shard_gates)
        else:
            self._shard_gates = None
            self.gate = SyncGate(self.storage.sync_data)
        self.state_dir = os.path.join(directory, "sessions")
        os.makedirs(self.state_dir, exist_ok=True)
        self.store_qos0 = store_qos0
        # persistence gate: filters of every persistent session (live or
        # detached), refcounted, matched on the host trie
        self._gate = make_trie(native)
        self._refs: Dict[str, int] = {}
        # detached states restored from disk at boot
        self._boot_states: Dict[str, SessionState] = {}
        # fired (with the clientid) when a boot checkpoint is dropped —
        # the broker uses it to retract the routes it advertised for
        # the detached session
        self.on_drop = None
        # grouped long-poll over the message log (the beamformer):
        # stores fire beams waking coherent parked readers
        from .beamformer import Beamformer

        self.beamformer = Beamformer(self.storage)
        # durable $share membership (the emqx_ds_shared_sub leader
        # state, persisted): stream assignment must see EVERY member —
        # detached, resumed, or mid-replay — regardless of liveness or
        # checkpoint presence
        self._share_members: Dict[str, List[str]] = {}
        self._share_path = os.path.join(directory, "share_members.json")
        # missing = fresh start; UNREADABLE = alarm + conservative
        # fallback — the persisted registry is gone, but
        # `shared_group_members` still unions every checkpointed
        # subscriber, so stream assignment degrades to the
        # checkpoint-derived membership instead of silently shrinking
        # to nobody
        obj = self._load_meta(self._share_path, "share membership")
        if obj is not None:
            try:
                self._share_members = {
                    k: list(v) for k, v in obj.items()
                }
            except (AttributeError, TypeError):
                self._report_corruption(
                    "meta", self._share_path, "not a members mapping"
                )
        # GROUP-level consumed progress per (share filter, stream):
        # the emqx_ds_shared_sub leader's per-stream offsets.  Replay
        # never re-reads below it, so membership churn (a member
        # leaving after consuming its share) cannot re-deliver the
        # consumed interval to the survivors.
        self._share_progress: Dict[str, Dict[str, List[int]]] = {}
        self._share_prog_path = os.path.join(
            directory, "share_progress.json"
        )
        # UNREADABLE progress falls back to empty — which means
        # "nothing consumed yet": replay restarts from disconnected_at,
        # strictly MORE redelivery (at-least-once), never loss — with
        # the alarm raised (the pre-PR silent `{}` reset looked
        # identical to a fresh directory)
        obj = self._load_meta(self._share_prog_path, "share progress")
        if isinstance(obj, dict):
            self._share_progress = obj
        elif obj is not None:
            self._report_corruption(
                "meta", self._share_prog_path, "not a progress mapping"
            )
        self._load_states()

    def boot_states(self) -> List[SessionState]:
        return list(self._boot_states.values())

    def has_checkpoint(self, clientid: str) -> bool:
        return clientid in self._boot_states

    # ---------------------------------------------------- meta/alarms

    def _report_corruption(self, kind: str, path: str, detail: str,
                           records: int = 0) -> None:
        """ONE funnel for every detected-corruption event (storage
        quarantine or unreadable sidecar): counted, logged, and either
        delivered to the broker's alarm wiring or buffered for it to
        drain after construction."""
        self.corruption_counts[kind] = (
            self.corruption_counts.get(kind, 0) + 1
        )
        log.error("ds %s corruption at %s: %s", kind, path, detail)
        evt = {"kind": kind, "path": path, "detail": detail}
        if records:
            evt["records"] = records
        if self.on_corruption is not None:
            self.on_corruption(evt)
        else:
            self.corruption_events.append(evt)

    def _forward_rebuild(self, evt: Dict) -> None:
        """Census-rebuild lifecycle events (start/done/aborted) flow
        to the broker's alarm wiring, or buffer until it exists."""
        log.warning(
            "ds census rebuild %s at %s (%d/%d streams)",
            evt.get("event"), evt.get("path"),
            evt.get("scanned", 0), evt.get("total", 0),
        )
        if self.on_rebuild is not None:
            self.on_rebuild(evt)
        else:
            self.rebuild_events.append(evt)

    def rebuild_now(self) -> None:
        """Block until any in-flight background census rebuild lands
        (tests/ctl)."""
        self.storage.rebuild_now()

    def _load_meta(self, path: str, what: str):
        """Load one sidecar: None for missing (fresh start) OR
        unreadable — but the unreadable case is alarmed first, so the
        conservative fallback is never silent."""
        try:
            return atomicio.load_json(path)
        except FileNotFoundError:
            return None
        except atomicio.MetaCorruption as exc:
            self._report_corruption("meta", exc.path, exc.detail)
            return None

    def _read_layout_marker(
        self, marker: str, msg_dir: str
    ) -> Tuple[Optional[str], Optional[int]]:
        """The LAYOUT pin as ``(layout, n_shards)``: legacy markers
        are the raw layout string or its checksummed document (both
        mean 1 shard — flat directory); sharded directories carry a
        ``{"layout": ..., "shards": N}`` document.  Garbage content is
        corruption — fall back to the pre-marker heuristic (a
        census.json means the flat hash layout) rather than pinning
        the directory to an unreadable value."""
        try:
            with open(marker) as f:
                raw = f.read()
        except OSError:
            if os.path.exists(os.path.join(msg_dir, "census.json")):
                return "hash", 1
            return None, None
        if raw.strip() in ("lts", "hash"):
            return raw.strip(), 1
        try:
            val = atomicio.loads_checked(raw, marker)
        except atomicio.MetaCorruption as exc:
            self._report_corruption("meta", exc.path, exc.detail)
            val = None
        if val in ("lts", "hash"):
            return val, 1
        if isinstance(val, dict) and val.get("layout") in ("lts", "hash"):
            try:
                shards = int(val.get("shards", 1))
            except (TypeError, ValueError):
                shards = 1
            return val["layout"], max(1, shards)
        if val is not None:
            self._report_corruption(
                "meta", marker, f"unknown layout {val!r}"
            )
        if os.path.exists(os.path.join(msg_dir, "census.json")):
            return "hash", 1
        return None, None

    # ------------------------------------------------------------ gate

    def add_filter(self, flt: str) -> None:
        n = self._refs.get(flt, 0)
        if n == 0:
            self._gate.insert(flt, flt)
        self._refs[flt] = n + 1

    def remove_filter(self, flt: str) -> None:
        n = self._refs.get(flt, 0)
        if n <= 1:
            self._refs.pop(flt, None)
            self._gate.delete_id(flt)
        else:
            self._refs[flt] = n - 1

    def persist(self, msgs: List[Message]) -> int:
        """Store messages a persistent session could need on resume."""
        batch = []
        for msg in msgs:
            if msg.sys or (msg.qos == 0 and not self.store_qos0):
                continue
            if self._gate.match(msg.topic):
                batch.append(msg)
        if batch:
            counts = self.storage.store_batch(batch)
            # advance the group-commit watermark: the broker's
            # dispatch barrier ("always" mode) parks this window's
            # acks until a flush covers it.  Sharded: each shard's OWN
            # gate is marked with that shard's count — the barrier
            # then only waits on shards this window actually touched.
            if self._shard_gates is not None and counts:
                for idx, n in counts.items():
                    self._shard_gates[idx].mark_appended(n)
            else:
                self.gate.mark_appended(len(batch))
            if self.beamformer.has_parked():
                self.beamformer.notify({
                    self.storage.stream_key(m.topic) for m in batch
                })
        return len(batch)

    # ------------------------------------------------------ checkpoints

    def _state_path(self, clientid: str) -> str:
        safe = hashlib.sha1(clientid.encode()).hexdigest()
        return os.path.join(self.state_dir, safe + ".json")

    def save(
        self,
        clientid: str,
        subs: Dict[str, object],
        expiry: float,
        now: Optional[float] = None,
    ) -> None:
        state = SessionState(
            clientid=clientid,
            subs={
                flt: opts.to_dict() if hasattr(opts, "to_dict") else dict(opts)
                for flt, opts in subs.items()
            },
            expiry=expiry,
            disconnected_at=now if now is not None else time.time(),
        )
        atomicio.atomic_write_json(
            self._state_path(clientid), state.to_json(),
            fsync=self.meta_fsync,
        )
        # group progress rides the checkpoint cadence (see
        # _advance_share_progress)
        self._flush_share_progress()

    def load(self, clientid: str) -> Optional[SessionState]:
        """Boot-restored state for a reconnecting client (None if the
        broker never restarted or no checkpoint exists/survives)."""
        state = self._boot_states.get(clientid)
        if state is not None and state.expired(time.time()):
            self.drop_checkpoint(clientid)
            return None
        return state

    def discard(self, clientid: str) -> None:
        self._boot_states.pop(clientid, None)
        try:
            os.unlink(self._state_path(clientid))
        except OSError:
            pass

    def drop_checkpoint(self, clientid: str) -> None:
        """Discard a boot checkpoint AND release the gate refs
        _load_states took for it (a plain discard leaks them when no
        live session inherits the filters)."""
        state = self._boot_states.get(clientid)
        if state is not None:
            self.remove_session_filters(state.subs, clientid)
            if self.on_drop is not None:
                self.on_drop(clientid)
        self.discard(clientid)

    def _load_states(self) -> None:
        for name in os.listdir(self.state_dir):
            if not name.endswith(".json"):
                continue
            path = os.path.join(self.state_dir, name)
            obj = self._load_meta(path, "session checkpoint")
            if obj is None:
                continue  # already alarmed (missing is impossible:
                # listdir just returned it)
            try:
                state = SessionState.from_json(obj)
            except (ValueError, KeyError, TypeError):
                # parseable-but-wrong schema: the checkpoint cannot be
                # trusted — alarm, never silently pretend it was absent
                self._report_corruption(
                    "meta", path, "checkpoint schema unreadable"
                )
                continue
            self._boot_states[state.clientid] = state
            for flt in state.subs:
                share = T.parse_share(flt)
                self.add_filter(share.topic if share else flt)

    def purge_expired(self, now: Optional[float] = None) -> List[str]:
        now = now if now is not None else time.time()
        dead = [
            cid
            for cid, st in self._boot_states.items()
            if st.expired(now)
        ]
        for cid in dead:
            self.drop_checkpoint(cid)
        return dead

    # ---------------------------------------------------------- replay

    def remove_session_filters(
        self, subs: Dict[str, object], clientid: Optional[str] = None
    ) -> None:
        """Drop a discarded/expired session's filters from the gate (and
        its checkpoint must be discarded separately).  $share filters
        release their REAL-topic ref (mirroring _load_states) and,
        when the clientid is known, leave the durable group — a ghost
        member would keep streams rendezvous-assigned to a session
        that can never replay them."""
        for flt in subs:
            share = T.parse_share(flt)
            self.remove_filter(share.topic if share else flt)
            if share is not None and clientid is not None:
                self.shared_leave(flt, clientid)

    def gc(self, cutoff_ts_us: int) -> int:
        """Retention pass over the message log, honoring GENERATION
        PINS: a detached session mid-replay pins, per shard, every
        generation at/after its replay cursor — GC reclaims only
        unpinned generations, so retention can never pull a segment
        out from under a resuming session's cursor (the property the
        pin suite tests).  Sessions whose replay has not STARTED have
        no cursors yet; they conservatively clamp the time cutoff to
        their disconnect instant instead."""
        floors, ts_floor = self._gc_pins()
        cutoff = cutoff_ts_us
        if ts_floor is not None and ts_floor < cutoff:
            cutoff = ts_floor
        return self.storage.gc_pinned(cutoff, floors)

    def _gc_pins(self) -> Tuple[Dict[int, int], Optional[int]]:
        """(per-store generation floors, time floor) derived from the
        boot states: a state with materialized cursors pins each
        cursor's generation (`seg_for`); one whose replay has not
        started pins by TIME (everything since its disconnect)."""
        floors: Dict[int, int] = {}
        ts_floor: Optional[int] = None
        for state in self._boot_states.values():
            if state.iters is None:
                t = int(state.disconnected_at * 1e6)
                if ts_floor is None or t < ts_floor:
                    ts_floor = t
                continue
            for cursors in state.iters.values():
                for cur in cursors:
                    it = IterRef.from_json(cur)
                    seg = self.storage.seg_for(
                        it.stream, it.ts, it.seq
                    )
                    if seg < 0:
                        continue  # exhausted: pins nothing
                    store = it.stream.store
                    if store not in floors or seg < floors[store]:
                        floors[store] = seg
        return floors, ts_floor

    def sync(self) -> None:
        """Full flush: group fsync (through the gate, so it is counted
        and releases any parked acks) + metadata checkpoint."""
        self.gate.sync_now()
        self.checkpoint_meta()

    def checkpoint_meta(self) -> None:
        """Metadata checkpoint cadence (the broker tick): storage
        caches (census / LTS index) + dirty share progress."""
        self.storage.save_meta()
        self._flush_share_progress()

    def sync_soon(self) -> None:
        """Interval-mode flush kick (asynchronous when a loop runs)."""
        self.gate.sync_soon()

    async def wait_durable(self) -> None:
        """The dispatch loop's group-commit barrier (`always` mode)."""
        await self.gate.wait_durable()

    def sync_stats(self) -> Dict:
        """The durability ops surface (/api/v5/nodes, ctl status,
        /metrics gauges): rolled-up totals, the census-rebuild gauge,
        and — sharded — a per-shard breakdown (each shard's own
        unsynced watermark, parked windows and quarantine counts)."""
        out = {"fsync": self.fsync_mode}
        out.update(self.gate.stats())
        out.update(self.storage.corruption_stats())
        out["meta_corruption"] = self.corruption_counts.get("meta", 0)
        out["shards"] = self.n_shards
        # numeric top-level fields so /metrics emits them as gauges
        out["meta_rebuild"] = 1 if self.storage.rebuilding else 0
        prog = self.storage.rebuild_progress
        out["meta_rebuild_scanned"] = prog.get("scanned", 0)
        out["meta_rebuild_total"] = prog.get("total", 0)
        if self._shard_gates is not None:
            rows = []
            for i, (g, st) in enumerate(
                zip(self._shard_gates, self.storage.stores)
            ):
                row = {"shard": i}
                row.update(g.stats())
                row.update(st.corruption_stats())
                rows.append(row)
            out["per_shard"] = rows
        return out

    def _save_share_members(self) -> None:
        atomicio.atomic_write_json(
            self._share_path, self._share_members,
            fsync=self.meta_fsync,
        )

    def shared_join(self, share_flt: str, clientid: str) -> None:
        members = self._share_members.setdefault(share_flt, [])
        if clientid not in members:
            members.append(clientid)
            self._save_share_members()

    def shared_leave(self, share_flt: str, clientid: str) -> None:
        members = self._share_members.get(share_flt)
        if members and clientid in members:
            members.remove(clientid)
            if not members:
                del self._share_members[share_flt]
            self._save_share_members()

    def _advance_share_progress(self, share_flt: str,
                                it: IterRef) -> None:
        """In-MEMORY only: the consumed interval lives in session
        mqueues until a checkpoint persists it, so the progress file
        is flushed together with checkpoints (`save`/`close`) — a
        crash mid-replay re-replays (at-least-once) instead of
        skipping undelivered messages (the broker.py replay-cursor
        invariant, applied group-wide)."""
        prog = self._share_progress.setdefault(share_flt, {})
        key = _stream_pkey(it.stream)
        cur = prog.get(key)
        if cur is None or (it.ts, it.seq) > (cur[0], cur[1]):
            prog[key] = [it.ts, it.seq]
            self._share_prog_dirty = True

    def _flush_share_progress(self) -> None:
        if not getattr(self, "_share_prog_dirty", False):
            return
        atomicio.atomic_write_json(
            self._share_prog_path, self._share_progress,
            fsync=self.meta_fsync,
        )
        self._share_prog_dirty = False

    def shared_group_members(self, share_flt: str) -> List[str]:
        """Members of this exact $share filter: the PERSISTED registry
        (survives restarts and stays stable across the whole replay
        sequence — a member leaving _boot_states on ITS resume must
        not shrink the assignment its peers derive), plus any
        checkpointed stragglers; sorted, so every member computes the
        same stream split."""
        members = set(self._share_members.get(share_flt, ()))
        for cid, st in self._boot_states.items():
            if share_flt in st.subs:
                members.add(cid)
        return sorted(members)

    def _replay_read(
        self, it: IterRef, n: int
    ) -> Tuple[IterRef, List[Message], bool]:
        """ONE storage read on the replay path — the ``ds.replay.read``
        failpoint seam (chaos: a DS read failing/stalling exactly when
        a reconnect storm replays millions of backlogs).  Returns
        ``(iterator, messages, ok)``:

          * ``error``/``panic`` raise out to the caller's recovery
            (the resume scheduler backs the session off and retries);
          * ``delay`` stalls the read (storm pacing under slow disk);
          * ``drop`` returns ``ok=False`` with the cursor UNCHANGED —
            a dropped read must never look like stream exhaustion, or
            replay would silently skip the interval behind it (QoS1
            loss); callers treat it like a budget stop and retry;
          * ``duplicate`` returns the batch with the PRE-read cursor,
            so the next read re-reads it — at-least-once duplication
            through the mid-dedup/inflight path.
        """
        if failpoints.enabled:
            act = failpoints.evaluate(
                "ds.replay.read",
                key=f"{it.stream.shard}:{it.topic_filter}",
            )
            if act == "drop":
                return it, [], False
            if act == "duplicate":
                _it2, msgs = self.storage.next(it, n)
                return it, msgs, True
        it2, msgs = self.storage.next(it, n)
        return it2, msgs, True

    def _ensure_iters(self, state: SessionState) -> None:
        """Lazily materialize the state's per-(filter, stream) replay
        cursors (shared by the scalar and windowed replay paths).
        Built into a LOCAL dict and assigned in one step: a storage
        fault midway must leave ``state.iters`` None, or the next call
        would skip the missing filters' whole intervals (loss)."""
        if state.iters is None:
            since_us = int(state.disconnected_at * 1e6)
            iters: Dict[str, List[Dict]] = {}
            for flt in state.subs:
                share = T.parse_share(flt)
                if share is None:
                    iters[flt] = [
                        self.storage.make_iterator(
                            s, flt, since_us
                        ).to_json()
                        for s in self.storage.get_streams(flt, since_us)
                    ]
                    continue
                # DURABLE SHARED SUBS (emqx_ds_shared_sub): the group's
                # offline interval replays EXACTLY ONCE across its
                # persistent members — each DS stream is assigned to
                # one member by rendezvous hash over the member set, so
                # every member independently derives the same split
                # without a live leader (the reference elects one;
                # deterministic assignment is this fs-backend's
                # equivalent)
                members = self.shared_group_members(flt)
                streams = [
                    s for s in self.storage.get_streams(
                        share.topic, since_us
                    )
                    if not members
                    or rendezvous_pick(
                        f"{share.group}:{_stream_pkey(s)}", members, 1
                    )[0] == state.clientid
                ]
                prog = self._share_progress.get(flt, {})
                its = []
                for s in streams:
                    it = self.storage.make_iterator(
                        s, share.topic, since_us
                    )
                    p = prog.get(_stream_pkey(s))
                    if p and (p[0], p[1]) > (it.ts, it.seq):
                        # group already consumed past here
                        it = IterRef(
                            stream=s, topic_filter=share.topic,
                            ts=p[0], seq=p[1],
                        )
                    its.append(it.to_json())
                iters[flt] = its
            state.iters = iters

    def replay_chunk(
        self, state: SessionState, max_msgs: int = 1024
    ) -> Tuple[List[Tuple[str, Message]], bool]:
        """Up to ``max_msgs`` messages persisted since the checkpoint,
        advancing the state's per-(filter, stream) iterator cursors.
        A caller that durably hands off each chunk may checkpoint the
        cursors between chunks (`save_state`) so a crash resumes
        mid-interval; a caller that only buffers in memory (the
        broker's resume path) must NOT, or a crash would skip the
        buffered chunk — chunking still bounds its replay memory.
        Returns ``(messages, done)``; message ids dedup across
        overlapping filters within one run (at-least-once across a
        crash)."""
        out, done, _nbytes, _err = self._replay_one(
            state, max_msgs, None
        )
        return out, done

    def _replay_one(
        self,
        state: SessionState,
        max_msgs: int,
        cache: Optional[Dict],
    ) -> Tuple[List[Tuple[str, Message]], bool, int,
               Optional[BaseException]]:
        """One session's replay round: the cursor walk shared by the
        scalar `replay_chunk` and the windowed `replay_chunk_many`.

        With ``cache`` (windowed mode) reads are a fixed 256 records
        and shared through it — sessions whose cursors sit at the same
        (stream, filter, position) cost ONE storage read, the
        mass-reconnect shape where thousands of sessions checkpointed
        at the same outage walk the same streams.  A chunk may then
        overshoot ``max_msgs`` by up to one read batch (cursors move
        batch-at-a-time; messages a read returned cannot be dropped
        once the cursor passed them).  Without a cache the reads size
        themselves to the remaining budget — `replay_chunk`'s exact
        legacy shape.  Message ORDER per session is identical either
        way: (filter, stream, record) order, which is what lets the
        windowed dispatch be property-tested bit-identical against
        the scalar resume wire.

        Returns ``(messages, done, payload_bytes_read, error)``:
        ``error`` is the exception of a read that FAULTED mid-round —
        the already-read prefix is still returned (its dedup/cursor
        state is committed and correct) and the faulted cursor is
        UNCHANGED, so the retry re-reads exactly the unread region.
        Raising past the mutations instead would poison the dedup
        set: the discarded prefix's mids would read as "seen" on
        retry, the cursor would skip them, and the interval would be
        silently lost.  `FailpointPanic` (process death) still flies
        — in-memory state dies with the process."""
        self._ensure_iters(state)
        seen = state._replay_seen
        out: List[Tuple[str, Message]] = []
        nbytes = 0
        for flt, cursors in state.iters.items():
            is_shared = T.parse_share(flt) is not None
            i = 0
            while i < len(cursors):
                it = IterRef.from_json(cursors[i])
                exhausted = False
                while len(out) < max_msgs:
                    try:
                        if cache is None:
                            it2, msgs, ok = self._replay_read(
                                it, min(256, max_msgs - len(out))
                            )
                            mids = mbytes = None
                        else:
                            ckey = (
                                it.stream.store, it.stream.shard,
                                it.topic_filter, it.ts, it.seq,
                            )
                            hit = cache.get(ckey)
                            if hit is None:
                                it2, msgs, ok = self._replay_read(
                                    it, 256
                                )
                                hit = cache[ckey] = (
                                    it2, msgs, ok,
                                    frozenset(m.mid for m in msgs),
                                    sum(
                                        len(m.payload) + len(m.topic)
                                        for m in msgs
                                    ),
                                )
                            it2, msgs, ok, mids, mbytes = hit
                    except Exception as exc:
                        # fault mid-round: commit the prefix, keep
                        # the cursor (see docstring) — never raise
                        # past the dedup/cursor mutations
                        cursors[i] = it.to_json()
                        return out, False, nbytes, exc
                    if not ok:
                        # dropped read (chaos): NOT exhaustion — keep
                        # the cursor and come back, or the interval
                        # behind it would be skipped
                        break
                    dup = it2.ts == it.ts and it2.seq == it.seq
                    it = it2
                    if not msgs:
                        exhausted = True
                        break
                    if mids is not None and seen.isdisjoint(mids):
                        # batch fast path (the mass-reconnect shape:
                        # thousands of sessions consuming the same
                        # cached batches): no overlap with this
                        # session's seen-set, so the whole batch
                        # appends in one C-speed extend
                        seen.update(mids)
                        out.extend((flt, m) for m in msgs)
                        nbytes += mbytes
                        continue
                    for msg in msgs:
                        if msg.mid not in seen:
                            seen.add(msg.mid)
                            out.append((flt, msg))
                            nbytes += len(msg.payload) + len(msg.topic)
                    if dup:
                        # duplicate-action read: cursor did not move;
                        # stop this cursor for the round so an armed
                        # unlimited duplicate cannot livelock the loop
                        break
                if is_shared:
                    # group progress: the interval up to this cursor is
                    # CONSUMED for the whole group — survivors must not
                    # re-read it after membership churn
                    self._advance_share_progress(flt, it)
                if exhausted:
                    cursors.pop(i)
                else:  # budget hit / blocked read: keep progress in
                    # memory, come back later
                    cursors[i] = it.to_json()
                    return out, False, nbytes, None
        state.iters = {f: c for f, c in state.iters.items() if c}
        return out, not any(state.iters.values()), nbytes, None

    def replay_chunk_many(
        self,
        states: List[SessionState],
        max_msgs: int = 1024,
        byte_budget: Optional[int] = None,
    ) -> Tuple[Dict[str, List[Tuple[str, Message]]], Dict[str, bool],
               int, Dict[str, str]]:
        """Windowed multi-session replay: one pass pulls up to
        ``max_msgs`` messages for EACH of ``states``, sharing storage
        reads across sessions whose cursors sit at the same (stream,
        filter, position) — the beamformer idea applied to resume:
        coherent readers are served by one sweep instead of one read
        cycle each.  ``byte_budget`` caps the total payload bytes one
        call pulls (the resume scheduler's per-round budget); sessions
        past the cap read nothing this round and simply go next round.

        Returns ``(chunks, done, bytes_read, errors)``: per-clientid
        message lists in exactly the order `replay_chunk` would
        produce them, per-clientid completion flags, the payload byte
        total, and per-clientid error strings for sessions whose read
        raised (failpoint or real IO fault) — an error on one
        session's stream must not abort the other thousand resumes in
        the window.  Cursor discipline is `replay_chunk`'s: cursors
        advance in MEMORY only; the caller checkpoints nothing until
        its window is durably handed off (a crash re-replays —
        at-least-once, never loss)."""
        cache: Dict = {}
        chunks: Dict[str, List[Tuple[str, Message]]] = {}
        done: Dict[str, bool] = {}
        errors: Dict[str, str] = {}
        total = 0
        for state in states:
            if byte_budget is not None and total >= byte_budget:
                break  # over budget: the rest go next round
            try:
                out, fin, nbytes, err = self._replay_one(
                    state, max_msgs, cache
                )
            except Exception as exc:
                # defensive only: read faults fail SOFT inside
                # _replay_one (partial prefix committed + returned);
                # panic (BaseException) flies
                errors[state.clientid] = repr(exc)
                continue
            chunks[state.clientid] = out
            done[state.clientid] = fin
            total += nbytes
            if err is not None:
                # partial round: the prefix in chunks[cid] is good and
                # MUST be delivered; the caller backs the session off
                # before the next read
                errors[state.clientid] = repr(err)
        return chunks, done, total, errors

    def save_state(self, state: SessionState) -> None:
        """Persist a state object as-is (mid-replay checkpoint)."""
        atomicio.atomic_write_json(
            self._state_path(state.clientid), state.to_json(),
            fsync=self.meta_fsync,
        )

    def replay(
        self, state: SessionState
    ) -> List[Tuple[str, Message]]:
        """Whole-interval replay (chunked under the hood)."""
        out: List[Tuple[str, Message]] = []
        while True:
            msgs, done = self.replay_chunk(state)
            out.extend(msgs)
            if done:
                return out

    def close(self) -> None:
        self._flush_share_progress()
        try:
            # clean shutdown leaves the log durable in every mode (a
            # mode says how much a POWER CUT may take, not a shutdown)
            self.gate.sync_now()
        except Exception:
            log.exception("final ds sync failed")
        self.gate.stop()
        self.storage.close()
