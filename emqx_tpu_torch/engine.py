"""MatchEngine: the subscription-matching core on the GPU.

Exact (non-wildcard) filters live in a host hash map; wildcard filters
in a trie automaton (`ops.automaton`) whose tables sit on the device
and are batch-matched by the hand-written kernels in
`ops.match_kernel`.  Subscription churn lands in host tiers
immediately (correct from the next match on) and reaches the device in
two steps, as in the JAX package's engine:

  * the delta since the last base build folds into a second, small
    automaton (the delta automaton), matched by the same kernel next to
    the base in every window.  A fold runs once the residual (inserts
    since the last fold, matched on the host trie through a watermark
    view) reaches ``max(delta_aut_threshold, |delta| /
    delta_fold_factor)``; its encode, assemble and upload run in a
    daemon thread, and adopting it is a watermark bump.
  * once the delta reaches ``rebuild_threshold`` the base is rebuilt:
    synchronously, or with ``background_rebuild`` in a builder thread
    while windows go on matching the old base, swapped in by the next
    mutation or window (`_poll_swap`).  Both re-encode only the delta
    into a cached encode arena (`_EncArena`).

Deletions mask stale device results by fid, per automaton generation.
Both threads upload their tables on a side stream of the card
(`state.put_arrays`) and synchronise it before they publish them.

Any topic the kernel flags (frontier overflow, match-cap overflow) is
re-matched on the host trie, so results are exact whatever the kernel
capacity bounds.  A device error propagates: there is no host
fallback.  An error in the fold or builder thread is kept and raised
once on the caller's thread by the next `insert`, `insert_many`,
`delete`, `rebuild` or `match_batch_submit` (before it changes
anything); the engine goes on serving from the host tiers and the
tables it has.

The rule engine's WHERE matrix runs on the same device, through the
engine's `rules_evaluator` (`rules.evaluator.RulesEvaluator`).

``device="cuda"`` (the default) runs the kernels and raises without a
card; ``device="cpu"`` runs their plain PyTorch versions.

The host path is C++ by default (``native=True``): the host tries
(`ops.trie_native.NativeTrie`), the window's topic encode (a row
cache whose misses go through `TokenDict.native`) and the automaton
build's filter encode and sorts.  The libraries build at construction
and a failed build raises; ``native=False`` runs the Python referees
(`ops.trie_host.HostTrie`, `ops.dictionary.encode_topics`, numpy's
sorts) with the same results.

``profiler`` (an `observability.Profiler`, set by the broker) receives
the window's ``tokenize`` stage — the split, row encode and dedup
before the launches — and ``rebuild``, ``delta_fold`` and ``upload``
events, the last with the bytes the tables put on the device.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Hashable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from . import topic as T
from .ops import _native
from .ops.automaton import (
    Automaton, assemble_automaton, expand_codes_dedup, expand_codes_flat,
)
from .ops.dictionary import PAD_TOK, SENTINEL, TokenDict, encode_filter, \
    encode_topics
from .ops.match_kernel import (
    decide_packed, match_batch, match_batch_compact, pack_opts,
)
from .ops.trie_native import make_trie
from .rules.evaluator import RulesEvaluator
from .state import (
    DeviceTables, HostStage, UploadStreams, resolve_device,
    tables_from_reference,
)
from .tp import tp


def _pad_batch(tokens, lengths, dollar):
    """Pad the batch to a power-of-two bucket (at least 16 rows):
    padded rows have length 0, ``dollar`` set and the pad token, so
    they match nothing."""
    b = tokens.shape[0]
    bp = 16
    while bp < b:
        bp *= 2
    if bp != b:
        pad = bp - b
        tokens = np.pad(tokens, ((0, pad), (0, 0)), constant_values=PAD_TOK)
        lengths = np.pad(lengths, (0, pad))  # length 0 => inert row
        dollar = np.pad(dollar, (0, pad), constant_values=True)
    return tokens, lengths, dollar


def _pad_nodes_pow2(aut: Automaton, minimum: int = 16) -> None:
    """Pad the node table to a power-of-two capacity class.  Padded
    rows are inert (no '+' child, no terminal flags) and unreachable
    (no edges point at them)."""
    n = aut.node_rows.shape[0]
    cap = minimum
    while cap < n:
        cap *= 2
    if cap != n:
        pad = np.zeros((cap - n, 8), np.int32)
        pad[:, 0] = int(SENTINEL)
        pad[:, 4] = -1  # no incoming edge: verification-dead
        pad[:, 5] = -1
        aut.node_rows = np.concatenate([aut.node_rows, pad])


def _validate_filter(flt: str):
    """Split + validate + wildcard classification: every '+'/'#' must
    be a WHOLE level and the single '#' the last level.  Returns
    ``(words, is_wildcard, n_hash)``; raises before any mutation."""
    ws = tuple(flt.split("/"))
    if (
        not flt
        or "\x00" in flt
        or len(flt) > 65535
        or (len(flt) > 16383 and len(flt.encode()) > 65535)
    ):
        raise ValueError(f"invalid topic filter: {flt!r}")
    n_hash = flt.count("#")
    n_plus = flt.count("+")
    wild = bool(n_hash or n_plus)
    if wild:
        if n_plus != ws.count("+"):
            raise ValueError(f"wildcard not a whole level: {flt!r}")
        if n_hash:
            if n_hash != 1 or ws[-1] != "#":
                raise ValueError(f"'#' not a whole last level: {flt!r}")
    return ws, wild, n_hash


def make_fid_arr(fids: List[Hashable]) -> np.ndarray:
    """Position -> fid: int64 when every fid is an int, else object."""
    if fids and all(type(f) is int for f in fids):
        return np.array(fids, np.int64)
    arr = np.empty(len(fids), object)
    arr[:] = fids
    return arr


class _EncArena:
    """Append-only encode arena: the incremental build cache.

    Row arrays (token matrix, body length, hash flag, fid) grow by
    doubling, copied in chunks with GIL yields; a deleted or superseded
    filter's row is dead-marked (``blen = -1``; ``blen == 0`` is a live
    bare '#' filter, and `assemble_automaton` keeps rows with ``blen >=
    0``) rather than compacted, so applying a delta is O(delta) with no
    full-array copies.  Row positions are stable for the arena's
    lifetime, so a live automaton's ``code_idx`` and fid views stay
    valid while later generations append; a sweep (`_compact`) rebuilds
    the arena into fresh arrays once half its rows are dead.

    Single writer: whichever thread holds the engine's ``_enc_lock``
    mutates it; matching never touches it.  ``native`` encodes through
    `TokenDict.encode_filters_into` (at every size), else through the
    Python `encode_filter`, with the same token ids."""

    __slots__ = ("max_levels", "native", "mat", "blen", "ish", "flist",
                 "fids", "rows", "dead")

    def __init__(self, max_levels: int, native: bool = True,
                 cap: int = 1024) -> None:
        self.max_levels = max_levels
        self.native = native
        self.mat = np.full((cap, max_levels), PAD_TOK, np.int32)
        self.blen = np.zeros(cap, np.int32)
        self.ish = np.zeros(cap, bool)
        self.flist: List[Tuple[Hashable, Tuple[str, ...]]] = []
        self.fids = np.zeros(cap, np.int64)
        self.rows: Dict[Hashable, int] = {}  # live fid -> row
        self.dead = 0

    @property
    def used(self) -> int:
        return len(self.flist)

    def _grow(self, need: int) -> None:
        cap = len(self.blen)
        while cap < need:
            cap *= 2
        if cap == len(self.blen):
            return
        mat = np.full((cap, self.max_levels), PAD_TOK, np.int32)
        # chunked copy with yields: one big memcpy holds the GIL
        step = 1 << 16
        for i in range(0, self.used, step):
            j = min(i + step, self.used)
            mat[i:j] = self.mat[i:j]
            time.sleep(0)
        self.mat = mat
        self.blen = np.resize(self.blen, cap)
        self.ish = np.resize(self.ish, cap)
        if self.fids.dtype == object:
            f2 = np.empty(cap, object)
            f2[: self.used] = self.fids[: self.used]
            self.fids = f2
        else:
            self.fids = np.resize(self.fids, cap)

    def _set_fid(self, row: int, fid: Hashable) -> None:
        if self.fids.dtype != object and type(fid) is not int:
            obj = np.empty(len(self.fids), object)
            obj[: self.used] = self.fids[: self.used].tolist()
            self.fids = obj
        self.fids[row] = fid

    def apply(self, items, dropped_fids, tdict: TokenDict) -> None:
        """Dead-mark ``dropped_fids`` and the rows ``items`` supersede,
        then encode and append ``items`` (``(fid, words)`` pairs).
        Yields the GIL every 1,024 rows: this runs in the builder and
        fold threads, beside the insert thread and the event loop."""
        for fid in dropped_fids:
            r = self.rows.pop(fid, None)
            if r is not None:
                self.blen[r] = -1  # dead marker (0 = live bare '#')
                self.dead += 1
        n_items = len(items)
        self._grow(self.used + n_items)
        u0 = self.used
        if self.native and n_items:
            tdict.encode_filters_into(
                items, self.max_levels, self.mat[u0:u0 + n_items],
                self.blen[u0:u0 + n_items], self.ish[u0:u0 + n_items])
        for n, (fid, ws) in enumerate(items, 1):
            r = self.rows.get(fid)
            if r is not None:  # a re-insert supersedes the old row
                self.blen[r] = -1
                self.dead += 1
            row = self.used
            if not self.native:
                body, hsh = encode_filter(tdict, ws)
                if len(body) > self.max_levels:
                    raise ValueError(
                        f"filter deeper than max_levels="
                        f"{self.max_levels}: {ws}")
                self.mat[row, : len(body)] = body
                self.blen[row] = len(body)
                self.ish[row] = hsh
            self._set_fid(row, fid)
            self.flist.append((fid, ws))
            self.rows[fid] = row
            if n % 1024 == 0:
                time.sleep(0)  # let the insert thread breathe
        if self.dead > max(self.used // 2, 4096):
            self._compact(tdict)

    def _compact(self, tdict: TokenDict) -> None:
        """Dead-row sweep (amortised by the 50% trigger): rebuilds the
        arena from its live rows into fresh arrays, so sustained churn
        cannot grow it without bound and live views stay intact."""
        live = sorted(self.rows.items(), key=lambda kv: kv[1])
        fresh = _EncArena(self.max_levels, self.native,
                          cap=max(len(live) * 2, 1024))
        fresh.apply([(fid, self.flist[r][1]) for fid, r in live], (), tdict)
        for name in ("mat", "blen", "ish", "flist", "fids", "rows"):
            setattr(self, name, getattr(fresh, name))
        self.dead = 0

    def views(self):
        """``(mat, blen, ish, flist)`` for `assemble_automaton`,
        zero-copy; positions align with `fid_view`."""
        u = self.used
        return self.mat[:u], self.blen[:u], self.ish[:u], self.flist

    def fid_view(self) -> np.ndarray:
        """Position -> fid for the current used span (valid as later
        generations append: a capacity doubling leaves its buffer
        intact)."""
        return self.fids[: self.used]


class _ResidualView:
    """Read view of "wildcard filters inserted after the fold
    watermark", backed by the seq-tagged `_wild` trie.  ``len`` is the
    skip check and reports the seq-span upper bound, which only inserts
    advance: a fold adopted mid-window moves the engine's watermark,
    but entries between this view's watermark and the new one are only
    in the NEW delta automaton, not in this window's snapshot."""

    __slots__ = ("_wild", "_min_seq")

    def __init__(self, wild, watermark: int) -> None:
        self._wild = wild
        self._min_seq = watermark + 1

    def __len__(self) -> int:
        return max(self._wild.last_seq() - self._min_seq + 1, 0)

    def match_words(self, ws) -> Set[Hashable]:
        return self._wild.match_since_words(ws, self._min_seq)


class MatchEngine:
    """Mutable filter set with batched matching on ``device``."""

    def __init__(
        self,
        max_levels: int = 16,
        f_width: int = 8,
        m_cap: int = 128,
        rebuild_threshold: int = 4096,
        device="cuda",
        native: bool = True,
        background_rebuild: bool = False,
        delta_aut_threshold: int = 1024,
        delta_fold_factor: int = 2,
    ) -> None:
        self.device = resolve_device(device)
        self.native = native
        if native:
            _native.load_all()  # raises when a library does not build
        self.max_levels = max_levels
        self.f_width = f_width
        self.m_cap = m_cap
        self.rebuild_threshold = rebuild_threshold
        self.background_rebuild = background_rebuild
        # the broker's overload ladder may set this: a truthy return
        # defers starting a background rebuild (the delta tiers keep the
        # results exact); called with the engine's locks held
        self.defer_rebuild = None
        self.delta_aut_threshold = delta_aut_threshold
        # fold when the residual reaches |delta| / factor
        self.delta_fold_factor = delta_fold_factor
        self.profiler = None  # an observability.Profiler, or None
        self._exact: Dict[str, Set[Hashable]] = {}
        # every wildcard filter: oracle + build source
        self._wild = make_trie(native)
        # wildcard filters added since the last base build: fid -> words
        self._delta: Dict[Hashable, Tuple[str, ...]] = {}
        self._deep = make_trie(native)  # filters deeper than max_levels
        self._by_fid: Dict[Hashable, str] = {}
        # per-generation tombstones: a delete masks the fid in the
        # snapshot(s) that still carry its stale entry; folds and
        # rebuilds REPLACE these sets (never mutate them in place), so
        # an in-flight window's snapshot stays consistent
        self._deleted_base: Set[Hashable] = set()
        self._deleted_daut: Set[Hashable] = set()
        self._tdict = TokenDict()
        # kernel levels -> [words -> row, token rows, lengths, dollar
        # flags, rows used]: the window encode's row cache, dropped
        # whenever the dictionary grows (a word unknown when a row was
        # encoded may be a filter literal now)
        self._enc_cache: Dict[int, list] = {}
        self._enc_gen = 0
        # the base automaton, its tables, position -> fid, live filters
        self._aut: Optional[Automaton] = None
        self._tables: Optional[DeviceTables] = None
        self._fid_arr: Optional[np.ndarray] = None
        self._n_base = 0
        self._build_cache = None  # the base builds' encode arena
        # the delta automaton (the same triple) and its encode arena
        self._daut: Optional[Automaton] = None
        self._dtables: Optional[DeviceTables] = None
        self._dfid_arr: Optional[np.ndarray] = None
        self._daut_fids: Set[Hashable] = set()
        self._fold_cache: Optional[_EncArena] = None
        # sticky capacity classes of the delta automaton (never shrink),
        # so its tables equal the JAX package's
        self._fold_min_nodes = 4096
        self._fold_min_buckets = 2048
        # the residual is the view "seq > _fold_watermark" of `_wild`:
        # adopting a fold is one watermark bump
        self._fold_watermark = 0
        self._residual_count = 0
        # (fid, seq) of inserts past the watermark: the fold's work list
        self._residual_log: List[Tuple[Hashable, int]] = []
        self._delta_seq: Dict[Hashable, int] = {}  # fid -> latest seq
        self._folding = False
        self._fold_async = True  # tests pin False for deterministic folds
        # bumped by every base swap and rebuild: a fold whose inputs
        # predate the new base is discarded at adoption
        self._fold_gen = 0
        self._fold_thread: Optional[threading.Thread] = None
        self._fold_deletes: Set[Hashable] = set()
        # background rebuild: the builder hands `_built` over under
        # `_lock`; `_poll_swap` adopts it
        self._lock = threading.Lock()
        # serializes mutation vs the snapshot/overlay phases of a match
        # running on another thread; the kernels run outside it
        self._mlock = threading.RLock()
        # serializes the dictionary's growth (arena encodes in the
        # builder and fold threads) with the window encode's lookups
        # and the row cache
        self._enc_lock = threading.Lock()
        self._building = False
        self._rebuild_snap_seq = 0  # `_wild` seq at the build snapshot
        self._built: Optional[Tuple] = None
        self._build_thread: Optional[threading.Thread] = None
        self._pending_inserts: List[Tuple[str, Hashable]] = []
        self._pending_deletes: Set[Hashable] = set()
        # errors of the fold and builder threads, raised by the next
        # call on the caller's thread (`_raise_background_error`)
        self._errors: List[BaseException] = []
        self._streams = UploadStreams()
        # compact-buffer capacity, in multiples of the window's unique
        # topics; doubles whenever the buffer clips, never shrinks
        self._ccap_mult = 2
        # (rev, the SubOpts columns packed one word a row, on the device)
        self._dec_cols: Optional[Tuple[int, torch.Tensor]] = None
        self._dec_stage = HostStage(self.device)
        self._dec_lock = threading.Lock()  # the stage, fill to download
        self.rules_evaluator = RulesEvaluator(self.device)
        self.counters = {"dev_windows": 0, "host_windows": 0,
                         "clip_reruns": 0, "rows": 0, "ovf_rows": 0,
                         "decide_windows": 0, "rebuilds": 0, "folds": 0,
                         "daut_windows": 0}

    # ------------------------------------------------------------ mutation

    def _raise_background_error(self) -> None:
        """Raise, once, what the fold or builder thread failed with."""
        if not self._errors:
            return
        with self._lock:
            errs, self._errors = self._errors, []
        if errs:
            if len(errs) > 1:
                errs[0].add_note(f"and {len(errs) - 1} later background "
                                 f"failure(s): {errs[1:]!r}")
            raise errs[0]

    def _background_failed(self, exc: BaseException) -> None:
        with self._lock:
            self._errors.append(exc)

    def insert(self, flt: str, fid: Hashable) -> None:
        self._raise_background_error()
        parsed = _validate_filter(flt)
        with self._mlock:
            self._insert_locked(flt, fid, *parsed)

    def insert_many(self, pairs: Sequence[Tuple[str, Hashable]]) -> None:
        """Batch insert; the whole window validates before any
        mutation, and a fid listed twice keeps its last filter.  Fresh
        wildcard filters go into the trie in one call; replacements,
        exact and too-deep filters take the single-item path."""
        self._raise_background_error()
        if len({fid for _, fid in pairs}) != len(pairs):
            dedup: Dict[Hashable, str] = {}
            for flt, fid in pairs:
                dedup[fid] = flt
            pairs = [(flt, fid) for fid, flt in dedup.items()]
        parsed = [(flt, fid, *_validate_filter(flt)) for flt, fid in pairs]
        with self._mlock:
            if self._built is not None:
                self._poll_swap()
            batch: List[Tuple[str, Hashable, Tuple[str, ...]]] = []
            for flt, fid, ws, wild, n_hash in parsed:
                prev = self._by_fid.get(fid)
                if prev is not None:
                    if prev != flt:
                        self._insert_locked(flt, fid, ws, wild, n_hash)
                    continue
                if not wild:
                    self._by_fid[fid] = flt
                    self._exact.setdefault(flt, set()).add(fid)
                    continue
                if len(ws) - (1 if n_hash else 0) > self.max_levels:
                    self._insert_locked(flt, fid, ws, wild, n_hash)
                    continue
                self._by_fid[fid] = flt
                batch.append((flt, fid, ws))
            if not batch:
                return
            seqs = self._wild.insert_batch(batch)
            delta, dseq, log = self._delta, self._delta_seq, \
                self._residual_log
            fresh = 0
            for (flt, fid, ws), seq in zip(batch, seqs):
                delta[fid] = ws
                if seq:
                    dseq[fid] = seq
                    log.append((fid, seq))
                    fresh += 1
            self._residual_count += fresh
            if self._building:
                self._pending_inserts.extend(
                    (flt, fid) for flt, fid, _ in batch)
            self._after_insert()

    def _insert_locked(self, flt, fid, ws, wild, n_hash) -> None:
        if self._built is not None:
            self._poll_swap()
        prev = self._by_fid.get(fid)
        if prev is not None:
            if prev == flt:
                return
            self._delete_locked(fid)
        self._by_fid[fid] = flt
        if not wild:
            self._exact.setdefault(flt, set()).add(fid)
            return
        seq = self._wild.insert(flt, fid, ws=ws)
        if len(ws) - (1 if n_hash else 0) > self.max_levels:
            self._deep.insert(flt, fid, ws=ws)
            return
        # a tombstone from an earlier filter of this fid stays: it masks
        # the stale entry while the residual view serves the new one
        self._delta[fid] = ws
        if seq:
            self._delta_seq[fid] = seq
            log = self._residual_log
            log.append((fid, seq))
            self._residual_count += 1
            if len(log) > 1024 and len(log) > 4 * max(
                    self._residual_count, 1):
                # amortised compaction: churn that never reaches the
                # fold threshold must not grow the log without bound
                wm, dseq = self._fold_watermark, self._delta_seq
                self._residual_log = [
                    e for e in log if e[1] > wm and dseq.get(e[0]) == e[1]]
        if self._building:
            self._pending_inserts.append((flt, fid))
        self._after_insert()

    def _after_insert(self) -> None:
        """The thresholds: a base rebuild once the delta reaches
        ``rebuild_threshold``, a fold once the residual reaches
        ``max(delta_aut_threshold, |delta| / delta_fold_factor)``."""
        if len(self._delta) >= self.rebuild_threshold:
            if self.background_rebuild:
                if self.defer_rebuild is None or not self.defer_rebuild():
                    self._start_background_rebuild()
            else:
                self._rebuild_locked()
        if self._residual_count >= max(
                self.delta_aut_threshold,
                len(self._delta) // self.delta_fold_factor):
            self._fold_delta_aut()

    def delete(self, fid: Hashable) -> bool:
        self._raise_background_error()
        with self._mlock:
            return self._delete_locked(fid)

    def _delete_locked(self, fid: Hashable) -> bool:
        flt = self._by_fid.pop(fid, None)
        if flt is None:
            return False
        if T.is_wildcard(flt):
            self._wild.delete_id(fid)
            self._delta.pop(fid, None)
            seq = self._delta_seq.pop(fid, None)
            if seq is not None and seq > self._fold_watermark:
                self._residual_count -= 1
            self._deep.delete_id(fid)
            # unconditional tombstones: membership checks against the
            # automata's fid sets would race the builder threads' arena
            # writes; masking a fid no snapshot carries is harmless
            self._deleted_base.add(fid)
            self._deleted_daut.add(fid)
            if self._folding:
                self._fold_deletes.add(fid)
            if self._building:
                self._pending_deletes.add(fid)
        else:
            ids = self._exact.get(flt)
            if ids is not None:
                ids.discard(fid)
                if not ids:
                    del self._exact[flt]
        return True

    def __len__(self) -> int:
        return len(self._by_fid)

    def stats(self) -> Dict[str, int]:
        return {**self.counters, **self.rules_evaluator.counters}

    def index_stats(self) -> Dict[str, object]:
        """The index tiers' sizes and the fold and build flags."""
        return {
            "base": self._n_base,
            "delta": len(self._delta),
            "folded": len(self._daut_fids),
            "residual": self._residual_count,
            "deep": len(self._deep),
            "exact": sum(len(v) for v in self._exact.values()),
            "deleted": len(self._deleted_base) + len(self._deleted_daut),
            "building": self._building,
            "folding": self._folding,
        }

    # ------------------------------------------------------------- rebuild

    def _event(self, kind: str, t0: float, **meta) -> None:
        prof = self.profiler
        if prof is not None:
            prof.event(kind, time.perf_counter() - t0, **meta)

    def _snapshot_inputs(self):
        """The build's work list, captured cheaply: every wildcard
        filter for the first build (``("full", pairs)``), then the delta
        and the base's tombstones (``("delta", pairs, dropped)``); the
        encode runs in `_build`, in the builder thread for a background
        rebuild."""
        if self._build_cache is None:
            return ("full", [(fid, ws) for fid, ws in self._wild.filters()
                             if fid not in self._deep])
        return ("delta", list(self._delta.items()), set(self._deleted_base))

    def _build(self, inputs, hash_buckets: int = 0):
        """``(automaton, device tables, position -> fid, live filters,
        arena)`` for a work list of `_snapshot_inputs`: only the delta
        is encoded, into the cached arena."""
        with self._enc_lock:
            if inputs[0] == "full":
                arena = _EncArena(self.max_levels, self.native)
                arena.apply(inputs[1], (), self._tdict)
            else:
                arena = self._build_cache
                arena.apply(inputs[1], inputs[2], self._tdict)
            views = arena.views()
            fid_arr = arena.fid_view()
            n_live = len(arena.rows)
        aut = assemble_automaton(*views, max_levels=self.max_levels,
                                 hash_buckets=hash_buckets,
                                 native=self.native)
        _pad_nodes_pow2(aut)
        return aut, self._upload(aut), fid_arr, n_live, arena

    def _upload(self, aut: Automaton) -> DeviceTables:
        """The automaton's tables on the device, on its side stream."""
        t0 = time.perf_counter()
        tables = tables_from_reference(
            aut.fp_rows, aut.node_rows, aut.salt, aut.code_off,
            aut.code_idx, self.device, self._streams.get(self.device))
        self._event("upload", t0,
                    bytes=aut.fp_rows.nbytes + aut.node_rows.nbytes)
        return tables

    def rebuild(self, hash_buckets: int = 0) -> None:
        """Fold every wildcard filter into a fresh base automaton and
        upload its tables (synchronous); an in-flight background build
        is joined first."""
        t = self._build_thread
        if t is not None and t.is_alive():
            t.join()
        self._raise_background_error()
        with self._mlock:
            self._rebuild_locked(hash_buckets)

    def _rebuild_locked(self, hash_buckets: int = 0) -> None:
        t0 = time.perf_counter()
        t = self._build_thread
        if t is not None and t.is_alive():
            t.join()  # two builders would interleave the dictionary
        self._poll_swap()
        inputs = self._snapshot_inputs()
        (self._aut, self._tables, self._fid_arr, self._n_base,
         self._build_cache) = self._build(inputs, hash_buckets)
        self._delta = {}
        self._delta_seq = {}
        self._residual_log = []
        self._residual_count = 0
        self._fold_watermark = self._wild.last_seq()
        self._drop_delta_aut()
        self._deleted_base = set()
        self._deleted_daut = set()
        self.counters["rebuilds"] += 1
        self._event("rebuild", t0, n_filters=len(inputs[1]))

    def _fold_delta_aut(self) -> None:
        """Fold the delta into the delta automaton.  Called under
        ``_mlock``, which captures the work list only; the encode,
        assemble and upload run in a daemon thread (inline with
        ``_fold_async = False``), and the result is adopted only if no
        base swap happened meanwhile (``_fold_gen``).  Windows go on
        matching the old delta automaton and the residual view until
        the adoption, which bumps the watermark.  The node table pads to
        a power-of-two class of at least ``_fold_min_nodes`` and the
        hash table to at least ``_fold_min_buckets``, both sticky, and
        the kernel walks ``max_levels + 1`` levels."""
        if self._folding:
            return
        # an entry of the log is live iff it carries its fid's last seq
        live = [(fid, seq) for fid, seq in self._residual_log
                if self._delta_seq.get(fid) == seq]
        self._residual_log = live
        new_items = [(fid, self._delta[fid]) for fid, _ in live]
        cache = self._fold_cache
        if cache is None:
            full_items = list(self._delta.items())
            if not full_items:
                return
        else:
            if not new_items and not self._deleted_daut:
                return
            full_items = None
        deleted_snap = set(self._deleted_daut)
        snap_seq = self._wild.last_seq()
        gen = self._fold_gen
        # before `_folding` flips: a tracepoint raising here must not
        # leave folds switched off
        tp("fold_capture", gen=gen, snap_seq=snap_seq,
           n_new=len(new_items))
        self._folding = True
        self._fold_deletes = set()

        def fold():
            t0 = time.perf_counter()
            with self._enc_lock:
                if cache is None:
                    arena = _EncArena(self.max_levels, self.native)
                    arena.apply(full_items, (), self._tdict)
                else:
                    arena = cache
                    arena.apply(new_items, deleted_snap, self._tdict)
                views = arena.views()
                fid_view = arena.fid_view()
                live_fids = set(arena.rows)
            if not live_fids:  # everything deleted since the capture
                with self._mlock:
                    self._folding = False
                return
            aut = assemble_automaton(
                *views, max_levels=self.max_levels,
                hash_buckets=self._fold_min_buckets, native=self.native)
            _pad_nodes_pow2(aut, minimum=self._fold_min_nodes)
            aut.kernel_levels = self.max_levels + 1
            self._fold_min_nodes = aut.node_rows.shape[0]
            self._fold_min_buckets = len(aut.fp_rows)
            tables = self._upload(aut)
            tp("fold_assemble_done", gen=gen)
            # outside the lock: a test may pin the adoption here while
            # a window holds or needs `_mlock`
            tp("fold_adopt", gen=gen)
            with self._mlock:
                self._folding = False
                if self._fold_gen != gen:
                    tp("fold_discard", gen=gen)
                    return  # the base swapped underneath: stale
                tp("fold_commit", gen=gen, watermark=snap_seq)
                self._fold_cache = arena
                self._daut, self._dtables = aut, tables
                self._dfid_arr, self._daut_fids = fid_view, live_fids
                # tombstones for fids deleted while the fold ran (a
                # fresh set: an in-flight window keeps the old pair); a
                # fid re-inserted meanwhile stays masked here, and the
                # residual view serves its new filter
                self._deleted_daut = {
                    f for f in self._fold_deletes if f in live_fids}
                self._fold_deletes = set()
                # the swap IS the watermark bump
                self._fold_watermark = snap_seq
                self._residual_log = [
                    e for e in self._residual_log if e[1] > snap_seq]
                self._residual_count = sum(
                    1 for fid, seq in self._residual_log
                    if self._delta_seq.get(fid) == seq)
                self.counters["folds"] += 1
            self._event("delta_fold", t0, n_new=len(new_items))

        def work():
            try:
                fold()
            except Exception as exc:
                with self._mlock:
                    self._folding = False
                self._background_failed(exc)

        if self._fold_async:
            self._fold_thread = threading.Thread(
                target=work, name="matchengine-fold", daemon=True)
            self._fold_thread.start()
        else:
            work()  # _mlock is reentrant

    def _drop_delta_aut(self) -> None:
        self._daut = None
        self._dtables = None
        self._dfid_arr = None
        self._daut_fids = set()
        self._fold_cache = None
        # discard any in-flight fold: its inputs predate this state
        self._fold_gen += 1
        self._fold_deletes = set()
        tp("daut_drop", gen=self._fold_gen)

    def kick_rebuild(self) -> bool:
        """Start a background rebuild now if the delta has outgrown the
        threshold (a rebuild `defer_rebuild` put off); True when one
        was started."""
        if (self.background_rebuild
                and len(self._delta) >= self.rebuild_threshold
                and not self._building):
            self._start_background_rebuild()
            return True
        return False

    def _start_background_rebuild(self) -> None:
        with self._lock:
            if self._building:
                return
            self._building = True
            self._pending_inserts = []
            self._pending_deletes = set()
            self._rebuild_snap_seq = self._wild.last_seq()
            inputs = self._snapshot_inputs()
        n_filters = len(inputs[1])

        def work():
            t0 = time.perf_counter()
            try:
                built = self._build(inputs)
                self._event("rebuild", t0, n_filters=n_filters,
                            background=True)
            except Exception as exc:
                with self._lock:
                    self._building = False
                self._background_failed(exc)
                return
            with self._lock:
                self._built = built

        self._build_thread = threading.Thread(
            target=work, name="matchengine-rebuild", daemon=True)
        self._build_thread.start()

    def _poll_swap(self) -> None:
        """Adopt a finished background build: an O(pending) swap.  The
        inserts since the build's snapshot become the fresh residual
        and its deletes the new base's tombstones."""
        if self._built is None:
            return
        with self._lock:
            built, self._built = self._built, None
            if built is None:
                return
            (self._aut, self._tables, self._fid_arr, self._n_base,
             self._build_cache) = built
            delta: Dict[Hashable, Tuple[str, ...]] = {}
            for flt, fid in self._pending_inserts:
                if self._by_fid.get(fid) == flt and fid not in self._deep:
                    delta[fid] = tuple(flt.split("/"))
            self._delta = delta
            self._delta_seq = {
                fid: s for fid, s in self._delta_seq.items() if fid in delta}
            self._fold_watermark = self._rebuild_snap_seq
            # the log anew from `_delta_seq`, not the old log: a fold
            # adopted mid-build pruned it past ITS watermark, which is
            # ahead of the build's snapshot
            self._residual_log = list(self._delta_seq.items())
            self._residual_count = len(self._residual_log)
            self._drop_delta_aut()
            self._deleted_base = set(self._pending_deletes)
            self._deleted_daut = set()
            self._pending_inserts = []
            self._pending_deletes = set()
            self._building = False
            self.counters["rebuilds"] += 1
            tp("base_swap", pending=len(delta))

    # --------------------------------------------------------------- match

    def match(self, topic: str) -> Set[Hashable]:
        return self.match_batch([topic])[0]

    def match_host(self, topic_words: T.Words) -> Set[Hashable]:
        """Pure-host match (the oracle, and the overflow re-match)."""
        out = set(self._exact.get(T.join(topic_words), ()))
        out |= self._wild.match_words(topic_words)
        return out

    def match_batch(self, topics: Sequence[str]) -> List[Set[Hashable]]:
        return self.match_batch_finish(self.match_batch_submit(topics))

    def match_batch_submit(self, topics: Sequence[str]):
        """Phase 1: tokenize the window for each automaton, dedup it,
        and launch the compact match kernel on the delta automaton (if
        any) and on the base without waiting for their results."""
        self._raise_background_error()
        t0 = time.perf_counter()
        words = [T.words(t) for t in topics]
        with self._mlock:
            if self._built is not None:
                self._poll_swap()
            snap = self._snapshot()
            device_on = snap[0] is not None and snap[0].n_nodes > 1
            if device_on:
                tp("match_snapshot", watermark=self._fold_watermark)
        if not device_on:
            self._stage("tokenize", t0)
            return ("host", self._match_host_window(words))
        daut, dtables, _ = snap[6]
        denc = (self._encode_window(words, daut.kernel_levels)
                if daut is not None else None)
        benc = self._encode_base(snap, words)
        self._stage("tokenize", t0)
        dpend = (self._flat_dispatch(dtables, denc)
                 if denc is not None else None)
        base = self._flat_submit(snap, benc)
        return ("dev", snap, base, dpend, topics, words)

    def _stage(self, name: str, t0: float) -> None:
        prof = self.profiler
        if prof is not None:
            prof.stage(name, time.perf_counter() - t0)

    def _encode_rows(self, words, levels: int):
        """Tokenize a window through the row cache; returns ``(idx,
        mat, lens, dol)``, the window's row of each topic in the
        cache's token, length and dollar columns.  A topic seen before
        costs one dict lookup; the misses are encoded in one batch, by
        the native encoder (`TokenDict.native`) or with
        ``native=False`` by `encode_topics`, with the same rows.  Runs
        under ``_enc_lock``, which also serializes the dictionary's
        growth (the builder and fold threads' encodes).  Rows are never
        overwritten: growth and resets allocate new arrays, so the
        returned arrays stay valid after the lock is released."""
        with self._enc_lock:
            gen = len(self._tdict)
            if gen != self._enc_gen:
                self._enc_cache.clear()
                self._enc_gen = gen
            entry = self._enc_cache.get(levels)
            if entry is None or entry[4] >= 262144:
                cap = 4096
                entry = self._enc_cache[levels] = [
                    {}, np.full((cap, levels), PAD_TOK, np.int32),
                    np.zeros(cap, np.int32), np.zeros(cap, bool), 0,
                ]
            index, mat, lens, dol, used = entry
            js = list(map(index.get, words))
            if None in js:
                miss_rows: Dict[T.Words, int] = {}
                miss_ws: List[T.Words] = []
                for i, j in enumerate(js):
                    if j is None:
                        ws = words[i]
                        r = miss_rows.get(ws)
                        if r is None:
                            r = miss_rows[ws] = used + len(miss_ws)
                            miss_ws.append(ws)
                        js[i] = r
                need = used + len(miss_ws)
                if need > len(lens):  # grow by doubling
                    cap = len(lens)
                    while cap < need:
                        cap *= 2
                    m2 = np.full((cap, levels), PAD_TOK, np.int32)
                    m2[:used] = mat[:used]
                    mat = m2
                    lens = np.resize(lens, cap)
                    dol = np.resize(dol, cap)
                    entry[1], entry[2], entry[3] = mat, lens, dol
                if self.native:
                    self._tdict.native().encode_topics_into(
                        [T.join(ws) for ws in miss_ws], levels,
                        mat[used:need], lens[used:need], dol[used:need])
                else:
                    mat[used:need], lens[used:need], dol[used:need] = (
                        encode_topics(self._tdict, miss_ws, levels))
                index.update(miss_rows)
                entry[4] = need
        return np.fromiter(js, np.int64, count=len(words)), mat, lens, dol

    def _encode_window(self, words, levels: int):
        """The window for K1 at ``levels``: its distinct topics (a
        publish window is Zipf-heavy; the row index is the dedup key),
        padded, as ``(tokens, lengths, dollar, n_uniq, inv)``."""
        idx, mat, lens, dol = self._encode_rows(words, levels)
        uniq, inv = np.unique(idx, return_inverse=True)
        return (*_pad_batch(mat[uniq], lens[uniq], dol[uniq]), len(uniq),
                inv)

    def _encode_base(self, snap, words):
        """The window as the base's kernel takes it (`_flat_submit`)."""
        return self._encode_window(words, snap[0].kernel_levels)

    def _flat_dispatch(self, tables: DeviceTables, enc):
        """Upload an encoded window and launch K1 on ``tables``; returns
        the pending handle `_flat_finish` completes."""
        tokens, lengths, dollar, n_uniq, inv = enc
        dev = self.device
        batch = tuple(torch.from_numpy(a).to(dev)
                      for a in (tokens, lengths, dollar))
        c_cap = self._ccap_mult * tokens.shape[0]
        flat, counts, total = match_batch_compact(
            tables.fp_rows, tables.node_rows, tables.salt, *batch,
            f_width=self.f_width, m_cap=self.m_cap, c_cap=c_cap,
        )
        return (tables, flat, counts, total, batch, n_uniq, inv)

    def _flat_submit(self, snap, enc):
        """The base's launch: pending (``("pend", handle)``) here; an
        engine whose launch completes at once returns ``("done",
        (rows, positions, overflowed rows))``."""
        return ("pend", self._flat_dispatch(snap[1], enc))

    def _flat_finish(self, pending):
        """Wait for one automaton's K1 and expand its codes to ``(rows,
        filter positions, overflowed rows)``.  If the compact buffer
        clipped, the window reruns on the dense kernel (K2) and the
        sticky capacity multiplier doubles."""
        tables, flat, counts, total, batch, n_uniq, inv = pending
        if int(total.item()) > flat.shape[0]:
            self._ccap_mult = min(self._ccap_mult * 2, 64)
            self.counters["clip_reruns"] += 1
            codes, _, ovf = match_batch(
                tables.fp_rows, tables.node_rows, tables.salt, *batch,
                f_width=self.f_width, m_cap=self.m_cap,
            )
            rows, pos = expand_codes_dedup(
                tables.code_off, tables.code_idx,
                codes.cpu().numpy()[:n_uniq], inv,
            )
            return rows, pos, ovf.cpu().numpy()[:n_uniq][inv]
        counts = counts.cpu().numpy().astype(np.int64)
        ovf_u = counts < 0
        counts_pos = np.where(ovf_u, -counts - 1, counts)
        rows, pos = expand_codes_flat(
            tables.code_off, tables.code_idx, flat.cpu().numpy(),
            counts_pos, inv,
        )
        return rows, pos, ovf_u[:n_uniq][inv]

    def _snapshot(self):
        """What one window matches against, of one generation: the base
        automaton, its tables and fids, the host tiers as of now, the
        base's tombstones, the delta automaton's ``(automaton, tables,
        fids)`` and its tombstones."""
        with self._mlock:
            return (
                self._aut, self._tables, self._fid_arr,
                _ResidualView(self._wild, self._fold_watermark), self._deep,
                self._deleted_base,
                (self._daut, self._dtables, self._dfid_arr),
                self._deleted_daut,
            )

    def _match_host_window(self, words) -> List[Set[Hashable]]:
        out = []
        for ws in words:
            with self._mlock:
                out.append(self.match_host(ws))
        self.counters["host_windows"] += 1
        return out

    def match_batch_finish(self, pending) -> List[Set[Hashable]]:
        """Phase 2: wait for the kernels, expand codes to filters on the
        host, overlay the host tiers."""
        if pending[0] != "dev":
            return pending[1]
        _, snap, base, dpend, topics, words = pending
        kind, res = base
        rows, gpos, ovf = self._flat_finish(res) if kind == "pend" else res
        dflat = self._flat_finish(dpend) if dpend is not None else None
        self.counters["dev_windows"] += 1
        self.counters["daut_windows"] += dflat is not None
        self.counters["rows"] += len(words)
        tp("match_overlay")
        with self._mlock:
            return self._overlay(topics, words, rows, gpos, ovf, snap,
                                 dflat)

    def _overlay(self, topics, words, rows, gpos, ovf, snap, dflat=None
                 ) -> List[Set[Hashable]]:
        fid_arr, residual, deep = snap[2], snap[3], snap[4]
        deleted_base, deleted_daut = snap[5], snap[7]
        # the host tiers' sizes once a window, not once a row (the
        # native trie answers them through a ctypes call)
        residual = residual if len(residual) else None
        deep = deep if len(deep) else None
        per_row = np.bincount(rows, minlength=len(words))
        chunks = np.split(fid_arr[gpos], np.cumsum(per_row)[:-1])
        dchunks = None
        if dflat is not None:
            drows, dgpos, dovf = dflat
            dper = np.bincount(drows, minlength=len(words))
            dchunks = np.split(snap[6][2][dgpos], np.cumsum(dper)[:-1])
            ovf = ovf | dovf  # either kernel overflowing -> host row
        self.counters["ovf_rows"] += int(ovf.sum())
        out: List[Set[Hashable]] = []
        for i, ws in enumerate(words):
            if ovf[i]:
                out.append(self.match_host(ws))
                continue
            # tombstones are per generation: a fid deleted from the base
            # may live on (re-inserted) in the delta automaton, so each
            # automaton's chunk is masked by its own set only
            fids: Set[Hashable] = set(chunks[i].tolist())
            if deleted_base:
                fids -= deleted_base
            if dchunks is not None:
                dfids = set(dchunks[i].tolist())
                if deleted_daut:
                    dfids -= deleted_daut
                fids |= dfids
            if self._exact:
                fids |= self._exact.get(topics[i], set())
            if residual is not None:
                fids |= residual.match_words(ws)
            if deep is not None:
                fids |= deep.match_words(ws)
            out.append(fids)
        return out

    # -------------------------------------------------------------- decide

    def decide_window(
        self,
        cols: Tuple,
        rev: int,
        opts_rows: np.ndarray,
        client_rows: np.ndarray,
        msg_idx: np.ndarray,
        m_qos: np.ndarray,
        m_retain: np.ndarray,
        m_from_row: np.ndarray,
    ) -> np.ndarray:
        """One window's packed per-delivery decision column (the bit
        layout of `ops.match_kernel.decide_batch`).  ``cols`` are the
        router's SubOpts attribute columns and ``rev`` their mutation
        counter: the device copy, packed one word a row, caches on it.
        Delivery and message columns pad to power-of-two buckets: opts
        row and message index 0, client row -1.  The six padded columns
        go up in one copy from a pinned buffer; the decisions and the
        kernel's range-check word come down after one synchronise, and
        a delivery outside the opts or message columns raises
        IndexError."""
        n = len(opts_rows)
        if n == 0:
            return np.zeros(0, np.uint8)
        cache = self._dec_cols
        if cache is None or cache[0] != rev:
            cache = self._dec_cols = (rev, pack_opts(*(
                torch.from_numpy(np.ascontiguousarray(c, dtype=dt))
                for c, dt in zip(cols, (np.int8, bool, bool, bool)))
            ).to(self.device))
        npad = 64
        while npad < n:
            npad *= 2
        b = len(m_qos)
        bpad = 16
        while bpad < b:
            bpad *= 2
        with self._dec_lock:
            host = self._dec_stage.views(
                [(np.int32, (npad,))] * 3
                + [(np.int32, (bpad,)), (np.int8, (bpad,)), (bool, (bpad,))])
            for dst, src, fill in zip(host, (
                    opts_rows, client_rows, msg_idx, m_from_row, m_qos,
                    m_retain), (0, -1, 0, -1, 0, False)):
                dst[:len(src)] = src
                dst[len(src):] = fill
            o, c, mi, mf, mq, mr = self._dec_stage.upload()
            packed, error = decide_packed(cache[1], o, c, mi, mq, mr, mf)
            packed, error = self._dec_stage.download(packed[:n], error)
        if error[0]:
            raise IndexError("a delivery indexes outside the opts or "
                             "message columns")
        self.counters["decide_windows"] += 1
        return packed
