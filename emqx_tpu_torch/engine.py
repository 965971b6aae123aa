"""MatchEngine: the subscription-matching core on the GPU.

Exact (non-wildcard) filters live in a host hash map; wildcard filters
in a trie automaton (`ops.automaton`) whose tables sit on the device
and are batch-matched by the hand-written kernels in
`ops.match_kernel`.  Subscription churn lands in a host residual
immediately (correct from the next match on): inserts since the last
build are matched on the host trie through a watermark view, deletions
mask stale device results by fid, and a synchronous rebuild folds the
residual into a fresh automaton once it reaches ``rebuild_threshold``.

Any topic the kernel flags (frontier overflow, match-cap overflow) is
re-matched on the `HostTrie`, so results are exact whatever the kernel
capacity bounds.  A device error propagates: there is no host fallback.

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
before the launch — and ``rebuild`` and ``upload`` events, the latter
with the bytes the tables put on the device.
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
    Automaton, build_automaton, expand_codes_dedup, expand_codes_flat,
)
from .ops.dictionary import PAD_TOK, SENTINEL, TokenDict, encode_topics
from .ops.match_kernel import (
    decide_packed, match_batch, match_batch_compact, pack_opts,
)
from .ops.trie_native import make_trie
from .rules.evaluator import RulesEvaluator
from .state import (
    DeviceTables, HostStage, resolve_device, tables_from_reference,
)


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


class _ResidualView:
    """Read view of "wildcard filters inserted after the build
    watermark", backed by the seq-tagged `_wild` trie.  ``len`` is the
    skip check and reports the seq-span upper bound."""

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
    ) -> None:
        self.device = resolve_device(device)
        self.native = native
        if native:
            _native.load_all()  # raises when a library does not build
        self.max_levels = max_levels
        self.f_width = f_width
        self.m_cap = m_cap
        self.rebuild_threshold = rebuild_threshold
        self.profiler = None  # an observability.Profiler, or None
        self._exact: Dict[str, Set[Hashable]] = {}
        # every wildcard filter: oracle + build source
        self._wild = make_trie(native)
        self._delta: Dict[Hashable, Tuple[str, ...]] = {}  # since last build
        self._deep = make_trie(native)  # filters deeper than max_levels
        self._by_fid: Dict[Hashable, str] = {}
        # a delete masks the fid in the built snapshot; replaced (never
        # mutated) at rebuild so an in-flight window's snapshot holds
        self._deleted_base: Set[Hashable] = set()
        self._tdict = TokenDict()
        # kernel levels -> [words -> row, token rows, lengths, dollar
        # flags, rows used]: the window encode's row cache, dropped
        # whenever the dictionary grows (a word unknown when a row was
        # encoded may be a filter literal now)
        self._enc_cache: Dict[int, list] = {}
        self._enc_gen = 0
        self._aut: Optional[Automaton] = None
        self._tables: Optional[DeviceTables] = None
        self._fid_arr: Optional[np.ndarray] = None
        self._watermark = 0  # _wild seq covered by the built automaton
        # serializes mutation vs the snapshot/overlay phases of a match
        # running on another thread; the kernels run outside it
        self._mlock = threading.RLock()
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
                         "decide_windows": 0, "rebuilds": 0}

    # ------------------------------------------------------------ mutation

    def insert(self, flt: str, fid: Hashable) -> None:
        parsed = _validate_filter(flt)
        with self._mlock:
            self._insert_locked(flt, fid, *parsed)
            self._maybe_rebuild()

    def insert_many(self, pairs: Sequence[Tuple[str, Hashable]]) -> None:
        """Batch insert; the whole window validates before any
        mutation, and a fid listed twice keeps its last filter."""
        parsed = [(flt, fid, *_validate_filter(flt)) for flt, fid in pairs]
        with self._mlock:
            for item in parsed:
                self._insert_locked(*item)
            self._maybe_rebuild()

    def _insert_locked(self, flt, fid, ws, wild, n_hash) -> None:
        prev = self._by_fid.get(fid)
        if prev is not None:
            if prev == flt:
                return
            self._delete_locked(fid)
        self._by_fid[fid] = flt
        if not wild:
            self._exact.setdefault(flt, set()).add(fid)
            return
        self._wild.insert(flt, fid, ws=ws)
        if len(ws) - (1 if n_hash else 0) > self.max_levels:
            self._deep.insert(flt, fid, ws=ws)
        else:
            # a tombstone from an earlier filter of this fid stays: it
            # masks the stale base entry while the residual view serves
            # the new one
            self._delta[fid] = ws

    def _maybe_rebuild(self) -> None:
        if len(self._delta) >= self.rebuild_threshold:
            self.rebuild()

    def delete(self, fid: Hashable) -> bool:
        with self._mlock:
            return self._delete_locked(fid)

    def _delete_locked(self, fid: Hashable) -> bool:
        flt = self._by_fid.pop(fid, None)
        if flt is None:
            return False
        if T.is_wildcard(flt):
            self._wild.delete_id(fid)
            self._delta.pop(fid, None)
            self._deep.delete_id(fid)
            self._deleted_base.add(fid)
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

    def rebuild(self) -> None:
        """Build a fresh automaton from every wildcard filter and upload
        its tables (synchronous)."""
        t0 = time.perf_counter()
        with self._mlock:
            filters = [
                (fid, ws) for fid, ws in self._wild.filters()
                if fid not in self._deep
            ]
            self._aut, self._tables, self._fid_arr = self._build(filters)
            self._delta = {}
            self._watermark = self._wild.last_seq()
            self._deleted_base = set()
            self.counters["rebuilds"] += 1
        self._event("rebuild", t0, n_filters=len(filters))

    def _event(self, kind: str, t0: float, **meta) -> None:
        prof = self.profiler
        if prof is not None:
            prof.event(kind, time.perf_counter() - t0, **meta)

    def _build(self, filters):
        """``(automaton, device tables, position -> fid)`` for the
        wildcard ``filters``."""
        aut = build_automaton(filters, self._tdict,
                              max_levels=self.max_levels,
                              native=self.native)
        _pad_nodes_pow2(aut)
        t0 = time.perf_counter()
        tables = tables_from_reference(
            aut.fp_rows, aut.node_rows, aut.salt, aut.code_off,
            aut.code_idx, self.device,
        )
        self._event("upload", t0,
                    bytes=aut.fp_rows.nbytes + aut.node_rows.nbytes)
        return aut, tables, make_fid_arr([fid for fid, _ in filters])

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
        """Phase 1: tokenize the window, dedup it, and launch the
        compact match kernel without waiting for its results."""
        t0 = time.perf_counter()
        words = [T.words(t) for t in topics]
        with self._mlock:
            snap = self._snapshot()
            aut, tables = snap[0], snap[1]
            if aut is not None and aut.n_nodes > 1:
                idx, mat, lens, dol = self._encode_rows(
                    words, aut.kernel_levels)
                # publish windows are Zipf-heavy: match each distinct
                # topic once; the row index is the dedup key
                uniq, inv = np.unique(idx, return_inverse=True)
                tokens, lengths, dollar = _pad_batch(
                    mat[uniq], lens[uniq], dol[uniq])
        self._stage("tokenize", t0)
        if aut is None or aut.n_nodes <= 1:
            return ("host", self._match_host_window(words))
        dev = self.device
        enc = (
            torch.from_numpy(tokens).to(dev),
            torch.from_numpy(lengths).to(dev),
            torch.from_numpy(dollar).to(dev),
        )
        c_cap = self._ccap_mult * tokens.shape[0]
        flat, counts, total = match_batch_compact(
            tables.fp_rows, tables.node_rows, tables.salt, *enc,
            f_width=self.f_width, m_cap=self.m_cap, c_cap=c_cap,
        )
        return ("dev", snap, topics, words,
                (flat, counts, total, enc, len(uniq), inv))

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
        ``native=False`` by `encode_topics`, with the same rows.  The
        caller holds ``_mlock``, which also serializes the dictionary's
        growth (rebuilds)."""
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

    def _snapshot(self):
        """What one window matches against: the built automaton, its
        tables and fids, and the host tiers as of now."""
        with self._mlock:
            return (
                self._aut, self._tables, self._fid_arr,
                _ResidualView(self._wild, self._watermark), self._deep,
                self._deleted_base,
            )

    def _match_host_window(self, words) -> List[Set[Hashable]]:
        out = []
        for ws in words:
            with self._mlock:
                out.append(self.match_host(ws))
        self.counters["host_windows"] += 1
        return out

    def match_batch_finish(self, pending) -> List[Set[Hashable]]:
        """Phase 2: wait for the kernel, expand codes to filters on the
        host, overlay the host tiers."""
        if pending[0] != "dev":
            return pending[1]
        _, snap, topics, words, (flat, counts, total, enc, n_uniq,
                                 inv) = pending
        tables = snap[1]
        if int(total.item()) > flat.shape[0]:
            # the compact buffer clipped: rerun the window on the dense
            # kernel and double the sticky capacity multiplier
            self._ccap_mult = min(self._ccap_mult * 2, 64)
            self.counters["clip_reruns"] += 1
            codes, _, ovf = match_batch(
                tables.fp_rows, tables.node_rows, tables.salt, *enc,
                f_width=self.f_width, m_cap=self.m_cap,
            )
            rows, pos = expand_codes_dedup(
                tables.code_off, tables.code_idx,
                codes.cpu().numpy()[:n_uniq], inv,
            )
            ovf_rows = ovf.cpu().numpy()[:n_uniq][inv]
        else:
            counts = counts.cpu().numpy().astype(np.int64)
            ovf_u = counts < 0
            counts_pos = np.where(ovf_u, -counts - 1, counts)
            rows, pos = expand_codes_flat(
                tables.code_off, tables.code_idx, flat.cpu().numpy(),
                counts_pos, inv,
            )
            ovf_rows = ovf_u[:n_uniq][inv]
        self.counters["dev_windows"] += 1
        self.counters["rows"] += len(words)
        self.counters["ovf_rows"] += int(ovf_rows.sum())
        with self._mlock:
            return self._overlay(topics, words, rows, pos, ovf_rows, snap)

    def _overlay(self, topics, words, rows, gpos, ovf, snap
                 ) -> List[Set[Hashable]]:
        fid_arr, residual, deep, deleted = snap[2], snap[3], snap[4], snap[5]
        # the host tiers' sizes once a window, not once a row (the
        # native trie answers them through a ctypes call)
        residual = residual if len(residual) else None
        deep = deep if len(deep) else None
        fids_flat = fid_arr[gpos]
        per_row = np.bincount(rows, minlength=len(words))
        chunks = np.split(fids_flat, np.cumsum(per_row)[:-1])
        out: List[Set[Hashable]] = []
        for i, ws in enumerate(words):
            if ovf[i]:
                out.append(self.match_host(ws))
                continue
            fids: Set[Hashable] = set(chunks[i].tolist())
            if deleted:
                fids -= deleted
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
