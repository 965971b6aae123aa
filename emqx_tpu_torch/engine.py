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
"""

from __future__ import annotations

import threading
from typing import Dict, Hashable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from . import topic as T
from .ops.automaton import (
    Automaton, build_automaton, expand_codes_dedup, expand_codes_flat,
)
from .ops.dictionary import PAD_TOK, SENTINEL, TokenDict, encode_topics
from .ops.match_kernel import (
    decide_packed, match_batch, match_batch_compact, pack_opts,
)
from .ops.trie_host import HostTrie
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

    def __init__(self, wild: HostTrie, watermark: int) -> None:
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
    ) -> None:
        self.device = resolve_device(device)
        self.max_levels = max_levels
        self.f_width = f_width
        self.m_cap = m_cap
        self.rebuild_threshold = rebuild_threshold
        self._exact: Dict[str, Set[Hashable]] = {}
        self._wild = HostTrie()  # every wildcard filter: oracle + build source
        self._delta: Dict[Hashable, Tuple[str, ...]] = {}  # since last build
        self._deep = HostTrie()  # filters deeper than max_levels
        self._by_fid: Dict[Hashable, str] = {}
        # a delete masks the fid in the built snapshot; replaced (never
        # mutated) at rebuild so an in-flight window's snapshot holds
        self._deleted_base: Set[Hashable] = set()
        self._tdict = TokenDict()
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

    def _build(self, filters):
        """``(automaton, device tables, position -> fid)`` for the
        wildcard ``filters``."""
        aut = build_automaton(filters, self._tdict,
                              max_levels=self.max_levels)
        _pad_nodes_pow2(aut)
        tables = tables_from_reference(
            aut.fp_rows, aut.node_rows, aut.salt, aut.code_off,
            aut.code_idx, self.device,
        )
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
        words = [T.words(t) for t in topics]
        snap = self._snapshot()
        aut, tables = snap[0], snap[1]
        if aut is None or aut.n_nodes <= 1:
            return ("host", self._match_host_window(words))
        # publish windows are Zipf-heavy: match each distinct topic once
        index: Dict[T.Words, int] = {}
        inv = np.fromiter(
            (index.setdefault(ws, len(index)) for ws in words),
            np.int64, len(words),
        )
        tokens, lengths, dollar = _pad_batch(
            *encode_topics(self._tdict, list(index), aut.kernel_levels)
        )
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
                (flat, counts, total, enc, len(index), inv))

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
            if len(residual):
                fids |= residual.match_words(ws)
            if len(deep):
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
