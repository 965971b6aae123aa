"""Router: subscription registry over the match engine.

One object owns the subscriber tables and the route table: the
`MatchEngine` indexes each distinct real filter once (fid = the filter
string), and per-filter subscriber maps carry (clientid -> SubOpts)
fan-out, CSR-expanded at dispatch time.

Fan-out expansion is vectorized: client ids intern to integer rows and
each SubOpts to a table slot, and each filter keeps an incrementally
maintained CSR column of (client_row, opts_row) pairs.  A window's
matched fid sets expand to flat ``(msg_idx, client_row, opts_row)``
arrays in one pass (`expand_window`).  The SubOpts attribute columns
(`opts_columns`) feed the decide kernel.  Rule fids
(``("rule", rule_id, i)``, inserted straight into the engine by the
rule engine) come back from `expand_window` grouped per message.

Shared subscriptions route through the same engine entry for the real
filter; group membership and per-message picks live in
`SharedSubManager`, and each shared subscription's options take a slot
of the same opts table, so a window's shared picks ride the decision
columns like direct deliveries.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from . import topic as T
from .broker.session import SubOpts
from .broker.shared import SharedSubManager
from .engine import MatchEngine

_EMPTY_I64 = np.empty(0, dtype=np.int64)

# initial capacity of the parallel SubOpts attribute columns; grown by
# doubling so the device decide path sees few distinct table shapes
_OPTS_CAP0 = 64


class _CsrBucket:
    """One filter's subscriber column: parallel (client_row, opts_row)
    lists with O(1) append and swap-remove, plus lazily rebuilt numpy
    views so a window expansion is array concatenation, not dict
    iteration."""

    __slots__ = ("rows", "opts_rows", "pos", "_arr")

    def __init__(self) -> None:
        self.rows: List[int] = []
        self.opts_rows: List[int] = []
        self.pos: Dict[int, int] = {}  # client_row -> index
        self._arr: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def add(self, client_row: int, opts_row: int) -> None:
        self.pos[client_row] = len(self.rows)
        self.rows.append(client_row)
        self.opts_rows.append(opts_row)
        self._arr = None

    def opts_row_of(self, client_row: int) -> Optional[int]:
        i = self.pos.get(client_row)
        return None if i is None else self.opts_rows[i]

    def remove(self, client_row: int) -> Optional[int]:
        """Swap-remove; returns the freed opts row (None if absent)."""
        i = self.pos.pop(client_row, None)
        if i is None:
            return None
        freed = self.opts_rows[i]
        last_row = self.rows[-1]
        last_opts = self.opts_rows[-1]
        self.rows.pop()
        self.opts_rows.pop()
        if i < len(self.rows):
            self.rows[i] = last_row
            self.opts_rows[i] = last_opts
            self.pos[last_row] = i
        self._arr = None
        return freed

    def arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        a = self._arr
        if a is None:
            a = self._arr = (
                np.asarray(self.rows, dtype=np.int64),
                np.asarray(self.opts_rows, dtype=np.int64),
            )
        return a


class Router:
    def __init__(self, engine: MatchEngine,
                 shared: Optional[SharedSubManager] = None) -> None:
        self.engine = engine
        self.shared = shared if shared is not None else SharedSubManager()
        # real filter -> {clientid -> SubOpts} (direct): the source of
        # truth
        self._subs: Dict[str, Dict[str, SubOpts]] = {}
        # real filter -> {(group, clientid) -> SubOpts} (shared)
        self._shared_opts: Dict[str, Dict[Tuple[str, str], SubOpts]] = {}
        # (real, group, clientid) -> opts table slot
        self._shared_slot: Dict[Tuple[str, str, str], int] = {}
        # clientid -> set of full filter strings ($share prefix kept)
        self._by_client: Dict[str, Set[str]] = {}
        # --- interning tables + CSR fan-out index -------------------
        self._client_rows: Dict[str, int] = {}   # clientid -> row
        self._row_clients: List[str] = []        # row -> clientid
        self._row_free: List[int] = []
        self._opts_table: List[Optional[SubOpts]] = []
        self._opts_free: List[int] = []
        self._csr: Dict[str, _CsrBucket] = {}
        # --- parallel SubOpts attribute columns ---------------------
        # numpy copies of `_opts_table`, maintained on every alloc/free/
        # refresh, so a window's per-delivery decisions come from ONE
        # vectorized gather.  `opts_rev` bumps on every write so the
        # engine's device decide path can cache its uploaded copies.
        self._oa_qos = np.zeros(_OPTS_CAP0, dtype=np.int8)
        self._oa_nl = np.zeros(_OPTS_CAP0, dtype=bool)
        self._oa_rap = np.zeros(_OPTS_CAP0, dtype=bool)
        self._oa_subid = np.zeros(_OPTS_CAP0, dtype=bool)
        self.opts_rev = 0

    # ---------------------------------------------------- interning

    def _intern(self, clientid: str) -> int:
        row = self._client_rows.get(clientid)
        if row is None:
            if self._row_free:
                row = self._row_free.pop()
                self._row_clients[row] = clientid
            else:
                row = len(self._row_clients)
                self._row_clients.append(clientid)
            self._client_rows[clientid] = row
        return row

    def _release_client(self, clientid: str) -> None:
        row = self._client_rows.pop(clientid, None)
        if row is not None:
            self._row_clients[row] = ""
            self._row_free.append(row)

    def _alloc_opts(self, opts: SubOpts) -> int:
        if self._opts_free:
            slot = self._opts_free.pop()
            self._opts_table[slot] = opts
        else:
            slot = len(self._opts_table)
            self._opts_table.append(opts)
            if slot >= len(self._oa_qos):
                cap = 2 * len(self._oa_qos)
                for name in ("_oa_qos", "_oa_nl", "_oa_rap",
                             "_oa_subid"):
                    old = getattr(self, name)
                    new = np.zeros(cap, dtype=old.dtype)
                    new[: len(old)] = old
                    setattr(self, name, new)
        self._set_opts_attrs(slot, opts)
        return slot

    def _set_opts_attrs(self, slot: int, opts: SubOpts) -> None:
        """Mirror one SubOpts into the attribute columns (alloc AND
        options-refresh paths)."""
        self._oa_qos[slot] = opts.qos
        self._oa_nl[slot] = opts.no_local
        self._oa_rap[slot] = opts.retain_as_published
        self._oa_subid[slot] = opts.subid is not None
        self.opts_rev += 1

    def _free_opts(self, slot: int) -> None:
        self._opts_table[slot] = None
        self._oa_qos[slot] = 0
        self._oa_nl[slot] = False
        self._oa_rap[slot] = False
        self._oa_subid[slot] = False
        self.opts_rev += 1
        self._opts_free.append(slot)

    def opts_columns(self) -> Tuple[np.ndarray, np.ndarray,
                                    np.ndarray, np.ndarray]:
        """(qos, no_local, retain_as_published, has_subid) attribute
        columns, indexed by opts row."""
        return self._oa_qos, self._oa_nl, self._oa_rap, self._oa_subid

    def client_of_row(self, row: int) -> str:
        return self._row_clients[row]

    def row_of_client(self, clientid: str) -> Optional[int]:
        return self._client_rows.get(clientid)

    def opts_at(self, slot: int) -> SubOpts:
        return self._opts_table[slot]  # type: ignore[return-value]

    # ------------------------------------------------------- mutation

    def subscribe(self, clientid: str, flt: str, opts: SubOpts) -> None:
        """Register `clientid`'s subscription to `flt` (which may be a
        `$share/...` filter)."""
        shared = T.parse_share(flt)
        if shared is not None:
            real = shared.topic
            opts.share_group = shared.group
            self._intern(clientid)  # picks resolve to rows at dispatch
            need_route = self.shared.join(shared.group, real, clientid)
            self._shared_opts.setdefault(real, {})[
                (shared.group, clientid)
            ] = opts
            skey = (real, shared.group, clientid)
            sslot = self._shared_slot.get(skey)
            if sslot is None:
                self._shared_slot[skey] = self._alloc_opts(opts)
            else:  # options refresh of an existing shared subscription
                self._opts_table[sslot] = opts
                self._set_opts_attrs(sslot, opts)
            if need_route and real not in self._subs:
                self.engine.insert(real, real)
        else:
            real = flt
            subs = self._subs.get(real)
            if subs is None:
                subs = self._subs[real] = {}
                if not self._shared_opts.get(real):
                    self.engine.insert(real, real)
            subs[clientid] = opts
            row = self._intern(clientid)
            bucket = self._csr.get(real)
            if bucket is None:
                bucket = self._csr[real] = _CsrBucket()
            slot = bucket.opts_row_of(row)
            if slot is None:
                bucket.add(row, self._alloc_opts(opts))
            else:  # options refresh of an existing subscription
                self._opts_table[slot] = opts
                self._set_opts_attrs(slot, opts)
        self._by_client.setdefault(clientid, set()).add(flt)

    def unsubscribe(self, clientid: str, flt: str) -> bool:
        shared = T.parse_share(flt)
        if shared is not None:
            real = shared.topic
            self.shared.leave(shared.group, real, clientid)
            opts_map = self._shared_opts.get(real)
            if opts_map is not None:
                opts_map.pop((shared.group, clientid), None)
                if not opts_map:
                    del self._shared_opts[real]
            sslot = self._shared_slot.pop(
                (real, shared.group, clientid), None
            )
            if sslot is not None:
                self._free_opts(sslot)
            removed = True
        else:
            real = flt
            subs = self._subs.get(real)
            if subs is None or clientid not in subs:
                removed = False
            else:
                del subs[clientid]
                if not subs:
                    del self._subs[real]
                bucket = self._csr.get(real)
                row = self._client_rows.get(clientid)
                if bucket is not None and row is not None:
                    freed = bucket.remove(row)
                    if freed is not None:
                        self._free_opts(freed)
                    if not bucket.rows:
                        del self._csr[real]
                removed = True
        self._maybe_drop_route(real)
        filters = self._by_client.get(clientid)
        if filters is not None:
            filters.discard(flt)
            if not filters:
                del self._by_client[clientid]
                self._release_client(clientid)
        return removed

    def _maybe_drop_route(self, real: str) -> None:
        """The real filter's route lives while a direct subscriber or a
        group remains."""
        if real not in self._subs and real not in self._shared_opts:
            self.engine.delete(real)

    def cleanup_client(self, clientid: str) -> None:
        """Drop every subscription of a dead client (its groups too)."""
        for flt in list(self._by_client.get(clientid, ())):
            self.unsubscribe(clientid, flt)

    def subscriptions_of(self, clientid: str) -> Set[str]:
        return set(self._by_client.get(clientid, ()))

    def topics(self) -> List[str]:
        """All indexed real filters."""
        return list(self._subs.keys() | self._shared_opts.keys())

    def subscription_count(self) -> int:
        """Total (client, filter) subscription pairs, shared pairs
        included (rule fids are not subscriptions and are not
        counted)."""
        return sum(len(v) for v in self._subs.values()) + sum(
            len(v) for v in self._shared_opts.values()
        )

    def shared_opts(
        self, real: str, group: str, clientid: str
    ) -> Optional[SubOpts]:
        m = self._shared_opts.get(real)
        return None if m is None else m.get((group, clientid))

    def shared_slot_of(
        self, real: str, group: str, clientid: str
    ) -> Optional[int]:
        """Opts-table slot of one shared subscription (the row a
        window's shared pick contributes to the decision columns)."""
        return self._shared_slot.get((real, group, clientid))

    def opts_slot_of(self, clientid: str, flt: str) -> Optional[int]:
        """Opts-table slot of one client's subscription to ``flt``
        (``$share`` filters included): how the durable-replay window
        resolves each (client, filter) backlog entry to the
        decision-column row its live deliveries ride."""
        share = T.parse_share(flt)
        if share is not None:
            return self._shared_slot.get(
                (share.topic, share.group, clientid))
        bucket = self._csr.get(flt)
        if bucket is None:
            return None
        row = self._client_rows.get(clientid)
        if row is None:
            return None
        return bucket.opts_row_of(row)

    # --------------------------------------------------------- match

    def match_batch(self, topics: Sequence[str]) -> List[Set]:
        """The fids matching each topic: real filters, shared and rule
        fids (one match kernel launch on the card)."""
        return self.engine.match_batch(topics)

    # ----------------------------------------------- window expansion

    def expand_window(
        self, matched: Sequence[Set]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
               List[Tuple[int, List[str]]],
               List[Tuple[int, str, str]]]:
        """CSR-expand one window's matched fid sets to flat delivery
        columns.

        Returns ``(msg_idx, client_rows, opts_rows, rules, shared)``:
        three aligned int64 arrays covering every DIRECT delivery in
        the window, built by one concatenation over the per-filter CSR
        columns; the rule fids grouped per message as ``(msg_idx,
        [rule_id, ...])`` (RAW: unsorted, a multi-filter rule may
        repeat; the rule engine dedups); and the shared-group fids as
        ``(msg_idx, real_filter, group)`` for the shared picks.  Fids
        with no local state (e.g. filters preloaded straight into the
        engine) cost two dict misses each."""
        seg_rows: List[np.ndarray] = []
        seg_opts: List[np.ndarray] = []
        seg_msg: List[int] = []
        seg_len: List[int] = []
        rules: List[Tuple[int, List[str]]] = []
        shared: List[Tuple[int, str, str]] = []
        csr = self._csr
        groups_for = self.shared.groups_for
        rule_i = -1
        rule_ids: List[str] = []
        for i, fids in enumerate(matched):
            for fid in fids:
                if type(fid) is tuple:  # ("rule", rule_id, i)
                    if rule_i != i:
                        rule_i = i
                        rule_ids = []
                        rules.append((i, rule_ids))
                    rule_ids.append(fid[1])
                    continue
                bucket = csr.get(fid)
                if bucket is not None and bucket.rows:
                    r, o = bucket.arrays()
                    seg_rows.append(r)
                    seg_opts.append(o)
                    seg_msg.append(i)
                    seg_len.append(len(r))
                for group in groups_for(fid):
                    shared.append((i, fid, group))
        if not seg_rows:
            return _EMPTY_I64, _EMPTY_I64, _EMPTY_I64, rules, shared
        if len(seg_rows) == 1:
            client_rows, opts_rows = seg_rows[0], seg_opts[0]
            msg_idx = np.full(seg_len[0], seg_msg[0], dtype=np.int64)
        else:
            client_rows = np.concatenate(seg_rows)
            opts_rows = np.concatenate(seg_opts)
            msg_idx = np.repeat(
                np.asarray(seg_msg, dtype=np.int64), seg_len
            )
        return msg_idx, client_rows, opts_rows, rules, shared
