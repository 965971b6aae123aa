"""ctypes binding for the native host trie (``native/hosttrie.cpp``).

The interface twin of `trie_host.HostTrie` — insert/insert_batch/
delete_id/match/match_words/last_seq/match_since_words/filters/len/
contains — with the mutation and match walks in C++.  Arbitrary Python
fid objects intern to dense int64 handles at this boundary; the fid ->
words mirror that rebuild snapshots read stays on the Python side.

`make_trie()` returns a NativeTrie, and raises when its library does
not build; ``make_trie(native=False)`` returns the Python HostTrie,
which matches identically.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterator, List, Tuple

import numpy as np

from .. import topic as T
from . import _native
from .trie_host import HostTrie


class NativeTrie:
    """C++-backed trie with the HostTrie interface."""

    def __init__(self) -> None:
        self._lib = _native.load("hosttrie")
        self._h = self._lib.ht_new()
        # fid object <-> dense int64 handle interning
        self._ids: Dict[Hashable, int] = {}
        self._rev: List[Hashable] = []
        self._free: List[int] = []
        # fid -> words mirror (read by rebuild snapshots)
        self._filters: Dict[Hashable, Tuple[str, ...]] = {}
        self._buf = np.empty(1024, np.int64)
        self._buf_p = _native.ptr(self._buf)
        self._ht_match = self._lib.ht_match  # one attribute lookup less

    def __del__(self) -> None:
        lib, h = getattr(self, "_lib", None), getattr(self, "_h", None)
        if lib is not None and h:
            lib.ht_free(h)
            self._h = None

    def __len__(self) -> int:
        return len(self._filters)

    def __contains__(self, fid: Hashable) -> bool:
        return fid in self._filters

    def filters(self) -> Iterator[Tuple[Hashable, Tuple[str, ...]]]:
        return iter(self._filters.items())

    def _intern(self, fid: Hashable) -> int:
        # non-negative ints pass through as even handles (no table);
        # everything else interns to odd handles — the two spaces can't
        # collide, so mixed int/str/tuple fid sets stay distinct
        if type(fid) is int and fid >= 0:
            return fid << 1
        iid = self._ids.get(fid)
        if iid is None:
            if self._free:
                iid = self._free.pop()
                self._rev[iid] = fid
            else:
                iid = len(self._rev)
                self._rev.append(fid)
            self._ids[fid] = iid
        return (iid << 1) | 1

    def insert(self, flt: str, fid: Hashable,
               ws: Tuple[str, ...] = None) -> int:
        """Insert ``flt`` under ``fid`` (replacing the fid's earlier
        filter); returns the monotonically increasing sequence tag, 0
        when unchanged — `match_since_words` filters on it."""
        if ws is None:
            ws = T.words(flt)
        if self._filters.get(fid) == ws:
            return 0
        seq = self._lib.ht_insert(self._h, flt.encode(), self._intern(fid))
        self._filters[fid] = ws
        return seq

    def insert_batch(self, items) -> List[int]:
        """Insert ``(flt, fid, ws)`` triples in ONE GIL-released call;
        returns the per-item sequence tags (0 where unchanged)."""
        n = len(items)
        parts = [flt.encode() for flt, _fid, _ws in items]
        fids = np.fromiter((self._intern(fid) for _f, fid, _w in items),
                           np.int64, count=n)
        lens = np.fromiter((len(p) for p in parts), np.int64, count=n)
        starts = np.zeros(n, np.int64)
        if n:
            np.cumsum(lens[:-1], out=starts[1:])
        seqs = np.empty(n, np.int64)
        self._lib.ht_insert_batch(
            self._h, b"".join(parts), _native.ptr(starts),
            _native.ptr(lens), _native.ptr(fids), n, _native.ptr(seqs))
        for _flt, fid, ws in items:
            self._filters[fid] = ws
        return seqs.tolist()

    def delete_id(self, fid: Hashable) -> bool:
        if fid not in self._filters:
            return False
        del self._filters[fid]
        if type(fid) is int and fid >= 0:
            self._lib.ht_delete(self._h, fid << 1)
            return True
        iid = self._ids.pop(fid)
        self._lib.ht_delete(self._h, (iid << 1) | 1)
        self._rev[iid] = None
        self._free.append(iid)
        return True

    def _grow(self, n: int) -> None:
        self._buf = np.empty(int(n) * 2, np.int64)
        self._buf_p = _native.ptr(self._buf)

    def _decode(self, n: int) -> set:
        vals = self._buf[:n].tolist()
        if not self._ids:  # no interned fid: every handle is fid << 1
            return {x >> 1 for x in vals}
        rev = self._rev
        return {rev[x >> 1] if x & 1 else x >> 1 for x in vals}

    def match(self, name: str) -> set:
        raw = name.encode()
        n = self._ht_match(self._h, raw, self._buf_p, len(self._buf))
        if n > len(self._buf):  # the buffer grows and the walk repeats
            self._grow(n)
            n = self._ht_match(self._h, raw, self._buf_p, len(self._buf))
        return self._decode(n)

    def match_words(self, name: Tuple[str, ...]) -> set:
        return self.match("/".join(name))

    def last_seq(self) -> int:
        return self._lib.ht_seq(self._h)

    def match_since_words(self, name: Tuple[str, ...], min_seq: int) -> set:
        """Matches restricted to filters inserted with seq >= min_seq
        (the residual-since-watermark view)."""
        raw = "/".join(name).encode()
        since = self._lib.ht_match_since
        n = since(self._h, raw, min_seq, self._buf_p, len(self._buf))
        if n > len(self._buf):
            self._grow(n)
            n = since(self._h, raw, min_seq, self._buf_p, len(self._buf))
        return self._decode(n)


def make_trie(native: bool = True):
    """A NativeTrie, or with ``native=False`` the Python HostTrie."""
    return NativeTrie() if native else HostTrie()
