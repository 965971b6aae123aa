"""Host-side wildcard-filter trie: the CPU fallback matcher and the
correctness oracle for the TPU automaton.

Result-equivalent to the reference's v2 index (`emqx_trie_search`
skip-scan over an ordered key set, EMQX apps/emqx/src/
emqx_trie_search.erl:230-348) but implemented as a pointer trie — the
natural Python shape; the skip-scan exists in the reference only because
its substrate is an ordered ETS table.  Matching cost is
O(matching-branches × levels), same complexity class as the reference
(module doc emqx_trie_search.erl:49-66).

Every unique filter string gets at most one entry per caller-supplied id;
id -> subscriber fan-out lives above this layer (the Router).
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterator, List, Optional, Set, Tuple

from .. import topic as T

_PLUS = T.PLUS
_HASH = T.HASH


class _Node:
    __slots__ = ("children", "exact_ids", "hash_ids")

    def __init__(self) -> None:
        self.children: Dict[str, _Node] = {}
        # ids of filters ending exactly at this node
        self.exact_ids: Set[Hashable] = set()
        # ids of filters '<path-to-here>/#'
        self.hash_ids: Set[Hashable] = set()


class HostTrie:
    """Mutable trie over topic-filter levels with wildcard matching."""

    def __init__(self) -> None:
        self._root = _Node()
        self._filters: Dict[Hashable, Tuple[str, ...]] = {}
        # fid -> insertion sequence tag (the match_since residual view)
        self._seqs: Dict[Hashable, int] = {}
        self._seq = 0

    def __len__(self) -> int:
        return len(self._filters)

    def __contains__(self, fid: Hashable) -> bool:
        return fid in self._filters

    def filters(self) -> Iterator[Tuple[Hashable, Tuple[str, ...]]]:
        return iter(self._filters.items())

    def insert(
        self, flt: str, fid: Hashable, ws: Optional[Tuple[str, ...]] = None
    ) -> int:
        """Insert filter `flt` under id `fid`. Re-inserting the same id
        replaces its previous filter.  ``ws`` skips the re-split when
        the caller already has the words.  Returns the monotonically
        increasing sequence tag (0 when unchanged)."""
        if ws is None:
            ws = T.words(flt)
        if fid in self._filters:
            if self._filters[fid] == ws:
                return 0
            self.delete_id(fid)
        node = self._root
        terminal_hash = ws and ws[-1] == _HASH
        body = ws[:-1] if terminal_hash else ws
        for w in body:
            node = node.children.setdefault(w, _Node())
        (node.hash_ids if terminal_hash else node.exact_ids).add(fid)
        self._filters[fid] = ws
        self._seq += 1
        self._seqs[fid] = self._seq
        return self._seq

    def insert_batch(self, items) -> List[int]:
        """Insert ``(flt, fid, ws)`` triples (the interface twin of
        `NativeTrie.insert_batch`); returns the per-item sequence tags."""
        return [self.insert(flt, fid, ws=ws) for flt, fid, ws in items]

    def delete_id(self, fid: Hashable) -> bool:
        ws = self._filters.pop(fid, None)
        if ws is None:
            return False
        self._seqs.pop(fid, None)
        terminal_hash = ws and ws[-1] == _HASH
        body = ws[:-1] if terminal_hash else ws
        # walk down recording the path so empty nodes can be pruned
        path: List[Tuple[_Node, str]] = []
        node = self._root
        for w in body:
            nxt = node.children.get(w)
            if nxt is None:
                return False
            path.append((node, w))
            node = nxt
        (node.hash_ids if terminal_hash else node.exact_ids).discard(fid)
        for parent, w in reversed(path):
            child = parent.children[w]
            if child.children or child.exact_ids or child.hash_ids:
                break
            del parent.children[w]
        return True

    def match(self, name: str) -> Set[Hashable]:
        return self.match_words(T.words(name))

    def match_words(self, name: Tuple[str, ...]) -> Set[Hashable]:
        """All filter ids matching concrete topic `name`, with the MQTT
        rules: '+'/'#' per-level, '#' also matches its parent, root
        wildcards excluded for '$'-topics."""
        out: Set[Hashable] = set()
        dollar = bool(name) and name[0].startswith("$")
        # stack of (node, next-level-index); the '$'-exclusion is the
        # i == 0 plus-guard below plus the root hash_ids subtraction after
        stack: List[Tuple[_Node, int]] = [(self._root, 0)]
        n = len(name)
        while stack:
            node, i = stack.pop()
            out |= node.hash_ids
            if i == n:
                out |= node.exact_ids
                continue
            w = name[i]
            lit = node.children.get(w)
            if lit is not None:
                stack.append((lit, i + 1))
            if not (dollar and i == 0):
                plus = node.children.get(_PLUS)
                if plus is not None:
                    stack.append((plus, i + 1))
        # root '#' must not match '$'-topics; root hash_ids were added
        # before the dollar guard could apply, so correct for it here.
        if dollar:
            out -= self._root.hash_ids
        return out

    def last_seq(self) -> int:
        return self._seq

    def match_since_words(
        self, name: Tuple[str, ...], min_seq: int
    ) -> Set[Hashable]:
        """Matches restricted to filters inserted with seq >= min_seq
        (the residual-since-watermark view; the native trie filters
        during the walk, this fallback filters after)."""
        seqs = self._seqs
        return {
            fid for fid in self.match_words(name)
            if seqs.get(fid, 0) >= min_seq
        }
