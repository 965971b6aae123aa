"""Bounded in-flight window keyed by packet id.

`emqx_inflight` (EMQX apps/emqx/src/emqx_inflight.erl) is a
gb_trees window; insertion order is what retransmit-on-reconnect needs,
so a plain insertion-ordered dict (Python guarantees order) suffices.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple


class Inflight:
    def __init__(self, max_size: int = 32) -> None:
        self.max_size = max_size
        self._d: Dict[int, Any] = {}

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: int) -> bool:
        return key in self._d

    def is_full(self) -> bool:
        return self.max_size > 0 and len(self._d) >= self.max_size

    def room_for(self, n: int) -> bool:
        """Can the window absorb ``n`` more entries right now?  The
        native run path's all-or-nothing gate: a run that would
        overflow takes the per-delivery loop, which queues the
        overflow one delivery at a time."""
        return self.max_size <= 0 or len(self._d) + n <= self.max_size

    def insert(self, key: int, value: Any) -> None:
        if key in self._d:
            raise KeyError(f"packet id {key} already in flight")
        self._d[key] = value

    def insert_seq(self, lo: int, values) -> None:
        """Insert ``values`` under the keys ``lo..lo+n-1``, which the
        caller has proven free (`free_range`): one dict.update."""
        self._d.update(zip(range(lo, lo + len(values)), values))

    def free_range(self, lo: int, hi: int) -> bool:
        """True when no key lies in [lo, hi]."""
        return self._d.keys().isdisjoint(range(lo, hi + 1))

    def update(self, key: int, value: Any) -> None:
        if key not in self._d:
            raise KeyError(key)
        self._d[key] = value  # preserves original insertion order

    def delete(self, key: int) -> Optional[Any]:
        return self._d.pop(key, None)

    def get(self, key: int) -> Optional[Any]:
        return self._d.get(key)

    def items(self) -> List[Tuple[int, Any]]:
        return list(self._d.items())

    def values(self) -> Iterator[Any]:
        return iter(self._d.values())

    def clear(self) -> None:
        self._d.clear()
