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

    def insert(self, key: int, value: Any) -> None:
        if key in self._d:
            raise KeyError(f"packet id {key} already in flight")
        self._d[key] = value

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
