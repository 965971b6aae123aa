"""Bounded priority message queue with drop policies.

Re-creates `emqx_mqueue` (EMQX apps/emqx/src/emqx_mqueue.erl):
per-topic priorities, bounded length, QoS-0 bypass option, and the
drop-oldest-on-overflow behavior (the reference drops the head of the
lowest non-empty priority band when full).
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Iterator, List, Optional

from ..message import Message

LOWEST = "lowest"
HIGHEST = "highest"


class MQueue:
    def __init__(
        self,
        max_len: int = 1000,
        priorities: Optional[Dict[str, int]] = None,
        default_priority: str = LOWEST,
        store_qos0: bool = True,
    ) -> None:
        self.max_len = max_len
        self.priorities = priorities or {}
        self.default_priority = default_priority
        self.store_qos0 = store_qos0
        # priority -> FIFO; kept sparse, highest priority served first
        self._bands: Dict[int, Deque[Message]] = {}
        self._len = 0
        self.dropped = 0

    def __len__(self) -> int:
        return self._len

    def is_empty(self) -> bool:
        return self._len == 0

    def _priority(self, topic: str) -> int:
        p = self.priorities.get(topic)
        if p is not None:
            return p
        if self.default_priority == HIGHEST:
            return max(self.priorities.values(), default=0) + 1
        return 0

    def insert(self, msg: Message) -> Optional[Message]:
        """Enqueue; returns the dropped message if the queue was full
        (or the message itself if it is undeliverable by policy)."""
        if msg.qos == 0 and not self.store_qos0:
            self.dropped += 1
            return msg
        band = self._priority(msg.topic)
        q = self._bands.get(band)
        if q is None:
            q = self._bands[band] = deque()
        dropped: Optional[Message] = None
        if self.max_len > 0 and self._len >= self.max_len:
            dropped = self._drop_lowest()
        q.append(msg)
        self._len += 1
        return dropped

    def _drop_lowest(self) -> Optional[Message]:
        for band in sorted(self._bands):
            q = self._bands[band]
            if q:
                self.dropped += 1
                self._len -= 1
                return q.popleft()
        return None

    def pop(self) -> Optional[Message]:
        for band in sorted(self._bands, reverse=True):
            q = self._bands[band]
            if q:
                self._len -= 1
                return q.popleft()
        return None

    def peek(self) -> Optional[Message]:
        for band in sorted(self._bands, reverse=True):
            q = self._bands[band]
            if q:
                return q[0]
        return None

    def drain(self, n: int) -> List[Message]:
        out: List[Message] = []
        while len(out) < n:
            m = self.pop()
            if m is None:
                break
            out.append(m)
        return out

    def __iter__(self) -> Iterator[Message]:
        for band in sorted(self._bands, reverse=True):
            yield from self._bands[band]
