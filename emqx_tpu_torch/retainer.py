"""Retained-message store + replay on subscribe.

Re-creates `emqx_retainer` (EMQX apps/emqx_retainer/src/
emqx_retainer.erl:98-110 backend contract; emqx_retainer_index.erl own
topic index): retained messages keyed by topic in a trie of topic
levels, with *reverse* matching on subscribe — a new filter is walked
against the stored topic names (`match`).  Host code, as in the JAX
package: the store sits on the publish path before the match and never
touches the device.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from . import topic as T
from .message import Message


class _Node:
    __slots__ = ("children", "msg")

    def __init__(self) -> None:
        self.children: Dict[str, _Node] = {}
        self.msg: Optional[Message] = None


class Retainer:
    def __init__(
        self,
        max_retained_messages: int = 0,
        max_payload_size: int = 1024 * 1024,
        msg_expiry_interval: float = 0.0,
        enable: bool = True,
    ) -> None:
        self.enable = enable
        self.max_retained_messages = max_retained_messages
        self.max_payload_size = max_payload_size
        self.msg_expiry_interval = msg_expiry_interval
        self._root = _Node()
        self._count = 0

    def __len__(self) -> int:
        return self._count

    # -------------------------------------------------------- store

    def store(self, msg: Message) -> bool:
        """Apply a retain-flagged publish: empty payload deletes
        ([MQTT-3.3.1-6]); otherwise insert/replace.  Returns False when
        refused (limits)."""
        if not self.enable:
            return False
        if not msg.payload:
            self.delete(msg.topic)
            return True
        if len(msg.payload) > self.max_payload_size:
            return False
        ws = T.words(msg.topic)
        node = self._root
        path = []
        for w in ws:
            path.append(node)
            node = node.children.setdefault(w, _Node())
        if node.msg is None:
            if (
                self.max_retained_messages
                and self._count >= self.max_retained_messages
            ):
                # roll back any freshly created empty path
                self._prune(ws)
                return False
            self._count += 1
        node.msg = msg
        return True

    def delete(self, topic: str) -> bool:
        ws = T.words(topic)
        node = self._root
        for w in ws:
            node = node.children.get(w)
            if node is None:
                return False
        if node.msg is None:
            return False
        node.msg = None
        self._count -= 1
        self._prune(ws)
        return True

    def _prune(self, ws: Tuple[str, ...]) -> None:
        path: List[Tuple[_Node, str]] = []
        node = self._root
        for w in ws:
            nxt = node.children.get(w)
            if nxt is None:
                return
            path.append((node, w))
            node = nxt
        for parent, w in reversed(path):
            child = parent.children[w]
            if child.children or child.msg is not None:
                break
            del parent.children[w]

    # -------------------------------------------------------- match

    def match(self, flt: str, now: Optional[float] = None) -> List[Message]:
        """All live retained messages whose topic matches filter `flt`
        (reverse matching: filter vs stored names)."""
        fw = T.words(T.real_topic(flt))
        now = now if now is not None else time.time()
        out: List[Message] = []
        self._walk(self._root, fw, 0, False, out)
        return [m for m in out if not self._expired(m, now)]

    def _expired(self, msg: Message, now: float) -> bool:
        if msg.expired(now):
            self._maybe_gc(msg)
            return True
        if self.msg_expiry_interval and (
            now > msg.timestamp + self.msg_expiry_interval
        ):
            self._maybe_gc(msg)
            return True
        return False

    def _maybe_gc(self, msg: Message) -> None:
        self.delete(msg.topic)

    def _walk(
        self,
        node: _Node,
        fw: Tuple[str, ...],
        i: int,
        past_root: bool,
        out: List[Message],
    ) -> None:
        if i == len(fw):
            if node.msg is not None:
                out.append(node.msg)
            return
        w = fw[i]
        if w == T.HASH:
            # '#' matches the parent level too; '$'-topics are excluded
            # from root wildcards (emqx_topic.erl:81-84)
            self._collect(node, out, exclude_dollar=not past_root)
            return
        if w == T.PLUS:
            for name, child in node.children.items():
                if not past_root and name.startswith("$"):
                    continue
                self._walk(child, fw, i + 1, True, out)
            return
        child = node.children.get(w)
        if child is not None:
            self._walk(child, fw, i + 1, True, out)

    def _collect(
        self, node: _Node, out: List[Message], exclude_dollar: bool
    ) -> None:
        if node.msg is not None:
            out.append(node.msg)
        for name, child in node.children.items():
            if exclude_dollar and name.startswith("$"):
                continue
            self._collect(child, out, exclude_dollar=False)

    def topics(self) -> List[str]:
        out: List[str] = []

        def rec(node: _Node, path: List[str]) -> None:
            if node.msg is not None:
                out.append("/".join(path))
            for name, child in node.children.items():
                rec(child, path + [name])

        rec(self._root, [])
        return out

    def clear(self) -> None:
        self._root = _Node()
        self._count = 0
