"""Shared-subscription ($share/Group/Topic) group dispatch.

Re-creates `emqx_shared_sub` (EMQX apps/emqx/src/
emqx_shared_sub.erl): group membership per (group, real-filter), the
seven pick strategies (:79-86), per-message pick (`dispatch/4`
:144-166) and redispatch-on-failure.  Single-node for now: the mria
membership table collapses to an in-process registry; `local` strategy
degenerates to `random` until the cluster layer adds node placement.
"""

from __future__ import annotations

import random
import zlib
from typing import Dict, List, Optional, Set, Tuple

from ..message import Message

STRATEGIES = (
    "random",
    "round_robin",
    "round_robin_per_group",
    "sticky",
    "local",
    "hash_clientid",
    "hash_topic",
)


def _hash(s: str) -> int:
    return zlib.crc32(s.encode("utf-8"))


class SharedSubManager:
    def __init__(self, strategy: str = "random", seed: Optional[int] = None):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown shared-sub strategy {strategy!r}")
        self.strategy = strategy
        self._rng = random.Random(seed)
        # (group, filter) -> ordered members (insertion order = join order)
        self._members: Dict[Tuple[str, str], Dict[str, None]] = {}
        # filter -> live groups: dispatch asks "which groups for this
        # matched filter" once per (msg, filter) — an index beats
        # scanning every (group, filter) pair on the hot path
        self._groups_by_filter: Dict[str, Set[str]] = {}
        self._rr: Dict[Tuple[str, str], int] = {}
        self._rr_group: Dict[str, int] = {}
        self._sticky: Dict[Tuple[str, str], str] = {}

    # ------------------------------------------------------ membership

    def join(self, group: str, flt: str, clientid: str) -> bool:
        """Add a member; True if the (group, filter) pair is new (i.e.
        the underlying route must be added)."""
        key = (group, flt)
        members = self._members.get(key)
        if members is None:
            members = self._members[key] = {}
            self._groups_by_filter.setdefault(flt, set()).add(group)
        fresh = not members
        members[clientid] = None
        return fresh

    def leave(self, group: str, flt: str, clientid: str) -> bool:
        """Remove a member; True if the pair became empty (route
        delete needed)."""
        key = (group, flt)
        members = self._members.get(key)
        if members is None:
            return False
        members.pop(clientid, None)
        if self._sticky.get(key) == clientid:
            del self._sticky[key]
        if not members:
            del self._members[key]
            self._rr.pop(key, None)
            groups = self._groups_by_filter.get(flt)
            if groups is not None:
                groups.discard(group)
                if not groups:
                    del self._groups_by_filter[flt]
            return True
        return False

    def leave_all(self, clientid: str) -> List[Tuple[str, str]]:
        """Drop a client from every group (channel death); returns the
        (group, filter) pairs that became empty."""
        emptied = []
        for group, flt in list(self._members):
            if clientid in self._members[(group, flt)]:
                if self.leave(group, flt, clientid):
                    emptied.append((group, flt))
        return emptied

    def groups_for(self, flt: str) -> List[str]:
        groups = self._groups_by_filter.get(flt)
        return list(groups) if groups else []

    def members(self, group: str, flt: str) -> List[str]:
        return list(self._members.get((group, flt), ()))

    # ---------------------------------------------------------- pick

    def pick(
        self,
        group: str,
        flt: str,
        msg: Message,
        exclude: Optional[Set[str]] = None,
    ) -> Optional[str]:
        """Choose the receiving member for one message; ``exclude``
        carries previously-failed members during redispatch
        (emqx_shared_sub:redispatch)."""
        key = (group, flt)
        members = [
            m
            for m in self._members.get(key, ())
            if not exclude or m not in exclude
        ]
        if not members:
            return None
        s = self.strategy
        if s == "sticky":
            cur = self._sticky.get(key)
            if cur is not None and cur in members:
                return cur
            picked = self._rng.choice(members)
            self._sticky[key] = picked
            return picked
        if s == "round_robin":
            i = self._rr.get(key, 0)
            self._rr[key] = i + 1
            return members[i % len(members)]
        if s == "round_robin_per_group":
            i = self._rr_group.get(group, 0)
            self._rr_group[group] = i + 1
            return members[i % len(members)]
        if s == "hash_clientid":
            return members[_hash(msg.from_client) % len(members)]
        if s == "hash_topic":
            return members[_hash(msg.topic) % len(members)]
        # random | local (no node placement yet)
        return self._rng.choice(members)
