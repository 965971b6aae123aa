"""Connection/session manager: clientid -> (session, live channel).

Re-creates `emqx_cm` (EMQX apps/emqx/src/emqx_cm.erl):
``open_session`` with clean-start discard vs resume (:276-303), the
takeover protocol (:314-317) where a new connection steals the session
from a still-live channel, kick/discard, and dead-channel cleanup.
Single process ⇒ the per-clientid distributed lock (`emqx_cm_locker`)
collapses to dict operations on the event loop.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Protocol, Tuple

from .session import Session


class ChannelLike(Protocol):
    """What the CM needs from a live channel: push packets out and be
    closeable (takeover/kick)."""

    def send_packets(self, packets: List[object]) -> None: ...

    def close(self, reason: str) -> None: ...


class _Entry:
    __slots__ = ("session", "channel", "disconnected_at")

    def __init__(self, session: Session, channel: Optional[ChannelLike]):
        self.session = session
        self.channel = channel
        self.disconnected_at: Optional[float] = None


class ConnectionManager:
    def __init__(self, session_factory: Callable[..., Session]) -> None:
        self._entries: Dict[str, _Entry] = {}
        self._session_factory = session_factory
        # wired by the broker: a discarded session's router state goes
        self.on_discarded: Optional[Callable[[Session], None]] = None
        # wired by the broker: counts a session a new channel took over
        self.on_takenover: Optional[Callable[[Session], None]] = None
        # wired by the broker when durable storage is on: fired with the
        # clientid whenever a persistent session's channel detaches, so
        # a mid-replay resume job releases its replay slot at once
        self.on_detached: Optional[Callable[[str], None]] = None

    def __len__(self) -> int:
        return len(self._entries)

    # ------------------------------------------------------- lookup

    def lookup(self, clientid: str) -> Optional[Session]:
        e = self._entries.get(clientid)
        return None if e is None else e.session

    def channel(self, clientid: str) -> Optional[ChannelLike]:
        e = self._entries.get(clientid)
        return None if e is None else e.channel

    def connected(self, clientid: str) -> bool:
        e = self._entries.get(clientid)
        return e is not None and e.channel is not None

    def clients(self) -> List[str]:
        return list(self._entries)

    # ------------------------------------------------- session open

    def open_session(
        self,
        clean_start: bool,
        clientid: str,
        channel: ChannelLike,
        **session_kwargs,
    ) -> Tuple[Session, bool]:
        """Returns (session, session_present).  Mirrors
        emqx_cm:open_session/3: clean_start discards any existing
        session; otherwise the existing session is taken over (its old
        channel, if still live, is closed)."""
        existing = self._entries.get(clientid)
        if existing is not None:
            if existing.channel is not None:
                existing.channel.close("takenover")
                if self.on_takenover:
                    self.on_takenover(existing.session)
            if clean_start:
                if self.on_discarded:
                    self.on_discarded(existing.session)
                existing = None
        if clean_start or existing is None:
            session = self._session_factory(
                clientid=clientid, clean_start=clean_start, **session_kwargs
            )
            self._entries[clientid] = _Entry(session, channel)
            return session, False
        existing.channel = channel
        existing.disconnected_at = None
        return existing.session, True

    # ---------------------------------------------------- lifecycle

    def remove(self, clientid: str) -> bool:
        """Silently drop an entry (no discard callback)."""
        return self._entries.pop(clientid, None) is not None

    def kick(self, clientid: str) -> bool:
        """Forcibly remove a client: close the live channel and discard
        the session."""
        e = self._entries.pop(clientid, None)
        if e is None:
            return False
        if e.channel is not None:
            e.channel.close("kicked")
        if self.on_discarded:
            self.on_discarded(e.session)
        return True

    def disconnect(self, clientid: str, channel: ChannelLike) -> None:
        """Channel died/closed.  Sessions with expiry keep their state
        for resume; clean sessions are dropped."""
        e = self._entries.get(clientid)
        if e is None or e.channel is not channel:
            return  # stale close after takeover
        e.channel = None
        e.disconnected_at = time.time()
        if e.session.expiry_interval <= 0:
            del self._entries[clientid]
        elif self.on_detached is not None:
            self.on_detached(clientid)

    def expire_sessions(self, now: Optional[float] = None) -> List[str]:
        """Drop detached sessions past their expiry interval."""
        now = now if now is not None else time.time()
        dead = [
            cid
            for cid, e in self._entries.items()
            if e.channel is None
            and e.disconnected_at is not None
            and now - e.disconnected_at > e.session.expiry_interval
        ]
        for cid in dead:
            e = self._entries.pop(cid)
            if self.on_discarded:
                self.on_discarded(e.session)
        return dead
