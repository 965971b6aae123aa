"""Broker-internal message representation.

The reference converts wire packets into `#message{}` records before
routing (`emqx_packet:to_message`, EMQX apps/emqx/src/
emqx_packet.erl:467-498; record fields in emqx/include/emqx.hrl).  Here
the analogue is a small dataclass carrying the routing-relevant fields
plus MQTT 5 properties; payload stays opaque bytes.
"""

from __future__ import annotations

import itertools
import os
import struct
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

_guid_counter = itertools.count()
_guid_node = os.getpid() & 0xFFFF


def new_guid() -> bytes:
    """Monotonic-ish 16-byte message id: (ns timestamp, pid, counter).
    Plays the role of `emqx_guid:gen/0` (apps/emqx/src/emqx_guid.erl) —
    unique per broker process, roughly time-ordered."""
    return struct.pack(
        ">QHHI",
        time.time_ns() & 0xFFFFFFFFFFFFFFFF,
        _guid_node,
        0,
        next(_guid_counter) & 0xFFFFFFFF,
    )


@dataclass
class Message:
    topic: str
    payload: bytes = b""
    qos: int = 0
    retain: bool = False
    from_client: str = ""
    from_username: Optional[str] = None
    mid: bytes = field(default_factory=new_guid)
    timestamp: float = field(default_factory=time.time)
    properties: Dict[str, object] = field(default_factory=dict)
    # broker-internal metadata that never reaches the wire (the
    # reference's #message.headers)
    headers: Dict[str, object] = field(default_factory=dict)
    # broker-internal flags (sys: $SYS self-publishes skip some hooks;
    # dup: redelivery)
    sys: bool = False
    dup: bool = False

    def expired(self, now: Optional[float] = None) -> bool:
        """MQTT 5 message-expiry-interval check (emqx_message:is_expired,
        apps/emqx/src/emqx_message.erl:270-283)."""
        interval = self.properties.get("message_expiry_interval")
        if interval is None:
            return False
        return (now if now is not None else time.time()) > (
            self.timestamp + float(interval)  # type: ignore[arg-type]
        )

    def remaining_expiry(self, now: Optional[float] = None) -> Optional[int]:
        """Expiry seconds left (to rewrite the property on delivery, per
        MQTT 5 [MQTT-3.3.2-6])."""
        interval = self.properties.get("message_expiry_interval")
        if interval is None:
            return None
        left = self.timestamp + float(interval) - (  # type: ignore[arg-type]
            now if now is not None else time.time()
        )
        return max(0, int(left))
