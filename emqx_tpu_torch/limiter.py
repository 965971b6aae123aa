"""Rate limiting: hierarchical token buckets on the connection path.

The `emqx_limiter` role (EMQX apps/emqx/src/emqx_limiter/, hierarchical
token buckets integrated with esockd's activation): a connection draws
from up to THREE levels — its own buckets, the listener's SHARED
buckets (all connections of one listener compete for the aggregate
rate), and the node/zone's shared buckets.  An exhausted bucket at any
level PAUSES the read loop (TCP backpressure throttles the client)
instead of disconnecting, exactly like EMQX hibernating the socket.
The PublishBatcher watermark (broker.py) bounds the queued volume
beside them.
"""

from __future__ import annotations

import time
from typing import Optional


class TokenBucket:
    """rate tokens/second, bursting to `burst`.  ``consume`` reports the
    seconds to wait before the deficit is refilled (0.0 = proceed)."""

    def __init__(
        self,
        rate: float,
        burst: Optional[float] = None,
        max_debt: Optional[float] = None,
    ) -> None:
        self.rate = float(rate)
        # the configured rate: `clamp` scales the live rate against
        # this base (olp L2 listener clamp), factor 1.0 restores it
        self.base_rate = self.rate
        self.burst = float(burst if burst is not None else rate)
        # PRIVATE buckets cap debt at one burst: a single oversized
        # read must not become an unbounded pause (keepalives would
        # starve and the client would die by timeout, not throttle).
        # SHARED buckets (listener/zone aggregate) need max_debt=inf:
        # with a cap, N connections hitting the bucket at once saturate
        # the debt instead of accumulating it, and the aggregate rate
        # scales with N instead of staying at `rate`.
        self.max_debt = float(
            max_debt if max_debt is not None else self.burst
        )
        self.tokens = self.burst
        self._at = time.monotonic()

    def consume(self, n: float, now: Optional[float] = None) -> float:
        now = now if now is not None else time.monotonic()
        self.tokens = min(
            self.burst, self.tokens + (now - self._at) * self.rate
        )
        self._at = now
        self.tokens = max(self.tokens - n, -self.max_debt)
        if self.tokens >= 0:
            return 0.0
        return -self.tokens / self.rate  # time until balance reaches 0

    def clamp(self, factor: float) -> None:
        """Scale the admitted rate to ``factor`` of the configured
        base (the olp ladder's L2 aggregate-bucket clamp); 1.0
        restores.  Outstanding debt drains at the clamped rate, so a
        clamp under load tightens immediately."""
        self.rate = self.base_rate * max(float(factor), 1e-9)


class ConnectionLimiter:
    """Message-rate + byte-rate buckets for one connection."""

    def __init__(
        self,
        messages_rate: float = 0.0,
        bytes_rate: float = 0.0,
        messages_burst: Optional[float] = None,
        bytes_burst: Optional[float] = None,
        shared: bool = False,
    ) -> None:
        # shared (aggregate) buckets accumulate debt without a cap so
        # the combined admitted rate stays at the configured rate no
        # matter how many connections compete — see TokenBucket
        debt = float("inf") if shared else None
        self.msg_bucket = (
            TokenBucket(messages_rate, messages_burst, max_debt=debt)
            if messages_rate > 0
            else None
        )
        self.byte_bucket = (
            TokenBucket(bytes_rate, bytes_burst, max_debt=debt)
            if bytes_rate > 0
            else None
        )

    def consume(self, n_bytes: int, n_messages: int) -> float:
        """Returns the pause (seconds) the read loop owes before
        continuing — the max of both buckets' deficits."""
        delay = 0.0
        now = time.monotonic()
        if self.byte_bucket is not None and n_bytes:
            delay = max(delay, self.byte_bucket.consume(n_bytes, now))
        if self.msg_bucket is not None and n_messages:
            delay = max(delay, self.msg_bucket.consume(n_messages, now))
        return delay

    def clamp(self, factor: float) -> None:
        """Scale both buckets' rates (see `TokenBucket.clamp`)."""
        if self.msg_bucket is not None:
            self.msg_bucket.clamp(factor)
        if self.byte_bucket is not None:
            self.byte_bucket.clamp(factor)


class HierarchicalLimiter:
    """One connection's view of the limiter tree: its private buckets
    plus any SHARED levels (listener aggregate, node/zone aggregate —
    plain `ConnectionLimiter`s consumed by every connection of the
    scope).  The pause owed is the max deficit across levels, so the
    tightest bound wins (emqx_htb_limiter's semantics, flattened)."""

    def __init__(self, *levels) -> None:
        self.levels = [lv for lv in levels if lv is not None]

    def consume(self, n_bytes: int, n_messages: int) -> float:
        return max(
            (lv.consume(n_bytes, n_messages) for lv in self.levels),
            default=0.0,
        )
