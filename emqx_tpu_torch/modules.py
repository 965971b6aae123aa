"""Broker modules: `$exclusive/` subscriptions.

The `emqx_exclusive_subscription.erl` feature of `emqx_modules`.  The
JAX package's delayed publish, topic rewrite and topic metrics ride its
hook registry, which the port does not have yet.
"""

from __future__ import annotations

from typing import Dict


class ExclusiveSub:
    """`$exclusive/<topic>` subscriptions: a cluster-wide-unique holder
    per real topic (emqx_exclusive_subscription.erl; node-local here,
    the registry is this broker's)."""

    PREFIX = "$exclusive/"

    def __init__(self) -> None:
        self._holders: Dict[str, str] = {}  # real topic -> clientid

    def acquire(self, clientid: str, real: str) -> bool:
        held = self._holders.get(real)
        if held is not None and held != clientid:
            return False
        self._holders[real] = clientid
        return True

    def release(self, clientid: str, real: str) -> None:
        if self._holders.get(real) == clientid:
            del self._holders[real]

    def release_all(self, clientid: str) -> None:
        for real in [
            r for r, c in self._holders.items() if c == clientid
        ]:
            del self._holders[real]
