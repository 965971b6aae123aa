"""Priority-ordered hook chains: the extension spine.

EMQX's hook system (`emqx_hooks:run/2`, `run_fold/3` in
apps/emqx/src/emqx_hooks.erl; hookpoint inventory emqx_hookpoints.erl)
without the gen_server: a plain registry of callback chains, sorted by
descending priority then registration order, as in the JAX package.
Callbacks signal flow control by return value:

  * ``run`` (notify):   return ``STOP`` to halt the chain, anything
    else to continue.
  * ``run_fold`` (transform): return ``STOP`` to halt keeping the
    current accumulator, ``STOP_WITH(v)`` to halt replacing it,
    ``None`` to pass the accumulator through unchanged, any other
    value to replace the accumulator and continue.
"""

from __future__ import annotations

import bisect
import functools
import itertools
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

# the core hookpoints (emqx_hookpoints.erl:40-71); registration is not
# limited to these, but they document the broker's extension surface
HOOKPOINTS = (
    "client.connect",
    "client.connack",
    "client.connected",
    "client.disconnected",
    "client.authenticate",
    "client.authorize",
    "client.subscribe",
    "client.unsubscribe",
    "session.created",
    "session.subscribed",
    "session.unsubscribed",
    "session.resumed",
    "session.discarded",
    "session.takenover",
    "session.terminated",
    "message.publish",
    "message.puback",
    "message.delivered",
    "message.acked",
    "message.dropped",
    "delivery.dropped",
)


class _Stop:
    __slots__ = ("value", "has_value")

    def __init__(self, value: Any = None, has_value: bool = False):
        self.value = value
        self.has_value = has_value

    def __repr__(self) -> str:
        return f"STOP_WITH({self.value!r})" if self.has_value else "STOP"


STOP = _Stop()


def STOP_WITH(value: Any) -> _Stop:
    return _Stop(value, True)


def with_async(sync_fn: Callable[..., Any],
               async_fn: Callable[..., Any]) -> Callable[..., Any]:
    """Pair a blocking callback with a coroutine twin.  Chains walked
    by ``run_fold``/``run`` call ``sync_fn``; the ``*_async`` walkers
    prefer ``async_fn`` so IO-backed hooks (exhook verdict RPCs) wait
    off the event loop instead of stalling every connection on it."""

    @functools.wraps(sync_fn)
    def wrapper(*args: Any) -> Any:
        return sync_fn(*args)

    wrapper.async_fn = async_fn  # type: ignore[attr-defined]
    return wrapper


class Callback(NamedTuple):
    priority: int
    seq: int
    fn: Callable[..., Any]

    def sort_key(self) -> Tuple[int, int]:
        # higher priority first; ties in registration order
        return (-self.priority, self.seq)


class HookRegistry:
    def __init__(self) -> None:
        self._chains: Dict[str, List[Callback]] = {}
        self._seq = itertools.count()
        # names with >=1 async-capable callback, kept as counts so
        # `has_async` is an O(1) hot-path check (the publish/authorize
        # paths consult it per packet)
        self._async_counts: Dict[str, int] = {}

    def add(
        self, name: str, fn: Callable[..., Any], priority: int = 0
    ) -> Callback:
        cb = Callback(priority, next(self._seq), fn)
        chain = self._chains.setdefault(name, [])
        bisect.insort(chain, cb, key=Callback.sort_key)
        if getattr(fn, "async_fn", None) is not None:
            self._async_counts[name] = self._async_counts.get(name, 0) + 1
        return cb

    def delete(self, name: str, fn_or_cb: Any) -> bool:
        chain = self._chains.get(name, [])
        for i, cb in enumerate(chain):
            if cb is fn_or_cb or cb.fn is fn_or_cb:
                del chain[i]
                if getattr(cb.fn, "async_fn", None) is not None:
                    n = self._async_counts.get(name, 1) - 1
                    if n <= 0:
                        self._async_counts.pop(name, None)
                    else:
                        self._async_counts[name] = n
                return True
        return False

    def has_async(self, name: str) -> bool:
        return name in self._async_counts

    def has(self, name: str) -> bool:
        """O(1) is-anything-registered probe: the dispatch window uses
        it to skip the ``message.delivered`` walk (and the per-run
        delivery-list materialization feeding it) entirely when nobody
        registered a callback."""
        return bool(self._chains.get(name))

    def callbacks(self, name: str) -> List[Callback]:
        return list(self._chains.get(name, ()))

    def run(self, name: str, *args: Any) -> None:
        """Notify chain: each callback sees the same args; a ``STOP``
        return halts the chain (emqx_hooks:run/2).  Iterates a
        SNAPSHOT: registrations may land from other threads (e.g. an
        exhook dial completing in an executor) mid-dispatch."""
        for cb in tuple(self._chains.get(name, ())):
            res = cb.fn(*args)
            if isinstance(res, _Stop):
                return

    def run_fold(self, name: str, args: Tuple[Any, ...], acc: Any) -> Any:
        """Transform chain: callbacks get ``(*args, acc)`` and may
        replace the accumulator (emqx_hooks:run_fold/3).  Snapshot
        iteration, as in `run`."""
        for cb in tuple(self._chains.get(name, ())):
            res = cb.fn(*args, acc)
            if isinstance(res, _Stop):
                return res.value if res.has_value else acc
            if res is not None:
                acc = res
        return acc

    async def run_fold_async(
        self, name: str, args: Tuple[Any, ...], acc: Any
    ) -> Any:
        """`run_fold` that awaits async-capable callbacks (registered
        via `with_async`) so IO hooks never block the event loop; pure
        callbacks run inline with identical semantics."""
        for cb in tuple(self._chains.get(name, ())):
            afn = getattr(cb.fn, "async_fn", None)
            if afn is not None:
                res = await afn(*args, acc)
            else:
                res = cb.fn(*args, acc)
            if isinstance(res, _Stop):
                return res.value if res.has_value else acc
            if res is not None:
                acc = res
        return acc
