"""Tracepoints, causal trace assertions and fault injection.

The engine's fold and swap code carries named tracepoints
(``tp.tp("fold_adopt", gen=3)``).  Tests install a collector to record
them, pin an interleaving with `force_ordering`, or make a tracepoint
raise with `inject`; the engine's race tests drive them.  Production
cost is one module-level bool check per tracepoint; everything else
exists only while a test collector is installed.  A copy of the JAX
package's ``tp`` module.

Usage (tests):

    with tp.collect() as trace:
        ... run concurrent code containing tp.tp("fold_adopt", gen=3) ...
    tp.assert_order(trace, "fold_capture", "fold_adopt")

Deterministic interleaving:

    with tp.collect() as trace, tp.force_ordering(
        after="match_snapshot", block="fold_adopt"
    ):
        ...  # every fold_adopt now waits until a match_snapshot fired

Fault injection:

    with tp.inject("fold_assemble_done", RuntimeError("boom")):
        ...  # the traced code raises at that point
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

enabled = False  # fast-path gate: production pays one bool check

_lock = threading.Lock()
_events: Optional[List[Dict[str, Any]]] = None
_orderings: List[Tuple[str, str, threading.Event]] = []
_injections: Dict[str, BaseException] = {}


def tp(point: str, **fields) -> None:
    """Record a tracepoint (no-op unless a collector is active)."""
    if not enabled:
        return
    _fire(point, fields)


def _fire(point: str, fields: Dict[str, Any]) -> None:
    waiters = []
    with _lock:
        if _events is not None:
            _events.append({
                "tp": point,
                "ts": time.monotonic(),
                "thread": threading.current_thread().name,
                **fields,
            })
        exc = _injections.get(point)
        for after, block, evt in _orderings:
            if point == after:
                evt.set()
            elif point == block and not evt.is_set():
                waiters.append(evt)
    for evt in waiters:  # wait OUTSIDE the lock (the releaser needs it)
        if not evt.wait(30.0):
            raise TimeoutError(
                f"force_ordering: {point!r} waited 30s for its trigger"
            )
    if exc is not None:
        raise exc


@contextmanager
def collect():
    """Install a trace collector; yields the (live) event list."""
    global enabled, _events
    with _lock:
        prev = _events
        _events = events = []
        enabled = True
    try:
        yield events
    finally:
        with _lock:
            _events = prev
            enabled = bool(prev or _orderings or _injections)


@contextmanager
def force_ordering(after: str, block: str):
    """Until a tracepoint `after` has fired, any thread reaching
    tracepoint `block` waits (the ?force_ordering race pin)."""
    global enabled
    evt = threading.Event()
    entry = (after, block, evt)
    with _lock:
        _orderings.append(entry)
        enabled = True
    try:
        yield evt
    finally:
        evt.set()  # release any still-blocked thread
        with _lock:
            _orderings.remove(entry)
            enabled = bool(_events or _orderings or _injections)


@contextmanager
def inject(point: str, exc: BaseException):
    """Raise `exc` from inside the traced code at tracepoint `point`."""
    global enabled
    with _lock:
        _injections[point] = exc
        enabled = True
    try:
        yield
    finally:
        with _lock:
            _injections.pop(point, None)
            enabled = bool(_events or _orderings or _injections)


# ------------------------------------------------------------ asserts


def events_of(trace: List[Dict], point: str) -> List[Dict]:
    return [e for e in trace if e["tp"] == point]


def assert_present(trace: List[Dict], point: str, **match) -> Dict:
    for e in events_of(trace, point):
        if all(e.get(k) == v for k, v in match.items()):
            return e
    raise AssertionError(
        f"no {point!r} event matching {match} in "
        f"{[e['tp'] for e in trace]}"
    )


def assert_absent(trace: List[Dict], point: str, **match) -> None:
    for e in events_of(trace, point):
        if all(e.get(k) == v for k, v in match.items()):
            raise AssertionError(f"unexpected {point!r} event: {e}")


def assert_order(trace: List[Dict], first: str, then: str) -> None:
    """Every `then` event must be preceded by at least one `first`."""
    seen_first = False
    for e in trace:
        if e["tp"] == first:
            seen_first = True
        elif e["tp"] == then and not seen_first:
            raise AssertionError(
                f"{then!r} fired before any {first!r}: "
                f"{[e['tp'] for e in trace]}"
            )
    if not any(e["tp"] == then for e in trace):
        raise AssertionError(f"no {then!r} event in trace")
