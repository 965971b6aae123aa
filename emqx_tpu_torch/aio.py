"""Small asyncio helpers shared across the broker's lifecycles (a copy
of the JAX package's ``aio.py``)."""

from __future__ import annotations

import asyncio


async def cancel_and_wait(task: asyncio.Task, poll: float = 0.5) -> None:
    """Cancel `task` and wait until it actually ends, RE-cancelling as
    needed: a cancel that lands exactly as an inner ``wait_for``'s
    future resolves is swallowed (bpo-37658 — wait_for returns the
    result instead of raising), the task loops on, and a single
    ``cancel(); await task`` would hang the caller's shutdown forever.
    The task's terminal exception (CancelledError or its own crash) is
    absorbed — this is a shutdown path."""
    while not task.done():
        task.cancel()
        await asyncio.wait([task], timeout=poll)
    try:
        await task
    except BaseException:
        pass
