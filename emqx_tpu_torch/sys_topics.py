"""$SYS broker self-topics: periodic heartbeat publishes.

The `emqx_sys` role (EMQX apps/emqx/src/emqx_sys.erl), as in the JAX
package: version/uptime/datetime heartbeats plus live stats and
metrics snapshots under ``$SYS/brokers/<node>/...``, so any MQTT client
monitoring ``$SYS/#`` observes the broker.  Messages carry ``sys=True`` so they
bypass retained storage and topic metrics.
"""

from __future__ import annotations

import json
import time
from typing import List

from .message import Message

VERSION = "emqx_tpu_torch 0.1.0"


class SysTopics:
    def __init__(self, broker, node_name: str | None = None) -> None:
        self.broker = broker
        self.node = node_name or broker.config.node_name
        self.started_at = time.time()
        self._last = 0.0

    def _msg(self, suffix: str, value) -> Message:
        payload = (
            value
            if isinstance(value, bytes)
            else json.dumps(value).encode()
            if not isinstance(value, str)
            else value.encode()
        )
        return Message(
            topic=f"$SYS/brokers/{self.node}/{suffix}",
            payload=payload,
            qos=0,
            sys=True,
        )

    def heartbeat_messages(self) -> List[Message]:
        b = self.broker
        uptime = int(time.time() - self.started_at)
        stats = b.stats.all()
        stats["connections.count"] = len(b.cm)
        stats["topics.count"] = len(b.router.topics())
        stats["retained.count"] = len(b.retainer)
        out = [
            self._msg("version", VERSION),
            self._msg("uptime", str(uptime)),
            self._msg("datetime", time.strftime("%Y-%m-%dT%H:%M:%S%z")),
            self._msg("sysdescr", "MQTT broker on PyTorch and CUDA"),
            self._msg("stats", stats),
            self._msg("metrics", b.metrics.all()),
            self._msg("clients/count", str(len(b.cm))),
            self._msg(
                "subscriptions/count", str(b.router.subscription_count())
            ),
        ]
        prof = getattr(b, "profiler", None)
        if prof is not None and prof.enabled:
            # periodic window-pipeline summary: per-stage p50/p99 and
            # the engine's counters, so a plain MQTT monitor on $SYS/#
            # sees where window time goes
            out.append(self._msg("profiler", {
                "stages_us": {
                    name: {
                        "count": d["count"],
                        "p50": d["p50"],
                        "p99": d["p99"],
                    }
                    for name, d in prof.summary().items()
                    if d["count"]
                },
                "engine": b.router.engine.stats(),
            }))
        return out

    def tick(self, now: float | None = None) -> int:
        """Publish the heartbeat when the configured interval elapsed;
        returns the number of $SYS messages published."""
        cfg = self.broker.config.sys
        if not cfg.enable:
            return 0
        now = now if now is not None else time.time()
        if now - self._last < cfg.interval:
            return 0
        self._last = now
        msgs = self.heartbeat_messages()
        self.broker.publish_many(msgs)
        return len(msgs)
