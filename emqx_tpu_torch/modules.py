"""Broker modules: delayed publish, topic rewrite, topic metrics,
exclusive subs.

The `emqx_modules` slice of EMQX (emqx_delayed.erl, emqx_rewrite.erl,
emqx_topic_metrics.erl) plus `emqx_exclusive_subscription.erl`, as the
JAX package has them: small protocol features hooked into the
publish/subscribe paths.  Delayed publish, rewrite and topic metrics
ride the broker's ``message.publish`` fold at priorities 100, 90 and 5:
a ``$delayed/`` publish is swallowed before the rewrite sees it, and
topic metrics count last, on the rewritten topic.
"""

from __future__ import annotations

import heapq
import re
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from . import topic as T
from .hooks import STOP_WITH
from .message import Message


class DelayedPublish:
    """`$delayed/<seconds>/real/topic` publishes fire after the delay
    (emqx_delayed.erl): the original publish is swallowed and a copy
    with the real topic is scheduled; `tick` releases due messages."""

    PREFIX = "$delayed/"
    MAX_DELAY = 42949670  # emqx_delayed's cap (~497 days)

    def __init__(self, broker) -> None:
        self.broker = broker
        self._heap: List[Tuple[float, int, Message]] = []
        self._seq = 0
        broker.hooks.add("message.publish", self._on_publish, priority=100)

    def _on_publish(self, msg: Message):
        if not msg.topic.startswith(self.PREFIX):
            return None  # not ours: leave the accumulator alone
        rest = msg.topic[len(self.PREFIX):]
        secs_str, sep, real = rest.partition("/")
        try:
            secs = min(int(secs_str), self.MAX_DELAY)
        except ValueError:
            secs = -1
        if not sep or not real or secs < 0:
            self.broker.metrics.inc("messages.dropped")
            return STOP_WITH(None)  # malformed: drop
        delayed = Message(
            topic=real,
            payload=msg.payload,
            qos=msg.qos,
            retain=msg.retain,
            from_client=msg.from_client,
            from_username=msg.from_username,
            mid=msg.mid,
            timestamp=msg.timestamp,
            properties=dict(msg.properties),
        )
        self._seq += 1
        heapq.heappush(
            self._heap, (time.time() + secs, self._seq, delayed)
        )
        self.broker.metrics.inc("messages.delayed")
        return STOP_WITH(None)  # swallowed; fires later

    def __len__(self) -> int:
        return len(self._heap)

    def tick(self, now: Optional[float] = None) -> int:
        now = now if now is not None else time.time()
        due = []
        while self._heap and self._heap[0][0] <= now:
            due.append(heapq.heappop(self._heap)[2])
        if due:
            self.broker.publish_many(due)
        return len(due)


@dataclass
class RewriteRule:
    """One rewrite (emqx_rewrite.erl): applies to pub and/or sub topics
    matching `source` (MQTT filter) AND `pattern` (regex); `dest` may
    use \\1..\\N backrefs from the pattern."""

    action: str  # "publish" | "subscribe" | "all"
    source: str
    pattern: str
    dest: str

    def __post_init__(self) -> None:
        self._re = re.compile(self.pattern)
        self._src_words = T.words(self.source)


class TopicRewrite:
    def __init__(self, broker, rules: Optional[List[RewriteRule]] = None):
        self.broker = broker
        self.rules = list(rules or ())
        broker.hooks.add("message.publish", self._on_publish, priority=90)

    def add_rule(self, rule: RewriteRule) -> None:
        self.rules.append(rule)

    def _apply(self, topic: str, action: str) -> str:
        # LAST matching rule wins, as in emqx_rewrite
        out = topic
        for rule in self.rules:
            if rule.action not in (action, "all"):
                continue
            if not T.match_words(T.words(out), rule._src_words):
                continue
            m = rule._re.match(out)
            if m is not None:
                out = m.expand(rule.dest)
        return out

    def _on_publish(self, msg: Message):
        if msg.topic.startswith("$"):  # never rewrite $-topics
            return None
        new = self._apply(msg.topic, "publish")
        if new == msg.topic:
            return None
        msg.topic = new
        return msg

    def rewrite_sub(self, flt: str) -> str:
        """Called by the channel on SUBSCRIBE/UNSUBSCRIBE filters."""
        if flt.startswith("$"):
            return flt
        return self._apply(flt, "subscribe")


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


class TopicMetrics:
    """Per-topic counters (the emqx_modules topic-metrics feature):
    an operator registers a FILTER (wildcards allowed, up to ``cap``)
    and every matching publish/delivery increments its counters, with
    a rolling messages-in rate.  Registration rides the broker's
    message.publish hook; delivery counts come from the dispatch path
    calling `on_delivered`."""

    CAP = 512

    def __init__(self, broker) -> None:
        self._T = T
        self.broker = broker
        self._metrics: Dict[str, Dict[str, float]] = {}
        broker.hooks.add("message.publish", self._on_publish,
                         priority=5)
        # delivered tap registered lazily with the first topic filter
        # (dropped with the last): an unused TopicMetrics must leave
        # the hookpoint empty — the dispatch window's early return
        self._delivered_cb = None

    def register(self, flt: str) -> bool:
        self._T.validate_filter(flt)
        if flt in self._metrics:
            return False
        if len(self._metrics) >= self.CAP:
            raise ValueError(f"topic-metrics cap {self.CAP} reached")
        self._metrics[flt] = {
            "messages.in": 0, "messages.out": 0, "messages.qos0.in": 0,
            "messages.qos1.in": 0, "messages.qos2.in": 0,
            "messages.dropped": 0, "created_at": time.time(),
            "_rate_last_n": 0.0, "_rate_last_t": time.time(),
            "rate.in": 0.0,
        }
        if self._delivered_cb is None:
            self._delivered_cb = self.broker.hooks.add(
                "message.delivered", self._on_delivered, priority=5
            )
        return True

    def unregister(self, flt: str) -> bool:
        ok = self._metrics.pop(flt, None) is not None
        if ok and not self._metrics and self._delivered_cb is not None:
            self.broker.hooks.delete(
                "message.delivered", self._delivered_cb
            )
            self._delivered_cb = None
        return ok

    def _matching(self, topic: str):
        tw = self._T.words(topic)
        for flt, m in self._metrics.items():
            if self._T.match_words(tw, self._T.words(flt)):
                yield m

    def _on_publish(self, msg: Message):
        if not self._metrics or msg.sys:
            return None
        for m in self._matching(msg.topic):
            m["messages.in"] += 1
            m[f"messages.qos{msg.qos}.in"] += 1
        return None

    def _on_delivered(self, clientid, deliveries):
        if not self._metrics:
            return None
        for entry in deliveries:
            msg = entry[0] if isinstance(entry, tuple) else entry
            topic = getattr(msg, "topic", None)
            if topic is None:
                continue
            for m in self._matching(topic):
                m["messages.out"] += 1
        return None

    def tick(self, now: Optional[float] = None) -> None:
        """Refresh the rolling messages-in rates (1 Hz housekeeping)."""
        now = time.time() if now is None else now
        for m in self._metrics.values():
            dt = now - m["_rate_last_t"]
            if dt > 0:
                m["rate.in"] = (
                    (m["messages.in"] - m["_rate_last_n"]) / dt
                )
                m["_rate_last_n"] = m["messages.in"]
                m["_rate_last_t"] = now

    def info(self) -> List[Dict]:
        return [
            {"topic": flt,
             **{k: v for k, v in m.items()
                if not k.startswith("_")}}
            for flt, m in self._metrics.items()
        ]
