"""MQTT topic semantics: split, validate, wildcard match, shared-sub parsing.

Behavioral parity with the reference's ``emqx_topic.erl`` (
EMQX apps/emqx/src/emqx_topic.erl:63-170 for wildcard/match,
:185-266 for validation and $share parsing), re-expressed as plain Python
over tuples of level strings.  These functions are the ground truth the
matching engines (host trie and TPU automaton) are tested against.

Semantics recap (MQTT 3.1.1 / 5.0):
  * Topics split on ``/``; empty levels are legal (``a//b`` has 3 levels,
    ``/a`` has 2).
  * ``+`` matches exactly one level (any content, including empty).
  * ``#`` matches any suffix, *including zero levels* — ``sport/#`` matches
    ``sport`` itself — and must be the last level.
  * Filters whose first level is a wildcard do not match topics whose first
    level starts with ``$`` (emqx_topic.erl:81-84).
  * ``$share/<group>/<real-filter>`` marks a shared subscription; the group
    may not contain ``/``, ``+`` or ``#``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

MAX_TOPIC_LEN = 65535

SHARE_PREFIX = "$share"

PLUS = "+"
HASH = "#"


class SharedFilter(NamedTuple):
    """A parsed ``$share/<group>/<topic>`` subscription filter."""

    group: str
    topic: str


Words = Tuple[str, ...]


def words(topic: str) -> Words:
    """Split a topic into its levels. ``'a//b'`` -> ``('a', '', 'b')``."""
    return tuple(topic.split("/"))


def join(ws: Sequence[str]) -> str:
    return "/".join(ws)


def levels(topic: str) -> int:
    return topic.count("/") + 1


def is_wildcard(topic: str) -> bool:
    """True if the topic filter contains ``+`` or ``#`` at any level."""
    return any(w in (PLUS, HASH) for w in words(topic))


def is_dollar(topic: str) -> bool:
    """True for ``$``-topics (``$SYS/...``, ``$share/...``, ...)."""
    return topic.startswith("$")


def match_words(name: Words, flt: Words) -> bool:
    """Word-level wildcard match; `name` must be a concrete (non-wildcard)
    topic. Mirrors emqx_topic.erl:91-112 including the parent-level ``#``
    rule and the root ``$`` exclusion."""
    if name and name[0].startswith("$") and flt and flt[0] in (PLUS, HASH):
        return False
    i = 0
    n, f = len(name), len(flt)
    while i < f:
        w = flt[i]
        if w == HASH:
            return True  # matches any suffix, incl. empty
        if i >= n:
            return False
        if w != PLUS and w != name[i]:
            return False
        i += 1
    return i == n


def match(name: str, flt: str) -> bool:
    """String-level wildcard match (concrete ``name`` vs filter ``flt``)."""
    return match_words(words(name), words(flt))


def validate_name(topic: str) -> None:
    """Validate a topic *name* (publish topic): nonempty, bounded, no
    wildcards (emqx_topic.erl:185-217)."""
    _validate_common(topic)
    if "+" in topic or "#" in topic:
        raise ValueError(f"wildcard in topic name: {topic!r}")


def validate_filter(topic: str) -> None:
    """Validate a subscription filter, including $share form."""
    _validate_common(topic)
    shared = parse_share(topic)
    real = shared.topic if shared else topic
    if shared is not None:
        _validate_common(real)
    ws = words(real)
    for i, w in enumerate(ws):
        if w == HASH:
            if i != len(ws) - 1:
                raise ValueError(f"'#' not at last level: {topic!r}")
        elif HASH in w or (PLUS in w and w != PLUS):
            raise ValueError(f"wildcard not a whole level: {topic!r}")


def _validate_common(topic: str) -> None:
    if topic == "":
        raise ValueError("empty topic")
    if len(topic.encode("utf-8")) > MAX_TOPIC_LEN:
        raise ValueError("topic too long")
    if "\x00" in topic:
        raise ValueError("NUL in topic")


def parse_share(flt: str) -> Optional[SharedFilter]:
    """Parse ``$share/Group/Topic`` (emqx_topic.erl:222-266). Returns None
    for non-shared filters; raises on malformed shared filters."""
    if not flt.startswith(SHARE_PREFIX + "/"):
        return None
    rest = flt[len(SHARE_PREFIX) + 1 :]
    group, sep, real = rest.partition("/")
    if not sep or group == "" or real == "":
        raise ValueError(f"malformed shared filter: {flt!r}")
    if "+" in group or "#" in group:
        raise ValueError(f"wildcard in share group: {flt!r}")
    if real.startswith(SHARE_PREFIX + "/"):
        raise ValueError(f"nested $share: {flt!r}")
    return SharedFilter(group=group, topic=real)


def real_topic(flt: str) -> str:
    """Strip a ``$share/Group/`` prefix if present."""
    shared = parse_share(flt)
    return shared.topic if shared else flt


def systopic(suffix: str) -> str:
    return "$SYS/brokers/" + suffix
