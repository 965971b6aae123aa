"""Window column extraction for the stacked rule-matrix program.

A port of the JAX package's ``rules/columns.py``.  `WindowColumns`
decodes each window message ONCE into parallel numpy
planes over the union of var paths the registry's lowerable rules
reference (predicate.StackedRules.paths): a float64 numeric lane, a
per-window RANK-interned string lane, a lookup-error lane and a
presence lane per path.  `ops.match_kernel.rules_eval_batch` then
evaluates the whole registry against these planes as one rules x
window boolean matrix (`state.columns_from_reference` puts the planes
on the device).

String interning rides one per-window dictionary (the string-dict
idiom `PredicateProgram.extract_columns` introduced), but assigns
SORTED ranks instead of first-seen ids: rank order == lexicographic
order, so the kernel's ordering comparisons cover interpreter string
ordering (`topic > clientid`) as well as equality.  The dictionary is
seeded with the registry's string-literal table, so literal operands
resolve to per-window ranks in one vectorized lookup
(``lit_ranks``).  Booleans take reserved ids OUTSIDE the orderable
rank space (-2 true / -3 false): equality-comparable, never
string-ordered — exactly the interpreter's Erlang-term semantics.

Non-scalar JSON values (dicts/lists) intern by a canonical encoding
under a NUL-prefixed namespace (NUL cannot occur in MQTT UTF-8
strings), so ``payload.a = payload.b`` over equal objects matches the
interpreter's term equality.

The per-message env dicts are `runtime.LazyEnv`: the extractor, any
per-RULE interpreter fallbacks, and the SELECT evaluation of passing
rules all share one env per message — and its `_PayloadStr` caches
the JSON decode, which is what makes "decode once per window" hold
across all three consumers.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..message import Message
from .runtime import LazyEnv, _PayloadStr, lookup_var

# reserved string-lane ids: bools are equality-comparable but must
# never participate in rank (string) ordering
SID_NONE = -1
SID_TRUE = -2
SID_FALSE = -3
# non-scalar terms encode as -4 - rank: equality-comparable through
# the shared dictionary, excluded (negative) from rank ordering
SID_TERM_BASE = -4


def _canon(v: Any) -> str:
    """Canonical encoding for non-scalar JSON values such that
    encodings are equal iff Python ``==`` holds (numbers normalize
    through float, like Python's cross-type numeric equality —
    including bools, since the interpreter's container equality is
    plain ``==`` where ``True == 1``)."""
    if isinstance(v, (int, float)):  # bool is an int: True == 1
        return "n" + repr(float(v))
    if isinstance(v, str):
        return "s" + v
    if v is None:
        return "z"
    if isinstance(v, list):
        return "[" + ",".join(_canon(x) for x in v) + "]"
    if isinstance(v, dict):
        return (
            "{"
            + ",".join(f"{k}:{_canon(v[k])}" for k in sorted(v))
            + "}"
        )
    return "?" + repr(v)


class WindowColumns:
    """One window's shared column planes: ``num``/``sid``/``err``/
    ``prs`` are ``[P, W]`` over the registry's path union."""

    __slots__ = (
        "n", "paths", "num", "sid", "err", "prs", "lit_ranks",
        "envs", "n_strings", "has_nan_value", "vals",
    )

    def __init__(
        self,
        msgs: Sequence[Message],
        paths: Sequence[Tuple[str, ...]],
        lit_strings: Sequence[str],
        envs: Optional[List[Optional[LazyEnv]]] = None,
        keep_values: bool = False,
    ) -> None:
        n = len(msgs)
        n_paths = len(paths)
        self.n = n
        self.paths = tuple(paths)
        self.num = np.full((n_paths, n), np.nan, np.float64)
        self.sid = np.full((n_paths, n), SID_NONE, np.int32)
        self.err = np.zeros((n_paths, n), bool)
        self.prs = np.zeros((n_paths, n), bool)
        # ``keep_values``: also keep each cell's RAW extracted value
        # (the batched SELECT transform's input — int-ness and nested
        # objects survive, which the f64/rank planes erase).  None
        # covers both "missing" and "error" cells; the err lane
        # disambiguates where it matters (expression operands).
        self.vals: Optional[List[List[Any]]] = (
            [[None] * n for _ in range(n_paths)] if keep_values
            else None
        )
        if envs is None:
            envs = [None] * n
        self.envs = envs
        self.has_nan_value = False
        num, sid, err, prs = self.num, self.sid, self.err, self.prs
        vals = self.vals
        # (plane, msg, string, is_term) cells holding a string-interned
        # value, resolved after the scan once the window's full
        # dictionary is known
        pending: List[Tuple[int, int, str, bool]] = []
        # nested payload paths walk the decoded JSON directly (ONE
        # decode per message, shared with the lazy envs); everything
        # else goes through the generic env lookup
        pay_paths = [
            (p, paths[p][1:]) for p in range(n_paths)
            if paths[p][0] == "payload" and len(paths[p]) > 1
        ]
        gen_paths = [
            p for p in range(n_paths)
            if not (paths[p][0] == "payload" and len(paths[p]) > 1)
        ]
        _ERR = object()

        def classify(p: int, i: int, v: Any) -> None:
            if vals is not None and v is not None:
                # raw-value plane: _PayloadStr flattens to plain str
                # here, exactly eval_select's output conversion
                vals[p][i] = str(v) if type(v) is _PayloadStr else v
            if isinstance(v, bool):
                sid[p, i] = SID_TRUE if v else SID_FALSE
                prs[p, i] = True
            elif isinstance(v, (int, float)):
                if v != v:
                    # a LITERAL NaN payload value (json.loads accepts
                    # NaN) would alias the not-a-number sentinel; the
                    # caller degrades this window to the interpreter
                    self.has_nan_value = True
                num[p, i] = v
                prs[p, i] = True
            elif isinstance(v, str):
                pending.append((p, i, str(v), False))
                prs[p, i] = True
            elif v is not None:
                # non-scalar term: canonical id, equality-only
                pending.append((p, i, "\x00j" + _canon(v), True))
                prs[p, i] = True

        for i in range(n):
            env = envs[i]
            if env is None:
                env = envs[i] = LazyEnv(msgs[i])
            if pay_paths:
                try:
                    data = env["payload"].decoded()
                except Exception:
                    data = _ERR
                for p, rest in pay_paths:
                    if data is _ERR:
                        err[p, i] = True
                        continue
                    cur: Any = data
                    for part in rest:
                        if isinstance(cur, dict):
                            if part not in cur:
                                cur = None
                                break
                            cur = cur[part]
                        else:
                            err[p, i] = True
                            cur = _ERR
                            break
                    if cur is not _ERR:
                        classify(p, i, cur)
            for p in gen_paths:
                try:
                    v = lookup_var(env, paths[p])
                except Exception:
                    err[p, i] = True
                    continue
                classify(p, i, v)
        # rank interning: literals seed the dictionary so every
        # literal operand resolves even when absent from the window
        strings = set(lit_strings)
        for _, _, s, _t in pending:
            strings.add(s)
        rank = {s: r for r, s in enumerate(sorted(strings))}
        self.n_strings = len(rank)
        for p, i, s, term in pending:
            sid[p, i] = SID_TERM_BASE - rank[s] if term else rank[s]
        self.lit_ranks = np.fromiter(
            (rank[s] for s in lit_strings), np.int32, len(lit_strings)
        )

    def env(self, i: int) -> LazyEnv:
        """The shared lazy env for message ``i`` (fallback predicates
        and SELECT evaluation ride the same decode cache)."""
        return self.envs[i]
