"""Rule evaluation: message -> env -> WHERE -> SELECT.

A copy of the JAX package's ``rules/runtime.py``.  The interpreter half
of the rule engine, mirroring `emqx_rule_runtime:apply_rule` (EMQX
apps/emqx_rule_engine/src/emqx_rule_runtime.erl:60-100): build the
event env from the message (`emqx_rule_events:eventmsg_publish`),
evaluate WHERE (any evaluation error => no match), then evaluate the
SELECT list into the action payload.  Also the correctness oracle for the batched predicate
compiler (`predicate.py`) and the rules x window kernel.

The node name in the env stays the JAX package's ``"emqx_tpu@local"``,
so rules that read ``node`` see the same value on both.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

from ..message import Message
from .funcs import FUNCS
from .sql import ParsedSql


NODE = "emqx_tpu@local"


class EvalError(Exception):
    pass


def build_env(msg: Message, node: str = NODE) -> Dict[str, Any]:
    """The '$events/message_publish' env (emqx_rule_events.erl
    eventmsg_publish): flat columns + lazily-decoded payload.  Built
    field-by-field from `_env_field` — the same single source of
    truth `LazyEnv` materializes from on demand."""
    return {k: _env_field(msg, k, node) for k in _ENV_KEYS}


class _PayloadStr(str):
    """Payload behaves as its UTF-8 string; nested access JSON-decodes
    once and caches (the reference decodes on first payload.x use)."""

    def __new__(cls, raw: bytes):
        s = super().__new__(cls, raw.decode("utf-8", "replace"))
        s._raw = raw  # type: ignore[attr-defined]
        s._decoded: Optional[Any] = None  # type: ignore[attr-defined]
        return s

    def decoded(self) -> Any:
        if self._decoded is None:  # type: ignore[attr-defined]
            self._decoded = json.loads(str(self))  # type: ignore[attr-defined]
        return self._decoded  # type: ignore[attr-defined]


def _env_field(msg: Message, key: str, node: str) -> Any:
    """One `build_env` field, computed on demand (LazyEnv)."""
    if key == "event":
        return "message.publish"
    if key == "id":
        return msg.mid.hex()
    if key == "clientid":
        return msg.from_client
    if key == "username":
        return msg.from_username
    if key == "topic":
        return msg.topic
    if key == "qos":
        return msg.qos
    if key == "payload":
        return _PayloadStr(msg.payload)
    if key == "flags":
        return {"retain": msg.retain, "dup": msg.dup, "sys": msg.sys}
    if key == "retain":
        return msg.retain
    if key == "pub_props":
        return dict(msg.properties)
    if key in ("timestamp", "publish_received_at"):
        return int(msg.timestamp * 1000)
    if key == "node":
        return node
    raise KeyError(key)


_ENV_KEYS = (
    "event", "id", "clientid", "username", "topic", "qos", "payload",
    "flags", "retain", "pub_props", "timestamp",
    "publish_received_at", "node",
)
_ENV_FIELDS = frozenset(_ENV_KEYS)


class LazyEnv(dict):
    """`build_env` that materializes only the fields a predicate or
    SELECT actually touches.  A fallback rule reading one payload
    field over a wide message costs one payload decode and ONE dict
    entry, not the full 13-field env — and the decoded-JSON cache on
    the shared `payload` entry means the window's column extractor,
    fallback predicates, and SELECTs all decode each message at most
    once (`len(env)` counts materialized fields; the regression suite
    pins it)."""

    __slots__ = ("_msg", "_node")

    def __init__(self, msg: Message, node: str = NODE):
        super().__init__()
        self._msg = msg
        self._node = node

    def __missing__(self, key: str) -> Any:
        v = _env_field(self._msg, key, self._node)  # KeyError: unknown
        self[key] = v
        return v

    def __contains__(self, key: object) -> bool:
        return dict.__contains__(self, key) or key in _ENV_FIELDS

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default


def lookup_var(env: Dict[str, Any], path: Tuple[str, ...]) -> Any:
    cur: Any = env
    for i, part in enumerate(path):
        if isinstance(cur, _PayloadStr) and i > 0:
            cur = cur.decoded()
        if isinstance(cur, dict):
            if part not in cur:
                return None
            cur = cur[part]
        else:
            raise EvalError(f"cannot descend into {part!r}")
    return cur


def eval_expr(expr: tuple, env: Dict[str, Any]) -> Any:
    kind = expr[0]
    if kind == "lit":
        return expr[1]
    if kind == "var":
        return lookup_var(env, expr[1])
    if kind == "neg":
        v = eval_expr(expr[1], env)
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            raise EvalError(f"negating non-number {v!r}")
        return -v
    if kind == "not":
        return not _truthy(eval_expr(expr[1], env))
    if kind == "op":
        return _eval_op(expr[1], expr[2], expr[3], env)
    if kind == "in":
        v = eval_expr(expr[1], env)
        return any(_sql_eq(v, eval_expr(e, env)) for e in expr[2])
    if kind == "call":
        fn = FUNCS.get(expr[1])
        if fn is None:
            raise EvalError(f"unknown function {expr[1]!r}")
        args = [eval_expr(a, env) for a in expr[2]]
        try:
            return fn(*args)
        except EvalError:
            raise
        except Exception as exc:
            raise EvalError(f"{expr[1]}: {exc}") from exc
    if kind == "case":
        for cond, then in expr[1]:
            if _truthy(eval_expr(cond, env)):
                return eval_expr(then, env)
        return eval_expr(expr[2], env) if expr[2] is not None else None
    raise EvalError(f"bad expression node {kind!r}")


def _truthy(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if v is None:
        return False
    raise EvalError(f"non-boolean in boolean context: {v!r}")


def _sql_eq(a: Any, b: Any) -> bool:
    # numeric cross-type equality, but not bool==1
    if isinstance(a, bool) or isinstance(b, bool):
        return a is b
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return a == b
    if isinstance(a, _PayloadStr):
        a = str(a)
    if isinstance(b, _PayloadStr):
        b = str(b)
    return type(a) == type(b) and a == b


def _eval_op(sym: str, le: tuple, re_: tuple, env: Dict[str, Any]) -> Any:
    if sym == "and":
        return _truthy(eval_expr(le, env)) and _truthy(eval_expr(re_, env))
    if sym == "or":
        return _truthy(eval_expr(le, env)) or _truthy(eval_expr(re_, env))
    a = eval_expr(le, env)
    b = eval_expr(re_, env)
    if sym == "=":
        return _sql_eq(a, b)
    if sym == "!=":
        return not _sql_eq(a, b)
    if sym in (">", "<", ">=", "<="):
        if isinstance(a, str) and isinstance(b, str):
            pass  # string ordering allowed
        elif not (
            isinstance(a, (int, float))
            and isinstance(b, (int, float))
            and not isinstance(a, bool)
            and not isinstance(b, bool)
        ):
            raise EvalError(f"cannot compare {a!r} {sym} {b!r}")
        return {
            ">": a > b, "<": a < b, ">=": a >= b, "<=": a <= b
        }[sym]
    return arith_op(sym, a, b)


def arith_op(sym: str, a: Any, b: Any) -> Any:
    """One arithmetic step over already-evaluated operands — shared by
    the interpreter (`_eval_op`) and the batched SELECT transform's
    compiled expression closures (`select.py`), so the two lanes are
    bit-identical by construction (int-ness preservation, string
    concat '+', truncating div/mod, div-by-zero -> EvalError)."""
    if sym == "+" and isinstance(a, str) and isinstance(b, str):
        return a + b  # string concat like the reference's '+'
    if not (
        isinstance(a, (int, float))
        and isinstance(b, (int, float))
        and not isinstance(a, bool)
        and not isinstance(b, bool)
    ):
        raise EvalError(f"arithmetic on non-numbers: {a!r} {sym} {b!r}")
    if sym == "+":
        return a + b
    if sym == "-":
        return a - b
    if sym == "*":
        return a * b
    if sym == "/":
        if b == 0:
            raise EvalError("division by zero")
        return a / b
    if sym == "div":
        if b == 0:
            raise EvalError("division by zero")
        return int(a) // int(b)
    if sym == "mod":
        if b == 0:
            raise EvalError("division by zero")
        return int(a) % int(b)
    raise EvalError(f"bad operator {sym!r}")


def eval_where(where: Optional[tuple], env: Dict[str, Any]) -> bool:
    """WHERE evaluation; any error counts as no-match (the reference
    logs and skips, emqx_rule_runtime.erl apply_rule catch)."""
    if where is None:
        return True
    try:
        return _truthy(eval_expr(where, env))
    except (EvalError, TypeError, ValueError):
        return False


_STAR_FIELDS = (
    "clientid", "username", "topic", "qos", "payload", "retain",
    "timestamp", "event",
)


def eval_select(sql: ParsedSql, env: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for f in sql.fields:
        if f.star:
            for k in _STAR_FIELDS:
                v = env.get(k)
                out[k] = str(v) if isinstance(v, _PayloadStr) else v
            continue
        try:
            val = eval_expr(f.expr, env)
        except (EvalError, TypeError, ValueError):
            val = None
        name = f.alias or _default_name(f.expr)
        if isinstance(val, _PayloadStr):
            val = str(val)
        out[name] = val
    return out


def _default_name(expr: tuple) -> str:
    if expr[0] == "var":
        return expr[1][-1]
    if expr[0] == "call":
        return expr[1]
    return "expr"
