"""Rule SQL function library.

A copy of the JAX package's ``rules/funcs.py``: a working subset of
EMQX's 1.3 kLoC stdlib (`emqx_rule_funcs`, apps/emqx_rule_engine/src/
emqx_rule_funcs.erl), grouped the same way: math, string, map/array,
type conversion, time, hashing, compression-free encoding.  All
functions are total over ``None`` where EMQX is (undefined propagates
as failure -> the rule's WHERE treats it as false).

``schema_decode``, ``schema_encode`` and ``schema_check`` resolve names
in the node's `schema_registry.global_registry()`.  Unlike the JAX
package's, ``schema_decode`` and ``schema_check`` read the env's
``payload`` as the message's bytes, not as its UTF-8 text, so a binary
payload (Avro, protobuf) decodes.
"""

from __future__ import annotations

import base64
import fnmatch
import hashlib
import json
import math
import time
import uuid
from typing import Any, Callable, Dict


def _num(x: Any) -> float:
    if isinstance(x, bool) or not isinstance(x, (int, float)):
        raise TypeError(f"not a number: {x!r}")
    return x


def _like(s: Any, pattern: Any) -> bool:
    """SQL LIKE: % = any run, _ = one char."""
    if not isinstance(s, str) or not isinstance(pattern, str):
        return False
    out = []
    for ch in pattern:
        if ch == "%":
            out.append("*")
        elif ch == "_":
            out.append("?")
        elif ch in "*?[":  # neutralize fnmatch metacharacters
            out.append("[" + ch + "]")
        else:
            out.append(ch)
    return fnmatch.fnmatchcase(s, "".join(out))


FUNCS: Dict[str, Callable[..., Any]] = {}


def _register(name: str):
    def deco(fn):
        FUNCS[name] = fn
        return fn

    return deco


# ------------------------------------------------------------------ math

for _name, _fn in {
    "abs": abs,
    "ceil": math.ceil,
    "floor": math.floor,
    "sqrt": math.sqrt,
    "exp": math.exp,
    "log": math.log,
    "log10": math.log10,
    "log2": math.log2,
    "sin": math.sin,
    "cos": math.cos,
    "tan": math.tan,
}.items():
    FUNCS[_name] = (lambda f: lambda x: f(_num(x)))(_fn)

FUNCS["round"] = lambda x, n=0: round(_num(x), int(n)) if n else round(_num(x))
FUNCS["power"] = lambda x, y: math.pow(_num(x), _num(y))
FUNCS["pow"] = FUNCS["power"]
FUNCS["fmod"] = lambda x, y: math.fmod(_num(x), _num(y))
FUNCS["random"] = lambda: __import__("random").random()
FUNCS["max"] = lambda *a: max(a)
FUNCS["min"] = lambda *a: min(a)


# ---------------------------------------------------------------- strings


@_register("lower")
def _lower(s):
    return str(s).lower()


@_register("upper")
def _upper(s):
    return str(s).upper()


@_register("trim")
def _trim(s):
    return str(s).strip()


@_register("ltrim")
def _ltrim(s):
    return str(s).lstrip()


@_register("rtrim")
def _rtrim(s):
    return str(s).rstrip()


@_register("reverse")
def _reverse(s):
    return str(s)[::-1]


@_register("strlen")
def _strlen(s):
    return len(str(s))


@_register("substr")
def _substr(s, start, length=None):
    s = str(s)
    start = int(start)
    return s[start:] if length is None else s[start : start + int(length)]


@_register("concat")
def _concat(*parts):
    return "".join(str(p) for p in parts)


@_register("split")
def _split(s, sep=" "):
    return str(s).split(str(sep))


@_register("tokens")
def _tokens(s, sep=" "):
    return [t for t in str(s).split(str(sep)) if t]


@_register("replace")
def _replace(s, old, new):
    return str(s).replace(str(old), str(new))


@_register("regex_match")
def _regex_match(s, pattern):
    import re

    return re.search(str(pattern), str(s)) is not None


@_register("regex_replace")
def _regex_replace(s, pattern, repl):
    import re

    return re.sub(str(pattern), str(repl), str(s))


@_register("ascii")
def _ascii(ch):
    return ord(str(ch)[0])


@_register("find")
def _find(s, sub):
    s = str(s)
    i = s.find(str(sub))
    return s[i:] if i >= 0 else ""


@_register("pad")
def _pad(s, n, side="trailing", char=" "):
    s, n, char = str(s), int(n), str(char)
    if side == "leading":
        return s.rjust(n, char)
    if side == "both":
        total = max(n - len(s), 0)
        left = total // 2
        return char * left + s + char * (total - left)
    return s.ljust(n, char)


@_register("sprintf")
def _sprintf(fmt, *args):
    return str(fmt).replace("~p", "%s").replace("~s", "%s") % args


FUNCS["like"] = _like


# ---------------------------------------------------------- maps / arrays


@_register("map_get")
def _map_get(key, m, default=None):
    if isinstance(m, dict):
        return m.get(str(key), default)
    return default


@_register("map_put")
def _map_put(key, val, m):
    out = dict(m) if isinstance(m, dict) else {}
    out[str(key)] = val
    return out


@_register("mget")
def _mget(key, m, default=None):
    return _map_get(key, m, default)


@_register("contains")
def _contains(item, arr):
    return isinstance(arr, (list, tuple)) and item in arr


@_register("nth")
def _nth(n, arr):
    n = int(n)
    if isinstance(arr, (list, tuple)) and 1 <= n <= len(arr):
        return arr[n - 1]
    return None


@_register("length")
def _length(x):
    return len(x)


@_register("sublist")
def _sublist(*args):
    if len(args) == 2:
        n, arr = args
        return list(arr[: int(n)])
    start, n, arr = args
    return list(arr[int(start) - 1 : int(start) - 1 + int(n)])


@_register("first")
def _first(arr):
    return arr[0] if arr else None


@_register("last")
def _last(arr):
    return arr[-1] if arr else None


# -------------------------------------------------------- type conversion


@_register("str")
def _str(x):
    if isinstance(x, bytes):
        return x.decode("utf-8", "replace")
    if isinstance(x, bool):
        return "true" if x else "false"
    if isinstance(x, float) and x.is_integer():
        return str(int(x))
    if isinstance(x, (dict, list)):
        return json.dumps(x)
    return str(x)


@_register("int")
def _int(x):
    if isinstance(x, str):
        return int(float(x)) if "." in x else int(x)
    return int(x)


@_register("float")
def _float(x):
    return float(x)


@_register("bool")
def _bool(x):
    if isinstance(x, bool):
        return x
    if x in ("true", 1):
        return True
    if x in ("false", 0):
        return False
    raise TypeError(f"not a bool: {x!r}")


@_register("is_null")
def _is_null(x):
    return x is None


@_register("is_not_null")
def _is_not_null(x):
    return x is not None


@_register("is_num")
def _is_num(x):
    return isinstance(x, (int, float)) and not isinstance(x, bool)


@_register("is_int")
def _is_int(x):
    return isinstance(x, int) and not isinstance(x, bool)


@_register("is_float")
def _is_float(x):
    return isinstance(x, float)


@_register("is_str")
def _is_str(x):
    return isinstance(x, str)


@_register("is_bool")
def _is_bool(x):
    return isinstance(x, bool)


@_register("is_map")
def _is_map(x):
    return isinstance(x, dict)


@_register("is_array")
def _is_array(x):
    return isinstance(x, (list, tuple))


# -------------------------------------------------------- json / encoding


def _payload_bytes(payload):
    """A payload argument as bytes: the message's own bytes when it is
    the env's ``payload`` (whose text is the UTF-8 decode with
    replacement, which loses binary schema payloads), else the text's
    UTF-8 encoding."""
    raw = getattr(payload, "_raw", None)
    if raw is not None:
        return raw
    return payload.encode() if isinstance(payload, str) else payload


@_register("schema_decode")
def _schema_decode(name, payload, message_type=None):
    """Decode a payload against a registered schema
    (emqx_rule_funcs:schema_decode — avro/protobuf/json by name)."""
    from ..schema_registry import global_registry

    return global_registry().decode(name, _payload_bytes(payload),
                                    message_type)


@_register("schema_encode")
def _schema_encode(name, value, message_type=None):
    from ..schema_registry import global_registry

    return global_registry().encode(name, value, message_type)


@_register("schema_check")
def _schema_check(name, payload):
    from ..schema_registry import global_registry

    return global_registry().check(name, _payload_bytes(payload))


@_register("json_decode")
def _json_decode(s):
    if isinstance(s, bytes):
        s = s.decode("utf-8")
    return json.loads(s)


@_register("json_encode")
def _json_encode(x):
    return json.dumps(x)


@_register("base64_encode")
def _b64e(x):
    if isinstance(x, str):
        x = x.encode("utf-8")
    return base64.b64encode(x).decode("ascii")


@_register("base64_decode")
def _b64d(s):
    return base64.b64decode(s)


@_register("bin2hexstr")
def _bin2hex(b):
    if isinstance(b, str):
        b = b.encode("utf-8")
    return b.hex()


@_register("hexstr2bin")
def _hex2bin(s):
    return bytes.fromhex(str(s))


# --------------------------------------------------------------- hashing


@_register("md5")
def _md5(x):
    return hashlib.md5(_as_bytes(x)).hexdigest()


@_register("sha")
def _sha(x):
    return hashlib.sha1(_as_bytes(x)).hexdigest()


@_register("sha256")
def _sha256(x):
    return hashlib.sha256(_as_bytes(x)).hexdigest()


def _as_bytes(x) -> bytes:
    return x if isinstance(x, bytes) else str(x).encode("utf-8")


# ------------------------------------------------------------------ time


@_register("now_timestamp")
def _now_timestamp(unit="second"):
    t = time.time()
    return int(t * {"second": 1, "millisecond": 1e3, "microsecond": 1e6}[unit])


@_register("timezone_to_second")
def _tz_to_s(tz):
    if tz in ("Z", "z"):
        return 0
    sign = -1 if tz.startswith("-") else 1
    hh, mm = tz.lstrip("+-").split(":")
    return sign * (int(hh) * 3600 + int(mm) * 60)


FUNCS["uuid_v4"] = lambda: str(uuid.uuid4())


# ------------------------------------------------------------ mqtt-domain


@_register("topic")
def _topic_join(*levels):
    return "/".join(str(x) for x in levels)
