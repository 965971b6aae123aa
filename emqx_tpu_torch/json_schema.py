"""A JSON Schema (Draft 2020-12) validator from the standard library.

`Validator(schema).validate(instance)` raises `ValidationError` where
``jsonschema.Draft202012Validator(schema).validate(instance)`` raises,
and returns where it returns, for the keywords implemented here:

  * ``type`` (an integer-valued float is an integer), ``enum``,
    ``const`` (``true`` is not ``1``, ``1`` is ``1.0``);
  * numbers: ``minimum``, ``maximum``, ``exclusiveMinimum``,
    ``exclusiveMaximum``, ``multipleOf``;
  * strings: ``minLength``, ``maxLength`` (code points), ``pattern``
    (``re.search``);
  * arrays: ``minItems``, ``maxItems``, ``uniqueItems``,
    ``prefixItems``, ``items``, ``contains`` with ``minContains`` and
    ``maxContains``;
  * objects: ``minProperties``, ``maxProperties``, ``required``,
    ``dependentRequired``, ``dependentSchemas``, ``properties``,
    ``patternProperties``, ``additionalProperties``, ``propertyNames``;
  * ``allOf``, ``anyOf``, ``oneOf``, ``not``, ``if``/``then``/``else``;
  * ``$ref`` to a JSON pointer inside the same document (``#``,
    ``#/$defs/name``).

``format`` is an annotation, as in ``jsonschema``'s default, and so are
the other keywords that assert nothing.  A schema that uses
``$dynamicRef``, ``$recursiveRef``, ``unevaluatedProperties``,
``unevaluatedItems``, or a ``$ref`` that is not a local JSON pointer
raises ValueError when the validator is made, naming the keyword.
"""

from __future__ import annotations

import re
from fractions import Fraction
from typing import Any, Dict
from urllib.parse import unquote

REFUSED = ("$dynamicRef", "$recursiveRef", "unevaluatedProperties",
           "unevaluatedItems")


class ValidationError(ValueError):
    """The instance is not valid under the schema."""


def equal(a: Any, b: Any) -> bool:
    """JSON equality: booleans are not numbers, containers compare
    element by element."""
    if a is b:
        return True
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(map(equal, a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return len(a) == len(b) and all(
            k in b and equal(v, b[k]) for k, v in a.items())
    if isinstance(a, bool) or isinstance(b, bool):
        return isinstance(a, bool) and isinstance(b, bool) and a == b
    return a == b


def is_type(x: Any, t: str) -> bool:
    if t == "object":
        return isinstance(x, dict)
    if t == "array":
        return isinstance(x, list)
    if t == "string":
        return isinstance(x, str)
    if t == "boolean":
        return isinstance(x, bool)
    if t == "null":
        return x is None
    if isinstance(x, bool):
        return False
    if t == "number":
        return isinstance(x, (int, float))
    if t == "integer":
        return isinstance(x, int) or (isinstance(x, float)
                                      and x.is_integer())
    return False


def _pointer(root: Any, ref: str) -> Any:
    if ref == "#":
        return root
    if not ref.startswith("#/"):
        raise ValueError(f"$ref {ref!r}: only local JSON pointers "
                         "(#, #/...) are supported")
    node = root
    for part in ref[2:].split("/"):
        part = unquote(part).replace("~1", "/").replace("~0", "~")
        if isinstance(node, list):
            try:
                node = node[int(part)]
            except (ValueError, IndexError):
                raise ValueError(f"$ref {ref!r} does not resolve") from None
        elif isinstance(node, dict) and part in node:
            node = node[part]
        else:
            raise ValueError(f"$ref {ref!r} does not resolve")
    return node


# keywords whose object maps names to subschemas
_NAMED = ("properties", "patternProperties", "dependentSchemas", "$defs",
          "definitions")


def _scan(root: Any, node: Any, depth: int = 0) -> None:
    """Refuse what this validator does not implement, a non-local
    ``$ref`` included.  A local ``$ref`` resolves when an instance
    reaches it, as in jsonschema: one that points nowhere fails only
    the instances that reach it."""
    if depth > 200:
        raise ValueError("schema nested too deep")
    if isinstance(node, dict):
        for k, v in node.items():
            if k in REFUSED:
                raise ValueError(f"{k} is not supported by this validator")
            if k == "$ref":
                if not isinstance(v, str):
                    raise ValueError("$ref must be a string")
                if v != "#" and not v.startswith("#/"):
                    raise ValueError(f"$ref {v!r}: only local JSON "
                                     "pointers (#, #/...) are supported")
            elif k in ("const", "enum", "default", "examples"):
                continue  # instance data, not schemas
            elif k in _NAMED and isinstance(v, dict):
                for sub in v.values():  # the keys are names, not keywords
                    _scan(root, sub, depth + 1)
                continue
            _scan(root, v, depth + 1)
    elif isinstance(node, list):
        for v in node:
            _scan(root, v, depth + 1)


class Validator:
    def __init__(self, schema: Any) -> None:
        _scan(schema, schema)
        self.schema = schema

    def is_valid(self, instance: Any) -> bool:
        return self._ok(self.schema, instance, 0)

    def validate(self, instance: Any) -> None:
        if not self._ok(self.schema, instance, 0):
            raise ValidationError(
                f"{instance!r} is not valid under the schema")

    def _ok(self, s: Any, x: Any, depth: int) -> bool:
        if s is True:
            return True
        if s is False:
            return False
        if not isinstance(s, dict):
            raise ValueError(f"not a schema: {s!r}")
        if depth > 500:
            raise ValueError("$ref recursion too deep")
        for k, v in s.items():
            check = _KEYWORDS.get(k)
            if check is not None and not check(self, v, x, s, depth + 1):
                return False
        return True


def _type(V, types, x, s, d):
    types = types if isinstance(types, list) else [types]
    return any(is_type(x, t) for t in types)


def _enum(V, values, x, s, d):
    return any(equal(e, x) for e in values)


def _const(V, c, x, s, d):
    return equal(x, c)


def _num(x) -> bool:
    return is_type(x, "number")


def _multiple_of(V, m, x, s, d):
    if not _num(x):
        return True
    if isinstance(m, float):
        q = x / m
        try:
            return int(q) == q
        except OverflowError:
            return (Fraction(x) / Fraction(m)).denominator == 1
    return not x % m


def _unique(V, u, x, s, d):
    if not u or not isinstance(x, list):
        return True
    for i in range(len(x)):
        for j in range(i):
            if equal(x[i], x[j]):
                return False
    return True


def _prefix_items(V, prefix, x, s, d):
    if not isinstance(x, list):
        return True
    return all(V._ok(sub, item, d) for sub, item in zip(prefix, x))


def _items(V, items, x, s, d):
    if not isinstance(x, list):
        return True
    start = len(s.get("prefixItems", []))
    if len(x) <= start:
        return True
    if items is False:
        return False
    return all(V._ok(items, item, d) for item in x[start:])


def _contains(V, sub, x, s, d):
    if not isinstance(x, list):
        return True
    lo = s.get("minContains", 1)
    hi = s.get("maxContains", len(x))
    n = 0
    for item in x:
        if V._ok(sub, item, d):
            n += 1
            if n > hi:
                return False
    return n >= lo


def _required(V, names, x, s, d):
    return not isinstance(x, dict) or all(n in x for n in names)


def _dependent_required(V, deps, x, s, d):
    if not isinstance(x, dict):
        return True
    return all(n in x for p, need in deps.items() if p in x for n in need)


def _dependent_schemas(V, deps, x, s, d):
    if not isinstance(x, dict):
        return True
    return all(V._ok(sub, x, d) for p, sub in deps.items() if p in x)


def _properties(V, props, x, s, d):
    if not isinstance(x, dict):
        return True
    return all(V._ok(sub, x[p], d) for p, sub in props.items() if p in x)


def _pattern_properties(V, pats, x, s, d):
    if not isinstance(x, dict):
        return True
    return all(V._ok(sub, v, d) for pat, sub in pats.items()
               for k, v in x.items() if re.search(pat, k))


def _additional(V, extra, x, s, d):
    if not isinstance(x, dict):
        return True
    props = s.get("properties", {})
    pats = "|".join(s.get("patternProperties", {}))
    rest = [k for k in x
            if k not in props and not (pats and re.search(pats, k))]
    if isinstance(extra, dict):
        return all(V._ok(extra, x[k], d) for k in rest)
    return bool(extra) or not rest


def _property_names(V, sub, x, s, d):
    return not isinstance(x, dict) or all(V._ok(sub, k, d) for k in x)


def _one_of(V, subs, x, s, d):
    return sum(1 for sub in subs if V._ok(sub, x, d)) == 1


def _if(V, cond, x, s, d):
    if V._ok(cond, x, d):
        return "then" not in s or V._ok(s["then"], x, d)
    return "else" not in s or V._ok(s["else"], x, d)


def _ref(V, ref, x, s, d):
    return V._ok(_pointer(V.schema, ref), x, d)


_KEYWORDS: Dict[str, Any] = {
    "type": _type,
    "enum": _enum,
    "const": _const,
    "minimum": lambda V, m, x, s, d: not _num(x) or not x < m,
    "maximum": lambda V, m, x, s, d: not _num(x) or not x > m,
    "exclusiveMinimum": lambda V, m, x, s, d: not _num(x) or x > m,
    "exclusiveMaximum": lambda V, m, x, s, d: not _num(x) or x < m,
    "multipleOf": _multiple_of,
    "minLength": lambda V, n, x, s, d: not isinstance(x, str) or len(x) >= n,
    "maxLength": lambda V, n, x, s, d: not isinstance(x, str) or len(x) <= n,
    "pattern": lambda V, p, x, s, d: (not isinstance(x, str)
                                      or re.search(p, x) is not None),
    "minItems": lambda V, n, x, s, d: not isinstance(x, list) or len(x) >= n,
    "maxItems": lambda V, n, x, s, d: not isinstance(x, list) or len(x) <= n,
    "uniqueItems": _unique,
    "prefixItems": _prefix_items,
    "items": _items,
    "contains": _contains,
    "minProperties": lambda V, n, x, s, d: (not isinstance(x, dict)
                                            or len(x) >= n),
    "maxProperties": lambda V, n, x, s, d: (not isinstance(x, dict)
                                            or len(x) <= n),
    "required": _required,
    "dependentRequired": _dependent_required,
    "dependentSchemas": _dependent_schemas,
    "properties": _properties,
    "patternProperties": _pattern_properties,
    "additionalProperties": _additional,
    "propertyNames": _property_names,
    "allOf": lambda V, subs, x, s, d: all(V._ok(sub, x, d) for sub in subs),
    "anyOf": lambda V, subs, x, s, d: any(V._ok(sub, x, d) for sub in subs),
    "oneOf": _one_of,
    "not": lambda V, sub, x, s, d: not V._ok(sub, x, d),
    "if": _if,
    "$ref": _ref,
}
