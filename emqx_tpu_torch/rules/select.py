"""Precompiled ``${a.b}`` placeholder templates (`emqx_placeholder`
semantics), the part of the JAX package's ``rules/select.py`` that the
republish action needs.

`compile_template` parses a template ONCE into a segment program
(literal chunks + resolved path tuples); `TemplateProgram.render`
substitutes one SELECTed row.  The batched SELECT lowering of the JAX
package (`build_select_stack`, `materialize_rows`) feeds only the sink
and aggregate actions, which this package does not have yet.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List

_PLACEHOLDER = re.compile(r"\$\{([^}]+)\}")

_MISSING = object()


def stringify(v: Any) -> str:
    """Template placeholder value -> text (emqx_placeholder parity;
    the exact `render_template` substitution semantics)."""
    t = type(v)
    if t is str:  # exact-type fast path: the dominant case by far
        return v
    if t is int:
        return str(v)
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    if isinstance(v, (dict, list)):
        return json.dumps(v)
    return str(v)


class TemplateProgram:
    """One parsed ``${a.b}`` template: an alternating sequence of
    literal string chunks and pre-split path tuples."""

    __slots__ = ("template", "parts", "n_slots")

    def __init__(self, template: str) -> None:
        self.template = template
        parts: List[Any] = []
        pos = 0
        n_slots = 0
        for m in _PLACEHOLDER.finditer(template):
            if m.start() > pos:
                parts.append(template[pos:m.start()])
            parts.append(tuple(m.group(1).split(".")))
            n_slots += 1
            pos = m.end()
        if pos < len(template):
            parts.append(template[pos:])
        self.parts = tuple(parts)
        self.n_slots = n_slots

    def render(self, data: Dict[str, Any]) -> str:
        """Scalar substitution against one SELECTed row."""
        if not self.n_slots:
            return self.template
        out: List[str] = []
        for part in self.parts:
            if part.__class__ is str:
                out.append(part)
                continue
            cur: Any = data
            for seg in part:
                if isinstance(cur, dict) and seg in cur:
                    cur = cur[seg]
                else:
                    cur = _MISSING
                    break
            out.append(
                "undefined" if cur is _MISSING else stringify(cur)
            )
        return "".join(out)


# compiled-template cache: action templates are a small fixed set per
# registry, but ad-hoc render_template callers ride the same cache
_TEMPLATE_CACHE: Dict[str, TemplateProgram] = {}
_TEMPLATE_CACHE_CAP = 4096


def compile_template(template: str) -> TemplateProgram:
    prog = _TEMPLATE_CACHE.get(template)
    if prog is None:
        if len(_TEMPLATE_CACHE) >= _TEMPLATE_CACHE_CAP:
            _TEMPLATE_CACHE.clear()
        prog = _TEMPLATE_CACHE[template] = TemplateProgram(template)
    return prog
