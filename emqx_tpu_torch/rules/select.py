"""Batched SELECT lowering + precompiled ``${a.b}`` templates.

A port of the JAX package's ``rules/select.py``.  The output half of
the rule matrix (the WHERE half lives in `predicate.py`/`columns.py`):
a lowerable SELECT list — field projections, literals, arithmetic,
``*`` — compiles ONCE per registry revision into a `SelectProgram`
whose inputs are raw-value planes on the shared `WindowColumns`, so
one pass over a window materializes action payloads for every matched
row of every lowered rule.  Rules whose SELECT uses nodes the compiler
doesn't cover (function calls, CASE, comparisons) degrade per RULE to
the scalar interpreter (`runtime.eval_select`), which stays the
referee.

Placeholder templates (``${a.b}``, `emqx_placeholder` semantics) get
the same treatment: `compile_template` parses a template ONCE into a
segment program (literal chunks + resolved path tuples).
`TemplateProgram.render` is the scalar form and `render_rows` the
column form used by the batched egress.

Value semantics are anchored to the interpreter on purpose:

- projection/star values come from a raw-value plane filled during
  the one `WindowColumns` walk (``keep_values``); a lookup error or a
  missing key is ``None``, exactly `eval_select`'s catch;
- arithmetic closures call `runtime.arith_op` — the SAME function the
  interpreter calls — so int-ness preservation (``json.dumps(5)`` !=
  ``json.dumps(5.0)``), string ``+`` concat and div-by-zero ->
  ``None`` hold bit-identically;
- expression operands distinguish lookup ERROR (raises, field ->
  ``None``) from missing (operand is ``None`` -> arithmetic raises),
  via the err lane, like `lookup_var`.
"""

from __future__ import annotations

import json
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .runtime import (
    EvalError, _PayloadStr, _STAR_FIELDS, _default_name, arith_op,
)
from .sql import ParsedSql

_PLACEHOLDER = re.compile(r"\$\{([^}]+)\}")

_MISSING = object()


def stringify(v: Any) -> str:
    """Template placeholder value -> text (emqx_placeholder parity;
    the exact `render_template` substitution semantics, shared by the
    scalar and column renderers)."""
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

    __slots__ = ("template", "parts", "n_slots", "_fmt")

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
        # %-format twin of ``parts`` (literals escaped): the column
        # renderer substitutes whole ROWS at C speed with one
        # ``fmt % tuple`` per row instead of a per-part join
        self._fmt = "".join(
            p.replace("%", "%%") if p.__class__ is str else "%s"
            for p in parts
        )

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

    def render_rows(
        self, cols: Dict[str, Sequence[Any]], n: int
    ) -> List[str]:
        """Column substitution: one rendered string per row, reading
        each placeholder's head from the SELECTed output columns.
        Bit-identical to calling `render` on each row's dict."""
        if not self.n_slots:
            return [self.template] * n
        vcols: List[List[str]] = []
        for part in self.parts:
            if part.__class__ is str:
                continue
            col = cols.get(part[0], _MISSING)
            if col is _MISSING:
                vcols.append(["undefined"] * n)
            elif len(part) == 1:
                vcols.append([stringify(v) for v in col])
            else:
                rest = part[1:]
                vals: List[str] = []
                for v in col:
                    cur: Any = v
                    for seg in rest:
                        if isinstance(cur, dict) and seg in cur:
                            cur = cur[seg]
                        else:
                            cur = _MISSING
                            break
                    vals.append(
                        "undefined" if cur is _MISSING
                        else stringify(cur)
                    )
                vcols.append(vals)
        fmt = self._fmt
        if len(vcols) == 1:
            return [fmt % (v,) for v in vcols[0]]
        return [fmt % t for t in zip(*vcols)]


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


# ------------------------------------------------------ SELECT lowering


class _Unsupported(Exception):
    pass


_ARITH_SYMS = ("+", "-", "*", "/", "div", "mod")


def _compile_expr(
    expr: tuple, reg: Callable[[Tuple[str, ...]], int]
) -> Callable[[tuple, tuple], Any]:
    """AST subtree -> closure over one row's gathered operand values
    (``vals``) and error flags (``errs``), indexed by the local path
    slots ``reg`` hands out.  Raises `_Unsupported` on nodes outside
    the lowerable subset (calls, CASE, comparisons, IN, NOT)."""
    kind = expr[0]
    if kind == "lit":
        v = expr[1]
        return lambda vals, errs: v
    if kind == "var":
        k = reg(expr[1])

        def var_fn(vals, errs, _k=k):
            if errs[_k]:
                # `lookup_var` raised for this row: the interpreter's
                # eval_expr propagates, so the compiled form does too
                raise EvalError("lookup error")
            return vals[_k]

        return var_fn
    if kind == "neg":
        f = _compile_expr(expr[1], reg)

        def neg_fn(vals, errs, _f=f):
            v = _f(vals, errs)
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                raise EvalError(f"negating non-number {v!r}")
            return -v

        return neg_fn
    if kind == "op" and expr[1] in _ARITH_SYMS:
        sym = expr[1]
        fa = _compile_expr(expr[2], reg)
        fb = _compile_expr(expr[3], reg)
        return lambda vals, errs: arith_op(
            sym, fa(vals, errs), fb(vals, errs)
        )
    raise _Unsupported(kind)


class SelectProgram:
    """One rule's lowered SELECT list.

    ``fields`` entries are ``(kind, name, arg)``:

    - ``("var", name, slot)`` — projection of local path slot
    - ``("lit", name, value)`` — constant column
    - ``("expr", name, fn)`` — compiled arithmetic closure
    - ``("star", None, ((name, slot), ...))`` — ``*`` expansion over
      the eight `_STAR_FIELDS`

    ``paths`` is the tuple of var paths the program reads; slots index
    into it.  ``has_expr`` gates the error-lane gather: only compiled
    expressions distinguish lookup-error from missing (projections
    emit ``None`` for both)."""

    __slots__ = ("fields", "paths", "has_expr")

    def __init__(self, fields: tuple, paths: tuple) -> None:
        self.fields = fields
        self.paths = paths
        self.has_expr = any(f[0] == "expr" for f in fields)


def compile_select(parsed: ParsedSql) -> Optional[SelectProgram]:
    """Lower a SELECT list, or None when any field uses nodes outside
    the compiled subset (the rule then degrades to the interpreter)."""
    paths: List[Tuple[str, ...]] = []
    pix: Dict[Tuple[str, ...], int] = {}

    def reg(path: Tuple[str, ...]) -> int:
        k = pix.get(path)
        if k is None:
            k = pix[path] = len(paths)
            paths.append(path)
        return k

    fields: List[tuple] = []
    try:
        for f in parsed.fields:
            if f.star:
                fields.append((
                    "star", None,
                    tuple((k, reg((k,))) for k in _STAR_FIELDS),
                ))
                continue
            name = f.alias or _default_name(f.expr)
            e = f.expr
            if e[0] == "lit":
                fields.append(("lit", name, e[1]))
            elif e[0] == "var":
                fields.append(("var", name, reg(e[1])))
            else:
                fields.append(("expr", name, _compile_expr(e, reg)))
    except _Unsupported:
        return None
    return SelectProgram(tuple(fields), tuple(paths))


class SelectStack:
    """The enabled registry's lowered SELECT programs over one shared
    path union: ``all_paths`` extends the WHERE stack's path list (the
    WHERE rows' plane indices stay valid — SELECT paths are strictly
    APPENDED), ``planes[rule_id]`` maps each program's local slots to
    plane rows in that combined space."""

    __slots__ = ("progs", "planes", "all_paths", "n_lowered")

    def __init__(self, progs, planes, all_paths) -> None:
        self.progs: Dict[str, SelectProgram] = progs
        self.planes: Dict[str, Tuple[int, ...]] = planes
        self.all_paths: Tuple[Tuple[str, ...], ...] = all_paths
        self.n_lowered = len(progs)


def build_select_stack(
    rules: Sequence[Tuple[str, ParsedSql]],
    base_paths: Sequence[Tuple[str, ...]],
) -> SelectStack:
    paths: List[Tuple[str, ...]] = list(base_paths)
    ix: Dict[Tuple[str, ...], int] = {
        p: k for k, p in enumerate(paths)
    }
    progs: Dict[str, SelectProgram] = {}
    planes: Dict[str, Tuple[int, ...]] = {}
    for rid, parsed in rules:
        prog = compile_select(parsed)
        if prog is None:
            continue
        pl: List[int] = []
        for p in prog.paths:
            k = ix.get(p)
            if k is None:
                k = ix[p] = len(paths)
                paths.append(p)
            pl.append(k)
        progs[rid] = prog
        planes[rid] = tuple(pl)
    return SelectStack(progs, planes, tuple(paths))


def materialize_rows(
    prog: SelectProgram,
    planes: Tuple[int, ...],
    cols,  # WindowColumns built with keep_values=True
    rows: Sequence[int],
) -> Tuple[List[str], List[List[Any]]]:
    """One rule's SELECT over its matched window rows in one pass:
    gather the program's value/err planes for ``rows``, then produce
    one output column per SELECT field.  Returns ``(names, columns)``
    aligned with the (star-expanded) field list; a per-row dict built
    as ``dict(zip(names, row))`` is bit-identical to
    `runtime.eval_select` (duplicate names keep first position, last
    value — plain dict-assignment semantics)."""
    vals_planes = cols.vals
    gv: List[List[Any]] = []
    ge: List[List[bool]] = []
    for g in planes:
        plane = vals_planes[g]
        gv.append([plane[i] for i in rows])
    if prog.has_expr:
        # scalar-index the numpy err rows: matched sets are usually a
        # few rows, where fancy-index + tolist costs more than it saves
        err_planes = cols.err
        for g in planes:
            erow = err_planes[g]
            ge.append([erow[i] for i in rows])
    n = len(rows)
    names: List[str] = []
    colvals: List[List[Any]] = []
    vrows = erows = None
    for kind, name, arg in prog.fields:
        if kind == "star":
            for sname, k in arg:
                names.append(sname)
                colvals.append(gv[k])
        elif kind == "var":
            names.append(name)
            colvals.append(gv[arg])
        elif kind == "lit":
            names.append(name)
            colvals.append([arg] * n)
        else:  # compiled expression
            if vrows is None:  # one transpose, shared by every expr
                vrows = list(zip(*gv)) if gv else [()] * n
                erows = list(zip(*ge)) if ge else [()] * n
            fn = arg
            out: List[Any] = []
            for r in range(n):
                try:
                    v = fn(vrows[r], erows[r])
                except (EvalError, TypeError, ValueError):
                    v = None
                if isinstance(v, _PayloadStr):
                    v = str(v)
                out.append(v)
            names.append(name)
            colvals.append(out)
    return names, colvals
