"""Batched WHERE-predicate compiler: rule conditions over message
columns as one vectorized step.

A port of the JAX package's ``rules/predicate.py``.  EMQX interprets
each rule's WHERE per message (emqx_rule_runtime.erl:60-100).  Here a
WHERE AST compiles — when its node set allows — into a column program
evaluated over the whole publish micro-batch at once.  Two forms:

  * `PredicateProgram`: ONE rule over a batch of envs, evaluated with
    numpy.  (The JAX package also jits it for its device; that kernel,
    K6, is not ported yet and ``eval_batch(use_jax=True)`` raises.)
  * `StackedRules` (`lower_where` + `build_stack`): the whole registry
    lowered to opcode/operand matrices that
    `ops.match_kernel.rules_eval_batch` (K4) evaluates as one
    rules x window boolean matrix.

Semantics must match the interpreter (`runtime.eval_where`) exactly:

  * ordering comparisons / arithmetic on a null or non-numeric value
    ERROR, and an error makes the whole WHERE false — but
    short-circuiting means an error on the right of an
    already-decided and/or never surfaces.  Captured by compiling
    every boolean node to a (T, F) pair — "provably true" /
    "provably false without error" under short-circuit order:

        ordering cmp:  T = defined & cmp,  F = defined & ~cmp
        not:           (T, F) -> (F, T)
        and:           T = Tl & Tr,        F = Fl | (Tl & Fr)
        or:            T = Tl | (Fl & Tr), F = Fl & Fr

  * equality (`=`, `!=`) over plain operands (var / literal) is TOTAL:
    null or cross-type operands are simply unequal (no error) — so
    `missing != 'y'` is TRUE.  Equality over a compound side (an
    arithmetic expression) inherits that side's error semantics.
  * booleans are their own type: `retain = 1` is false even when
    retain is true (Erlang term inequality in EMQX).

Columns are dual-typed: each var extracts to a float lane (NaN = not a
number/undefined) and a dictionary-encoded id lane (-1 = not a
string/bool; bools get reserved ids).  Comparisons pick lanes by
operand type.  Unsupported nodes (function calls, CASE, bare vars in
boolean position) make ``compile_where`` return None and the caller
falls back to the interpreter.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .runtime import lookup_var

# reserved string-lane ids for booleans ('\x00' cannot occur in MQTT
# UTF-8 strings, so these keys cannot collide with real payloads)
_TRUE_KEY = "\x00true"
_FALSE_KEY = "\x00false"


class _Unsupported(Exception):
    pass


class PredicateProgram:
    """A compiled WHERE: collect var columns, evaluate batched."""

    def __init__(self, where: tuple, var_paths: List[Tuple[str, ...]]):
        self.where = where
        self.var_paths = var_paths

    # ---------------------------------------------------- extraction

    def extract_columns(
        self, envs: Sequence[Dict[str, Any]]
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
        """Host side: pull each var path from each env into dual-typed
        columns; strings (and bools) dictionary-encoded per batch."""
        n = len(envs)
        sdict: Dict[str, int] = {_TRUE_KEY: 0, _FALSE_KEY: 1}
        num = {p: np.full(n, np.nan, np.float64) for p in self.var_paths}
        sid = {p: np.full(n, -1, np.int32) for p in self.var_paths}
        # a lookup ERROR (e.g. descending into a non-JSON payload) is
        # not the same as undefined: the interpreter errors when it
        # evaluates that var, making the WHERE false — tracked as a
        # third lane so total equality stays oracle-equal
        err = {p: np.zeros(n, bool) for p in self.var_paths}
        for i, env in enumerate(envs):
            for p in self.var_paths:
                try:
                    v = lookup_var(env, p)
                except Exception:
                    err[p][i] = True
                    continue
                if isinstance(v, bool):
                    sid[p][i] = sdict[_TRUE_KEY if v else _FALSE_KEY]
                elif isinstance(v, (int, float)):
                    num[p][i] = v
                elif isinstance(v, str):
                    key = str(v)
                    if key not in sdict:
                        sdict[key] = len(sdict)
                    sid[p][i] = sdict[key]
        cols = {}
        for p in self.var_paths:
            cols["n:" + "/".join(p)] = num[p]
            cols["s:" + "/".join(p)] = sid[p]
            cols["e:" + "/".join(p)] = err[p]
        return cols, sdict

    # ---------------------------------------------------- evaluation

    def eval_batch(
        self, envs: Sequence[Dict[str, Any]], use_jax: bool = False
    ) -> np.ndarray:
        if use_jax:
            raise NotImplementedError(
                "K6 not yet ported: PredicateProgram.eval_batch runs on "
                "the host only"
            )
        cols, sdict = self.extract_columns(envs)
        lit_ids = _literal_ids(self.where, sdict)
        t, _ = _eval(self.where, cols, lit_ids, np)
        return np.asarray(t)


def _string_literals(expr: tuple, out: Set[str]) -> None:
    kind = expr[0]
    if kind == "lit" and isinstance(expr[1], str):
        out.add(expr[1])
    elif kind == "op":
        _string_literals(expr[2], out)
        _string_literals(expr[3], out)
    elif kind in ("not", "neg"):
        _string_literals(expr[1], out)
    elif kind == "in":
        _string_literals(expr[1], out)
        for e in expr[2]:
            _string_literals(e, out)


def _literal_ids(where: tuple, sdict: Dict[str, int]) -> Dict[str, int]:
    """Map string literals to batch-dict ids (-2 = absent from batch:
    matches nothing, distinct from -1 'not a string')."""
    lits: Set[str] = set()
    _string_literals(where, lits)
    return {s: sdict.get(s, -2) for s in lits}


def _collect_vars(expr: tuple, out: List[Tuple[str, ...]]) -> None:
    kind = expr[0]
    if kind == "var":
        if expr[1] not in out:
            out.append(expr[1])
    elif kind == "op":
        _collect_vars(expr[2], out)
        _collect_vars(expr[3], out)
    elif kind in ("not", "neg"):
        _collect_vars(expr[1], out)
    elif kind == "in":
        _collect_vars(expr[1], out)
        for e in expr[2]:
            _collect_vars(e, out)
    elif kind in ("call", "case"):
        raise _Unsupported(kind)


def compile_where(where: Optional[tuple]) -> Optional[PredicateProgram]:
    """Compile if every node is in the supported subset, else None."""
    if where is None:
        return None
    try:
        paths: List[Tuple[str, ...]] = []
        _collect_vars(where, paths)
        _check_bool(where)
    except _Unsupported:
        return None
    return PredicateProgram(where, paths)


def _check_bool(expr: tuple) -> None:
    """Validate a boolean-position node."""
    kind = expr[0]
    if kind == "lit" and isinstance(expr[1], bool):
        return
    if kind == "not":
        return _check_bool(expr[1])
    if kind == "in":
        lt = _check_val(expr[1])
        for e in expr[2]:
            et = _check_val(e)
            if "bool" in (lt, et):
                raise _Unsupported("bool in IN")
            if lt != "var" and et != "var" and et != lt:
                raise _Unsupported("mixed IN list")
        return
    if kind == "op":
        sym = expr[1]
        if sym in ("and", "or"):
            _check_bool(expr[2])
            _check_bool(expr[3])
            return
        if sym in ("=", "!=", ">", "<", ">=", "<="):
            lt, rt = _check_val(expr[2]), _check_val(expr[3])
            if "bool" in (lt, rt):
                raise _Unsupported("bool compare")
            if lt == "str" and rt == "str":
                raise _Unsupported("str-str compare is constant")
            if "str" in (lt, rt):
                other = rt if lt == "str" else lt
                if other != "var":
                    raise _Unsupported("str vs num compare")
                if sym not in ("=", "!="):
                    raise _Unsupported("string ordering")
            return
    raise _Unsupported(f"{kind} at boolean position")


def _check_val(expr: tuple) -> str:
    """Validate a value-position node -> 'num' | 'str' | 'bool' |
    'var' (dual-typed) | 'expr' (compound numeric)."""
    kind = expr[0]
    if kind == "lit":
        v = expr[1]
        if isinstance(v, bool):
            return "bool"
        if isinstance(v, (int, float)):
            return "num"
        if isinstance(v, str):
            return "str"
        raise _Unsupported(f"literal {v!r}")
    if kind == "var":
        return "var"
    if kind == "neg":
        t = _check_val(expr[1])
        if t not in ("num", "var", "expr"):
            raise _Unsupported("neg of non-number")
        return "expr"
    if kind == "op" and expr[1] in ("+", "-", "*", "/", "div", "mod"):
        for sub in (expr[2], expr[3]):
            if _check_val(sub) not in ("num", "var", "expr"):
                raise _Unsupported("arith on non-numbers")
        return "expr"
    raise _Unsupported(kind)


def _eval(expr: tuple, cols, lit_ids, xp):
    """Boolean-position evaluation -> (T, F) masks."""
    kind = expr[0]
    if kind == "op" and expr[1] in ("and", "or"):
        tl, fl = _eval(expr[2], cols, lit_ids, xp)
        tr, fr = _eval(expr[3], cols, lit_ids, xp)
        if expr[1] == "and":
            return tl & tr, fl | (tl & fr)
        return tl | (fl & tr), fl & fr
    if kind == "not":
        t, f = _eval(expr[1], cols, lit_ids, xp)
        return f, t
    if kind == "lit":  # bool literal (validated)
        n = _batch_len(cols)
        full = xp.full(n, bool(expr[1]))
        return full, ~full
    if kind == "in":
        ts = fs = None
        for e in expr[2]:
            t, f = _eval(("op", "=", expr[1], e), cols, lit_ids, xp)
            ts = t if ts is None else (ts | (fs & t))
            fs = f if fs is None else (fs & f)
        return ts, fs
    if kind == "op":
        return _eval_cmp(expr, cols, lit_ids, xp)
    raise AssertionError(f"non-boolean node at boolean position: {kind}")


def _is_simple(expr: tuple) -> bool:
    return expr[0] in ("lit", "var")


def _eval_cmp(expr: tuple, cols, lit_ids, xp):
    sym, le, re_ = expr[1], expr[2], expr[3]
    lstr = le[0] == "lit" and isinstance(le[1], str)
    rstr = re_[0] == "lit" and isinstance(re_[1], str)
    if lstr or rstr:
        # string-literal equality against a var's id lane; TOTAL except
        # when the var lookup itself ERRORED (interpreter: WHERE false)
        lit, var = (le, re_) if lstr else (re_, le)
        ids = cols["s:" + "/".join(var[1])]
        erv = cols["e:" + "/".join(var[1])]
        lid = lit_ids[lit[1]]
        eq = ~erv & (ids == lid)
        ne = ~erv & (ids != lid)
        return (eq, ne) if sym == "=" else (ne, eq)

    if sym in ("=", "!="):
        lv, ld = _num_eval_pair(le, cols, lit_ids, xp)
        rv, rd = _num_eval_pair(re_, cols, lit_ids, xp)
        eq = ld & rd & (lv == rv)
        if le[0] == "var" and re_[0] == "var":
            # var-var equality also matches on the id lanes
            li = cols["s:" + "/".join(le[1])]
            ri = cols["s:" + "/".join(re_[1])]
            eq = eq | ((li >= 0) & (li == ri))
        # equality itself is total; but a lookup ERROR on a simple var
        # (vs merely undefined) poisons the row, and a COMPOUND side
        # contributes its own error semantics (sub-expression may fail)
        ok = None
        for side in (le, re_):
            if side[0] == "var":
                e = cols["e:" + "/".join(side[1])]
                ok = ~e if ok is None else (ok & ~e)
        if ok is None:
            ok = xp.full(_batch_len(cols), True)
        cd = None
        for side, d in ((le, ld), (re_, rd)):
            if not _is_simple(side):
                cd = d if cd is None else (cd & d)
        if cd is None:
            return (
                (eq & ok, ~eq & ok) if sym == "=" else (~eq & ok, eq & ok)
            )
        return (
            (eq & ok, cd & ~eq & ok)
            if sym == "="
            else (cd & ~eq & ok, eq & ok)
        )

    # ordering: error semantics
    lv, ld = _num_eval_pair(le, cols, lit_ids, xp)
    rv, rd = _num_eval_pair(re_, cols, lit_ids, xp)
    d = ld & rd
    cmp = {
        ">": lv > rv,
        "<": lv < rv,
        ">=": lv >= rv,
        "<=": lv <= rv,
    }[sym]
    return d & cmp, d & ~cmp


def _num_eval_pair(expr: tuple, cols, lit_ids, xp):
    """Numeric (value, defined) evaluation."""
    kind = expr[0]
    if kind == "lit":
        n = _batch_len(cols)
        v = xp.full(n, float(expr[1]), np.float64)
        return v, xp.full(n, True)
    if kind == "var":
        v = cols["n:" + "/".join(expr[1])]
        return v, ~xp.isnan(v)
    if kind == "neg":
        v, d = _num_eval_pair(expr[1], cols, lit_ids, xp)
        return -v, d
    if kind == "op":
        sym = expr[1]
        lv, ld = _num_eval_pair(expr[2], cols, lit_ids, xp)
        rv, rd = _num_eval_pair(expr[3], cols, lit_ids, xp)
        d = ld & rd
        if sym == "+":
            return lv + rv, d
        if sym == "-":
            return lv - rv, d
        if sym == "*":
            return lv * rv, d
        if sym == "/":
            ok = rv != 0
            return xp.where(ok, lv / xp.where(ok, rv, 1), 0), d & ok
        # div/mod: the interpreter truncates BOTH operands to int
        # first (int(a) // int(b), int(a) % int(b)), then floor-divides
        ta = xp.trunc(lv)
        tb = xp.trunc(rv)
        ok = tb != 0
        safe = xp.where(ok, tb, 1)
        q = xp.floor(ta / safe)
        if sym == "div":
            return q, d & ok
        return ta - q * safe, d & ok
    raise AssertionError(f"bad numeric node {kind}")


def _batch_len(cols) -> int:
    return next(iter(cols.values())).shape[0]


# ===================================================================
# Registry-wide lowering: the rules x window matrix program
#
# The PredicateProgram above vectorizes ONE rule over a batch of envs;
# a broker with thousands of rules still pays a Python step per rule
# per window.  The lowering below goes the rest of the way: each
# rule's WHERE compiles into a LINEAR instruction row over a SHARED
# column space (`rules/columns.py` extracts the window once), and the
# whole registry stacks into opcode/operand matrices that
# `ops.match_kernel.rules_eval_batch` (K4: the CUDA kernel, or its
# plain PyTorch version for CPU tensors) evaluates as one rules x
# window boolean matrix.
#
# Register machine: step s writes register s.  Numeric registers are
# (value, defined) pairs; boolean registers are the same (T, F)
# "provably true / provably false without error" pairs the
# short-circuit algebra above uses, so error semantics stay
# bit-identical to the interpreter.  Column planes per referenced
# path (see WindowColumns): ``num`` (float64, NaN = not a number),
# ``sid`` (int32 per-window string RANK, order-preserving, so string
# ordering comparisons lower too; -1 = not a string, -2/-3 = bool
# true/false), ``err`` (lookup raised), ``prs`` (lookup succeeded and
# value is not null).
# ===================================================================

R_NOP = 0
R_NLOAD = 1   # a0=plane           -> (num[p], ~isnan)
R_NLIT = 2    # litn[r,s]          -> (lit, True)
R_NNEG = 3    # a0=reg
R_NADD = 4    # a0,a1=regs
R_NSUB = 5
R_NMUL = 6
R_NDIV = 7    # defined &= rhs != 0
R_NIDV = 8    # trunc both, floor-divide (interpreter div)
R_NMOD = 9
R_BLIT = 10   # a0 = 0/1
R_BNOT = 11   # a0=reg             -> (F, T)
R_BAND = 12   # a0,a1=regs         -> (Tl&Tr, Fl|(Tl&Fr))
R_BOR = 13    # a0,a1=regs         -> (Tl|(Fl&Tr), Fl&Fr)
R_CGT = 14    # a0,a1=num regs; a2,a3=string planes (-1: not a bare
R_CLT = 15    #   var) — rows where BOTH sides are strings compare by
R_CGE = 16    #   per-window rank (interpreter string ordering)
R_CLE = 17
R_EQVV = 18   # a0=plane p, a1=plane q, a2=negate
R_EQVL = 19   # a0=plane p, numeric literal in litn, a2=negate
R_EQSL = 20   # a0=plane p, a1=string-literal index, a2=negate
R_EQC = 21    # a0,a1=num regs; a2=flags(neg|lcomp<<1|rcomp<<2);
              #   a3=simple-var err plane for totality (-1: none)
R_PRES = 22   # a0=plane p, a2=negate (negate -> is_null)

# rows deeper than this fall back to the interpreter (bounds the
# stacked register file: S x R x W planes)
MAX_STEPS = 48

# presence-check calls that lower onto the prs/err planes
_PRESENCE_FUNCS = {"is_null": 1, "is_not_null": 0}


class LoweredRule:
    """One rule's linear program over its LOCAL path/literal spaces
    (the stacker remaps to the registry-global spaces)."""

    __slots__ = ("steps", "paths", "lit_strings", "has_arith")

    def __init__(self) -> None:
        # (op, a0, a1, a2, a3, litn)
        self.steps: List[Tuple[int, int, int, int, int, float]] = []
        self.paths: List[Tuple[str, ...]] = []
        self.lit_strings: List[str] = []
        self.has_arith = False

    # ------------------------------------------------------- emit

    def _emit(self, op, a0=-1, a1=-1, a2=-1, a3=-1, litn=0.0) -> int:
        if len(self.steps) >= MAX_STEPS:
            raise _Unsupported("program too long")
        self.steps.append((op, a0, a1, a2, a3, float(litn)))
        return len(self.steps) - 1

    def _plane(self, path: Tuple[str, ...]) -> int:
        if path not in self.paths:
            self.paths.append(path)
        return self.paths.index(path)

    def _slit(self, s: str) -> int:
        if s not in self.lit_strings:
            self.lit_strings.append(s)
        return self.lit_strings.index(s)

    # ------------------------------------------------- bool position

    def lower_bool(self, expr: tuple) -> int:
        kind = expr[0]
        if kind == "lit" and isinstance(expr[1], bool):
            return self._emit(R_BLIT, 1 if expr[1] else 0)
        if kind == "not":
            return self._emit(R_BNOT, self.lower_bool(expr[1]))
        if kind == "in":
            lt = _check_val(expr[1])
            reg = None
            for e in expr[2]:
                et = _check_val(e)
                if "bool" in (lt, et):
                    raise _Unsupported("bool in IN")
                if lt != "var" and et != "var" and et != lt:
                    raise _Unsupported("mixed IN list")
                r = self.lower_cmp("=", expr[1], e)
                reg = r if reg is None else self._emit(R_BOR, reg, r)
            if reg is None:
                raise _Unsupported("empty IN")
            return reg
        if kind == "op":
            sym = expr[1]
            if sym == "and":
                return self._emit(
                    R_BAND,
                    self.lower_bool(expr[2]),
                    self.lower_bool(expr[3]),
                )
            if sym == "or":
                return self._emit(
                    R_BOR,
                    self.lower_bool(expr[2]),
                    self.lower_bool(expr[3]),
                )
            if sym in ("=", "!=", ">", "<", ">=", "<="):
                return self.lower_cmp(sym, expr[2], expr[3])
        if kind == "call":
            neg = _PRESENCE_FUNCS.get(expr[1])
            if (
                neg is not None
                and len(expr[2]) == 1
                and expr[2][0][0] == "var"
            ):
                p = self._plane(expr[2][0][1])
                return self._emit(R_PRES, p, -1, neg)
        raise _Unsupported(f"{kind} at boolean position")

    # ------------------------------------------------- comparisons

    def lower_cmp(self, sym: str, le: tuple, re_: tuple) -> int:
        lt, rt = _check_val(le), _check_val(re_)
        if "bool" in (lt, rt):
            raise _Unsupported("bool compare")
        if "str" in (lt, rt):
            if lt == "str" and rt == "str":
                if sym in ("=", "!="):
                    # constant-fold literal equality (IN lists build
                    # these); _sql_eq semantics on two str literals
                    eq = le[1] == re_[1]
                    if sym == "!=":
                        eq = not eq
                    return self._emit(R_BLIT, 1 if eq else 0)
                raise _Unsupported("str-str compare is constant")
            other = rt if lt == "str" else lt
            if other != "var":
                raise _Unsupported("str vs num compare")
            if sym not in ("=", "!="):
                raise _Unsupported("string ordering vs literal")
            lit, var = (le, re_) if lt == "str" else (re_, le)
            return self._emit(
                R_EQSL,
                self._plane(var[1]),
                self._slit(lit[1]),
                1 if sym == "!=" else 0,
            )
        if sym in ("=", "!="):
            neg = 1 if sym == "!=" else 0
            if lt == "var" and rt == "var":
                return self._emit(
                    R_EQVV, self._plane(le[1]), self._plane(re_[1]), neg
                )
            if lt == "var" and rt == "num":
                return self._emit(
                    R_EQVL, self._plane(le[1]), -1, neg, -1, re_[1]
                )
            if lt == "num" and rt == "var":
                return self._emit(
                    R_EQVL, self._plane(re_[1]), -1, neg, -1, le[1]
                )
            if lt == "num" and rt == "num":
                eq = float(le[1]) == float(re_[1])
                if neg:
                    eq = not eq
                return self._emit(R_BLIT, 1 if eq else 0)
            # a compound side carries its own error semantics
            a = self.lower_num(le)
            b = self.lower_num(re_)
            flags = neg
            if not _is_simple(le):
                flags |= 2
            if not _is_simple(re_):
                flags |= 4
            okp = -1
            if le[0] == "var":
                okp = self._plane(le[1])
            elif re_[0] == "var":
                okp = self._plane(re_[1])
            return self._emit(R_EQC, a, b, flags, okp)
        # ordering: numeric via the regs, string via per-window ranks
        # when BOTH sides are bare vars (rank order == lex order)
        a = self.lower_num(le)
        b = self.lower_num(re_)
        sp = self._plane(le[1]) if le[0] == "var" else -1
        sq = self._plane(re_[1]) if re_[0] == "var" else -1
        op = {">": R_CGT, "<": R_CLT, ">=": R_CGE, "<=": R_CLE}[sym]
        return self._emit(op, a, b, sp, sq)

    # --------------------------------------------------- value (num)

    def lower_num(self, expr: tuple) -> int:
        kind = expr[0]
        if kind == "lit":
            v = expr[1]
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise _Unsupported(f"numeric literal {v!r}")
            return self._emit(R_NLIT, -1, -1, -1, -1, v)
        if kind == "var":
            return self._emit(R_NLOAD, self._plane(expr[1]))
        if kind == "neg":
            if _check_val(expr[1]) not in ("num", "var", "expr"):
                raise _Unsupported("neg of non-number")
            self.has_arith = True
            return self._emit(R_NNEG, self.lower_num(expr[1]))
        if kind == "op" and expr[1] in ("+", "-", "*", "/", "div", "mod"):
            for sub in (expr[2], expr[3]):
                if _check_val(sub) not in ("num", "var", "expr"):
                    raise _Unsupported("arith on non-numbers")
            if expr[1] == "+" and _could_be_str(expr[2]) and (
                _could_be_str(expr[3])
            ):
                # interpreter '+' CONCATENATES two runtime strings;
                # the numeric lanes cannot — degrade this rule.
                # (string + number errors on both paths, so a single
                # could-be-string side stays lowerable.)
                raise _Unsupported("possible string concat")
            self.has_arith = True
            op = {
                "+": R_NADD, "-": R_NSUB, "*": R_NMUL,
                "/": R_NDIV, "div": R_NIDV, "mod": R_NMOD,
            }[expr[1]]
            return self._emit(
                op, self.lower_num(expr[2]), self.lower_num(expr[3])
            )
        raise _Unsupported(kind)


def _could_be_str(expr: tuple) -> bool:
    """Can this value expression produce a STRING at runtime?  Bare
    vars are dual-typed; a ``+`` of two could-be-strings can
    concatenate; every other arith shape errors on strings (making
    its result numeric-or-error on both paths)."""
    if expr[0] == "var":
        return True
    if expr[0] == "op" and expr[1] == "+":
        return _could_be_str(expr[2]) and _could_be_str(expr[3])
    return False


def lower_where(where: Optional[tuple]) -> Optional[LoweredRule]:
    """Lower one WHERE into a linear program row, or None when any
    node is outside the lowerable subset (regex/UDF-shaped calls,
    CASE, bare vars in boolean position, over-long programs) — the
    caller then degrades that RULE, not the window, to the
    interpreter."""
    prog = LoweredRule()
    if where is None:
        prog._emit(R_BLIT, 1)  # no WHERE: every routed message passes
        return prog
    try:
        prog.lower_bool(where)
    except _Unsupported:
        return None
    return prog


class StackedRules:
    """The whole registry's lowerable rules as one stacked program:
    opcode/operand matrices ``[R, S]`` over a shared plane space, plus
    the fallback set.  Built once per ``rules_rev`` (registry churn
    invalidates); `ops.match_kernel.rules_eval_batch` evaluates it
    against a `WindowColumns` extraction.

    ``litn`` stays float64, as in the JAX package: the port's kernel
    computes in float64, so every literal reaches it exactly.

    Identical programs DEDUP to one matrix row (``row_of`` maps every
    rule id to its shared row): a fleet registry of thousands of
    per-device rules differing only in topic filter — the IoT-pipeline
    shape — evaluates its WHERE once per distinct program, not once
    per rule, while per-rule matched/passed counters stay exact (the
    pair bookkeeping is per rule, only the boolean matrix is
    shared)."""

    __slots__ = (
        "row_of", "fallback", "paths", "lit_strings",
        "code", "a0", "a1", "a2", "a3", "litn", "last",
        "has_arith", "n_steps", "n_lowered",
    )

    def __init__(self, lowered: List[Tuple[str, LoweredRule]],
                 fallback: List[str]) -> None:
        self.fallback = fallback
        self.n_lowered = len(lowered)
        paths: List[Tuple[str, ...]] = []
        path_ix: Dict[Tuple[str, ...], int] = {}
        lits: List[str] = []
        lit_ix: Dict[str, int] = {}
        self.has_arith = any(p.has_arith for _, p in lowered)
        n_steps = max((len(p.steps) for _, p in lowered), default=1)
        self.n_steps = n_steps
        # which operand slots hold a plane index (per opcode) — the
        # stacker remaps those from rule-local to global planes
        plane_slots = {
            R_NLOAD: (0,), R_EQVV: (0, 1), R_EQVL: (0,),
            R_EQSL: (0,), R_PRES: (0,),
            R_CGT: (2, 3), R_CLT: (2, 3), R_CGE: (2, 3), R_CLE: (2, 3),
            R_EQC: (3,),
        }
        row_of: Dict[str, int] = {}
        uniq: Dict[Tuple, int] = {}
        programs: List[Tuple] = []
        for rid, prog in lowered:
            pmap = []
            for p in prog.paths:
                if p not in path_ix:
                    path_ix[p] = len(paths)
                    paths.append(p)
                pmap.append(path_ix[p])
            lmap = []
            for s in prog.lit_strings:
                if s not in lit_ix:
                    lit_ix[s] = len(lits)
                    lits.append(s)
                lmap.append(lit_ix[s])
            remapped = []
            for op, b0, b1, b2, b3, lv in prog.steps:
                args = [b0, b1, b2, b3]
                for slot in plane_slots.get(op, ()):
                    if args[slot] >= 0:
                        args[slot] = pmap[args[slot]]
                if op == R_EQSL and args[1] >= 0:
                    args[1] = lmap[args[1]]
                remapped.append((op, *args, lv))
            key = tuple(remapped)
            row = uniq.get(key)
            if row is None:
                row = uniq[key] = len(programs)
                programs.append(key)
            row_of[rid] = row
        self.row_of = row_of
        n_rows = max(len(programs), 0)
        code = np.zeros((n_rows, n_steps), np.int32)
        a0 = np.full((n_rows, n_steps), -1, np.int32)
        a1 = np.full((n_rows, n_steps), -1, np.int32)
        a2 = np.full((n_rows, n_steps), -1, np.int32)
        a3 = np.full((n_rows, n_steps), -1, np.int32)
        litn = np.zeros((n_rows, n_steps), np.float64)
        last = np.zeros(n_rows, np.int32)
        for r, steps in enumerate(programs):
            for s, (op, c0, c1, c2, c3, lv) in enumerate(steps):
                code[r, s] = op
                a0[r, s], a1[r, s] = c0, c1
                a2[r, s], a3[r, s] = c2, c3
                litn[r, s] = lv
            last[r] = len(steps) - 1
        self.paths = paths
        self.lit_strings = lits
        self.code, self.litn, self.last = code, litn, last
        self.a0, self.a1, self.a2, self.a3 = a0, a1, a2, a3

    @property
    def n_rules(self) -> int:
        """Distinct program rows (rules sharing a program share a
        row; `n_lowered` counts the rules themselves)."""
        return self.code.shape[0]


def build_stack(
    rules: Sequence[Tuple[str, Optional[tuple]]]
) -> StackedRules:
    """Stack every lowerable ``(rule_id, where)``; the rest land in
    ``fallback`` (degrade per RULE, never per window)."""
    lowered: List[Tuple[str, LoweredRule]] = []
    fallback: List[str] = []
    for rid, where in rules:
        prog = lower_where(where)
        if prog is None:
            fallback.append(rid)
        else:
            lowered.append((rid, prog))
    return StackedRules(lowered, fallback)
