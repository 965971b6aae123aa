"""Batched WHERE-predicate compiler: rule conditions over message
columns as one vectorized step.

A port of the JAX package's ``rules/predicate.py``.  EMQX interprets
each rule's WHERE per message (emqx_rule_runtime.erl:60-100).  Here a
WHERE AST compiles — when its node set allows — into a column program
evaluated over the whole publish micro-batch at once.  Two forms:

  * `PredicateProgram`: ONE rule over a batch of envs
    (``eval_batch(envs, device="cuda")``): the tree flattens into a
    small register program (`lower_predicate`) that
    `ops.match_kernel.predicate_eval_batch` (K6: the CUDA kernel, or its
    plain PyTorch version for CPU tensors) runs over the rule's columns.
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

import threading
from typing import (
    Any, Dict, List, NamedTuple, Optional, Sequence, Set, Tuple,
)

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
        self._code: Optional[PredicateCode] = None
        # device -> (the program on it, the stage its calls go through)
        self._dev_code: Dict[str, Any] = {}
        self._lock = threading.Lock()  # a stage serves one call at a time

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

    def eval_batch(self, envs: Sequence[Dict[str, Any]],
                   device="cuda") -> np.ndarray:
        """The WHERE's verdict per env, computed by K6 on ``device``
        (CUDA launches the kernel; the CPU runs its plain version), in
        float64.  A WHERE that reads no var raises StopIteration, as the
        JAX package's does (``_batch_len`` has no column to take the
        batch length from)."""
        cols, sdict = self.extract_columns(envs)
        return self.eval_columns(cols, _literal_ids(self.where, sdict),
                                 device)

    def eval_columns(self, cols: Dict[str, np.ndarray],
                     lit_ids: Dict[str, int], device="cuda") -> np.ndarray:
        """`eval_batch` from the extracted columns on: ``cols`` and
        ``lit_ids`` (`extract_columns` and `_literal_ids`, of either
        package) are packed into this program's `state.HostStage` for
        ``device`` and go up in one copy; K6 runs, and the verdicts come
        down after one synchronise.  Calls on one program serialise."""
        from ..ops.match_kernel import predicate_eval_batch
        from ..state import (
            HostStage, predicate_program_from_code, resolve_device,
        )

        w = _batch_len(cols)
        dev = resolve_device(device)
        names = tuple(k[2:] for k in cols if k.startswith("n:"))
        with self._lock:
            if self._code is None:
                self._code = lower_predicate(self.where, self.var_paths)
            code = self._code
            if (names, tuple(sorted(lit_ids))) != (code.names, code.lits):
                raise ValueError("columns do not belong to this predicate")
            key = str(dev)
            if key not in self._dev_code:
                self._dev_code[key] = (predicate_program_from_code(code, dev),
                                       HostStage(dev))
            prog, stage = self._dev_code[key]
            v = len(names)
            num, sid, err, ids = stage.views((
                (np.float64, (v, w)), (np.int32, (v, w)), (np.bool_, (v, w)),
                (np.int32, (len(code.lits),))))
            for i, n in enumerate(names):
                num[i], sid[i], err[i] = (cols[k + n] for k in ("n:", "s:",
                                                                "e:"))
            ids[:] = [lit_ids[s] for s in code.lits]
            out = predicate_eval_batch(prog.steps, prog.lit, prog.result,
                                       *stage.upload(), slots=prog.slots)
            return stage.download(out)[0]


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


def _is_simple(expr: tuple) -> bool:
    return expr[0] in ("lit", "var")


def _batch_len(cols) -> int:
    return next(iter(cols.values())).shape[0]


# ===================================================================
# One rule's WHERE as a register program (K6)
#
# `lower_predicate` flattens a PredicateProgram's tree in post-order
# into steps that one thread per message walks
# (``ops/csrc/predicate_kernels.cu``; the plain version is
# `ops.match_kernel.predicate_eval_plain`).  The semantics are the JAX
# package's `_eval`'s exactly (the (T, F) algebra above; the tests hold
# them bit for bit) — not K4's `lower_where`, whose var = var equality
# holds for null = null.  Registers are allocated in Sethi-Ullman order (the
# child that needs more registers first), so a tree of n nodes needs
# about log2(n) of them.  A step is ``(op, dst, a, b, c, d, flags, 0)``
# with a float64 literal beside it:
#
#   numeric registers (value, defined):
#     P_NLOAD  a = var lane            P_NLIT  the literal
#     P_NNEG   a = reg                 P_NADD..P_NMOD  a, b = regs
#   boolean registers (T, F):
#     P_BLIT   a = 0/1                 P_BNOT  a = reg
#     P_BAND / P_BOR  a, b = regs      P_CGT..P_CLE  a, b = num regs
#     P_EQN    a, b = num regs; c, d = the var lanes of simple var sides
#              (-1: not a var; both set: the id lanes match too);
#              flags = negate | left compound << 1 | right compound << 2
#     P_EQS    a = var lane, b = string-literal index; flags = negate
#
# ``IN`` unrolls as the reference's `_eval` does: one equality per
# item, folded with the ``or`` algebra.
# ===================================================================

P_NLOAD = 1
P_NLIT = 2
P_NNEG = 3
P_NADD = 4
P_NSUB = 5
P_NMUL = 6
P_NDIV = 7
P_NIDV = 8
P_NMOD = 9
P_BLIT = 10
P_BNOT = 11
P_BAND = 12
P_BOR = 13
P_CGT = 14
P_CLT = 15
P_CGE = 16
P_CLE = 17
P_EQN = 18
P_EQS = 19
PRED_REGS = 16  # the kernel's per-thread register file

_P_ARITH = {"+": P_NADD, "-": P_NSUB, "*": P_NMUL, "/": P_NDIV,
            "div": P_NIDV, "mod": P_NMOD}
_P_ORDER = {">": P_CGT, "<": P_CLT, ">=": P_CGE, "<=": P_CLE}


def numeric_slots(steps: np.ndarray) -> int:
    """How many numeric registers a program names: one past the highest
    register a numeric step writes or a step reads as a number (0 when
    there is none).  The kernel holds that many doubles a message."""
    op = steps[:, 0]
    reads_a = (op == P_NNEG) | ((op >= P_NADD) & (op <= P_NMOD)) | (
        (op >= P_CGT) & (op <= P_EQN))
    reads_b = reads_a & (op != P_NNEG)
    regs = np.concatenate([steps[(op >= P_NLOAD) & (op <= P_NMOD), 1],
                           steps[reads_a, 2], steps[reads_b, 3]])
    return int(regs.max()) + 1 if regs.size else 0


class PredicateCode(NamedTuple):
    steps: np.ndarray  # [S, 8] int32: op, dst, a, b, c, d, flags, 0
    lit: np.ndarray  # [S] float64 numeric literals
    result: int  # register holding the WHERE's (T, F)
    names: Tuple[str, ...]  # var lanes: "/".join(path), var_paths order
    lits: Tuple[str, ...]  # string literals, sorted


def _in_chain(expr: tuple) -> tuple:
    """``x IN (e1, e2, ...)`` as the reference's `_eval` computes it:
    ``((x = e1) or (x = e2)) or ...``."""
    acc = ("op", "=", expr[1], expr[2][0])
    for e in expr[2][1:]:
        acc = ("op", "or", acc, ("op", "=", expr[1], e))
    return acc


def _su(nl: int, nr: int) -> int:
    return max(nl, nr) if nl != nr else nl + 1


def _need_num(expr: tuple) -> int:
    if expr[0] == "neg":
        return _need_num(expr[1])
    if expr[0] == "op":
        return _su(_need_num(expr[2]), _need_num(expr[3]))
    return 1


def _is_str_lit(expr: tuple) -> bool:
    return expr[0] == "lit" and isinstance(expr[1], str)


def _need_bool(expr: tuple) -> int:
    kind = expr[0]
    if kind == "not":
        return _need_bool(expr[1])
    if kind == "in":
        return _need_bool(_in_chain(expr))
    if kind == "op" and expr[1] in ("and", "or"):
        return _su(_need_bool(expr[2]), _need_bool(expr[3]))
    if kind == "op" and not (_is_str_lit(expr[2]) or _is_str_lit(expr[3])):
        return _su(_need_num(expr[2]), _need_num(expr[3]))
    return 1


class _PredLowering:
    def __init__(self, names: Tuple[str, ...], lits: Tuple[str, ...]):
        self.names = names
        self.lits = lits
        self.steps: List[Tuple[int, ...]] = []
        self.lit: List[float] = []

    def emit(self, op, dst, a=-1, b=-1, c=-1, d=-1, flags=0, lit=0.0):
        if dst >= PRED_REGS:  # operands were an earlier step's dst
            raise ValueError(
                f"WHERE needs more than {PRED_REGS} registers")
        self.steps.append((op, dst, a, b, c, d, flags, 0))
        self.lit.append(float(lit))

    def lane(self, path, kind: str) -> int:
        # looked up by name, as the reference looks up cols[kind + name]
        name = "/".join(path)
        if name not in self.names:
            raise KeyError(kind + name)
        return self.names.index(name)

    def pair(self, x, y, r, lower, need):
        """Lower x and y into two registers from r on, the one that
        needs more registers first; returns (x's register, y's)."""
        if need(x) >= need(y):
            lower(x, r)
            lower(y, r + 1)
            return r, r + 1
        lower(y, r)
        lower(x, r + 1)
        return r + 1, r

    def bool_(self, expr: tuple, r: int) -> None:
        kind = expr[0]
        if kind == "op" and expr[1] in ("and", "or"):
            a, b = self.pair(expr[2], expr[3], r, self.bool_, _need_bool)
            self.emit(P_BAND if expr[1] == "and" else P_BOR, r, a, b)
        elif kind == "not":
            self.bool_(expr[1], r)
            self.emit(P_BNOT, r, r)
        elif kind == "lit":  # bool literal (validated)
            self.emit(P_BLIT, r, 1 if expr[1] else 0)
        elif kind == "in":
            self.bool_(_in_chain(expr), r)
        elif kind == "op":
            self.cmp(expr, r)
        else:
            raise AssertionError(
                f"non-boolean node at boolean position: {kind}")

    def cmp(self, expr: tuple, r: int) -> None:
        sym, le, re_ = expr[1], expr[2], expr[3]
        if _is_str_lit(le) or _is_str_lit(re_):
            lit, var = (le, re_) if _is_str_lit(le) else (re_, le)
            self.emit(P_EQS, r, self.lane(var[1], "s:"),
                      self.lits.index(lit[1]),
                      flags=1 if sym == "!=" else 0)
            return
        a, b = self.pair(le, re_, r, self.num, _need_num)
        if sym in ("=", "!="):
            c = self.lane(le[1], "e:") if le[0] == "var" else -1
            d = self.lane(re_[1], "e:") if re_[0] == "var" else -1
            flags = ((1 if sym == "!=" else 0)
                     | (0 if _is_simple(le) else 2)
                     | (0 if _is_simple(re_) else 4))
            self.emit(P_EQN, r, a, b, c, d, flags)
        else:
            self.emit(_P_ORDER[sym], r, a, b)

    def num(self, expr: tuple, r: int) -> None:
        kind = expr[0]
        if kind == "lit":
            self.emit(P_NLIT, r, lit=float(expr[1]))
        elif kind == "var":
            self.emit(P_NLOAD, r, self.lane(expr[1], "n:"))
        elif kind == "neg":
            self.num(expr[1], r)
            self.emit(P_NNEG, r, r)
        elif kind == "op":
            a, b = self.pair(expr[2], expr[3], r, self.num, _need_num)
            self.emit(_P_ARITH[expr[1]], r, a, b)
        else:
            raise AssertionError(f"bad numeric node {kind}")


def lower_predicate(where: tuple,
                    var_paths: Sequence[Tuple[str, ...]]) -> PredicateCode:
    """One compiled WHERE (`compile_where`'s tree and var paths) as K6's
    register program; the result is register 0."""
    lits: Set[str] = set()
    _string_literals(where, lits)
    low = _PredLowering(tuple("/".join(p) for p in var_paths),
                        tuple(sorted(lits)))
    low.bool_(where, 0)
    return PredicateCode(
        steps=np.array(low.steps, np.int32).reshape(-1, 8),
        lit=np.array(low.lit, np.float64),
        result=0, names=low.names, lits=low.lits,
    )


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
