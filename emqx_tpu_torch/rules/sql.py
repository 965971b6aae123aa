"""Rule SQL parser: SELECT ... FROM "topic", ... [WHERE ...].

A copy of the JAX package's ``rules/sql.py``.  Covers the core of EMQX's
rule SQL (parsed there by the `rulesql` dep behind
`emqx_rule_sqlparser`, apps/emqx_rule_engine/src/
emqx_rule_sqlparser.erl): select lists with
aliases and nested field paths (``payload.x.y``), arithmetic,
comparison and boolean operators, function calls, IN lists, and
CASE/WHEN.  FOREACH/DO/INCASE (array unrolling) is not implemented.

Hand-written tokenizer + Pratt parser producing a plain-tuple AST:

  ("lit", value)
  ("var", ("payload", "x"))          field path
  ("call", name, [args])
  ("op", symbol, lhs, rhs)           binary
  ("neg", expr) / ("not", expr)
  ("in", expr, [exprs])
  ("case", [(when, then), ...], else_or_None)
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class SqlError(ValueError):
    pass


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<num>\d+\.\d+|\d+)
  | (?P<dq>"(?:[^"\\]|\\.)*")
  | (?P<sq>'(?:[^'\\]|\\.)*')
  | (?P<op><>|!=|>=|<=|=|>|<|\+|-|\*|/|\(|\)|,|\.)
  | (?P<word>[A-Za-z_$][A-Za-z0-9_$]*)
""",
    re.VERBOSE,
)

_KEYWORDS = {
    "select", "from", "where", "as", "and", "or", "not", "in",
    "case", "when", "then", "else", "end", "div", "mod", "true",
    "false", "null", "like",
}


@dataclass
class Token:
    kind: str  # num | str | topic | op | word | kw | end
    value: object
    pos: int


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if m is None:
            raise SqlError(f"bad character at {pos}: {sql[pos:pos+10]!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        if m.lastgroup == "num":
            text = m.group()
            out.append(
                Token("num", float(text) if "." in text else int(text), m.start())
            )
        elif m.lastgroup == "dq":
            # double quotes delimit topics in FROM, or quoted identifiers
            out.append(
                Token("topic", _unescape(m.group()[1:-1]), m.start())
            )
        elif m.lastgroup == "sq":
            out.append(Token("str", _unescape(m.group()[1:-1]), m.start()))
        elif m.lastgroup == "op":
            out.append(Token("op", m.group(), m.start()))
        else:
            word = m.group()
            low = word.lower()
            if low in _KEYWORDS:
                out.append(Token("kw", low, m.start()))
            else:
                out.append(Token("word", word, m.start()))
    out.append(Token("end", None, len(sql)))
    return out


def _unescape(s: str) -> str:
    return s.replace('\\"', '"').replace("\\'", "'").replace("\\\\", "\\")


@dataclass
class SelectField:
    expr: tuple
    alias: Optional[str] = None
    star: bool = False


@dataclass
class ParsedSql:
    fields: List[SelectField]
    froms: List[str]
    where: Optional[tuple] = None


class _Parser:
    def __init__(self, tokens: List[Token]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect_kw(self, kw: str) -> None:
        t = self.next()
        if t.kind != "kw" or t.value != kw:
            raise SqlError(f"expected {kw.upper()} at {t.pos}, got {t.value!r}")

    def accept_op(self, sym: str) -> bool:
        t = self.peek()
        if t.kind == "op" and t.value == sym:
            self.i += 1
            return True
        return False

    def accept_kw(self, kw: str) -> bool:
        t = self.peek()
        if t.kind == "kw" and t.value == kw:
            self.i += 1
            return True
        return False

    # ---------------------------------------------------- statement

    def statement(self) -> ParsedSql:
        self.expect_kw("select")
        fields = [self.select_field()]
        while self.accept_op(","):
            fields.append(self.select_field())
        self.expect_kw("from")
        froms = [self.topic()]
        while self.accept_op(","):
            froms.append(self.topic())
        where = None
        if self.accept_kw("where"):
            where = self.expr()
        t = self.peek()
        if t.kind != "end":
            raise SqlError(f"trailing input at {t.pos}: {t.value!r}")
        return ParsedSql(fields=fields, froms=froms, where=where)

    def select_field(self) -> SelectField:
        if self.accept_op("*"):
            return SelectField(expr=("lit", None), star=True)
        e = self.expr()
        alias = None
        if self.accept_kw("as"):
            t = self.next()
            if t.kind not in ("word", "topic"):
                raise SqlError(f"bad alias at {t.pos}")
            alias = str(t.value)
        return SelectField(expr=e, alias=alias)

    def topic(self) -> str:
        t = self.next()
        if t.kind == "topic" or t.kind == "str":
            return str(t.value)
        raise SqlError(f'expected "topic" at {t.pos}')

    # -------------------------------------------------- expressions

    # precedence climbing: or < and < not < cmp < add < mul < unary
    def expr(self) -> tuple:
        return self.or_expr()

    def or_expr(self) -> tuple:
        lhs = self.and_expr()
        while self.accept_kw("or"):
            lhs = ("op", "or", lhs, self.and_expr())
        return lhs

    def and_expr(self) -> tuple:
        lhs = self.not_expr()
        while self.accept_kw("and"):
            lhs = ("op", "and", lhs, self.not_expr())
        return lhs

    def not_expr(self) -> tuple:
        if self.accept_kw("not"):
            return ("not", self.not_expr())
        return self.cmp_expr()

    def cmp_expr(self) -> tuple:
        lhs = self.add_expr()
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "!=", "<>", ">", "<", ">=", "<="):
            self.i += 1
            sym = "!=" if t.value == "<>" else str(t.value)
            return ("op", sym, lhs, self.add_expr())
        if t.kind == "kw" and t.value == "in":
            self.i += 1
            if not self.accept_op("("):
                raise SqlError(f"expected ( after IN at {self.peek().pos}")
            items = [self.expr()]
            while self.accept_op(","):
                items.append(self.expr())
            if not self.accept_op(")"):
                raise SqlError("unclosed IN list")
            return ("in", lhs, items)
        if t.kind == "kw" and t.value == "like":
            self.i += 1
            pat = self.add_expr()
            return ("call", "like", [lhs, pat])
        return lhs

    def add_expr(self) -> tuple:
        lhs = self.mul_expr()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-"):
                self.i += 1
                lhs = ("op", str(t.value), lhs, self.mul_expr())
            else:
                return lhs

    def mul_expr(self) -> tuple:
        lhs = self.unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/"):
                self.i += 1
                lhs = ("op", str(t.value), lhs, self.unary())
            elif t.kind == "kw" and t.value in ("div", "mod"):
                self.i += 1
                lhs = ("op", str(t.value), lhs, self.unary())
            else:
                return lhs

    def unary(self) -> tuple:
        if self.accept_op("-"):
            return ("neg", self.unary())
        return self.primary()

    def primary(self) -> tuple:
        t = self.next()
        if t.kind == "num" or t.kind == "str":
            return ("lit", t.value)
        if t.kind == "kw":
            if t.value == "true":
                return ("lit", True)
            if t.value == "false":
                return ("lit", False)
            if t.value == "null":
                return ("lit", None)
            if t.value == "case":
                return self.case_expr()
            raise SqlError(f"unexpected keyword {t.value!r} at {t.pos}")
        if t.kind == "op" and t.value == "(":
            e = self.expr()
            if not self.accept_op(")"):
                raise SqlError("unclosed (")
            return e
        if t.kind in ("word", "topic"):
            name = str(t.value)
            if self.accept_op("("):
                args: List[tuple] = []
                if not self.accept_op(")"):
                    args.append(self.expr())
                    while self.accept_op(","):
                        args.append(self.expr())
                    if not self.accept_op(")"):
                        raise SqlError("unclosed call")
                return ("call", name.lower(), args)
            path = [name]
            while self.accept_op("."):
                nt = self.next()
                if nt.kind not in ("word", "topic", "kw"):
                    raise SqlError(f"bad field path at {nt.pos}")
                path.append(str(nt.value))
            return ("var", tuple(path))
        raise SqlError(f"unexpected token {t.value!r} at {t.pos}")

    def case_expr(self) -> tuple:
        whens: List[Tuple[tuple, tuple]] = []
        els: Optional[tuple] = None
        while True:
            if self.accept_kw("when"):
                cond = self.expr()
                self.expect_kw("then")
                whens.append((cond, self.expr()))
            elif self.accept_kw("else"):
                els = self.expr()
            elif self.accept_kw("end"):
                if not whens:
                    raise SqlError("CASE without WHEN")
                return ("case", whens, els)
            else:
                t = self.peek()
                raise SqlError(f"bad CASE at {t.pos}: {t.value!r}")


def parse_sql(sql: str) -> ParsedSql:
    return _Parser(tokenize(sql)).statement()
