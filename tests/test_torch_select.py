"""The port's batched SELECT lane against the JAX package's.

`compile_select`'s covered and rejected nodes, `build_select_stack`'s
appended paths, `materialize_rows` over seeded windows (each package
through its own `WindowColumns(keep_values=True)`), `render_rows`
against per-row `render`, the rules kernel's WHERE-prefix upload (the
matrix is the same with SELECT-only planes appended) and the SELECT
lane's cost gate and `stats()` fields.

Values compare TYPED (``_typed``): ``5`` and ``5.0``, ``True`` and
``1`` differ, so "equal" here is bit for bit through `json.dumps`.
"""

import json
import random

import numpy as np
import pytest

from emqx_tpu.message import Message as RefMessage
from emqx_tpu.rules import columns as ref_columns
from emqx_tpu.rules import engine as ref_engine
from emqx_tpu.rules import predicate as ref_predicate
from emqx_tpu.rules import runtime as ref_runtime
from emqx_tpu.rules import select as ref_select
from emqx_tpu.rules.sql import parse_sql as ref_parse

from emqx_tpu_torch.message import Message
from emqx_tpu_torch.rules import evaluator as port_evaluator
from emqx_tpu_torch.rules import runtime as port_runtime
from emqx_tpu_torch.rules import select as port_select
from emqx_tpu_torch.rules.columns import WindowColumns
from emqx_tpu_torch.rules.engine import RuleEngine
from emqx_tpu_torch.rules.evaluator import RulesEvaluator
from emqx_tpu_torch.rules.predicate import build_stack
from emqx_tpu_torch.rules.sql import parse_sql


def _typed(v):
    """A value with its types spelled out, recursively (NaN equal to
    itself)."""
    if isinstance(v, dict):
        return ("dict", tuple((k, _typed(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, tuple(_typed(x) for x in v))
    if isinstance(v, float) and v != v:
        return ("float", "nan")
    return (type(v).__name__, v)


# ----------------------------------------------------- the compiler

_LOWERED = [
    'SELECT * FROM "t/#"',
    'SELECT payload.a AS a, topic FROM "t/#"',
    "SELECT payload.a + 1 AS b, 'k' AS lit FROM \"t/#\"",
    'SELECT payload.a * 2 + payload.b AS c FROM "t/#"',
    'SELECT payload.a div 2 AS d, payload.a mod 2 AS e FROM "t/#"',
    'SELECT -payload.a AS n FROM "t/#"',
    'SELECT payload.a / payload.b AS q, 7 AS seven, *, qos FROM "t/#"',
]
_DEGRADED = [
    'SELECT lower(payload.s) AS l FROM "t/#"',
    "SELECT CASE WHEN qos = 0 THEN 1 ELSE 2 END AS c FROM \"t/#\"",
    'SELECT payload.a > 1 AS cmp FROM "t/#"',
    "SELECT schema_decode('s', payload) AS d FROM \"t/#\"",
    'SELECT payload.a AS a, NOT retain AS nr FROM "t/#"',
]


def _shape(prog):
    """A SelectProgram's fields without its closures."""
    return ([(k, n, a if k != "expr" else "fn") for k, n, a in prog.fields],
            prog.paths, prog.has_expr)


@pytest.mark.parametrize("sql", _LOWERED + _DEGRADED)
def test_compile_select_covers_and_rejects_like_reference(sql):
    got = port_select.compile_select(parse_sql(sql))
    want = ref_select.compile_select(ref_parse(sql))
    assert (got is None) == (want is None)
    assert (got is None) == (sql in _DEGRADED)
    if got is not None:
        assert _shape(got) == _shape(want)


def test_select_stack_appends_paths_after_where_paths():
    rules = [(f"r{i}", sql) for i, sql in enumerate(_LOWERED + _DEGRADED)]
    rules.append(("w", 'SELECT payload.a AS a, qos FROM "t/#" '
                       "WHERE payload.w > 1 AND qos = 1"))
    stack = build_stack([(rid, parse_sql(q).where) for rid, q in rules])
    ref_stack = ref_predicate.build_stack(
        [(rid, ref_parse(q).where) for rid, q in rules])
    assert stack.paths == ref_stack.paths
    got = port_select.build_select_stack(
        [(rid, parse_sql(q)) for rid, q in rules], stack.paths)
    want = ref_select.build_select_stack(
        [(rid, ref_parse(q)) for rid, q in rules], ref_stack.paths)
    # the WHERE paths keep their plane indices; SELECT paths append
    assert got.all_paths[:len(stack.paths)] == tuple(stack.paths)
    assert got.all_paths == want.all_paths
    assert got.planes == want.planes
    assert got.n_lowered == want.n_lowered == len(_LOWERED) + 1
    assert sorted(got.progs) == sorted(want.progs)
    for rid in got.progs:
        assert _shape(got.progs[rid]) == _shape(want.progs[rid])
    # `qos` of rule "w" reuses the WHERE plane
    slot = got.progs["w"].paths.index(("qos",))
    assert got.planes["w"][slot] == stack.paths.index(("qos",))


# ----------------------------------------------- materialize_rows

_SELECTS = [
    "*",
    "payload.a AS a, topic",
    "payload.a + payload.b AS s, payload.a * 2 AS d, 'k' AS lit",
    "payload.s + '!' AS cat, clientid",
    "payload.a / payload.b AS q, payload.a mod 2 AS m",
    "payload.a div payload.b AS dv, -payload.a AS neg",
    "payload.obj AS o, payload.a AS a, payload.obj.k AS ok",
    "payload.a AS x, payload.b AS x",  # duplicate alias
    "payload.a + payload.nope AS mn, 7 AS seven, qos, retain",
    "payload.a - 0.5 AS h, username, payload",
]
_WHERES = ["payload.a >= 0", "payload.s = 'x' OR payload.b > 1",
           "qos >= 0", "topic = 't/1/x'"]


def _rand_body(rng):
    p = {}
    if rng.random() < 0.85:
        p["a"] = (rng.randint(-5, 5) if rng.random() < 0.7
                  else round(rng.uniform(-5, 5), 2))
    if rng.random() < 0.7:
        p["b"] = rng.randint(0, 3)
    if rng.random() < 0.6:
        p["s"] = rng.choice(["x", "y", "zz"])
    if rng.random() < 0.3:
        p["obj"] = rng.choice([{"k": 1}, [1, 2], {"k": {"d": True}}, "str"])
    if rng.random() < 0.1:
        p["a"] = rng.choice([True, None, "5", [1]])
    body = json.dumps(p).encode()
    if rng.random() < 0.08:
        body = rng.choice([b"not json {", b"[1, 2]", b"3"])
    return body


def _window(rng, n):
    return [dict(topic=rng.choice(["t/1/x", "t/2/x", "t/2/y"]),
                 payload=_rand_body(rng), qos=rng.randint(0, 2),
                 retain=bool(rng.getrandbits(1)),
                 from_client=rng.choice(["c1", "c2"]),
                 from_username=rng.choice([None, "u"]),
                 mid=k.to_bytes(16, "big"), timestamp=1.7e9 + k)
            for k in range(n)]


@pytest.mark.parametrize("seed", [1, 5, 9, 13, 21])
def test_materialize_rows_equals_reference_and_eval_select(seed):
    rng = random.Random(seed)
    rules = [(f"r{i}", f"SELECT {s} FROM \"t/#\" WHERE {rng.choice(_WHERES)}")
             for i, s in enumerate(_SELECTS)]
    stack = build_stack([(rid, parse_sql(q).where) for rid, q in rules])
    ref_stack = ref_predicate.build_stack(
        [(rid, ref_parse(q).where) for rid, q in rules])
    sel = port_select.build_select_stack(
        [(rid, parse_sql(q)) for rid, q in rules], stack.paths)
    ref_sel = ref_select.build_select_stack(
        [(rid, ref_parse(q)) for rid, q in rules], ref_stack.paths)
    assert sel.n_lowered == len(rules)
    for _ in range(4):
        win = _window(rng, rng.randint(1, 24))
        msgs = [Message(**m) for m in win]
        ref_msgs = [RefMessage(**m) for m in win]
        cols = WindowColumns(msgs, sel.all_paths, stack.lit_strings,
                             keep_values=True)
        ref_cols = ref_columns.WindowColumns(
            ref_msgs, ref_sel.all_paths, ref_stack.lit_strings,
            keep_values=True)
        for a in ("num", "sid", "err", "prs", "lit_ranks"):
            assert np.array_equal(getattr(cols, a), getattr(ref_cols, a),
                                  equal_nan=a == "num"), a
        assert _typed(cols.vals) == _typed(ref_cols.vals)
        for rid, q in rules:
            rows = sorted(rng.sample(range(len(msgs)),
                                     rng.randint(0, len(msgs))))
            names, vals = port_select.materialize_rows(
                sel.progs[rid], sel.planes[rid], cols, rows)
            rnames, rvals = ref_select.materialize_rows(
                ref_sel.progs[rid], ref_sel.planes[rid], ref_cols, rows)
            assert names == rnames
            assert _typed(vals) == _typed(rvals)
            # the batched row equals the interpreter's SELECT output
            parsed = parse_sql(q)
            for k, i in enumerate(rows):
                row = dict(zip(names, (c[k] for c in vals)))
                want = port_runtime.eval_select(
                    parsed, port_runtime.build_env(msgs[i]))
                assert _typed(row) == _typed(want), (q, i)
                assert _typed(want) == _typed(ref_runtime.eval_select(
                    ref_parse(q), ref_runtime.build_env(ref_msgs[i])))


# --------------------------------------------------- render_rows

_VALUES = [0, 1, -3, 2.5, 4.0, True, False, None, "", "x", "a%sb",
           "100% done", b"raw\xffbytes", {"k": 1, "j": [1, "s"]}, [1, 2.5]]
_KEYS = ["a", "b", "payload", "topic", "v"]


def _rand_template(rng):
    parts = []
    for _ in range(rng.randint(0, 6)):
        if rng.random() < 0.45:
            parts.append(rng.choice(["lit ", "x%sy", "100%", "{", "}", "$",
                                     "${", "a.b ", ""]))
        else:
            parts.append("${" + ".".join(
                rng.choice(_KEYS) for _ in range(rng.randint(1, 3))) + "}")
    return "".join(parts)


def _rand_row(rng, depth=0):
    d = {}
    for k in _KEYS:
        if rng.random() < 0.6:
            if depth < 2 and rng.random() < 0.3:
                d[k] = _rand_row(rng, depth + 1)
            else:
                v = rng.choice(_VALUES)
                d[k] = "b" if depth and isinstance(v, bytes) else v
    return d


@pytest.mark.parametrize("seed", [5, 17, 23])
def test_render_rows_equals_per_row_render_and_reference(seed):
    rng = random.Random(seed)
    for _ in range(150):
        tmpl = _rand_template(rng)
        prog = port_select.TemplateProgram(tmpl)
        ref_prog = ref_select.TemplateProgram(tmpl)
        assert prog._fmt == ref_prog._fmt
        rows = [_rand_row(rng) for _ in range(rng.randint(1, 7))]
        heads = {p[0] for p in prog.parts if p.__class__ is not str}
        cols = {h: [r.get(h) for r in rows] for h in heads
                if any(h in r for r in rows)}
        got = prog.render_rows(cols, len(rows))
        twin = [{h: c[i] for h, c in cols.items()} for i in range(len(rows))]
        assert got == [prog.render(t) for t in twin], tmpl
        assert got == ref_prog.render_rows(cols, len(rows)), tmpl


# ------------------------------------- the rules kernel's WHERE prefix

_K4_RULES = [
    "payload.a > 2", "payload.s = 'x'", "payload.s IN ('x', 'zz')",
    "topic > clientid", "payload.a + 1 >= payload.b * 2",
    "payload.obj = payload.obj2", "payload.s > payload.s2",
]


@pytest.mark.parametrize("seed", [2, 3])
def test_select_planes_leave_the_where_matrix_equal(seed, monkeypatch):
    """With keep_values and the SELECT-only paths appended (among them
    string fields that shift the window's string ranks), K4's plain
    version gives the same matrix, and the evaluator hands it only the
    WHERE prefix of the planes."""
    rng = random.Random(seed)
    rules = [(f"r{i}", f'SELECT *, payload.t AS t, payload.u AS u FROM "t/#" '
                       f"WHERE {w}") for i, w in enumerate(_K4_RULES)]
    stack = build_stack([(rid, parse_sql(q).where) for rid, q in rules])
    assert stack.n_lowered == len(rules)
    sel = port_select.build_select_stack(
        [(rid, parse_sql(q)) for rid, q in rules], stack.paths)
    assert len(sel.all_paths) > len(stack.paths)
    win = _window(rng, 40)
    for k, m in enumerate(win):
        body = json.loads(m["payload"]) if m["payload"][:1] == b"{" else {}
        body["t"] = rng.choice(["aaa", "w", "zzz", "x0"])
        body["u"] = rng.choice(["", "~", 3])
        body["s2"] = rng.choice(["x", "y", "xq"])
        body["obj2"] = rng.choice([{"k": 1}, [1, 2]])
        m["payload"] = json.dumps(body).encode()
    msgs = [Message(**m) for m in win]
    plain = WindowColumns(msgs, stack.paths, stack.lit_strings)
    same = WindowColumns(msgs, stack.paths, stack.lit_strings,
                         keep_values=True)
    wide = WindowColumns(msgs, sel.all_paths, stack.lit_strings,
                         keep_values=True)
    k = len(stack.paths)
    for a in ("num", "sid", "err", "prs", "lit_ranks"):
        assert np.array_equal(getattr(same, a), getattr(plain, a),
                              equal_nan=a == "num"), a
    for a in ("num", "err", "prs"):
        assert np.array_equal(getattr(wide, a)[:k], getattr(plain, a),
                              equal_nan=a == "num"), a
    # the appended strings shift the ranks: the matrix must not move
    assert wide.n_strings > plain.n_strings
    seen = []
    orig = port_evaluator.columns_from_reference

    def spy(num, *rest):
        seen.append(num.shape)
        return orig(num, *rest)

    monkeypatch.setattr(port_evaluator, "columns_from_reference", spy)
    ev = RulesEvaluator("cpu")
    m_plain = ev.eval_window(stack, 1, plain)[0]
    m_wide = ev.eval_window(stack, 1, wide)[0]
    assert seen == [(k, len(msgs))] * 2
    assert np.array_equal(m_plain, m_wide)
    assert m_plain.any() and not m_plain.all()
    ref_stack = ref_predicate.build_stack(
        [(rid, ref_parse(q).where) for rid, q in rules])
    ref_cols = ref_columns.WindowColumns(
        [RefMessage(**m) for m in win], ref_stack.paths,
        ref_stack.lit_strings)
    from emqx_tpu.ops.match_kernel import rules_eval_host

    want = rules_eval_host(
        ref_stack.code, ref_stack.a0, ref_stack.a1, ref_stack.a2,
        ref_stack.a3, ref_stack.litn, ref_cols.lit_ranks, ref_stack.last,
        ref_cols.num, ref_cols.sid, ref_cols.err, ref_cols.prs)
    assert np.array_equal(m_wide, want)


# ------------------------------------------------- the cost gate

_LAPS = (
    [(10, 0, 10e-6)] * 8 + [(0, 10, 100e-6)] * 20 + [(10, 0, 500e-6)] * 10
    + [(5, 5, 1e-3)] * 3 + [(0, 10, 20e-6)] * 4
)


def test_cost_gate_trips_rearms_and_stats_equal_reference():
    """Fixed laps fed to `_sel_lane_account` on both engines: the same
    EWMAs, the breaker trips at the same lap, registry churn re-arms it,
    and the ``select_*`` fields of `stats()` are the reference's."""
    sql = 'SELECT payload.a AS a FROM "t/#" WHERE payload.a > 0'
    port, ref = RuleEngine(device="cpu"), ref_engine.RuleEngine()
    for eng in (port, ref):
        eng.add_rule("r1", sql)
    trips = []
    for rows_b, rows_s, dt in _LAPS:
        for eng in (port, ref):
            eng._sel_lane_account(rows_b, rows_s, dt)
        trips.append(port._sel_batch_off)
        assert port._sel_batch_off == ref._sel_batch_off
    first = trips.index(True)  # trips once and stays tripped
    assert first > 0 and all(trips[first:])
    keys = ("select_lowered", "select_batched_rows", "select_scalar_rows",
            "select_ewma_off", "select_batched_us_ewma",
            "select_scalar_us_ewma", "select_batch_disabled",
            "rules", "lowered", "program_rows", "fallback",
            "matrix_windows", "scalar_windows", "fallback_rule_evals")
    st, rst = port.stats(), ref.stats()
    assert {k: st[k] for k in keys} == {k: rst[k] for k in keys}
    assert st["select_ewma_off"] == 1 and st["select_batch_disabled"]
    # select_force pins the lane past the tripped gate ...
    port.select_force = "batched"
    for eng in (port, ref):
        eng.add_rule("r2", sql)  # churn: the next window re-arms
    port.apply_batch([])
    assert port._sel_batch_off  # no window ran, nothing re-armed yet
    port.apply_batch([(Message(topic="t/1", payload=b'{"a": 1}'), ["r1"])])
    assert not port._sel_batch_off
    # ... and a pinned lane never trips the gate
    for rows_b, rows_s, dt in _LAPS:
        port._sel_lane_account(rows_b, rows_s, dt)
    assert not port._sel_batch_off
