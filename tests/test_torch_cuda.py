"""On a card: each hand-written kernel against its plain PyTorch
version on the same inputs, exactly (all outputs are integers or
booleans).  Skipped without CUDA; this file imports only the port, so
it runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import random

import numpy as np
import pytest
import torch

from emqx_tpu_torch.engine import MatchEngine
from emqx_tpu_torch.ops import match_kernel as mk
from emqx_tpu_torch.ops.automaton import build_automaton
from emqx_tpu_torch.ops.dictionary import TokenDict, encode_topics
from emqx_tpu_torch.ops.trie_host import HostTrie

WORDS = ["a", "b", "c", "", "dev", "$SYS", "x"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _world(seed, n_filters=400, n_topics=300):
    rng = random.Random(seed)
    filters = []
    for fid in range(n_filters):
        depth = rng.randint(1, 6)
        ws = []
        for i in range(depth):
            r = rng.random()
            if r < 0.2:
                ws.append("+")
            elif r < 0.3 and i == depth - 1:
                ws.append("#")
            else:
                ws.append(rng.choice(WORDS))
        filters.append((fid, tuple(ws)))
    topics = [tuple(rng.choice(WORDS) for _ in range(rng.randint(0, 7)))
              for _ in range(n_topics)]
    return filters, topics


@pytest.mark.cuda
@pytest.mark.parametrize("f_width,m_cap,c_cap", [(8, 64, 1024), (2, 4, 64),
                                                 (16, 128, 37)])
def test_match_kernels_equal_plain(cuda, f_width, m_cap, c_cap):
    filters, topics = _world(f_width)
    td = TokenDict()
    aut = build_automaton(filters, td, max_levels=8)
    tok, ln, dol = encode_topics(td, topics, aut.kernel_levels)
    cpu = [torch.from_numpy(a) for a in (aut.fp_rows, aut.node_rows, tok,
                                         ln, dol)]
    gpu = [t.to(cuda) for t in cpu]
    for fn, extra in ((mk.match_batch, {}),
                      (mk.match_batch_compact, {"c_cap": c_cap})):
        want = fn(cpu[0], cpu[1], aut.salt, *cpu[2:], f_width=f_width,
                  m_cap=m_cap, **extra)
        got = fn(gpu[0], gpu[1], aut.salt, *gpu[2:], f_width=f_width,
                 m_cap=m_cap, **extra)
        plain = (mk.match_batch_plain if fn is mk.match_batch
                 else mk.match_batch_compact_plain)(
            gpu[0], gpu[1], aut.salt, *gpu[2:], f_width=f_width,
            m_cap=m_cap, **extra)
        torch.cuda.synchronize()
        for w, g, p in zip(want, got, plain):
            assert g.device.type == "cuda" and g.dtype == w.dtype
            assert torch.equal(w, g.cpu())
            assert torch.equal(w, p.cpu())


@pytest.mark.cuda
def test_decide_kernel_equals_plain(cuda):
    rng = np.random.default_rng(7)
    for _ in range(20):
        r, n, b = 64, int(rng.integers(1, 5000)), int(rng.integers(1, 40))
        case = (
            rng.integers(0, 3, r).astype(np.int8), rng.random(r) < 0.3,
            rng.random(r) < 0.4, rng.random(r) < 0.2,
            rng.integers(0, r, n).astype(np.int32),
            rng.integers(0, 100, n).astype(np.int32),
            rng.integers(0, b, n).astype(np.int32),
            rng.integers(0, 3, b).astype(np.int8), rng.random(b) < 0.5,
            rng.integers(-1, 100, b).astype(np.int32),
        )
        cpu = [torch.from_numpy(c) for c in case]
        want = mk.decide_batch(*cpu)
        got = mk.decide_batch(*(c.to(cuda) for c in cpu))
        assert torch.equal(want, got.cpu())
    with pytest.raises(IndexError):
        bad = [c.to(cuda) for c in cpu]
        bad[4][0] = 64
        mk.decide_batch(*bad)


@pytest.mark.cuda
def test_engine_on_card_equals_host_trie(cuda):
    filters, topics = _world(3, 2000, 1000)
    eng = MatchEngine(max_levels=8, f_width=8, m_cap=64)
    trie = HostTrie()
    filters = [(fid, ws) for fid, ws in filters if "/".join(ws)]
    for fid, ws in filters:
        eng.insert("/".join(ws), fid)
        if "+" in ws or "#" in ws:
            trie.insert("/".join(ws), fid)
    eng.rebuild()
    mk.reset_launches()
    names = ["/".join(t) for t in topics if t]
    got = eng.match_batch(names)
    exact = {}
    for fid, ws in filters:
        if "+" not in ws and "#" not in ws:
            exact.setdefault("/".join(ws), set()).add(fid)
    for t, g in zip(names, got):
        assert g == trie.match(t) | exact.get(t, set()), t
    assert mk.match_batch_compact.launches >= 1


# ------------------------------------------------------- rules (K4)

RULE_CORPUS = [
    "payload.a > 2", "payload.a >= payload.b", "payload.a = 3",
    "payload.s = 'x'", "payload.s != 'nowhere'", "payload.s IN ('x', 'q')",
    "qos IN (1, 2)", "retain != 1", "is_null(payload.a)",
    "is_not_null(payload.s) AND payload.s != 'z'",
    "NOT (payload.a > 0) AND payload.b <= 2", "payload.m = payload.n",
    "payload.s > payload.s2", "topic >= clientid",
    "payload.a = 1 OR payload.missing > 1", "payload.obj = payload.obj2",
    "payload.a + 1 >= payload.b * 2", "payload.a div payload.b = 1",
    "payload.a mod 3 = 0", "payload.a / payload.b > 1",
    "payload.a - 0.5 < payload.b", "-payload.a > 1",
    "payload.a * payload.b + payload.c = 0", "payload.a + 1 = payload.b * 2",
    "1 + 1 = 2", "true",
]
TRAP_PAYLOADS = [
    # FMA contraction: numpy rounds ta - q*safe and a*b + c twice
    b'{"a": 2633996730456453632}',
    b'{"a": 9385959.583563903, "b": 2834748.6238531545,'
    b' "c": -26606836013049.1}',
    # division by zero, by a missing (NaN) value, infinities
    b'{"a": 4, "b": 0}', b'{"a": 4}', b'{"a": Infinity, "b": Infinity}',
    b'{"m": null}', b'{"m": "x", "n": "x"}', b'{"s": "x", "s2": 3}',
    b'{"obj": {"k": 1}, "obj2": {"k": 1}}', b"not json",
    b'{"a": 16777217, "b": 0.5, "s": "q"}', b'{"a": 1752000000123}',
]


def _rules_window(seed, n_rules, n_msgs):
    from emqx_tpu_torch.message import Message
    from emqx_tpu_torch.rules.columns import WindowColumns
    from emqx_tpu_torch.rules.predicate import build_stack
    from emqx_tpu_torch.rules.sql import parse_sql

    rng = random.Random(seed)
    stack = build_stack([
        (str(i), parse_sql('SELECT * FROM "t" WHERE '
                           + rng.choice(RULE_CORPUS)).where)
        for i in range(n_rules)
    ] + [(f"t{i}", parse_sql(f'SELECT * FROM "t" WHERE {p}').where)
         for i, p in enumerate(RULE_CORPUS)])
    msgs = [Message(topic=rng.choice(["t/1", "t/2", "c1"]), payload=p,
                    qos=rng.randint(0, 2), retain=bool(k % 2),
                    from_client=rng.choice(["c1", "t/1"]))
            for k, p in enumerate(TRAP_PAYLOADS + [
                b'{"a": %d, "b": %d, "s": "%s"}' % (
                    rng.randint(-5, 5), rng.randint(0, 3),
                    rng.choice("xyzq").encode())
                for _ in range(n_msgs)])]
    return stack, WindowColumns(msgs, stack.paths, stack.lit_strings)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rules,n_msgs", [(40, 100), (300, 700)])
def test_rules_kernel_equals_plain(cuda, n_rules, n_msgs):
    from emqx_tpu_torch.state import (
        columns_from_reference, rules_program_from_reference,
    )

    stack, cols = _rules_window(n_rules, n_rules, n_msgs)
    out = {}
    for dev in ("cpu", cuda):
        p = rules_program_from_reference(
            stack.code, stack.a0, stack.a1, stack.a2, stack.a3, stack.litn,
            stack.last, dev)
        c = columns_from_reference(cols.num, cols.sid, cols.err, cols.prs,
                                   cols.lit_ranks, dev)
        args = (p.code, p.a0, p.a1, p.a2, p.a3, p.litn, c.lit_ranks, p.last,
                c.num, c.sid, c.err, c.prs)
        out[str(dev)] = mk.rules_eval_batch(*args)
        if dev == cuda:
            out["plain"] = mk.rules_eval_plain(*args)
    torch.cuda.synchronize()
    got = out[str(cuda)]
    assert got.dtype == torch.bool and got.device.type == "cuda"
    assert torch.equal(out["cpu"], got.cpu())
    assert torch.equal(out["plain"], got)
    # the FMA rows: payload 0 passes "a mod 3 = 0", payload 1 passes
    # "a * b + c = 0", exactly as numpy computes them
    row = stack.row_of
    assert bool(got[row[f"t{RULE_CORPUS.index('payload.a mod 3 = 0')}"], 0])
    fma = RULE_CORPUS.index("payload.a * payload.b + payload.c = 0")
    assert bool(got[row[f"t{fma}"], 1])


@pytest.mark.cuda
def test_rules_kernel_empty_planes_and_literals(cuda):
    from emqx_tpu_torch.message import Message
    from emqx_tpu_torch.rules.columns import WindowColumns
    from emqx_tpu_torch.rules.evaluator import RulesEvaluator
    from emqx_tpu_torch.rules.predicate import build_stack
    from emqx_tpu_torch.rules.sql import parse_sql

    stack = build_stack([(str(i), parse_sql(
        f'SELECT * FROM "t" WHERE {p}').where) for i, p in enumerate(
            ["true", "1 + 1 = 2", "2 > 3"])])
    cols = WindowColumns([Message(topic="t")] * 3, stack.paths,
                         stack.lit_strings)
    mat, path = RulesEvaluator().eval_window(stack, 1, cols)
    assert path == "dev" and mat.tolist() == [[True] * 3] * 2 + [[False] * 3]


@pytest.mark.cuda
def test_rules_broker_on_card_equals_scalar_referee(cuda):
    from emqx_tpu_torch.broker.broker import Broker
    from emqx_tpu_torch.message import Message
    from emqx_tpu_torch.rules.engine import FunctionAction

    rng = random.Random(5)
    # the interpreter raises ZeroDivisionError (out of eval_where) on
    # div by a value in (-1, 1), so the referee's registry has no
    # "a div b"
    rules = [(f"r{i}", f'SELECT * FROM "t/#" WHERE {p}')
             for i, p in enumerate(RULE_CORPUS) if " div " not in p] + [
        ("rx", "SELECT * FROM \"t/#\" WHERE regex_match(payload.s, 'x')")]
    # the interpreter raises OverflowError (out of eval_where) on
    # div/mod of an infinity, and takes mod of integers past 2**53
    # exactly where the float64 lanes cannot: the referee's windows
    # carry neither
    finite = [p for p in TRAP_PAYLOADS
              if b"Infinity" not in p and b"2633996730456453632" not in p]
    wins = [[(f"t/{rng.randint(0, 3)}", rng.choice(finite))
             for _ in range(rng.randint(1, 30))] for _ in range(6)]
    out = []
    for scalar in (False, True):
        b = Broker()
        b.rules.eval_force = "scalar" if scalar else None
        fired = []
        for rid, sql in rules:
            b.rules.add_rule(rid, sql, actions=[FunctionAction(
                lambda s, m, rid=rid: fired.append((rid, m.payload)))])
        mk.reset_launches()
        for k, w in enumerate(wins):
            if k == 3:  # churn: the device program re-keys on rules_rev
                b.rules.enable_rule("r0", False)
            b.publish_many([Message(topic=t, payload=p, mid=bytes(16),
                                    timestamp=1.0) for t, p in w])
        out.append((fired, {r: (x.matched, x.passed, x.failed)
                            for r, x in b.rules.rules.items()}))
        if not scalar:
            assert mk.rules_eval_batch.launches == len(wins)
            ev = b.router.engine.rules_evaluator
            assert ev._prog[0] == b.rules.rules_rev
    assert out[0] == out[1]
