"""One rule's WHERE predicate (K6) in the port against the JAX package:
``PredicateProgram.eval_batch(envs, device="cpu")`` (the register
program's plain PyTorch version, through the program's staged upload)
against the reference's ``eval_batch(envs)`` (numpy) and
``eval_batch(envs, use_jax=True)`` (its jit, or its numpy path where
`_f32_safe` refuses the batch), on tests/test_rules.py's predicates,
the error-vs-undefined and compound-equality cases, float32-lossy
values, a WHERE that reads no var, and the programs that reach the
kernel's limits: all 16 numeric registers, an IN list past one staged
chunk of steps, div / mod at infinities and 0.5.  Every output is
boolean: the tolerance is 0."""

import json
import os
import random
import re

import numpy as np
import pytest
import torch

from emqx_tpu.message import Message as RefMessage
from emqx_tpu.rules import predicate as ref_pred
from emqx_tpu.rules import runtime as ref_runtime
from emqx_tpu.rules.sql import parse_sql as ref_parse

from emqx_tpu_torch.message import Message
from emqx_tpu_torch.ops import match_kernel as mk
from emqx_tpu_torch.rules import predicate as P
from emqx_tpu_torch.rules import runtime as port_runtime
from emqx_tpu_torch.rules.sql import parse_sql
from emqx_tpu_torch.state import (
    predicate_columns_from_reference, predicate_program_from_code,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_rules.py _PREDICATES
PREDICATES = [
    "payload.a > 0",
    "payload.a > payload.b",
    "payload.a + 1 >= payload.b * 2",
    "payload.s = 'x'",
    "payload.s != 'y'",
    "qos = 2 AND retain = 1 OR payload.b = 0",
    "NOT (payload.a > 0) AND payload.b <= 2",
    "payload.a = 1 OR payload.missing > 1",
    "payload.missing > 1 OR payload.a = 1",
    "qos IN (1, 2)",
    "payload.s IN ('x', 'q')",
    "payload.a / payload.b > 1",
    "payload.a div 2 = 1",
    "payload.a mod 2 = 0",
    "payload.a - 0.5 < payload.b OR payload.s = 'z' AND qos > 0",
]
# every other opcode and shape: var = var (id lanes), neg, compound
# sides, string literals absent from the batch, IN over mixed items,
# an IN with a string literal on the left, and nested arithmetic deep
# enough to need several registers
EXTRA = [
    "payload.s = payload.s2",
    "payload.a = payload.b",
    "-payload.a > 1",
    "payload.s != qos + 1",
    "payload.missing + 1 != 5",
    "(payload.a + 1) * 2 = payload.b - 3",
    "payload.s = 'nowhere'",
    "payload.x IN (1, 'y', payload.a)",
    "'x' IN (payload.s, payload.s2)",
    "payload.a <= payload.b / 2 AND NOT (payload.s != 'x' OR qos >= 1)",
    "((payload.a + payload.b) * (payload.a - payload.b)) div"
    " ((payload.b + 1) * (payload.a + 2)) >= payload.a mod 3 - 1",
    "payload.a * payload.b + payload.c = 0",
    "payload.a mod 3 = 0",
    "true AND payload.a > 1 OR false",
]
# the staging chunk of predicate_kernels.cu (kChunk steps a pass)
K6_SRC = os.path.join(REPO, "emqx_tpu_torch", "ops", "csrc",
                      "predicate_kernels.cu")
K6_CHUNK = int(re.search(r"kChunk = (\d+);", open(K6_SRC).read()).group(1))
INF_PAYLOADS = [{"a": a, "b": b}
                for a in (float("inf"), float("-inf"), 3, 0.5, -2.5)
                for b in (float("inf"), float("-inf"), 0.5, 2, -0.5)]


def _balanced(depth):
    """A numeric tree over payload.a and payload.b that needs depth + 1
    registers in Sethi-Ullman order (its two halves differ, so both are
    evaluated); subtrees are shared, so building it costs nothing."""
    left, right = ("var", ("payload", "a")), ("var", ("payload", "b"))
    for _ in range(depth):
        left, right = ("op", "+", left, right), ("op", "-", right, left)
    return left


# (name, WHERE tree, payloads): the programs at the kernel's limits
LIMIT_PROGRAMS = {
    # all PRED_REGS numeric registers live (65,537 steps)
    "most_numeric_slots": (("op", ">", _balanced(15), ("lit", 0)), None),
    # an IN list of 70 items: 139 steps, past one staged chunk; no
    # arithmetic and float32-exact values, so the reference's jit runs
    "in_list_past_a_chunk": (parse_sql(
        'SELECT * FROM "t" WHERE payload.a IN (%s)'
        % ", ".join(str(i) for i in range(70))).where,
        [{"a": i} for i in range(-9, 90, 4)]
        + [{"a": "x"}, {}, b"hello", {"a": 2.5}, {"a": None}]),
    # div / mod of an infinity and by 0.5 (truncated to 0: undefined)
    "div_mod_at_infinity_and_half": (parse_sql(
        'SELECT * FROM "t" WHERE payload.a div payload.b > 0 OR '
        'payload.a mod payload.b != 1').where, INF_PAYLOADS),
}
FMA_PAYLOADS = [  # numpy rounds ta - q*safe and a*b + c twice
    {"a": 2633996730456453632},
    {"a": 9385959.583563903, "b": 2834748.6238531545,
     "c": -26606836013049.1},
]


def _rand_payload(rng):
    payload = {}
    if rng.random() < 0.8:
        payload["a"] = (rng.randint(-5, 5) if rng.random() < 0.7
                        else round(rng.uniform(-5, 5), 2))
    if rng.random() < 0.7:
        payload["b"] = rng.randint(0, 3)
    if rng.random() < 0.6:
        payload["s"] = rng.choice(["x", "y", "z", "xq"])
    if rng.random() < 0.5:
        payload["s2"] = rng.choice(["x", "y"])
    if rng.random() < 0.3:
        payload["x"] = rng.choice([1, "y"])
    if rng.random() < 0.2:
        payload["c"] = rng.choice([None, True, 2.5])
    return payload


def _envs(payloads, **kw):
    """The same messages as envs of both packages.  A payload that is
    bytes goes as it is (``b"hello"``: a lookup error)."""
    ref, port = [], []
    for k, p in enumerate(payloads):
        body = p if isinstance(p, bytes) else json.dumps(p).encode()
        m = dict(topic="t/1", payload=body, qos=k % 3, retain=bool(k % 2),
                 from_client="c1", mid=bytes(16), timestamp=1.7e9 + k)
        m.update(kw)
        ref.append(ref_runtime.build_env(RefMessage(**m)))
        port.append(port_runtime.build_env(Message(**m)))
    return ref, port


def _progs(src):
    w = f'SELECT * FROM "t" WHERE {src}'
    ref = ref_pred.compile_where(ref_parse(w).where)
    port = P.compile_where(parse_sql(w).where)
    assert ref is not None and port is not None, src
    return ref, port


def _check(src, renvs, penvs, use_jax=True):
    ref, port = _progs(src)
    want = ref.eval_batch(renvs)
    got = port.eval_batch(penvs, device="cpu")
    assert got.dtype == bool and got.shape == want.shape
    assert np.array_equal(got, want), (src, got, want)
    if use_jax:
        assert np.array_equal(ref.eval_batch(renvs, use_jax=True), want), src
    return got


def test_opcodes_agree_with_the_kernel():
    src = open(K6_SRC).read()
    enum = dict(re.findall(r"\b(P_[A-Z]+) = (\d+),", src))
    names = [n for n in dir(P) if re.fullmatch(r"P_[A-Z]+", n)]
    assert sorted(enum) == sorted(names)
    for n in names:
        assert int(enum[n]) == getattr(P, n), n
    assert re.search(rf"kRegs = {P.PRED_REGS};", src)


@pytest.mark.parametrize("src", PREDICATES + EXTRA)
def test_device_path_equals_reference(src):
    rng = random.Random(len(src))
    renvs, penvs = _envs([_rand_payload(rng) for _ in range(48)]
                         + FMA_PAYLOADS + [b"hello", {"a": None}])
    # the JAX path for these sources: tests/test_rules.py's corpus
    _check(src, renvs, penvs, use_jax=src in PREDICATES)


def test_error_undefined_and_compound_equality():
    renvs, penvs = _envs([b"hello", {"a": 2}, {"x": 1}], qos=1)
    for src in ("payload.x != 1", "payload.x != 'y'",
                "payload.x = 1 OR qos = 1"):
        ref, _ = _progs(src)
        want = [ref_runtime.eval_where(ref.where, e) for e in renvs]
        assert _check(src, renvs, penvs).tolist() == want, src
    renvs, penvs = _envs([{"s": "abc"}], qos=1)
    assert _check("payload.s != qos + 1", renvs, penvs).tolist() == [True]
    assert _check("payload.missing + 1 != 5", renvs,
                  penvs).tolist() == [False]


def test_float32_lossy_values():
    # millisecond timestamps and 2**24 + 1: the JAX package's
    # `_f32_safe` sends these batches to numpy; float64 equals it
    renvs, penvs = _envs([{"a": 16777216, "big": 16777217}] * 2)
    for e, ts in zip(renvs + penvs, [1753000000200, 1753000000000] * 2):
        e["timestamp"] = ts
    assert _check("timestamp > 1753000000100", renvs,
                  penvs).tolist() == [True, False]
    assert _check("payload.a + 1 > 16777216", renvs,
                  penvs).tolist() == [True, True]
    assert _check("payload.big = 16777217", renvs,
                  penvs).tolist() == [True, True]
    assert _check("payload.big - 1 = 16777216 + 0", renvs,
                  penvs).tolist() == [True, True]


def test_fma_payloads():
    renvs, penvs = _envs(FMA_PAYLOADS)
    assert _check("payload.a mod 3 = 0", renvs, penvs,
                  use_jax=False).tolist() == [True, True]
    assert _check("payload.a * payload.b + payload.c = 0", renvs, penvs,
                  use_jax=False).tolist() == [False, True]


@pytest.mark.parametrize("src", ["true", "1 = 1", "not false"])
def test_var_free_where_raises_stop_iteration_like_reference(src):
    renvs, penvs = _envs([{"a": 1}] * 3)
    ref, port = _progs(src)
    for call in (lambda: ref.eval_batch(renvs),
                 lambda: ref.eval_batch(renvs, use_jax=True),
                 lambda: port.eval_batch(penvs, device="cpu")):
        with pytest.raises(StopIteration):
            call()


@pytest.mark.parametrize("name", sorted(LIMIT_PROGRAMS))
def test_limit_programs_equal_reference(name):
    where, payloads = LIMIT_PROGRAMS[name]
    if payloads is None:
        rng = random.Random(len(name))
        payloads = [_rand_payload(rng) for _ in range(12)] + FMA_PAYLOADS
    renvs, penvs = _envs(payloads)
    ref = ref_pred.compile_where(where)
    port = P.compile_where(where)
    want = ref.eval_batch(renvs)
    assert np.array_equal(port.eval_batch(penvs, device="cpu"), want)
    code = port._code
    # the jit path where `_f32_safe` lets it run (arithmetic never)
    assert np.array_equal(ref.eval_batch(renvs, use_jax=True), want)
    assert want.any() and not want.all()
    if name == "most_numeric_slots":
        assert P.numeric_slots(code.steps) == P.PRED_REGS
    elif name == "in_list_past_a_chunk":
        assert len(code.steps) > K6_CHUNK
        assert ref._f32_safe(ref.extract_columns(renvs)[0])


def _numeric_refs(steps):
    """Every register a step uses as a number, walked step by step."""
    out = []
    for op, dst, a, b, *_ in steps.tolist():
        if P.P_NLOAD <= op <= P.P_NMOD:
            out.append(dst)
        if op == P.P_NNEG:
            out.append(a)
        elif P.P_NADD <= op <= P.P_NMOD or P.P_CGT <= op <= P.P_EQN:
            out += [a, b]
    return out


@pytest.mark.parametrize("src", PREDICATES + EXTRA)
def test_numeric_slots_hold_every_numeric_register(src):
    """The kernel instance a program runs on (the smallest of 2, 4, 8
    and 16 numeric registers that holds `numeric_slots`) holds every
    register it reads or writes as a number; the upload carries the
    count."""
    _, port = _progs(src)
    code = P.lower_predicate(port.where, port.var_paths)
    refs = _numeric_refs(code.steps)
    slots = P.numeric_slots(code.steps)
    assert slots == (max(refs) + 1 if refs else 0)
    assert next(n for n in (2, 4, 8, 16) if n >= slots) > max(refs,
                                                               default=-1)
    assert predicate_program_from_code(code, "cpu").slots == slots


def test_staged_wrapper_equals_unstaged():
    """`eval_batch` / `eval_columns` (columns packed into the program's
    stage, one upload) equal the unstaged wrapper (each lane uploaded on
    its own) on the CPU, over batches of changing width, from the
    port's columns and the reference's; columns of another program are
    refused."""
    rng = random.Random(9)
    mk.reset_launches()
    for src in PREDICATES + EXTRA:
        ref, port = _progs(src)
        prog = predicate_program_from_code(
            P.lower_predicate(port.where, port.var_paths), "cpu")
        for n in (40, 7, 40):  # the stage re-lays its views, then reuses
            renvs, penvs = _envs([_rand_payload(rng) for _ in range(n)])
            cols, sdict = port.extract_columns(penvs)
            pc = predicate_columns_from_reference(
                cols, P._literal_ids(port.where, sdict), "cpu")
            unstaged = mk.predicate_eval_batch(
                prog.steps, prog.lit, prog.result, pc.num, pc.sid, pc.err,
                pc.lit_ids, slots=prog.slots).numpy()
            assert np.array_equal(port.eval_batch(penvs, device="cpu"),
                                  unstaged), src
            rcols, rsdict = ref.extract_columns(renvs)
            staged = port.eval_columns(
                rcols, ref_pred._literal_ids(ref.where, rsdict), "cpu")
            assert np.array_equal(staged, unstaged), src
    assert mk.predicate_eval_batch.launches == 0  # plain versions only
    _, a = _progs("payload.a > 0")
    _, b = _progs("payload.b > 0")
    cols, _ = b.extract_columns(_envs([{"a": 1, "b": 1}])[1])
    with pytest.raises(ValueError, match="do not belong"):
        a.eval_columns(cols, {}, "cpu")


def test_reference_columns_through_the_kernel_wrapper():
    """The reference's own `extract_columns` and `_literal_ids`, carried
    by `predicate_columns_from_reference`, through the wrapper."""
    rng = random.Random(8)
    renvs, _ = _envs([_rand_payload(rng) for _ in range(40)])
    mk.reset_launches()
    for src in PREDICATES + EXTRA:
        ref, port = _progs(src)
        cols, sdict = ref.extract_columns(renvs)
        lit_ids = ref_pred._literal_ids(ref.where, sdict)
        pc = predicate_columns_from_reference(cols, lit_ids, "cpu")
        code = P.lower_predicate(port.where, port.var_paths)
        assert (pc.names, pc.lits) == (code.names, code.lits)
        prog = predicate_program_from_code(code, "cpu")
        got = mk.predicate_eval_batch(prog.steps, prog.lit, prog.result,
                                      pc.num, pc.sid, pc.err, pc.lit_ids)
        assert got.dtype == torch.bool
        assert np.array_equal(got.numpy(), ref.eval_batch(renvs)), src
    assert mk.predicate_eval_batch.launches == 0  # plain versions only


def test_lowering_registers_and_checks():
    _, deep = _progs(" AND ".join(f"payload.a{i} > {i}" for i in range(200)))
    code = P.lower_predicate(deep.where, deep.var_paths)
    assert code.steps[:, 1].max() < 4  # left-deep: few registers
    _, bal = _progs(EXTRA[10])
    code = P.lower_predicate(bal.where, bal.var_paths)
    ops = set(code.steps[:, 0].tolist())
    assert {P.P_NADD, P.P_NSUB, P.P_NMUL, P.P_NIDV, P.P_NMOD,
            P.P_CGE} <= ops
    assert code.steps[:, 1].max() < P.PRED_REGS
    bad = code._replace(steps=code.steps.copy())
    bad.steps[0, 1] = P.PRED_REGS
    with pytest.raises(ValueError, match="registers"):
        predicate_program_from_code(bad, "cpu")
    bad = code._replace(steps=code.steps.copy())
    bad.steps[0, 0] = 99
    with pytest.raises(ValueError, match="opcode"):
        predicate_program_from_code(bad, "cpu")
    with pytest.raises(ValueError, match="at least one var"):
        predicate_columns_from_reference({}, {}, "cpu")
    dc = predicate_program_from_code(code, "cpu")
    cols, sdict = bal.extract_columns(_envs([{"a": 1, "b": 2}])[1])
    pc = predicate_columns_from_reference(
        cols, P._literal_ids(bal.where, sdict), "cpu")
    for bad in (-1, P.PRED_REGS + 1):
        with pytest.raises(ValueError, match="slots"):
            mk.predicate_eval_batch(dc.steps, dc.lit, dc.result, pc.num,
                                    pc.sid, pc.err, pc.lit_ids, slots=bad)
