"""The rules x window matrix (K4) of the port against the JAX package.

The same numpy inputs, made from a seed, go through three functions:
the JAX package's numpy twin `rules_eval_host`, its device kernel
`rules_eval_batch` (JAX on the CPU, on float32-safe arithmetic-free
windows only, which is all that kernel is routed), and the port's
`rules_eval_batch` on CPU tensors (its plain PyTorch version).  The
tolerance is exact equality: the outputs are booleans.

Also: the port's `build_stack` arrays and `WindowColumns` planes equal
the JAX package's for the same rules and messages, every one of the 22
opcodes is exercised, and the windows the CUDA kernel must get right
bit for bit (FMA contraction, division by zero and by NaN, NaN lanes,
null = null, the compound-equality flags, string ranks, absent
literals, empty plane and literal spaces, booleans) are pinned here
against the numpy twin; tests/test_torch_cuda.py runs the same cases
on the card.
"""

import json
import os
import random
import re

import numpy as np
import pytest
import torch

from emqx_tpu.message import Message as RefMessage
from emqx_tpu.ops import match_kernel as ref_mk
from emqx_tpu.rules import predicate as ref_pred
from emqx_tpu.rules.columns import WindowColumns as RefColumns
from emqx_tpu.rules.sql import parse_sql as ref_parse

from emqx_tpu_torch.message import Message
from emqx_tpu_torch.ops import match_kernel as mk
from emqx_tpu_torch.rules import predicate as pred
from emqx_tpu_torch.rules.columns import WindowColumns
from emqx_tpu_torch.rules.sql import parse_sql
from emqx_tpu_torch.state import (
    columns_from_reference, rules_program_from_reference,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every opcode, arithmetic included
CORPUS = [
    "payload.a > 2",
    "payload.a >= payload.b",
    "payload.a = 3",
    "payload.s = 'x'",
    "payload.s != 'y'",
    "payload.s IN ('x', 'q')",
    "qos IN (1, 2)",
    "retain != 1",
    "is_null(payload.a)",
    "is_not_null(payload.s) AND payload.s != 'z'",
    "NOT (payload.a > 0) AND payload.b <= 2",
    "payload.missing = payload.gone",
    "payload.s > payload.s2",
    "payload.s <= payload.s2 OR payload.a < payload.b",
    "topic > clientid",
    "payload.a = 1 OR payload.missing > 1",
    "payload.x != 1",
    "payload.obj = payload.obj2",
    "payload.s = 'absent-literal'",
    "payload.a + 1 >= payload.b * 2",
    "payload.a div 2 = 1",
    "payload.a mod 2 = 0",
    "payload.a / payload.b > 1",
    "payload.a - 0.5 < payload.b",
    "-payload.a > 1",
    "payload.a * payload.b + payload.c = 0",
    "payload.a mod 3 != payload.b",
    "payload.a + 1 = payload.b * 2",
    "payload.a + 1 != 2",
    "1 + 1 = 2",
    "true",
    "NOT false",
]
ARITH_FREE = [
    p for p in CORPUS
    if not re.search(r"[-+*/]| div | mod ", p)
]
TOPICS = ["t/1/x", "t/2/x", "s/only", "q/none"]


def _payload(rng, lossy=True):
    p = {}
    if rng.random() < 0.85:
        p["a"] = rng.choice([
            rng.randint(-5, 5), rng.randint(-5, 5) / 4, 0,
            *((round(rng.uniform(-5, 5), 2), 16777217, 1752000000123)
              if lossy else ()),  # float32-lossy values
        ])
    if rng.random() < 0.7:
        p["b"] = rng.choice([rng.randint(0, 3), 0, 0.5])
    if rng.random() < 0.4:
        p["c"] = rng.randint(-3, 3)
    if rng.random() < 0.6:
        p["s"] = rng.choice(["x", "y", "z", "xq"])
    if rng.random() < 0.5:
        p["s2"] = rng.choice(["x", "y", 3])
    if rng.random() < 0.3:
        p["x"] = rng.choice([1, "y", True, None])
    if rng.random() < 0.3:
        p["obj"] = rng.choice([{"k": 1}, {"k": 2}, [1, 2]])
    if rng.random() < 0.3:
        p["obj2"] = rng.choice([{"k": 1}, [1, 2]])
    body = json.dumps(p).encode()
    if rng.random() < 0.08:
        body = b"not json {"
    return body


def _messages(rng, n, payload=None):
    """Twin message lists (the JAX package's and the port's), the same
    fields, ids and timestamps."""
    ref, port = [], []
    for k in range(n):
        kw = dict(
            topic=rng.choice(TOPICS),
            payload=payload(rng) if payload else _payload(rng),
            qos=rng.randint(0, 2), retain=bool(rng.getrandbits(1)),
            from_client=rng.choice(["c1", "c2", "t/1/x"]),
            mid=k.to_bytes(16, "big"), timestamp=1.7e9 + k,
        )
        ref.append(RefMessage(**kw))
        port.append(Message(**kw))
    return ref, port


def _stacks(preds):
    wheres = [(str(i), f'SELECT * FROM "t" WHERE {p}')
              for i, p in enumerate(preds)]
    ref = ref_pred.build_stack([(r, ref_parse(q).where) for r, q in wheres])
    port = pred.build_stack([(r, parse_sql(q).where) for r, q in wheres])
    return ref, port


def _host(stack, cols):
    return ref_mk.rules_eval_host(
        stack.code, stack.a0, stack.a1, stack.a2, stack.a3, stack.litn,
        cols.lit_ranks, stack.last, cols.num, cols.sid, cols.err, cols.prs,
    )


def _port(stack, cols):
    prog = rules_program_from_reference(
        stack.code, stack.a0, stack.a1, stack.a2, stack.a3, stack.litn,
        stack.last, "cpu")
    pl = columns_from_reference(cols.num, cols.sid, cols.err, cols.prs,
                                cols.lit_ranks, "cpu")
    got = mk.rules_eval_batch(prog.code, prog.a0, prog.a1, prog.a2,
                              prog.a3, prog.litn, pl.lit_ranks, prog.last,
                              pl.num, pl.sid, pl.err, pl.prs)
    assert got.dtype == torch.bool and got.device.type == "cpu"
    return got.numpy()


def _assert_same_stack(ref, port):
    for name in ("code", "a0", "a1", "a2", "a3", "litn", "last"):
        a, b = getattr(ref, name), getattr(port, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert ref.paths == port.paths and ref.lit_strings == port.lit_strings
    assert ref.row_of == port.row_of and ref.fallback == port.fallback
    assert (ref.n_steps, ref.has_arith, ref.n_lowered) == (
        port.n_steps, port.has_arith, port.n_lowered)


def _assert_same_planes(ref, port):
    assert np.array_equal(ref.num, port.num, equal_nan=True)
    for name in ("sid", "err", "prs", "lit_ranks"):
        a, b = getattr(ref, name), getattr(port, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert ref.has_nan_value == port.has_nan_value
    assert ref.n_strings == port.n_strings


# ------------------------------------------------------------- layout


def test_opcodes_equal_reference_and_cuda_source():
    names = [n for n in dir(ref_pred) if re.fullmatch(r"R_[A-Z]+", n)]
    assert len(names) == 23  # 22 opcodes + NOP
    src = open(os.path.join(
        REPO, "emqx_tpu_torch", "ops", "csrc", "rules_kernels.cu")).read()
    enum = dict(re.findall(r"\b(R_[A-Z]+) = (\d+),", src))
    for n in names:
        assert getattr(pred, n) == getattr(ref_pred, n), n
        assert int(enum[n]) == getattr(ref_pred, n), n
    assert pred.MAX_STEPS == ref_pred.MAX_STEPS
    assert f"kMaxSteps = {pred.MAX_STEPS};" in src
    assert mk.RULES_HOST_BLOCK == ref_mk.RULES_HOST_BLOCK


def test_corpus_covers_every_opcode():
    _, port = _stacks(CORPUS)
    assert not port.fallback
    assert set(np.unique(port.code).tolist()) == set(range(23))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stack_and_planes_equal_reference(seed):
    rng = random.Random(seed)
    preds = [rng.choice(CORPUS) for _ in range(25)] + [
        "regex_match(payload.s, 'x.*')", "topic LIKE 't/%'"]
    ref, port = _stacks(preds)
    _assert_same_stack(ref, port)
    assert len(port.fallback) == 2
    rmsgs, pmsgs = _messages(rng, 40)
    _assert_same_planes(RefColumns(rmsgs, ref.paths, ref.lit_strings),
                        WindowColumns(pmsgs, port.paths, port.lit_strings))


# -------------------------------------------------------------- parity


@pytest.mark.parametrize("seed", [3, 4, 5, 6])
def test_plain_equals_host_twin(seed):
    rng = random.Random(seed)
    ref, port = _stacks([rng.choice(CORPUS) for _ in range(40)])
    for _ in range(3):
        rmsgs, pmsgs = _messages(rng, rng.randint(1, 70))
        rcols = RefColumns(rmsgs, ref.paths, ref.lit_strings)
        pcols = WindowColumns(pmsgs, port.paths, port.lit_strings)
        want = _host(ref, rcols)
        assert np.array_equal(want, _port(port, pcols))
        direct = mk.rules_eval_plain(*(torch.from_numpy(a) for a in (
            port.code, port.a0, port.a1, port.a2, port.a3, port.litn,
            pcols.lit_ranks, port.last, pcols.num, pcols.sid, pcols.err,
            pcols.prs)))
        assert np.array_equal(want, direct.numpy())


# one padded shape class for the JAX kernel, so it compiles once
_JR, _JS, _JW, _JP, _JL = 32, 8, 64, 16, 8


def _jax_padded(stack, cols):
    """The JAX kernel at one fixed padded shape: NOP steps, inert rule
    rows and planes (NaN / -1 / False), unused literal slots."""
    r, s = stack.code.shape
    p, w = cols.num.shape

    def pad(a, shape, fill, dtype):
        out = np.full(shape, fill, dtype)
        out[tuple(slice(0, k) for k in a.shape)] = a
        return out

    mat = ref_mk.rules_eval_batch(
        pad(stack.code, (_JR, _JS), 0, np.int32),
        *(pad(getattr(stack, n), (_JR, _JS), -1, np.int32)
          for n in ("a0", "a1", "a2", "a3")),
        pad(stack.litn, (_JR, _JS), 0.0, np.float32),
        pad(cols.lit_ranks, (_JL,), 0, np.int32),
        pad(stack.last, (_JR,), 0, np.int32),
        pad(cols.num, (_JP, _JW), np.nan, np.float32),
        pad(cols.sid, (_JP, _JW), -1, np.int32),
        pad(cols.err, (_JP, _JW), False, bool),
        pad(cols.prs, (_JP, _JW), False, bool),
    )
    return np.asarray(mat)[:r, :w]


def _f32_safe(cols):
    finite = cols.num[np.isfinite(cols.num)]
    return bool((finite == finite.astype(np.float32)).all())


def test_plain_equals_jax_kernel_on_f32_safe_windows():
    rng = random.Random(9)
    for _ in range(6):
        ref, port = _stacks([rng.choice(ARITH_FREE) for _ in range(_JR)])
        assert ref.n_steps <= _JS and len(ref.paths) <= _JP
        assert len(ref.lit_strings) <= _JL
        rmsgs, pmsgs = _messages(rng, rng.randint(1, _JW),
                                 payload=lambda r: _payload(r, lossy=False))
        rcols = RefColumns(rmsgs, ref.paths, ref.lit_strings)
        assert _f32_safe(rcols)
        pcols = WindowColumns(pmsgs, port.paths, port.lit_strings)
        got = _port(port, pcols)
        assert np.array_equal(_jax_padded(ref, rcols), got)
        assert np.array_equal(_host(ref, rcols), got)


# -------------------------------------------------- bit-exactness traps


def _trap(preds, payloads, meta=None):
    """The port's plain version against the numpy twin on one window of
    hand-made payloads; returns the matrix."""
    ref, port = _stacks(preds)
    assert not port.fallback
    rmsgs, pmsgs = [], []
    for k, body in enumerate(payloads):
        kw = dict(topic="t", payload=body, mid=bytes(16), timestamp=1.0,
                  **(meta[k] if meta else {}))
        rmsgs.append(RefMessage(**kw))
        pmsgs.append(Message(**kw))
    rcols = RefColumns(rmsgs, ref.paths, ref.lit_strings)
    pcols = WindowColumns(pmsgs, port.paths, port.lit_strings)
    _assert_same_planes(rcols, pcols)
    want = _host(ref, rcols)
    got = _port(port, pcols)
    assert np.array_equal(want, got)
    return got


def test_trap_fma_contraction():
    """numpy rounds ``ta - q*safe`` and ``a*b + c`` twice; an fma rounds
    once and flips these verdicts."""
    big = 2633996730456453632  # 2**61 and up: q*3 is inexact
    got = _trap(
        ["payload.a mod 3 = 0", "payload.a * payload.b + payload.c = 0"],
        [json.dumps({"a": big}).encode(),
         json.dumps({"a": 9385959.583563903, "b": 2834748.6238531545,
                     "c": -26606836013049.1}).encode()],
    )
    assert got[0, 0] and got[1, 1]


def test_trap_division_by_zero_and_nan():
    got = _trap(
        ["payload.a / payload.b > 1", "NOT (payload.a / payload.b > 1)",
         "payload.a div payload.b = 0", "payload.a mod payload.b = 0"],
        [b'{"a": 4, "b": 0}', b'{"a": 4}', b'{"a": 4, "b": 2}',
         b'{"a": 4, "b": 0.4}', b'{"b": 0}'],
    )
    # b = 0: undefined, so both the rule and its negation fail
    assert not got[0, 0] and not got[1, 0]
    assert got[0, 2] and not got[1, 2]


def test_trap_nan_lanes_and_literal_nan():
    _trap(["NOT (payload.a > 0)", "payload.a = payload.a",
           "payload.a < 1 OR payload.b >= 0"],
          [b'{}', b'{"a": null}', b'{"a": "s"}', b'{"a": 1e308}',
           b'{"a": Infinity}', b'{"a": -Infinity, "b": 1}', b"[1, 2]"])


def test_trap_eqvv_null_equals_null():
    got = _trap(["payload.m = payload.n", "payload.m != payload.n"],
                [b"{}", b'{"m": null}', b'{"m": 1, "n": 1}',
                 b'{"m": "x", "n": "x"}', b'{"m": true, "n": true}',
                 b"not json"])
    assert got[0, 0] and got[0, 1] and not got[1, 0]
    assert not got[0, 5] and not got[1, 5]  # lookup error: neither


def test_trap_eqc_flags_and_no_simple_side():
    _trap(["payload.a + 1 = payload.b * 2", "payload.a + 1 != 2",
           "2 = payload.a - 1", "1 + 1 = 2", "1 + 1 != 2",
           "payload.a * 2 = payload.b"],
          [b'{"a": 1, "b": 1}', b'{"a": 3, "b": 6}', b'{"b": 1}',
           b'{"a": "s", "b": 2}', b"oops"])


def test_trap_string_rank_ordering():
    _trap(["payload.s > payload.t", "payload.s <= payload.t",
           "topic >= clientid", "payload.s < payload.n"],
          [b'{"s": "abc", "t": "abd"}', b'{"s": "b", "t": "a"}',
           b'{"s": "x", "t": 1}', b'{"s": true, "t": false}',
           b'{"s": "x", "n": 5}', b'{"s": 2, "t": 1}'],
          meta=[{"from_client": c} for c in ("t", "u", "a", "t", "", "z")])


def test_trap_absent_literal_and_bool_planes():
    _trap(["payload.s = 'nowhere'", "payload.s != 'nowhere'",
           "retain = 1", "retain != 1", "payload.f = payload.g"],
          [b'{"s": "x", "f": true, "g": true}', b'{"f": false, "g": 0}',
           b'{"s": "nowhere"}'],
          meta=[{"retain": True}, {"retain": False}, {"retain": True}])


def test_trap_empty_plane_and_literal_space():
    ref, port = _stacks(["true", "1 + 1 = 2", "NOT false", "2 > 3"])
    assert port.paths == [] and port.lit_strings == []
    rmsgs, pmsgs = _messages(random.Random(1), 5)
    rcols = RefColumns(rmsgs, ref.paths, ref.lit_strings)
    pcols = WindowColumns(pmsgs, port.paths, port.lit_strings)
    assert pcols.num.shape == (0, 5) and pcols.lit_ranks.shape == (0,)
    got = _port(port, pcols)
    assert np.array_equal(_host(ref, rcols), got)
    assert got[:3].all() and not got[3].any()


def test_slabs_past_the_host_block():
    """Registries past RULES_HOST_BLOCK run in 2,048-row slabs (distinct
    literals defeat the program dedup)."""
    n = mk.RULES_HOST_BLOCK + 37
    ref, port = _stacks([f"payload.a > {i}" for i in range(n)])
    assert port.n_rules == n
    rmsgs, pmsgs = _messages(random.Random(2), 4, payload=lambda rng: (
        b'{"a": %d}' % rng.choice([0, 1, 500, 2090])))
    rcols = RefColumns(rmsgs, ref.paths, ref.lit_strings)
    got = _port(port, WindowColumns(pmsgs, port.paths, port.lit_strings))
    assert got.shape == (n, 4)
    assert np.array_equal(_host(ref, rcols), got)


# -------------------------------------------------------------- checks


def test_wrapper_and_upload_refuse_bad_inputs():
    _, port = _stacks(["payload.a > 1"])
    prog = rules_program_from_reference(
        port.code, port.a0, port.a1, port.a2, port.a3, port.litn,
        port.last, "cpu")
    cols = WindowColumns([Message(topic="t", payload=b'{"a": 2}')],
                         port.paths, port.lit_strings)
    pl = columns_from_reference(cols.num, cols.sid, cols.err, cols.prs,
                                cols.lit_ranks, "cpu")
    args = [prog.code, prog.a0, prog.a1, prog.a2, prog.a3, prog.litn,
            pl.lit_ranks, prog.last, pl.num, pl.sid, pl.err, pl.prs]
    assert mk.rules_eval_batch(*args).tolist() == [[True]]
    bad = list(args)
    bad[5] = prog.litn.float()
    with pytest.raises(TypeError, match="litn"):
        mk.rules_eval_batch(*bad)
    bad = list(args)
    bad[8] = torch.zeros((2, 1), dtype=torch.float64)
    with pytest.raises(ValueError, match="disagree"):
        mk.rules_eval_batch(*bad)
    long = [torch.zeros((1, pred.MAX_STEPS + 1), dtype=t.dtype)
            for t in args[:6]]
    with pytest.raises(ValueError, match="steps"):
        mk.rules_eval_batch(*long, *args[6:])
    with pytest.raises(ValueError, match="last"):
        rules_program_from_reference(port.code, port.a0, port.a1, port.a2,
                                     port.a3, port.litn, port.last + 5,
                                     "cpu")
    with pytest.raises(ValueError, match="opcode"):
        rules_program_from_reference(port.code + 40, port.a0, port.a1,
                                     port.a2, port.a3, port.litn, port.last,
                                     "cpu")


# ------------------------------------------------------- lowered form
#
# K4 runs the program lowered once per rules rev
# (`ops.rules_lowering`); its plain version
# (`rules_eval_lowered_plain`) is what chip_smoke.py holds the kernel
# against, so it is held here against the JAX package's numpy twin.

from test_torch_cuda import (  # noqa: E402  (card-test inputs, JAX-free)
    RULE_CORPUS, _rules_window, random_planes, random_programs,
)

from emqx_tpu_torch import state  # noqa: E402
from emqx_tpu_torch.ops import rules_lowering as rl  # noqa: E402


def _lowered(progs, planes, n_lits):
    low = state.rules_lowered_from_reference(*progs, "cpu", n_lits=n_lits)
    num, sid, err, prs, lit_ranks = (torch.from_numpy(a) for a in planes)
    got = mk.rules_eval_lowered(low, lit_ranks, num, sid, err, prs)
    assert got.dtype == torch.bool and got.shape == (len(progs[6]),
                                                     num.shape[1])
    return low, got.numpy()


def test_lowered_constants_equal_cuda_source():
    src = open(os.path.join(
        REPO, "emqx_tpu_torch", "ops", "csrc", "rules_kernels.cu")).read()
    for text in (f"kNumSlots = {rl.RULES_NUM_SLOTS};",
                 f"kSrcPlane = {rl.SRC_PLANE};",
                 f"kSrcLit = {rl.SRC_LIT};", f"kRank = {rl.CMP_RANK};",
                 f"kOkPlane = {rl.EQ_OKP};",
                 f"kBoolInit = 1u << {rl.RULES_BOOL_TRUE};",
                 f"kBoolInitF = 1u << {rl.RULES_BOOL_FALSE};"):
        assert text in src, text
    assert rl.SRC_SLOT == 0 and rl.RULES_BOOL_ZERO == 29


@pytest.mark.parametrize("seed", [0, 1])
def test_lowered_equals_host_twin_on_corpus(seed):
    """RULE_CORPUS windows, the FMA-trap payloads among them."""
    stack, cols = _rules_window(seed, 60, 80)
    progs = (stack.code, stack.a0, stack.a1, stack.a2, stack.a3, stack.litn,
             stack.last)
    with np.errstate(all="ignore"):
        want = ref_mk.rules_eval_host(*progs[:6], cols.lit_ranks,
                                      stack.last, cols.num, cols.sid,
                                      cols.err, cols.prs)
    low, got = _lowered(progs, (cols.num, cols.sid, cols.err, cols.prs,
                                cols.lit_ranks), len(stack.lit_strings))
    assert np.array_equal(want, got)
    assert low.steps.shape[1] < stack.code.shape[1]  # loads are operands
    row = stack.row_of
    assert got[row[f"t{RULE_CORPUS.index('payload.a mod 3 = 0')}"], 0]
    fma = RULE_CORPUS.index("payload.a * payload.b + payload.c = 0")
    assert got[row[f"t{fma}"], 1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lowered_equals_host_twin_on_random_programs(seed):
    """Random programs of up to 48 steps (every opcode, reads of NOP and
    other-kind registers, NaN and infinite literals) and the widest one
    the lowering allows, over planes holding the FMA-trap values."""
    n_planes, n_lits = 5, 4
    progs = random_programs(seed, 80, n_planes, n_lits)
    planes = random_planes(seed, n_planes, 40, n_lits)
    with np.errstate(all="ignore"):  # infinities and NaNs on purpose
        want = ref_mk.rules_eval_host(*progs[:6], planes[4], progs[6],
                                      *planes[:4])
    low, got = _lowered(progs, planes, n_lits)
    assert np.array_equal(want, got)
    stacked = mk.rules_eval_plain(
        *(torch.from_numpy(a) for a in progs[:6]),
        torch.from_numpy(planes[4]), torch.from_numpy(progs[6]),
        *(torch.from_numpy(a) for a in planes[:4]))
    assert np.array_equal(want, stacked.numpy())
    rec = low.steps[0].numpy()  # the widest: every numeric register
    live = rec[:low.meta[0] & 0xFF]
    numeric = (live[:, 0] & 0xFF) >= pred.R_NNEG
    numeric &= (live[:, 0] & 0xFF) <= pred.R_NMOD
    assert ((live[numeric, 0] >> 8) & 0xFF).max() == \
        rl.RULES_NUM_SLOTS - 1
    assert progs[6][0] == 46  # 47 steps


def _prog(steps):
    width = len(steps)
    arrs = [np.full((1, width), -1, np.int32) for _ in range(5)]
    litn = np.zeros((1, width), np.float64)
    for s, (op, *args) in enumerate(steps):
        arrs[0][0, s] = op
        for k, v in enumerate(args):
            arrs[k + 1][0, s] = v
    return (*arrs, litn, np.array([width - 1], np.int32))


def test_lowering_refuses_what_the_kernel_would_check():
    ok = [(pred.R_NLOAD, 0), (pred.R_NLIT,), (pred.R_CGT, 0, 1)]
    state.rules_lowered_from_reference(*_prog(ok), "cpu")
    for bad in (
        [(pred.R_NLOAD, 0), (pred.R_CGT, 0, 1)],  # reads itself
        [(pred.R_NLOAD, 0), (pred.R_CGT, 0, 5)],  # a later step
        [(pred.R_NLOAD, 0), (pred.R_CGT, -1, 0)],  # negative
        [(pred.R_NLOAD, 0), (pred.R_NNEG, 3), (pred.R_BLIT, 1)],
    ):
        with pytest.raises(ValueError, match="register operand"):
            state.rules_lowered_from_reference(*_prog(bad), "cpu")
    eqsl = _prog([(pred.R_EQSL, 0, 2, 0)])
    state.rules_lowered_from_reference(*eqsl, "cpu", n_lits=3)
    for n_lits in (0, 2):
        with pytest.raises(ValueError, match="string-literal"):
            state.rules_lowered_from_reference(*eqsl, "cpu", n_lits=n_lits)
    low = state.rules_lowered_from_reference(*eqsl, "cpu")
    assert low.lits_needed == 3
    planes = [torch.zeros((1, 2), dtype=d) for d in (
        torch.float64, torch.int32, torch.bool, torch.bool)]
    with pytest.raises(ValueError, match="string literals"):
        mk.rules_eval_lowered(low, torch.zeros(2, dtype=torch.int32),
                              *planes)
    # six values each read twice, by two chains: any order keeps seven
    # numeric registers live
    steps = []
    for k in range(6):
        steps += [(pred.R_NLOAD, k), (pred.R_NNEG, len(steps))]
    vals = [2 * k + 1 for k in range(6)]
    for op in (pred.R_NADD, pred.R_NMUL):
        acc = vals[0]
        for v in vals[1:]:
            steps.append((op, acc, v))
            acc = len(steps) - 1
        vals.append(acc)
    steps.append((pred.R_CGT, vals[-2], vals[-1]))
    with pytest.raises(ValueError, match="numeric registers"):
        state.rules_lowered_from_reference(*_prog(steps), "cpu")


def test_rules_eval_lowered_reaches_the_launch_past_int32_planes():
    # P x W past INT_MAX (the unstaged instance's 64-bit plane offsets)
    # and W past 65,535 slices of 128 messages (the slices' grid-stride
    # loop) are taken; meta tensors take the shapes without the memory,
    # and a size it takes gets as far as the launch, which wants a card
    meta = torch.device("meta")
    low = rl.LoweredRules(
        torch.zeros((1, 1, 4), dtype=torch.int32, device=meta),
        torch.zeros((1, 1), dtype=torch.float64, device=meta),
        torch.zeros(1, dtype=torch.int32, device=meta), 0)
    lit_ranks = torch.zeros(1, dtype=torch.int32, device=meta)
    for p, w in ((2, 2**30 - 1), (1, 2**31 - 1), (2, 2**30), (3, 2**30),
                 (257, 8_388_608), (1, 8_388_481)):
        planes = [torch.zeros((p, w), dtype=d, device=meta) for d in (
            torch.float64, torch.int32, torch.bool, torch.bool)]
        with pytest.raises(ValueError, match="CUDA tensors"):
            mk.rules_eval_lowered(low, lit_ranks, *planes)
