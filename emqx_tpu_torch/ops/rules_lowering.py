"""K4's program format: the rule engine's stacked WHERE program lowered
into the step records `rules_kernels.cu` runs.

`lower_rules` lowers a stacked program (`predicate.StackedRules`
arrays of either package) once per rules rev; `match_kernel.
rules_eval_lowered` launches K4 on the result and
`match_kernel.rules_eval_lowered_plain` is its plain version.  The
record constants here are the kernel's (`tests/test_torch_rules_kernel.
py` holds them against the CUDA source).  `state.
rules_lowered_from_reference` is the device entry point.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..rules.predicate import (
    MAX_STEPS, R_BAND, R_BLIT, R_BNOT, R_BOR, R_CGE, R_CGT, R_CLE, R_CLT,
    R_EQC, R_EQSL, R_EQVL, R_EQVV, R_NADD, R_NDIV, R_NIDV, R_NLIT, R_NLOAD,
    R_NMOD, R_NMUL, R_NNEG, R_NOP, R_NSUB, R_PRES,
)


def rules_arrays(code, a0, a1, a2, a3, litn, last):
    """The stacked program as contiguous numpy arrays, checked for what
    every evaluator relies on: ``1 <= S <= MAX_STEPS``, known opcodes,
    and each rule's result register inside its row."""
    ops = [np.ascontiguousarray(a, dtype=np.int32)
           for a in (code, a0, a1, a2, a3)]
    lit = np.ascontiguousarray(litn, dtype=np.float64)
    res = np.ascontiguousarray(last, dtype=np.int32)
    shape = ops[0].shape
    if len(shape) != 2 or any(a.shape != shape for a in (*ops, lit)):
        raise ValueError("code, a0..a3 and litn must share one [R, S] shape")
    r, s = shape
    if not 1 <= s <= MAX_STEPS:
        raise ValueError(f"programs must have 1..{MAX_STEPS} steps, got {s}")
    if res.shape != (r,):
        raise ValueError(f"last must be [{r}], got {res.shape}")
    if r and (ops[0].min() < 0 or ops[0].max() > R_PRES):
        raise ValueError("unknown opcode in code")
    if r and (res.min() < 0 or res.max() >= s):
        raise ValueError(f"last must index a step in [0, {s})")
    return (*ops, lit, res)


# ------------------------------------------------------ K4's step records
#
# The stacked program writes register s at step s and keeps all S of
# them.  The lowered form keeps what a rule's result depends on, in an
# order that needs few registers, renamed onto two small files: K
# numeric registers (a float64 and its defined bit) and 32 boolean ones
# (a (T, F) pair), of which 29..31 hold the constants clear, true and
# false.  Plane loads and numeric literals are not steps: the operand
# that reads one names the plane or the literal itself.  A register
# read across kinds (a numeric read of a boolean register, a boolean
# read of a numeric one) or of a step that writes nothing (NOP) reads
# clear, as in the stacked program's zero-filled file.
#
# A step is one 16 B record of four int32 words:
#   w0  opcode | dst << 8 | flags << 16
#   w1  operand a: a numeric source (kind << 16 | index), a boolean
#       register, or a plane
#   w2  operand b: the same, or a string-literal index (EQSL)
#   w3  planes: the rank planes p | q << 16 (ordered compares), or the
#       error plane of an equality
# with the operand's literal (if any) in the rule's literal row.  The
# opcodes are the stacked program's: the four ordered compares become
# R_CGT with an order mask (lt 1, eq 2, gt 4) and a rank flag (8), an
# EQVL becomes the R_EQC of its plane and its literal.

RULES_NUM_SLOTS = 5  # numeric registers (rules_kernels.cu kNumSlots)
RULES_BOOL_ZERO, RULES_BOOL_TRUE, RULES_BOOL_FALSE = 29, 30, 31
SRC_SLOT, SRC_PLANE, SRC_LIT = 0, 1, 2  # numeric operand kinds
PLANE_MAX = 0xFFFF  # plane indices clamp here; P may not pass 65,536
CMP_RANK = 8  # R_CGT flag: both sides are bare vars (string ranks)
EQ_OKP = 8  # R_EQC flag: w3 names the error plane

_ORDER_MASK = {R_CGT: 4, R_CLT: 1, R_CGE: 6, R_CLE: 3}
_NUM_OPS = frozenset((R_NNEG, R_NADD, R_NSUB, R_NMUL, R_NDIV, R_NIDV,
                      R_NMOD))
_REG_ARGS = {R_NNEG: 1, R_BNOT: 1, R_BAND: 2, R_BOR: 2, R_EQC: 2,
             **{op: 2 for op in (R_NADD, R_NSUB, R_NMUL, R_NDIV, R_NIDV,
                                 R_NMOD, R_CGT, R_CLT, R_CGE, R_CLE)}}
_NUM_ZERO = (SRC_SLOT, RULES_NUM_SLOTS)  # reads 0, not defined
_NODE = -1  # operand kind: the result of another lowered step


class LoweredRules(NamedTuple):
    steps: torch.Tensor  # [R, S', 4] int32 step records
    lits: torch.Tensor  # [R, NL] float64 literal operands
    meta: torch.Tensor  # [R] int32: step count | result register << 8
    lits_needed: int  # string-literal indices the records read (EQSL)


def _plane(p: int) -> int:
    return min(max(int(p), 0), PLANE_MAX)


def _lower_rule(code, a0, a1, a2, a3, litn, last, n_lits, r):
    """One rule's records, literal row and (step count, result
    register).  Raises ValueError for a register operand outside the
    rule's earlier steps, a string-literal index outside [0, n_lits),
    or a program that needs more than RULES_NUM_SLOTS numeric
    registers live at once."""
    nsrc, bsrc, kids = {}, {}, {}
    for s in range(last + 1):
        op = code[s]
        regs = (a0[s], a1[s])[:_REG_ARGS.get(op, 0)]
        for j in regs:
            if not 0 <= j < s:
                raise ValueError(
                    f"rule {r} step {s}: register operand {j} is not an "
                    f"earlier step")
        if op == R_EQSL and not (0 <= a1[s] and (n_lits is None
                                                 or a1[s] < n_lits)):
            raise ValueError(f"rule {r} step {s}: string-literal index "
                             f"{a1[s]} outside [0, {n_lits})")
        nsrc[s], bsrc[s] = _NUM_ZERO, RULES_BOOL_ZERO
        if op == R_NLOAD:
            nsrc[s] = (SRC_PLANE, _plane(a0[s]))
        elif op == R_NLIT:
            nsrc[s] = (SRC_LIT, s)
        elif op in _NUM_OPS:
            nsrc[s] = (_NODE, s)
        elif op == R_BLIT:
            bsrc[s] = RULES_BOOL_TRUE if a0[s] == 1 else RULES_BOOL_FALSE
        elif op != R_NOP:
            bsrc[s] = (_NODE, s)
        if op in (R_BNOT, R_BAND, R_BOR):
            kids[s] = [bsrc[j] for j in regs]
        elif op in _REG_ARGS:
            kids[s] = [nsrc[j] for j in regs]
        else:
            kids[s] = []
    root = bsrc[last]
    if not isinstance(root, tuple):  # a constant or clear result
        return [], [], 0, root
    # Sethi-Ullman order: the child needing more registers first
    weight, order, seen = {}, [], set()

    def nodes(s):
        return list(dict.fromkeys(k[1] for k in kids[s]
                                  if isinstance(k, tuple) and k[0] == _NODE))

    for s in range(last + 1):
        if isinstance(bsrc[s], tuple) or nsrc[s][0] == _NODE:
            ws = sorted((weight[c] for c in nodes(s)), reverse=True)
            weight[s] = max([1] + [w + i for i, w in enumerate(ws)])

    def visit(s):
        if s in seen:
            return
        seen.add(s)
        for c in sorted(nodes(s), key=lambda c: -weight[c]):
            visit(c)
        order.append(s)

    visit(root[1])
    pos = {s: t for t, s in enumerate(order)}
    last_use = {root[1]: len(order)}
    for s in order:
        for c in nodes(s):
            last_use[c] = max(last_use.get(c, -1), pos[s])
    free = {True: list(range(RULES_NUM_SLOTS)),
            False: list(range(RULES_BOOL_ZERO))}
    slot = {}
    for t, s in enumerate(order):
        for c in nodes(s):
            if last_use[c] == t:
                free[code[c] in _NUM_OPS].append(slot[c])
        pool = free[code[s] in _NUM_OPS]
        if not pool:
            raise ValueError(
                f"rule {r} needs more than {RULES_NUM_SLOTS} numeric "
                f"registers live at once")
        pool.sort()
        slot[s] = pool.pop(0)
    lits: List[float] = []
    lit_ix: Dict[int, int] = {}

    def num(src):
        kind, v = src
        if kind == _NODE:
            return SRC_SLOT << 16 | slot[v]
        if kind == SRC_LIT:
            if v not in lit_ix:
                lit_ix[v] = len(lits)
                lits.append(float(litn[v]))
            v = lit_ix[v]
        return kind << 16 | v

    def boo(src):
        return slot[src[1]] if isinstance(src, tuple) else src

    recs = []
    for s in order:
        op, x, y, z, u = code[s], a0[s], a1[s], a2[s], a3[s]
        flags, w1, w2, w3 = 0, 0, 0, 0
        if op in _NUM_OPS:
            w1 = num(kids[s][0])
            w2 = num(kids[s][1]) if len(kids[s]) > 1 else 0
        elif op in (R_BNOT, R_BAND, R_BOR):
            w1 = boo(kids[s][0])
            w2 = boo(kids[s][1]) if len(kids[s]) > 1 else 0
        elif op in _ORDER_MASK:
            flags = _ORDER_MASK[op]
            op = R_CGT
            w1, w2 = num(kids[s][0]), num(kids[s][1])
            if z >= 0 and u >= 0:
                flags |= CMP_RANK
                w3 = _plane(z) | _plane(u) << 16
        elif op == R_EQC:
            flags = z & 7
            w1, w2 = num(kids[s][0]), num(kids[s][1])
            if u >= 0:
                flags |= EQ_OKP
                w3 = _plane(u)
        elif op == R_EQVL:
            op, flags = R_EQC, (z == 1) | EQ_OKP
            w1, w2 = num((SRC_PLANE, _plane(x))), num((SRC_LIT, s))
            w3 = _plane(x)
        else:  # R_EQVV, R_EQSL, R_PRES: planes (and a literal index)
            flags = int(z == 1)
            w1 = _plane(x)
            w2 = _plane(y) if op == R_EQVV else (y if op == R_EQSL else 0)
        recs.append((op | slot[s] << 8 | flags << 16, w1, w2, w3))
    return recs, lits, len(order), slot[root[1]]


def lower_rules(code, a0, a1, a2, a3, litn, last, device: torch.device,
                n_lits: Optional[int] = None) -> LoweredRules:
    """Lower a stacked WHERE program (`rules_arrays`) into K4's step
    records on ``device``; ``n_lits``, when
    known, is the size of the string-literal table the program's EQSL
    indices must stay inside.  Each result is bit for bit the stacked
    program's (`ops.match_kernel.rules_eval_plain`): the kept steps
    compute the same functions of the same operands.  Raises ValueError
    where the kernel could not run the program without a run-time
    check: a register operand outside its rule's earlier steps, a
    literal index out of range, more than RULES_NUM_SLOTS numeric
    registers live at once (no program `predicate.build_stack` makes:
    its programs are trees, and a tree of 48 steps needs at most 5)."""
    arrays = rules_arrays(code, a0, a1, a2, a3, litn, last)
    rows = [a.tolist() for a in arrays]
    per = [_lower_rule(*(a[r] for a in rows[:6]), rows[6][r], n_lits, r)
           for r in range(len(rows[6]))]
    n_rules = len(per)
    width = max([1] + [n for _, _, n, _ in per])
    n_lit = max([1] + [len(lt) for _, lt, _, _ in per])
    steps = np.zeros((n_rules, width, 4), np.uint32)
    lits = np.zeros((n_rules, n_lit), np.float64)
    meta = np.zeros(n_rules, np.int32)
    for r, (recs, lt, n, res) in enumerate(per):
        if recs:
            steps[r, :n] = recs
        lits[r, :len(lt)] = lt
        meta[r] = n | res << 8
    eqsl = arrays[0] == R_EQSL
    eqsl &= np.arange(arrays[0].shape[1])[None, :] <= arrays[6][:, None]
    needed = int(arrays[2][eqsl].max()) + 1 if eqsl.any() else 0
    return LoweredRules(
        torch.from_numpy(steps.view(np.int32)).to(device),
        torch.from_numpy(lits).to(device), torch.from_numpy(meta).to(device),
        needed,
    )
