"""Batched wildcard match and per-delivery decide: wrappers, CUDA
launches and their plain PyTorch versions.

Four functions carry the publish path and the rule engine on the
device:

  * `match_batch_compact` — the frontier scan of a ``[B, L]`` token
    batch through the trie automaton (`automaton.py`), with the match
    codes compacted into one flat buffer.  Every publish window runs it.
  * `match_batch` — the same scan with a dense ``[B, m_cap]`` output;
    the engine reruns a window on it when the compact buffer clipped.
  * `decide_packed` — one packed decision byte per delivery: effective
    QoS (both upgrade variants), the no-local drop, retain-as-published
    and subscription-identifier presence, from the subscription options
    packed one word a row (`pack_opts`), with the range check of the
    delivery indices fused in.  `decide_batch` takes the four option
    columns as the JAX package's does.
  * `rules_eval_lowered` — the rule engine's WHERE programs, lowered
    once per rules rev (`rules_lowering.lower_rules`), over a
    window's column planes: the ``[R, W]`` pass matrix.
    `rules_eval_batch` takes the stacked program as the JAX package's
    does.
  * `sharded_match_local` — `match_batch` over the K shards of a
    sharded index that live on one device, with the per-topic count
    summed over the shards (`parallel.sharded.sharded_match` launches it
    once per device).
  * `predicate_eval_batch` — one rule's WHERE register program
    (`rules.predicate.lower_predicate`) over its var columns.

Each wrapper dispatches on the device of the tensors it is given: CPU
tensors run the plain PyTorch version in this module, CUDA tensors
launch the hand-written kernel in ``csrc/match_kernels.cu``,
``csrc/rules_kernels.cu`` or ``csrc/predicate_kernels.cu`` (built and
bound by `_kernels.py`) or raise.  Each wrapper counts its kernel
launches in its ``launches`` attribute.  `decide_batch` and
`rules_eval_batch` keep the JAX package's arguments: on the card they
pack or lower them and call `decide_packed` and `rules_eval_lowered`,
which launch K3 and K4 and count them.

Match codes: ``node*2 + 1`` = a ``#``-terminal matched at ``node``;
``node*2`` = an exact terminal.  A lookup can false-hit a fingerprint
with probability ~2^-32 per lane; every candidate is re-verified
against its node's unique incoming edge, so a collision produces
neither a false match nor a duplicate one.

Semantics (bit for bit those of the JAX package's kernels):
  * the 2F candidates of a level (F literal lookups, then F ``+``
    children) are sorted ascending, adjacent duplicates are replaced by
    ``SENTINEL`` in place (no compaction), and the first F slots become
    the new frontier; a live candidate past slot F flags overflow;
  * codes of a row come out in the order root ``#``, then per level the
    frontier lanes in slot order, then the final exact hits;
  * ``$``-topics never match a root ``+`` (candidate step and
    verification) nor the root ``#``;
  * rows past their length keep their frontier and record nothing;
  * out-of-range node gathers clamp to the table, as the JAX gathers do.
"""

from __future__ import annotations

from typing import List

import torch

from ..rules import predicate as P
from ..rules.predicate import (  # opcode space (compiler-owned)
    MAX_STEPS, R_BAND, R_BLIT, R_BNOT, R_BOR, R_CGE, R_CGT, R_CLE, R_CLT,
    R_EQC, R_EQSL, R_EQVL, R_EQVV, R_NADD, R_NDIV, R_NIDV, R_NLIT,
    R_NLOAD, R_NMOD, R_NMUL, R_NNEG, R_NSUB, R_PRES,
)
from .automaton import BUCKET
from .dictionary import PLUS_TOK, SENTINEL
from .rules_lowering import (
    CMP_RANK, EQ_OKP, PLANE_MAX, RULES_BOOL_FALSE, RULES_BOOL_TRUE,
    RULES_NUM_SLOTS, SRC_LIT, SRC_PLANE, LoweredRules, lower_rules,
)

SENT = int(SENTINEL)
F_MAX = 16  # frontier width: the widest lane group of the kernels
M_MAX = 32767  # largest m_cap whose counts fit the compact int16 column
_M32 = 0xFFFFFFFF

# packed decision byte (one per delivery)
DEC_QMAX_SHIFT = 2
DEC_DROP_BIT = 1 << 4
DEC_RETAIN_BIT = 1 << 5
DEC_SUBID_BIT = 1 << 6


# ------------------------------------------------------------ hashing
#
# CPU torch has no uint32 arithmetic, so the plain versions hash in
# int64 holding values in [0, 2^32).  Each product is split into 16-bit
# halves so no intermediate leaves the signed 64-bit range.


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def mix32_i64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`automaton.mix32` on int64 tensors holding uint32 values."""
    x = _mul32(a, 0x9E3779B1)
    y = (_mul32(b, 0x85EBCA6B) + 0x165667B1) & _M32
    h = x ^ y
    h = h ^ (h >> 15)
    h = _mul32(h, 0x2C1B3C6D)
    return h ^ (h >> 12)


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _M32


def _i32_bits(x: torch.Tensor) -> torch.Tensor:
    """uint32 value (int64) -> the int32 value with the same bits."""
    return x - ((x >> 31) << 32)


# ------------------------------------------------------ plain versions


def _fp_lookup(fp_rows, nodes, toks, salt: int, touched=None, rows=None):
    """Literal-edge lookup: (node, tok) -> child | SENTINEL; one bucket
    row gather + an 8-wide fingerprint compare, the literal child being
    the max child over the fingerprint hits."""
    valid = nodes != SENT
    toks = toks.expand_as(nodes)
    nb = fp_rows.shape[0]
    pu, tu = _u32(nodes), _u32(toks)
    h0 = mix32_i64((pu + salt) & _M32, tu)
    s2 = (salt * 0x9E3779B1) & _M32
    fp = _i32_bits(mix32_i64(tu, pu ^ s2))
    idx = torch.where(valid, h0 & (nb - 1), torch.zeros_like(h0))
    if touched is not None:  # bucket rows the looked-up rows read
        touched[0].append(idx[valid & rows])
    row = fp_rows[idx].to(torch.int64)  # [B, F, 2*BUCKET]
    hit = row[..., :BUCKET] == fp[..., None]
    child = torch.where(
        hit, row[..., BUCKET:], torch.full_like(row[..., BUCKET:], -1)
    ).amax(dim=-1)
    return torch.where(
        valid & (child >= 0), child, torch.full_like(child, SENT)
    )


def _match_core(fp_rows, node_rows, salt: int, tokens, lengths, dollar,
                f_width: int, touched=None):
    """Shared frontier scan.  Returns ``(vals, hits, over)``: the
    ``[B, 1 + L*F + F]`` code values and hit flags in output order, and
    the per-row frontier-overflow flag.  ``touched`` (a pair of lists)
    collects the bucket and node rows the scan reads."""
    b, levels = tokens.shape
    n_nodes = node_rows.shape[0]
    dev = tokens.device
    nrows64 = node_rows.to(torch.int64)
    tok64 = tokens.to(torch.int64)
    len64 = lengths.to(torch.int64)

    def gather_rows(f):
        return nrows64[f.clamp(0, n_nodes - 1)]  # [B, F, 8]

    frontier = torch.full((b, f_width), SENT, dtype=torch.int64, device=dev)
    frontier[:, 0] = 0
    frows = gather_rows(frontier)
    sent = torch.full_like(frontier, SENT)
    h_seq: List[torch.Tensor] = []
    nf_seq: List[torch.Tensor] = []
    over = torch.zeros(b, dtype=torch.bool, device=dev)
    for i in range(levels):
        tok = tok64[:, i]
        active = i < len64  # [B]
        root_dollar = (dollar & (i == 0))[:, None]
        lit = _fp_lookup(fp_rows, frontier, tok[:, None], salt, touched,
                         active[:, None])
        fvalid = frontier != SENT
        plus = torch.where(fvalid, frows[..., 0], sent)
        plus = torch.where(root_dollar, sent, plus)
        cand, _ = torch.sort(torch.cat([lit, plus], dim=1), dim=1)
        dup = torch.zeros_like(cand, dtype=torch.bool)
        dup[:, 1:] = cand[:, 1:] == cand[:, :-1]
        cand = torch.where(dup, torch.full_like(cand, SENT), cand)
        nf = cand[:, :f_width]
        over |= active & (cand[:, f_width:] != SENT).any(dim=1)
        nf = torch.where(active[:, None], nf, frontier)
        if touched is not None:
            touched[1].append(nf[active[:, None] & (nf != SENT)])
        nrows = gather_rows(nf)
        eparent = nrows[..., 4]
        etok = nrows[..., 5]
        in_prev = (eparent[..., None] == frontier[:, None, :]).any(dim=-1)
        plus_ok = (etok == PLUS_TOK) & ~root_dollar
        ok = in_prev & ((etok == tok[:, None]) | plus_ok)
        ok = ok | ~active[:, None]
        nf = torch.where(ok, nf, sent)
        h_seq.append((nrows[..., 1] > 0) & (nf != SENT) & active[:, None])
        nf_seq.append(nf)
        frontier, frows = nf, nrows
    root_hash = (nrows64[0, 1] > 0) & ~dollar
    e_hit = (frows[..., 2] > 0) & (frontier != SENT)
    vals = torch.cat(
        [torch.ones((b, 1), dtype=torch.int64, device=dev)]
        + [nf * 2 + 1 for nf in nf_seq]
        + [frontier * 2],
        dim=1,
    )
    hits = torch.cat([root_hash[:, None]] + h_seq + [e_hit], dim=1)
    return vals, hits, over


def match_batch_plain(fp_rows, node_rows, salt, tokens, lengths, dollar,
                      *, f_width: int, m_cap: int):
    """Plain PyTorch version of `match_batch`."""
    b = tokens.shape[0]
    vals, hits, over = _match_core(
        fp_rows, node_rows, int(salt), tokens, lengths, dollar, f_width
    )
    prefix = torch.cumsum(hits.to(torch.int64), dim=1)
    count = prefix[:, -1]
    pos = torch.where(hits & (prefix <= m_cap), prefix - 1,
                      torch.full_like(prefix, m_cap))
    buf = torch.full((b, m_cap + 1), -1, dtype=torch.int64,
                     device=tokens.device)
    buf.scatter_(1, pos, torch.where(hits, vals, torch.full_like(vals, -1)))
    ovf = over | (count > m_cap)
    return (buf[:, :m_cap].to(torch.int32),
            count.clamp(max=m_cap).to(torch.int32), ovf)


def match_batch_compact_plain(fp_rows, node_rows, salt, tokens, lengths,
                              dollar, *, f_width: int, m_cap: int,
                              c_cap: int):
    """Plain PyTorch version of `match_batch_compact`."""
    vals, hits, over = _match_core(
        fp_rows, node_rows, int(salt), tokens, lengths, dollar, f_width
    )
    prefix = torch.cumsum(hits.to(torch.int64), dim=1)
    count = prefix[:, -1]
    count_c = count.clamp(max=m_cap)
    row_start = torch.cumsum(count_c, dim=0) - count_c  # exclusive
    valid = hits & (prefix <= m_cap)
    tgt = torch.where(valid, row_start[:, None] + prefix - 1,
                      torch.full_like(prefix, c_cap))
    tgt = tgt.clamp(max=c_cap)  # codes past c_cap are dropped
    flat = torch.full((c_cap + 1,), -1, dtype=torch.int64,
                      device=tokens.device)
    keep = tgt < c_cap
    flat[tgt[keep]] = vals[keep]
    ovf = over | (count > m_cap)
    counts_out = torch.where(ovf, -count_c - 1, count_c).to(torch.int16)
    total = count_c.sum().to(torch.int32).reshape(1)
    return flat[:c_cap].to(torch.int32), counts_out, total


def sharded_match_plain(fp_rows, node_rows, salts, tokens, lengths, dollar,
                        *, f_width: int, m_cap: int):
    """Plain PyTorch version of `sharded_match_local`: `match_batch`'s
    plain version per shard, with that shard's salt, and the counts
    summed over the shards."""
    outs = [
        match_batch_plain(fp_rows[k], node_rows[k], salt, tokens, lengths,
                          dollar, f_width=f_width, m_cap=m_cap)
        for k, salt in enumerate(salts.cpu().to(torch.int64).tolist())
    ]
    codes, counts, ovf = (torch.stack(t) for t in zip(*outs))
    return codes, counts, ovf, counts.sum(dim=0).to(torch.int32)


def decide_batch_plain(oa_qos, oa_nl, oa_rap, oa_subid, opts_rows,
                       client_rows, msg_idx, m_qos, m_retain, m_from_row):
    """Plain PyTorch version of `decide_batch` (gathers clamp, as the
    JAX gathers do)."""
    o = opts_rows.to(torch.int64).clamp(0, oa_qos.shape[0] - 1)
    mi = msg_idx.to(torch.int64).clamp(0, m_qos.shape[0] - 1)
    oq = oa_qos[o].to(torch.int32)
    mq = m_qos[mi].to(torch.int32)
    drop = oa_nl[o] & (client_rows == m_from_row[mi])
    ret = m_retain[mi] & oa_rap[o]
    packed = (
        torch.minimum(mq, oq)
        | (torch.maximum(mq, oq) << DEC_QMAX_SHIFT)
        | drop.to(torch.int32) * DEC_DROP_BIT
        | ret.to(torch.int32) * DEC_RETAIN_BIT
        | oa_subid[o].to(torch.int32) * DEC_SUBID_BIT
    )
    return packed.to(torch.uint8)


def pack_opts(oa_qos, oa_nl, oa_rap, oa_subid) -> torch.Tensor:
    """The four per-opts-row columns (``int8``, ``bool`` x 3, ``[R]``)
    as one ``int32`` word a row: its bytes, lowest first, are the QoS,
    no-local, retain-as-published and subscription-identifier bytes."""
    return torch.stack([c.view(torch.uint8) for c in (
        oa_qos, oa_nl, oa_rap, oa_subid)], dim=1).view(torch.int32).reshape(-1)


def decide_packed_plain(oa, opts_rows, client_rows, msg_idx, m_qos,
                        m_retain, m_from_row):
    """Plain PyTorch version of `decide_packed`: ``(decisions, error)``;
    a delivery whose opts row or message index is out of range gets the
    byte 0 and sets ``error``."""
    o = opts_rows.to(torch.int64)
    mi = msg_idx.to(torch.int64)
    ok = (o >= 0) & (o < oa.shape[0]) & (mi >= 0) & (mi < m_qos.shape[0])
    o = torch.where(ok, o, torch.zeros_like(o))
    mi = torch.where(ok, mi, torch.zeros_like(mi))
    w = oa[o]
    oq = ((w & 0xFF) ^ 0x80) - 0x80  # the QoS byte, sign-extended
    nl, rap, sub = (((w >> k) & 0xFF) != 0 for k in (8, 16, 24))
    mq = m_qos[mi].to(torch.int32)
    drop = nl & (client_rows == m_from_row[mi])
    ret = m_retain[mi] & rap
    packed = (
        torch.minimum(mq, oq)
        | (torch.maximum(mq, oq) << DEC_QMAX_SHIFT)
        | drop.to(torch.int32) * DEC_DROP_BIT
        | ret.to(torch.int32) * DEC_RETAIN_BIT
        | sub.to(torch.int32) * DEC_SUBID_BIT
    )
    packed = torch.where(ok, packed, torch.zeros_like(packed))
    return packed.to(torch.uint8), (~ok).any().to(torch.int32).reshape(1)


# ------------------------------------------------- rules x window eval
#
# Step s of each rule's row writes register s; numeric registers are
# (value, defined) pairs, boolean registers the predicate compiler's
# (T, F) short-circuit pairs, so the matrix equals the interpreter's
# verdicts.  The plain version groups rows by opcode per step (indexing
# just the rules that run that op) like the JAX package's numpy twin
# `rules_eval_host`, in float64, and equals it bit for bit.

# rule-block size: bounds the [S, R_BLOCK, W] register file (a 10k-rule
# registry evaluates in slabs, not one 700 MB tensor)
RULES_HOST_BLOCK = 2048


def rules_eval_plain(code, a0, a1, a2, a3, litn, lit_ranks, last, num, sid,
                     err, prs):
    """Plain PyTorch version of `rules_eval_batch`: ``code``/``a0..a3``/
    ``litn`` are ``[R, S]``, ``last`` ``[R]`` (each rule's result
    register), ``num``/``sid``/``err``/``prs`` ``[P, W]`` column planes,
    ``lit_ranks`` maps string-literal indices to this window's ranks.
    Returns the ``[R, W]`` bool pass matrix."""
    n_rules = code.shape[0]
    if n_rules > RULES_HOST_BLOCK:
        return torch.cat([
            rules_eval_plain(
                *(t[k:k + RULES_HOST_BLOCK] for t in (code, a0, a1, a2, a3,
                                                      litn)),
                lit_ranks, last[k:k + RULES_HOST_BLOCK], num, sid, err, prs,
            )
            for k in range(0, n_rules, RULES_HOST_BLOCK)
        ])
    r_n, s_n = code.shape
    w = num.shape[1]
    dev = num.device
    code, a0, a1, a2, a3 = (t.to(torch.int64) for t in (code, a0, a1, a2,
                                                          a3))
    nv = torch.zeros((s_n, r_n, w), dtype=torch.float64, device=dev)
    nd = torch.zeros((s_n, r_n, w), dtype=torch.bool, device=dev)
    bt = torch.zeros((s_n, r_n, w), dtype=torch.bool, device=dev)
    bf = torch.zeros((s_n, r_n, w), dtype=torch.bool, device=dev)
    nul = ~err & ~prs  # value is null (lookup ok, nothing there)

    def col(mask):
        return mask[:, None]

    def put(s, rows, t, f, neg):
        bt[s, rows] = torch.where(neg, f, t)
        bf[s, rows] = torch.where(neg, t, f)

    for s in range(s_n):
        oc = code[:, s]
        for op in torch.unique(oc).tolist():
            rows = torch.nonzero(oc == op).flatten()
            i0, i1, i2 = a0[rows, s], a1[rows, s], a2[rows, s]
            if op == R_NLOAD:
                v = num[i0]
                nv[s, rows] = v
                nd[s, rows] = ~torch.isnan(v)
            elif op == R_NLIT:
                nv[s, rows] = litn[rows, s][:, None].expand(-1, w)
                nd[s, rows] = True
            elif op == R_NNEG:
                nv[s, rows] = -nv[i0, rows]
                nd[s, rows] = nd[i0, rows]
            elif op in (R_NADD, R_NSUB, R_NMUL, R_NDIV, R_NIDV, R_NMOD):
                lv, ld = nv[i0, rows], nd[i0, rows]
                rv, rd = nv[i1, rows], nd[i1, rows]
                d = ld & rd
                if op == R_NADD:
                    nv[s, rows], nd[s, rows] = lv + rv, d
                elif op == R_NSUB:
                    nv[s, rows], nd[s, rows] = lv - rv, d
                elif op == R_NMUL:
                    nv[s, rows], nd[s, rows] = lv * rv, d
                elif op == R_NDIV:
                    ok = rv != 0
                    nv[s, rows] = torch.where(
                        ok, lv / torch.where(ok, rv, torch.ones_like(rv)),
                        torch.zeros_like(rv),
                    )
                    nd[s, rows] = d & ok
                else:  # div / mod: trunc both, then floor-divide
                    ta, tb = torch.trunc(lv), torch.trunc(rv)
                    ok = tb != 0
                    safe = torch.where(ok, tb, torch.ones_like(tb))
                    q = torch.floor(ta / safe)
                    nv[s, rows] = q if op == R_NIDV else ta - q * safe
                    nd[s, rows] = d & ok
            elif op == R_BLIT:
                v = col(i0 == 1).expand(-1, w)
                bt[s, rows] = v
                bf[s, rows] = ~v
            elif op == R_BNOT:
                bt[s, rows] = bf[i0, rows]
                bf[s, rows] = bt[i0, rows]
            elif op in (R_BAND, R_BOR):
                tl, fl = bt[i0, rows], bf[i0, rows]
                tr, fr = bt[i1, rows], bf[i1, rows]
                if op == R_BAND:
                    bt[s, rows], bf[s, rows] = tl & tr, fl | (tl & fr)
                else:
                    bt[s, rows], bf[s, rows] = tl | (fl & tr), fl & fr
            elif op in (R_CGT, R_CLT, R_CGE, R_CLE):
                lv, ld = nv[i0, rows], nd[i0, rows]
                rv, rd = nv[i1, rows], nd[i1, rows]
                d = ld & rd
                cmp = _ORDER[op](lv, rv)
                t, f = d & cmp, d & ~cmp
                i3 = a3[rows, s]
                sv = (i2 >= 0) & (i3 >= 0)  # bare-var sides: strings
                if bool(sv.any()):
                    zero = torch.zeros_like(i2)
                    sl = sid[torch.where(sv, i2, zero)]
                    sr = sid[torch.where(sv, i3, zero)]
                    ds = col(sv) & (sl >= 0) & (sr >= 0)
                    cmps = _ORDER[op](sl, sr)
                    t = t | (ds & cmps)
                    f = f | (ds & ~cmps)
                bt[s, rows], bf[s, rows] = t, f
            elif op == R_EQVV:
                lp, rp = num[i0], num[i1]
                eqn = ~torch.isnan(lp) & ~torch.isnan(rp) & (lp == rp)
                sl, sr = sid[i0], sid[i1]
                eqs = (sl != -1) & (sl == sr)
                eqz = nul[i0] & nul[i1]  # null = null is TRUE
                e = eqn | eqs | eqz
                ok = ~err[i0] & ~err[i1]
                put(s, rows, e & ok, ~e & ok, col(i2 == 1))
            elif op == R_EQVL:
                v = num[i0]
                e = ~torch.isnan(v) & (v == litn[rows, s][:, None])
                ok = ~err[i0]
                put(s, rows, e & ok, ~e & ok, col(i2 == 1))
            elif op == R_EQSL:
                lid = lit_ranks[i1][:, None]
                ok = ~err[i0]
                put(s, rows, ok & (sid[i0] == lid), ok & (sid[i0] != lid),
                    col(i2 == 1))
            elif op == R_EQC:
                lv, ld = nv[i0, rows], nd[i0, rows]
                rv, rd = nv[i1, rows], nd[i1, rows]
                e = ld & rd & (lv == rv)
                i3 = a3[rows, s]
                has_ok = i3 >= 0
                if bool(has_ok.any()):
                    ok = torch.where(
                        col(has_ok),
                        ~err[torch.where(has_ok, i3, torch.zeros_like(i3))],
                        torch.ones_like(e),
                    )
                else:
                    # no simple-var side anywhere in this op group: the
                    # plane space may be empty, so don't gather
                    ok = torch.ones_like(e)
                one = torch.ones_like(ld)
                cd = torch.where(col((i2 & 2) != 0), ld, one)
                cd = cd & torch.where(col((i2 & 4) != 0), rd, one)
                put(s, rows, e & ok, cd & ~e & ok, col((i2 & 1) != 0))
            elif op == R_PRES:
                ok = ~err[i0]
                put(s, rows, ok & prs[i0], ok & ~prs[i0], col(i2 == 1))
    return bt[last.to(torch.int64), torch.arange(r_n, device=dev)]


_ORDER = {
    R_CGT: torch.gt, R_CLT: torch.lt, R_CGE: torch.ge, R_CLE: torch.le,
}


def rules_eval_lowered_plain(steps, lits, meta, lit_ranks, num, sid, err,
                             prs):
    """Plain PyTorch version of `rules_eval_lowered`: the step records
    of `rules_lowering.lower_rules` (``steps`` ``[R, S', 4]``,
    ``lits`` ``[R, NL]``, ``meta`` ``[R]``) run as the kernel runs them,
    over the same planes as `rules_eval_plain`.  Returns the ``[R, W]``
    bool pass matrix."""
    n_rules = steps.shape[0]
    if n_rules > RULES_HOST_BLOCK:
        return torch.cat([
            rules_eval_lowered_plain(
                steps[k:k + RULES_HOST_BLOCK], lits[k:k + RULES_HOST_BLOCK],
                meta[k:k + RULES_HOST_BLOCK], lit_ranks, num, sid, err, prs)
            for k in range(0, n_rules, RULES_HOST_BLOCK)
        ])
    p, w = num.shape
    dev = num.device
    if p == 0:  # an empty plane space reads as "lookup ok, nothing there"
        num = torch.full((1, w), float("nan"), dtype=torch.float64,
                         device=dev)
        sid = torch.full((1, w), -1, dtype=torch.int32, device=dev)
        err = prs = torch.zeros((1, w), dtype=torch.bool, device=dev)
    top, k_num = num.shape[0] - 1, RULES_NUM_SLOTS
    rec = steps.to(torch.int64) & 0xFFFFFFFF
    n = meta.to(torch.int64) & 0xFF
    nv = torch.zeros((k_num + 1, n_rules, w), dtype=torch.float64,
                     device=dev)  # slot k_num: the clear register
    nd = torch.zeros((k_num + 1, n_rules, w), dtype=torch.bool, device=dev)
    bt = torch.zeros((32, n_rules, w), dtype=torch.bool, device=dev)
    bf = torch.zeros((32, n_rules, w), dtype=torch.bool, device=dev)
    bt[RULES_BOOL_TRUE] = True
    bf[RULES_BOOL_FALSE] = True

    def plane(x, idx):
        return x[idx.clamp(max=top)]

    def fetch(d, rows):
        kind, idx = d >> 16, d & 0xFFFF
        pv = plane(num, idx)
        lv = lits[rows, idx.clamp(max=lits.shape[1] - 1)][:, None]
        slot = idx.clamp(max=k_num)
        is_p, is_l = (kind == SRC_PLANE)[:, None], (kind == SRC_LIT)[:, None]
        v = torch.where(is_p, pv, torch.where(is_l, lv, nv[slot, rows]))
        return v, torch.where(is_p, ~torch.isnan(pv), is_l | nd[slot, rows])

    def order(mask, x, y):
        return (((mask & 1) != 0)[:, None] & (x < y)) | (
            ((mask & 2) != 0)[:, None] & (x == y)) | (
            ((mask & 4) != 0)[:, None] & (x > y))

    for s in range(steps.shape[1]):
        live = s < n
        ops = rec[:, s, 0] & 0xFF
        for op in torch.unique(ops[live]).tolist():
            rows = torch.nonzero(live & (ops == op)).flatten()
            w0, w1, w2, w3 = rec[rows, s].unbind(1)
            dst, fl = (w0 >> 8) & 0xFF, (w0 >> 16) & 0xFF
            neg = ((fl & 1) != 0)[:, None]  # the equalities' negate
            t = f = None
            if op == R_CGT:  # the four ordered compares, by their mask
                x, dx = fetch(w1, rows)
                y, dy = fetch(w2, rows)
                d = dx & dy
                c = order(fl, x, y)
                t, f = d & c, d & ~c
                rank = ((fl & CMP_RANK) != 0)[:, None]
                sl, sr = plane(sid, w3 & 0xFFFF), plane(sid, w3 >> 16)
                ds = rank & (sl >= 0) & (sr >= 0)
                cs = order(fl, sl, sr)
                t, f = t | (ds & cs), f | (ds & ~cs)
                neg = torch.zeros_like(neg)
            elif op == R_EQC:
                x, ld = fetch(w1, rows)
                y, rd = fetch(w2, rows)
                e = ld & rd & (x == y)
                ok = ~(((fl & EQ_OKP) != 0)[:, None] & plane(err, w3))
                cd = (ld | ((fl & 2) == 0)[:, None]) & (
                    rd | ((fl & 4) == 0)[:, None])
                t, f = e & ok, cd & ~e & ok
            elif op == R_EQVV:
                lp, rp = plane(num, w1), plane(num, w2)
                sl, sr = plane(sid, w1), plane(sid, w2)
                el, er = plane(err, w1), plane(err, w2)
                nul = ~el & ~plane(prs, w1) & ~er & ~plane(prs, w2)
                e = (lp == rp) | ((sl != -1) & (sl == sr)) | nul
                ok = ~el & ~er
                t, f = e & ok, ~e & ok
            elif op == R_EQSL:
                ok, v = ~plane(err, w1), plane(sid, w1)
                lid = lit_ranks[w2][:, None]
                t, f = ok & (v == lid), ok & (v != lid)
            elif op == R_PRES:
                ok, pr = ~plane(err, w1), plane(prs, w1)
                t, f = ok & pr, ok & ~pr
            elif op == R_BNOT:
                bt[dst, rows], bf[dst, rows] = bf[w1, rows], bt[w1, rows]
            elif op in (R_BAND, R_BOR):
                tl, fl_, tr, fr = (bt[w1, rows], bf[w1, rows], bt[w2, rows],
                                   bf[w2, rows])
                if op == R_BAND:
                    bt[dst, rows], bf[dst, rows] = tl & tr, fl_ | (tl & fr)
                else:
                    bt[dst, rows], bf[dst, rows] = tl | (fl_ & tr), fl_ & fr
            elif op == R_NNEG:
                x, d = fetch(w1, rows)
                nv[dst, rows], nd[dst, rows] = -x, d
            else:  # R_NADD .. R_NMOD
                lv, ld = fetch(w1, rows)
                rv, rd = fetch(w2, rows)
                d = ld & rd
                if op == R_NADD:
                    v = lv + rv
                elif op == R_NSUB:
                    v = lv - rv
                elif op == R_NMUL:
                    v = lv * rv
                elif op == R_NDIV:
                    nz = rv != 0
                    v = torch.where(nz, lv / torch.where(nz, rv, 1.0), 0.0)
                    d = d & nz
                else:  # div / mod: truncate both, then floor-divide
                    ta, tb = torch.trunc(lv), torch.trunc(rv)
                    nz = tb != 0
                    safe = torch.where(nz, tb, 1.0)
                    q = torch.floor(ta / safe)
                    v = q if op == R_NIDV else ta - q * safe
                    d = d & nz
                nv[dst, rows], nd[dst, rows] = v, d
            if t is not None:
                bt[dst, rows] = torch.where(neg, f, t)
                bf[dst, rows] = torch.where(neg, t, f)
    res = (meta.to(torch.int64) >> 8) & 0xFF
    return bt[res, torch.arange(n_rules, device=dev)]


# ------------------------------------------------- one rule's predicate
#
# K6's register program (`rules.predicate.lower_predicate`): numeric
# registers are (value, defined) pairs, boolean ones (T, F), as in the
# JAX package's `_eval`, whose numpy path this equals bit for bit
# (float64; each arithmetic step rounds once, as numpy does).

_P_ORDER = {
    P.P_CGT: torch.gt, P.P_CLT: torch.lt, P.P_CGE: torch.ge,
    P.P_CLE: torch.le,
}


def predicate_eval_plain(steps, lit, result: int, num, sid, err, lit_ids):
    """Plain PyTorch version of `predicate_eval_batch`: ``steps`` is
    ``[S, 8]`` (op, dst, a, b, c, d, flags, 0), ``lit`` ``[S]``,
    ``num``/``sid``/``err`` the ``[V, W]`` var lanes, ``lit_ids`` the
    ``[L]`` string-literal ids.  Returns the ``[W]`` bool verdicts."""
    w, dev = num.shape[1], num.device
    hv, nl, top = num.shape[0] - 1, lit_ids.shape[0], P.PRED_REGS - 1
    ids = lit_ids.tolist()
    zero = torch.zeros(w, dtype=torch.float64, device=dev)
    false = torch.zeros(w, dtype=torch.bool, device=dev)
    nv, nd = [zero] * P.PRED_REGS, [false] * P.PRED_REGS
    bt, bf = [false] * P.PRED_REGS, [false] * P.PRED_REGS

    def reg(x):
        return min(max(x, 0), top)

    def lane(x):
        return min(max(x, 0), hv)

    def put(dst, t, f, neg):
        bt[dst], bf[dst] = (f, t) if neg else (t, f)

    for (op, dst, a, b, c, d, flags, _), lv in zip(steps.tolist(),
                                                  lit.tolist()):
        dst, ra, rb = reg(dst), reg(a), reg(b)
        if op == P.P_NLOAD:
            v = num[lane(a)]
            nv[dst], nd[dst] = v, ~torch.isnan(v)
        elif op == P.P_NLIT:
            nv[dst] = torch.full((w,), lv, dtype=torch.float64, device=dev)
            nd[dst] = ~false
        elif op == P.P_NNEG:
            nv[dst], nd[dst] = -nv[ra], nd[ra]
        elif P.P_NADD <= op <= P.P_NMOD:
            x, y, ok = nv[ra], nv[rb], nd[ra] & nd[rb]
            if op == P.P_NADD:
                v = x + y
            elif op == P.P_NSUB:
                v = x - y
            elif op == P.P_NMUL:
                v = x * y
            elif op == P.P_NDIV:
                nz = y != 0
                v = torch.where(nz, x / torch.where(nz, y, 1.0), 0.0)
                ok = ok & nz
            else:  # div / mod: trunc both, then floor-divide
                ta, tb = torch.trunc(x), torch.trunc(y)
                nz = tb != 0
                safe = torch.where(nz, tb, 1.0)
                q = torch.floor(ta / safe)
                v = q if op == P.P_NIDV else ta - q * safe
                ok = ok & nz
            nv[dst], nd[dst] = v, ok
        elif op == P.P_BLIT:
            bt[dst], bf[dst] = (~false, false) if a == 1 else (false, ~false)
        elif op == P.P_BNOT:
            bt[dst], bf[dst] = bf[ra], bt[ra]
        elif op in (P.P_BAND, P.P_BOR):
            tl, fl, tr, fr = bt[ra], bf[ra], bt[rb], bf[rb]
            if op == P.P_BAND:
                bt[dst], bf[dst] = tl & tr, fl | (tl & fr)
            else:
                bt[dst], bf[dst] = tl | (fl & tr), fl & fr
        elif op in _P_ORDER:
            ok = nd[ra] & nd[rb]
            cmp = _P_ORDER[op](nv[ra], nv[rb])
            bt[dst], bf[dst] = ok & cmp, ok & ~cmp
        elif op == P.P_EQN:
            ld, rd = nd[ra], nd[rb]
            e = ld & rd & (nv[ra] == nv[rb])
            ok = ~false
            if c >= 0:
                ok = ok & ~err[lane(c)]
            if d >= 0:
                ok = ok & ~err[lane(d)]
            if c >= 0 and d >= 0:
                li = sid[lane(c)]
                e = e | ((li >= 0) & (li == sid[lane(d)]))
            cd = (ld if flags & 2 else ~false) & (rd if flags & 4 else ~false)
            put(dst, e & ok, cd & ~e & ok, flags & 1)
        elif op == P.P_EQS:
            lid = ids[min(max(b, 0), nl - 1)] if nl else -2
            ok = ~err[lane(a)]
            v = sid[lane(a)]
            put(dst, ok & (v == lid), ok & (v != lid), flags & 1)
    return bt[reg(result)].clone()


# ------------------------------------------------------------ checks


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(
            f"{name} is on {t.device}, expected {device} like the others"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_match(fp_rows, node_rows, salt, tokens, lengths, dollar,
                 f_width: int, m_cap: int) -> int:
    dev = tokens.device
    _check(tokens, "tokens", torch.int32, 2, dev)
    _check(fp_rows, "fp_rows", torch.int32, 2, dev)
    _check(node_rows, "node_rows", torch.int32, 2, dev)
    _check(lengths, "lengths", torch.int32, 1, dev)
    _check(dollar, "dollar", torch.bool, 1, dev)
    nb = fp_rows.shape[0]
    if fp_rows.shape[1] != 2 * BUCKET or nb < 1 or nb & (nb - 1):
        raise ValueError(
            f"fp_rows must be [power of two, {2 * BUCKET}], "
            f"got {tuple(fp_rows.shape)}"
        )
    if node_rows.shape[1] != 8 or node_rows.shape[0] < 1:
        raise ValueError(f"node_rows must be [N>=1, 8], got "
                         f"{tuple(node_rows.shape)}")
    b = tokens.shape[0]
    if b < 1 or tokens.shape[1] < 1:
        raise ValueError(f"tokens must be [B>=1, L>=1], got "
                         f"{tuple(tokens.shape)}")
    if lengths.shape[0] != b or dollar.shape[0] != b:
        raise ValueError("tokens, lengths and dollar disagree on B")
    if not 1 <= f_width <= F_MAX:
        raise ValueError(f"f_width must be in [1, {F_MAX}], got {f_width}")
    if not 1 <= m_cap <= M_MAX:
        raise ValueError(f"m_cap must be in [1, {M_MAX}], got {m_cap}")
    salt = int(salt)
    if not 0 <= salt <= _M32:
        raise ValueError(f"salt must be a uint32, got {salt}")
    return salt


# ----------------------------------------------------------- wrappers


def match_batch(fp_rows, node_rows, salt, tokens, lengths, dollar, *,
                f_width: int, m_cap: int):
    """Match a topic batch.  Returns ``(codes [B, m_cap] int32 (-1 pad),
    counts [B] int32, overflow [B] bool)``; an overflowed row's codes
    are incomplete and the caller must re-match that topic on the host.

    Replaces ``emqx_tpu/ops/match_kernel.py`` ``match_batch``."""
    salt = _check_match(fp_rows, node_rows, salt, tokens, lengths, dollar,
                        f_width, m_cap)
    if tokens.device.type == "cpu":
        return match_batch_plain(fp_rows, node_rows, salt, tokens, lengths,
                                 dollar, f_width=f_width, m_cap=m_cap)
    from . import _kernels

    b = tokens.shape[0]
    codes = torch.empty((b, m_cap), dtype=torch.int32, device=tokens.device)
    counts = torch.empty(b, dtype=torch.int32, device=tokens.device)
    ovf = torch.empty(b, dtype=torch.bool, device=tokens.device)
    _kernels.match_rows(fp_rows, node_rows, salt, tokens, lengths, dollar,
                        f_width, m_cap, codes, counts, ovf)
    match_batch.launches += 1
    return codes, counts, ovf


def match_batch_compact(fp_rows, node_rows, salt, tokens, lengths, dollar,
                        *, f_width: int, m_cap: int, c_cap: int):
    """`match_batch` with a compacted output.  Returns ``(flat [c_cap]
    int32, counts [B] int16, total [1] int32)``: all codes row-major,
    rows abutting at offsets ``cumsum(counts)``; per-row counts,
    NEGATIVE (-n-1) when the row overflowed ``f_width``/``m_cap`` and
    must be host-rematched; ``total`` is the sum of the clipped counts
    BEFORE the ``c_cap`` clip — ``total > c_cap`` means ``flat``
    dropped codes and the caller must rerun on `match_batch`.

    Replaces ``emqx_tpu/ops/match_kernel.py`` ``match_batch_compact``."""
    salt = _check_match(fp_rows, node_rows, salt, tokens, lengths, dollar,
                        f_width, m_cap)
    if c_cap < 1:
        raise ValueError(f"c_cap must be >= 1, got {c_cap}")
    if tokens.device.type == "cpu":
        return match_batch_compact_plain(
            fp_rows, node_rows, salt, tokens, lengths, dollar,
            f_width=f_width, m_cap=m_cap, c_cap=c_cap,
        )
    from . import _kernels

    b, levels = tokens.shape
    dev = tokens.device
    flat = torch.empty(c_cap, dtype=torch.int32, device=dev)
    counts_out = torch.empty(b, dtype=torch.int16, device=dev)
    total = torch.empty(1, dtype=torch.int32, device=dev)
    scratch = torch.empty(
        _kernels.compact_scratch_words(b, levels, f_width, m_cap),
        dtype=torch.int64, device=dev)
    _kernels.match_compact(fp_rows, node_rows, salt, tokens, lengths,
                           dollar, f_width, m_cap, c_cap, flat, counts_out,
                           total, scratch)
    match_batch_compact.launches += 1
    return flat, counts_out, total


_DECIDE_DTYPES = (
    ("oa_qos", torch.int8), ("oa_nl", torch.bool), ("oa_rap", torch.bool),
    ("oa_subid", torch.bool), ("opts_rows", torch.int32),
    ("client_rows", torch.int32), ("msg_idx", torch.int32),
    ("m_qos", torch.int8), ("m_retain", torch.bool),
    ("m_from_row", torch.int32),
)


def _check_decide(named, n, r, b, dev) -> None:
    for t, (name, dtype) in named:
        _check(t, name, dtype, 1, dev)
    if n and (r == 0 or b == 0):
        raise ValueError("deliveries index empty opts/message columns")


def decide_batch(oa_qos, oa_nl, oa_rap, oa_subid, opts_rows, client_rows,
                 msg_idx, m_qos, m_retain, m_from_row):
    """The window's packed decision column, one ``uint8`` per delivery
    (bits 0-1 min QoS, 2-3 max QoS, 4 no-local drop, 5 retain on the
    wire, 6 subscription identifier present).  ``oa_*`` are ``[R]``
    per-opts-row columns, ``opts_rows``/``client_rows``/``msg_idx``
    ``[N]`` per delivery, ``m_*`` ``[B]`` per message.  An opts row
    outside [0, R) or a message index outside [0, B) raises IndexError;
    on the card that check is the kernel's (`decide_packed`), read with
    its 4 B error word.

    Replaces ``emqx_tpu/ops/match_kernel.py`` ``decide_batch``."""
    args = (oa_qos, oa_nl, oa_rap, oa_subid, opts_rows, client_rows,
            msg_idx, m_qos, m_retain, m_from_row)
    dev = opts_rows.device
    r, n, b = oa_qos.shape[0], opts_rows.shape[0], m_qos.shape[0]
    _check_decide(zip(args, _DECIDE_DTYPES), n, r, b, dev)
    if any(t.shape[0] != r for t in (oa_nl, oa_rap, oa_subid)):
        raise ValueError("oa_* columns disagree on R")
    if client_rows.shape[0] != n or msg_idx.shape[0] != n:
        raise ValueError("per-delivery columns disagree on N")
    if m_retain.shape[0] != b or m_from_row.shape[0] != b:
        raise ValueError("per-message columns disagree on B")
    if dev.type == "cpu":
        if n:
            lo_o, hi_o = torch.aminmax(opts_rows)
            lo_m, hi_m = torch.aminmax(msg_idx)
            if lo_o < 0 or hi_o >= r:
                raise IndexError(f"opts_rows out of range [0, {r}): "
                                 f"[{int(lo_o)}, {int(hi_o)}]")
            if lo_m < 0 or hi_m >= b:
                raise IndexError(f"msg_idx out of range [0, {b}): "
                                 f"[{int(lo_m)}, {int(hi_m)}]")
        return decide_batch_plain(*args)
    out, error = decide_packed(pack_opts(*args[:4]), *args[4:])
    if n and int(error.item()):
        raise IndexError(f"opts_rows outside [0, {r}) or msg_idx outside "
                         f"[0, {b})")
    return out


def decide_packed(oa, opts_rows, client_rows, msg_idx, m_qos, m_retain,
                  m_from_row):
    """`decide_batch` from the options packed one ``int32`` word a row
    (`pack_opts`; ``oa`` ``[R]``), with its range check fused in.
    Returns ``(decisions [N] uint8, error [1] int32)``: ``error`` is
    nonzero when some delivery's opts row is outside [0, R) or its
    message index outside [0, B); such a delivery gets the byte 0, and
    nothing outside the columns is read.  Nothing here synchronises:
    the caller reads ``error`` with the decisions.

    Replaces ``emqx_tpu/ops/match_kernel.py`` ``decide_batch``."""
    dev = opts_rows.device
    r, n, b = oa.shape[0], opts_rows.shape[0], m_qos.shape[0]
    _check_decide(zip((oa, opts_rows, client_rows, msg_idx, m_qos,
                       m_retain, m_from_row),
                      (("oa", torch.int32),) + _DECIDE_DTYPES[4:]),
                  n, r, b, dev)
    if client_rows.shape[0] != n or msg_idx.shape[0] != n:
        raise ValueError("per-delivery columns disagree on N")
    if m_retain.shape[0] != b or m_from_row.shape[0] != b:
        raise ValueError("per-message columns disagree on B")
    if dev.type == "cpu":
        return decide_packed_plain(oa, opts_rows, client_rows, msg_idx,
                                   m_qos, m_retain, m_from_row)
    from . import _kernels

    out = torch.empty(n, dtype=torch.uint8, device=dev)
    error = torch.empty(1, dtype=torch.int32, device=dev)
    _kernels.decide(oa, opts_rows, client_rows, msg_idx, m_qos, m_retain,
                    m_from_row, out, error)
    if n:
        decide_packed.launches += 1
    return out, error


_RULES_PROGRAM = (
    ("code", torch.int32), ("a0", torch.int32), ("a1", torch.int32),
    ("a2", torch.int32), ("a3", torch.int32), ("litn", torch.float64),
)
_RULES_PLANES = (
    ("num", torch.float64), ("sid", torch.int32), ("err", torch.bool),
    ("prs", torch.bool),
)


def _check_planes(num, sid, err, prs, lit_ranks, dev) -> None:
    for t, (name, dtype) in zip((num, sid, err, prs), _RULES_PLANES):
        _check(t, name, dtype, 2, dev)
    _check(lit_ranks, "lit_ranks", torch.int32, 1, dev)
    if any(t.shape != num.shape for t in (sid, err, prs)):
        raise ValueError("num, sid, err and prs disagree on [P, W]")


def rules_eval_batch(code, a0, a1, a2, a3, litn, lit_ranks, last, num, sid,
                     err, prs):
    """The rules x window pass matrix, ``[R, W]`` bool: each rule's
    stacked WHERE program (``code``/``a0..a3`` int32 and ``litn``
    float64, ``[R, S]`` with ``S <= MAX_STEPS``; ``last`` int32 ``[R]``)
    over the window's column planes (``num`` float64, ``sid`` int32,
    ``err``/``prs`` bool, ``[P, W]``), with ``lit_ranks`` int32 ``[L]``.
    Computed in float64: equal, bit for bit, to the JAX package's
    numpy twin on every window.  On the card the program is lowered on
    every call (`rules_lowering.lower_rules`, which refuses an
    operand the kernel would have to check) and run by
    `rules_eval_lowered`; the engine lowers once per rules rev.

    Replaces ``emqx_tpu/ops/match_kernel.py`` ``rules_eval_batch``."""
    dev = num.device
    prog = (code, a0, a1, a2, a3, litn)
    for t, (name, dtype) in zip(prog, _RULES_PROGRAM):
        _check(t, name, dtype, 2, dev)
    _check_planes(num, sid, err, prs, lit_ranks, dev)
    _check(last, "last", torch.int32, 1, dev)
    r, s = code.shape
    if any(t.shape != code.shape for t in prog):
        raise ValueError("code, a0..a3 and litn disagree on [R, S]")
    if last.shape[0] != r:
        raise ValueError("last disagrees with code on R")
    if not 1 <= s <= MAX_STEPS:
        raise ValueError(f"programs must have 1..{MAX_STEPS} steps, got {s}")
    if dev.type == "cpu":
        return rules_eval_plain(code, a0, a1, a2, a3, litn, lit_ranks, last,
                                num, sid, err, prs)
    low = lower_rules(
        *(t.cpu().numpy() for t in (code, a0, a1, a2, a3, litn, last)), dev,
        n_lits=lit_ranks.shape[0])
    return rules_eval_lowered(low, lit_ranks, num, sid, err, prs)


def rules_eval_lowered(prog: LoweredRules, lit_ranks, num, sid, err, prs):
    """The rules x window pass matrix, ``[R, W]`` bool, of a program
    lowered by `rules_lowering.lower_rules` over the window's
    column planes (as `rules_eval_batch` takes them).  Equal, bit for
    bit, to `rules_eval_batch` of the stacked program.

    Replaces ``emqx_tpu/ops/match_kernel.py`` ``rules_eval_batch``."""
    dev = num.device
    _check(prog.steps, "steps", torch.int32, 3, dev)
    _check(prog.lits, "lits", torch.float64, 2, dev)
    _check(prog.meta, "meta", torch.int32, 1, dev)
    _check_planes(num, sid, err, prs, lit_ranks, dev)
    r, width, four = prog.steps.shape
    if four != 4 or prog.lits.shape[0] != r or prog.meta.shape[0] != r \
            or prog.lits.shape[1] < 1 or not 1 <= width <= MAX_STEPS:
        raise ValueError("steps, lits and meta must be [R, 1..MAX_STEPS, "
                         "4], [R, NL>=1] and [R]")
    if lit_ranks.shape[0] < prog.lits_needed:
        raise ValueError(f"the program reads {prog.lits_needed} string "
                         f"literals, lit_ranks has {lit_ranks.shape[0]}")
    if num.shape[0] > PLANE_MAX + 1:
        raise ValueError(f"at most {PLANE_MAX + 1} planes, got "
                         f"{num.shape[0]}")
    if dev.type == "cpu":
        return rules_eval_lowered_plain(prog.steps, prog.lits, prog.meta,
                                        lit_ranks, num, sid, err, prs)
    from . import _kernels

    out = torch.empty((r, num.shape[1]), dtype=torch.bool, device=dev)
    if out.numel():
        _kernels.rules_eval(prog.steps, prog.lits, prog.meta, lit_ranks,
                            num, sid, err, prs, out)
        rules_eval_lowered.launches += 1
    return out


def sharded_match_local(fp_rows, node_rows, salts, tokens, lengths, dollar,
                        *, f_width: int, m_cap: int):
    """Match a topic batch against K automaton shards on one device:
    stacked ``fp_rows [K, nb, 2*BUCKET]`` and ``node_rows [K, N, 8]``
    int32 of one common geometry, ``salts [K]`` uint32.  Returns
    ``(codes [K, B, m_cap] int32, counts [K, B] int32, overflow [K, B]
    bool, total [B] int32)``: shard k's `match_batch` outputs, and each
    topic's count summed over the shards.

    Replaces the per-device body of ``emqx_tpu/parallel/sharded.py``
    ``sharded_match`` (its shard_map of ``match_batch`` and the psum of
    the counts over the ``sub`` axis)."""
    dev = tokens.device
    _check(fp_rows, "fp_rows", torch.int32, 3, dev)
    _check(node_rows, "node_rows", torch.int32, 3, dev)
    _check(salts, "salts", torch.uint32, 1, dev)
    k = fp_rows.shape[0]
    if k < 1 or node_rows.shape[0] != k or salts.shape[0] != k:
        raise ValueError("fp_rows, node_rows and salts disagree on K >= 1")
    _check_match(fp_rows[0], node_rows[0], 0, tokens, lengths, dollar,
                 f_width, m_cap)
    if dev.type == "cpu":
        return sharded_match_plain(fp_rows, node_rows, salts, tokens,
                                   lengths, dollar, f_width=f_width,
                                   m_cap=m_cap)
    from . import _kernels

    b = tokens.shape[0]
    codes = torch.empty((k, b, m_cap), dtype=torch.int32, device=dev)
    counts = torch.empty((k, b), dtype=torch.int32, device=dev)
    ovf = torch.empty((k, b), dtype=torch.bool, device=dev)
    total = torch.zeros(b, dtype=torch.int32, device=dev)
    _kernels.sharded_match_rows(fp_rows, node_rows, salts, tokens, lengths,
                                dollar, f_width, m_cap, codes, counts, ovf,
                                total)
    sharded_match_local.launches += 1
    return codes, counts, ovf, total


def predicate_eval_batch(steps, lit, result: int, num, sid, err, lit_ids,
                         *, slots: int = P.PRED_REGS):
    """One rule's WHERE over a batch: the register program ``steps``
    (int32 ``[S, 8]``) and ``lit`` (float64 ``[S]``) of
    `rules.predicate.lower_predicate`, result register ``result``, over
    the var lanes ``num`` (float64), ``sid`` (int32) and ``err`` (bool),
    ``[V, W]``, with the string-literal ids ``lit_ids`` (int32 ``[L]``).
    Returns the ``[W]`` bool verdicts.  Computed in float64: equal, bit
    for bit, to the JAX package's numpy path.  Operand indices are not
    range-checked on the card (that would cost a host sync):
    `state.predicate_program_from_code` checks a program on upload, and
    counts ``slots``, the numeric registers it names (the card runs the
    smallest kernel instance that holds them; the default holds any).

    Replaces ``emqx_tpu/rules/predicate.py``
    ``PredicateProgram.eval_batch(use_jax=True)``."""
    dev = num.device
    _check(steps, "steps", torch.int32, 2, dev)
    _check(lit, "lit", torch.float64, 1, dev)
    _check(num, "num", torch.float64, 2, dev)
    _check(sid, "sid", torch.int32, 2, dev)
    _check(err, "err", torch.bool, 2, dev)
    _check(lit_ids, "lit_ids", torch.int32, 1, dev)
    s = steps.shape[0]
    if s < 1 or steps.shape[1] != 8 or lit.shape[0] != s:
        raise ValueError("steps must be [S>=1, 8] with a [S] literal row")
    if sid.shape != num.shape or err.shape != num.shape or num.shape[0] < 1:
        raise ValueError("num, sid and err must share one [V>=1, W] shape")
    if not 0 <= result < P.PRED_REGS:
        raise ValueError(f"result must be a register in [0, {P.PRED_REGS})")
    if not 0 <= slots <= P.PRED_REGS:
        raise ValueError(f"slots must be in [0, {P.PRED_REGS}], got {slots}")
    if dev.type == "cpu":
        return predicate_eval_plain(steps, lit, result, num, sid, err,
                                    lit_ids)
    from . import _kernels

    out = torch.empty(num.shape[1], dtype=torch.bool, device=dev)
    if out.numel():
        _kernels.predicate_eval(steps, lit, result, num, sid, err, lit_ids,
                                slots, out)
        predicate_eval_batch.launches += 1
    return out


match_batch.launches = 0
match_batch_compact.launches = 0
decide_packed.launches = 0
rules_eval_lowered.launches = 0
sharded_match_local.launches = 0
predicate_eval_batch.launches = 0
KERNELS = (match_batch_compact, match_batch, decide_packed,
           rules_eval_lowered, sharded_match_local, predicate_eval_batch)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launches() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
