"""Batched wildcard match and per-delivery decide: wrappers, CUDA
launches and their plain PyTorch versions.

Three functions carry the publish path on the device:

  * `match_batch_compact` — the frontier scan of a ``[B, L]`` token
    batch through the trie automaton (`automaton.py`), with the match
    codes compacted into one flat buffer.  Every publish window runs it.
  * `match_batch` — the same scan with a dense ``[B, m_cap]`` output;
    the engine reruns a window on it when the compact buffer clipped.
  * `decide_batch` — one packed decision byte per delivery: effective
    QoS (both upgrade variants), the no-local drop, retain-as-published
    and subscription-identifier presence.

Each wrapper dispatches on the device of the tensors it is given: CPU
tensors run the plain PyTorch version in this module, CUDA tensors
launch the hand-written kernel in ``csrc/match_kernels.cu`` (built and
bound by `_kernels.py`) or raise.  Each wrapper counts its kernel
launches in its ``launches`` attribute.

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

from .automaton import BUCKET
from .dictionary import PLUS_TOK, SENTINEL

SENT = int(SENTINEL)
F_MAX = 16  # frontier width the kernel's per-thread arrays hold
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

    b = tokens.shape[0]
    dev = tokens.device
    codes = torch.empty((b, m_cap), dtype=torch.int32, device=dev)
    counts = torch.empty(b, dtype=torch.int32, device=dev)
    ovf = torch.empty(b, dtype=torch.bool, device=dev)
    row_start = torch.empty(b, dtype=torch.int32, device=dev)
    flat = torch.empty(c_cap, dtype=torch.int32, device=dev)
    counts_out = torch.empty(b, dtype=torch.int16, device=dev)
    total = torch.empty(1, dtype=torch.int32, device=dev)
    _kernels.match_rows(fp_rows, node_rows, salt, tokens, lengths, dollar,
                        f_width, m_cap, codes, counts, ovf)
    _kernels.compact(codes, counts, ovf, m_cap, c_cap, row_start, total,
                     flat, counts_out)
    match_batch_compact.launches += 1
    return flat, counts_out, total


_DECIDE_DTYPES = (
    ("oa_qos", torch.int8), ("oa_nl", torch.bool), ("oa_rap", torch.bool),
    ("oa_subid", torch.bool), ("opts_rows", torch.int32),
    ("client_rows", torch.int32), ("msg_idx", torch.int32),
    ("m_qos", torch.int8), ("m_retain", torch.bool),
    ("m_from_row", torch.int32),
)


def decide_batch(oa_qos, oa_nl, oa_rap, oa_subid, opts_rows, client_rows,
                 msg_idx, m_qos, m_retain, m_from_row):
    """The window's packed decision column, one ``uint8`` per delivery
    (bits 0-1 min QoS, 2-3 max QoS, 4 no-local drop, 5 retain on the
    wire, 6 subscription identifier present).  ``oa_*`` are ``[R]``
    per-opts-row columns, ``opts_rows``/``client_rows``/``msg_idx``
    ``[N]`` per delivery, ``m_*`` ``[B]`` per message.

    Replaces ``emqx_tpu/ops/match_kernel.py`` ``decide_batch``."""
    args = (oa_qos, oa_nl, oa_rap, oa_subid, opts_rows, client_rows,
            msg_idx, m_qos, m_retain, m_from_row)
    dev = opts_rows.device
    for t, (name, dtype) in zip(args, _DECIDE_DTYPES):
        _check(t, name, dtype, 1, dev)
    r, n, b = oa_qos.shape[0], opts_rows.shape[0], m_qos.shape[0]
    if any(t.shape[0] != r for t in (oa_nl, oa_rap, oa_subid)):
        raise ValueError("oa_* columns disagree on R")
    if client_rows.shape[0] != n or msg_idx.shape[0] != n:
        raise ValueError("per-delivery columns disagree on N")
    if m_retain.shape[0] != b or m_from_row.shape[0] != b:
        raise ValueError("per-message columns disagree on B")
    if n:
        if r == 0 or b == 0:
            raise ValueError("deliveries index empty opts/message columns")
        lo_o, hi_o = torch.aminmax(opts_rows)
        lo_m, hi_m = torch.aminmax(msg_idx)
        lo_o, hi_o, lo_m, hi_m = torch.stack(
            [lo_o, hi_o, lo_m, hi_m]).tolist()
        if lo_o < 0 or hi_o >= r:
            raise IndexError(f"opts_rows out of range [0, {r}): "
                             f"[{lo_o}, {hi_o}]")
        if lo_m < 0 or hi_m >= b:
            raise IndexError(f"msg_idx out of range [0, {b}): "
                             f"[{lo_m}, {hi_m}]")
    if dev.type == "cpu":
        return decide_batch_plain(*args)
    from . import _kernels

    out = torch.empty(n, dtype=torch.uint8, device=dev)
    if n:
        _kernels.decide(*args, out)
        decide_batch.launches += 1
    return out


match_batch.launches = 0
match_batch_compact.launches = 0
decide_batch.launches = 0
KERNELS = (match_batch_compact, match_batch, decide_batch)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launches() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
