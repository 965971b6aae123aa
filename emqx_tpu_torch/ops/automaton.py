"""Array-form trie automaton: the device-resident wildcard index.

Result-equivalent to a wildcard route index, laid out for batched
matching with one wide row gather per lookup:

  * literal edges -> a single-probe bucketed hash table keyed by a
    32-bit *fingerprint* of (node, token): one bucket = one
    ``[2*BUCKET]`` int32 row (8 fingerprints, 8 children, 64 B), so a
    lookup is ONE row gather + an 8-wide compare.
  * ``+`` edges, ``#``/exact terminal flags AND each node's unique
    incoming edge (parent, token) -> one ``[N, 8]`` node row, one
    gather per frontier lane per level.  The kernel re-checks every
    fingerprint candidate against the incoming edge (parent must sit in
    the previous frontier, token must be the level token or '+'), which
    is the literal trie-transition condition — a colliding fingerprint
    can therefore never create a false match.
  * terminal -> filter-id fan-out stays host-side CSR, keeping device
    output compressed.

The build is vectorized numpy, with its filter encode and its sorts
(argsort, unique per depth) in C++ (`TokenDict.encode_filters_into`,
`sortutil_native`) unless ``native=False`` asks for the Python and
numpy referees.  Its tables are bit-identical to the JAX package's
build for the same filters, either way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from .dictionary import PAD_TOK, PLUS_TOK, SENTINEL, TokenDict, encode_filter
from .sortutil_native import sorts

# Tokens are >= PAD_TOK; shift keeps packed keys non-negative.
_TOK_SHIFT = 16

BUCKET = 8  # hash-table entries per bucket row


def mix32(a, b):
    """Hash two uint32 numpy arrays -> uint32 (wrapping arithmetic).
    The match kernels repeat this hash bit for bit: the plain torch
    version in int64 masked to 32 bits (`match_kernel.mix32_i64`), the
    CUDA kernel in native ``uint32``."""
    x = a * np.uint32(0x9E3779B1)
    y = b * np.uint32(0x85EBCA6B) + np.uint32(0x165667B1)
    h = x ^ y
    h = h ^ (h >> np.uint32(15))
    h = h * np.uint32(0x2C1B3C6D)
    h = h ^ (h >> np.uint32(12))
    return h


def edge_fp(parents, toks, salt):
    """32-bit fingerprint of a literal edge key; independent of the
    bucket hash (argument order swapped + salt folded differently), so
    same-bucket keys collide with probability ~2^-32, and those
    collisions are caught at build time and killed by the kernel's
    edge verification at match time.

    ``salt`` is a plain int."""
    s2 = np.uint32((int(salt) * 0x9E3779B1) & 0xFFFFFFFF)
    return mix32(toks.astype(np.uint32), parents.astype(np.uint32) ^ s2)


def bucket_hash(parents, toks, salt):
    """Bucket index hash (before masking with n_buckets - 1)."""
    return mix32(
        parents.astype(np.uint32) + np.uint32(salt), toks.astype(np.uint32)
    )


@dataclass
class Automaton:
    """Immutable snapshot of the wildcard-filter set in array form."""

    # single-probe fingerprint hash table [n_buckets, 2*BUCKET]:
    # row = [fp x8 | child x8]; empty slots hold child = -1, which the
    # lookup filters on, so an fp that happens to equal the -1 filler
    # is still unambiguous
    fp_rows: np.ndarray
    # per-node rows [n_nodes, 8]: (plus_child|SENTINEL, hash_flag,
    # exact_flag, 0, edge_parent|-1, edge_tok|-1, 0, 0) — cols 4-5 are
    # the node's unique incoming edge, used for exact verification
    node_rows: np.ndarray
    # CSR keyed by match code (node*2 | is_hash) -> positions into
    # `filters`; device-gatherable so code->fid expansion never loops
    # on the host (the round-1 bottleneck).
    code_off: np.ndarray  # [2*n_nodes + 1] int32
    code_idx: np.ndarray  # [n_filters] int32
    # build metadata
    filters: List[Tuple[object, Tuple[str, ...]]]  # (fid, words) as built
    salt: int  # hash salt (bumped when a same-bucket fp collision hits)
    max_levels: int
    kernel_levels: int  # deepest filter body + 1: scan length needed
    n_nodes: int

    def expand(self, val: int) -> Sequence[int]:
        """Device match code (node*2 | kind) -> filter positions."""
        return self.code_idx[self.code_off[val] : self.code_off[val + 1]]

    def device_arrays(self) -> Tuple[np.ndarray, ...]:
        return (self.fp_rows, self.node_rows, np.uint32(self.salt))


def expand_codes_host(
    code_off: np.ndarray,
    code_idx: np.ndarray,
    codes: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized host-side expansion of a ``[B, M]`` code matrix (-1
    padded) into flat ``(topic_row, filter_position)`` pairs.

    This is the "device returns compressed (filter-ID, count) form,
    host expands lazily" strategy (SURVEY §7): the device ships only
    the compact per-topic code list; the fan-out amplification happens
    here with pure numpy — no Python loop per match."""
    rows, cols = np.nonzero(codes >= 0)
    c = codes[rows, cols].astype(np.int64)
    starts = code_off[c].astype(np.int64)
    lens = code_off[c + 1].astype(np.int64) - starts
    total = int(lens.sum())
    seg_end = np.cumsum(lens)
    within = np.arange(total, dtype=np.int64) - np.repeat(seg_end - lens, lens)
    src = np.repeat(starts, lens) + within
    return np.repeat(rows, lens), code_idx[src]


def expand_codes_dedup(
    code_off: np.ndarray,
    code_idx: np.ndarray,
    codes_u: np.ndarray,
    inv: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """`expand_codes_host` for a DEDUPLICATED batch: ``codes_u`` holds
    one row per unique topic, ``inv`` maps each original batch row to
    its unique row.  Zipf-heavy publish windows repeat hot topics
    (~50% dups at bench scale), and matching each unique topic once
    halves both device compute and the device->host code transfer —
    the full-path bottleneck on links slower than PCIe.  The dup
    fan-back happens here with pure numpy."""
    rows_u, pos = expand_codes_host(code_off, code_idx, codes_u)
    n_uniq = codes_u.shape[0]
    counts_u = np.bincount(rows_u, minlength=n_uniq)
    off_u = np.zeros(n_uniq + 1, np.int64)
    np.cumsum(counts_u, out=off_u[1:])
    cnt = counts_u[inv]  # per original row
    total = int(cnt.sum())
    rows_o = np.repeat(np.arange(len(inv), dtype=np.int64), cnt)
    seg_end = np.cumsum(cnt)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        seg_end - cnt, cnt
    )
    src = np.repeat(off_u[inv], cnt) + within
    return rows_o, pos[src]


def expand_codes_flat(
    code_off: np.ndarray,
    code_idx: np.ndarray,
    flat: np.ndarray,
    counts_u: np.ndarray,
    inv: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """`expand_codes_dedup` for the COMPACT kernel layout
    (`match_batch_compact`): ``flat`` holds the valid codes row-major,
    ``counts_u`` the per-unique-row code count, ``inv`` maps original
    batch rows to unique rows.  No dense-matrix ``nonzero`` scan — the
    codes arrive pre-compacted from the device."""
    n_uniq = len(counts_u)
    total_codes = int(counts_u.sum())
    c = flat[:total_codes].astype(np.int64)
    starts = code_off[c].astype(np.int64)
    lens = code_off[c + 1].astype(np.int64) - starts
    total = int(lens.sum())
    seg_end = np.cumsum(lens)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        seg_end - lens, lens
    )
    src = np.repeat(starts, lens) + within
    pos = code_idx[src]
    # per-unique-row fid counts: sum of lens over each row's code span
    code_rows = np.repeat(
        np.arange(n_uniq, dtype=np.int64), counts_u
    )
    fid_counts_u = np.bincount(code_rows, weights=lens,
                               minlength=n_uniq).astype(np.int64)
    off_u = np.zeros(n_uniq + 1, np.int64)
    np.cumsum(fid_counts_u, out=off_u[1:])
    # fan back to original (possibly duplicated) batch rows
    cnt = fid_counts_u[inv]
    total_o = int(cnt.sum())
    rows_o = np.repeat(np.arange(len(inv), dtype=np.int64), cnt)
    seg_end_o = np.cumsum(cnt)
    within_o = np.arange(total_o, dtype=np.int64) - np.repeat(
        seg_end_o - cnt, cnt
    )
    src_o = np.repeat(off_u[inv], cnt) + within_o
    return rows_o, pos[src_o]


def _build_fp_table(
    parents: np.ndarray,
    toks: np.ndarray,
    children: np.ndarray,
    load: float,
    min_buckets: int = 4,
    native: bool = True,
) -> Tuple[np.ndarray, int]:
    """Vectorized single-probe fingerprint-table build.

    Every key lands in its h0 bucket (a bucket overflow grows the
    table; a same-bucket fingerprint collision bumps the salt), so the
    kernel does exactly one row gather per lookup.  Returns
    ``(rows [nb, 2*BUCKET], salt)``."""
    argsort, unique_inverse = sorts(native)
    e = len(parents)
    nb = 4
    while nb < min_buckets or nb * BUCKET * load < max(e, 1):
        nb *= 2
    salt = 0
    while True:
        h0 = bucket_hash(parents, toks, salt)
        fp = edge_fp(parents, toks, salt)
        b = (h0 & np.uint32(nb - 1)).astype(np.int64)
        order = argsort(b)
        bs = b[order]
        # bs is sorted: derive run starts/counts without np.unique's
        # internal (GIL-held) re-sort
        if e:
            change = np.empty(e, bool)
            change[0] = True
            np.not_equal(bs[1:], bs[:-1], out=change[1:])
            start = np.flatnonzero(change)
            cnts = np.diff(np.append(start, e))
        else:
            start = cnts = np.zeros(0, np.int64)
        if cnts.max(initial=0) > BUCKET:
            nb *= 2
            continue
        # at most one stored entry per (bucket, fp): required both for
        # lookup uniqueness and for the kernel's dedup-then-verify step
        key64 = (
            fp[order].astype(np.int64) | (bs << 32)
        )
        if len(unique_inverse(key64)[0]) != e:
            salt += 1
            continue
        rank = np.arange(e, dtype=np.int64) - np.repeat(start, cnts)
        rows = np.full((nb, 2 * BUCKET), -1, np.int32)
        rows[bs, rank] = fp[order].astype(np.int32)
        rows[bs, BUCKET + rank] = children[order]
        return rows, salt


def encode_filters(
    filters: Sequence[Tuple[object, Tuple[str, ...]]],
    tdict: TokenDict,
    max_levels: int = 16,
    native: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List]:
    """Encode ``(fid, words)`` pairs into build-input arrays: in one
    native call (`TokenDict.encode_filters_into`), or with
    ``native=False`` through the per-filter Python loop, which gives
    the same arrays and token ids.

    Split from assembly so a caller can keep the arrays of an existing
    build and re-encode only its delta.
    """
    nf = len(filters)
    mat = np.full((nf, max_levels), PAD_TOK, np.int32)
    blen = np.zeros(nf, np.int32)
    is_hash = np.zeros(nf, bool)
    flist: List[Tuple[object, Tuple[str, ...]]] = list(filters)
    if native:
        tdict.encode_filters_into(flist, max_levels, mat, blen, is_hash)
        return mat, blen, is_hash, flist
    for i, (fid, ws) in enumerate(flist):
        body, hsh = encode_filter(tdict, ws)
        if len(body) > max_levels:
            raise ValueError(f"filter deeper than max_levels={max_levels}: {ws}")
        mat[i, : len(body)] = body
        blen[i] = len(body)
        is_hash[i] = hsh
    return mat, blen, is_hash, flist


def build_automaton(
    filters: Sequence[Tuple[object, Tuple[str, ...]]],
    tdict: TokenDict,
    max_levels: int = 16,
    load: float = 0.25,
    hash_buckets: int = 0,
    native: bool = True,
) -> Automaton:
    """Build the automaton from ``(fid, filter_words)`` pairs.

    ``hash_buckets`` forces a minimum bucket count so multiple shard
    automata can share one traced kernel shape (stacked over a mesh).
    ``native`` selects the C++ encoder and sorts (the default) or their
    Python and numpy referees; the tables are the same.
    """
    return assemble_automaton(
        *encode_filters(filters, tdict, max_levels, native=native),
        max_levels=max_levels,
        load=load,
        hash_buckets=hash_buckets,
        native=native,
    )


def assemble_automaton(
    mat: np.ndarray,
    blen: np.ndarray,
    is_hash: np.ndarray,
    flist: List[Tuple[object, Tuple[str, ...]]],
    max_levels: int = 16,
    load: float = 0.25,
    hash_buckets: int = 0,
    native: bool = True,
) -> Automaton:
    """Assemble from pre-encoded arrays (fully vectorized numpy — the
    GIL-friendly half of the build).

    Rows with ``blen < 0`` are DEAD (deleted or superseded entries of
    an incremental encode cache): they contribute no trie edges, no
    terminal flags and no CSR codes — their positions in ``flist``
    never appear in ``code_idx``."""
    nf = len(flist)
    # BFS by depth: unique (parent, token) pairs become child nodes.
    parent = np.zeros(nf, np.int64)
    n_nodes = 1
    e_parent: List[np.ndarray] = []
    e_tok: List[np.ndarray] = []
    e_child: List[np.ndarray] = []
    depth = int(blen.max()) if nf else 0
    argsort, unique_inverse = sorts(native)

    for d in range(depth):
        act = np.nonzero(blen > d)[0]
        if act.size == 0:
            break
        p = parent[act]
        t = mat[act, d].astype(np.int64)
        key = (p << 32) | (t + _TOK_SHIFT)
        uniq, inv = unique_inverse(key)
        child = n_nodes + np.arange(len(uniq), dtype=np.int64)
        parent[act] = child[inv]
        e_parent.append((uniq >> 32).astype(np.int32))
        e_tok.append(((uniq & 0xFFFFFFFF) - _TOK_SHIFT).astype(np.int32))
        e_child.append(child.astype(np.int32))
        n_nodes += len(uniq)

    if e_parent:
        ep = np.concatenate(e_parent)
        et = np.concatenate(e_tok)
        ec = np.concatenate(e_child)
    else:
        ep = et = ec = np.zeros(0, np.int32)

    node_rows = np.zeros((n_nodes, 8), np.int32)
    node_rows[:, 0] = SENTINEL
    node_rows[:, 4] = -1  # root / padded rows: impossible parent
    node_rows[:, 5] = -1
    plus_mask = et == PLUS_TOK
    node_rows[ep[plus_mask], 0] = ec[plus_mask]
    # each node's unique incoming edge, for kernel-side verification
    node_rows[ec, 4] = ep
    node_rows[ec, 5] = et

    lit = ~plus_mask
    # a mod-size hash table cannot be padded after the fact, so a forced
    # size (for shard-stacking) is honored at build time
    fp_rows, salt = _build_fp_table(
        ep[lit], et[lit], ec[lit], load, min_buckets=max(hash_buckets, 4),
        native=native,
    )

    term = parent.astype(np.int64)

    alive = blen >= 0  # blen == 0 is a LIVE bare-'#' filter
    codes_all = term * 2 + is_hash.astype(np.int64)
    pos_alive = np.nonzero(alive)[0]
    codes_alive = codes_all[pos_alive]
    order = pos_alive[argsort(codes_alive)]
    counts = np.bincount(codes_alive, minlength=2 * n_nodes).astype(
        np.int64
    )
    code_off = np.zeros(2 * n_nodes + 1, np.int64)
    np.cumsum(counts, out=code_off[1:])

    node_rows[term[alive & is_hash], 1] = 1
    node_rows[term[alive & ~is_hash], 2] = 1

    return Automaton(
        fp_rows=fp_rows,
        node_rows=node_rows,
        code_off=code_off.astype(np.int32),
        code_idx=order.astype(np.int32),
        filters=flist,
        salt=salt,
        max_levels=max_levels,
        # Always scan one level past the deepest filter body: encoding
        # topics to depth+1 keeps truncation exact (a topic deeper than
        # every body can never sit on an exact terminal, because the
        # frontier dies at depth+1 where the trie has no edges).
        kernel_levels=depth + 1,
        n_nodes=n_nodes,
    )
