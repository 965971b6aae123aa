"""The port's automaton build against the JAX package's: the same
filters give identical tables (fp_rows, node_rows, salt, code_off,
code_idx, kernel_levels), including a build whose first salt suffers a
same-bucket fingerprint collision and is bumped."""

import random

import numpy as np
import pytest

from emqx_tpu.ops import automaton as ref_aut
from emqx_tpu.ops.dictionary import TokenDict as RefTokenDict

from emqx_tpu_torch.ops import automaton as aut
from emqx_tpu_torch.ops.dictionary import TokenDict

WORDS = ["a", "b", "c", "", "dev", "$SYS", "x", "sensors", "temp"]


def _filters(seed, n):
    rng = random.Random(seed)
    out = []
    for fid in range(n):
        depth = rng.randint(1, 7)
        ws = []
        for i in range(depth):
            r = rng.random()
            if r < 0.2:
                ws.append("+")
            elif r < 0.3 and i == depth - 1:
                ws.append("#")
            else:
                ws.append(rng.choice(WORDS) + str(rng.randrange(40)))
        out.append((fid, tuple(ws)))
    return out


def _assert_same(ra, pa):
    np.testing.assert_array_equal(ra.fp_rows, pa.fp_rows)
    np.testing.assert_array_equal(ra.node_rows, pa.node_rows)
    np.testing.assert_array_equal(ra.code_off, pa.code_off)
    np.testing.assert_array_equal(ra.code_idx, pa.code_idx)
    assert ra.salt == pa.salt
    assert ra.kernel_levels == pa.kernel_levels
    assert ra.n_nodes == pa.n_nodes
    assert ra.fp_rows.dtype == pa.fp_rows.dtype == np.int32
    assert ra.node_rows.dtype == pa.node_rows.dtype == np.int32


@pytest.mark.parametrize("seed,n", [(0, 50), (1, 300), (2, 2000),
                                    (3, 5000)])
def test_build_automaton_identical(seed, n):
    items = _filters(seed, n)
    rtd, ptd = RefTokenDict(), TokenDict()
    ra = ref_aut.build_automaton(items, rtd, max_levels=8)
    pa = aut.build_automaton(items, ptd, max_levels=8)
    _assert_same(ra, pa)
    assert rtd._ids == ptd._ids


def test_dead_rows_and_forced_buckets_identical():
    """assemble with dead (blen < 0) rows and a forced bucket count."""
    items = _filters(4, 400)
    rm = ref_aut.encode_filters(items, RefTokenDict(), 8)
    pm = aut.encode_filters(items, TokenDict(), 8)
    for r, p in zip(rm[:3], pm[:3]):
        np.testing.assert_array_equal(r, p)
    blen_r, blen_p = rm[1].copy(), pm[1].copy()
    blen_r[::7] = -1
    blen_p[::7] = -1
    ra = ref_aut.assemble_automaton(rm[0], blen_r, rm[2], rm[3],
                                    max_levels=8, hash_buckets=1024)
    pa = aut.assemble_automaton(pm[0], blen_p, pm[2], pm[3],
                                max_levels=8, hash_buckets=1024)
    _assert_same(ra, pa)
    assert len(pa.fp_rows) == 1024


def _colliding_pair():
    """Two literal edges whose salt-0 fingerprints are equal and which
    land in the same bucket of a 4-bucket table (for a fixed parent the
    fingerprint is a bijection of the token, so the parents differ)."""
    idx = np.arange(1 << 20, dtype=np.int64)
    parents, toks = idx & 0x3FF, idx >> 10
    fp = aut.edge_fp(parents, toks, 0).astype(np.int64)
    bucket = (aut.bucket_hash(parents, toks, 0) & np.uint32(3)).astype(
        np.int64)
    key = (fp << 2) | bucket
    order = np.argsort(key, kind="stable")
    ks = key[order]
    dup = np.flatnonzero(ks[1:] == ks[:-1])
    assert len(dup), "no salt-0 collision in the search range"
    i, j = order[dup[0]], order[dup[0] + 1]
    return parents[[i, j]].astype(np.int32), toks[[i, j]].astype(np.int32)


def test_salt_bump_identical():
    parents, toks = _colliding_pair()
    children = np.array([1, 2], np.int32)
    r_rows, r_salt = ref_aut._build_fp_table(parents, toks, children, 0.25)
    p_rows, p_salt = aut._build_fp_table(parents, toks, children, 0.25)
    assert r_salt >= 1 and p_salt == r_salt
    np.testing.assert_array_equal(r_rows, p_rows)


def test_expand_codes_identical():
    items = _filters(5, 300)
    pa = aut.build_automaton(items, TokenDict(), max_levels=8)
    rng = np.random.default_rng(5)
    codes = rng.integers(-1, 2 * pa.n_nodes, (40, 6)).astype(np.int32)
    r = ref_aut.expand_codes_host(pa.code_off, pa.code_idx, codes)
    p = aut.expand_codes_host(pa.code_off, pa.code_idx, codes)
    for a, b in zip(r, p):
        np.testing.assert_array_equal(a, b)
    uniq, inv = np.unique(rng.integers(0, 40, 90), return_inverse=True)
    r = ref_aut.expand_codes_dedup(pa.code_off, pa.code_idx, codes[uniq],
                                   inv)
    p = aut.expand_codes_dedup(pa.code_off, pa.code_idx, codes[uniq], inv)
    for a, b in zip(r, p):
        np.testing.assert_array_equal(a, b)


def test_fleet_workload_matches_bench_generator():
    """The port's copy of the fleet generator equals bench.py's, and
    its vectorized encoding builds the same automaton as the scalar
    encoder."""
    import bench

    from emqx_tpu_torch import workload as W

    filters, pops = W.make_filters(5000, 8)
    assert (filters, pops) == bench.make_filters(5000, 8)
    assert W.make_topics(np.random.default_rng(0), 300, pops) == \
        bench.make_topics(np.random.default_rng(0), 300, pops)
    td_scalar = TokenDict()
    W.seed_words(td_scalar, pops)
    scalar = aut.build_automaton(filters, td_scalar, max_levels=16)
    td_vec = TokenDict()
    mat, blen, ish, _ = W.fleet_encoded(5000, 8, td_vec)
    vec = aut.assemble_automaton(mat, blen, ish, range(5000),
                                 max_levels=16)
    _assert_same(scalar, vec)
    assert td_scalar._ids == td_vec._ids
