"""The port's sharded match path (plain versions on the CPU) against the
JAX package's: the mesh layout, the stacked sharded index, K5
`sharded_match` bit for bit on a (4, 2) mesh (codes, counts, overflow
flags and the summed total; tolerance 0, every output is an integer or
boolean), and the sharded engine under churn.

The JAX package runs on its virtual 8-device CPU mesh (tests/
conftest.py); the port's mesh repeats the CPU device at every position,
the same idiom that holds a 4-shard index on one card.  Fids are ints:
Python salts hash() of a str per process, and shard_of hashes."""

import random

import numpy as np
import pytest
import torch

from emqx_tpu import topic as RT
from emqx_tpu.ops.dictionary import TokenDict as RefTokenDict
from emqx_tpu.ops.dictionary import encode_topics as ref_encode_topics
from emqx_tpu.parallel import sharded as ref_sh

from emqx_tpu_torch.ops import match_kernel as mk
from emqx_tpu_torch.ops.dictionary import TokenDict
from emqx_tpu_torch.parallel import sharded as sh
from emqx_tpu_torch.state import sharded_tables_from_reference

WORDS = ["a", "b", "c", "", "dev", "$SYS", "x"]
CPU8 = [torch.device("cpu")] * 8
B_PAD = 64  # one padded batch shape: one JAX compile per (F, M)


def _filter(rng, depth_max=5):
    depth = rng.randint(1, depth_max)
    ws = []
    for i in range(depth):
        r = rng.random()
        if r < 0.2:
            ws.append("+")
        elif r < 0.3 and i == depth - 1:
            ws.append("#")
        else:
            ws.append(rng.choice(WORDS))
    return "/".join(ws)


def _world(seed, n=300, skip_shard=None):
    """Wildcard filters with int fids (none in shard ``skip_shard`` of
    4: an empty partition) and topics, some built to hit filters."""
    rng = random.Random(seed)
    filters = []
    for fid in range(n):
        if skip_shard is not None and fid % 4 == skip_shard:
            continue
        flt = _filter(rng)
        try:
            RT.validate_filter(flt)
        except ValueError:
            continue
        if RT.is_wildcard(flt):
            filters.append((fid, RT.words(flt)))
    topics = [tuple(rng.choice(WORDS) for _ in range(rng.randint(1, 6)))
              for _ in range(40)]
    topics += [tuple(rng.choice(WORDS[:3]) if w in "+#" else w for w in ws)
               for _, ws in filters[:B_PAD - 40]]
    return filters, topics[:B_PAD]


@pytest.mark.parametrize("f_width,m_cap,skip", [(8, 64, None), (2, 4, 3)])
def test_sharded_match_equals_reference(f_width, m_cap, skip):
    filters, topics = _world(f_width, skip_shard=skip)
    td = RefTokenDict()
    idx = ref_sh.build_sharded_index(filters, td, n_shards=4, max_levels=8)
    tok, ln, dol = ref_encode_topics(td, topics, idx.kernel_levels)
    want = [np.asarray(a) for a in ref_sh.sharded_match(
        ref_sh.make_mesh(8, sub=4), *idx.tables, tok, ln, dol,
        f_width=f_width, m_cap=m_cap)]

    mesh = sh.make_mesh(8, sub=4, devices=CPU8)
    placed = sharded_tables_from_reference(*idx.tables, mesh)
    assert len(placed.fp_rows) == 1  # one device: one block, one launch
    got = sh.sharded_match(mesh, *placed, tok, ln, dol, f_width=f_width,
                           m_cap=m_cap)
    raw = sh.sharded_match(mesh, *idx.tables, tok, ln, dol,
                           f_width=f_width, m_cap=m_cap)
    # "cpu" and "cpu:0" are two devices to the mesh: two blocks, split
    # by shards or by batch columns, whose outputs and partial totals
    # are assembled on the first device
    a, b = torch.device("cpu"), torch.device("cpu", 0)
    by_shards = sh.make_mesh(8, sub=4, devices=[a] * 4 + [b] * 4)
    by_cols = sh.make_mesh(8, sub=4, devices=[a, b] * 4)
    assert [blk[1:] for blk in by_shards.blocks] == [
        (slice(0, 2), slice(0, 2)), (slice(2, 4), slice(0, 2))]
    assert [blk[1:] for blk in by_cols.blocks] == [
        (slice(0, 4), slice(0, 1)), (slice(0, 4), slice(1, 2))]
    parts = [sh.sharded_match(m, *idx.tables, tok, ln, dol,
                              f_width=f_width, m_cap=m_cap)
             for m in (by_shards, by_cols)]
    for i, w in enumerate(want):
        assert got[i].dtype == {np.int32: torch.int32,
                                np.bool_: torch.bool}[w.dtype.type]
        for t in (got[i], raw[i], parts[0][i], parts[1][i]):
            assert np.array_equal(t.numpy(), w)
    if skip is not None:
        assert not want[1][skip].any()  # the empty shard matched nothing
    else:
        assert want[3].sum() > 0
    if f_width == 2:
        assert want[2].any()  # the overflow case overflows


def test_sharded_match_local_checks():
    filters, topics = _world(1)
    idx = sh.build_sharded_index(filters, TokenDict(), 4, max_levels=8)
    fp, nodes, salts = (torch.from_numpy(a) for a in idx.tables)
    tok = torch.zeros((4, idx.kernel_levels), dtype=torch.int32)
    ln = torch.zeros(4, dtype=torch.int32)
    dol = torch.zeros(4, dtype=torch.bool)
    out = mk.sharded_match_local(fp, nodes, salts, tok, ln, dol, f_width=4,
                                 m_cap=8)
    assert [tuple(t.shape) for t in out] == [(4, 4, 8), (4, 4), (4, 4), (4,)]
    with pytest.raises(TypeError, match="salts"):
        mk.sharded_match_local(fp, nodes, salts.to(torch.int64), tok, ln,
                               dol, f_width=4, m_cap=8)
    with pytest.raises(ValueError, match="disagree on K"):
        mk.sharded_match_local(fp, nodes[:3].contiguous(), salts, tok, ln,
                               dol, f_width=4, m_cap=8)
    with pytest.raises(ValueError, match="f_width"):
        mk.sharded_match_local(fp, nodes, salts, tok, ln, dol, f_width=17,
                               m_cap=8)


def test_index_and_mesh_equal_reference():
    filters, _ = _world(5, n=200)
    ref = ref_sh.build_sharded_index(filters, RefTokenDict(), 4,
                                     max_levels=8)
    port = sh.build_sharded_index(filters, TokenDict(), 4, max_levels=8)
    for a, b in zip(port.tables, ref.tables):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert port.offsets == ref.offsets
    assert (port.kernel_levels, port.n_nodes) == (ref.kernel_levels,
                                                  ref.n_nodes)
    for a, b in zip(port.shards, ref.shards):
        assert np.array_equal(a.code_off, b.code_off)
        assert np.array_equal(a.code_idx, b.code_idx)
        assert a.filters == b.filters
    # sticky geometry classes
    td, rtd = TokenDict(), RefTokenDict()
    from emqx_tpu.ops.automaton import encode_filters as ref_encode
    from emqx_tpu_torch.ops.automaton import encode_filters

    parts = [[f for f in filters if f[0] % 3 == k] for k in range(3)]
    a = sh.assemble_sharded([encode_filters(p, td, 8) for p in parts], 8,
                            min_buckets=256, min_nodes=300)
    b = ref_sh.assemble_sharded([ref_encode(p, rtd, 8) for p in parts], 8,
                                min_buckets=256, min_nodes=300)
    for x, y in zip(a.tables, b.tables):
        assert np.array_equal(x, y)
    assert a.tables[0].shape[1] == 256 and a.tables[1].shape[1] == 512
    assert sh.shard_of(7, 4) == ref_sh.shard_of(7, 4) == 3

    for n in range(1, 9):
        for s in (None, 1, 2, 4):
            if s is not None and s > n:
                continue
            assert sh.make_mesh(n, sub=s, devices=CPU8).shape == dict(
                ref_sh.make_mesh(n, sub=s).shape), (n, s)
    mesh = sh.make_mesh(devices=CPU8, sub=4)
    assert mesh.shape == {"sub": 4, "pub": 2}
    assert mesh.blocks == [(torch.device("cpu"), slice(0, 4), slice(0, 2))]
    with pytest.raises(ValueError, match="need 9 devices"):
        ref_sh.make_mesh(9)
    with pytest.raises(ValueError, match="need 9 devices"):
        sh.make_mesh(9, devices=CPU8)


def test_mesh_blocks_one_per_device():
    """Each device fills one block of adjacent shards and columns: one
    shard per device is a block each; a device whose positions are not
    one block is refused."""
    a, b, c, d = (torch.device("cpu"), torch.device("cpu", 0),
                  torch.device("meta"), torch.device("meta", 0))
    grid = np.empty(4, object)
    grid[:] = [a, b, c, d]
    mesh = sh.Mesh(grid.reshape(2, 2))
    assert mesh.blocks == [(a, slice(0, 1), slice(0, 1)),
                           (b, slice(0, 1), slice(1, 2)),
                           (c, slice(1, 2), slice(0, 1)),
                           (d, slice(1, 2), slice(1, 2))]
    grid[:] = [a, b, b, a]
    with pytest.raises(ValueError, match="one block"):
        sh.Mesh(grid.reshape(2, 2))
    with pytest.raises(ValueError, match="one block"):
        sh.make_mesh(6, sub=3, devices=[a, a, b, b, a, a])


def test_make_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sh.make_mesh(devices=["cuda:0"] * 4, sub=4)


def _oracle(live, topic):
    ws = RT.words(topic)
    return {f for f, w in live.items() if RT.match_words(ws, RT.words(w))}


@pytest.mark.parametrize("seed", [3, 11])
def test_sharded_engine_churn_equals_reference(seed):
    """tests/test_sharded.py's churn suite, run on the port's engine and
    the JAX package's engine side by side: the same fid sets, equal to
    the brute-force oracle, before and after a rebuild."""
    rng = random.Random(seed)
    port = sh.ShardedMatchEngine(sh.make_mesh(8, sub=4, devices=CPU8),
                                 max_levels=8, rebuild_threshold=200)
    ref = ref_sh.ShardedMatchEngine(ref_sh.make_mesh(4), max_levels=8,
                                    rebuild_threshold=200)
    live = {}
    words_pool = ["a", "b", "c", "+", "dev", "x1"]
    fid = 0
    for _ in range(4):
        for _ in range(120):
            ws = [rng.choice(words_pool) for _ in range(rng.randint(1, 4))]
            if rng.random() < 0.3:
                ws.append("#")
            flt = "/".join(ws)
            try:
                RT.validate_filter(flt)
            except ValueError:
                continue
            port.insert(flt, fid)
            ref.insert(flt, fid)
            live[fid] = flt
            fid += 1
        for victim in rng.sample(sorted(live), 15):
            port.delete(victim)
            ref.delete(victim)
            del live[victim]
        topics = ["/".join(rng.choice(["a", "b", "c", "dev", "x1", "zz"])
                           for _ in range(rng.randint(1, 5)))
                  for _ in range(25)]
        got, want = port.match_batch(topics), ref.match_batch(topics)
        for t, g, w in zip(topics, got, want):
            assert g == w == _oracle(live, t), t
    port.rebuild()
    for t, g in zip(topics, port.match_batch(topics)):
        assert g == _oracle(live, t), ("post-rebuild", t)
    assert port.counters["rebuilds"] >= 2
    assert port.counters["dev_windows"] >= 2
    assert port.index.n_shards == 4


def test_sharded_engine_adopts_a_seed_index():
    filters, topics = _world(9, n=120)
    flts = [(fid, ws) for fid, ws in filters if len(ws) <= 8]
    idx = sh.build_sharded_index(flts, TokenDict(), 4, max_levels=8)
    eng = sh.ShardedMatchEngine(sh.make_mesh(4, devices=CPU8), idx,
                                f_width=8, m_cap=64)
    live = {fid: RT.join(ws) for fid, ws in flts}
    names = [RT.join(t) for t in topics]
    for t, g in zip(names, eng.match_batch(names)):
        assert g == _oracle(live, t), t
    with pytest.raises(ValueError, match="4 shards"):
        sh.ShardedMatchEngine(sh.make_mesh(2, devices=CPU8), idx)
