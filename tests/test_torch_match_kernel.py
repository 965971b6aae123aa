"""Port kernels (plain PyTorch versions) against the JAX package's
kernels, bit for bit: codes, counts, overflow flags, the compact layout
and its total, and the packed decide bytes.  Every output is an integer
or boolean, so every comparison is exact (tolerance 0).

The worlds are those of tests/test_match_engine.py (randomized sets
over a tiny alphabet, '$'-topic rules, '#' matching its parent level,
empty levels, frontier overflow, topics deeper than the automaton) plus
full frontiers at F=16 and F=5 (`workload.full_frontier`), a compact
buffer that clips (total > c_cap), and the decide cases of
tests/test_decide_columns.py."""

import random

import numpy as np
import pytest
import torch

from emqx_tpu import topic as RT
from emqx_tpu.ops import automaton as ref_aut
from emqx_tpu.ops import match_kernel as ref_mk
from emqx_tpu.ops.dictionary import TokenDict as RefTokenDict
from emqx_tpu.ops.dictionary import encode_topics as ref_encode_topics

from emqx_tpu_torch.ops import match_kernel as mk
from emqx_tpu_torch.ops.automaton import build_automaton
from emqx_tpu_torch.ops.dictionary import TokenDict, encode_topics
from emqx_tpu_torch.state import tables_from_reference
from emqx_tpu_torch.workload import full_frontier

WORDS = ["a", "b", "c", "", "dev", "$SYS", "$share-ish", "x"]
B_PAD = 256  # one padded batch shape keeps the JAX compiles few


def _random_filter(rng):
    depth = rng.randint(1, 6)
    ws = []
    for i in range(depth):
        r = rng.random()
        if r < 0.18:
            ws.append("+")
        elif r < 0.28 and i == depth - 1:
            ws.append("#")
        else:
            ws.append(rng.choice(WORDS))
    return "/".join(ws)


def _random_topic(rng):
    return "/".join(rng.choice(WORDS) for _ in range(rng.randint(1, 7)))


def _randomized(seed):
    rng = random.Random(seed)
    filters = []
    for fid in range(300):
        flt = _random_filter(rng)
        try:
            RT.validate_filter(flt)
        except ValueError:
            continue
        if RT.is_wildcard(flt):
            filters.append(flt)
    topics = [_random_topic(rng) for _ in range(200)]
    for flt in filters[:50]:
        topics.append("/".join(
            rng.choice(WORDS) if w in "+#" else w for w in flt.split("/")
        ))
    return filters, topics, dict(max_levels=8, f_width=8, m_cap=64)


def _overflow():
    filters = []
    for i in range(12):
        pat = ["+"] * 4
        pat[i % 4] = "w%d" % (i % 3)
        filters.append("/".join(pat))
    filters.append("w0/+/+/+")
    topics = ["w0/w1/w2/w0", "w1/w1/w1/w1", "w2/x/y/z", "a/b"]
    return filters, topics, dict(max_levels=8, f_width=2, m_cap=4)


def _full_frontier(f_width):
    """`workload.full_frontier`: every filter over +/a/b/c up to 5
    levels, so a topic's frontier doubles each level; at F=16 it fills
    all lanes at level 4 and overflows at level 5."""
    filters, topics = full_frontier(np.random.default_rng(f_width), 62)
    return filters, topics, dict(max_levels=8, f_width=f_width, m_cap=128)


WORLDS = {
    **{f"randomized{s}": (lambda s=s: _randomized(s)) for s in range(4)},
    "dollar": lambda: (
        ["#", "+/monitor", "$SYS/#", "$SYS/+", "+/+", "+"],
        ["$SYS/monitor", "$SYS", "sys/monitor", "$SYS/a/b", "$x", "a"],
        dict(max_levels=16, f_width=8, m_cap=128),
    ),
    "hash_parent": lambda: (
        ["sport/tennis/#", "sport/#", "+/tennis/#"],
        ["sport/tennis", "sport/tennis/player1", "sport", "sportx",
         "sport/tennis/a/b/c"],
        dict(max_levels=16, f_width=8, m_cap=128),
    ),
    "empty_levels": lambda: (
        ["a//b", "a/+/b", "/+", "+/+", "//#"],
        ["a//b", "/x", "/", "a/x/b", "//", "///"],
        dict(max_levels=16, f_width=8, m_cap=128),
    ),
    "overflow": _overflow,
    "too_deep": lambda: (
        ["a/#", "a/+/+/+", "+/b/#"],
        ["a/" + "/".join("x%d" % i for i in range(10)), "a/b/c/d",
         "a/b/c/d/e/f/g", "z/b"],
        dict(max_levels=4, f_width=8, m_cap=128),
    ),
    "full_frontier16": lambda: _full_frontier(16),
    "full_frontier5": lambda: _full_frontier(5),
}


def _build_both(filters, max_levels):
    items = [(i, tuple(f.split("/"))) for i, f in enumerate(filters)]
    ra = ref_aut.build_automaton(items, RefTokenDict(), max_levels=max_levels)
    td = TokenDict()
    pa = build_automaton(items, td, max_levels=max_levels)
    return ra, pa, td


def _batch(td, aut, topics):
    tokens, lengths, dollar = encode_topics(
        td, [tuple(t.split("/")) for t in topics], aut.kernel_levels
    )
    pad = B_PAD - len(topics)
    assert pad >= 0
    tokens = np.pad(tokens, ((0, pad), (0, 0)), constant_values=-4)
    lengths = np.pad(lengths, (0, pad))
    dollar = np.pad(dollar, (0, pad), constant_values=True)
    return tokens, lengths, dollar


def _torch_args(fp_rows, node_rows, tokens, lengths, dollar):
    return (torch.from_numpy(np.ascontiguousarray(fp_rows)),
            torch.from_numpy(np.ascontiguousarray(node_rows)),
            torch.from_numpy(tokens), torch.from_numpy(lengths),
            torch.from_numpy(dollar))


def _check_world(filters, topics, kw, c_cap=None):
    ra, pa, td = _build_both(filters, kw["max_levels"])
    tokens, lengths, dollar = _batch(td, pa, topics)
    # the port's encoder agrees with the reference's
    ref_tok = ref_encode_topics(
        _ref_tdict(filters, kw["max_levels"]),
        [tuple(t.split("/")) for t in topics], ra.kernel_levels,
    )
    np.testing.assert_array_equal(ref_tok[0], tokens[:len(topics)])
    f, m = kw["f_width"], kw["m_cap"]
    c_cap = c_cap or B_PAD
    rc, rn, ro = ref_mk.match_batch(
        ra.fp_rows, ra.node_rows, np.uint32(ra.salt), tokens, lengths,
        dollar, f_width=f, m_cap=m,
    )
    rf, rcnt, rtot = ref_mk.match_batch_compact(
        ra.fp_rows, ra.node_rows, np.uint32(ra.salt), tokens, lengths,
        dollar, f_width=f, m_cap=m, c_cap=c_cap,
    )
    args = _torch_args(pa.fp_rows, pa.node_rows, tokens, lengths, dollar)
    pc, pn, po = mk.match_batch(args[0], args[1], pa.salt, *args[2:],
                                f_width=f, m_cap=m)
    pf, pcnt, ptot = mk.match_batch_compact(
        args[0], args[1], pa.salt, *args[2:], f_width=f, m_cap=m,
        c_cap=c_cap,
    )
    assert pc.dtype == torch.int32 and pn.dtype == torch.int32
    assert po.dtype == torch.bool and pf.dtype == torch.int32
    assert pcnt.dtype == torch.int16 and ptot.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(rc), pc.numpy())
    np.testing.assert_array_equal(np.asarray(rn), pn.numpy())
    np.testing.assert_array_equal(np.asarray(ro), po.numpy())
    np.testing.assert_array_equal(np.asarray(rf), pf.numpy())
    np.testing.assert_array_equal(np.asarray(rcnt), pcnt.numpy())
    np.testing.assert_array_equal(np.asarray(rtot), ptot.numpy())
    return ra, pa, np.asarray(rtot), np.asarray(ro)


def _ref_tdict(filters, max_levels):
    td = RefTokenDict()
    ref_aut.build_automaton(
        [(i, tuple(f.split("/"))) for i, f in enumerate(filters)], td,
        max_levels=max_levels,
    )
    return td


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_match_kernels_equal_reference(world):
    filters, topics, kw = WORLDS[world]()
    _check_world(filters, topics, kw)


def test_overflow_world_flags_rows():
    filters, topics, kw = _overflow()
    _ra, _pa, _tot, ovf = _check_world(filters, topics, kw)
    assert ovf[:len(topics)].any()


def test_compact_clip_equals_reference():
    """total > c_cap: the flat buffer drops codes past c_cap, total
    still reports the unclipped sum."""
    filters, topics, kw = _randomized(11)
    _ra, _pa, tot, _ovf = _check_world(filters, topics, kw, c_cap=32)
    assert int(tot[0]) > 32


def test_tables_from_reference_run_the_port_kernels():
    """The port's kernels on tables the JAX package built."""
    filters, topics, kw = _randomized(3)
    ra, pa, td = _build_both(filters, kw["max_levels"])
    tokens, lengths, dollar = _batch(td, pa, topics)
    tab = tables_from_reference(*ra.device_arrays(), ra.code_off,
                                ra.code_idx, "cpu")
    pc, pn, po = mk.match_batch(
        tab.fp_rows, tab.node_rows, tab.salt, torch.from_numpy(tokens),
        torch.from_numpy(lengths), torch.from_numpy(dollar),
        f_width=kw["f_width"], m_cap=kw["m_cap"],
    )
    rc, rn, ro = ref_mk.match_batch(
        *ra.device_arrays(), tokens, lengths, dollar,
        f_width=kw["f_width"], m_cap=kw["m_cap"],
    )
    np.testing.assert_array_equal(np.asarray(rc), pc.numpy())
    np.testing.assert_array_equal(np.asarray(rn), pn.numpy())
    np.testing.assert_array_equal(np.asarray(ro), po.numpy())
    np.testing.assert_array_equal(tab.code_off, ra.code_off)


def test_mix32_matches_table_hash():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, 100_000, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, 100_000, dtype=np.uint64).astype(np.uint32)
    want = ref_aut.mix32(a, b)
    got = mk.mix32_i64(torch.from_numpy(a.astype(np.int64)),
                       torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(want.astype(np.int64), got.numpy())


def _decide_cases():
    rng = np.random.default_rng(7)
    for _ in range(20):
        r, n, b = 64, int(rng.integers(1, 700)), int(rng.integers(1, 40))
        cols = (
            rng.integers(0, 3, r).astype(np.int8),
            rng.random(r) < 0.3,
            rng.random(r) < 0.4,
            rng.random(r) < 0.2,
        )
        orows = rng.integers(0, r, n).astype(np.int32)
        crows = rng.integers(0, 100, n).astype(np.int32)
        midx = rng.integers(0, b, n).astype(np.int32)
        mq = rng.integers(0, 3, b).astype(np.int8)
        mr = rng.random(b) < 0.5
        mf = rng.integers(-1, 100, b).astype(np.int32)
        yield cols + (orows, crows, midx, mq, mr, mf)


def test_decide_equals_reference():
    """Port decide (plain) vs decide_batch_host and the JAX kernel."""
    for case in _decide_cases():
        host = ref_mk.decide_batch_host(*case)
        dev = np.asarray(ref_mk.decide_batch(*case))
        got = mk.decide_batch(*(torch.from_numpy(np.asarray(c))
                                for c in case))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(host, got.numpy())
        np.testing.assert_array_equal(dev, got.numpy())


# ------------------------------------------------------ wrapper refusals


def _small_match_args():
    filters, topics, kw = WORLDS["hash_parent"]()
    _ra, pa, td = _build_both(filters, 16)
    tokens, lengths, dollar = _batch(td, pa, topics)
    return _torch_args(pa.fp_rows, pa.node_rows, tokens, lengths,
                       dollar), pa.salt


@pytest.mark.parametrize("bad", [
    "tokens_dtype", "noncontiguous", "f_width", "m_cap", "fp_rows_shape",
    "lengths_len",
])
def test_match_wrapper_refuses(bad):
    (fp, nodes, tok, ln, dol), salt = _small_match_args()
    kw = dict(f_width=8, m_cap=128)
    exc = ValueError
    if bad == "tokens_dtype":
        tok, exc = tok.to(torch.int64), TypeError
    elif bad == "noncontiguous":
        tok = torch.cat([tok, tok], dim=1)[:, ::2]
    elif bad == "f_width":
        kw["f_width"] = mk.F_MAX + 1
    elif bad == "m_cap":
        kw["m_cap"] = mk.M_MAX + 1
    elif bad == "fp_rows_shape":
        fp = fp[:3].contiguous()
    elif bad == "lengths_len":
        ln = ln[:-1].contiguous()
    with pytest.raises(exc):
        mk.match_batch(fp, nodes, salt, tok, ln, dol, **kw)
    with pytest.raises(exc):
        mk.match_batch_compact(fp, nodes, salt, tok, ln, dol, c_cap=64,
                               **kw)


@pytest.mark.parametrize("bad", [
    "opts_high", "opts_negative", "msg_high", "qos_dtype", "noncontiguous",
])
def test_decide_wrapper_refuses(bad):
    case = [torch.from_numpy(np.asarray(c)) for c in next(_decide_cases())]
    exc = IndexError
    if bad == "opts_high":
        case[4][0] = case[0].shape[0]
    elif bad == "opts_negative":
        case[4][0] = -1
    elif bad == "msg_high":
        case[6][0] = case[7].shape[0]
    elif bad == "qos_dtype":
        case[0], exc = case[0].to(torch.int32), TypeError
    elif bad == "noncontiguous":
        case[5], exc = torch.stack([case[5], case[5]], 1)[:, 0], ValueError
    with pytest.raises(exc):
        mk.decide_batch(*case)


def test_decide_packed_equals_reference_and_flags_range():
    """K3's packed form (plain): the JAX package's bytes, and a delivery
    outside the opts or message columns gets 0 and sets the error."""
    for case in _decide_cases():
        host = ref_mk.decide_batch_host(*case)
        t = [torch.from_numpy(np.asarray(c)) for c in case]
        got, err = mk.decide_packed(mk.pack_opts(*t[:4]), *t[4:])
        assert got.dtype == torch.uint8 and int(err) == 0
        np.testing.assert_array_equal(host, got.numpy())
        t[4][0] = t[0].shape[0]
        t[6][-1] = -1
        got, err = mk.decide_packed(mk.pack_opts(*t[:4]), *t[4:])
        assert int(err) == 1 and got[0] == 0 and got[-1] == 0
        np.testing.assert_array_equal(host[1:-1], got[1:-1].numpy())
