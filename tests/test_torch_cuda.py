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


def _full_world(n_topics=70):
    """`workload.full_frontier`: frontiers that fill and overflow every
    width up to 16."""
    from emqx_tpu_torch import workload as W

    flts, tops = W.full_frontier(np.random.default_rng(9), n_topics)
    return ([(fid, tuple(f.split("/"))) for fid, f in enumerate(flts)],
            [tuple(t.split("/")) for t in tops])


def _rows(topics, b, seed):
    """``b`` topic rows drawn from ``topics``: ragged last groups and
    blocks, and many blocks for the compact look-back."""
    rng = random.Random(seed)
    return topics[:b] + [rng.choice(topics) for _ in range(b - len(topics))]


# (world, f_width, m_cap, c_cap, B); B None: the world's own topics
MATCH_CASES = (
    [("random", 8, 64, 1024, None), ("random", 2, 4, 64, None),
     ("random", 16, 128, 37, None)]
    # every group width and every F that is not a power of two, on
    # frontiers that fill and overflow; the m_cap and c_cap clips
    + [("full", f, 128, 4096, None) for f in range(1, 17)]
    + [("full", 16, 8, 37, None), ("full", 5, 3, 50, None)]
    + [("full", 16, 128, b * 4, b) for b in (1, 33, 4097, 65537)]
    + [("random", 3, 16, b, b) for b in (33, 65537)]
)


@pytest.mark.cuda
@pytest.mark.parametrize("world,f_width,m_cap,c_cap,b", MATCH_CASES)
def test_match_kernels_equal_plain(cuda, world, f_width, m_cap, c_cap, b):
    filters, topics = (_full_world() if world == "full"
                       else _world(f_width))
    if b is not None:
        topics = _rows(topics, b, f_width)
    td = TokenDict()
    aut = build_automaton(filters, td, max_levels=8)
    tok, ln, dol = encode_topics(td, topics, aut.kernel_levels)
    cpu = [torch.from_numpy(a) for a in (aut.fp_rows, aut.node_rows, tok,
                                         ln, dol)]
    gpu = [t.to(cuda) for t in cpu]
    mk.reset_launches()
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
        if fn is mk.match_batch and world == "full" and b is None:
            assert bool(want[2].any())  # some frontier overflowed
    assert mk.launches()["match_batch"] == 1
    assert mk.launches()["match_batch_compact"] == 1


@pytest.mark.cuda
def test_compact_kernel_reuses_its_outputs(cuda):
    """One-pass K1 launched again and again into the same flat, counts,
    total and look-back scratch, on batches of other sizes: the entry
    point refills flat and resets the scratch (ticket counter and
    status words) every time."""
    from emqx_tpu_torch.ops import _kernels

    filters, topics = _full_world()
    td = TokenDict()
    aut = build_automaton(filters, td, max_levels=8)
    fp, nodes = (torch.from_numpy(a).to(cuda)
                 for a in (aut.fp_rows, aut.node_rows))
    big, c_cap = 20_000, 60_000
    flat = torch.empty(c_cap, dtype=torch.int32, device=cuda)
    counts = torch.empty(big, dtype=torch.int16, device=cuda)
    total = torch.empty(1, dtype=torch.int32, device=cuda)
    runs = ((big, 16, 128), (5_000, 4, 16), (big, 1, 128), (big, 16, 128))
    scratch = torch.empty(max(
        _kernels.compact_scratch_words(b, aut.kernel_levels, f, m)
        for b, f, m in runs), dtype=torch.int64, device=cuda)
    for b, f, m in runs:
        tok, ln, dol = (torch.from_numpy(a).to(cuda) for a in encode_topics(
            td, _rows(topics, b, b + f), aut.kernel_levels))
        _kernels.match_compact(fp, nodes, aut.salt, tok, ln, dol, f, m,
                               c_cap, flat, counts[:b], total, scratch)
        want = mk.match_batch_compact_plain(
            fp, nodes, aut.salt, tok, ln, dol, f_width=f, m_cap=m,
            c_cap=c_cap)
        torch.cuda.synchronize()
        for g, w in zip((flat, counts[:b], total), want):
            assert torch.equal(g, w), (b, f, m)


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [40, 400])
def test_compact_kernel_stages_deep_rows(cuda, levels):
    """K1 on token rows far wider than the automaton: a row may then
    record up to 1 + (L + 1) * F codes, so at L = 400 a block's staged
    codes pass 48 KB of shared memory and the launch asks for more."""
    filters, topics = _full_world()
    td = TokenDict()
    aut = build_automaton(filters, td, max_levels=8)
    tok, ln, dol = encode_topics(td, _rows(topics, 3000, levels), levels)
    args = [torch.from_numpy(a).to(cuda) for a in (aut.fp_rows,
                                                   aut.node_rows)]
    batch = [torch.from_numpy(a).to(cuda) for a in (tok, ln, dol)]
    for f, m in ((16, mk.M_MAX), (3, 200)):
        got = mk.match_batch_compact(args[0], args[1], aut.salt, *batch,
                                     f_width=f, m_cap=m, c_cap=50_000)
        want = mk.match_batch_compact_plain(
            args[0], args[1], aut.salt, *batch, f_width=f, m_cap=m,
            c_cap=50_000)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), (levels, f, m)


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


def _decide_case(rng, n, r, b, offset=0):
    """CPU columns of one decide window; the per-delivery columns are
    views ``offset`` elements into their buffers."""
    def view(a):
        return torch.from_numpy(np.concatenate(
            [np.zeros(offset, a.dtype), a]))[offset:]

    return [
        torch.from_numpy(rng.integers(-1, 3, r).astype(np.int8)),
        torch.from_numpy(rng.random(r) < 0.3),
        torch.from_numpy(rng.random(r) < 0.4),
        torch.from_numpy(rng.random(r) < 0.2),
        view(rng.integers(0, r, n).astype(np.int32)),
        view(rng.integers(-1, 100, n).astype(np.int32)),
        view(rng.integers(0, b, n).astype(np.int32)),
        torch.from_numpy(rng.integers(-1, 3, b).astype(np.int8)),
        torch.from_numpy(rng.random(b) < 0.5),
        torch.from_numpy(rng.integers(-1, 100, b).astype(np.int32)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset,b", [
    (n, off, 40) for n in (1, 3, 5, 17, (1 << 20) + 3)
    for off in (0, 1, 2, 3)] + [(5000, 0, 7000), (4099, 1, 7000)])
def test_decide_kernel_tails_and_unaligned_views(cuda, n, offset, b):
    """K3's vector path, its scalar tail, views that are not 16 B
    aligned, and windows of 7,000 messages."""
    cpu = _decide_case(np.random.default_rng(n + offset), n, 300, b, offset)
    gpu = [c.to(cuda) for c in cpu]
    if offset:  # the same unaligned views on the card
        gpu[4:7] = [torch.cat([c.new_zeros(offset), c])[offset:]
                    for c in gpu[4:7]]
        assert gpu[4].data_ptr() % 16
    mk.reset_launches()
    want = mk.decide_batch(*cpu)
    got = mk.decide_batch(*gpu)
    assert torch.equal(want, got.cpu())
    packed, err = mk.decide_packed(mk.pack_opts(*gpu[:4]), *gpu[4:])
    plain, perr = mk.decide_packed_plain(mk.pack_opts(*gpu[:4]), *gpu[4:])
    torch.cuda.synchronize()
    assert torch.equal(packed, plain) and int(err) == int(perr) == 0
    assert mk.decide_packed.launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [
    "opts_high", "opts_negative", "msg_high", "qos_dtype", "noncontiguous",
])
def test_decide_kernel_refuses(cuda, bad):
    """`test_decide_wrapper_refuses`'s five bad inputs on the card: the
    range errors come from the kernel's error word, and the bytes of
    the bad deliveries are 0."""
    case = [c.to(cuda) for c in _decide_case(np.random.default_rng(2), 700,
                                             64, 30)]
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
    if exc is IndexError:
        got, err = mk.decide_packed(mk.pack_opts(*case[:4]), *case[4:])
        want, werr = mk.decide_packed_plain(mk.pack_opts(*case[:4]),
                                            *case[4:])
        torch.cuda.synchronize()
        assert int(err) == int(werr) == 1 and int(got[0]) == 0
        assert torch.equal(got, want)


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



def _churn_topics_delta_world(eng):
    """A base of unrelated filters, then a delta automaton (fold pinned
    synchronous) of many distinct shapes over a/b/c, so that each of
    the window's topics matches several codes of the delta automaton
    and its compact buffer clips."""
    trie = HostTrie()
    for i in range(300):
        eng.insert(f"base/{i % 17}/+/{i}", i)
        trie.insert(f"base/{i % 17}/+/{i}", i)
    eng.rebuild()
    shapes = ["a/+/+", "+/b/+", "a/b/+", "+/+/c", "a/#", "#", "+/#",
              "a/+/c", "+/b/c", "a/b/#"]
    for k in range(400):
        flt = shapes[k % len(shapes)].replace("a", f"a{k % 12}")
        eng.insert(flt, 1000 + k)
        trie.insert(flt, 1000 + k)
    names = [f"a{i % 12}/b/c" for i in range(40)] + ["base/3/x/3", "zz"]
    return trie, names


@pytest.mark.cuda
def test_delta_automaton_k1_and_clip_rerun_equal_plain(cuda):
    """K1 on the delta automaton (padded to 4,096 nodes and 2,048
    buckets, walked at max_levels + 1), with the engine's clip rerun on
    K2, against the plain versions and the host trie."""
    eng = MatchEngine(max_levels=8, f_width=8, m_cap=64,
                      rebuild_threshold=10**9, delta_aut_threshold=16)
    eng._fold_async = False
    trie, names = _churn_topics_delta_world(eng)
    assert eng._daut is not None and eng.counters["folds"] >= 1
    tab = eng._dtables
    assert tab.node_rows.shape[0] >= 4096 and tab.fp_rows.shape[0] >= 2048
    from emqx_tpu_torch import topic as T

    tokens, lengths, dollar, _, _ = eng._encode_window(
        [T.words(t) for t in names], eng._daut.kernel_levels)
    batch = [torch.from_numpy(a).to(cuda) for a in (tokens, lengths, dollar)]
    args = (tab.fp_rows, tab.node_rows, tab.salt, *batch)
    for c_cap in (8, 4096):
        got = mk.match_batch_compact(*args, f_width=8, m_cap=64, c_cap=c_cap)
        want = mk.match_batch_compact_plain(*args, f_width=8, m_cap=64,
                                            c_cap=c_cap)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())
    for g, w in zip(mk.match_batch(*args, f_width=8, m_cap=64),
                    mk.match_batch_plain(*args, f_width=8, m_cap=64)):
        assert torch.equal(g.cpu(), w.cpu())
    mk.reset_launches()
    clips = eng.counters["clip_reruns"]
    for t, g in zip(names, eng.match_batch(names)):
        assert g == trie.match(t), t
    assert eng.counters["daut_windows"] >= 1
    assert eng.counters["clip_reruns"] > clips
    assert mk.match_batch.launches >= 1
    assert mk.match_batch_compact.launches == 2  # the delta, the base


@pytest.mark.cuda
def test_background_swap_under_a_running_window(cuda):
    """A window submitted on the old base finishes after a background
    build was swapped in by the next window (whose snapshot is the new
    base); both equal the host trie, and the old tables stay valid for
    the window that holds them."""
    eng = MatchEngine(max_levels=8, f_width=8, m_cap=64,
                      rebuild_threshold=256, background_rebuild=True)
    trie = HostTrie()
    for i in range(2000):
        eng.insert(f"s/{i % 31}/+/{i % 5}", i)
        trie.insert(f"s/{i % 31}/+/{i % 5}", i)
    eng.rebuild()
    names = [f"s/{i % 31}/x/{i % 5}" for i in range(500)]
    first = eng.match_batch_submit(names)
    old = eng._tables
    pairs = [(f"n/{i % 13}/+", 10**6 + i) for i in range(600)]
    eng.insert_many(pairs)
    for flt, fid in pairs:
        trie.insert(flt, fid)
    eng._build_thread.join(60)
    assert not eng._build_thread.is_alive()
    later = names[:100] + [f"n/{i}/y" for i in range(13)]
    second = eng.match_batch_submit(later)  # polls the swap
    assert eng._tables is not old and eng.counters["rebuilds"] >= 2
    del old
    torch.cuda.empty_cache()
    for t, g in zip(later, eng.match_batch_finish(second)):
        assert g == trie.match(t), t
    for t, g in zip(names, eng.match_batch_finish(first)):
        assert g == trie.match(t), t


@pytest.mark.cuda
@pytest.mark.parametrize("n_cards", [1, 2])
def test_sharded_churn_on_cards_equals_host_trie(cuda, n_cards):
    """The sharded engine's churn path on one card (4 shards) and on two
    (one shard a card): background builds upload each card's share
    from the builder thread on that card's side stream, folds put the
    delta automaton on the first card, and every window equals the host
    trie."""
    from emqx_tpu_torch import topic as T
    from emqx_tpu_torch.parallel import sharded as sh

    if torch.cuda.device_count() < n_cards:
        pytest.skip(f"needs {n_cards} CUDA devices")
    mesh = (sh.make_mesh(devices=[cuda] * 4, sub=4) if n_cards == 1
            else sh.make_mesh(2, sub=2))
    eng = sh.ShardedMatchEngine(mesh, max_levels=8, f_width=8, m_cap=64,
                                rebuild_threshold=256,
                                background_rebuild=True)
    eng.delta_aut_threshold = 64
    filters, topics = _world(5, 1500, 400)
    filters = [(fid, ws) for fid, ws in filters if "/".join(ws)]
    eng.insert_many([("/".join(ws), fid) for fid, ws in filters])
    eng.rebuild()
    names = ["/".join(t) for t in topics if t] + [
        f"c/{i % 9}/x" for i in range(50)]

    def check():
        for t, g in zip(names, eng.match_batch(names)):
            assert g == eng.match_host(T.words(t)), t

    check()
    for k in range(12):
        batch = [(f"c/{i % 9}/+", 10**6 + k * 64 + i) for i in range(64)]
        eng.insert_many(batch)
        for _, fid in batch[::8]:
            assert eng.delete(fid)
        check()
    for t in (eng._build_thread, eng._fold_thread):
        if t is not None:
            t.join(60)
            assert not t.is_alive()
    check()
    c = eng.counters
    assert c["folds"] >= 1 and c["rebuilds"] >= 3 and c["daut_windows"] >= 1
    for dev, _, _ in mesh.blocks:
        assert eng._tables.fp_rows[dev].device == dev

# ------------------------------------------------------- rules (K4)

def _shared_wire(device, strategy, subs, msgs, window):
    """Every client's bytes after ``subs`` subscribe (MQTT 3.1.1, in
    process) and ``msgs`` go through ``Broker.publish_many`` in windows
    of ``window``; and the broker's engine counters."""
    from emqx_tpu_torch.broker.broker import Broker
    from emqx_tpu_torch.broker.channel import Channel
    from emqx_tpu_torch.codec import mqtt as C
    from emqx_tpu_torch.message import Message

    b = Broker(device=device, shared_strategy=strategy)
    raw = {}
    for cid, flts in subs:
        buf = raw[cid] = bytearray()
        ch = Channel(b, send=lambda pkts, buf=buf: buf.extend(
            b"".join(C.serialize(p, C.MQTT_V4) for p in pkts)),
            close=lambda reason: None)
        for pkt in (C.Connect(client_id=cid, proto_ver=C.MQTT_V4),
                    C.Subscribe(packet_id=1, subscriptions=[
                        C.Subscription(topic_filter=f, qos=q)
                        for f, q in flts])):
            for q in C.StreamParser(version=C.MQTT_V4).feed(
                    C.serialize(pkt, C.MQTT_V4)):
                ch.handle_in(q)
    b.router.engine.rebuild()
    for k in range(0, len(msgs), window):
        b.publish_many([Message(topic=t, qos=q, from_client=f,
                                payload=b"%d" % (k + i))
                        for i, (t, q, f) in enumerate(msgs[k:k + window])])
    return {cid: bytes(v) for cid, v in raw.items()}, b.router.engine.counters


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["round_robin", "round_robin_per_group",
                                      "hash_clientid", "hash_topic"])
def test_shared_window_on_card_equals_cpu(cuda, strategy):
    """chip_smoke's shared parity at a small size: ``$share`` groups
    beside direct subscribers, the broker on the card (K1, K3) against
    the broker on the CPU: the same bytes to every client."""
    from emqx_tpu_torch import workload as W

    subs, msgs = W.shared_script(np.random.default_rng(4), 40, 6, 600)
    mk.reset_launches()
    got, counters = _shared_wire("cuda", strategy, subs, msgs, 128)
    launches = mk.launches()
    want, _ = _shared_wire("cpu", strategy, subs, msgs, 128)
    assert got == want
    assert sum(map(len, got.values())) > 10_000
    assert launches["match_batch_compact"] >= 1
    assert launches["decide_packed"] == counters["decide_windows"] >= 1


@pytest.mark.cuda
def test_access_world_on_card_equals_cpu(cuda):
    """chip_smoke's access parity at a small size: authenticated
    clients under the default-ACL world, the load rewrite, delayed
    publishes and topic metrics; the broker on the card (K1, K3) against
    the broker on the CPU: the same bytes to every client and the same
    topic metrics."""
    from emqx_tpu_torch import workload as W

    subs, msgs = W.access_script(np.random.default_rng(5), 24, 400)
    mk.reset_launches()
    got, tm, metrics = W.access_world("cuda", subs, msgs)
    launches = mk.launches()
    want, tm_cpu, _ = W.access_world("cpu", subs, msgs)
    assert got == want and tm == tm_cpu
    assert metrics["authorization.deny"] >= 400 // 8
    assert metrics["messages.delayed"] >= 1
    assert tm[0]["messages.in"] > 0 and tm[0]["messages.out"] > 0
    assert launches["match_batch_compact"] >= 1
    assert launches["decide_packed"] >= 1


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
            assert mk.rules_eval_lowered.launches == len(wins)
            ev = b.router.engine.rules_evaluator
            assert ev._prog[0] == b.rules.rules_rev
    assert out[0] == out[1]


# Seeded stacked programs, laid out as `predicate.build_stack` lays them
# out: random expression trees of up to MAX_STEPS steps in post-order
# over every opcode, some reading the register of a step that writes
# nothing (NOP) or a register of the other kind, over random planes.
_LITS = [0.0, -0.0, 0.5, -3.0, 3.0, 7.0, 1e308, float("inf"), float("nan"),
         2633996730456453632.0, 16777217.0]


def _tree(rng, steps, budget, n_planes, n_lits, numeric):
    """Emit one random subtree; returns its register."""
    from emqx_tpu_torch.rules import predicate as P

    def emit(op, a0=-1, a1=-1, a2=-1, a3=-1, lit=0.0):
        steps.append((op, a0, a1, a2, a3, lit))
        return len(steps) - 1

    def plane():
        return rng.randrange(n_planes)

    if rng.random() < 0.04:
        return emit(P.R_NOP)  # never written: reads clear
    if rng.random() < 0.04:  # a register of the other kind
        return _tree(rng, steps, budget - 1, n_planes, n_lits, not numeric)
    leaf = budget <= 2 or rng.random() < 0.15
    if numeric:
        if leaf:
            return (emit(P.R_NLOAD, plane()) if rng.random() < 0.6
                    else emit(P.R_NLIT, lit=rng.choice(_LITS)))
        if rng.random() < 0.15:
            return emit(P.R_NNEG, _tree(rng, steps, budget - 1, n_planes,
                                        n_lits, True))
        op = rng.choice([P.R_NADD, P.R_NSUB, P.R_NMUL, P.R_NDIV, P.R_NIDV,
                         P.R_NMOD])
    elif leaf:
        kind = rng.randrange(5)
        neg = rng.choice([0, 1])
        if kind == 0:
            return emit(P.R_BLIT, rng.choice([0, 1]))
        if kind == 1:
            return emit(P.R_EQVV, plane(), plane(), neg)
        if kind == 2:
            return emit(P.R_EQVL, plane(), -1, neg, -1, rng.choice(_LITS))
        if kind == 3 and n_lits:
            return emit(P.R_EQSL, plane(), rng.randrange(n_lits), neg)
        return emit(P.R_PRES, plane(), -1, neg)
    else:
        op = rng.choice([P.R_BNOT, P.R_BAND, P.R_BOR, P.R_CGT, P.R_CLT,
                         P.R_CGE, P.R_CLE, P.R_EQC])
    if op == P.R_BNOT:
        return emit(op, _tree(rng, steps, budget - 1, n_planes, n_lits,
                              False))
    # operands: numeric except under BAND / BOR
    num_kids = numeric or op not in (P.R_BAND, P.R_BOR)
    half = rng.randint(1, max(1, budget - 2))
    a = _tree(rng, steps, half, n_planes, n_lits, num_kids)
    b = _tree(rng, steps, budget - 1 - half, n_planes, n_lits, num_kids)
    if op in (P.R_CGT, P.R_CLT, P.R_CGE, P.R_CLE):
        ranks = rng.random() < 0.4
        return emit(op, a, b, plane() if ranks else -1,
                    plane() if ranks else -1)
    if op == P.R_EQC:
        return emit(op, a, b, rng.randrange(8),
                    plane() if rng.random() < 0.5 else -1)
    return emit(op, a, b)


def widest_program(n_planes):
    """The widest live set the lowering allows: a compare of two
    balanced sums of 8 negated loads (47 steps), so 5 numeric registers
    hold values at once."""
    from emqx_tpu_torch.rules import predicate as P

    steps = []

    def emit(op, a0=-1, a1=-1):
        steps.append((op, a0, a1, -1, -1, 0.0))
        return len(steps) - 1

    def tree(depth, k):
        if depth == 1:
            return emit(P.R_NNEG, emit(P.R_NLOAD, k % n_planes))
        left = tree(depth - 1, 2 * k)
        right = tree(depth - 1, 2 * k + 1)
        return emit([P.R_NADD, P.R_NMUL, P.R_NSUB][depth % 3], left, right)

    left = tree(4, 0)
    emit(P.R_CGE, left, tree(4, 1))
    return steps


def random_programs(seed, n_rules, n_planes, n_lits):
    """``(code, a0, a1, a2, a3, litn, last)`` of ``n_rules`` random
    programs of 1..MAX_STEPS steps, the widest one first."""
    from emqx_tpu_torch.rules.predicate import MAX_STEPS, R_NOP

    rng = random.Random(seed)
    progs = [widest_program(n_planes)]
    while len(progs) < n_rules:
        steps = []
        _tree(rng, steps, rng.randint(1, 60), n_planes, n_lits, False)
        if len(steps) <= MAX_STEPS:
            progs.append(steps)
    width = max(len(p) for p in progs)
    out = [np.full((n_rules, width), -1, np.int32) for _ in range(5)]
    out[0][:] = R_NOP
    litn = np.zeros((n_rules, width), np.float64)
    for r, steps in enumerate(progs):
        for s, (op, *args, lit) in enumerate(steps):
            out[0][r, s] = op
            for k, v in enumerate(args):
                out[k + 1][r, s] = v
            litn[r, s] = lit
    last = np.array([len(p) - 1 for p in progs], np.int32)
    return (*out, litn, last)


def random_planes(seed, n_planes, w, n_lits):
    """``(num, sid, err, prs, lit_ranks)``: a window's planes with NaN,
    infinities, signed zeros, the FMA-trap values and strings."""
    rng = np.random.default_rng(seed)
    num = rng.choice(np.array(_LITS + [1.0, 2.0, 0.25, 9385959.583563903,
                                       2834748.6238531545,
                                       -26606836013049.1]),
                     (n_planes, w))
    sid = rng.integers(-3, 6, (n_planes, w)).astype(np.int32)
    err = rng.random((n_planes, w)) < 0.1
    prs = ~err & (rng.random((n_planes, w)) < 0.7)
    lit_ranks = rng.integers(-1, 6, n_lits).astype(np.int32)
    return num, sid, err, prs, lit_ranks


@pytest.mark.cuda
@pytest.mark.parametrize("n_rules,w,n_planes", [
    (300, 1, 5), (300, 33, 5), (300, 130, 5), (300, 4097, 5),
    (70_000, 5, 5),  # more rule blocks than gridDim.y could hold
    (200, 100, 60),  # planes past the shared tile: read from L1
])
def test_rules_kernel_lowered_programs(cuda, n_rules, w, n_planes):
    from emqx_tpu_torch.ops.rules_lowering import RULES_NUM_SLOTS
    from emqx_tpu_torch.state import rules_lowered_from_reference

    n_lits = 4
    progs = random_programs(11, min(n_rules, 300), n_planes, n_lits)
    if n_rules > 300:  # the same programs, tiled
        reps = -(-n_rules // 300)
        progs = tuple(np.ascontiguousarray(np.concatenate(
            [a] * reps)[:n_rules]) for a in progs)
    planes = random_planes(w, n_planes, w, n_lits)
    num, sid, err, prs, lit_ranks = (torch.from_numpy(a).to(cuda)
                                     for a in planes)
    low = rules_lowered_from_reference(*progs, cuda, n_lits=n_lits)
    # the widest program keeps all RULES_NUM_SLOTS numeric registers
    rec = low.steps[0].cpu().numpy()
    numeric = (rec[:, 0] & 0xFF) <= 9
    assert ((rec[numeric, 0] >> 8) & 0xFF).max() == RULES_NUM_SLOTS - 1
    mk.reset_launches()
    got = mk.rules_eval_lowered(low, lit_ranks, num, sid, err, prs)
    lowered = mk.rules_eval_lowered_plain(*low[:3], lit_ranks, num, sid,
                                          err, prs)
    stacked = mk.rules_eval_plain(
        *(torch.from_numpy(a).to(cuda) for a in progs[:6]), lit_ranks,
        torch.from_numpy(progs[6]).to(cuda), num, sid, err, prs)
    torch.cuda.synchronize()
    assert got.shape == (n_rules, w) and got.device.type == "cuda"
    assert torch.equal(got, lowered)
    assert torch.equal(got, stacked)
    assert mk.rules_eval_lowered.launches == 1


# -------------------------------------------- sharded match (K5)


@pytest.mark.cuda
@pytest.mark.parametrize("world,f_width,m_cap,n_shards", [
    ("random", 8, 64, 4), ("random", 2, 4, 4), ("random", 5, 16, 1),
    ("full", 16, 128, 4), ("full", 16, 24, 1), ("full", 7, 128, 4),
])
def test_sharded_kernel_equals_plain(cuda, world, f_width, m_cap, n_shards):
    from emqx_tpu_torch.parallel import sharded as sh
    from emqx_tpu_torch.state import sharded_tables_from_reference

    if world == "full":
        filters, topics = _full_world(496)
        filters = [(fid, ws) for fid, ws in filters if fid % 4 != 3]
    else:
        filters, topics = _world(f_width, 1200, 500)
        # no fid in shard 3: an empty, all-padding partition
        filters = [(fid, ws) for fid, ws in filters
                   if fid % 4 != 3 and ("+" in ws or "#" in ws)]
    td = TokenDict()
    idx = sh.build_sharded_index(filters, td, n_shards, max_levels=8)
    tok, ln, dol = encode_topics(td, topics[:496], idx.kernel_levels)
    mesh = sh.make_mesh(devices=[cuda] * n_shards, sub=n_shards)
    placed = sharded_tables_from_reference(*idx.tables, mesh)
    (key,) = placed.fp_rows
    args = (placed.fp_rows[key], placed.node_rows[key], placed.salts[key],
            *(torch.from_numpy(a).to(cuda) for a in (tok, ln, dol)))
    mk.reset_launches()
    got = sh.sharded_match(mesh, *placed, tok, ln, dol, f_width=f_width,
                           m_cap=m_cap)
    assert mk.sharded_match_local.launches == 1  # one card, one launch
    plain = mk.sharded_match_plain(*args, f_width=f_width, m_cap=m_cap)
    cpu = sh.sharded_match(sh.make_mesh(devices=["cpu"] * n_shards,
                                        sub=n_shards),
                           *idx.tables, tok, ln, dol, f_width=f_width,
                           m_cap=m_cap)
    torch.cuda.synchronize()
    for g, p, c in zip(got, plain, cpu):
        assert g.device.type == "cuda" and g.dtype == c.dtype
        assert torch.equal(g, p) and torch.equal(g.cpu(), c)
    assert int(got[3].sum()) > 0
    if n_shards == 4 and world == "random":
        assert not got[1][3].any()
    # K2 on each shard's slice gives the same codes (one scan body)
    for k in range(n_shards):
        dense = mk.match_batch(args[0][k], args[1][k],
                               int(idx.tables[2][k]), *args[3:],
                               f_width=f_width, m_cap=m_cap)
        for d, g in zip(dense, got[:3]):
            assert torch.equal(d, g[k])


@pytest.mark.cuda
def test_sharded_engine_on_card_equals_host_trie(cuda):
    from emqx_tpu_torch import topic as T
    from emqx_tpu_torch.parallel import sharded as sh

    filters, topics = _world(4, 2000, 800)
    filters = [(fid, ws) for fid, ws in filters if "/".join(ws)]
    eng = sh.ShardedMatchEngine(sh.make_mesh(devices=[cuda] * 4, sub=4),
                                max_levels=8, f_width=8, m_cap=64,
                                rebuild_threshold=10**9)
    eng.insert_many([("/".join(ws), fid) for fid, ws in filters])
    eng.rebuild()
    names = ["/".join(t) for t in topics if t]

    def check():
        for t, g in zip(names, eng.match_batch(names)):
            assert g == eng.match_host(T.words(t)), t

    mk.reset_launches()
    check()
    eng.insert("a/+/x", 10**6)
    eng.insert_many([(f"b/{i % 7}/+", 10**6 + 1 + i) for i in range(300)])
    eng.delete(filters[0][0])
    eng.delete(filters[5][0])
    check()
    eng.rebuild()
    check()
    assert mk.sharded_match_local.launches == 3


@pytest.mark.cuda
@pytest.mark.parametrize("n_cards,sub", [(2, 2), (4, 2), (4, 4)])
def test_sharded_match_across_cards_equals_one_card(cuda, n_cards, sub):
    """Each card its own block of the mesh: one launch per card, the
    outputs and partial totals added on the first card, equal to the
    same grid on one card; the sharded engine there equals the host
    trie before and after churn."""
    from emqx_tpu_torch import topic as T
    from emqx_tpu_torch.parallel import sharded as sh

    if torch.cuda.device_count() < n_cards:
        pytest.skip(f"needs {n_cards} CUDA devices")
    filters, topics = _world(n_cards + sub, 1200, 496)
    filters = [(fid, ws) for fid, ws in filters if "+" in ws or "#" in ws]
    td = TokenDict()
    idx = sh.build_sharded_index(filters, td, sub, max_levels=8)
    tok, ln, dol = encode_topics(td, topics, idx.kernel_levels)
    mesh = sh.make_mesh(n_cards, sub=sub)
    assert len(mesh.blocks) == n_cards
    one = sh.make_mesh(devices=[cuda] * n_cards, sub=sub)
    mk.reset_launches()
    got = sh.sharded_match(mesh, *idx.tables, tok, ln, dol, f_width=4,
                           m_cap=16)
    assert mk.sharded_match_local.launches == n_cards
    want = sh.sharded_match(one, *idx.tables, tok, ln, dol, f_width=4,
                            m_cap=16)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.device == torch.device("cuda", 0) and torch.equal(g, w)
    assert int(got[3].sum()) > 0 and bool(got[2].any())

    eng = sh.ShardedMatchEngine(mesh, max_levels=8, f_width=8, m_cap=64,
                                rebuild_threshold=10**9)
    eng.insert_many([("/".join(ws), fid) for fid, ws in filters])
    eng.rebuild()
    names = ["/".join(t) for t in topics if t]

    def check():
        for t, g in zip(names, eng.match_batch(names)):
            assert g == eng.match_host(T.words(t)), t

    check()
    eng.insert_many([(f"b/{i % 7}/+", 10**6 + i) for i in range(300)])
    eng.delete(filters[0][0])
    check()
    eng.rebuild()
    check()


# ------------------------------------------------ one predicate (K6)

PRED_CORPUS = [
    "payload.a > 2", "payload.a >= payload.b", "payload.a = 3",
    "payload.s = 'x'", "payload.s != 'nowhere'", "payload.s IN ('x', 'q')",
    "qos IN (1, 2)", "retain != 1", "NOT (payload.a > 0) AND payload.b <= 2",
    "payload.m = payload.n", "payload.s = payload.s2",
    "payload.a = 1 OR payload.missing > 1", "payload.obj = payload.obj2",
    "payload.a + 1 >= payload.b * 2", "payload.a div payload.b = 1",
    "payload.a mod 3 = 0", "payload.a / payload.b > 1",
    "payload.a - 0.5 < payload.b", "-payload.a > 1",
    "payload.a * payload.b + payload.c = 0", "payload.a + 1 = payload.b * 2",
    "payload.s != qos + 1", "payload.x IN (1, 'y', payload.a)",
    "'x' IN (payload.s, payload.s2)", "true AND payload.a < 9 OR false",
    "payload.a < 1 OR payload.b <= 1 AND payload.c >= 0",
]


@pytest.mark.cuda
def test_predicate_kernel_equals_plain(cuda):
    from emqx_tpu_torch.message import Message
    from emqx_tpu_torch.rules import predicate as P
    from emqx_tpu_torch.rules.runtime import build_env
    from emqx_tpu_torch.rules.sql import parse_sql
    from emqx_tpu_torch.state import (
        predicate_columns_from_reference, predicate_program_from_code,
    )

    rng = random.Random(6)
    payloads = TRAP_PAYLOADS + [
        b'{"a": %d, "b": %d, "s": "%s", "s2": "%s", "x": %s}' % (
            rng.randint(-5, 5), rng.randint(0, 3), rng.choice("xyzq").encode(),
            rng.choice("xy").encode(), rng.choice([b"1", b'"y"', b"2"]))
        for _ in range(700)]
    envs = [build_env(Message(topic="t/1", payload=p, qos=k % 3,
                              retain=bool(k % 2), from_client="c1"))
            for k, p in enumerate(payloads)]
    seen = set()
    mk.reset_launches()
    for src in PRED_CORPUS:
        prog = P.compile_where(parse_sql(
            f'SELECT * FROM "t" WHERE {src}').where)
        got = prog.eval_batch(envs, device=cuda)
        assert np.array_equal(got, prog.eval_batch(envs, device="cpu")), src
        cols, sdict = prog.extract_columns(envs)
        pc = predicate_columns_from_reference(
            cols, P._literal_ids(prog.where, sdict), cuda)
        code = P.lower_predicate(prog.where, prog.var_paths)
        seen |= set(code.steps[:, 0].tolist())
        dc = predicate_program_from_code(code, cuda)
        args = (dc.steps, dc.lit, dc.result, pc.num, pc.sid, pc.err,
                pc.lit_ids)
        kern = mk.predicate_eval_batch(*args, slots=dc.slots)
        plain = mk.predicate_eval_plain(*args)
        torch.cuda.synchronize()
        assert kern.device.type == "cuda" and torch.equal(kern, plain), src
        if src == "payload.a mod 3 = 0":  # the FMA payloads, as numpy
            assert bool(kern[0])
        if src == "payload.a * payload.b + payload.c = 0":
            assert bool(kern[1])
    assert seen == set(range(P.P_NLOAD, P.P_EQS + 1))  # every opcode
    assert mk.predicate_eval_batch.launches == 2 * len(PRED_CORPUS)


def _balanced(depth):
    """A numeric tree over payload.a and payload.b needing depth + 1
    registers in Sethi-Ullman order (subtrees shared)."""
    left, right = ("var", ("payload", "a")), ("var", ("payload", "b"))
    for _ in range(depth):
        left, right = ("op", "+", left, right), ("op", "-", right, left)
    return left


@pytest.mark.cuda
def test_predicate_kernel_every_instance(cuda):
    """Each of K6's instances (2, 4, 8 and 16 numeric registers) runs a
    program that needs it, and the widest runs them all, over a batch
    with a ragged end (W = 1,000 is no multiple of any block's
    messages); an IN list past two staged chunks of steps, too.  All
    equal the plain version."""
    from emqx_tpu_torch.message import Message
    from emqx_tpu_torch.rules import predicate as P
    from emqx_tpu_torch.rules.runtime import build_env
    from emqx_tpu_torch.state import (
        predicate_columns_from_reference, predicate_program_from_code,
    )

    rng = random.Random(16)
    envs = [build_env(Message(topic="t/1", payload=b'{"a": %s, "b": %d}' % (
        rng.choice([b"1.5", b"-3", b"7", b"1e308", b'"s"']),
        rng.randint(-4, 4)), qos=1, from_client="c1")) for _ in range(1000)]
    wheres = [("op", "<", _balanced(d), ("lit", 5.0)) for d in (1, 3, 7, 15)]
    wheres.append(("in", ("var", ("payload", "b")),
                   [("lit", float(i)) for i in range(-150, 150)]))
    mk.reset_launches()
    widths = []
    for where in wheres:
        prog = P.compile_where(where)
        code = P.lower_predicate(prog.where, prog.var_paths)
        cols, sdict = prog.extract_columns(envs)
        pc = predicate_columns_from_reference(
            cols, P._literal_ids(prog.where, sdict), cuda)
        dc = predicate_program_from_code(code, cuda)
        widths.append(next(n for n in (2, 4, 8, 16) if n >= dc.slots))
        args = (dc.steps, dc.lit, dc.result, pc.num, pc.sid, pc.err,
                pc.lit_ids)
        plain = mk.predicate_eval_plain(*args)
        for slots in (dc.slots, P.PRED_REGS):
            kern = mk.predicate_eval_batch(*args, slots=slots)
            torch.cuda.synchronize()
            assert torch.equal(kern, plain), (len(code.steps), slots)
        assert np.array_equal(prog.eval_batch(envs, device=cuda),
                              plain.cpu().numpy())
    assert widths == [2, 4, 8, 16, 4]  # an IN's or-chain names 3
    assert mk.predicate_eval_batch.launches == 3 * len(wheres)


@pytest.mark.cuda
def test_rules_kernel_planes_past_int32_and_65535_slices(cuda):
    """P = 257 planes x W = 8,388,608 messages (30 GB of planes): the
    last plane starts at element 2^31 (the unstaged instance's 64-bit
    offsets) and W has 65,536 slices of 128 messages, one more than
    gridDim.y holds (the slice loop: the blocks of grid row 0 run the
    first slice and the last).  A column's result depends only on that
    column, so the kernel's first and last 4,096 columns equal the plain
    version on those columns sliced."""
    from emqx_tpu_torch.rules import predicate as P
    from emqx_tpu_torch.state import rules_lowered_from_reference

    p, w, n_lits = 257, 8_388_608, 4
    free, _ = torch.cuda.mem_get_info()
    if free < 36 * 2**30:
        pytest.skip(f"needs 36 GiB of free card memory, has {free >> 30}")
    progs = random_programs(17, 64, p, n_lits)
    # every plane operand onto the last four planes: plane 256 starts at
    # element 2^31, past any int32 offset
    code, a0, a1, a2, a3 = progs[:5]
    ordered = (code >= P.R_CGT) & (code <= P.R_CLE)
    for arr, mask in (
            (a0, np.isin(code, [P.R_NLOAD, P.R_EQVV, P.R_EQVL, P.R_EQSL,
                                P.R_PRES])),
            (a1, code == P.R_EQVV), (a2, ordered),
            (a3, ordered | (code == P.R_EQC))):
        sel = mask & (arr >= 0)
        arr[sel] = p - 1 - arr[sel] % 4
    assert ((code == P.R_NLOAD) & (a0 == p - 1)).any()
    low = rules_lowered_from_reference(*progs, cuda, n_lits=n_lits)
    small = random_planes(5, p, 4096, n_lits)
    reps = w // 4096
    num, sid, err, prs = (torch.from_numpy(a).to(cuda).repeat(1, reps)
                          for a in small[:4])
    lit_ranks = torch.from_numpy(small[4]).to(cuda)
    # vary the tile so columns far apart differ
    num[:, -4096:] = torch.flip(num[:, -4096:], (1,))
    sid[:, -4096:] = torch.roll(sid[:, -4096:], 7, 1)
    got = mk.rules_eval_lowered(low, lit_ranks, num, sid, err, prs)
    torch.cuda.synchronize()
    assert got.shape == (64, w)
    for start in (0, w - 4096):
        cols = slice(start, start + 4096)
        want = mk.rules_eval_lowered_plain(
            *low[:3], lit_ranks, *(t[:, cols].contiguous()
                                   for t in (num, sid, err, prs)))
        assert torch.equal(got[:, cols], want), start
    assert torch.equal(got[:, :4096], got[:, 4096:8192])


@pytest.mark.cuda
def test_listeners_fairness_window_split_on_card(cuda):
    """The per-source lanes on the card: ``light``'s one message rides
    the first window of ``flood``'s 600 (windows of 512 and 89), and the
    subscriber's bytes equal the CPU broker's."""
    from emqx_tpu_torch import workload as W

    got = W.fairness_world("cuda")
    assert got == W.fairness_world("cpu")
    assert got[1] == [512, 89]


async def _round_trip(port, kind, tag):
    """One QoS 1 round trip on one transport; each client's bytes."""
    from emqx_tpu_torch.codec import mqtt as C
    from emqx_tpu_torch.workload import TransportClient

    sub = TransportClient(port, f"sub-{tag}", kind)
    pub = TransportClient(port, f"pub-{tag}", kind)
    await sub.connect()
    await pub.connect()
    await sub.subscribe(f"rt/{tag}/#", 1)
    pub.send(C.Publish(topic=f"rt/{tag}/x", payload=b"hi", qos=1,
                       packet_id=7))
    await pub.expect(C.PUBACK)
    got = await sub.expect(C.PUBLISH)
    sub.send(C.Puback(packet_id=got.packet_id))
    for c in (sub, pub):
        c.send(C.Disconnect())
        await c.eof()
    return bytes(sub.raw), bytes(pub.raw)


@pytest.mark.cuda
def test_listeners_tcp_and_ws_on_card_equal_cpu(cuda):
    """A `BrokerServer` booted from a config with a tcp and a ws
    listener on the card: a round trip on each writes the CPU server's
    bytes, and the card's broker launched K1 and K3."""
    import asyncio

    from emqx_tpu_torch.broker.listener import BrokerServer
    from emqx_tpu_torch.config import ConfigHandler

    conf = {"listeners": [
        {"name": "t", "type": "tcp", "bind": "127.0.0.1", "port": 0},
        {"name": "w", "type": "ws", "bind": "127.0.0.1", "port": 0}]}

    async def run(device):
        srv = BrokerServer(ConfigHandler.from_dict(conf).root, device=device)
        try:
            await srv.start()
            eng = srv.broker.router.engine
            eng.insert_many([(f"bg/{i}/+", 10_000 + i) for i in range(1000)])
            eng.rebuild()
            out = []
            for lst in srv.listeners:
                out.append(await _round_trip(lst.port, lst.cfg.type,
                                             lst.cfg.type))
            return out
        finally:
            await srv.stop()

    mk.reset_launches()
    got = asyncio.run(asyncio.wait_for(run("cuda"), 120))
    n = mk.launches()
    assert got == asyncio.run(asyncio.wait_for(run("cpu"), 120))
    assert n["match_batch_compact"] >= 2 and n["decide_packed"] >= 2, n


@pytest.mark.cuda
def test_rules_kernel_reads_only_the_where_prefix_on_card(cuda):
    """The SELECT lane appends SELECT-only planes to the window's
    columns: the evaluator stages and uploads only the WHERE prefix,
    and K4's matrix equals the one without the appended planes, and the
    plain version's on the CPU."""
    from emqx_tpu_torch.message import Message
    from emqx_tpu_torch.rules.columns import WindowColumns
    from emqx_tpu_torch.rules.evaluator import RulesEvaluator
    from emqx_tpu_torch.rules.predicate import build_stack
    from emqx_tpu_torch.rules.select import build_select_stack
    from emqx_tpu_torch.rules.sql import parse_sql

    rng = random.Random(8)
    rules = [(f"r{i}", f'SELECT *, payload.t AS t FROM "t/#" WHERE {p}')
             for i, p in enumerate(RULE_CORPUS)]
    stack = build_stack([(rid, parse_sql(q).where) for rid, q in rules])
    sel = build_select_stack([(rid, parse_sql(q)) for rid, q in rules],
                             stack.paths)
    assert len(sel.all_paths) > len(stack.paths)
    msgs = []
    for k in range(300):
        body = rng.choice(TRAP_PAYLOADS)
        if body[:1] == b"{" and rng.random() < 0.7:
            body = body[:-1] + b', "t": "%s"}' % rng.choice(
                [b"aa", b"zz", b"m"])
        msgs.append(Message(topic="t/1", payload=body, qos=k % 3,
                            from_client=f"c{k % 5}"))
    plain = WindowColumns(msgs, stack.paths, stack.lit_strings)
    wide = WindowColumns(msgs, sel.all_paths, stack.lit_strings,
                         keep_values=True)
    ev = RulesEvaluator("cuda")
    shapes = []
    views = ev._stage.views

    def spy(specs):
        shapes.append([s for _, s in specs])
        return views(specs)

    ev._stage.views = spy
    mk.reset_launches()
    a = ev.eval_window(stack, 1, plain)[0]
    b = ev.eval_window(stack, 1, wide)[0]
    assert mk.launches()["rules_eval_lowered"] == 2
    p = len(stack.paths)
    assert [s[0] for s in shapes] == [(p, len(msgs))] * 2
    assert np.array_equal(a, b)
    want = RulesEvaluator("cpu").eval_window(stack, 1, wide)[0]
    assert np.array_equal(b, want)
    assert a.any() and not a.all()


@pytest.mark.cuda
def test_mgmt_world_on_card_equals_cpu(cuda):
    """chip_smoke's management-API script at a small size, on the card
    and on the CPU, response for response: each REST publish's
    delivered count, each rule's counters, the subscribers' bytes, the
    metrics and every read-back; K1, K3 and K4 launched on the card, K4
    once a rules window."""
    from emqx_tpu_torch import workload as W

    mk.reset_launches()
    got = W.mgmt_world("cuda")
    launches = mk.launches()
    want = W.mgmt_world("cpu")
    assert W.mgmt_outcome(got) == W.mgmt_outcome(want)
    eng = got["engine"]
    assert launches["match_batch_compact"] >= 1
    assert launches["decide_packed"] == eng["decide_windows"] >= 1
    assert launches["rules_eval_lowered"] == eng["rules_dev_windows"] >= 1
    assert eng["rules_host_windows"] == 0
    assert got["refusals"][:3] == [401, 403, 403]


@pytest.mark.cuda
def test_authdb_world_on_card_equals_cpu(cuda):
    """chip_smoke's auth back-end world at a small size (4,000 filters,
    64 clients over the GCP, LDAP, HTTP and Mongo back ends), on the card
    and on the CPU: every client's bytes, the metrics and what each back
    end was asked (one ACL find a client, none after CONNECT); K1 and K3
    launched on the card, K3 once a decide window."""
    from emqx_tpu_torch import workload as W

    script = W.authdb_script(14, 64, 256, n_gcp=(4, 4), n_msgs=256)
    impl, made = W.port_impl("cuda"), []
    serve = impl.server
    impl.server = lambda cfg: made.append(serve(cfg)) or made[-1]
    mk.reset_launches()
    got = W.authdb_world("cuda", script, impl=impl)
    launches = mk.launches()
    want = W.authdb_world("cpu", script)
    assert got["bytes"] == want["bytes"]
    assert got["asked"] == want["asked"]
    assert got["metrics"] == want["metrics"]
    decides = made[0].broker.router.engine.counters["decide_windows"]
    assert launches["match_batch_compact"] >= 1
    assert launches["decide_packed"] == decides >= 1
    assert got["asked"]["mongo"] == got["asked"]["before_publish"][0]


@pytest.mark.cuda
def test_sinks_world_on_card_equals_cpu(cuda):
    """chip_smoke's sinks broker world in process at a small size:
    config 4's rules with sink, template and aggregate actions and the
    Avro rule, on the card (K1, K4) and on the CPU: the same sink
    queries, aggregator bodies, rule counters and action metrics, in
    the batched lane and against the scalar referee."""
    from emqx_tpu_torch import workload as W

    wins = W.sink_windows(np.random.default_rng(6), 4, 256,
                          W.populations(1000, 8))
    mk.reset_launches()
    got = W.sinks_world("cuda", wins, "batched")
    launches = mk.launches()
    want = W.sinks_world("cpu", wins, "batched")
    scalar = W.sinks_world("cuda", wins, "scalar")
    assert got[:4] == want[:4]
    assert got[0] == scalar[0] and got[2] == scalar[2]
    assert b"".join(got[1]) == b"".join(scalar[1])
    st = got[4]
    assert st["select_lowered"] == 99 and st["dev_windows"] == len(wins)
    assert st["select_scalar_rows"] == got[2]["avro"][1] == 4 * 32
    assert st["select_batched_rows"] > 0
    assert launches["match_batch_compact"] >= len(wins)
    assert launches["rules_eval_lowered"] == len(wins)


@pytest.mark.cuda
def test_exhook_world_on_card_equals_cpu(cuda):
    """chip_smoke's exhook world at a small size (4,000 filters, 16
    clients, 96 publishes through the port's exhook client and the
    provider fixture on the port's own gRPC server), on the card and on
    the CPU: the CONNACK and PUBACK codes, every client's bytes, the
    provider's requests and the metrics; K1 and K3 once a decide window
    on the card, and `ExhookServer`'s answers equal too."""
    from emqx_tpu_torch import workload as W

    script = W.exhook_script(15, n_clients=16, n_msgs=96)
    got = W.exhook_world("cuda", script)
    want = W.exhook_world("cpu", script)
    for key in ("connacks", "pubacks", "bytes", "requests", "counts",
                "metrics"):
        assert got[key] == want[key], key
    decides = got["decide_windows"]
    assert got["launches"]["match_batch_compact"] == decides >= 1
    assert got["launches"]["decide_packed"] == decides
    calls = W.exhook_server_script(15, 64)
    card = W.exhook_server_world("cuda", calls)
    cpu = W.exhook_server_world("cpu", calls)
    assert card["responses"] == cpu["responses"]
    assert card["fired"] == cpu["fired"]
    assert card["launches"]["match_batch_compact"] == card["publishes"]


def test_durable_world_on_card_equals_cpu(cuda):
    """chip_smoke's durable parity world (20,000 filters, 32 persistent
    sessions, 2,000 messages): after a restart the resume scheduler
    replays every backlog, windowed (replay windows decided by K3 on
    the card) and scalar; the card's client bytes equal the CPU's, and
    the windowed replay launched K3."""
    from emqx_tpu_torch import workload as W

    script = W.durable_script(16, 32, 2000)
    for windowed in (True, False):
        card = W.durable_world("cuda", script, windowed=windowed)
        cpu = W.durable_world("cpu", script, windowed=windowed)
        assert card["bytes"] == cpu["bytes"], windowed
        assert card["metrics"] == cpu["metrics"], windowed
        assert card["committed"] == len(script["sessions"])
        assert card["publish_launches"]["match_batch_compact"] > 0
        if windowed:
            assert card["replay_launches"]["decide_packed"] == \
                card["metrics"]["session.replay.windows"] > 0
