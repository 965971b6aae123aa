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


@pytest.mark.cuda
@pytest.mark.parametrize("f_width,m_cap,c_cap", [(8, 64, 1024), (2, 4, 64),
                                                 (16, 128, 37)])
def test_match_kernels_equal_plain(cuda, f_width, m_cap, c_cap):
    filters, topics = _world(f_width)
    td = TokenDict()
    aut = build_automaton(filters, td, max_levels=8)
    tok, ln, dol = encode_topics(td, topics, aut.kernel_levels)
    cpu = [torch.from_numpy(a) for a in (aut.fp_rows, aut.node_rows, tok,
                                         ln, dol)]
    gpu = [t.to(cuda) for t in cpu]
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
