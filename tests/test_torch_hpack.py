"""HPACK (`emqx_tpu_torch.hpack`): the Huffman code written as code
lengths (its Kraft sum, EOS, RFC 7541's examples), every byte value
Huffman-coded by the port read by a grpcio server, grpcio's own coded
headers read by the port, the dynamic table's eviction and size
updates."""

import threading
from concurrent import futures
from fractions import Fraction

import grpc
import pytest

from emqx_tpu_torch import grpc_util as G
from emqx_tpu_torch import hpack as H


def test_huffman_code_is_complete_and_eos_is_thirty_ones():
    lengths = [n for _, n in H.HUFFMAN_CODES]
    assert len(lengths) == 257
    assert sum(Fraction(1, 2 ** n) for n in lengths) == 1  # Kraft: full
    assert H.HUFFMAN_CODES[H.EOS] == ((1 << 30) - 1, 30)
    assert len({c for c in H.HUFFMAN_CODES}) == 257
    # RFC 7541 Appendix B spot checks
    assert H.HUFFMAN_CODES[ord("a")] == (0x3, 5)
    assert H.HUFFMAN_CODES[ord(" ")] == (0x14, 6)
    assert H.HUFFMAN_CODES[0] == (0x1ff8, 13)
    assert H.HUFFMAN_CODES[255] == (0x3ffffee, 26)


@pytest.mark.parametrize("text,coded", [
    (b"www.example.com", "f1e3c2e5f23a6ba0ab90f4ff"),
    (b"no-cache", "a8eb10649cbf"),
    (b"custom-key", "25a849e95ba97d7f"),
    (b"custom-value", "25a849e95bb8e8b4bf"),
])
def test_huffman_rfc7541_examples(text, coded):
    assert H.huffman_encode(text).hex() == coded
    assert H.huffman_decode(bytes.fromhex(coded)) == text


def test_huffman_round_trip_and_bad_padding():
    data = bytes(range(256)) * 2
    assert H.huffman_decode(H.huffman_encode(data)) == data
    with pytest.raises(H.HpackError):
        H.huffman_decode(b"\xff\xff\xff\xff")  # EOS inside the string
    with pytest.raises(H.HpackError):
        H.huffman_decode(b"\x00")  # padding of zeros ('0' is 00000)
    with pytest.raises(H.HpackError):
        H.huffman_decode(H.huffman_encode(b"a") + b"\xff")  # 8+ bits pad


def test_rfc7541_c4_requests_with_huffman_share_a_dynamic_table():
    dec = H.Decoder()
    b = lambda *hs: [(n.encode(), v.encode()) for n, v in hs]  # noqa: E731
    assert dec.decode(bytes.fromhex(
        "828684418cf1e3c2e5f23a6ba0ab90f4ff")) == b(
        (":method", "GET"), (":scheme", "http"), (":path", "/"),
        (":authority", "www.example.com"))
    assert dec.decode(bytes.fromhex("828684be5886a8eb10649cbf")) == b(
        (":method", "GET"), (":scheme", "http"), (":path", "/"),
        (":authority", "www.example.com"), ("cache-control", "no-cache"))
    assert dec.decode(bytes.fromhex(
        "828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf")) == b(
        (":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
        (":authority", "www.example.com"), ("custom-key", "custom-value"))
    assert dec.table.entries == b(
        ("custom-key", "custom-value"), ("cache-control", "no-cache"),
        (":authority", "www.example.com"))
    assert dec.table.size == 164


def test_dynamic_table_eviction_and_size_updates():
    enc = H.Encoder(indexing=True, max_table_size=256)
    dec = H.Decoder(max_table_size=256)
    dec.table.resize(256)
    blocks = [[("x-key-%d" % i, "v" * 40)] for i in range(6)]
    for hs in blocks:
        got = dec.decode(enc.encode(hs))
        assert got == [(n.encode(), v.encode()) for n, v in hs]
        assert dec.table.entries == enc.table.entries
        assert dec.table.size <= 256
    # 82 bytes an entry: three fit in 256, the oldest went first
    assert [n for n, _ in dec.table.entries] == [b"x-key-5", b"x-key-4",
                                                 b"x-key-3"]
    # a repeat is indexed: one byte
    assert enc.encode([("x-key-5", "v" * 40)]) == bytes([0x80 | 62])
    # a size update to 0 empties the table; then it may grow back
    enc.set_max_table_size(0)
    enc.set_max_table_size(256)
    block = enc.encode([("x-new", "1")])
    assert block[:1] == b"\x20"  # the update leads the block
    dec.decode(block)
    assert dec.table.entries == [(b"x-new", b"1")]
    with pytest.raises(H.HpackError):
        H.Decoder(max_table_size=100).decode(H.encode_int(200, 5, 0x20))
    with pytest.raises(H.HpackError):  # an update after a field
        dec.decode(bytes([0x82]) + H.encode_int(10, 5, 0x20))
    with pytest.raises(H.HpackError):
        dec.decode(bytes([0x80 | 70]))  # past the table


def test_integer_prefix_boundaries():
    for prefix in (4, 5, 6, 7):
        for v in (0, (1 << prefix) - 2, (1 << prefix) - 1, 1 << prefix,
                  1337, 2 ** 31):
            got, pos = H.decode_int(H.encode_int(v, prefix), 0, prefix)
            assert got == v
    assert H.encode_int(1337, 5) == bytes([31, 154, 10])  # RFC C.1.2


def _echo_metadata(req, ctx):
    return b"".join(v for k, v in ctx.invocation_metadata()
                    if k == "x-all-bin")


def test_every_byte_huffman_coded_by_the_port_reaches_grpcio():
    srv = grpc.server(futures.ThreadPoolExecutor(2))
    srv.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        "t.S", {"Echo": grpc.unary_unary_rpc_method_handler(
            _echo_metadata)}),))
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    ch = G.Channel(f"127.0.0.1:{port}", huffman="always", true_binary=True)
    coded = []
    real = H.huffman_encode

    def spy(data):
        coded.append(bytes(data))
        return real(data)

    try:
        H.huffman_encode = spy
        every = bytes(range(256))
        got = ch.unary_unary("/t.S/Echo")(b"", timeout=10,
                                          metadata=[("x-all-bin", every)])
        assert got == every
        assert b"\x00" + every in coded  # the value went Huffman-coded
    finally:
        H.huffman_encode = real
        ch.close()
        srv.stop(0)


def test_grpcio_huffman_coded_headers_decode_in_the_port():
    seen = []
    decoded = []
    real = H.huffman_decode

    def spy(data):
        out = real(data)
        decoded.append(out)
        return out

    srv = G.Server(2)
    srv.add_method("/t.S/Echo", lambda req, ctx: seen.append(
        ctx.invocation_metadata()) or b"ok")
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    ch = grpc.insecure_channel(f"127.0.0.1:{port}")
    value = bytes(range(256))
    try:
        H.huffman_decode = spy
        assert ch.unary_unary("/t.S/Echo")(
            b"x", timeout=10, metadata=[("x-all-bin", value),
                                        ("x-text", "hello world")]) == b"ok"
    finally:
        H.huffman_decode = real
        ch.close()
        srv.stop(0).wait()
    md = dict(seen[0])
    assert md["x-all-bin"] == value and md["x-text"] == "hello world"
    assert decoded, "grpcio sent no Huffman-coded string"


def test_decoder_is_thread_confined_per_connection():
    # one decoder per connection, used by its reader thread only: two
    # connections decoding at once keep separate tables
    a, b = H.Decoder(), H.Decoder()
    block_a = H.Encoder(indexing=True).encode([("k", "a")])
    block_b = H.Encoder(indexing=True).encode([("k", "b")])
    out = []
    ts = [threading.Thread(target=lambda d=d, blk=blk: out.append(
        d.decode(blk))) for d, blk in ((a, block_a), (b, block_b))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    assert a.table.entries == [(b"k", b"a")]
    assert b.table.entries == [(b"k", b"b")]
