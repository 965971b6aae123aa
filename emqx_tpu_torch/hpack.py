"""HPACK (RFC 7541): header compression for HTTP/2.

`Decoder` takes a header block and returns ``[(name, value)]`` as
bytes: the static table, the dynamic table with its size updates and
evictions, integer and string literals, Huffman-coded strings.
`Encoder` writes a block: a static-table match as an index, other
fields as literals (without indexing, or with incremental indexing when
asked, which keeps its own dynamic table), each string Huffman-coded
when that is shorter (or always, or never, as asked).

The Huffman code of Appendix B is canonical: the 257 code lengths fix
every code (shorter codes first, equal lengths in symbol order), so the
table is written here as lengths.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

Header = Tuple[bytes, bytes]

MEMO_ENTRIES = 1024  # strings (fields) a decoder (an encoder) remembers


class HpackError(ValueError):
    """A header block that does not decode (COMPRESSION_ERROR)."""


STATIC_TABLE: Tuple[Header, ...] = tuple(
    (n.encode(), v.encode()) for n, v in (
        (":authority", ""), (":method", "GET"), (":method", "POST"),
        (":path", "/"), (":path", "/index.html"), (":scheme", "http"),
        (":scheme", "https"), (":status", "200"), (":status", "204"),
        (":status", "206"), (":status", "304"), (":status", "400"),
        (":status", "404"), (":status", "500"), ("accept-charset", ""),
        ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
        ("accept-ranges", ""), ("accept", ""),
        ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
        ("authorization", ""), ("cache-control", ""),
        ("content-disposition", ""), ("content-encoding", ""),
        ("content-language", ""), ("content-length", ""),
        ("content-location", ""), ("content-range", ""),
        ("content-type", ""), ("cookie", ""), ("date", ""), ("etag", ""),
        ("expect", ""), ("expires", ""), ("from", ""), ("host", ""),
        ("if-match", ""), ("if-modified-since", ""), ("if-none-match", ""),
        ("if-range", ""), ("if-unmodified-since", ""),
        ("last-modified", ""), ("link", ""), ("location", ""),
        ("max-forwards", ""), ("proxy-authenticate", ""),
        ("proxy-authorization", ""), ("range", ""), ("referer", ""),
        ("refresh", ""), ("retry-after", ""), ("server", ""),
        ("set-cookie", ""), ("strict-transport-security", ""),
        ("transfer-encoding", ""), ("user-agent", ""), ("vary", ""),
        ("via", ""), ("www-authenticate", "")))
_STATIC_FULL = {}
_STATIC_NAME = {}
for _i, _hv in enumerate(STATIC_TABLE, 1):
    _STATIC_FULL.setdefault(_hv, _i)
    _STATIC_NAME.setdefault(_hv[0], _i)

# Appendix B as code lengths: length -> the symbols of that length
# (256 is EOS)
_LENGTHS = {
    5: (48, 49, 50, 97, 99, 101, 105, 111, 115, 116),
    6: (32, 37, 45, 46, 47, 51, 52, 53, 54, 55, 56, 57, 61, 65, 95, 98,
        100, 102, 103, 104, 108, 109, 110, 112, 114, 117),
    7: (58, *range(66, 88), 89, 106, 107, 113, 118, 119, 120, 121, 122),
    8: (38, 42, 44, 59, 88, 90),
    10: (33, 34, 40, 41, 63),
    11: (39, 43, 124),
    12: (35, 62),
    13: (0, 36, 64, 91, 93, 126),
    14: (94, 125),
    15: (60, 96, 123),
    19: (92, 195, 208),
    20: (128, 130, 131, 162, 184, 194, 224, 226),
    21: (153, 161, 167, 172, 176, 177, 179, 209, 216, 217, 227, 229, 230),
    22: (129, 132, 133, 134, 136, 146, 154, 156, 160, 163, 164, 169, 170,
         173, 178, 181, 185, 186, 187, 189, 190, 196, 198, 228, 232, 233),
    23: (1, 135, 137, 138, 139, 140, 141, 143, 147, 149, 150, 151, 152,
         155, 157, 158, 165, 166, 168, 174, 175, 180, 182, 183, 188, 191,
         197, 231, 239),
    24: (9, 142, 144, 145, 148, 159, 171, 206, 215, 225, 236, 237),
    25: (199, 207, 234, 235),
    26: (192, 193, 200, 201, 202, 205, 210, 213, 218, 219, 238, 240, 242,
         243, 255),
    27: (203, 204, 211, 212, 214, 221, 222, 223, 241, 244, 245, 246, 247,
         248, 250, 251, 252, 253, 254),
    28: (2, 3, 4, 5, 6, 7, 8, 11, 12, 14, 15, 16, 17, 18, 19, 20, 21, 23,
         24, 25, 26, 27, 28, 29, 30, 31, 127, 220, 249),
    30: (10, 13, 22, 256),
}
EOS = 256


def _canonical():
    """(code, length) of every symbol, and per length the first code
    and the symbols in code order (the decoder's tables)."""
    codes: List[Tuple[int, int]] = [(0, 0)] * 257
    first: Dict[int, int] = {}
    code = 0
    prev = 0
    for length in sorted(_LENGTHS):
        code <<= length - prev
        prev = length
        first[length] = code
        for sym in _LENGTHS[length]:
            codes[sym] = (code, length)
            code += 1
    return codes, first


HUFFMAN_CODES, _FIRST = _canonical()
_SYMS = {n: tuple(s) for n, s in _LENGTHS.items()}
_MAX_LEN = max(_LENGTHS)


def huffman_encode(data: bytes) -> bytes:
    acc = nbits = 0
    out = bytearray()
    for b in data:
        code, length = HUFFMAN_CODES[b]
        acc = (acc << length) | code
        nbits += length
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
        acc &= (1 << nbits) - 1
    if nbits:  # pad with the most significant bits of EOS (all ones)
        out.append(((acc << (8 - nbits)) | ((1 << (8 - nbits)) - 1)) & 0xFF)
    return bytes(out)


def huffman_length(data: bytes) -> int:
    return (sum(HUFFMAN_CODES[b][1] for b in data) + 7) // 8


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    code = length = 0
    for byte in data:
        for shift in range(7, -1, -1):
            code = (code << 1) | ((byte >> shift) & 1)
            length += 1
            syms = _SYMS.get(length)
            if syms is not None:
                k = code - _FIRST[length]
                if 0 <= k < len(syms):
                    sym = syms[k]
                    if sym == EOS:
                        raise HpackError("EOS in a Huffman-coded string")
                    out.append(sym)
                    code = length = 0
            if length > _MAX_LEN:
                raise HpackError("bad Huffman code")
    # what is left must be a prefix of EOS (all ones), under 8 bits
    if length > 7 or code != (1 << length) - 1:
        raise HpackError("bad Huffman padding")
    return bytes(out)


# --------------------------------------------------------- primitives

def encode_int(value: int, prefix: int, first: int = 0) -> bytes:
    """An integer with an N-bit prefix; ``first`` holds the high bits
    of the first byte."""
    limit = (1 << prefix) - 1
    if value < limit:
        return bytes([first | value])
    out = bytearray([first | limit])
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_int(buf: bytes, pos: int, prefix: int) -> Tuple[int, int]:
    if pos >= len(buf):
        raise HpackError("truncated integer")
    limit = (1 << prefix) - 1
    value = buf[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(buf):
            raise HpackError("truncated integer")
        b = buf[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos
        if shift > 56:
            raise HpackError("integer too large")


def encode_str(data: bytes, huffman: str = "shorter") -> bytes:
    if huffman == "always" or (
            huffman == "shorter" and huffman_length(data) < len(data)):
        coded = huffman_encode(data)
        return encode_int(len(coded), 7, 0x80) + coded
    return encode_int(len(data), 7) + data


def decode_str(buf: bytes, pos: int,
               memo: Optional[Dict[bytes, bytes]] = None
               ) -> Tuple[bytes, int]:
    """A string literal; ``memo`` keeps the Huffman-coded strings
    already decoded (a peer sends the same ones on every request)."""
    if pos >= len(buf):
        raise HpackError("truncated string")
    huff = buf[pos] & 0x80
    n, pos = decode_int(buf, pos, 7)
    if pos + n > len(buf):
        raise HpackError("truncated string")
    raw = bytes(buf[pos:pos + n])
    if not huff:
        return raw, pos + n
    if memo is None:
        return huffman_decode(raw), pos + n
    out = memo.get(raw)
    if out is None:
        out = huffman_decode(raw)
        if len(memo) >= MEMO_ENTRIES:
            memo.clear()
        memo[raw] = out
    return out, pos + n


# -------------------------------------------------------- the tables

class DynamicTable:
    def __init__(self, max_size: int = 4096) -> None:
        self.max_size = max_size
        self.size = 0
        self.entries: List[Header] = []  # newest first

    @staticmethod
    def entry_size(h: Header) -> int:
        return len(h[0]) + len(h[1]) + 32

    def add(self, h: Header) -> None:
        need = self.entry_size(h)
        if need > self.max_size:  # clears the table (RFC 7541 4.4)
            self.entries.clear()
            self.size = 0
            return
        while self.size + need > self.max_size:
            self.size -= self.entry_size(self.entries.pop())
        self.entries.insert(0, h)
        self.size += need

    def resize(self, max_size: int) -> None:
        self.max_size = max_size
        while self.size > max_size:
            self.size -= self.entry_size(self.entries.pop())

    def get(self, index: int) -> Header:
        if index <= 0:
            raise HpackError("index 0")
        if index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        k = index - len(STATIC_TABLE) - 1
        if k >= len(self.entries):
            raise HpackError(f"index {index} past the dynamic table")
        return self.entries[k]


class Decoder:
    """Decodes header blocks in the order the peer sent them; the
    dynamic table lives across blocks."""

    def __init__(self, max_table_size: int = 4096) -> None:
        # the most the peer may set with a size update: our
        # SETTINGS_HEADER_TABLE_SIZE
        self.max_allowed = max_table_size
        self.table = DynamicTable(max_table_size)
        self._memo: Dict[bytes, bytes] = {}

    def decode(self, block: bytes) -> List[Header]:
        out: List[Header] = []
        pos = 0
        buf = bytes(block)
        fields_seen = False
        while pos < len(buf):
            b = buf[pos]
            if b & 0x80:  # indexed header field
                idx, pos = decode_int(buf, pos, 7)
                out.append(self.table.get(idx))
                fields_seen = True
            elif b & 0x40:  # literal with incremental indexing
                h, pos = self._literal(buf, pos, 6)
                self.table.add(h)
                out.append(h)
                fields_seen = True
            elif b & 0x20:  # dynamic table size update
                if fields_seen:
                    raise HpackError("table size update after a field")
                size, pos = decode_int(buf, pos, 5)
                if size > self.max_allowed:
                    raise HpackError(f"table size {size} above the "
                                     f"{self.max_allowed} allowed")
                self.table.resize(size)
            else:  # literal without indexing (0000) or never indexed (0001)
                h, pos = self._literal(buf, pos, 4)
                out.append(h)
                fields_seen = True
        return out

    def _literal(self, buf: bytes, pos: int, prefix: int) -> Tuple[Header,
                                                                     int]:
        idx, pos = decode_int(buf, pos, prefix)
        if idx:
            name = self.table.get(idx)[0]
        else:
            name, pos = decode_str(buf, pos, self._memo)
        value, pos = decode_str(buf, pos, self._memo)
        return (name, value), pos


def _b(x: Union[str, bytes]) -> bytes:
    return x.encode("latin-1") if isinstance(x, str) else bytes(x)


class Encoder:
    """Writes header blocks.  ``huffman``: ``shorter`` (the default),
    ``always`` or ``never``; ``indexing``: add literals to a dynamic
    table (the peer's decoder keeps the same one) and index later
    matches."""

    def __init__(self, huffman: str = "shorter", indexing: bool = False,
                 max_table_size: int = 4096) -> None:
        self.huffman = huffman
        self.indexing = indexing
        self.table = DynamicTable(max_table_size)
        self._pending_sizes: List[int] = []
        # a field's bytes without indexing depend on the field alone
        self._memo: Dict[Header, bytes] = {}

    def set_max_table_size(self, size: int) -> None:
        """The peer's SETTINGS_HEADER_TABLE_SIZE changed, or we choose a
        smaller table: the next block starts with a size update."""
        self._pending_sizes.append(size)

    def encode(self, headers: Sequence[Tuple[Union[str, bytes],
                                             Union[str, bytes]]]) -> bytes:
        out = bytearray()
        for size in self._pending_sizes:
            out += encode_int(size, 5, 0x20)
            self.table.resize(size)
        self._pending_sizes.clear()
        for n, v in headers:
            h = (_b(n), _b(v))
            if self.indexing:
                out += self._indexed(h)
                continue
            field = self._memo.get(h)
            if field is None:
                field = self._literal(h)
                if len(self._memo) >= MEMO_ENTRIES:
                    self._memo.clear()
                self._memo[h] = field
            out += field
        return bytes(out)

    def _indexed(self, h: Header) -> bytes:
        """A field as an index into either table, or a literal the
        dynamic table takes."""
        idx = _STATIC_FULL.get(h)
        if idx is None:
            idx = self._dynamic_index(h)
        if idx is not None:
            return encode_int(idx, 7, 0x80)
        name_idx = _STATIC_NAME.get(h[0])
        out = encode_int(name_idx or 0, 6, 0x40)
        self.table.add(h)
        if not name_idx:
            out += encode_str(h[0], self.huffman)
        return out + encode_str(h[1], self.huffman)

    def _literal(self, h: Header) -> bytes:
        """A field as a static index or a literal without indexing."""
        idx = _STATIC_FULL.get(h)
        if idx is not None:
            return encode_int(idx, 7, 0x80)
        name_idx = _STATIC_NAME.get(h[0])
        out = encode_int(name_idx or 0, 4, 0x00)
        if not name_idx:
            out += encode_str(h[0], self.huffman)
        return out + encode_str(h[1], self.huffman)

    def _dynamic_index(self, h: Header) -> Optional[int]:
        for k, e in enumerate(self.table.entries):
            if e == h:
                return len(STATIC_TABLE) + 1 + k
        return None
