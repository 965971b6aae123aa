"""MongoDB authentication/authorization backend — wire protocol.

A copy of the JAX package's ``auth_mongo.py``.  EMQX's
emqx_auth_mongodb runs `find` commands against user/ACL collections
through the mongodb driver; this module speaks the modern wire
protocol directly (OP_MSG, opcode 2013, with a minimal BSON codec) so
no driver dependency exists, and plugs the providers into the same
async chain + prefetched-ACL pattern as the SQL/Redis backends
(auth_db.py).

BSON scope: the types auth documents actually use — string, double,
int32/64, bool, null, embedded document, array.  `MongoConnector`
pipelines commands on one connection, replies matched to requests by
``responseTo``.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import struct
from typing import Any, Dict, List, Optional, Tuple

from .access import ALLOW, DENY, IGNORE, Authenticator, ClientInfo
from .auth_db import check_algorithm_supported, verify_password

log = logging.getLogger("emqx_tpu_torch.auth_mongo")

OP_MSG = 2013


# ---------------------------------------------------------------- BSON

def bson_encode(doc: Dict[str, Any]) -> bytes:
    body = bytearray()
    for key, val in doc.items():
        kb = key.encode() + b"\x00"
        if isinstance(val, bool):  # before int: bool is an int subtype
            body += b"\x08" + kb + (b"\x01" if val else b"\x00")
        elif isinstance(val, float):
            body += b"\x01" + kb + struct.pack("<d", val)
        elif isinstance(val, int):
            if -(2 ** 31) <= val < 2 ** 31:
                body += b"\x10" + kb + struct.pack("<i", val)
            else:
                body += b"\x12" + kb + struct.pack("<q", val)
        elif isinstance(val, str):
            vb = val.encode() + b"\x00"
            body += b"\x02" + kb + struct.pack("<i", len(vb)) + vb
        elif val is None:
            body += b"\x0a" + kb
        elif isinstance(val, dict):
            body += b"\x03" + kb + bson_encode(val)
        elif isinstance(val, (list, tuple)):
            body += b"\x04" + kb + bson_encode(
                {str(i): v for i, v in enumerate(val)}
            )
        else:
            raise TypeError(f"bson: unsupported {type(val)!r}")
    return struct.pack("<i", len(body) + 5) + bytes(body) + b"\x00"


def bson_decode(data: bytes, offset: int = 0) -> Tuple[Dict[str, Any], int]:
    (total,) = struct.unpack_from("<i", data, offset)
    end = offset + total - 1  # trailing NUL
    off = offset + 4
    out: Dict[str, Any] = {}
    while off < end:
        etype = data[off]
        off += 1
        nul = data.index(b"\x00", off)
        key = data[off:nul].decode()
        off = nul + 1
        if etype == 0x01:
            (out[key],) = struct.unpack_from("<d", data, off)
            off += 8
        elif etype == 0x02:
            (ln,) = struct.unpack_from("<i", data, off)
            out[key] = data[off + 4:off + 4 + ln - 1].decode()
            off += 4 + ln
        elif etype in (0x03, 0x04):
            sub, off = bson_decode(data, off)
            out[key] = (
                [sub[str(i)] for i in range(len(sub))]
                if etype == 0x04 else sub
            )
        elif etype == 0x08:
            out[key] = data[off] == 1
            off += 1
        elif etype == 0x0A:
            out[key] = None
        elif etype == 0x10:
            (out[key],) = struct.unpack_from("<i", data, off)
            off += 4
        elif etype == 0x12:
            (out[key],) = struct.unpack_from("<q", data, off)
            off += 8
        else:
            raise ValueError(f"bson: unsupported type 0x{etype:02x}")
    return out, end + 1


# ------------------------------------------------------------ connector

class MongoConnector:
    """One OP_MSG connection; `command` runs one database command and
    returns the reply document.

    Commands PIPELINE on the single connection: OP_MSG replies carry
    ``responseTo``, so each caller registers a future under its
    request id, writes its frame, and a shared reader pump
    demultiplexes replies back: concurrent CONNECT-time auth lookups
    do not serialize on one round trip each."""

    def __init__(self, host: str = "127.0.0.1", port: int = 27017,
                 database: str = "mqtt") -> None:
        self.host = host
        self.port = port
        self.database = database
        self._r: Optional[asyncio.StreamReader] = None
        self._w: Optional[asyncio.StreamWriter] = None
        self._req = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._reader: Optional[asyncio.Task] = None
        self._connecting: Optional[asyncio.Task] = None

    async def _connect(self) -> None:
        self._r, self._w = await asyncio.open_connection(
            self.host, self.port
        )
        # fresh pending map per connection: a stale pump's teardown
        # must never fail futures registered against its successor
        self._pending = {}
        self._reader = asyncio.get_running_loop().create_task(
            self._read_loop(self._r, self._pending)
        )

    async def _ensure(self) -> None:
        """Connect once, even under concurrent callers: the first
        starts the dial, the rest await the same task."""
        if self._w is not None and not self._w.is_closing():
            return
        if self._connecting is None or self._connecting.done():
            self._connecting = asyncio.get_running_loop().create_task(
                self._connect()
            )
        await asyncio.shield(self._connecting)

    async def _read_loop(
        self, r: asyncio.StreamReader,
        pending: Dict[int, "asyncio.Future"],
    ) -> None:
        """Reader pump: demultiplex replies by ``responseTo``."""
        try:
            while True:
                hdr = await r.readexactly(16)
                length, _rid, resp_to, opcode = struct.unpack(
                    "<iiii", hdr
                )
                payload = await r.readexactly(length - 16)
                fut = pending.pop(resp_to, None)
                if fut is None or fut.done():
                    continue
                if opcode != OP_MSG:
                    fut.set_exception(
                        ConnectionError(f"unexpected opcode {opcode}")
                    )
                    continue
                try:
                    # flagBits(4) + section kind(1) + document
                    reply, _ = bson_decode(payload, 5)
                except Exception as exc:
                    fut.set_exception(exc)
                else:
                    fut.set_result(reply)
        except asyncio.CancelledError:
            raise
        except Exception:
            pass  # connection loss surfaces via the pending futures
        finally:
            exc = ConnectionError(
                f"mongo connection {self.host}:{self.port} lost"
            )
            for fut in pending.values():
                if not fut.done():
                    fut.set_exception(exc)
            pending.clear()
            # tear the transport down with the pump: a half-closed
            # socket must read as disconnected, or every later
            # command() would register in an unpumped map and stall
            # CONNECT-time auth to its timeout instead of re-dialing
            if self._r is r and self._w is not None:
                w, self._w, self._r = self._w, None, None
                w.close()

    async def command(self, doc: Dict[str, Any],
                      timeout: float = 5.0) -> Dict[str, Any]:
        await self._ensure()
        rid = next(self._req)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        doc = dict(doc)
        doc.setdefault("$db", self.database)
        body = struct.pack("<I", 0) + b"\x00" + bson_encode(doc)
        msg = struct.pack(
            "<iiii", 16 + len(body), rid, 0, OP_MSG
        ) + body
        try:
            self._w.write(msg)
            await self._w.drain()
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._pending.pop(rid, None)

    async def find_one(self, collection: str,
                       flt: Dict[str, Any]) -> Optional[Dict]:
        reply = await self.command({
            "find": collection, "filter": flt, "limit": 1,
        })
        batch = reply.get("cursor", {}).get("firstBatch", [])
        return batch[0] if batch else None

    async def find(self, collection: str,
                   flt: Dict[str, Any]) -> List[Dict]:
        reply = await self.command({
            "find": collection, "filter": flt,
        })
        return list(reply.get("cursor", {}).get("firstBatch", []))

    async def close(self) -> None:
        if self._reader is not None:
            self._reader.cancel()
            self._reader = None
        self._connecting = None
        if self._w is not None:
            self._w.close()
            self._w = self._r = None


# ------------------------------------------------------------ providers

class MongoAuthenticator(Authenticator):
    """find-one against the user collection, password verified with
    the shared hashing suite (emqx_authn_mongodb)."""

    is_async = True

    def __init__(
        self,
        connector: MongoConnector,
        collection: str = "mqtt_user",
        filter_field: str = "username",
        algorithm: str = "sha256",
        salt_position: str = "prefix",
        iterations: int = 50_000,
    ) -> None:
        check_algorithm_supported(algorithm)
        self.connector = connector
        self.collection = collection
        self.filter_field = filter_field
        self.algorithm = algorithm
        self.salt_position = salt_position
        self.iterations = iterations

    def authenticate(self, client: ClientInfo):
        return IGNORE, {}  # async-only provider

    async def authenticate_async(self, client: ClientInfo):
        if not client.username:
            return IGNORE, {}
        try:
            row = await self.connector.find_one(
                self.collection, {self.filter_field: client.username}
            )
        except Exception:
            log.exception("mongo authn failed")
            return IGNORE, {}
        if not row or not row.get("password_hash"):
            return IGNORE, {}
        ok = verify_password(
            client.password,
            str(row["password_hash"]),
            algorithm=self.algorithm,
            salt=str(row.get("salt") or ""),
            salt_position=self.salt_position,
            iterations=self.iterations,
        )
        if not ok:
            return DENY, {}
        return ALLOW, {
            "is_superuser": bool(row.get("is_superuser") or False)
        }

    async def close(self) -> None:
        await self.connector.close()


class MongoAuthorizer:
    """ACL rows from a collection, prefetched at CONNECT into the
    access layer's cache (emqx_authz_mongodb): documents carry
    ``permission``, ``action``, and ``topics`` (list) or ``topic``."""

    def __init__(
        self,
        connector: MongoConnector,
        collection: str = "mqtt_acl",
        filter_field: str = "username",
    ) -> None:
        self.connector = connector
        self.collection = collection
        self.filter_field = filter_field

    async def fetch_rows(self, client: ClientInfo) -> List[Dict]:
        docs = await self.connector.find(
            self.collection,
            {self.filter_field: client.username or ""},
        )
        rows: List[Dict] = []
        for d in docs:
            topics = d.get("topics") or (
                [d["topic"]] if d.get("topic") else []
            )
            for t in topics:
                rows.append({
                    "permission": d.get("permission", ALLOW),
                    "action": d.get("action", "all"),
                    "topic": t,
                })
        return rows

    async def close(self) -> None:
        await self.connector.close()
