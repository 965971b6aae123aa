"""TLS-PSK identity store — the emqx_psk app's core.

A copy of the JAX package's ``psk.py``.  EMQX (emqx_psk.erl) keeps
an identity -> pre-shared-key table loaded from ``init_file`` (lines
of ``identity:psk_hex``), refreshable at runtime, consulted by the
TLS layer's psk lookup callback.  This module is that store plus the
callback in the shape CPython's ``ssl`` expects.

Limit: Python 3.12's ssl module does not expose
``SSLContext.set_psk_server_callback`` (it landed in 3.13), so the
handshake hookup is gated on the interpreter: `attach` wires the
callback when the running ssl module supports it and reports False
otherwise — the store, file format, refresh, and lookup semantics are
complete either way."""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

log = logging.getLogger("emqx_tpu_torch.psk")


class PskStore:
    def __init__(self, init_file: Optional[str] = None) -> None:
        self._keys: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self.init_file = init_file
        self.stats = {"lookups": 0, "misses": 0}
        if init_file:
            self.refresh()

    def refresh(self) -> int:
        """(Re)load ``identity:psk_hex`` lines; unparsable lines are
        skipped loudly (EMQX warns per bad entry).  Returns
        the table size."""
        if not self.init_file:
            return len(self._keys)
        loaded: Dict[str, bytes] = {}
        try:
            with open(self.init_file) as f:
                for ln, line in enumerate(f, 1):
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    if ":" not in line:
                        log.warning("psk: bad line %d (no colon)", ln)
                        continue
                    ident, hexkey = line.split(":", 1)
                    try:
                        loaded[ident.strip()] = bytes.fromhex(
                            hexkey.strip()
                        )
                    except ValueError:
                        log.warning("psk: bad hex on line %d", ln)
        except OSError as exc:
            raise RuntimeError(
                f"psk init_file {self.init_file!r} unreadable: {exc}"
            ) from exc
        with self._lock:
            self._keys = loaded
        return len(loaded)

    def insert(self, identity: str, psk: bytes) -> None:
        with self._lock:
            self._keys[identity] = psk

    def delete(self, identity: str) -> None:
        with self._lock:
            self._keys.pop(identity, None)

    def lookup(self, identity: str) -> Optional[bytes]:
        self.stats["lookups"] += 1
        with self._lock:
            psk = self._keys.get(identity)
        if psk is None:
            self.stats["misses"] += 1
        return psk

    def __len__(self) -> int:
        return len(self._keys)

    # ------------------------------------------------- TLS integration

    def server_callback(self, conn, identity):
        """The shape ``SSLContext.set_psk_server_callback`` calls:
        returns the key bytes or b"" (handshake fails) for an unknown
        identity."""
        ident = (
            identity.decode("utf-8", "replace")
            if isinstance(identity, (bytes, bytearray))
            else (identity or "")
        )
        return self.lookup(ident) or b""

    def attach(self, ssl_context, hint: str = "emqx_tpu") -> bool:
        """Wire this store into an SSLContext when the interpreter
        supports server-side PSK (Python >= 3.13); returns whether the
        hookup happened."""
        cb = getattr(ssl_context, "set_psk_server_callback", None)
        if cb is None:
            log.warning(
                "tls-psk: this Python's ssl lacks "
                "set_psk_server_callback (needs >= 3.13); identities "
                "are loaded (%d) but the handshake hook is inactive",
                len(self),
            )
            return False
        cb(self.server_callback, hint)
        return True
