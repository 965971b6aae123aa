"""Record aggregation for batch-oriented sinks.

A port of the JAX package's ``aggregator.py``, EMQX's
`emqx_connector_aggregator` role (apps/emqx_connector_aggregator/src/
emqx_connector_aggregator.erl buffer manager,
emqx_connector_aggreg_csv.erl container format,
emqx_connector_aggreg_delivery.erl offload): rule output records
accumulate into time-bucketed buffers and flush as one object per
(bucket, sequence) — CSV or JSONL — when the record cap, byte cap, or
the time interval is reached.  Deliveries go to any callable sink.

The aggregator is a plain object ticked by the server's 1 Hz
housekeeping (EMQX uses a gen_server + timer); `push` is called from
rule actions on the event loop.  This package has no overload
protection, so `tick` has no deferral."""

from __future__ import annotations

import csv
import io
import json
import logging
import time
from typing import Callable, Dict, List, Optional, Sequence

log = logging.getLogger("emqx_tpu_torch.aggregator")


class Aggregator:
    def __init__(
        self,
        deliver: Callable[[str, bytes], None],  # (object key, body)
        *,
        name: str = "aggreg",
        container: str = "jsonl",  # jsonl | csv
        interval_s: float = 60.0,
        max_records: int = 10_000,
        max_bytes: int = 8 * 1024 * 1024,
        column_order: Optional[Sequence[str]] = None,
        key_template: str = "{name}/{ts}/{seq}.{ext}",
    ) -> None:
        if container not in ("jsonl", "csv"):
            raise ValueError(f"unknown container {container!r}")
        self.deliver = deliver
        self.name = name
        self.container = container
        self.interval_s = interval_s
        self.max_records = max_records
        self.max_bytes = max_bytes
        self.column_order = list(column_order or ())
        self.key_template = key_template
        self._records: List[Dict] = []
        self._approx_bytes = 0
        self._bucket_start = time.time()
        self._seq = 0
        self.stats = {
            "pushed": 0,
            "flushed_objects": 0,
            "errors": 0,
        }

    # ----------------------------------------------------------- push

    def push(self, records: Sequence[Dict]) -> None:
        """Queue records; flushes inline when a cap is crossed (EMQX
        offloads the same way on `push_records`)."""
        for r in records:
            self._records.append(r)
            self._approx_bytes += len(str(r)) + 2
        self.stats["pushed"] += len(records)
        if (
            len(self._records) >= self.max_records
            or self._approx_bytes >= self.max_bytes
        ):
            self.flush()

    def tick(self, now: Optional[float] = None) -> bool:
        """1 Hz housekeeping: flush when the time bucket lapses (the
        record and byte caps flush in `push`)."""
        now = now if now is not None else time.time()
        if not self._records:
            return False
        if now - self._bucket_start < self.interval_s:
            return False
        self.flush(now)
        return True

    # ---------------------------------------------------------- flush

    def flush(self, now: Optional[float] = None) -> None:
        if not self._records:
            return
        records, self._records = self._records, []
        self._approx_bytes = 0
        now = now if now is not None else time.time()
        ts = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime(self._bucket_start))
        key = self.key_template.format(
            name=self.name,
            ts=ts,
            seq=self._seq,
            ext="csv" if self.container == "csv" else "jsonl",
        )
        self._seq += 1
        self._bucket_start = now
        try:
            body = self._encode(records)
            self.deliver(key, body)
            self.stats["flushed_objects"] += 1
        except Exception:
            self.stats["errors"] += 1
            log.exception("aggregator %s: flush of %d records failed",
                          self.name, len(records))

    def _encode(self, records: List[Dict]) -> bytes:
        if self.container == "jsonl":
            return "".join(
                json.dumps(r, separators=(",", ":"), default=str) + "\n"
                for r in records
            ).encode()
        # CSV: fixed column order first (EMQX's ordered
        # columns), then any extra keys in first-seen order
        cols = list(self.column_order)
        seen = set(cols)
        for r in records:
            for k in r:
                if k not in seen:
                    seen.add(k)
                    cols.append(k)
        out = io.StringIO()
        w = csv.DictWriter(out, fieldnames=cols, extrasaction="ignore",
                           restval="")
        w.writeheader()
        for r in records:
            w.writerow({k: r.get(k, "") for k in cols})
        return out.getvalue().encode()
