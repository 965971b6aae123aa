"""TCP listener and the broker server CLI.

    python -m emqx_tpu_torch.broker --port P [--bind ADDR] [--device cuda|cpu]

``--device`` defaults to ``cuda`` (the hand-written kernels) and fails
without a card; ``--device cpu`` runs the plain PyTorch versions.
``--port 0`` binds a free port.  The server prints one line with the
address it listens on once it accepts connections.

The server gives each connection the listener's mountpoint and its
limiter (`HierarchicalLimiter`: the connection's own buckets, the
listener's shared ones, the broker's zone buckets), publishes the
``$SYS`` heartbeats (`SysTopics`) and runs the 1 Hz housekeeping:
``Broker.tick`` and ``SysTopics.tick``.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import sys
from typing import List, Optional, Set

from ..config import BrokerConfig
from ..limiter import ConnectionLimiter, HierarchicalLimiter
from ..sys_topics import SysTopics
from .broker import Broker, PublishBatcher
from .connection import Connection

log = logging.getLogger("emqx_tpu_torch.listener")


class BrokerServer:
    """A broker, its publish batcher, its ``$SYS`` heartbeats and one
    TCP listener."""

    def __init__(self, config: Optional[BrokerConfig] = None,
                 device="cuda", native: bool = True) -> None:
        self.broker = Broker(config=config, device=device, native=native)
        self.sys = SysTopics(self.broker)
        lc = self.broker.config.listener
        # the listener-aggregate buckets all its connections share
        self._shared_limiter: Optional[ConnectionLimiter] = None
        if lc.max_messages_rate > 0 or lc.max_bytes_rate > 0:
            self._shared_limiter = ConnectionLimiter(
                messages_rate=lc.max_messages_rate,
                bytes_rate=lc.max_bytes_rate, shared=True,
            )
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: Set[asyncio.Task] = set()
        self._housekeeper: Optional[asyncio.Task] = None
        self.port: Optional[int] = None

    async def start(self) -> None:
        cfg = self.broker.config
        eng = cfg.engine
        self.broker.batcher = PublishBatcher(
            self.broker,
            window=eng.batch_window_ms / 1000.0,
            batch_max=eng.batch_max,
            pipeline_windows=eng.pipeline_windows,
        )
        await self.broker.batcher.start()
        self._server = await asyncio.start_server(
            self._on_client, cfg.bind, cfg.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self._housekeeper = asyncio.get_running_loop().create_task(
            self._housekeep()
        )

    def _make_limiter(self):
        """One connection's limiter: None when no level is set, one
        `ConnectionLimiter` when only its own, else the hierarchy."""
        lc = self.broker.config.listener
        conn = None
        if lc.messages_rate > 0 or lc.bytes_rate > 0:
            conn = ConnectionLimiter(messages_rate=lc.messages_rate,
                                     bytes_rate=lc.bytes_rate)
        zone = self.broker.zone_limiter
        if self._shared_limiter is None and zone is None:
            return conn
        return HierarchicalLimiter(conn, self._shared_limiter, zone)

    async def _housekeep(self) -> None:
        """The broker's 1 Hz housekeeping and the $SYS heartbeat."""
        while True:
            await asyncio.sleep(1.0)
            try:
                self.broker.tick()
                self.sys.tick()
            except Exception:
                log.exception("housekeeping tick failed")

    async def stop(self) -> None:
        if self._housekeeper is not None:
            self._housekeeper.cancel()
            self._housekeeper = None
        # cancel connection handlers BEFORE wait_closed: Server.wait_closed
        # also waits for live handlers
        if self._server is not None:
            self._server.close()
        for task in list(self._conns):
            task.cancel()
        if self._conns:
            await asyncio.gather(*self._conns, return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None
        if self.broker.batcher is not None:
            await self.broker.batcher.stop()
            self.broker.batcher = None
        self.broker.shutdown()

    async def _on_client(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            await Connection(
                self.broker, reader, writer,
                mountpoint=self.broker.config.listener.mountpoint,
                limiter=self._make_limiter(),
            ).run()
        finally:
            self._conns.discard(task)

    async def run_forever(self) -> None:
        await self.start()
        print(f"emqx_tpu_torch broker listening on "
              f"{self.broker.config.bind}:{self.port} "
              f"(device {self.broker.router.engine.device})", flush=True)
        try:
            await asyncio.Event().wait()
        finally:
            await self.stop()


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="emqx_tpu_torch MQTT broker")
    ap.add_argument("--port", type=int, default=1883)
    ap.add_argument("--bind", default="0.0.0.0")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    cfg = BrokerConfig(bind=args.bind, port=args.port)
    try:
        server = BrokerServer(cfg, device=args.device)
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        raise SystemExit(2)
    try:
        asyncio.run(server.run_forever())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
