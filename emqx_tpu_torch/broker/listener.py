"""Listeners and the broker server CLI.

    python -m emqx_tpu_torch.broker [--config FILE] [--check-config]
        [--port P] [--bind ADDR] [--device cuda|cpu]

``--config`` loads a JSON file (`ConfigHandler.load`); the
``EMQX_TPU_<PATH>`` environment variables apply on top of it
(`apply_env_overrides`), then `check_config` runs: ``--check-config``
prints ``config ok`` and exits 0, or prints ``config error:`` lines and
exits 1; a bad configuration at boot exits 2.  ``--port`` and
``--bind``, when given, override the first listener's.  ``--device``
defaults to ``cuda`` (the hand-written kernels) and fails without a
card; ``--device cpu`` runs the plain PyTorch versions.  Once every
listener accepts connections the server prints one line a listener
with its name, type, address and the device.

A `Listener` is one bound socket over tcp, ssl (TLS, optionally with
client certificates and a CRL the housekeeping reloads), ws or wss
(MQTT over WebSocket, `ws.py`).  It caps its connections at
``max_connections`` (counted from accept, so a slow WebSocket handshake
is no free pass; the handshake has 10 s) and gives each connection the
listener's mountpoint and its limiter (`HierarchicalLimiter`: the
connection's own buckets, the listener's shared ones, the broker's zone
buckets).  The server publishes the ``$SYS`` heartbeats (`SysTopics`)
and runs the 1 Hz housekeeping: ``Broker.tick``, ``SysTopics.tick``,
each aggregator's ``tick``, each listener's CRL reload and the retry of
each exhook client whose provider has not loaded.  It starts
the configuration's ``sinks`` (``http``, `resources.HttpSink`) in the
broker's resource manager before anything else, and a sink that fails
to start fails `BrokerServer.start`; then it dials the configuration's
``exhooks`` (`exhook.client.ExhookClient`, each in an executor: an
unreachable provider fails closed or open by its policy until a retry
loads it), and stops them on shutdown.  With ``api.enable`` it starts the
management API (`mgmt.MgmtApi`) after the listeners, and prints its
address beside theirs; an API port that cannot bind fails `start`.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import sys
from typing import List, Optional, Set

from ..aio import cancel_and_wait
from ..config import (
    BrokerConfig, ConfigHandler, ListenerConfig, apply_env_overrides,
    check_config,
)
from ..limiter import ConnectionLimiter, HierarchicalLimiter
from ..resources import HttpSink
from ..sys_topics import SysTopics
from .broker import Broker, PublishBatcher
from .connection import Connection
from .ws import WsError, WsServerStream, server_handshake

log = logging.getLogger("emqx_tpu_torch.listener")

TRANSPORTS = ("tcp", "ssl", "ws", "wss")
WS_HANDSHAKE_TIMEOUT = 10.0


class Listener:
    """One bound socket accepting MQTT clients over tcp, ssl, ws or
    wss."""

    def __init__(self, broker: Broker, cfg: ListenerConfig) -> None:
        self.broker = broker
        self.cfg = cfg
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: Set[asyncio.Task] = set()
        self._ssl_ctx = None
        self._crl_mtime = 0.0
        self._crl_next_update = None
        # the listener-aggregate buckets all its connections share
        self._shared_limiter: Optional[ConnectionLimiter] = None
        if cfg.max_messages_rate > 0 or cfg.max_bytes_rate > 0:
            self._shared_limiter = ConnectionLimiter(
                messages_rate=cfg.max_messages_rate,
                bytes_rate=cfg.max_bytes_rate, shared=True,
            )

    @property
    def port(self) -> int:
        """The bound port (the configured one before `start`)."""
        if self._server is None or not self._server.sockets:
            return self.cfg.port
        return self._server.sockets[0].getsockname()[1]

    def _make_limiter(self):
        """One connection's limiter: None when no level is set, one
        `ConnectionLimiter` when only its own, else the hierarchy."""
        cfg = self.cfg
        conn = None
        if cfg.messages_rate > 0 or cfg.bytes_rate > 0:
            conn = ConnectionLimiter(messages_rate=cfg.messages_rate,
                                     bytes_rate=cfg.bytes_rate)
        zone = self.broker.zone_limiter
        if self._shared_limiter is None and zone is None:
            return conn
        return HierarchicalLimiter(conn, self._shared_limiter, zone)

    def _ssl_context(self):
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.cfg.certfile, self.cfg.keyfile)
        if self.cfg.cacertfile:
            ctx.load_verify_locations(self.cfg.cacertfile)
        if self.cfg.verify:
            ctx.verify_mode = ssl.CERT_REQUIRED
        if self.cfg.crlfile:
            # revocation: leaf certificates are checked against the
            # CRL, which the housekeeping reloads when the file changes
            if not self.cfg.verify:
                raise ValueError(
                    f"listener {self.cfg.name}: crlfile requires "
                    "verify=true (without a requested client cert "
                    "there is nothing to check revocation against)"
                )
            ctx.verify_flags |= ssl.VERIFY_CRL_CHECK_LEAF
            ctx.load_verify_locations(self.cfg.crlfile)
            self._crl_mtime = os.stat(self.cfg.crlfile).st_mtime
            self._note_crl_expiry()
        self._ssl_ctx = ctx
        return ctx

    def _note_crl_expiry(self) -> None:
        """Keep the CRL's nextUpdate: once it passes, OpenSSL fails
        every handshake, and an untouched file never triggers a
        reload, so the operator is warned."""
        self._crl_next_update = None
        try:
            from cryptography import x509

            with open(self.cfg.crlfile, "rb") as f:
                crl = x509.load_pem_x509_crl(f.read())
            self._crl_next_update = crl.next_update_utc
        except Exception:
            log.debug("CRL nextUpdate unreadable", exc_info=True)

    def maybe_reload_crl(self) -> bool:
        """Load the CRL file into the live context when its mtime
        changed (OpenSSL takes the freshest CRL per issuer).  True when
        it reloaded."""
        if self._ssl_ctx is None or not self.cfg.crlfile:
            return False
        if self._crl_next_update is not None:
            import datetime

            now = datetime.datetime.now(datetime.timezone.utc)
            if now > self._crl_next_update:
                log.warning(
                    "listener %s: CRL is past nextUpdate (%s): OpenSSL "
                    "now rejects ALL client certs on this listener until "
                    "a fresh CRL is written",
                    self.cfg.name, self._crl_next_update,
                )
                self._crl_next_update = None  # warn once an expiry
        try:
            mtime = os.stat(self.cfg.crlfile).st_mtime
        except OSError:
            return False
        if mtime == self._crl_mtime:
            return False
        try:
            self._ssl_ctx.load_verify_locations(self.cfg.crlfile)
        except Exception:
            # the mtime stays: the load is tried again every tick
            log.warning("listener %s: CRL reload failed", self.cfg.name,
                        exc_info=True)
            return False
        self._crl_mtime = mtime
        self._note_crl_expiry()
        log.info("listener %s: CRL reloaded", self.cfg.name)
        return True

    async def start(self) -> None:
        ssl_ctx = (self._ssl_context() if self.cfg.type in ("ssl", "wss")
                   else None)
        self._server = await asyncio.start_server(
            self._on_client, self.cfg.bind, self.cfg.port, ssl=ssl_ctx,
            reuse_port=self.cfg.reuse_port or None,
        )
        log.info("listener %s (%s) started on %s:%d", self.cfg.name,
                 self.cfg.type, self.cfg.bind, self.port)

    async def stop(self) -> None:
        # cancel the connection handlers BEFORE wait_closed, which also
        # waits for live handlers
        if self._server is not None:
            self._server.close()
        for task in list(self._conns):
            task.cancel()
        if self._conns:
            await asyncio.gather(*self._conns, return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None

    async def _on_client(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        if len(self._conns) >= self.cfg.max_connections:
            writer.close()
            return
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            if self.cfg.type in ("ws", "wss"):
                try:
                    await asyncio.wait_for(server_handshake(reader, writer),
                                           WS_HANDSHAKE_TIMEOUT)
                except (WsError, asyncio.TimeoutError,
                        asyncio.IncompleteReadError,
                        asyncio.LimitOverrunError, ConnectionError,
                        ValueError):
                    writer.close()
                    return
                reader = writer = WsServerStream(
                    reader, writer,
                    max_size=self.broker.config.mqtt.max_packet_size * 2,
                )
            await Connection(
                self.broker, reader, writer, mountpoint=self.cfg.mountpoint,
                limiter=self._make_limiter(),
            ).run()
        finally:
            self._conns.discard(task)


class BrokerServer:
    """A broker, its publish batcher (unless ``engine.batch_publish`` is
    off), its ``$SYS`` heartbeats, its sinks and its listeners.  A
    listener of a type this package does not serve raises here; one
    that fails to bind or to load its certificates, and a sink that
    fails to start, raise out of `start`."""

    def __init__(self, config: Optional[BrokerConfig] = None,
                 device="cuda", native: bool = True) -> None:
        self.broker = Broker(config=config, device=device, native=native)
        self.sys = SysTopics(self.broker)
        self.listeners: List[Listener] = []
        for lc in self.broker.config.listeners:
            if not lc.enable:
                continue
            if lc.type == "quic":
                raise ValueError(
                    f"listener {lc.name}: quic is not ported to "
                    "emqx_tpu_torch (ROADMAP.md section 1, item 11)")
            if lc.type not in TRANSPORTS:
                raise ValueError(
                    f"listener {lc.name}: unknown type {lc.type!r}")
            self.listeners.append(Listener(self.broker, lc))
        self._housekeeper: Optional[asyncio.Task] = None
        self.api = None  # the management API, once started
        self.exhook_clients: list = []  # ExhookClient per config.exhooks

    @property
    def port(self) -> Optional[int]:
        """The first listener's bound port."""
        return self.listeners[0].port if self.listeners else None

    async def start(self) -> None:
        from .. import failpoints

        # arm any EMQX_FAILPOINTS spec before traffic flows (a no-op
        # when the variable is unset)
        failpoints.load_env()
        self.broker._loop = asyncio.get_running_loop()
        # the config's sinks first: a rule's SinkAction finds its worker
        # from the first window on, and one that fails to start raises
        try:
            for sink_cfg in self.broker.config.sinks:
                await self._start_sink(sink_cfg)
        except BaseException:
            await self.broker.resources.stop_all()
            raise
        for ex_cfg in self.broker.config.exhooks:
            from ..exhook.client import ExhookClient

            client = ExhookClient(
                self.broker,
                name=ex_cfg["name"],
                url=ex_cfg["url"],
                timeout=float(ex_cfg.get("timeout", 5.0)),
                failure_action=ex_cfg.get("failure_action", "deny"),
            )
            # OnProviderLoaded is a blocking round trip: off the loop.
            # start() never raises on an unreachable provider (a deny
            # policy fails closed, the housekeeping retries the load)
            await asyncio.get_running_loop().run_in_executor(
                None, client.start)
            self.exhook_clients.append(client)
        eng = self.broker.config.engine
        if eng.batch_publish:
            self.broker.batcher = PublishBatcher(
                self.broker,
                window=eng.batch_window_ms / 1000.0,
                batch_max=eng.batch_max,
                pipeline_windows=eng.pipeline_windows,
            )
            await self.broker.batcher.start()
        if self.broker.resume is not None:
            # the resume scheduler before the listeners accept: the
            # first reconnect of a storm already goes through admission
            await self.broker.resume.start()
        for lst in self.listeners:
            await lst.start()
        api_cfg = self.broker.config.api
        if api_cfg.enable:
            from ..mgmt import MgmtApi

            try:
                self.api = MgmtApi(self, bind=api_cfg.bind,
                                   port=api_cfg.port)
                await self.api.start()
            except BaseException:
                self.api = None
                await self.stop()
                raise
        self._housekeeper = asyncio.get_running_loop().create_task(
            self._housekeep()
        )

    async def _housekeep(self) -> None:
        """The broker's 1 Hz housekeeping, the $SYS heartbeat, the
        aggregators' interval flushes and the listeners' CRL reloads."""
        while True:
            await asyncio.sleep(1.0)
            try:
                self.broker.tick()
                self.sys.tick()
                for agg in self.broker.aggregators:
                    agg.tick()
                for lst in self.listeners:
                    lst.maybe_reload_crl()
                for client in self.exhook_clients:
                    if not client.loaded:
                        # a blocking dial: off the loop
                        await asyncio.get_running_loop().run_in_executor(
                            None, client.retry)
            except Exception:
                log.exception("housekeeping tick failed")

    async def _start_sink(self, sink_cfg: dict) -> None:
        """One config-declared data-integration sink: registered with
        the resource manager under its id, addressable from rule
        SinkActions (the emqx_bridge boot path)."""
        stype = sink_cfg.get("type", "http")
        if stype == "kafka":
            raise ValueError(
                f"sink {sink_cfg.get('id')!r}: kafka is not ported to "
                "emqx_tpu_torch (ROADMAP.md section 1, item 11)")
        if stype != "http":
            raise ValueError(f"unknown sink type {stype!r}")
        res = HttpSink(
            sink_cfg["url"],
            method=sink_cfg.get("method", "POST"),
            headers=sink_cfg.get("headers"),
        )
        await self.broker.resources.create(
            sink_cfg["id"], res,
            max_buffer=int(sink_cfg.get("max_buffer", 10_000)),
        )

    async def stop(self) -> None:
        if self._housekeeper is not None:
            await cancel_and_wait(self._housekeeper)
            self._housekeeper = None
        if self.api is not None:
            await self.api.stop()
            self.api = None
        for lst in self.listeners:
            await lst.stop()
        if self.broker.resume is not None:
            # after the listeners (no new resumes), before the batcher:
            # uncommitted jobs keep their boot checkpoints, so the next
            # boot replays their intervals (at-least-once)
            await self.broker.resume.stop()
        if self.broker.batcher is not None:
            await self.broker.batcher.stop()
            self.broker.batcher = None
        for client in self.exhook_clients:
            try:
                await asyncio.get_running_loop().run_in_executor(
                    None, client.stop)
            except Exception:
                log.debug("exhook client stop failed", exc_info=True)
        self.exhook_clients = []
        await self.broker.resources.stop_all()
        await self.broker.access.close()
        self.broker.shutdown()

    async def run_forever(self) -> None:
        try:
            await self.start()
            device = self.broker.router.engine.device
            for lst in self.listeners:
                print(f"emqx_tpu_torch broker listener {lst.cfg.name} "
                      f"({lst.cfg.type}) listening on "
                      f"{lst.cfg.bind}:{lst.port} (device {device})",
                      flush=True)
            if self.api is not None:
                print(f"emqx_tpu_torch management API listening on "
                      f"http://{self.api.bind}:{self.api.port}", flush=True)
            await asyncio.Event().wait()
        finally:
            await self.stop()


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="emqx_tpu_torch MQTT broker")
    ap.add_argument("--config", default=None, help="JSON config file")
    ap.add_argument(
        "--check-config", action="store_true",
        help="validate the config (file and EMQX_TPU_* overrides) and "
        "exit: 0 when it boots cleanly",
    )
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--bind", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    failed = 1 if args.check_config else 2
    try:
        cfg = (ConfigHandler.load(args.config).root if args.config
               else BrokerConfig())
        # EMQX_TPU_A__B=value lands between the file and the flags
        applied = apply_env_overrides(cfg)
    except (OSError, ValueError, TypeError) as exc:
        print(f"config error: {exc}", file=sys.stderr)
        raise SystemExit(failed)
    for path, value in applied:
        log.info("env override: %s = %r", path, value)
    problems = check_config(cfg)
    for p in problems:
        print(f"config error: {p}", file=sys.stderr)
    if args.check_config:
        print("config ok" if not problems else f"{len(problems)} problem(s)",
              file=sys.stderr if problems else sys.stdout)
        raise SystemExit(1 if problems else 0)
    if problems:
        raise SystemExit(2)
    # the flags override the first listener only when given
    if args.port is not None:
        cfg.listeners[0].port = args.port
    if args.bind is not None:
        cfg.listeners[0].bind = args.bind
    try:
        server = BrokerServer(cfg, device=args.device)
    except (RuntimeError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        raise SystemExit(2)
    try:
        asyncio.run(server.run_forever())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
