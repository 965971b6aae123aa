"""Asyncio TCP connection: the owning loop for one client socket.

Reads socket chunks into the incremental `StreamParser`, feeds packets
to the channel state machine, serializes outgoing packets, and drives
the keepalive / retry timers.  The transport's write buffer feeds the
outbound watermark (`Channel.out_buffered`) and the
``conn_congestion/<clientid>`` alarm: raised at `CONGESTION_BYTES`
buffered (counting ``connection.congested``), cleared below a quarter
of that and on close.  With a ``limiter`` (the listener's
`HierarchicalLimiter` or one `ConnectionLimiter`) each read's bytes and
each PUBLISH draw from its buckets, and the read loop sleeps the
deficit (in 1 s slices) before it goes on: the client is throttled
through TCP backpressure, never disconnected.
"""

from __future__ import annotations

import asyncio
import logging
from typing import List, Optional

from ..codec import mqtt as C
from .broker import Broker
from .channel import CONNECTING, Channel

log = logging.getLogger("emqx_tpu_torch.connection")

_TIMER_TICK = 5.0  # keepalive/retry check cadence


class Connection:
    def __init__(
        self,
        broker: Broker,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        mountpoint: Optional[str] = None,
        limiter=None,
    ) -> None:
        self.broker = broker
        self.reader = reader
        self.writer = writer
        self.limiter = limiter
        peername = writer.get_extra_info("peername")
        peer = f"{peername[0]}:{peername[1]}" if peername else "?"
        self.channel = Channel(
            broker, send=self._send_packets, close=self._close, peer=peer,
            mountpoint=mountpoint,
        )
        # the watermark's input: the transport's write buffer, where a
        # stalled subscriber's bytes pile up (a WebSocket stream has no
        # transport of its own: its watermark stays off)
        transport = getattr(writer, "transport", None)
        if transport is not None and hasattr(transport,
                                             "get_write_buffer_size"):
            self.channel.transport_buffered = transport.get_write_buffer_size
        self.parser = C.StreamParser(
            max_packet_size=broker.config.mqtt.max_packet_size
        )
        self._closed = asyncio.Event()
        self._congested = False

    # a connection whose transport holds more than this is a congested
    # subscriber: alarm per client id, cleared once the buffer drains
    CONGESTION_BYTES = 1 << 20

    def _send_packets(self, packets: List[C.Packet]) -> None:
        if self.writer.is_closing():
            return
        version = self.channel.version
        data = b"".join(C.serialize(p, version) for p in packets)
        # a Raw blob (the native window assembly) carries a whole run
        self.broker.metrics.inc(
            "packets.sent", sum(getattr(p, "n_packets", 1) for p in packets))
        self.broker.metrics.inc("bytes.sent", len(data))
        self.writer.write(data)
        buffered = self.channel.out_buffered()
        if buffered == 0 and not self._congested:
            return
        name = f"conn_congestion/{self._alarm_id()}"
        if buffered >= self.CONGESTION_BYTES:
            if not self._congested:
                self._congested = True
                self.broker.metrics.inc("connection.congested")
                self.broker.alarms.activate(
                    name,
                    details={"clientid": self._alarm_id(),
                             "buffered": buffered},
                    message="connection send buffer congested "
                    "(slow consumer)",
                )
        elif self._congested and buffered < self.CONGESTION_BYTES // 4:
            self._congested = False
            self.broker.alarms.deactivate(name)

    def _alarm_id(self) -> str:
        client = self.channel.client
        return client.clientid if client is not None else self.channel.peer

    def _close(self, reason: str) -> None:
        if self._congested:
            # the alarm must not outlive its connection
            self._congested = False
            self.broker.alarms.deactivate(
                f"conn_congestion/{self._alarm_id()}")
        if not self.writer.is_closing():
            self.writer.close()
        self._closed.set()

    async def run(self) -> None:
        """The connection's receive loop."""
        timer = asyncio.get_running_loop().create_task(self._timers())
        reason = "closed"
        try:
            idle = self.broker.config.mqtt.idle_timeout
            while not self._closed.is_set():
                timeout = idle if self.channel.state == CONNECTING else None
                try:
                    data = await asyncio.wait_for(
                        self.reader.read(65536), timeout
                    )
                except asyncio.TimeoutError:
                    reason = "idle_timeout"
                    break
                if not data:
                    break
                self.broker.metrics.inc("bytes.received", len(data))
                if self.limiter is None:
                    for pkt in self.parser.feed(data):
                        self.channel.handle_in(pkt)
                        if self._closed.is_set():
                            break
                else:
                    # inside the packet loop: one read may carry a whole
                    # flood, so pausing only the next read would let it
                    # through
                    await self._limit(len(data), 0)
                    for pkt in self.parser.feed(data):
                        if pkt.type == C.PUBLISH:
                            await self._limit(0, 1)
                        self.channel.handle_in(pkt)
                        if self._closed.is_set():
                            break
                await self._drain()
                batcher = self.broker.batcher
                if batcher is not None and batcher.congested(self.channel):
                    # stop reading until this client's lane drains: TCP
                    # backpressure reaches the client, and only it
                    await batcher.wait_uncongested(self.channel)
                if self.channel.defer_saturated:
                    # the async-verdict chain sits before the batcher:
                    # a flood must pause on it too
                    await self.channel.wait_defer_drain()
        except C.MqttError as exc:
            log.debug("codec error from %s: %s", self.channel.peer, exc)
            reason = "frame_error"
        except (ConnectionResetError, BrokenPipeError):
            reason = "peer_reset"
        except asyncio.CancelledError:
            reason = "server_stopped"
        finally:
            timer.cancel()
            self.channel.connection_lost(reason)
            if not self.writer.is_closing():
                self.writer.close()
            try:
                await self.writer.wait_closed()
            except (ConnectionError, asyncio.CancelledError):
                pass

    async def _limit(self, n_bytes: int, n_messages: int) -> None:
        """Draw from the limiter and sleep the whole deficit (shared
        listener and zone buckets hand out long waits under contention:
        cutting them short would let the aggregate rate grow with the
        number of connections), in 1 s slices so a close stays
        prompt."""
        delay = self.limiter.consume(n_bytes, n_messages)
        if delay <= 0:
            return
        self.broker.metrics.inc("connection.rate_limited")
        while delay > 0 and not self._closed.is_set():
            step = min(delay, 1.0)
            await asyncio.sleep(step)
            delay -= step

    async def _drain(self) -> None:
        try:
            await self.writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            self._closed.set()

    async def _timers(self) -> None:
        """Keepalive + redelivery ticks."""
        while not self._closed.is_set():
            await asyncio.sleep(_TIMER_TICK)
            if self.channel.keepalive_expired():
                self.channel.close("keepalive_timeout")
                return
            self.channel.retry_deliveries()
            await self._drain()
