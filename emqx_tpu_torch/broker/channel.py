"""Channel: the per-connection MQTT protocol state machine.

Handles CONNECT/CONNACK, SUBSCRIBE/SUBACK (``$share/`` and
``$exclusive/`` filters, retained replay after the SUBACK),
UNSUBSCRIBE/UNSUBACK, PUBLISH at QoS 0/1/2 with PUBACK,
PUBREC/PUBREL/PUBCOMP in both directions, PINGREQ and DISCONNECT, on
MQTT 3.1.1 and 5.0, as the JAX package's channel does.  CONNECT runs the
``client.connect`` hook, the banned list (0x8A) and then authentication
(`AccessControl`, deferred to a task when a provider or hook is
async); PUBLISH and SUBSCRIBE are authorized on the mounted topic
(0x87), through an ordered chain of async continuations when a
``client.authorize`` hook is async; SUBSCRIBE and UNSUBSCRIBE filters
pass the topic rewrite first.  A lost connection feeds the flapping
detector; the configured ``auto_subscribe`` filters are subscribed at
every connect.  Pure state machine: the owning `Connection` feeds parsed
packets in and gets packets out through ``send``.
"""

from __future__ import annotations

import asyncio
import logging
import secrets
import time
from typing import Dict, List, Optional, Tuple

from .. import topic as T
from ..access import PUBLISH, SUBSCRIBE, ClientInfo
from ..codec import mqtt as C
from ..message import Message
from ..modules import ExclusiveSub
from .broker import Broker
from .resume import ResumeBusy
from .session import Session, SubOpts

log = logging.getLogger("emqx_tpu_torch.channel")

CONNECTING = "connecting"
CONNECTED = "connected"
DISCONNECTED = "disconnected"

# reason codes (MQTT 5)
RC_NORMAL = 0x00
RC_NO_MATCHING_SUBSCRIBERS = 0x10
RC_NO_SUBSCRIPTION_EXISTED = 0x11
RC_UNSPECIFIED = 0x80
RC_PROTOCOL_ERROR = 0x82
RC_BAD_CLIENTID = 0x85
RC_BAD_AUTH = 0x86
RC_NOT_AUTHORIZED = 0x87
RC_SERVER_BUSY = 0x89
RC_BANNED = 0x8A
RC_PACKET_ID_IN_USE = 0x91
RC_RECEIVE_MAX_EXCEEDED = 0x93
RC_TOPIC_ALIAS_INVALID = 0x94
RC_SESSION_TAKEN_OVER = 0x8E
RC_TOPIC_FILTER_INVALID = 0x8F
RC_TOPIC_NAME_INVALID = 0x90
RC_QUOTA_EXCEEDED = 0x97
RC_SHARED_SUB_UNSUPPORTED = 0x9E
RC_WILDCARD_SUB_UNSUPPORTED = 0xA2

# CONNACK codes for MQTT < 5
_V3_CONNACK = {
    RC_BAD_CLIENTID: 2,
    RC_SERVER_BUSY: 3,
    RC_BAD_AUTH: 4,
    RC_NOT_AUTHORIZED: 5,
}

_QOS_SENT = ("messages.qos0.sent", "messages.qos1.sent",
             "messages.qos2.sent")
_QOS_RECV = ("messages.qos0.received", "messages.qos1.received",
             "messages.qos2.received")


class Channel:
    # metric slot tuples, resolved once (one registry layout a process)
    _recv_slots = None
    _sent_slots = None
    _auth_ok = None

    def __init__(self, broker: Broker, send, close, peer: str = "",
                 mountpoint: Optional[str] = None) -> None:
        self.broker = broker
        self._send = send
        self._close = close
        self.state = CONNECTING
        self.version = C.MQTT_V5
        self.client: Optional[ClientInfo] = None
        self.session: Optional[Session] = None
        self.keepalive = 0.0
        self.peer = peer
        self.mountpoint = mountpoint
        self.will_msg: Optional[Message] = None
        self._alias_in: Dict[int, str] = {}
        self.last_rx = time.time()
        self._closing = False
        self._pending_connect: Optional[asyncio.Task] = None
        self._connect_backlog: List[C.Packet] = []  # pipelined pre-CONNACK
        # the ordered chain of async continuations (async authorize
        # hooks): its tail, every live task (shutdown cancels them
        # all), and its depth for the read loop's backpressure
        self._defer_tail: Optional[asyncio.Task] = None
        self._defer_tasks: set = set()
        self._defer_depth = 0
        self._defer_drained: Optional[asyncio.Event] = None
        self.DEFER_HIGH = 256
        self.DEFER_LOW = 64
        # write coalescing: while corked (a dispatch window), outgoing
        # packets buffer and flush as ONE write on uncork
        self._cork_depth = 0
        self._cork_buf: List[C.Packet] = []
        # wired by the owning Connection: () -> bytes buffered in the
        # transport toward this client, the outbound watermark's input
        # (None: the transport cannot report, the watermark is off)
        self.transport_buffered = None

    def out_buffered(self) -> int:
        """Bytes buffered toward this client in the transport (cork
        buffers flush within their window; the transport buffer is what
        a stalled subscriber grows)."""
        fn = self.transport_buffered
        if fn is None:
            return 0
        try:
            return fn()
        except Exception:
            return 0

    @property
    def clientid(self) -> Optional[str]:
        return None if self.client is None else self.client.clientid

    # ---------------------------------------------------------- util

    def cork(self) -> None:
        self._cork_depth += 1

    def uncork(self) -> None:
        if self._cork_depth:
            self._cork_depth -= 1
        if self._cork_depth == 0 and self._cork_buf:
            buf, self._cork_buf = self._cork_buf, []
            if not self._closing:
                self._send(buf)

    def _pub_sent_slots(self, m):
        sent = Channel._sent_slots
        if sent is None:
            sent = Channel._sent_slots = tuple(
                m.slots("messages.sent", q, "packets.publish.sent")
                for q in _QOS_SENT)
        return sent

    def send_packets(self, packets: List[C.Packet]) -> None:
        if packets and not self._closing:
            m = self.broker.metrics
            sent = self._pub_sent_slots(m)
            npub = [0, 0, 0]
            for p in packets:
                if p.type == C.PUBLISH:
                    npub[p.qos] += 1
            for q in (0, 1, 2):
                if npub[q]:
                    m.inc_slots(sent[q], npub[q])
            if self._cork_depth:
                self._cork_buf.extend(packets)
                return
            self._send(packets)

    def send_wire(self, data, npub: Tuple[int, int, int]) -> bool:
        """One pre-assembled delivery run (the native window path): the
        sent counters `send_packets` bumps, then ONE `Raw` blob into the
        corked buffer.  Returns False when the channel is closing and
        the blob was dropped."""
        if self._closing:
            return False
        m = self.broker.metrics
        sent = self._pub_sent_slots(m)
        for q in (0, 1, 2):
            if npub[q]:
                m.inc_slots(sent[q], npub[q])
        pkt = C.Raw(data, self.version, npub[0] + npub[1] + npub[2])
        if self._cork_depth:
            self._cork_buf.append(pkt)
        else:
            self._send([pkt])
        return True

    def close(self, reason: str) -> None:
        """CM-initiated close (takeover): tell a v5 client why."""
        if self._closing:
            return
        if self.version == C.MQTT_V5 and self.state == CONNECTED:
            rc = RC_SESSION_TAKEN_OVER if reason == "takenover" \
                else RC_UNSPECIFIED
            self._send([C.Disconnect(reason_code=rc)])
        if reason == "takenover":
            # the session moves to the new channel
            self.session = None
            self.will_msg = None
        self._shutdown(reason)

    def _shutdown(self, reason: str) -> None:
        self._closing = True
        self.state = DISCONNECTED
        self._cork_buf = []
        # cancel the WHOLE deferred chain, not only its tail
        for t in list(self._defer_tasks):
            t.cancel()
        self._defer_tasks.clear()
        self._defer_tail = None
        self._close(reason)

    @property
    def defer_saturated(self) -> bool:
        return self._defer_depth >= self.DEFER_HIGH

    async def wait_defer_drain(self) -> None:
        while self._defer_depth > self.DEFER_LOW and not self._closing:
            if self._defer_drained is None:
                self._defer_drained = asyncio.Event()
            self._defer_drained.clear()
            if self._defer_depth <= self.DEFER_LOW:
                return
            await self._defer_drained.wait()

    def _defer(self, coro) -> None:
        """Chain an async continuation behind every earlier deferred
        packet, so the connection's packet order survives an off-loop
        verdict wait: each runs only after its predecessor ended."""
        prev = self._defer_tail
        self._defer_depth += 1

        async def run() -> None:
            if prev is not None:
                # wait() swallows the predecessor's failure or cancel
                # (it never skips THIS packet) and still propagates our
                # own cancellation from _shutdown
                try:
                    await asyncio.wait({prev})
                except asyncio.CancelledError:
                    coro.close()
                    raise
            try:
                await coro
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("deferred packet handling failed")

        task = asyncio.get_running_loop().create_task(run())
        self._defer_tasks.add(task)

        def done(t, channel=self):
            channel._defer_tasks.discard(t)
            channel._defer_depth -= 1
            if channel._defer_tail is t:
                channel._defer_tail = None
            if (channel._defer_drained is not None
                    and channel._defer_depth <= channel.DEFER_LOW):
                channel._defer_drained.set()

        task.add_done_callback(done)
        self._defer_tail = task

    def _defer_if_async(self, coro_fn, pkt) -> bool:
        """Defer ``coro_fn(pkt)`` into the chain when an async
        ``client.authorize`` hook is loaded, or while the chain is not
        empty (sticky: later packets must not overtake deferred ones).
        False without a running loop: the caller then blocks."""
        if not (self.broker.access.has_async_authz_hooks
                or self._defer_depth > 0):
            return False
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return False
        self._defer(coro_fn(pkt))
        return True

    def _mount(self, topic: str) -> str:
        return self.mountpoint + topic if self.mountpoint else topic

    # ------------------------------------------------------ incoming

    def handle_in(self, pkt: C.Packet) -> None:
        """One parsed packet from the wire."""
        self.last_rx = time.time()
        m = self.broker.metrics
        m.inc("packets.received")
        if self.state == CONNECTING:
            if self._pending_connect is not None:
                # CONNECT is resolving asynchronously: a client may
                # pipeline packets before CONNACK (bounded), replayed
                # once connected; a second CONNECT is fatal
                if pkt.type == C.CONNECT:
                    self._shutdown("protocol_error")  # [MQTT-3.1.0-2]
                elif len(self._connect_backlog) >= 64:
                    self._shutdown("connect_backlog_overflow")
                else:
                    self._connect_backlog.append(pkt)
                return
            if pkt.type != C.CONNECT:
                self._shutdown("protocol_error")
                return
            self._handle_connect(pkt)
            return
        t = pkt.type
        if t == C.CONNECT:
            self._disconnect_with(RC_PROTOCOL_ERROR)  # [MQTT-3.1.0-2]
        elif t == C.PUBLISH:
            self._handle_publish(pkt)
        elif t == C.PUBACK:
            m.inc("packets.puback.received")
            ok, out = self.session.puback(pkt.packet_id)
            if ok:
                m.inc("messages.acked")
                self.broker.hooks.run("message.acked", self.clientid,
                                      pkt.packet_id)
            self.send_packets(out)
        elif t == C.PUBREC:
            m.inc("packets.pubrec.received")
            _ok, out = self.session.pubrec(pkt.packet_id)
            if out:
                m.inc("packets.pubrel.sent")
            self.send_packets(out)
        elif t == C.PUBREL:
            m.inc("packets.pubrel.received")
            found = self.session.pubrel(pkt.packet_id)
            m.inc("packets.pubcomp.sent")
            self.send_packets(
                [C.Pubcomp(packet_id=pkt.packet_id,
                           reason_code=0 if found else 0x92)]
            )
        elif t == C.PUBCOMP:
            m.inc("packets.pubcomp.received")
            ok, out = self.session.pubcomp(pkt.packet_id)
            if ok:
                m.inc("messages.acked")
            self.send_packets(out)
        elif t == C.SUBSCRIBE:
            self._handle_subscribe(pkt)
        elif t == C.UNSUBSCRIBE:
            self._handle_unsubscribe(pkt)
        elif t == C.PINGREQ:
            m.inc("packets.pingreq.received")
            m.inc("packets.pingresp.sent")
            self.send_packets([C.Pingresp()])
        elif t == C.DISCONNECT:
            self._handle_disconnect(pkt)
        elif t == C.AUTH:
            m.inc("packets.auth.received")
            self._disconnect_with(RC_PROTOCOL_ERROR)  # no enhanced auth
        else:
            self._shutdown("protocol_error")

    # ------------------------------------------------------- connect

    def _handle_connect(self, pkt: C.Connect) -> None:
        m = self.broker.metrics
        m.inc("packets.connect.received")
        m.inc("client.connect")
        self.version = pkt.proto_ver
        self.broker.hooks.run("client.connect", pkt)
        mqtt = self.broker.config.mqtt
        clientid = pkt.client_id
        assigned = None
        if not clientid:
            if self.version < C.MQTT_V5 and not pkt.clean_start:
                self._connack_error(RC_BAD_CLIENTID)  # [MQTT-3.1.3-8]
                return
            clientid = assigned = "emqx_tpu_" + secrets.token_hex(8)
        if len(clientid) > mqtt.max_clientid_len:
            self._connack_error(RC_BAD_CLIENTID)
            return
        # banned before authentication: a banned client costs no
        # credential check
        peerhost = self.peer.rsplit(":", 1)[0] if self.peer else ""
        if self.broker.banned.is_banned(
            clientid=clientid, username=pkt.username, peerhost=peerhost
        ):
            m.inc("client.banned")
            self._connack_error(RC_BANNED)  # [MQTT-3.2.2.2]
            return
        client = ClientInfo(
            clientid=clientid,
            username=pkt.username,
            password=pkt.password,
            peerhost=self.peer,
            mountpoint=self.mountpoint,
        )
        m.inc("client.authenticate")
        access = self.broker.access
        if access.has_async_authn or access.has_async_authz:
            # IO-backed providers must not block the loop: the rest of
            # CONNECT waits for the chain in a task
            self._pending_connect = asyncio.get_running_loop().create_task(
                self._async_auth_connect(pkt, clientid, assigned, client)
            )
            return
        ok, client = access.authenticate(client)
        self._post_auth_connect(pkt, clientid, assigned, client, ok)

    async def _async_auth_connect(self, pkt, clientid, assigned,
                                  client) -> None:
        try:
            access = self.broker.access
            if access.has_async_authn:
                ok, client = await access.authenticate_async(client)
            else:
                ok, client = access.authenticate(client)
            if ok:
                await access.prefetch_acl(client)
        except Exception:
            log.exception("async authentication failed for %s", clientid)
            ok = False
        self._pending_connect = None
        if self.state != CONNECTING:
            return
        self._post_auth_connect(pkt, clientid, assigned, client, ok)

    def _post_auth_connect(self, pkt, clientid, assigned, client,
                           ok) -> None:
        m = self.broker.metrics
        mqtt = self.broker.config.mqtt
        if not ok:
            # the JAX package counts a refused CONNECT under this name
            m.inc("packets.publish.auth_error")
            self._connack_error(RC_BAD_AUTH)
            return
        if client.username is None:
            m.inc("client.auth.anonymous")
        client.password = None  # never retain credentials
        self.client = client
        expiry = float(
            pkt.properties.get("session_expiry_interval", 0)
            if self.version == C.MQTT_V5
            else (0 if pkt.clean_start else mqtt.session_expiry_interval)
        )
        receive_max = pkt.properties.get("receive_maximum")
        try:
            session, present = self.broker.open_session(
                pkt.clean_start,
                clientid,
                self,
                expiry_interval=expiry,
                max_inflight=min(
                    mqtt.max_inflight, receive_max or mqtt.max_inflight
                ),
            )
        except ResumeBusy:
            # resume admission saturated (a mass-reconnect storm): the
            # client backs off and retries
            self._connack_error(RC_SERVER_BUSY)
            return
        self.session = session
        self.broker.cancel_will(clientid)  # reconnect cancels a delayed will
        if present:
            m.inc("session.resumed")
            self.broker.hooks.run("session.resumed", clientid)
            # re-register subscriptions in case the router was cleaned
            for flt, opts in session.subscriptions.items():
                self.broker.router.subscribe(clientid, flt, opts)
        if pkt.will is not None:
            self.will_msg = Message(
                topic=self._mount(pkt.will.topic),
                payload=pkt.will.payload,
                qos=min(pkt.will.qos, mqtt.max_qos_allowed),
                retain=pkt.will.retain,
                from_client=clientid,
                from_username=client.username,
                properties=dict(pkt.will.properties),
            )
        self.keepalive = float(
            mqtt.server_keepalive
            if (mqtt.server_keepalive and self.version == C.MQTT_V5)
            else pkt.keepalive
        )
        props: C.Properties = {}
        if self.version == C.MQTT_V5:
            if assigned is not None:
                props["assigned_client_identifier"] = assigned
            if mqtt.server_keepalive:
                props["server_keep_alive"] = mqtt.server_keepalive
            if mqtt.max_qos_allowed < 2:
                props["maximum_qos"] = mqtt.max_qos_allowed
            if not mqtt.retain_available:
                props["retain_available"] = 0
            if not mqtt.wildcard_subscription:
                props["wildcard_subscription_available"] = 0
            if not mqtt.shared_subscription:
                props["shared_subscription_available"] = 0
            props["topic_alias_maximum"] = mqtt.max_topic_alias
            props["receive_maximum"] = mqtt.max_inflight
            props["session_expiry_interval"] = int(expiry)
            props["maximum_packet_size"] = mqtt.max_packet_size
        self.state = CONNECTED
        m.inc("packets.connack.sent")
        m.inc("client.connack")
        m.inc("client.connected")
        self.broker.hooks.run("client.connected", client)
        self.send_packets(
            [C.Connack(session_present=present, reason_code=0,
                       properties=props)]
        )
        self._auto_subscribe(client, session)
        if present:
            self.send_packets(session.resume())
        # the packets the client pipelined while CONNECT resolved
        backlog, self._connect_backlog = self._connect_backlog, []
        for pending in backlog:
            if self.state != CONNECTED:
                break
            self.handle_in(pending)

    def _auto_subscribe(self, client: ClientInfo, session: Session) -> None:
        """The configured server-side subscriptions, made at every
        connect through the checks a client SUBSCRIBE passes (filter
        validity, the mountpoint, authorization); subscribing again is
        a no-op.  Retained messages are not replayed to them."""
        clientid = client.clientid
        for entry in self.broker.config.auto_subscribe:
            flt = (entry["topic"].replace("%c", clientid)
                   .replace("%u", client.username or ""))
            try:
                T.validate_filter(flt)
            except ValueError:
                log.warning("invalid auto_subscribe filter %r", flt)
                continue
            full = self._mount(flt)
            if not self.broker.access.authorize(client, SUBSCRIBE, full):
                continue
            opts = SubOpts(qos=int(entry.get("qos", 0)))
            is_new = session.subscribe(full, opts)
            self.broker.subscribe(clientid, full, opts, is_new_sub=is_new)

    def _connack_error(self, rc: int) -> None:
        code = rc if self.version == C.MQTT_V5 else _V3_CONNACK.get(rc, 3)
        self.broker.metrics.inc("packets.connack.sent")
        self._send([C.Connack(session_present=False, reason_code=code)])
        self._shutdown("connack_error")

    # ------------------------------------------------------- publish

    def _resolve_alias(self, pkt: C.Publish) -> Optional[str]:
        """MQTT 5 topic-alias resolution; None => protocol error."""
        alias = pkt.properties.get("topic_alias")
        if alias is None:
            return pkt.topic
        if (
            not isinstance(alias, int)
            or alias == 0
            or alias > self.broker.config.mqtt.max_topic_alias
        ):
            return None
        if pkt.topic:
            self._alias_in[alias] = pkt.topic
            return pkt.topic
        return self._alias_in.get(alias)

    def _handle_publish(self, pkt: C.Publish) -> None:
        if self._defer_if_async(self._handle_publish_async, pkt):
            return
        full_topic = self._publish_validate(pkt)
        if full_topic is None:
            return
        ok = self.broker.access.authorize(self.client, PUBLISH, full_topic)
        self._publish_post_auth(pkt, full_topic, ok)

    async def _handle_publish_async(self, pkt: C.Publish) -> None:
        full_topic = self._publish_validate(pkt)
        if full_topic is None:
            return
        ok = await self.broker.access.authorize_async(
            self.client, PUBLISH, full_topic)
        if self._closing or self.state != CONNECTED:
            return  # the channel died while the verdict was in flight
        self._publish_post_auth(pkt, full_topic, ok)

    def _publish_validate(self, pkt: C.Publish) -> Optional[str]:
        """Checks before authorization; returns the mounted topic, or
        None after answering or disconnecting."""
        m = self.broker.metrics
        recv = Channel._recv_slots
        if recv is None:
            recv = Channel._recv_slots = tuple(
                m.slots("packets.publish.received", "messages.received", q)
                for q in _QOS_RECV)
        m.inc_slots(recv[pkt.qos])
        topic = (self._resolve_alias(pkt) if self.version == C.MQTT_V5
                 else pkt.topic)
        if topic is None:
            self._disconnect_with(RC_TOPIC_ALIAS_INVALID)
            return None
        try:
            T.validate_name(topic)
        except ValueError:
            m.inc("packets.publish.error")
            self._disconnect_with(RC_TOPIC_NAME_INVALID)
            return None
        mqtt = self.broker.config.mqtt
        if pkt.qos > mqtt.max_qos_allowed:
            self._disconnect_with(0x9B)  # QoS not supported
            return None
        if pkt.retain and not mqtt.retain_available:
            self._disconnect_with(0x9A)  # retain not supported
            return None
        return self._mount(topic)

    def _publish_post_auth(self, pkt: C.Publish, full_topic: str,
                           ok: bool) -> None:
        m = self.broker.metrics
        if not ok:
            m.inc("client.authorize")
            m.inc("authorization.deny")
            m.inc("packets.publish.auth_error")
            self._publish_denied(pkt)
            return
        ok_slots = Channel._auth_ok
        if ok_slots is None:
            ok_slots = Channel._auth_ok = m.slots(
                "client.authorize", "authorization.allow")
        m.inc_slots(ok_slots)
        props = {
            k: v for k, v in pkt.properties.items() if k != "topic_alias"
        }
        msg = Message(
            topic=full_topic,
            payload=pkt.payload,
            qos=pkt.qos,
            retain=pkt.retain,
            from_client=self.client.clientid,
            from_username=self.client.username,
            properties=props,
        )
        batcher = self.broker.batcher
        if pkt.qos == 0:
            if batcher is not None:
                batcher.publish_nowait(msg, source=self)
            else:
                self.broker.publish(msg)
            return
        if pkt.qos == 2:
            # route immediately, dedup on packet id until PUBREL
            st = self.session.awaiting_rel_add(pkt.packet_id)
            if st == "in_use":
                m.inc("packets.pubrec.sent")
                self.send_packets(
                    [C.Pubrec(packet_id=pkt.packet_id, reason_code=0)]
                )
                return
            if st == "full":
                m.inc("messages.dropped")
                m.inc("messages.dropped.await_pubrel_timeout")
                self._disconnect_with(RC_RECEIVE_MAX_EXCEEDED)
                return
        if batcher is not None:
            # the ack resolves from the window's future
            batcher.publish(msg, source=self).add_done_callback(
                lambda f, pid=pkt.packet_id, q=pkt.qos:
                    self._publish_acked(pid, q, f)
            )
        else:
            self._send_pub_ack(pkt.packet_id, pkt.qos,
                               self.broker.publish(msg))

    def _publish_denied(self, pkt: C.Publish) -> None:
        """An unauthorized publish: dropped with a 0x87 ack, or the
        connection closed with 0x87, per ``deny_action``."""
        if self.broker.access.deny_action == "disconnect":
            self._disconnect_with(RC_NOT_AUTHORIZED)
            return
        if pkt.qos == 1:
            self.send_packets([C.Puback(packet_id=pkt.packet_id,
                                        reason_code=RC_NOT_AUTHORIZED)])
        elif pkt.qos == 2:
            self.send_packets([C.Pubrec(packet_id=pkt.packet_id,
                                        reason_code=RC_NOT_AUTHORIZED)])

    def _publish_acked(self, packet_id: int, qos: int, fut) -> None:
        """Window future resolved: emit the deferred PUBACK/PUBREC."""
        if fut.cancelled():
            return
        if fut.exception() is not None:
            # never ack a publish that was not routed; a QoS 2 id leaves
            # awaiting_rel so the retransmit routes again
            if qos == 2 and self.session is not None:
                self.session.awaiting_rel.pop(packet_id, None)
            self.broker.metrics.inc("messages.publish.error")
            if self.state == CONNECTED:
                self._disconnect_with(RC_UNSPECIFIED)
            return
        self._send_pub_ack(packet_id, qos, fut.result())

    def _send_pub_ack(self, packet_id: int, qos: int, n: int) -> None:
        m = self.broker.metrics
        rc = (
            RC_NO_MATCHING_SUBSCRIBERS
            if (n == 0 and self.version == C.MQTT_V5)
            else 0
        )
        if qos == 1:
            m.inc("packets.puback.sent")
            self.send_packets([C.Puback(packet_id=packet_id, reason_code=rc)])
        else:
            m.inc("packets.pubrec.sent")
            self.send_packets([C.Pubrec(packet_id=packet_id, reason_code=rc)])

    # ----------------------------------------------------- subscribe

    def _handle_subscribe(self, pkt: C.Subscribe) -> None:
        if self._defer_if_async(self._handle_subscribe_async, pkt):
            return
        self._subscribe_body(pkt, None)

    async def _handle_subscribe_async(self, pkt: C.Subscribe) -> None:
        """Each filter's verdict off the loop, then the synchronous
        subscribe body with them."""
        verdicts: List[Optional[bool]] = []
        for sub in pkt.subscriptions:
            real = self._sub_authz_topic(sub.topic_filter)
            verdicts.append(None if real is None else
                            await self.broker.access.authorize_async(
                                self.client, SUBSCRIBE, real))
        if self._closing or self.state != CONNECTED:
            return
        self._subscribe_body(pkt, verdicts)

    def _sub_authz_topic(self, topic_filter: str) -> Optional[str]:
        """The mounted real topic a filter is authorized on, as
        `_do_subscribe` derives it; None when the filter is invalid."""
        flt = self.broker.rewrite.rewrite_sub(topic_filter)
        try:
            T.validate_filter(flt)
        except ValueError:
            return None
        if flt.startswith(ExclusiveSub.PREFIX):
            flt = flt[len(ExclusiveSub.PREFIX):]
            if not flt:
                return None
        shared = T.parse_share(flt)
        return self._mount(shared.topic if shared else flt)

    def _subscribe_body(self, pkt: C.Subscribe,
                        verdicts: Optional[List[Optional[bool]]]) -> None:
        """SUBACK first, then the granted filters' retained messages,
        through the session (inflight window, then mqueue), in one
        write."""
        m = self.broker.metrics
        m.inc("packets.subscribe.received")
        subid = pkt.properties.get("subscription_identifier")
        if isinstance(subid, list):
            subid = subid[0] if subid else None
        retained_jobs: List[Tuple[Message, SubOpts]] = []
        rcs = [self._do_subscribe(sub, subid, retained_jobs,
                                  None if verdicts is None else verdicts[i])
               for i, sub in enumerate(pkt.subscriptions)]
        if self.version != C.MQTT_V5:
            rcs = [rc if rc <= 2 else 0x80 for rc in rcs]
        m.inc("packets.suback.sent")
        self.send_packets([C.Suback(packet_id=pkt.packet_id,
                                    reason_codes=rcs)])
        if retained_jobs:
            self.send_packets(self.session.deliver(retained_jobs))

    def _do_subscribe(
        self, sub: C.Subscription, subid: Optional[int],
        retained_jobs: List[Tuple[Message, SubOpts]],
        authz: Optional[bool] = None,
    ) -> int:
        m = self.broker.metrics
        mqtt = self.broker.config.mqtt
        flt = self.broker.rewrite.rewrite_sub(sub.topic_filter)
        try:
            T.validate_filter(flt)
        except ValueError:
            m.inc("packets.subscribe.error")
            return RC_TOPIC_FILTER_INVALID
        exclusive = flt.startswith(ExclusiveSub.PREFIX)
        if exclusive:
            if not mqtt.exclusive_subscription:
                return RC_TOPIC_FILTER_INVALID
            flt = flt[len(ExclusiveSub.PREFIX):]
            if not flt:
                return RC_TOPIC_FILTER_INVALID
            # the lock is taken LAST, after every check below: an error
            # return must not leave a stale hold
        shared = T.parse_share(flt)
        if shared is not None and not mqtt.shared_subscription:
            return RC_SHARED_SUB_UNSUPPORTED
        real = shared.topic if shared else flt
        if T.is_wildcard(real) and not mqtt.wildcard_subscription:
            return RC_WILDCARD_SUB_UNSUPPORTED
        if T.levels(real) > mqtt.max_topic_levels:
            return RC_TOPIC_FILTER_INVALID
        full = self._mount(flt) if shared is None else flt
        m.inc("client.authorize")
        allowed = authz if authz is not None else \
            self.broker.access.authorize(self.client, SUBSCRIBE,
                                         self._mount(real))
        if not allowed:
            m.inc("authorization.deny")
            m.inc("packets.subscribe.auth_error")
            return RC_NOT_AUTHORIZED
        m.inc("authorization.allow")
        granted = min(sub.qos, mqtt.max_qos_allowed)
        opts = SubOpts(
            qos=granted,
            no_local=sub.no_local,
            retain_as_published=sub.retain_as_published,
            retain_handling=sub.retain_handling,
            subid=subid,
        )
        if shared is not None and sub.no_local:
            return RC_PROTOCOL_ERROR  # [MQTT-3.8.3-4]
        hooked = self.broker.hooks.run_fold(
            "client.subscribe", (self.client, flt), opts)
        if hooked is None:
            return RC_NOT_AUTHORIZED
        opts = hooked
        if exclusive and not self.broker.exclusive.acquire(
            self.clientid, flt
        ):
            return RC_QUOTA_EXCEEDED  # already held by another client
        is_new = self.session.subscribe(full, opts)
        for rmsg in self.broker.subscribe(self.clientid, full, opts,
                                          is_new_sub=is_new):
            # retained replay keeps the retain bit set [MQTT-3.3.1-8]
            retained_jobs.append((rmsg, SubOpts(
                qos=opts.qos, retain_as_published=True, subid=opts.subid,
            )))
        return granted

    def _handle_unsubscribe(self, pkt: C.Unsubscribe) -> None:
        m = self.broker.metrics
        m.inc("packets.unsubscribe.received")
        rcs: List[int] = []
        for flt in pkt.topic_filters:
            flt = self.broker.rewrite.rewrite_sub(flt)
            if flt.startswith(ExclusiveSub.PREFIX):
                flt = flt[len(ExclusiveSub.PREFIX):]
                self.broker.exclusive.release(self.clientid, flt)
            full = self._mount(flt) if not T.parse_share(flt) else flt
            self.broker.hooks.run("client.unsubscribe", self.client, flt)
            had = self.session.unsubscribe(full) is not None
            if had:
                self.broker.unsubscribe(self.clientid, full)
            rcs.append(RC_NORMAL if had else RC_NO_SUBSCRIPTION_EXISTED)
        m.inc("packets.unsuback.sent")
        self.send_packets(
            [C.Unsuback(packet_id=pkt.packet_id, reason_codes=rcs)]
        )

    # ---------------------------------------------------- disconnect

    def _handle_disconnect(self, pkt: C.Disconnect) -> None:
        self.broker.metrics.inc("packets.disconnect.received")
        if pkt.reason_code == RC_NORMAL:
            self.will_msg = None  # [MQTT-3.14.4-3]
        if self.version == C.MQTT_V5:
            expiry = pkt.properties.get("session_expiry_interval")
            if expiry is not None and self.session is not None:
                if self.session.expiry_interval == 0 and expiry > 0:
                    self._disconnect_with(RC_PROTOCOL_ERROR)
                    return
                self.session.expiry_interval = float(expiry)  # type: ignore[arg-type]
        self._shutdown("normal")

    def _disconnect_with(self, rc: int) -> None:
        if self.version == C.MQTT_V5 and self.state == CONNECTED:
            self.broker.metrics.inc("packets.disconnect.sent")
            self._send([C.Disconnect(reason_code=rc)])
        self._shutdown(f"rc_{rc:#04x}")

    # ------------------------------------------------------- timers

    def keepalive_expired(self, now: Optional[float] = None) -> bool:
        if self.keepalive <= 0 or self.state != CONNECTED:
            return False
        now = now if now is not None else time.time()
        mult = self.broker.config.mqtt.keepalive_multiplier
        return now - self.last_rx > self.keepalive * mult

    def retry_deliveries(self) -> None:
        if self.session is not None and self.state == CONNECTED:
            self.send_packets(self.session.retry())
            self.session.expire_awaiting_rel()
            wm = self.broker.config.mqtt.outbound_high_watermark
            if self.session.out_parked and (
                    not wm or self.out_buffered() < wm):
                # the buffer recovered, but the client may owe no ack
                # that would dequeue: flush the parked queue in order
                self.send_packets(self.session._dequeue())

    # ----------------------------------------------------- teardown

    def connection_lost(self, reason: str = "closed") -> None:
        """Socket gone (either direction): count the cycle toward the
        flapping ban, publish the will, update the connection manager,
        drop router state of a session that ends."""
        if self.state == DISCONNECTED and self.session is None:
            return
        self.state = DISCONNECTED
        if self._pending_connect is not None:
            self._pending_connect.cancel()
            self._pending_connect = None
        broker = self.broker
        if self.client is not None:
            broker.metrics.inc("client.disconnected")
            if broker.flapping.on_disconnect(self.clientid):
                broker.metrics.inc("client.flapping_banned")
                broker.alarms.activate(
                    f"flapping/{self.clientid}",
                    message="client banned for flapping",
                    ttl=broker.flapping.ban_time,
                )
            broker.hooks.run("client.disconnected", self.client, reason)
        if self.will_msg is not None:
            will, self.will_msg = self.will_msg, None
            delay = float(will.properties.pop("will_delay_interval", 0) or 0)
            expiry = self.session.expiry_interval if self.session else 0.0
            if delay > 0 and expiry > 0:
                # fire at min(delay, session expiry) unless the client
                # reconnects first ([MQTT-3.1.2-8], [MQTT-3.1.3.2.2])
                broker.schedule_will(self.clientid, will,
                                     min(delay, expiry))
            else:
                broker.publish(will)
        if self.session is not None and self.client is not None:
            broker.cm.disconnect(self.clientid, self)
            broker.channel_disconnected(self.clientid)
            if self.session.expiry_interval <= 0:
                broker.session_terminated(self.clientid, self.session)
                broker.hooks.run("session.terminated", self.clientid,
                                 reason)
            self.session = None
