"""Channel: the per-connection MQTT protocol state machine.

Handles CONNECT/CONNACK, SUBSCRIBE/SUBACK (``$share/`` and
``$exclusive/`` filters, retained replay after the SUBACK),
UNSUBSCRIBE/UNSUBACK, PUBLISH at QoS 0/1/2 with PUBACK,
PUBREC/PUBREL/PUBCOMP in both directions, PINGREQ and DISCONNECT, on
MQTT 3.1.1 and 5.0.  Every client is allowed (no authentication or
authorization yet).  Pure
state machine: the owning `Connection` feeds parsed packets in and
gets packets out through ``send``.
"""

from __future__ import annotations

import secrets
import time
from typing import Dict, List, Optional, Tuple

from .. import topic as T
from ..codec import mqtt as C
from ..message import Message
from ..modules import ExclusiveSub
from .broker import Broker
from .session import Session, SubOpts

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
_V3_CONNACK = {RC_BAD_CLIENTID: 2}


class Channel:
    def __init__(self, broker: Broker, send, close, peer: str = "") -> None:
        self.broker = broker
        self._send = send
        self._close = close
        self.state = CONNECTING
        self.version = C.MQTT_V5
        self.clientid: Optional[str] = None
        self.session: Optional[Session] = None
        self.keepalive = 0.0
        self.peer = peer
        self.will_msg: Optional[Message] = None
        self._alias_in: Dict[int, str] = {}
        self.last_rx = time.time()
        self._closing = False
        # write coalescing: while corked (a dispatch window), outgoing
        # packets buffer and flush as ONE write on uncork
        self._cork_depth = 0
        self._cork_buf: List[C.Packet] = []

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

    def send_packets(self, packets: List[C.Packet]) -> None:
        if packets and not self._closing:
            m = self.broker.metrics
            for p in packets:
                if p.type == C.PUBLISH:
                    m[f"messages.qos{p.qos}.sent"] += 1
            if self._cork_depth:
                self._cork_buf.extend(packets)
                return
            self._send(packets)

    def send_wire(self, data, npub: Tuple[int, int, int]) -> bool:
        """One pre-assembled delivery run (the native window path): the
        per-QoS sent counters `send_packets` bumps, then ONE `Raw` blob
        into the corked buffer.  Returns False when the channel is
        closing and the blob was dropped."""
        if self._closing:
            return False
        m = self.broker.metrics
        for q in (0, 1, 2):
            if npub[q]:
                m[f"messages.qos{q}.sent"] += npub[q]
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
        self._close(reason)

    # ------------------------------------------------------ incoming

    def handle_in(self, pkt: C.Packet) -> None:
        """One parsed packet from the wire."""
        self.last_rx = time.time()
        m = self.broker.metrics
        m.inc("packets.received")
        if self.state == CONNECTING:
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
            ok, out = self.session.puback(pkt.packet_id)
            if ok:
                m.inc("messages.acked")
            self.send_packets(out)
        elif t == C.PUBREC:
            _ok, out = self.session.pubrec(pkt.packet_id)
            self.send_packets(out)
        elif t == C.PUBREL:
            found = self.session.pubrel(pkt.packet_id)
            self.send_packets(
                [C.Pubcomp(packet_id=pkt.packet_id,
                           reason_code=0 if found else 0x92)]
            )
        elif t == C.PUBCOMP:
            ok, out = self.session.pubcomp(pkt.packet_id)
            if ok:
                m.inc("messages.acked")
            self.send_packets(out)
        elif t == C.SUBSCRIBE:
            self._handle_subscribe(pkt)
        elif t == C.UNSUBSCRIBE:
            self._handle_unsubscribe(pkt)
        elif t == C.PINGREQ:
            self.send_packets([C.Pingresp()])
        elif t == C.DISCONNECT:
            self._handle_disconnect(pkt)
        elif t == C.AUTH:
            self._disconnect_with(RC_PROTOCOL_ERROR)  # no enhanced auth
        else:
            self._shutdown("protocol_error")

    # ------------------------------------------------------- connect

    def _handle_connect(self, pkt: C.Connect) -> None:
        self.version = pkt.proto_ver
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
        self.clientid = clientid
        expiry = float(
            pkt.properties.get("session_expiry_interval", 0)
            if self.version == C.MQTT_V5
            else (0 if pkt.clean_start else mqtt.session_expiry_interval)
        )
        receive_max = pkt.properties.get("receive_maximum")
        session, present = self.broker.cm.open_session(
            pkt.clean_start,
            clientid,
            self,
            expiry_interval=expiry,
            max_inflight=min(
                mqtt.max_inflight, receive_max or mqtt.max_inflight
            ),
        )
        self.session = session
        self.broker.cancel_will(clientid)  # reconnect cancels a delayed will
        if present:
            # re-register subscriptions in case the router was cleaned
            for flt, opts in session.subscriptions.items():
                self.broker.router.subscribe(clientid, flt, opts)
        if pkt.will is not None:
            self.will_msg = Message(
                topic=pkt.will.topic,
                payload=pkt.will.payload,
                qos=min(pkt.will.qos, mqtt.max_qos_allowed),
                retain=pkt.will.retain,
                from_client=clientid,
                from_username=pkt.username,
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
        self.broker.metrics.inc("client.connected")
        self.send_packets(
            [C.Connack(session_present=present, reason_code=0,
                       properties=props)]
        )
        if present:
            self.send_packets(session.resume())

    def _connack_error(self, rc: int) -> None:
        code = rc if self.version == C.MQTT_V5 else _V3_CONNACK.get(rc, 3)
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
        m = self.broker.metrics
        m.inc(f"messages.qos{pkt.qos}.received")
        topic = (self._resolve_alias(pkt) if self.version == C.MQTT_V5
                 else pkt.topic)
        if topic is None:
            self._disconnect_with(RC_TOPIC_ALIAS_INVALID)
            return
        try:
            T.validate_name(topic)
        except ValueError:
            self._disconnect_with(RC_TOPIC_NAME_INVALID)
            return
        mqtt = self.broker.config.mqtt
        if pkt.qos > mqtt.max_qos_allowed:
            self._disconnect_with(0x9B)  # QoS not supported
            return
        if pkt.retain and not mqtt.retain_available:
            self._disconnect_with(0x9A)  # retain not supported
            return
        props = {
            k: v for k, v in pkt.properties.items() if k != "topic_alias"
        }
        msg = Message(
            topic=topic,
            payload=pkt.payload,
            qos=pkt.qos,
            retain=pkt.retain,
            from_client=self.clientid,
            properties=props,
        )
        batcher = self.broker.batcher
        if pkt.qos == 0:
            if batcher is not None:
                batcher.publish_nowait(msg)
            else:
                self.broker.publish(msg)
            return
        if pkt.qos == 2:
            # route immediately, dedup on packet id until PUBREL
            st = self.session.awaiting_rel_add(pkt.packet_id)
            if st == "in_use":
                self.send_packets(
                    [C.Pubrec(packet_id=pkt.packet_id, reason_code=0)]
                )
                return
            if st == "full":
                m.inc("messages.dropped")
                self._disconnect_with(RC_RECEIVE_MAX_EXCEEDED)
                return
        if batcher is not None:
            # the ack resolves from the window's future
            batcher.publish(msg).add_done_callback(
                lambda f, pid=pkt.packet_id, q=pkt.qos:
                    self._publish_acked(pid, q, f)
            )
        else:
            self._send_pub_ack(pkt.packet_id, pkt.qos,
                               self.broker.publish(msg))

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
        rc = (
            RC_NO_MATCHING_SUBSCRIBERS
            if (n == 0 and self.version == C.MQTT_V5)
            else 0
        )
        ack = C.Puback if qos == 1 else C.Pubrec
        self.send_packets([ack(packet_id=packet_id, reason_code=rc)])

    # ----------------------------------------------------- subscribe

    def _handle_subscribe(self, pkt: C.Subscribe) -> None:
        """SUBACK first, then the granted filters' retained messages,
        through the session (inflight window, then mqueue), in one
        write."""
        subid = pkt.properties.get("subscription_identifier")
        if isinstance(subid, list):
            subid = subid[0] if subid else None
        retained_jobs: List[Tuple[Message, SubOpts]] = []
        rcs = [self._do_subscribe(sub, subid, retained_jobs)
               for sub in pkt.subscriptions]
        if self.version != C.MQTT_V5:
            rcs = [rc if rc <= 2 else 0x80 for rc in rcs]
        self.send_packets([C.Suback(packet_id=pkt.packet_id,
                                    reason_codes=rcs)])
        if retained_jobs:
            self.send_packets(self.session.deliver(retained_jobs))

    def _do_subscribe(
        self, sub: C.Subscription, subid: Optional[int],
        retained_jobs: List[Tuple[Message, SubOpts]],
    ) -> int:
        mqtt = self.broker.config.mqtt
        flt = sub.topic_filter
        try:
            T.validate_filter(flt)
        except ValueError:
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
        if exclusive and not self.broker.exclusive.acquire(
            self.clientid, flt
        ):
            return RC_QUOTA_EXCEEDED  # already held by another client
        is_new = self.session.subscribe(flt, opts)
        for rmsg in self.broker.subscribe(self.clientid, flt, opts,
                                          is_new_sub=is_new):
            # retained replay keeps the retain bit set [MQTT-3.3.1-8]
            retained_jobs.append((rmsg, SubOpts(
                qos=opts.qos, retain_as_published=True, subid=opts.subid,
            )))
        return granted

    def _handle_unsubscribe(self, pkt: C.Unsubscribe) -> None:
        rcs: List[int] = []
        for flt in pkt.topic_filters:
            if flt.startswith(ExclusiveSub.PREFIX):
                flt = flt[len(ExclusiveSub.PREFIX):]
                self.broker.exclusive.release(self.clientid, flt)
            had = self.session.unsubscribe(flt) is not None
            if had:
                self.broker.unsubscribe(self.clientid, flt)
            rcs.append(RC_NORMAL if had else RC_NO_SUBSCRIPTION_EXISTED)
        self.send_packets(
            [C.Unsuback(packet_id=pkt.packet_id, reason_codes=rcs)]
        )

    # ---------------------------------------------------- disconnect

    def _handle_disconnect(self, pkt: C.Disconnect) -> None:
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

    # ----------------------------------------------------- teardown

    def connection_lost(self, reason: str = "closed") -> None:
        """Socket gone (either direction): publish the will, update the
        connection manager, drop router state of a session that ends."""
        if self.state == DISCONNECTED and self.session is None:
            return
        self.state = DISCONNECTED
        if self.will_msg is not None:
            will, self.will_msg = self.will_msg, None
            delay = float(will.properties.pop("will_delay_interval", 0) or 0)
            expiry = self.session.expiry_interval if self.session else 0.0
            if delay > 0 and expiry > 0:
                # fire at min(delay, session expiry) unless the client
                # reconnects first ([MQTT-3.1.2-8], [MQTT-3.1.3.2.2])
                self.broker.schedule_will(
                    self.clientid, will, min(delay, expiry)
                )
            else:
                self.broker.publish(will)
        if self.session is not None and self.clientid is not None:
            self.broker.cm.disconnect(self.clientid, self)
            if self.session.expiry_interval <= 0:
                self.broker.session_terminated(self.clientid, self.session)
            self.session = None
