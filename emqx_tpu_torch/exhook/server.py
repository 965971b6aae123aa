"""HookProvider gRPC server backed by the broker's engine.

The graft: a stock EMQX configures this endpoint as an exhook provider
and its hook chain rides the port's MatchEngine, RuleEngine and auth
chains.  EMQX's bridge direction in reverse: where
`emqx_exhook_handler:on_message_publish` forwards EMQX hooks to a gRPC
server, this is that server.  A port of the JAX package's server on
the port's own gRPC stack (`grpc_util.Server`):

  * OnMessagePublish: runs the local 'message.publish' fold chain and
    the SQL rule engine over the message (its rule hits come from one
    `Router.match_batch` call, a match kernel launch on the card); a
    dropped message returns STOP_AND_RETURN with allow_publish=false, a
    mutated one returns CONTINUE with the new payload/topic/qos.
  * OnClientAuthenticate / OnClientAuthorize: run the local authn/authz
    chains and answer with bool_result.
  * every other hook notifies the local hookpoint of the same name, so
    rules/metrics/extensions observe the external broker's events.

A handler that raises (a device error in the match included) answers
INTERNAL "handler failure" and is logged; nothing falls back to a host
match.  Handlers run on the server's worker threads.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from .. import grpc_util

from ..access import PUBLISH, SUBSCRIBE, ClientInfo
from ..message import Message
from . import pb

log = logging.getLogger("emqx_tpu_torch.exhook")

SERVICE = "emqx.exhook.v2.HookProvider"

# hook names the provider registers by default (HookSpec inventory,
# exhook.proto HookSpec comment)
ALL_HOOKS = [
    "client.connect",
    "client.connack",
    "client.connected",
    "client.disconnected",
    "client.authenticate",
    "client.authorize",
    "client.subscribe",
    "client.unsubscribe",
    "session.created",
    "session.subscribed",
    "session.unsubscribed",
    "session.resumed",
    "session.discarded",
    "session.takenover",
    "session.terminated",
    "message.publish",
    "message.delivered",
    "message.acked",
    "message.dropped",
]


def _to_message(m: "pb.Message") -> Message:
    return Message(
        topic=m.topic,
        payload=bytes(m.payload),
        qos=m.qos,
        from_client=getattr(m, "from"),
        from_username=m.headers.get("username") or None,
        timestamp=(m.timestamp or 0) / 1000.0,
    )


def _from_message(msg: Message, node: str, mid: str) -> "pb.Message":
    out = pb.Message(
        node=node,
        id=mid,
        qos=msg.qos,
        topic=msg.topic,
        payload=bytes(msg.payload),
        timestamp=int(msg.timestamp * 1000),
    )
    setattr(out, "from", msg.from_client or "")
    if msg.from_username:
        out.headers["username"] = msg.from_username
    return out


def _clientinfo(ci: "pb.ClientInfo") -> ClientInfo:
    return ClientInfo(
        clientid=ci.clientid,
        username=ci.username or None,
        password=(ci.password or "").encode() or None,
        peerhost=ci.peerhost,
        mountpoint=ci.mountpoint or None,
        is_superuser=ci.is_superuser,
    )


class ExhookServer:
    """Serves HookProvider for external EMQX nodes.

    ``broker`` supplies hooks/rules/access/metrics; omitted, a
    standalone Broker (no listeners) is created on ``device`` ("cuda"
    unless the caller asks for "cpu"), so the graft can run as a pure
    sidecar process.
    """

    def __init__(
        self,
        broker=None,
        bind: str = "127.0.0.1:0",
        hooks: Optional[list] = None,
        message_topics: Optional[list] = None,
        max_workers: int = 8,
        device="cuda",
    ) -> None:
        if broker is None:
            from ..broker.broker import Broker

            broker = Broker(device=device)
        self.broker = broker
        self.bind = bind
        self.hooks = list(hooks if hooks is not None else ALL_HOOKS)
        self.message_topics = list(message_topics or ["#"])
        self._grpc = grpc_util.Server(max_workers=max_workers)
        self._grpc.add_service(SERVICE, self._handlers())
        self.port = self._grpc.add_insecure_port(bind)
        self._started_at = time.time()

    # ------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._grpc.start()
        log.info("exhook HookProvider serving on port %d", self.port)

    def stop(self, grace: float = 0.5) -> None:
        """Stop serving and close every connection accepted."""
        self._grpc.stop(grace).wait()

    # -------------------------------------------------------- handlers

    def _handlers(self):
        def unary(fn, req_cls, resp_cls):
            def call(request, context):
                try:
                    return fn(request)
                except Exception:
                    log.exception("exhook handler %s failed", fn.__name__)
                    context.abort(
                        grpc_util.StatusCode.INTERNAL, "handler failure"
                    )

            return (call, req_cls.FromString,
                    lambda m: m.SerializeToString())

        E = pb.EmptySuccess
        V = pb.ValuedResponse
        return {
            "OnProviderLoaded": unary(
                self.on_provider_loaded,
                pb.ProviderLoadedRequest,
                pb.LoadedResponse,
            ),
            "OnProviderUnloaded": unary(
                self.on_provider_unloaded, pb.ProviderUnloadedRequest, E
            ),
            "OnClientConnect": unary(
                self._notify("client.connect", "conninfo"),
                pb.ClientConnectRequest,
                E,
            ),
            "OnClientConnack": unary(
                self._notify("client.connack", "conninfo"),
                pb.ClientConnackRequest,
                E,
            ),
            "OnClientConnected": unary(
                self._notify("client.connected", "clientinfo"),
                pb.ClientConnectedRequest,
                E,
            ),
            "OnClientDisconnected": unary(
                self._notify("client.disconnected", "clientinfo", "reason"),
                pb.ClientDisconnectedRequest,
                E,
            ),
            "OnClientAuthenticate": unary(
                self.on_client_authenticate, pb.ClientAuthenticateRequest, V
            ),
            "OnClientAuthorize": unary(
                self.on_client_authorize, pb.ClientAuthorizeRequest, V
            ),
            "OnClientSubscribe": unary(
                self._notify("client.subscribe", "clientinfo"),
                pb.ClientSubscribeRequest,
                E,
            ),
            "OnClientUnsubscribe": unary(
                self._notify("client.unsubscribe", "clientinfo"),
                pb.ClientUnsubscribeRequest,
                E,
            ),
            "OnSessionCreated": unary(
                self._notify("session.created", "clientinfo"),
                pb.SessionCreatedRequest,
                E,
            ),
            "OnSessionSubscribed": unary(
                self._notify("session.subscribed", "clientinfo", "topic"),
                pb.SessionSubscribedRequest,
                E,
            ),
            "OnSessionUnsubscribed": unary(
                self._notify("session.unsubscribed", "clientinfo", "topic"),
                pb.SessionUnsubscribedRequest,
                E,
            ),
            "OnSessionResumed": unary(
                self._notify("session.resumed", "clientinfo"),
                pb.SessionResumedRequest,
                E,
            ),
            "OnSessionDiscarded": unary(
                self._notify("session.discarded", "clientinfo"),
                pb.SessionDiscardedRequest,
                E,
            ),
            "OnSessionTakenover": unary(
                self._notify("session.takenover", "clientinfo"),
                pb.SessionTakenoverRequest,
                E,
            ),
            "OnSessionTerminated": unary(
                self._notify("session.terminated", "clientinfo", "reason"),
                pb.SessionTerminatedRequest,
                E,
            ),
            "OnMessagePublish": unary(
                self.on_message_publish, pb.MessagePublishRequest, V
            ),
            "OnMessageDelivered": unary(
                self._notify("message.delivered", "clientinfo", "message"),
                pb.MessageDeliveredRequest,
                E,
            ),
            "OnMessageDropped": unary(
                self._notify("message.dropped", "message", "reason"),
                pb.MessageDroppedRequest,
                E,
            ),
            "OnMessageAcked": unary(
                self._notify("message.acked", "clientinfo", "message"),
                pb.MessageAckedRequest,
                E,
            ),
        }

    # -------------------------------------------------------- provider

    def on_provider_loaded(self, req) -> "pb.LoadedResponse":
        self.broker.metrics.inc("exhook.provider.loaded")
        log.info(
            "provider loaded by %s (%s)",
            req.broker.version,
            req.meta.cluster_name or req.meta.node,
        )
        hooks = []
        for name in self.hooks:
            spec = pb.HookSpec(name=name)
            if name.startswith("message."):
                spec.topics.extend(self.message_topics)
            hooks.append(spec)
        return pb.LoadedResponse(hooks=hooks)

    def on_provider_unloaded(self, req) -> "pb.EmptySuccess":
        self.broker.metrics.inc("exhook.provider.unloaded")
        return pb.EmptySuccess()

    # -------------------------------------------------------- verdicts

    def on_message_publish(self, req) -> "pb.ValuedResponse":
        self.broker.metrics.inc("exhook.message.publish")
        msg = _to_message(req.message)
        out = self.broker.hooks.run_fold("message.publish", (), msg)
        if out is None:
            # hook chain dropped it: tell the external broker not to
            # publish (allow_publish=false is EMQX's stop form)
            stopped = pb.Message()
            stopped.CopyFrom(req.message)
            stopped.headers["allow_publish"] = "false"
            return pb.ValuedResponse(
                type=pb.ValuedResponse.STOP_AND_RETURN, message=stopped
            )
        # rule hits ride the same match step class as local publishes
        matched = self.broker.router.match_batch([out.topic])[0]
        rule_ids = sorted(
            {f[1] for f in matched if isinstance(f, tuple)}
        )
        if rule_ids:
            self.broker.rules.apply(out, rule_ids)
        # compare against the WIRE message: a hook may mutate in place
        # and return the same object
        changed = (
            out.topic != req.message.topic
            or out.payload != bytes(req.message.payload)
            or out.qos != req.message.qos
        )
        if changed:
            resp = _from_message(
                out, req.meta.node or "emqx_tpu", req.message.id
            )
            return pb.ValuedResponse(
                type=pb.ValuedResponse.CONTINUE, message=resp
            )
        return pb.ValuedResponse(type=pb.ValuedResponse.IGNORE)

    def on_client_authenticate(self, req) -> "pb.ValuedResponse":
        self.broker.metrics.inc("exhook.client.authenticate")
        ok, _ = self.broker.access.authenticate(_clientinfo(req.clientinfo))
        return pb.ValuedResponse(
            type=pb.ValuedResponse.STOP_AND_RETURN, bool_result=ok
        )

    def on_client_authorize(self, req) -> "pb.ValuedResponse":
        self.broker.metrics.inc("exhook.client.authorize")
        action = (
            PUBLISH
            if req.type == pb.ClientAuthorizeRequest.PUBLISH
            else SUBSCRIBE
        )
        ok = self.broker.access.authorize(
            _clientinfo(req.clientinfo), action, req.topic
        )
        return pb.ValuedResponse(
            type=pb.ValuedResponse.STOP_AND_RETURN, bool_result=ok
        )

    # ---------------------------------------------------- notify hooks

    def _notify(self, hookpoint: str, *fields):
        def handler(req):
            self.broker.metrics.inc(f"exhook.{hookpoint}")
            args = []
            for f in fields:
                v = getattr(req, f, None)
                if f == "clientinfo" and v is not None:
                    args.append(v.clientid)
                elif f == "message" and v is not None:
                    args.append(_to_message(v))
                else:
                    args.append(v)
            self.broker.hooks.run(hookpoint, *args)
            return pb.EmptySuccess()

        handler.__name__ = f"notify_{hookpoint}"
        return handler
