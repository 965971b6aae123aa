"""The port's `ExhookServer` against the JAX package's: the cases of
``tests/test_exhook.py``, each request sent by one grpcio client to both
servers (the JAX package's on grpcio, the port's on its own gRPC stack,
``device="cpu"``), over equal brokers; the responses, decoded by the
same ``google.protobuf`` classes, must be equal, and so must what each
broker saw."""

import grpc
import pytest

from emqx_tpu.access import DictAuthenticator as RefDictAuthenticator
from emqx_tpu.broker.broker import Broker as RefBroker
from emqx_tpu.config import BrokerConfig as RefConfig
from emqx_tpu.exhook import pb as ref_pb
from emqx_tpu.exhook.server import ExhookServer as RefServer
from emqx_tpu.hooks import STOP_WITH as REF_STOP_WITH
from emqx_tpu.rules.engine import FunctionAction as RefFunctionAction

from emqx_tpu_torch.access import DictAuthenticator
from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.exhook import pb as port_pb
from emqx_tpu_torch.exhook.server import ALL_HOOKS, SERVICE, ExhookServer
from emqx_tpu_torch.hooks import STOP_WITH
from emqx_tpu_torch.rules.engine import FunctionAction

SIDES = {
    "ref": dict(STOP_WITH=REF_STOP_WITH, FunctionAction=RefFunctionAction,
                DictAuthenticator=RefDictAuthenticator),
    "port": dict(STOP_WITH=STOP_WITH, FunctionAction=FunctionAction,
                 DictAuthenticator=DictAuthenticator),
}


class Served:
    """Both servers, each with its broker, and one grpcio channel to
    each."""

    def __init__(self):
        self.brokers = {"ref": RefBroker(RefConfig()),
                        "port": Broker(device="cpu")}
        self.servers = {
            "ref": RefServer(broker=self.brokers["ref"], bind="127.0.0.1:0"),
            "port": ExhookServer(broker=self.brokers["port"],
                                 bind="127.0.0.1:0")}
        self.chans = {}
        for side, srv in self.servers.items():
            srv.start()
            self.chans[side] = grpc.insecure_channel(f"127.0.0.1:{srv.port}")

    def rpc(self, method, req, resp_cls):
        """``req`` to both servers: their responses, equal."""
        out = {}
        for side, ch in self.chans.items():
            fn = ch.unary_unary(
                f"/{SERVICE}/{method}",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=resp_cls.FromString)
            out[side] = fn(req, timeout=10)
        assert out["port"] == out["ref"], (method, out)
        return out["port"]

    def close(self):
        for ch in self.chans.values():
            ch.close()
        for srv in self.servers.values():
            srv.stop()


@pytest.fixture()
def served():
    s = Served()
    yield s
    s.close()
    assert s.servers["port"]._grpc.connections == []


def metric(served, name):
    vals = {side: b.metrics.val(name) if side == "ref" else b.metrics[name]
            for side, b in served.brokers.items()}
    assert vals["port"] == vals["ref"], (name, vals)
    return vals["port"]


def test_provider_loaded_lists_hooks(served):
    resp = served.rpc(
        "OnProviderLoaded",
        ref_pb.ProviderLoadedRequest(
            broker=ref_pb.BrokerInfo(version="5.8.0"),
            meta=ref_pb.RequestMeta(node="emqx@remote", cluster_name="cl1")),
        ref_pb.LoadedResponse)
    assert [h.name for h in resp.hooks] == ALL_HOOKS
    pub = next(h for h in resp.hooks if h.name == "message.publish")
    assert list(pub.topics) == ["#"]
    assert metric(served, "exhook.provider.loaded") == 1
    served.rpc("OnProviderUnloaded", ref_pb.ProviderUnloadedRequest(),
               ref_pb.EmptySuccess)
    assert metric(served, "exhook.provider.unloaded") == 1


def test_message_publish_verdicts(served):
    for side, b in served.brokers.items():
        stop_with = SIDES[side]["STOP_WITH"]

        def gate(msg, stop_with=stop_with):
            if msg.topic.startswith("secret/"):
                return stop_with(None)
            if msg.topic == "rewrite/me":
                msg.topic = "rewritten/you"
            if msg.topic == "upper/me":
                msg.payload = msg.payload.upper()
            return msg

        b.hooks.add("message.publish", gate)

    def publish(topic, payload=b"x", **kw):
        return served.rpc(
            "OnMessagePublish",
            ref_pb.MessagePublishRequest(
                message=ref_pb.Message(topic=topic, payload=payload, qos=1,
                                       id="m1", **kw),
                meta=ref_pb.RequestMeta(node="emqx@remote")),
            ref_pb.ValuedResponse)

    assert publish("plain/topic").type == ref_pb.ValuedResponse.IGNORE
    dropped = publish("secret/launch-codes", headers={"username": "u"})
    assert dropped.type == ref_pb.ValuedResponse.STOP_AND_RETURN
    assert dropped.message.headers["allow_publish"] == "false"
    moved = publish("rewrite/me", **{"from": "dev-7"})
    assert moved.type == ref_pb.ValuedResponse.CONTINUE
    assert moved.message.topic == "rewritten/you"
    assert getattr(moved.message, "from") == "dev-7"
    up = publish("upper/me", b"quiet", headers={"username": "ann"})
    assert up.message.payload == b"QUIET"
    assert up.message.headers["username"] == "ann"
    assert metric(served, "exhook.message.publish") == 4


def test_message_publish_runs_rules(served):
    hits = {"ref": [], "port": []}
    for side, b in served.brokers.items():
        b.rules.add_rule(
            "r1",
            'SELECT payload.v AS v FROM "metrics/#" WHERE payload.v > 10',
            actions=[SIDES[side]["FunctionAction"](
                fn=lambda sel, msg, side=side: hits[side].append(sel["v"]))])
    for v, topic in ((5, "metrics/a"), (42, "metrics/b"), (9, "other/c"),
                     (77, "metrics/c/d")):
        served.rpc(
            "OnMessagePublish",
            ref_pb.MessagePublishRequest(
                message=ref_pb.Message(topic=topic,
                                       payload=b'{"v": %d}' % v)),
            ref_pb.ValuedResponse)
    assert hits["port"] == hits["ref"] == [42, 77]


def test_authenticate_and_authorize(served):
    for side, b in served.brokers.items():
        b.access.allow_anonymous = False
        authn = SIDES[side]["DictAuthenticator"]()
        authn.add_user("alice", "wonder")
        b.access.authenticators.append(authn)

    def auth(clientid, username, password):
        return served.rpc(
            "OnClientAuthenticate",
            ref_pb.ClientAuthenticateRequest(
                clientinfo=ref_pb.ClientInfo(
                    clientid=clientid, username=username,
                    password=password)),
            ref_pb.ValuedResponse)

    assert auth("c1", "alice", "wonder").bool_result is True
    assert auth("c1", "alice", "nope").bool_result is False
    assert auth("c2", "mallory", "x").bool_result is False
    ok = auth("c3", "", "")
    assert ok.WhichOneof("value") == "bool_result" and not ok.bool_result
    for typ in (ref_pb.ClientAuthorizeRequest.PUBLISH,
                ref_pb.ClientAuthorizeRequest.SUBSCRIBE):
        resp = served.rpc(
            "OnClientAuthorize",
            ref_pb.ClientAuthorizeRequest(
                clientinfo=ref_pb.ClientInfo(clientid="c1",
                                             username="alice"),
                type=typ, topic="t/1"),
            ref_pb.ValuedResponse)
        assert resp.bool_result is True  # default authz allow
    assert metric(served, "exhook.client.authenticate") == 4
    assert metric(served, "exhook.client.authorize") == 2


NOTIFIES = [
    ("OnClientConnect", "client.connect", "ClientConnectRequest",
     dict(conninfo=dict(clientid="d1", username="u"))),
    ("OnClientConnack", "client.connack", "ClientConnackRequest",
     dict(conninfo=dict(clientid="d1"), result_code="success")),
    ("OnClientConnected", "client.connected", "ClientConnectedRequest",
     dict(clientinfo=dict(clientid="d1"))),
    ("OnClientDisconnected", "client.disconnected",
     "ClientDisconnectedRequest",
     dict(clientinfo=dict(clientid="d1"), reason="normal")),
    ("OnClientSubscribe", "client.subscribe", "ClientSubscribeRequest",
     dict(clientinfo=dict(clientid="d1"),
          topic_filters=[dict(name="a/#", subopts=dict(qos=1))])),
    ("OnClientUnsubscribe", "client.unsubscribe",
     "ClientUnsubscribeRequest",
     dict(clientinfo=dict(clientid="d1"), topic_filters=[dict(name="a/#")])),
    ("OnSessionCreated", "session.created", "SessionCreatedRequest",
     dict(clientinfo=dict(clientid="d1"))),
    ("OnSessionSubscribed", "session.subscribed", "SessionSubscribedRequest",
     dict(clientinfo=dict(clientid="dev-1"), topic="fleet/+/pos",
          subopts=dict(qos=1))),
    ("OnSessionUnsubscribed", "session.unsubscribed",
     "SessionUnsubscribedRequest",
     dict(clientinfo=dict(clientid="dev-1"), topic="fleet/+/pos")),
    ("OnSessionResumed", "session.resumed", "SessionResumedRequest",
     dict(clientinfo=dict(clientid="d1"))),
    ("OnSessionDiscarded", "session.discarded", "SessionDiscardedRequest",
     dict(clientinfo=dict(clientid="d1"))),
    ("OnSessionTakenover", "session.takenover", "SessionTakenoverRequest",
     dict(clientinfo=dict(clientid="d1"))),
    ("OnSessionTerminated", "session.terminated",
     "SessionTerminatedRequest",
     dict(clientinfo=dict(clientid="d1"), reason="takenover")),
    ("OnMessageDelivered", "message.delivered", "MessageDeliveredRequest",
     dict(clientinfo=dict(clientid="d2"),
          message=dict(topic="t/1", payload=b"p", qos=1,
                       headers={"username": "u"}))),
    ("OnMessageDropped", "message.dropped", "MessageDroppedRequest",
     dict(message=dict(topic="t/2", payload=b"q"), reason="no_subscribers")),
    ("OnMessageAcked", "message.acked", "MessageAckedRequest",
     dict(clientinfo=dict(clientid="d3"),
          message=dict(topic="t/3", payload=b"r", timestamp=1700000000123))),
]


def _plain(args):
    """A hook's arguments, comparable across the packages: messages as
    (topic, payload, qos, from, username, timestamp), protobuf messages
    as their bytes."""
    out = []
    for a in args:
        if hasattr(a, "SerializeToString"):
            out.append(("pb", a.SerializeToString()))
        elif hasattr(a, "topic") and hasattr(a, "payload"):
            out.append((a.topic, a.payload, a.qos, a.from_client,
                        a.from_username, a.timestamp))
        else:
            out.append(a)
    return tuple(out)


def test_connect_notifies_fail_in_the_reference_through_its_trace_hook(
        served):
    """A fault of the JAX package, not copied: its trace module's
    ``client.connected``/``client.disconnected`` callbacks (on every
    broker) read ``.clientid`` of the client id string the exhook server
    passes, so those two RPCs answer INTERNAL there.  The port has no
    trace module (ROADMAP item 8): the same requests succeed."""
    for method, hook, req_name, kw in NOTIFIES[2:4]:
        req = getattr(ref_pb, req_name)(**kw)
        out = {}
        for side, ch in served.chans.items():
            fn = ch.unary_unary(
                f"/{SERVICE}/{method}",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=ref_pb.EmptySuccess.FromString)
            try:
                fn(req, timeout=10)
                out[side] = "ok"
            except grpc.RpcError as exc:
                out[side] = exc.code().name
        assert out == {"ref": "INTERNAL", "port": "ok"}, method


def test_notification_hooks_fan_into_local_chain(served):
    seen = {"ref": [], "port": []}
    ref = served.brokers["ref"]
    for name in ("client.connected", "client.disconnected"):
        # the JAX package's own trace callbacks (see the test above)
        for cb in ref.hooks.callbacks(name):
            ref.hooks.delete(name, cb)
    for side, b in served.brokers.items():
        for _, hook, _, _ in NOTIFIES:
            b.hooks.add(hook, lambda *a, side=side, hook=hook: seen[
                side].append((hook, _plain(a))))
    for method, hook, req_name, kw in NOTIFIES:
        served.rpc(method, getattr(ref_pb, req_name)(**kw),
                   ref_pb.EmptySuccess)
        assert metric(served, f"exhook.{hook}") == 1
    assert seen["port"] == seen["ref"]
    assert ("session.subscribed", ("dev-1", "fleet/+/pos")) in seen["port"]
    assert len(seen["port"]) == len(NOTIFIES)


def test_handler_failure_is_internal(served):
    """A hook that raises inside a handler: INTERNAL "handler failure"
    from both servers (a device error in the match takes this path
    too), and each server goes on serving."""
    for b in served.brokers.values():
        def bad(msg):
            raise RuntimeError("hook fault")

        b.hooks.add("message.publish", bad)
    codes = {}
    for side, ch in served.chans.items():
        fn = ch.unary_unary(
            f"/{SERVICE}/OnMessagePublish",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=ref_pb.ValuedResponse.FromString)
        with pytest.raises(grpc.RpcError) as err:
            fn(ref_pb.MessagePublishRequest(
                message=ref_pb.Message(topic="a")), timeout=10)
        codes[side] = (err.value.code(), err.value.details())
    assert codes["port"] == codes["ref"] == (grpc.StatusCode.INTERNAL,
                                             "handler failure")
    served.rpc("OnProviderUnloaded", ref_pb.ProviderUnloadedRequest(),
               ref_pb.EmptySuccess)


def test_port_client_to_port_server_round_trip():
    """The port's own client against the port's server: the same
    answers the grpcio client gets."""
    from emqx_tpu_torch import grpc_util as G

    srv = ExhookServer(device="cpu")
    srv.start()
    ch = G.Channel(f"127.0.0.1:{srv.port}")
    try:
        fn = ch.unary_unary(f"/{SERVICE}/OnMessagePublish",
                            request_serializer=lambda m: m.SerializeToString(),
                            response_deserializer=port_pb.ValuedResponse
                            .FromString)
        resp = fn(port_pb.MessagePublishRequest(
            message=port_pb.Message(topic="x/y", payload=b"z")), timeout=10)
        assert resp.type == port_pb.ValuedResponse.IGNORE
        assert srv.broker.router.engine.device.type == "cpu"
    finally:
        ch.close()
        srv.stop()
    assert srv._grpc.connections == []
