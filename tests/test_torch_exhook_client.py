"""The port's `ExhookClient` against the JAX package's: the cases of
``tests/test_exhook_client.py``, the same grpcio stub provider (the
reference's ``StubProvider`` shape) driving both packages' clients on
equal brokers (the port's ``device="cpu"``).  Equal: the verdicts, the
provider's recorded requests (decoded, without message ids, timestamps,
the uptime and the cluster name), the breaker's stats, the
fail-closed-then-recover path, the loop staying live under a slow
provider, the batcher's async prepare; and through a `BrokerServer`
configured with ``exhooks`` (`workload.exhook_world`, the port's
provider fixture on the port's own gRPC server), every client's bytes."""

import asyncio
import json
import threading
import time
from concurrent import futures
from types import SimpleNamespace

import grpc
import pytest
from google.protobuf import json_format

from emqx_tpu import access as ref_access
from emqx_tpu import config as RC
from emqx_tpu.broker import session as ref_session
from emqx_tpu.broker.broker import Broker as RefBroker
from emqx_tpu.broker.broker import PublishBatcher as RefBatcher
from emqx_tpu.broker.listener import BrokerServer as RefServer
from emqx_tpu.exhook import pb
from emqx_tpu.exhook.client import ExhookClient as RefClient
from emqx_tpu.message import Message as RefMessage
from tests_fakes import FakeChannel as RefFakeChannel

from emqx_tpu_torch import access as port_access
from emqx_tpu_torch import grpc_util as G
from emqx_tpu_torch import workload as W
from emqx_tpu_torch.broker import session as port_session
from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.broker.broker import PublishBatcher
from emqx_tpu_torch.codec import mqtt as C
from emqx_tpu_torch.exhook.client import SERVICE, ExhookClient
from emqx_tpu_torch.message import Message


class PortFakeChannel(RefFakeChannel):
    version = C.MQTT_V5

    def cork(self):
        pass

    def uncork(self):
        pass


SIDE = {
    "ref": SimpleNamespace(
        Broker=lambda: RefBroker(RC.BrokerConfig()), Client=RefClient,
        Message=RefMessage, access=ref_access, SubOpts=ref_session.SubOpts,
        FakeChannel=RefFakeChannel, Batcher=RefBatcher,
        dead=lambda: grpc.insecure_channel("127.0.0.1:1"),
        live=lambda port: grpc.insecure_channel(f"127.0.0.1:{port}")),
    "port": SimpleNamespace(
        Broker=lambda: Broker(device="cpu", native=False),
        Client=ExhookClient, Message=Message, access=port_access,
        SubOpts=port_session.SubOpts, FakeChannel=PortFakeChannel,
        Batcher=PublishBatcher,
        dead=lambda: G.Channel("127.0.0.1:1"),
        live=lambda port: G.Channel(f"127.0.0.1:{port}")),
}


class StubProvider:
    """A HookProvider on grpcio: wants message.publish, auth and
    session.created; rewrites payloads, denies user 'mallory', drops
    topic 'secret/x', refuses topics under 'forbidden/'."""

    def __init__(self):
        self.hooks = ["message.publish", "client.authenticate",
                      "client.authorize", "session.created"]
        self.seen = []
        self.lock = threading.Lock()
        self.delay = 0.0

    def _record(self, name, req):
        with self.lock:
            self.seen.append((name, req))

    def handlers(self):
        def unary(fn, req_cls):
            return grpc.unary_unary_rpc_method_handler(
                fn, request_deserializer=req_cls.FromString,
                response_serializer=lambda m: m.SerializeToString())

        def loaded(req, ctx):
            self._record("loaded", req)
            return pb.LoadedResponse(hooks=[pb.HookSpec(name=n, topics=["#"])
                                            for n in self.hooks])

        def unloaded(req, ctx):
            self._record("unloaded", req)
            return pb.EmptySuccess()

        def on_publish(req, ctx):
            self._record("publish", req)
            if self.delay:
                time.sleep(self.delay)
            m = req.message
            out = pb.Message()
            out.CopyFrom(m)
            if m.topic == "secret/x":
                out.headers["allow_publish"] = "false"
                return pb.ValuedResponse(
                    type=pb.ValuedResponse.STOP_AND_RETURN, message=out)
            out.payload = m.payload + b"!ext"
            return pb.ValuedResponse(type=pb.ValuedResponse.CONTINUE,
                                     message=out)

        def on_auth(req, ctx):
            self._record("auth", req)
            return pb.ValuedResponse(
                type=pb.ValuedResponse.STOP_AND_RETURN,
                bool_result=req.clientinfo.username != "mallory")

        def on_authz(req, ctx):
            self._record("authz", req)
            if self.delay:
                time.sleep(self.delay)
            return pb.ValuedResponse(
                type=pb.ValuedResponse.STOP_AND_RETURN,
                bool_result=not req.topic.startswith("forbidden/"))

        def created(req, ctx):
            self._record("session.created", req)
            return pb.EmptySuccess()

        return {
            "OnProviderLoaded": unary(loaded, pb.ProviderLoadedRequest),
            "OnProviderUnloaded": unary(unloaded, pb.ProviderUnloadedRequest),
            "OnMessagePublish": unary(on_publish, pb.MessagePublishRequest),
            "OnClientAuthenticate": unary(on_auth,
                                          pb.ClientAuthenticateRequest),
            "OnClientAuthorize": unary(on_authz, pb.ClientAuthorizeRequest),
            "OnSessionCreated": unary(created, pb.SessionCreatedRequest),
        }

    def decoded(self):
        """The recorded requests, by name, without what differs run to
        run or by package."""
        out = []
        with self.lock:
            seen = list(self.seen)
        for name, req in seen:
            d = json_format.MessageToDict(req,
                                          preserving_proto_field_name=True)
            d.get("message", {}).pop("id", None)
            d.get("message", {}).pop("timestamp", None)
            d.get("broker", {}).pop("uptime", None)
            d.get("meta", {}).pop("cluster_name", None)
            out.append((name, json.dumps(d, sort_keys=True)))
        return out


@pytest.fixture()
def provider():
    stub = StubProvider()
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        SERVICE, stub.handlers()),))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    yield stub, port
    server.stop(0)


def make_client(side, port, **kw):
    s = SIDE[side]
    broker = s.Broker()
    client = s.Client(broker, "test", f"127.0.0.1:{port}", timeout=3.0, **kw)
    client.start()
    return broker, client


def attach(side, broker, cid, flt):
    s = SIDE[side]
    ch = s.FakeChannel()
    broker.cm.open_session(True, cid, ch)
    broker.subscribe(cid, flt, s.SubOpts(qos=0))
    return ch


def wait_recorded(stub, name, n=1):
    """Until the provider has recorded ``n`` requests called ``name``
    (a notification is sent from the client's pool)."""
    deadline = time.time() + 10
    while time.time() < deadline:
        with stub.lock:
            if sum(1 for k, _ in stub.seen if k == name) >= n:
                return
        time.sleep(0.005)
    raise AssertionError(f"{name} never recorded")


def both(stub, fn):
    """``fn(side)`` for the JAX package, then the port, the provider's
    record cleared between: the two results and records (sorted),
    equal."""
    out = {}
    for side in ("ref", "port"):
        with stub.lock:
            stub.seen.clear()
        res = fn(side)
        # notifications arrive from the client's pool: in any order
        out[side] = (res, sorted(stub.decoded()))
    assert out["port"] == out["ref"]
    return out["port"]


def test_publish_mutation_round_trip(provider):
    stub, port = provider

    def run(side):
        M = SIDE[side].Message
        broker, client = make_client(side, port)
        try:
            regs = [n for n, _ in client._registered]
            ch = attach(side, broker, "c1", "t/#")
            broker.publish(M(topic="t/1", payload=b"hi", qos=0))
            broker.subscribe("c1", "secret/#", SIDE[side].SubOpts(qos=0))
            broker.publish(M(topic="secret/x", payload=b"s", qos=0))
            broker.publish(M(topic="$SYS/x", payload=b"s", qos=0, sys=True))
        finally:
            client.stop()
        return sorted(regs), [(p.topic, p.payload) for p in ch.sent]

    (regs, sent), seen = both(stub, run)
    assert sent == [("t/1", b"hi!ext")]
    assert [n for n, _ in seen] == ["loaded", "publish", "publish",
                                    "session.created", "unloaded"]


def test_auth_verdicts(provider):
    stub, port = provider

    def run(side):
        a = SIDE[side].access
        broker, client = make_client(side, port)
        try:
            return [broker.access.authenticate(
                        a.ClientInfo(clientid="a", username="alice"))[0],
                    broker.access.authenticate(
                        a.ClientInfo(clientid="m", username="mallory"))[0],
                    broker.access.authorize(a.ClientInfo(clientid="a"),
                                            a.PUBLISH, "ok/t"),
                    broker.access.authorize(a.ClientInfo(clientid="a"),
                                            a.SUBSCRIBE, "forbidden/t")]
        finally:
            client.stop()

    verdicts, _ = both(stub, run)
    assert verdicts == [True, False, True, False]


def test_notify_hooks_fire(provider):
    stub, port = provider

    def run(side):
        broker, client = make_client(side, port)
        try:
            broker.hooks.run("session.created", "some-client")
            deadline = time.time() + 5
            while time.time() < deadline and not any(
                    n == "session.created" for n, _ in stub.seen):
                time.sleep(0.01)
        finally:
            client.stop()
        return client.stats

    stats, seen = both(stub, run)
    assert ("session.created" in [n for n, _ in seen])


def test_failure_policy_and_breaker(provider):
    stub, port = provider

    def run(side):
        s = SIDE[side]
        out = []
        broker, client = make_client(side, port, failure_action="deny",
                                     breaker_threshold=2,
                                     breaker_window=0.3)
        ch = attach(side, broker, "c1", "t/#")
        wait_recorded(stub, "session.created")
        try:
            client._channel.close()
            client._channel = s.dead()
            client._methods.clear()
            broker.publish(s.Message(topic="t/1", payload=b"x", qos=0))
            out.append(list(ch.sent))
            out.append(broker.access.authenticate(
                s.access.ClientInfo(clientid="a"))[0])
            before = client.stats["calls"]
            broker.publish(s.Message(topic="t/2", payload=b"x", qos=0))
            out.append((client.stats["calls"] == before, dict(client.stats),
                        client.info()["breaker_open"]))
        finally:
            client.stop()
        broker2, client2 = make_client(side, port, failure_action="ignore")
        ch2 = attach(side, broker2, "c1", "t/#")
        wait_recorded(stub, "session.created", 2)
        try:
            client2._channel.close()
            client2._channel = s.dead()
            client2._methods.clear()
            broker2.publish(s.Message(topic="t/1", payload=b"y", qos=0))
            out.append([p.payload for p in ch2.sent])
            out.append(broker2.access.authenticate(
                s.access.ClientInfo(clientid="a"))[0])
        finally:
            client2.stop()
        return out

    out, _ = both(stub, run)
    assert out[0] == [] and out[1] is False
    assert out[2] == (True, {"calls": 2, "failures": 2, "fast_failed": 1},
                      True)
    assert out[3] == [b"y"] and out[4] is True


def test_unreachable_provider_fails_closed_then_recovers(provider):
    stub, port = provider

    def run(side):
        s = SIDE[side]
        out = []
        broker = s.Broker()
        client = s.Client(broker, "t", "127.0.0.1:1", timeout=0.5,
                          failure_action="deny")
        client.start()
        out.append(client.loaded)
        ch = attach(side, broker, "c1", "t/#")
        broker.publish(s.Message(topic="t/1", payload=b"x", qos=0))
        out.append(list(ch.sent))
        out.append(broker.access.authenticate(
            s.access.ClientInfo(clientid="a"))[0])
        client._channel.close()
        client._channel = s.live(port)
        client._methods.clear()
        client.retry()
        out.append(client.loaded)
        broker.publish(s.Message(topic="t/2", payload=b"hi", qos=0))
        out.append([p.payload for p in ch.sent])
        client.stop()
        broker2 = s.Broker()
        client2 = s.Client(broker2, "t2", "127.0.0.1:1", timeout=0.5,
                           failure_action="ignore")
        client2.start()
        ch2 = attach(side, broker2, "c1", "t/#")
        broker2.publish(s.Message(topic="t/1", payload=b"y", qos=0))
        out.append([p.payload for p in ch2.sent])
        client2.stop()
        return out

    out, _ = both(stub, run)
    assert out == [False, [], False, True, [b"hi!ext"], [b"y"]]


def test_async_verdicts_keep_loop_live(provider):
    stub, port = provider

    def run(side):
        s = SIDE[side]
        broker, client = make_client(side, port)
        try:
            flags = (broker.hooks.has_async("message.publish"),
                     broker.access.has_async_authz_hooks,
                     broker.access.has_async_authn)
            stub.delay = 0.3

            async def main():
                ticks = 0

                async def ticker():
                    nonlocal ticks
                    while True:
                        ticks += 1
                        await asyncio.sleep(0.01)

                t = asyncio.create_task(ticker())
                out = await broker.hooks.run_fold_async(
                    "message.publish", (),
                    s.Message(topic="t/1", payload=b"x", qos=0))
                allowed = await broker.access.authorize_async(
                    s.access.ClientInfo(clientid="a"), s.access.PUBLISH,
                    "ok/t")
                denied = await broker.access.authorize_async(
                    s.access.ClientInfo(clientid="a"), s.access.PUBLISH,
                    "forbidden/t")
                t.cancel()
                return ticks, out.payload, allowed, denied

            ticks, payload, allowed, denied = asyncio.run(
                asyncio.wait_for(main(), 30))
        finally:
            stub.delay = 0.0
            client.stop()
        # three 0.3 s round trips: a blocked loop ticks 0-1 times
        return flags, ticks >= 4, payload, allowed, denied

    res, _ = both(stub, run)
    assert res == ((True, True, True), True, b"x!ext", True, False)


def test_batcher_prepare_uses_async_hook_path(provider):
    stub, port = provider

    def run(side):
        s = SIDE[side]
        broker, client = make_client(side, port)
        ch = attach(side, broker, "c1", "t/#")
        try:
            stub.delay = 0.2

            async def main():
                batcher = s.Batcher(broker, window=0.001)
                await batcher.start()
                ticks = 0

                async def ticker():
                    nonlocal ticks
                    while True:
                        ticks += 1
                        await asyncio.sleep(0.01)

                t = asyncio.create_task(ticker())
                n = await asyncio.wait_for(batcher.publish(
                    s.Message(topic="t/1", payload=b"e", qos=1)), 10)
                many = await asyncio.wait_for(asyncio.gather(*(
                    batcher.publish(s.Message(topic=f"t/{k}", qos=1,
                                              payload=b"%d" % k))
                    for k in range(6))), 10)
                t.cancel()
                await batcher.stop()
                return ticks, n, many

            ticks, n, many = asyncio.run(asyncio.wait_for(main(), 30))
        finally:
            stub.delay = 0.0
            client.stop()
        return (n, many, sorted((p.topic, p.payload) for p in ch.sent),
                ticks >= 3)

    res, _ = both(stub, run)
    assert res[0] == 1 and res[1] == [1] * 6 and res[3] is True
    assert (("t/1", b"e!ext") in res[2]) and len(res[2]) == 7


def _ref_impl():
    def server(cfg):
        cfg.engine.use_device = False
        return RefServer(cfg)

    return SimpleNamespace(config=RC, server=server)


def test_exhook_world_equals_reference_through_broker_servers():
    """`workload.exhook_world`: the port's provider fixture (on the
    port's own gRPC server) in front of each package's `BrokerServer`,
    dialled through its ``exhooks`` config; every client's bytes, the
    CONNACK and PUBACK codes, the provider's requests and the metrics
    equal."""
    script = W.exhook_script(5, n_clients=16, n_msgs=48)
    ref = W.exhook_world("cpu", script, n_filters=2000, impl=_ref_impl())
    port = W.exhook_world("cpu", script, n_filters=2000)
    for key in ("connacks", "pubacks", "bytes", "requests", "counts",
                "metrics"):
        assert port[key] == ref[key], key
    assert port["connacks"].count(0x86) == 2
    assert 0x87 in port["pubacks"] and 0x10 in port["pubacks"]
    assert port["counts"]["OnMessagePublish"] == sum(
        1 for _, t, _ in script["pubs"] if not t.startswith("deny/"))


def test_exhooks_config_dials_retries_and_stops():
    """A `BrokerServer` whose provider is down at start fails closed,
    and its housekeeping loads the provider once it is up; `stop` sends
    OnProviderUnloaded."""
    from emqx_tpu_torch import config as PCfg
    from emqx_tpu_torch.broker.listener import BrokerServer

    fixture = W.ExhookProviderFixture(W.exhook_verdicts(1))
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    async def run():
        cfg = PCfg.BrokerConfig(listeners=[PCfg.ListenerConfig(
            bind="127.0.0.1", port=0)])
        cfg.sys.enable = False
        cfg.exhooks = [{"name": "late", "url": f"127.0.0.1:{port}",
                        "timeout": 2.0}]
        srv = BrokerServer(cfg, device="cpu")
        await srv.start()
        try:
            client = srv.exhook_clients[0]
            assert not client.loaded and client.failure_action == "deny"
            cl = W.TransportClient(srv.listeners[0].port, "c1",
                                   username="u-1", password=b"p")
            await cl.connect(rc=0x86)  # fail closed: no provider
            await cl.eof()
            fixture._srv.add_insecure_port(f"127.0.0.1:{port}")
            fixture._srv.start()
            fixture.port = port
            for _ in range(300):  # the 1 Hz housekeeping retries
                if client.loaded:
                    break
                await asyncio.sleep(0.02)
            assert client.loaded
            cl = W.TransportClient(srv.listeners[0].port, "c2",
                                   username="u-2", password=b"p")
            await cl.connect(rc=0)
            await cl.close()
        finally:
            await srv.stop()
        assert srv.exhook_clients == []

    try:
        asyncio.run(asyncio.wait_for(run(), 60))
    finally:
        fixture.stop()
    assert fixture.counts["OnProviderLoaded"] == 1
    assert fixture.counts["OnProviderUnloaded"] == 1
    assert fixture._srv.connections == []
