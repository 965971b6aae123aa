"""The port's hook registry against the JAX package's: the same random
sequences of ``add`` (with priorities and ties), ``delete``, ``run``,
``run_fold`` and ``run_fold_async`` over callbacks that continue, stop,
stop with a value or replace the accumulator give the same call order
and the same results."""

import asyncio
import random

import pytest

from emqx_tpu import hooks as ref_hooks

from emqx_tpu_torch import hooks as port_hooks

NAMES = ("message.publish", "client.authorize", "session.created")
# what a callback returns: pass, replace, STOP, STOP_WITH(value)
KINDS = ("none", "replace", "stop", "stop_with")


def _callback(H, log, tag, kind, is_async):
    def fn(*args):
        log.append((tag, args))
        if kind == "replace":
            return f"{args[-1]}>{tag}"
        if kind == "stop":
            return H.STOP
        if kind == "stop_with":
            return H.STOP_WITH(f"w{tag}")
        return None

    if not is_async:
        return fn

    async def afn(*args):
        await asyncio.sleep(0)
        return fn(*args)

    return H.with_async(fn, afn)


def _script(seed, n_ops=120):
    rng = random.Random(seed)
    ops, tags = [], []
    for k in range(n_ops):
        r = rng.random()
        name = rng.choice(NAMES)
        if r < 0.45 or not tags:
            tag = f"c{k}"
            tags.append((name, tag))
            ops.append(("add", name, tag, rng.choice(KINDS),
                        rng.choice((-5, 0, 0, 5, 100)), rng.random() < 0.3))
        elif r < 0.55:
            ops.append(("delete", *tags.pop(rng.randrange(len(tags)))))
        elif r < 0.75:
            ops.append(("run", name, f"a{k}"))
        elif r < 0.9:
            ops.append(("fold", name, f"acc{k}"))
        else:
            ops.append(("fold_async", name, f"acc{k}"))
    return ops


def _play(H, ops):
    reg = H.HookRegistry()
    log, out, fns = [], [], {}
    for op in ops:
        if op[0] == "add":
            _, name, tag, kind, prio, is_async = op
            fns[tag] = _callback(H, log, tag, kind, is_async)
            reg.add(name, fns[tag], priority=prio)
        elif op[0] == "delete":
            _, name, tag = op
            out.append(("delete", reg.delete(name, fns[tag])))
        elif op[0] == "run":
            reg.run(op[1], op[2])
            out.append(("run", len(log)))
        elif op[0] == "fold":
            out.append(("fold", reg.run_fold(op[1], ("x",), op[2])))
        else:
            out.append(("fold_async", asyncio.run(
                reg.run_fold_async(op[1], ("x",), op[2]))))
        out.append(tuple((n, reg.has(n), reg.has_async(n)) for n in NAMES))
    return log, out


@pytest.mark.parametrize("seed", range(6))
def test_random_call_sequences_equal_reference(seed):
    ops = _script(seed)
    assert _play(port_hooks, ops) == _play(ref_hooks, ops)


def test_priority_order_ties_and_stop():
    """Higher priority first, ties in the order added; STOP ends a
    notify chain, STOP keeps and STOP_WITH replaces a fold's value."""
    for H in (port_hooks, ref_hooks):
        reg = H.HookRegistry()
        seen = []
        reg.add("h", lambda acc: seen.append("low") or acc + "L", 1)
        reg.add("h", lambda acc: seen.append("tie1") or acc + "1", 5)
        reg.add("h", lambda acc: seen.append("tie2") or acc + "2", 5)
        reg.add("h", lambda acc: seen.append("high") or acc + "H", 9)
        assert reg.run_fold("h", (), "") == "H12L"
        assert seen == ["high", "tie1", "tie2", "low"]
        reg.add("h", lambda acc: H.STOP, 6)
        assert reg.run_fold("h", (), "a") == "aH"
        reg.add("h", lambda acc: H.STOP_WITH(None), 7)
        assert reg.run_fold("h", (), "a") is None
        calls = []
        reg.add("n", lambda: calls.append(1) or H.STOP, 2)
        reg.add("n", lambda: calls.append(2), 1)
        reg.run("n")
        assert calls == [1]
        assert [cb.priority for cb in reg.callbacks("h")] == [
            9, 7, 6, 5, 5, 1]
        assert repr(H.STOP) == "STOP"
        assert repr(H.STOP_WITH(3)) == "STOP_WITH(3)"


def _norm(x):
    """A hook argument in a form both packages share."""
    if isinstance(x, (str, int, float, bool, type(None), bytes)):
        return x
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    for attrs in (("topic", "payload", "qos"), ("clientid", "username"),
                  ("client_id",), ("qos", "no_local", "subid")):
        if all(hasattr(x, a) for a in attrs):
            return (type(x).__name__,) + tuple(
                _norm(getattr(x, a)) for a in attrs)
    return type(x).__name__


@pytest.mark.parametrize("native", [True, False])
def test_broker_hook_calls_equal_reference(native):
    """Every hookpoint recorded on both brokers through the same
    scripted session (connects, a takeover, subscribes with options,
    publishes with a no-subscriber drop, acks, an unsubscribe, a clean
    and a persistent disconnect): the same calls in the same order with
    the same arguments."""
    from emqx_tpu.broker.broker import Broker as RefBroker
    from emqx_tpu.codec import mqtt as C

    from emqx_tpu_torch.broker.broker import Broker

    from test_torch_broker import Pair

    ref, port = RefBroker(), Broker(device="cpu", native=native)
    logs = ([], [])
    for b, log in zip((ref, port), logs):
        for name in ref_hooks.HOOKPOINTS:
            if name == "message.publish":
                continue  # a fold: its recorder must pass the message on
            b.hooks.add(name, lambda *a, name=name, log=log: log.append(
                (name, _norm(list(a)))))
        b.hooks.add("message.publish", lambda msg, log=log: log.append(
            ("message.publish", _norm(msg))))
    sub = Pair(ref, port, C.MQTT_V5)
    sub.send(C.Connect(client_id="s", proto_ver=5, clean_start=False,
                       properties={"session_expiry_interval": 60}))
    sub.send(C.Subscribe(packet_id=1, subscriptions=[
        C.Subscription(topic_filter="t/#", qos=1),
        C.Subscription(topic_filter="u/+", qos=0, no_local=True)]))
    pub = Pair(ref, port, C.MQTT_V5)
    pub.send(C.Connect(client_id="p", proto_ver=5))
    for k, topic in enumerate(("t/a", "u/b", "none", "t/c")):
        pub.send(C.Publish(topic=topic, qos=1, payload=b"%d" % k,
                           packet_id=k + 1))
        while sub.auto_ack() + pub.auto_ack():
            pass
    sub.send(C.Unsubscribe(packet_id=2, topic_filters=["u/+"]))
    again = Pair(ref, port, C.MQTT_V5)  # takes the persistent session
    again.send(C.Connect(client_id="s", proto_ver=5, clean_start=False,
                         properties={"session_expiry_interval": 60}))
    pub.send(C.Disconnect())
    for w in (pub.ref, pub.port):
        w.ch.connection_lost("normal")
    for c in (sub, pub, again):
        c.assert_same(c.port.ch.clientid or "closed")
    assert logs[0] == logs[1]
    names = {n for n, _ in logs[1]}
    assert names >= {"client.connect", "client.connected",
                     "client.authenticate", "client.authorize",
                     "client.subscribe", "client.unsubscribe",
                     "client.disconnected", "session.created",
                     "session.subscribed", "session.unsubscribed",
                     "session.resumed", "session.terminated",
                     "message.publish", "message.delivered",
                     "message.acked", "message.dropped"}
