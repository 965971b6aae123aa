"""The port's configuration against the JAX package's: ``from_dict`` /
``to_dict``, dotted-path ``get``/``update`` with handlers, the
unknown-key errors, the ``EMQX_TPU_*`` environment overrides and
`check_config`, over the sections the port has; the keys of sections
it has not ported (and ``engine.use_device``) raise, naming the key;
``main --check-config`` exits as the reference's does; the
``auto_subscribe`` filters and ``engine.rules_matrix`` act as in the
reference."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from emqx_tpu import config as RC
from emqx_tpu.broker.broker import Broker as RefBroker
from emqx_tpu.access import AclProvider as RefAclProvider
from emqx_tpu.access import AclRule as RefAclRule
from emqx_tpu.codec import mqtt as C

from emqx_tpu_torch import config as PCfg
from emqx_tpu_torch.access import AclProvider, AclRule
from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.message import Message
from emqx_tpu_torch.rules.engine import FunctionAction

from test_torch_broker import Pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one dict a case, each over sections both packages have
DICTS = [
    {},
    {"mqtt": {"max_inflight": 8, "max_qos_allowed": 1,
              "mqueue_priorities": {"a/b": 3}, "server_keepalive": 30,
              "outbound_high_watermark": 65536},
     "node_name": "n1@host"},
    {"listeners": [
        {"name": "t", "port": 0, "bind": "127.0.0.1"},
        {"name": "s", "type": "ssl", "port": 8883, "certfile": "c.pem",
         "keyfile": "k.pem", "cacertfile": "ca.pem", "verify": True,
         "crlfile": "ca.crl", "max_connections": 10},
        {"name": "w", "type": "ws", "port": 8083, "mountpoint": "ws/",
         "messages_rate": 5.0, "max_bytes_rate": 1e6, "reuse_port": True},
        {"name": "ws2", "type": "wss", "enable": False},
    ]},
    {"engine": {"batch_publish": False, "rules_matrix": False,
                "batch_max": 1024, "batch_window_ms": 2.5},
     "auth": {"allow_anonymous": False, "authz_default": "deny"},
     "retainer": {"max_retained_messages": 10},
     "sys": {"interval": 5.0}, "flapping": {"max_count": 3},
     "slow_subs": {"top_k": 3}, "profiler": {"ring_size": 16},
     "auto_subscribe": [{"topic": "inbox/%c", "qos": 1}]},
    {"sinks": [{"id": "web", "type": "http", "url": "http://h:8080/in",
                "method": "PUT", "headers": {"X-K": "v"}, "max_buffer": 5},
               {"id": "b", "url": "http://h/b"}]},
]


def _same_sections(ref: dict, port: dict) -> None:
    """Every key the port has equals the reference's; the only keys the
    reference has beyond them are the ``NOT_PORTED`` ones."""
    assert set(ref) - set(port) == {
        k for k in PCfg.NOT_PORTED if "." not in k}
    for key, val in port.items():
        if isinstance(val, dict):
            extra = set(ref[key]) - set(val)
            assert extra == {k.split(".")[1] for k in PCfg.NOT_PORTED
                             if k.startswith(key + ".")}
            assert {k: ref[key][k] for k in val} == val, key
        else:
            assert ref[key] == val, key


@pytest.mark.parametrize("case", range(len(DICTS)))
def test_from_dict_to_dict_equal_reference(case):
    d = DICTS[case]
    _same_sections(RC.ConfigHandler.from_dict(d).to_dict(),
                   PCfg.ConfigHandler.from_dict(d).to_dict())


def test_sections_ported_or_named_not_ported():
    """Each field of a ported section is the reference's, and each
    top-level key of the reference is either ported or in
    ``NOT_PORTED``."""
    def names(cls):
        return [f.name for f in dataclasses.fields(cls)]

    for cls in ("MqttConfig", "ListenerConfig", "AuthConfig",
                "SysConfig", "FlappingConfig", "SlowSubsConfig",
                "ProfilerConfig"):
        assert names(getattr(PCfg, cls)) == names(getattr(RC, cls)), cls
    assert names(PCfg.BrokerEngineConfig) == [
        n for n in names(RC.BrokerEngineConfig) if n != "use_device"]
    assert names(PCfg.RetainerConfig) == [
        n for n in names(RC.RetainerConfig) if n != "deliver_rate"]
    top = set(names(PCfg.BrokerConfig))
    assert top | {k for k in PCfg.NOT_PORTED if "." not in k} == set(
        names(RC.BrokerConfig))
    assert not top & set(PCfg.NOT_PORTED)


def test_get_update_and_handlers_equal_reference():
    seen = []
    for mod in (RC, PCfg):
        h = mod.ConfigHandler()
        calls = []
        h.add_handler("mqtt", lambda old, new: calls.append(("mqtt", old,
                                                             new)))

        def refuse(old, new):
            if new > 64:
                raise ValueError("too many")
            calls.append(("inflight", old, new))

        h.add_handler("mqtt.max_inflight", refuse)
        h.update("mqtt.max_inflight", 16)
        with pytest.raises(ValueError, match="too many"):
            h.update("mqtt.max_inflight", 100)
        h.update("mqtt.mqueue_priorities", {"x": 1})
        h.update("engine.batch_max", 512)
        seen.append((calls, h.get("mqtt.max_inflight"),
                     h.get("mqtt.mqueue_priorities"),
                     h.get("engine.batch_max"),
                     h.get("listeners")[0].port))
    assert seen[0] == seen[1]


@pytest.mark.parametrize("bad,exc", [
    ({"nope": 1}, ValueError),
    ({"mqtt": {"nope": 1}}, ValueError),
    ({"engine": {"batch_maxx": 1}}, ValueError),
    ({"listeners": [{"name": "x", "tls": True}]}, TypeError),
])
def test_unknown_keys_raise_like_reference(bad, exc):
    with pytest.raises(exc) as want:
        RC.ConfigHandler.from_dict(bad)
    with pytest.raises(exc) as got:
        PCfg.ConfigHandler.from_dict(bad)
    assert str(got.value) == str(want.value)


ENV = {
    "EMQX_TPU_MQTT__MAX_INFLIGHT": "64",
    "EMQX_TPU_MQTT__SERVER_KEEPALIVE": "30",
    "EMQX_TPU_MQTT__MQUEUE_PRIORITIES": '{"a/b": 3}',
    "EMQX_TPU_MQTT__OUTBOUND_HIGH_WATERMARK": "1048576",
    "EMQX_TPU_ENGINE__BATCH_WINDOW_MS": "2",
    "EMQX_TPU_ENGINE__RULES_MATRIX": "false",
    "EMQX_TPU_AUTH__AUTHZ_DEFAULT": "deny",
    "EMQX_TPU_RETAINER__ENABLE": "0",
    "EMQX_TPU_NODE_NAME": "edge@10.0.0.1",
    "EMQX_TPU_AUTO_SUBSCRIBE": '[{"topic": "in/%c"}]',
    "EMQXTPU_MQTT__MAX_INFLIGHT": "1",  # not the prefix
    "PATH": "/bin",
}


def test_env_overrides_equal_reference():
    applied, cfgs = [], []
    for mod in (RC, PCfg):
        cfg = mod.BrokerConfig()
        applied.append(mod.apply_env_overrides(cfg, environ=dict(ENV)))
        cfgs.append(mod.ConfigHandler(cfg))
    assert applied[0] == applied[1]
    assert len(applied[1]) == 10
    for path, _v in applied[1]:
        a, b = cfgs[0].get(path), cfgs[1].get(path)
        assert (a, type(a)) == (b, type(b)), path
    assert cfgs[1].get("engine.batch_window_ms") == 2.0
    assert cfgs[1].get("retainer.enable") is False


@pytest.mark.parametrize("env", [
    {"EMQX_TPU_MQTT__MAX_INFLIGHT": "lots"},
    {"EMQX_TPU_ENGINE__BATCH_MAX": "[1]"},
    {"EMQX_TPU_MQTT__NOPE": "1"},
    {"EMQX_TPU_NOPE__X": "1"},
    {"EMQX_TPU_LISTENERS__0__PORT": "1884"},
])
def test_env_override_errors_equal_reference(env):
    with pytest.raises(ValueError) as want:
        RC.apply_env_overrides(RC.BrokerConfig(), environ=dict(env))
    with pytest.raises(ValueError) as got:
        PCfg.apply_env_overrides(PCfg.BrokerConfig(), environ=dict(env))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", sorted(PCfg.ENV_RESERVED))
def test_reserved_env_switches_raise_naming_the_switch(name):
    """The JAX package's native and decide switches act on nothing here:
    setting one raises, naming it, where the reference skips it."""
    env = {name: "1", "EMQX_TPU_MQTT__MAX_INFLIGHT": "8"}
    assert RC.apply_env_overrides(RC.BrokerConfig(), environ=dict(env)) \
        == [("mqtt.max_inflight", 8)]
    with pytest.raises(ValueError, match=f"{name}: not ported"):
        PCfg.apply_env_overrides(PCfg.BrokerConfig(), environ=dict(env))


def _set(cfg, path, value):
    *owner, leaf = path.split(".")
    obj = cfg
    for part in owner:
        obj = obj[int(part)] if part.isdigit() else getattr(obj, part)
    setattr(obj, leaf, value)


@pytest.mark.parametrize("edits", [
    {},
    {"listeners.0.type": "udp"},
    {"listeners.0.type": "ssl"},
    {"listeners.0.type": "wss", "listeners.0.certfile": "c.pem"},
    {"listeners.0.port": 70000},
    {"listeners.0.port": -1, "listeners.0.type": "tcpx"},
    {"mqtt.max_qos_allowed": 3},
    {"mqtt.mqueue_default_priority": "middle"},
    {"mqtt.outbound_high_watermark": -1},
    {"mqtt.max_qos_allowed": 5, "mqtt.outbound_high_watermark": -4096},
])
def test_check_config_equal_reference(edits):
    got = []
    for mod in (RC, PCfg):
        cfg = mod.BrokerConfig()
        for path, value in edits.items():
            _set(cfg, path, value)
        got.append(mod.check_config(cfg))
    assert got[0] == got[1]
    assert len(got[1]) == (len(edits) if edits else 0) - (
        "listeners.0.certfile" in edits)


def test_quic_listener_is_refused():
    """The JAX package serves QUIC; the port refuses it in check_config
    and at construction, never skipping the listener silently."""
    from emqx_tpu_torch.broker.listener import BrokerServer

    cfg = PCfg.BrokerConfig(listeners=[PCfg.ListenerConfig(
        type="quic", certfile="c.pem", keyfile="k.pem")])
    assert PCfg.check_config(cfg) == [
        "listeners[0].type: quic is not ported to emqx_tpu_torch"]
    with pytest.raises(ValueError, match="quic is not ported"):
        BrokerServer(cfg, device="cpu")


@pytest.mark.parametrize("path", sorted(PCfg.NOT_PORTED))
def test_unported_keys_raise_naming_the_key(path):
    """From a file and from the environment alike."""
    d, value = {}, {"enable": True} if "." not in path else False
    *owner, leaf = path.split(".")
    node = d
    for part in owner:
        node = node.setdefault(part, {})
    node[leaf] = value
    with pytest.raises(ValueError, match=f"config key {path}: not ported"):
        PCfg.ConfigHandler.from_dict(d)
    env = {"EMQX_TPU_" + path.upper().replace(".", "__"): "1"}
    with pytest.raises(ValueError, match=f"config key {path}: not ported"):
        PCfg.apply_env_overrides(PCfg.BrokerConfig(), environ=env)


def _cli(module, *args):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("EMQX_TPU_")}
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen(
        [sys.executable, "-m", module, *args], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_main_check_config_exits_like_reference(tmp_path):
    """``--check-config`` on a good and a bad file: 0 and ``config ok``,
    or 1 and ``config error:`` lines, as the reference's ``main``; a bad
    file at boot exits 2, and a not-ported key is a config error."""
    good, bad, olp = (tmp_path / n for n in ("good.json", "bad.json",
                                            "olp.json"))
    good.write_text(json.dumps({"listeners": [
        {"name": "t", "port": 0}, {"name": "w", "type": "ws", "port": 0}],
        "mqtt": {"max_inflight": 16}}))
    bad.write_text(json.dumps({"listeners": [
        {"name": "s", "type": "ssl", "port": 0}],
        "mqtt": {"max_qos_allowed": 7}}))
    olp.write_text(json.dumps({"olp": {"enable": True}}))
    procs = {
        (mod, f.name): _cli(mod, "--config", str(f), "--check-config")
        for mod in ("emqx_tpu.broker", "emqx_tpu_torch.broker")
        for f in (good, bad)
    }
    procs["boot"] = _cli("emqx_tpu_torch.broker", "--device", "cpu",
                         "--config", str(bad))
    procs["olp"] = _cli("emqx_tpu_torch.broker", "--config", str(olp),
                        "--check-config")
    out = {}
    for k, p in procs.items():
        so, se = p.communicate(timeout=120)
        out[k] = (p.returncode, so, se)
    for f in ("good.json", "bad.json"):
        ref, port = out[("emqx_tpu.broker", f)], out[
            ("emqx_tpu_torch.broker", f)]
        assert ref[0] == port[0]
        want = [ln for ln in ref[2].splitlines() if
                ln.startswith("config error:")]
        assert [ln for ln in port[2].splitlines() if
                ln.startswith("config error:")] == want
    assert out[("emqx_tpu_torch.broker", "good.json")][:2] == (
        0, "config ok\n")
    rc, _so, se = out[("emqx_tpu_torch.broker", "bad.json")]
    assert rc == 1 and se.count("config error:") == 2, se
    assert out["boot"][0] == 2 and "config error:" in out["boot"][2]
    assert out["olp"][0] == 1
    assert "config error: config key olp: not ported" in out["olp"][2]


def test_auto_subscribe_equal_reference():
    """The JAX package's auto-subscribe case (``inbox/%c`` at QoS 1)
    with ``%u``, an invalid filter, a mountpoint and an ACL that refuses
    one filter: the same subscriptions and the same bytes."""
    ref, port = RefBroker(), Broker(device="cpu")
    entries = [{"topic": "inbox/%c", "qos": 1}, {"topic": "u/%u/#"},
               {"topic": "bad/#/x"}, {"topic": "secret/%c", "qos": 2}]
    for b, rule, prov in ((ref, RefAclRule, RefAclProvider),
                          (port, AclRule, AclProvider)):
        b.config.auto_subscribe = [dict(e) for e in entries]
        b.access.authz_sources.append(prov([
            rule("deny", "all", "subscribe", ["mp/secret/#"])]))
    dev = Pair(ref, port, C.MQTT_V5)
    dev.ref.ch.mountpoint = dev.port.ch.mountpoint = "mp/"
    dev.send(C.Connect(client_id="dev9", proto_ver=C.MQTT_V5,
                       username="alice", keepalive=30))
    dev.assert_same("connect")
    subs = [sorted(b.cm.lookup("dev9").subscriptions) for b in (ref, port)]
    assert subs[0] == subs[1] == ["mp/inbox/dev9", "mp/u/alice/#"]
    pub = Pair(ref, port, C.MQTT_V5)
    pub.send(C.Connect(client_id="p", proto_ver=C.MQTT_V5, keepalive=30))
    for k, topic in enumerate(("mp/inbox/dev9", "mp/u/alice/x",
                               "mp/secret/dev9")):
        pub.send(C.Publish(topic=topic, qos=1, payload=b"auto",
                           packet_id=k + 1))
        dev.auto_ack()
    for c in (dev, pub):
        c.assert_same("publishes")
    got = [p.topic for p in C.StreamParser(version=C.MQTT_V5).feed(
        b"".join(dev.port.writes)) if p.type == C.PUBLISH]
    assert got == ["mp/inbox/dev9", "mp/u/alice/x"]


def test_rules_matrix_false_pins_the_interpreter():
    """``engine.rules_matrix = False`` takes the per-rule interpreter,
    as ``eval_force = "scalar"`` does, with the same actions; the
    default takes the matrix."""
    outs = {}
    for how in ("default", "config", "force"):
        cfg = PCfg.BrokerConfig()
        cfg.engine.rules_matrix = how != "config"
        b = Broker(cfg, device="cpu")
        if how == "force":
            b.rules.eval_force = "scalar"
        fired = []
        b.rules.add_rule(
            "r", 'SELECT payload.v AS v FROM "t/#" WHERE payload.v > 1',
            actions=[FunctionAction(lambda sel, msg: fired.append(
                (msg.topic, sorted(sel.items()))))])
        b.publish_many([Message(topic=f"t/{i}", payload=b'{"v": %d}' % i)
                        for i in range(5)])
        st = b.rules.stats()
        outs[how] = (fired, st["matrix_windows"], st["scalar_windows"])
    assert outs["config"] == outs["force"] == (outs["default"][0], 0, 1)
    assert outs["default"][1:] == (1, 0)
    assert len(outs["default"][0]) == 3


_SINK_CASES = [
    [],
    [{"id": "a", "type": "http", "url": "http://h/p"}],
    [{"type": "http", "url": "http://h/p"}],
    [{"id": "a", "type": "http"}],
    [{"id": "a", "url": ""}],
    [{"id": "a", "type": "smtp"}, {"url": "http://h/q"}],
]


@pytest.mark.parametrize("sinks", _SINK_CASES)
def test_sinks_check_config_equal_reference(sinks):
    got = []
    for mod in (RC, PCfg):
        cfg = mod.BrokerConfig()
        cfg.sinks = json.loads(json.dumps(sinks))
        got.append(mod.check_config(cfg))
    assert got[0] == got[1]


def test_kafka_sink_is_not_ported():
    """The JAX package's kafka sink is refused by check_config (and by
    `BrokerServer.start`, tests/test_torch_sinks.py), never skipped."""
    sink = {"id": "k", "type": "kafka", "bootstrap": [["h", 9092]],
            "topic": "t"}
    ref = RC.BrokerConfig()
    ref.sinks = [sink]
    assert RC.check_config(ref) == []
    cfg = PCfg.ConfigHandler.from_dict({"sinks": [sink]}).root
    assert PCfg.check_config(cfg) == [
        "sinks[0].type: kafka is not ported to emqx_tpu_torch"]
    bad = PCfg.BrokerConfig()
    bad.sinks = ["http://h/p"]
    assert PCfg.check_config(bad) == ["sinks[0]: expected an object"]
    bad.sinks = {"id": "a"}
    assert PCfg.check_config(bad) == [
        "sinks: expected a list of sink objects"]


def test_sinks_from_a_file_and_the_environment(tmp_path):
    sinks = [{"id": "web", "type": "http", "url": "http://h/in",
              "max_buffer": 3}]
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"sinks": sinks}))
    assert PCfg.ConfigHandler.load(str(path)).root.sinks == sinks
    assert RC.ConfigHandler.load(str(path)).root.sinks == sinks
    env = {"EMQX_TPU_SINKS": json.dumps(sinks + [{"id": "x",
                                                   "url": "http://h/x"}])}
    got = []
    for mod in (RC, PCfg):
        cfg = mod.ConfigHandler.load(str(path)).root
        got.append((mod.apply_env_overrides(cfg, environ=dict(env)),
                    cfg.sinks))
    assert got[0] == got[1]
    assert [s["id"] for s in got[1][1]] == ["web", "x"]
    # the CLI's --check-config reads both and finds the kafka sink
    env = dict(os.environ, PYTHONPATH=REPO,
               EMQX_TPU_SINKS=json.dumps([{"id": "k", "type": "kafka"}]))
    proc = subprocess.run(
        [sys.executable, "-m", "emqx_tpu_torch.broker", "--config",
         str(path), "--check-config"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "sinks[0].type: kafka is not ported" in proc.stderr


# ------------------------------------------------------ the api section

def test_api_section_ported_like_reference():
    """``api`` is no longer refused: its fields and defaults are the
    reference's, and a config dict with it loads in both alike."""
    names = [f.name for f in dataclasses.fields(PCfg.ApiConfig)]
    assert names == [f.name for f in dataclasses.fields(RC.ApiConfig)]
    assert "api" not in PCfg.NOT_PORTED
    d = {"api": {"enable": True, "port": 18084, "bind": "0.0.0.0",
                 "data_dir": "d/m", "token_ttl": 60.0,
                 "prometheus_auth": True, "default_password": None}}
    _same_sections(RC.ConfigHandler.from_dict(d).to_dict(),
                   PCfg.ConfigHandler.from_dict(d).to_dict())
    assert dataclasses.asdict(PCfg.ApiConfig()) == \
        dataclasses.asdict(RC.ApiConfig())


def test_api_from_a_file_and_the_environment(tmp_path):
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"api": {"enable": False, "port": 1}}))
    env = {"EMQX_TPU_API__ENABLE": "true", "EMQX_TPU_API__PORT": "18099",
           "EMQX_TPU_API__DATA_DIR": str(tmp_path / "mgmt")}
    got = []
    for mod in (RC, PCfg):
        cfg = mod.ConfigHandler.load(str(path)).root
        applied = mod.apply_env_overrides(cfg, environ=dict(env))
        got.append((applied, dataclasses.asdict(cfg.api)))
    assert got[0] == got[1]
    assert got[1][1]["enable"] is True and got[1][1]["port"] == 18099


@pytest.mark.parametrize("source", ["file", "environment"])
def test_gcp_device_keys_ported_like_reference(tmp_path, source):
    """``gcp_device_enable`` and ``gcp_device_file`` are no longer
    refused: the reference's defaults, loaded from a file or the
    environment alike; enabled, the broker holds the registry (its
    directory made) and its authenticator leads the chain."""
    assert "gcp_device_enable" not in PCfg.NOT_PORTED
    assert "exhooks" not in PCfg.NOT_PORTED
    want = str(tmp_path / "gcp" / "devices.json")
    got = []
    for mod in (RC, PCfg):
        assert (mod.BrokerConfig().gcp_device_enable,
                mod.BrokerConfig().gcp_device_file) == (
                    False, "data/gcp_devices.json")
        if source == "file":
            path = tmp_path / "c.json"
            path.write_text(json.dumps({"gcp_device_enable": True,
                                        "gcp_device_file": want}))
            cfg = mod.ConfigHandler.load(str(path)).root
        else:
            cfg = mod.BrokerConfig()
            mod.apply_env_overrides(cfg, environ={
                "EMQX_TPU_GCP_DEVICE_ENABLE": "true",
                "EMQX_TPU_GCP_DEVICE_FILE": json.dumps(want)})
        got.append((cfg.gcp_device_enable, cfg.gcp_device_file))
    assert got[0] == got[1] == (True, want)
    b = Broker(cfg, device="cpu")  # the port's config, the last loaded
    assert os.path.isdir(str(tmp_path / "gcp"))
    assert b.gcp_devices.list_devices() == []
    assert type(b.access.authenticators[0]).__name__ == \
        "GcpDeviceAuthenticator"
    assert Broker(PCfg.BrokerConfig(), device="cpu").gcp_devices is None


@pytest.mark.parametrize("source", ["file", "environment"])
def test_exhooks_key_parses_and_starts_clients(tmp_path, source):
    """``exhooks`` is no longer refused: the list parses into
    ``BrokerConfig.exhooks`` as in the reference, from a file or the
    environment, and `BrokerServer.start` makes one `ExhookClient` an
    entry with its settings (an unreachable provider: not loaded, the
    verdict hooks failing closed), which `stop` removes."""
    import asyncio

    from emqx_tpu_torch.broker.listener import BrokerServer

    hooks = [{"name": "ext", "url": "127.0.0.1:1", "timeout": 0.5,
              "failure_action": "deny"},
             {"name": "open", "url": "http://127.0.0.1:1",
              "failure_action": "ignore"}]
    got = []
    for mod in (RC, PCfg):
        assert mod.BrokerConfig().exhooks == []
        if source == "file":
            path = tmp_path / "c.json"
            path.write_text(json.dumps({"exhooks": hooks}))
            cfg = mod.ConfigHandler.load(str(path)).root
        else:
            cfg = mod.BrokerConfig()
            mod.apply_env_overrides(cfg, environ={
                "EMQX_TPU_EXHOOKS": json.dumps(hooks)})
        got.append(cfg.exhooks)
    assert got[0] == got[1] == hooks
    cfg.listeners = [PCfg.ListenerConfig(bind="127.0.0.1", port=0)]
    cfg.sys.enable = False

    async def run():
        srv = BrokerServer(cfg, device="cpu")
        await srv.start()
        try:
            return [(c.name, c.url, c.timeout, c.failure_action, c.loaded,
                     sorted(n for n, _ in c._registered))
                    for c in srv.exhook_clients]
        finally:
            await srv.stop()
            assert srv.exhook_clients == []
            assert not srv.broker.hooks.has_async("message.publish")

    clients = asyncio.run(asyncio.wait_for(run(), 60))
    assert clients == [
        ("ext", "127.0.0.1:1", 0.5, "deny", False,
         ["client.authenticate", "client.authorize", "message.publish"]),
        ("open", "http://127.0.0.1:1", 5.0, "ignore", False, [])]


def test_put_configs_on_a_not_ported_path_gives_400(tmp_path):
    """``PUT /api/v5/configs`` on a path under ``NOT_PORTED`` answers
    400 naming the key (the reference applies it); a ported path is
    applied with its type coerced and the ``config.updated`` hook run."""
    import asyncio

    from test_torch_mgmt import LIMIT, _token, acall, port_server

    async def t():
        srv = port_server(str(tmp_path))
        seen = []
        srv.broker.hooks.add("config.updated",
                             lambda path, value: seen.append((path, value)))
        await srv.start()
        try:
            hdr = await _token(srv.api.port)
            out = {}
            for path, value in (("olp.enable", True),
                                ("engine.use_device", False),
                                ("retainer.deliver_rate", 5),
                                ("cluster.enable", True),
                                ("mqtt.retry_interval", 7)):
                st, _, body, _ = await acall(srv.api.port, "PUT",
                                             "/api/v5/configs",
                                             {"path": path,
                                              "value": value}, hdr)
                out[path] = (st, body)
            return out, seen, srv.broker.config.mqtt.retry_interval
        finally:
            await srv.stop()

    out, seen, retry = asyncio.run(asyncio.wait_for(t(), LIMIT))
    for path in ("olp.enable", "engine.use_device", "retainer.deliver_rate",
                 "cluster.enable"):
        st, body = out[path]
        key = path if path in PCfg.NOT_PORTED else path.split(".")[0]
        assert st == 400 and body["code"] == "BAD_REQUEST", path
        assert body["message"].startswith(
            f"config key {key}: not ported to emqx_tpu_torch"), body
    assert out["mqtt.retry_interval"] == (200, {"path":
                                                "mqtt.retry_interval"})
    assert retry == 7.0 and isinstance(retry, float)
    assert seen == [("mqtt.retry_interval", 7.0)]


def test_main_config_reaches_the_api(tmp_path):
    """``python -m emqx_tpu_torch.broker --config`` with ``api.enable``:
    the API's address line beside the listener's, and it logs in."""
    import http.client
    import queue
    import threading

    cfg = {"listeners": [{"name": "t", "bind": "127.0.0.1", "port": 0}],
           "api": {"enable": True, "port": 0,
                   "data_dir": str(tmp_path / "mgmt")}}
    path = tmp_path / "c.json"
    path.write_text(json.dumps(cfg))
    proc = _cli("emqx_tpu_torch.broker", "--config", str(path),
                "--device", "cpu")
    got: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [got.put(x) for x in proc.stdout],
                     daemon=True).start()
    try:
        lines = []
        while not any("management API" in x for x in lines):
            try:
                lines.append(got.get(timeout=60))
            except queue.Empty:
                break
        api = [x for x in lines if "management API listening" in x]
        assert api, (lines, proc.poll())
        assert any("listener t (tcp) listening on 127.0.0.1:" in x
                   for x in lines)
        port = int(api[0].rsplit(":", 1)[1])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("POST", "/api/v5/login", body=json.dumps(
            {"username": "admin", "password": "public"}))
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read())["token"]
    finally:
        proc.terminate()
        proc.communicate(timeout=30)
