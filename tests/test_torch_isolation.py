"""The port stands alone: importing it loads neither JAX nor anything
of the JAX package, and its entry points run on the card by default —
without CUDA they raise instead of dropping to the CPU."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import sys
import emqx_tpu_torch
import emqx_tpu_torch.engine
import emqx_tpu_torch.state
import emqx_tpu_torch.tp
import emqx_tpu_torch.router
import emqx_tpu_torch.broker.broker
import emqx_tpu_torch.broker.channel
import emqx_tpu_torch.broker.shared
import emqx_tpu_torch.retainer
import emqx_tpu_torch.modules
import emqx_tpu_torch.hooks
import emqx_tpu_torch.metrics
import emqx_tpu_torch.config
import emqx_tpu_torch.access
import emqx_tpu_torch.auth_providers
import emqx_tpu_torch.ops_guard
import emqx_tpu_torch.limiter
import emqx_tpu_torch.sys_topics
import emqx_tpu_torch.broker.connection
import emqx_tpu_torch.broker.cm
import emqx_tpu_torch.broker.listener
import emqx_tpu_torch.broker.ws
import emqx_tpu_torch.ops.match_kernel
import emqx_tpu_torch.ops._kernels
import emqx_tpu_torch.ops._native
import emqx_tpu_torch.ops.dispatchasm
import emqx_tpu_torch.ops.sortutil_native
import emqx_tpu_torch.ops.tokdict_native
import emqx_tpu_torch.ops.trie_native
import emqx_tpu_torch.observability
import emqx_tpu_torch.parallel
import emqx_tpu_torch.parallel.sharded
import emqx_tpu_torch.rules
import emqx_tpu_torch.rules.columns
import emqx_tpu_torch.rules.engine
import emqx_tpu_torch.rules.evaluator
import emqx_tpu_torch.rules.funcs
import emqx_tpu_torch.rules.predicate
import emqx_tpu_torch.rules.runtime
import emqx_tpu_torch.rules.select
import emqx_tpu_torch.rules.sql
import emqx_tpu_torch.aio
import emqx_tpu_torch.resources
import emqx_tpu_torch.aggregator
import emqx_tpu_torch.schema_registry
import emqx_tpu_torch.workload
import emqx_tpu_torch.httpd
import emqx_tpu_torch.mgmt
import emqx_tpu_torch.mgmt_auth
import emqx_tpu_torch.dashboard
import emqx_tpu_torch.ctl
import emqx_tpu_torch.httpc
import emqx_tpu_torch.auth_db
import emqx_tpu_torch.auth_mongo
import emqx_tpu_torch.auth_ldap
import emqx_tpu_torch.psk
import emqx_tpu_torch.gcp_device
import emqx_tpu_torch.protobuf
import emqx_tpu_torch.hpack
import emqx_tpu_torch.h2
import emqx_tpu_torch.grpc_util
import emqx_tpu_torch.json_schema
import emqx_tpu_torch.exhook
import emqx_tpu_torch.exhook.client
import emqx_tpu_torch.exhook.server
bad = sorted(
    n for n in sys.modules
    if n == "jax" or n.startswith("jax.")
    or n == "emqx_tpu" or n.startswith("emqx_tpu.")
)
print("BAD", bad)
opt = sorted(
    n for n in sys.modules
    if n.split(".")[0] in ("aiohttp", "jsonschema", "grpc", "cryptography",
                           "aiomysql", "asyncpg", "redis")
    or n == "google.protobuf" or n.startswith("google.protobuf.")
)
print("OPT", opt)
"""


def _run(*args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120, **kw)


def test_port_imports_no_jax_and_no_reference():
    proc = _run("-c", _CHECK)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout


def test_port_imports_no_optional_dependency():
    """Importing the port loads none of aiohttp, grpc, cryptography, the
    SQL and Redis drivers (the gated connectors import theirs when
    constructed), protobuf or jsonschema (loaded when a schema of their
    type is added): the port needs none of them to run."""
    proc = _run("-c", _CHECK)
    assert proc.returncode == 0, proc.stderr
    assert "OPT []" in proc.stdout, proc.stdout


_API_WITHOUT_AIOHTTP = """
import asyncio, http.client, json, sys, tempfile
sys.modules["aiohttp"] = None  # any import of it now fails
from emqx_tpu_torch.broker.listener import BrokerServer
from emqx_tpu_torch.config import BrokerConfig, ListenerConfig

def call(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request(method, path, body=body, headers=headers or {})
    resp = conn.getresponse()
    return resp.status, resp.getheader("Content-Type"), resp.read()

async def main():
    cfg = BrokerConfig(listeners=[ListenerConfig(bind="127.0.0.1", port=0)])
    cfg.api.enable, cfg.api.port = True, 0
    cfg.api.data_dir = tempfile.mkdtemp()
    srv = BrokerServer(cfg, device="cpu")
    await srv.start()
    loop = asyncio.get_running_loop()
    try:
        st, _, body = await loop.run_in_executor(None, call, srv.api.port,
            "POST", "/api/v5/login",
            json.dumps({"username": "admin", "password": "public"}))
        print("LOGIN", st)
        tok = json.loads(body)["token"]
        st, ct, body = await loop.run_in_executor(None, call, srv.api.port,
            "GET", "/metrics", None, {"Authorization": "Bearer " + tok})
        print("METRICS", st, ct, b"# TYPE emqx_messages_received counter"
              in body)
    finally:
        await srv.stop()
    print("LOADED", sorted(n for n in sys.modules
                           if n.split(".")[0] in ("jax", "emqx_tpu")
                           or (n.startswith("aiohttp")
                               and sys.modules[n] is not None)))

asyncio.run(asyncio.wait_for(main(), 60))
"""


def test_api_starts_and_serves_with_aiohttp_unimportable():
    """The management API needs no aiohttp: with the module made
    unimportable, a server with the API enabled starts, logs in and
    serves the scrape, and neither aiohttp nor jax was loaded."""
    proc = _run("-c", _API_WITHOUT_AIOHTTP)
    assert proc.returncode == 0, proc.stderr
    assert "LOGIN 200" in proc.stdout, proc.stdout
    assert "METRICS 200 text/plain; charset=utf-8 True" in proc.stdout
    assert "LOADED []" in proc.stdout, proc.stdout


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from emqx_tpu_torch.broker.broker import Broker
    from emqx_tpu_torch.engine import MatchEngine
    from emqx_tpu_torch.rules.engine import RuleEngine
    from emqx_tpu_torch.state import rules_program_from_reference

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MatchEngine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Broker()
    code = torch.full((1, 1), 10, dtype=torch.int32).numpy()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rules_program_from_reference(code, code, code, code, code,
                                     code.astype("float64"), [0], "cuda")
    eng = RuleEngine()  # standalone: the matrix runs on the card
    eng.add_rule("r", 'SELECT * FROM "t" WHERE payload.v > 1')
    from emqx_tpu_torch.message import Message

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eng.apply_batch([(Message(topic="t", payload=b'{"v": 2}'), ["r"])])


def test_cli_default_device_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run("-m", "emqx_tpu_torch.broker", "--port", "0", "--bind",
                "127.0.0.1")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_cuda_tensor_without_kernel_build_raises():
    """A CUDA tensor never takes the plain path: on a box without a
    card the wrapper's launch fails instead of computing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from emqx_tpu_torch.ops import _kernels

    t = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels._stream(t.device)


def test_failed_native_build_raises_and_python_path_still_works(
        monkeypatch, tmp_path):
    """No silent fallback: with a compiler that fails, the default
    engine and broker raise; ``native=False`` needs no library."""
    from emqx_tpu_torch.broker.broker import Broker
    from emqx_tpu_torch.engine import MatchEngine
    from emqx_tpu_torch.ops import _native

    monkeypatch.setattr(_native, "CXX", "false")
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_native, "_libs", {})
    with pytest.raises(RuntimeError, match="native library build failed"):
        MatchEngine(device="cpu")
    with pytest.raises(RuntimeError, match="native library build failed"):
        Broker(device="cpu")
    eng = MatchEngine(device="cpu", native=False)
    eng.insert("a/+", 1)
    eng.rebuild()
    assert eng.match_batch(["a/b", "c"]) == [{1}, set()]
    assert Broker(device="cpu", native=False).publish_many([]) == []
    assert list(tmp_path.glob("*.so")) == []
    monkeypatch.setattr(_native, "CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="cannot run the C\\+\\+ compiler"):
        _native.load("sortutil")


_LOADER_CHECK = """
import os, sys, tempfile
repo = sys.argv[1]
opened = []
def audit(event, args):
    if event == "open" and isinstance(args[0], str):
        opened.append(os.path.abspath(args[0]))
    elif event == "subprocess.Popen":
        opened.extend(os.path.abspath(a) for a in args[1]
                      if isinstance(a, str) and os.sep in a)
sys.addaudithook(audit)
from emqx_tpu_torch.ops import _native
_native.BUILD_DIR = tempfile.mkdtemp()
_native.load_all()
bad = [p for p in opened
       if p.startswith(os.path.join(repo, "native") + os.sep)
       or p.startswith(os.path.join(repo, "emqx_tpu") + os.sep)]
srcs = {p for p in opened if p.endswith(".cpp")}
print("BAD", bad)
print("SRCS", sorted(srcs))
"""


def test_native_loader_reads_only_the_ports_sources():
    """The port's loader compiles its own copies under
    ``emqx_tpu_torch/native/`` and opens nothing under the top-level
    ``native/`` or ``emqx_tpu/``."""
    proc = _run("-c", _LOADER_CHECK, REPO)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout
    mine = sorted(os.path.join(REPO, "emqx_tpu_torch", "native", f"{n}.cpp")
                  for n in ("dispatchasm", "hosttrie", "sortutil", "tokdict"))
    assert f"SRCS {mine}" in proc.stdout, proc.stdout


_BACKENDS_WITHOUT_OPTIONAL = """
import asyncio, json, sys, tempfile
BLOCKED = ("aiohttp", "grpc", "cryptography", "aiomysql", "asyncpg",
           "redis")
for name in BLOCKED:
    sys.modules[name] = None  # any import of it now fails
from emqx_tpu_torch import httpd
from emqx_tpu_torch import workload as W

async def main():
    hits = []

    async def hook(request):
        hits.append(await request.read())
        return httpd.Response(status=204)

    app = httpd.App()
    app.add_route("HEAD", "/hook", hook)
    app.add_post("/hook", hook)
    hook_srv = httpd.HttpServer(app)
    await hook_srv.start()
    script = W.authdb_script(5, 16, 8, n_gcp=(1, 2), n_ldap=3, n_http=3,
                             n_msgs=8, rsa_bits=1024)
    fixtures = await W.start_auth_backends(script)
    tmp = tempfile.mkdtemp()
    impl = W.port_impl("cpu")
    cfg = W.auth_config(impl, tmp)
    cfg.sinks = [{"id": "web", "type": "http",
                  "url": f"http://127.0.0.1:{hook_srv.port}/hook"}]
    srv = impl.server(cfg)
    srv.broker.gcp_devices.import_devices(script["devices"])
    W.auth_chain(impl, srv.broker, fixtures)
    await srv.start()
    try:
        w = srv.broker.resources.get("web")
        w.enqueue(b"payload")
        for _ in range(500):
            if w.stats["success"]:
                break
            await asyncio.sleep(0.01)
        print("SINK", w.status, w.stats["success"], hits)
        codes = []
        for kind, cid, name, pw, ok in script["connects"][4:8]:
            cl = W.TransportClient(srv.listeners[0].port, cid,
                                   username=name, password=pw)
            codes.append((await cl.connect()).reason_code)
            await cl.close()
        print("CONNACK", codes, dict(fixtures[0].finds))
    finally:
        await srv.stop()
        await hook_srv.stop()
        for f in fixtures:
            await f.stop()
    print("LOADED", sorted(n for n in sys.modules
                           if (n.split(".")[0] in ("jax", "emqx_tpu")
                               or n.split(".")[0] in BLOCKED)
                           and sys.modules[n] is not None))

asyncio.run(asyncio.wait_for(main(), 60))
"""


def test_backends_sink_and_gcp_run_without_optional_dependencies():
    """With aiohttp, grpc, cryptography and the SQL/Redis drivers made
    unimportable, a `BrokerServer` with an ``http`` sink and the GCP
    registry on starts, its sink delivers (the F3 repair: the port's own
    HTTP client), a GCP device (ES256, the port's own verifier), an LDAP,
    an HTTP and a Mongo user each connect, and neither those modules
    nor jax nor the JAX package was loaded."""
    proc = _run("-c", _BACKENDS_WITHOUT_OPTIONAL)
    assert proc.returncode == 0, proc.stderr
    # the health probe's HEAD, then the delivery
    assert "SINK connected 1 [b'', b'payload']" in proc.stdout, proc.stdout
    assert "CONNACK [0, 0, 0, 0] {'mqtt_user': 1, 'mqtt_acl': 4}" in \
        proc.stdout, proc.stdout
    assert "LOADED []" in proc.stdout, proc.stdout


_EXHOOK_WITHOUT_OPTIONAL = """
import asyncio, json, os, sys, tempfile
os.environ["PATH"] = tempfile.mkdtemp()  # no protoc
BLOCKED = ("grpc", "google.protobuf", "jsonschema")
for name in BLOCKED:
    sys.modules[name] = None  # any import of it now fails
from emqx_tpu_torch import schema_registry as SR
from emqx_tpu_torch import workload as W
from emqx_tpu_torch.broker.broker import Broker
from emqx_tpu_torch.exhook import pb
from emqx_tpu_torch.exhook.client import ExhookClient
from emqx_tpu_torch.exhook.server import ExhookServer
from emqx_tpu_torch.message import Message

# the port's client against the port's server, both ways of exhook
provider = ExhookServer(device="cpu", hooks=["message.publish"])
provider.broker.hooks.add("message.publish", lambda m: Message(
    topic=m.topic, payload=m.payload + b"!srv", qos=m.qos))
provider.start()
b = Broker(device="cpu", native=False)
client = ExhookClient(b, "p", f"127.0.0.1:{provider.port}", timeout=5.0)
client.start()
out = b.hooks.run_fold("message.publish", (), Message(topic="a/b",
                                                      payload=b"x"))
print("ROUND", client.loaded, out.payload)
client.stop()
provider.stop()
script = W.exhook_script(2, n_clients=8, n_msgs=12)
world = W.exhook_world("cpu", script, n_filters=200)
print("WORLD", world["connacks"], world["counts"]["OnMessagePublish"])

reg = SR.SchemaRegistry()
reg.add("p", "protobuf", 'syntax = "proto3"; message M { int64 a = 1; '
        'map<string, bytes> m = 2; }')
enc = reg.encode("p", {"a": "5", "m": {"k": "AAE="}})
print("PROTO", enc.hex(), reg.decode("p", enc))
reg.add("j", "json", {"type": "object", "required": ["a"]})
print("JSON", reg.check("j", b'{"a": 1}'), reg.check("j", b'{"b": 1}'))
print("LOADED", sorted(
    n for n, mod in sys.modules.items() if mod is not None and (
        n.split(".")[0] in ("jax", "emqx_tpu", "grpc", "jsonschema")
        or n.startswith("google.protobuf"))))
"""


def test_exhook_and_registry_run_without_grpc_protobuf_jsonschema():
    """With grpc, google.protobuf and jsonschema unimportable and no
    ``protoc`` on ``PATH``: the port's exhook client and server round
    trip (and `workload.exhook_world` through a `BrokerServer`), a
    protobuf schema encodes and decodes and a JSON schema validates;
    none of those packages, nor jax or the JAX package, was loaded."""
    proc = _run("-c", _EXHOOK_WITHOUT_OPTIONAL)
    assert proc.returncode == 0, proc.stderr
    assert "ROUND True b'x!srv'" in proc.stdout, proc.stdout
    assert "WORLD [0, 0, 0, 0, 0, 0, 0, 134]" in proc.stdout, proc.stdout
    assert "PROTO 080512070a016b12020001 {'a': '5', 'm': {'k': 'AAE='}}" \
        in proc.stdout, proc.stdout
    assert "JSON True False" in proc.stdout, proc.stdout
    assert "LOADED []" in proc.stdout, proc.stdout


_DURABLE_CHECK = """
import sys
import emqx_tpu_torch.failpoints
import emqx_tpu_torch.ds
import emqx_tpu_torch.ds.api
import emqx_tpu_torch.ds.atomicio
import emqx_tpu_torch.ds.beamformer
import emqx_tpu_torch.ds.builtin_local
import emqx_tpu_torch.ds.durability
import emqx_tpu_torch.ds.journal
import emqx_tpu_torch.ds.lts
import emqx_tpu_torch.ds.native
import emqx_tpu_torch.ds.persist
import emqx_tpu_torch.ds.reference
import emqx_tpu_torch.ds.sharded
import emqx_tpu_torch.broker.resume
bad = sorted(
    n for n in sys.modules
    if n == "jax" or n.startswith("jax.")
    or n == "emqx_tpu" or n.startswith("emqx_tpu.")
)
print("BAD", bad)
"""


def test_failpoints_store_and_resume_import_alone():
    """The failpoints, the durable store and the resume scheduler load
    neither JAX nor anything of the JAX package."""
    proc = _run("-c", _DURABLE_CHECK)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout


def test_failed_dslog_build_raises(monkeypatch, tmp_path):
    """The store's segment log has no fallback: a compiler that fails
    raises out of the store and out of a durable broker."""
    from emqx_tpu_torch.broker.broker import Broker
    from emqx_tpu_torch.config import BrokerConfig
    from emqx_tpu_torch.ds.persist import DurableSessions
    from emqx_tpu_torch.ops import _native

    libs = {n: lib for n, lib in _native._libs.items() if n != "dslog"}
    monkeypatch.setattr(_native, "CXX", "false")
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_native, "_libs", libs)
    with pytest.raises(RuntimeError, match="native library build failed"):
        DurableSessions(str(tmp_path / "ds"))
    cfg = BrokerConfig()
    cfg.durable.enable = True
    cfg.durable.data_dir = str(tmp_path / "ds2")
    with pytest.raises(RuntimeError, match="native library build failed"):
        Broker(config=cfg, device="cpu", native=False)
