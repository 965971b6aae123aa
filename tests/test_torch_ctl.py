"""The port's operator CLI against the JAX package's: both packages'
``ctl.main`` (stdout captured), each against the port's live server, as
tests/test_trace_ctl.py:92 drives the reference's.  Every subcommand
gives the same output (uptime normalised), or the same ``error <code>:
...`` exit: the subcommands of modules the port has not ported exit
with the server's 501.  Then ``python -m emqx_tpu_torch.ctl`` as a
subprocess.

Every test's coroutine runs under `asyncio.wait_for` with its own limit.
"""

import asyncio
import contextlib
import io
import os
import re
import subprocess
import sys

import pytest

from emqx_tpu import ctl as RCtl

from emqx_tpu_torch import ctl as PCtl
from emqx_tpu_torch import failpoints as PFP

from mqtt_client import TestClient
from test_torch_mgmt import LIMIT, Loop, port_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def L():
    lp = Loop()
    yield lp
    lp.close()


def run_main(main, argv):
    """(stdout, the SystemExit's message or None) of one ``main``."""
    out = io.StringIO()
    code = None
    with contextlib.redirect_stdout(out):
        try:
            main(argv)
        except SystemExit as exc:
            code = str(exc.code)
    return re.sub(r"uptime \d+s", "uptime *s", out.getvalue()), code


def _ban(broker):
    broker.banned.ban("clientid", "bad-1", seconds=None)


def _arm_probe(broker):
    """The port's server serves the port's failpoint registry: arm the
    probe a ``clear`` removes before each run."""
    PFP.configure("ctl.probe", "delay", delay=0.01, seed=3)


# each subcommand runs once a package, back to back; a command that
# changes the server's state gets it back before each run
COMMANDS = [
    (["status"], None), (["clients"], None), (["subscriptions"], None),
    (["topics"], None), (["rules"], None), (["metrics"], None),
    (["metrics", "messages"], None), (["stats"], None),
    (["publish", "cli/hello", "from-ctl", "--qos", "1"], None),
    (["banned"], None), (["banned", "add", "clientid", "bad-1"], None),
    (["banned"], None), (["banned", "del", "clientid", "bad-1"], _ban),
    (["profiler"], None), (["profiler", "windows", "4"], None),
    (["profiler", "reset"], None), (["clients", "kick", "nobody"], None),
    (["failpoints"], None),
    (["failpoints", "set", "ctl.probe", "delay", "delay=0.01", "seed=3"],
     None),
    (["failpoints", "list"], None),
    (["failpoints", "clear", "ctl.probe"], _arm_probe),
    (["failpoints", "clear"], _arm_probe),
    # modules not ported: the server's 501
    (["trace"], None), (["trace", "start", "t1", "clientid", "x"], None),
    (["data", "export"], None), (["rebalance"], None),
    (["rebalance", "evacuation"], None),
    (["olp"], None), (["flight"], None), (["tracing"], None),
    (["tracing", "perfetto"], None),
]


def test_ctl_main_of_both_packages_prints_the_same(L, tmp_path):
    async def t():
        srv = port_server(str(tmp_path))
        srv.broker.config.sys.enable = False
        await srv.start()
        watch = TestClient(srv.listeners[0].port, "cli-watch")
        await watch.connect()
        await watch.subscribe("cli/#", qos=1)
        srv.broker.rules.add_rule("r1", 'SELECT * FROM "cli/#"')
        api = ["--api", f"http://127.0.0.1:{srv.api.port}"]
        loop = asyncio.get_running_loop()
        outs = []
        try:
            for argv, setup in COMMANDS:
                pair = []
                for main in (RCtl.main, PCtl.main):
                    if setup is not None:
                        setup(srv.broker)
                    pair.append(await loop.run_in_executor(
                        None, run_main, main, api + argv))
                outs.append((argv, pair))
            # the two publishes reached the subscriber
            for _ in range(2):
                pkt = await watch.recv_publish()
                assert pkt.payload == b"from-ctl"
        finally:
            await watch.close()
            await srv.stop()
        return outs

    outs = L.run(t(), LIMIT)
    for argv, (ref, prt) in outs:
        assert prt == ref, (argv, ref, prt)
    by = {tuple(a): p for a, (_, p) in outs}
    assert "is running" in by[("status",)][0]
    assert "cli-watch" in by[("clients",)][0]
    assert "delivered to 1" in by[("publish", "cli/hello", "from-ctl",
                                   "--qos", "1")][0]
    assert by[("clients", "kick", "nobody")][1].startswith("error 404")
    assert by[("failpoints",)][0].startswith("framework disabled")
    assert "ctl.probe\tdelay\t" in by[("failpoints", "list")][0]
    for argv in (("olp",), ("rebalance",), ("data", "export"),
                 ("tracing", "perfetto")):
        out, err = by[argv]
        assert err.startswith("error 501: ") and "NOT_PORTED" in err, argv


def test_python_m_ctl_against_the_port(L, tmp_path):
    async def t():
        srv = port_server(str(tmp_path))
        await srv.start()
        api = f"http://127.0.0.1:{srv.api.port}"

        def ctl(*args):
            return subprocess.run(
                [sys.executable, "-m", "emqx_tpu_torch.ctl", "--api", api,
                 *args], capture_output=True, text=True, timeout=20,
                cwd=REPO)

        loop = asyncio.get_running_loop()
        try:
            ok = await loop.run_in_executor(None, ctl, "status")
            assert ok.returncode == 0, ok.stderr
            assert "emqx_tpu@127.0.0.1 is running" in ok.stdout
            bad = await loop.run_in_executor(None, ctl, "olp")
            assert bad.returncode == 1
            assert bad.stderr.startswith("error 501: ")
            nologin = await loop.run_in_executor(
                None, ctl, "--user", "admin:wrong", "status")
            assert nologin.returncode == 1
            assert nologin.stderr.startswith("error 401: ")
        finally:
            await srv.stop()

    L.run(t(), LIMIT)


def test_ctl_status_shows_the_resume_queue_and_durability(L, tmp_path):
    """With durable storage on, ``ctl status`` prints the resume queue
    and the durability lines from ``/api/v5/nodes``, the same from both
    packages' CLIs."""
    from test_torch_mgmt import _cfg
    from emqx_tpu_torch import config as PCfg
    from emqx_tpu_torch.broker.listener import BrokerServer

    async def t():
        cfg = _cfg(PCfg, str(tmp_path / "api"))
        cfg.durable.enable = True
        cfg.durable.data_dir = str(tmp_path / "ds")
        cfg.durable.fsync = "always"
        srv = BrokerServer(cfg, device="cpu")
        await srv.start()
        api = ["--api", f"http://127.0.0.1:{srv.api.port}"]
        loop = asyncio.get_running_loop()
        try:
            return [await loop.run_in_executor(None, run_main, main,
                                               api + ["status"])
                    for main in (RCtl.main, PCtl.main)]
        finally:
            await srv.stop()

    ref, port = L.run(t(), LIMIT)
    assert port == ref
    out = port[0]
    assert "  resume queue: 0 active / 0 parked / 0 paused " \
           "(max_concurrent=64, park_cap=4096, windowed=True)" in out
    assert "  durability: fsync=always; 0 syncs (0 errors)" in out
