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
import emqx_tpu_torch.router
import emqx_tpu_torch.broker.broker
import emqx_tpu_torch.broker.channel
import emqx_tpu_torch.broker.listener
import emqx_tpu_torch.ops.match_kernel
import emqx_tpu_torch.ops._kernels
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
bad = sorted(
    n for n in sys.modules
    if n == "jax" or n.startswith("jax.")
    or n == "emqx_tpu" or n.startswith("emqx_tpu.")
)
print("BAD", bad)
"""


def _run(*args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120, **kw)


def test_port_imports_no_jax_and_no_reference():
    proc = _run("-c", _CHECK)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout


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
