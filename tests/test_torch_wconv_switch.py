"""The W-pair route's switch (``neuroclear_tpu_torch/ops/wconv.py``:
``ENABLED``, from ``NEUROCLEAR_PALLAS_WCONV``) against the JAX package's
(``neuroclear_tpu/ops/pallas_wconv.py``), and the route it switches in
``nn.core.Conv``, on the CPU.

The switch: the environment pins it in both packages ("1" on, any other
value off, "" too).  Unset, the port's is on, where JAX's starts off until
its forward-only entry points call ``set_enabled(True)``: the port has no
runtime switch, because every caller of it wants the kernel.  Both modules
read the environment at import: the port's is reloaded here under each
value, the JAX package's in one subprocess.

The route: a bf16 conv inside the gate runs the W-pair wrapper (its plain
version here) with the switch on and ``F.conv3d`` with it off; both are
held to the f32 conv within the bf16 conv bound of
``tests/test_torch_wconv.py`` (2e-2 of the largest f32 value: inputs and
weights rounded to bf16 over 27 * cin terms, one rounding out), forward and
backward.
"""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from neuroclear_tpu_torch.nn.core import Conv
from neuroclear_tpu_torch.ops import wconv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_REL = 2e-2
KEY = "NEUROCLEAR_PALLAS_WCONV"
ENVS = [None, "1", "0", ""]

_JAX_STATES = """
import importlib, json, os
from neuroclear_tpu.ops import pallas_wconv
states = []
for env in json.loads(os.environ.pop("ENVS")):
    os.environ.pop("{key}", None)
    if env is not None:
        os.environ["{key}"] = env
    states.append(importlib.reload(pallas_wconv).ENABLED)
print(json.dumps(states))
""".format(key=KEY)


@pytest.fixture(scope="module")
def jax_states() -> dict:
    """The JAX package's ``ENABLED`` at import under each value of ENVS."""
    full = {k: v for k, v in os.environ.items() if k != KEY}
    full.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", ENVS=json.dumps(ENVS))
    proc = subprocess.run([sys.executable, "-c", _JAX_STATES], cwd=REPO, env=full,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return dict(zip(map(str, ENVS), json.loads(proc.stdout.strip().splitlines()[-1])))


def _set_env(value) -> None:
    os.environ.pop(KEY, None)
    if value is not None:
        os.environ[KEY] = value


@pytest.mark.parametrize("env", ENVS)
def test_switch_matches_jax(jax_states, env):
    saved = os.environ.get(KEY)
    try:
        _set_env(env)
        port = importlib.reload(wconv).ENABLED
    finally:
        _set_env(saved)
        importlib.reload(wconv)
    if env is None:
        # the deviation: unset, the port is on and JAX's starts off
        assert port is True and jax_states["None"] is False
    else:
        assert port == jax_states[env] == (env == "1")


def _fill(conv: Conv, rng, cin: int) -> None:
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(rng.normal(size=(64, cin, 3, 3, 3)) * 0.05))
        conv.bias.copy_(torch.from_numpy(rng.normal(size=(64,))))


def _forward_backward(conv: Conv, x: np.ndarray, g: np.ndarray, dtype) -> tuple:
    conv.zero_grad(set_to_none=True)
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    y = conv(xt)
    (y.float() * torch.from_numpy(g)).sum().backward()
    return (y.detach().float(), xt.grad.float(), conv.weight.grad.clone(),
            conv.bias.grad.clone())


@pytest.mark.parametrize("cin", [64, 128])
@pytest.mark.parametrize("on", [True, False])
def test_switch_routes_the_gated_conv(monkeypatch, on, cin):
    rng = np.random.default_rng(cin + on)
    conv = Conv(cin, 64, 3, 1, 1)
    _fill(conv, rng, cin)
    x = rng.normal(size=(1, 4, 4, 8, cin)).astype(np.float32)
    g = rng.normal(size=(1, 4, 4, 8, 64)).astype(np.float32)
    ref = _forward_backward(conv, x, g, torch.float32)

    calls = []
    plain, conv3d = wconv.conv3d_plain, torch.nn.functional.conv3d
    monkeypatch.setattr(wconv, "conv3d_plain",
                        lambda *a: (calls.append(("wconv", a[0].shape[-1])), plain(*a))[1])
    monkeypatch.setattr(torch.nn.functional, "conv3d",
                        lambda x, *a, **k: (calls.append(("F.conv3d", x.dtype)),
                                            conv3d(x, *a, **k))[1])
    monkeypatch.setattr(wconv, "ENABLED", on)
    got = _forward_backward(conv, x, g, torch.bfloat16)
    # forward, then the input gradient (the conv on the 64-channel cotangent)
    assert calls == ([("wconv", cin), ("wconv", 64)] if on
                     else [("F.conv3d", torch.bfloat16)])
    for name, a, b in zip(("y", "dx", "dw", "db"), got, ref):
        err = (a.float() - b).abs().max().item()
        assert err <= BF16_REL * b.abs().max().item(), (name, err)
