"""The port's learning-rate schedules (``neuroclear_tpu_torch/nn/
schedulers.py``) against the JAX package's ``LRController``, iteration by
iteration, and their state round trip."""

import argparse
import math

import pytest

from neuroclear_tpu.nn.schedulers import LRController as JaxLRController
from neuroclear_tpu_torch.nn.schedulers import LRController

POLICIES = ["linear", "constant", "step", "plateau", "cosine"]
ITERS = 300


def _opt(**kw):
    base = dict(epoch_count=1, n_epochs=100, n_epochs_decay=150, lr_decay_iters=50)
    base.update(kw)
    return argparse.Namespace(**base)


def _metric(i: int) -> float:
    """Falls for 40 iterations, then stalls and wobbles: the plateau policy
    both improves and decays on it."""
    return 1.0 / (1 + min(i, 40)) + 0.001 * math.sin(i)


@pytest.mark.parametrize("policy", POLICIES)
def test_scale_per_iteration_matches_jax(policy):
    for opt in (_opt(), _opt(epoch_count=7, n_epochs=20, n_epochs_decay=30, lr_decay_iters=9)):
        port, ref = LRController(policy, opt), JaxLRController(policy, opt)
        scales = []
        for i in range(ITERS):
            assert port.scale == ref.scale, (policy, i)
            scales.append(port.scale)
            assert port.step(_metric(i)) == ref.step(_metric(i))
        assert port.state() == ref.state()
    if policy != "constant":
        assert len(set(scales)) > 1  # the schedule moved


@pytest.mark.parametrize("policy", POLICIES)
def test_state_round_trip(policy):
    """A controller restored from another's state() continues as it would."""
    a = LRController(policy, _opt())
    for i in range(123):
        a.step(_metric(i))
    b = LRController(policy, _opt())
    b.restore(a.state())
    assert b.state() == a.state() and b.scale == a.scale
    for i in range(123, ITERS):
        assert b.step(_metric(i)) == a.step(_metric(i))
    jax_b = JaxLRController(policy, _opt())
    jax_b.restore(LRController(policy, _opt()).state())
    assert jax_b.scale == LRController(policy, _opt()).scale
