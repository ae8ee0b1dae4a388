"""The port's Dryops accumulation (``--grad_accum 2``) against the JAX
package's ``grad_accum_scan`` on the CPU, and against the mean of the
crops' gradients: the two accumulation cases of tests/test_torch_dryops.py,
in a file of their own so that ``--dist loadfile`` runs them on another
worker than that file's one-crop cases (the float64 JAX referee of the
accumulation compiles alone for minutes).  The inputs, bars and referee are
that file's (its module docstring)."""

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from neuroclear_tpu.nn.core import flatten_params
from test_torch_dryops import (D_NAMES, G_NAMES, LOSS_NAMES, MODEL_NAMES, _assert_grads, _draws,
                               _flat_of, _jax_step, _port, _real, _weights)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def accum():
    params = _weights("random")
    rng = jax.random.PRNGKey(9)
    crops = _real(3, n=2)
    jax_out = _jax_step(params, rng, crops, accum=2)
    model = _port({n: flatten_params(params[n]) for n in MODEL_NAMES}, extra=["--grad_accum", "2"])
    return jax_out, model, crops, _draws(rng)


def test_accumulation_draws_once_and_matches_grad_accum_scan(accum):
    """JAX closes one step's keys over ``grad_accum_scan``: both crops'
    micro-steps use the same depth and positions.  The port's accumulation
    under the one set of draws matches it."""
    (jl, jfake, jax64), model, crops, draws = accum
    losses, real, fake, gg, dg = model.accumulate(
        lambda i: torch.from_numpy(crops[i:i + 1]), 2, draws)
    for name in LOSS_NAMES:
        assert float(losses[name]) == pytest.approx(jl[name], rel=1e-4), name
    np.testing.assert_array_equal(real.numpy(), crops[1:2])
    np.testing.assert_allclose(fake.numpy(), jfake, rtol=1e-4, atol=1e-4 * np.abs(jfake).max())
    _assert_grads({**_flat_of(model, G_NAMES, gg), **_flat_of(model, D_NAMES, dg)}, jax64)


def test_accumulation_is_the_mean_of_the_crops_gradients(accum):
    _, model, crops, draws = accum
    *_, gg, dg = model.accumulate(lambda i: torch.from_numpy(crops[i:i + 1]), 2, draws)
    per = [model.gradients(torch.from_numpy(crops[i:i + 1]), draws) for i in range(2)]
    for j, acc in enumerate(list(gg) + list(dg)):
        mean = sum((p[2] + p[3])[j] for p in per) / 2
        assert torch.linalg.vector_norm(acc - mean) <= 1e-6 * torch.linalg.vector_norm(mean)


def test_fused_accum_step_matches_grad_accum_scan(accum, monkeypatch):
    """``--fused_accum`` (the two crops resident together,
    ``optimize_parameters_batch``; JAX's Dryops step takes only this form):
    its losses and the gradients that reach its update against the
    accumulation's referee."""
    (jl, _, jax64), model, crops, draws = accum
    seen = []
    monkeypatch.setattr(model, "apply_gradients", lambda g, d: seen.append((g, d)))
    losses, *_ = model.optimize_parameters_batch(torch.from_numpy(crops), draws)
    for name in LOSS_NAMES:
        assert float(losses[name]) == pytest.approx(jl[name], rel=1e-4), name
    (gg, dg), = seen
    _assert_grads({**_flat_of(model, G_NAMES, gg), **_flat_of(model, D_NAMES, dg)}, jax64)
