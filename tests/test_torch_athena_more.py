"""The port's Athena accumulation (neuroclear_tpu_torch/models/
axial_to_lateral_gan_athena_model.py, ``--grad_accum 2``) on the CPU,
against the JAX package's ``grad_accum_scan`` (``make_athena_step`` with
``grad_accum=2``, a program of its own to compile) and against the mean of
the crops' own gradients.  The JAX side and the bars are
tests/test_torch_athena.py's.
"""

import numpy as np
import pytest
import torch

from neuroclear_tpu.nn.core import flatten_params
from neuroclear_tpu_torch.models.axial_to_lateral_gan_athena_model import (
    D_NAMES, G_NAMES, LOSS_NAMES, MODEL_NAMES)
from test_torch_athena import (D_REL_L2, G_A_REL_L2, _assert_grads, _flat_of, _jax_nets,
                               _jax_step, _port, _real, _weights)
from test_torch_athena import one_cpu_thread  # noqa: F401  (the module's autouse fixture)


@pytest.fixture(scope="module")
def accum():
    params = _weights("random", _jax_nets())
    crops = _real(2, n=2)
    jax_out = _jax_step(params, ("yz", "xy"), crops, accum=2)
    model = _port(("yz", "xy"), {n: flatten_params(params[n]) for n in MODEL_NAMES},
                  extra=["--grad_accum", "2"])
    return jax_out, model, crops


def test_accumulation_matches_grad_accum_scan(accum):
    """Two crops: the port's per-crop accumulation against JAX's
    ``grad_accum_scan`` (mean losses, the last crop's visuals, the mean
    gradients)."""
    (jl, jfake, jrec, jg, jd), model, crops = accum
    losses, real, fake, rec, gg, dg = model.accumulate(
        lambda i: torch.from_numpy(crops[i:i + 1]), 2, None)
    for name in LOSS_NAMES:
        assert float(losses[name]) == pytest.approx(jl[name], rel=1e-4), name
    np.testing.assert_array_equal(real.numpy(), crops[1:2])
    np.testing.assert_allclose(fake.numpy(), jfake, rtol=1e-4, atol=1e-4 * np.abs(jfake).max())
    _assert_grads(_flat_of(model, D_NAMES, dg), jd, D_REL_L2)
    pg = _flat_of(model, G_NAMES, gg)
    _assert_grads({k: v for k, v in pg.items() if k.startswith("G_B.")},
                  {k: v for k, v in jg.items() if k.startswith("G_B.")}, D_REL_L2)
    _assert_grads({k: v for k, v in pg.items() if k.startswith("G_A.")},
                  {k: v for k, v in jg.items() if k.startswith("G_A.")}, G_A_REL_L2)


def test_accumulation_is_the_mean_of_the_crops_gradients(accum):
    _, model, crops = accum
    *_, gg, dg = model.accumulate(lambda i: torch.from_numpy(crops[i:i + 1]), 2, None)
    per = [model.gradients(torch.from_numpy(crops[i:i + 1])) for i in range(2)]
    for j, acc in enumerate(list(gg) + list(dg)):
        mean = sum((p[3] + p[4])[j] for p in per) / 2
        assert torch.linalg.vector_norm(acc - mean) <= 1e-6 * torch.linalg.vector_norm(mean)


def test_fused_accum_step_matches_grad_accum_scan(accum, monkeypatch):
    """``--fused_accum`` (the two crops resident together,
    ``optimize_parameters_batch``; JAX's Athena step takes only this form):
    its losses and the gradients that reach its update against
    ``grad_accum_scan``'s, at the accumulation's bars."""
    (jl, _, _, jg, jd), model, crops = accum
    seen = []
    monkeypatch.setattr(model, "apply_gradients", lambda g, d: seen.append((g, d)))
    losses, *_ = model.optimize_parameters_batch(torch.from_numpy(crops), None)
    for name in LOSS_NAMES:
        assert float(losses[name]) == pytest.approx(jl[name], rel=1e-4), name
    (gg, dg), = seen
    _assert_grads(_flat_of(model, D_NAMES, dg), jd, D_REL_L2)
    pg = _flat_of(model, G_NAMES, gg)
    _assert_grads({k: v for k, v in pg.items() if k.startswith("G_B.")},
                  {k: v for k, v in jg.items() if k.startswith("G_B.")}, D_REL_L2)
    _assert_grads({k: v for k, v in pg.items() if k.startswith("G_A.")},
                  {k: v for k, v in jg.items() if k.startswith("G_A.")}, G_A_REL_L2)
