"""``--remat`` in the port (``nn/generators.py``, ``models/gan_common.py``):
the Apollo step with the two generators of the G loss recomputing their
activations against the same step without, on the CPU at 24^3 with the
production nets at full width.  The recomputation runs the same operations
on the same inputs, so the parameters, gradients and losses must be the same
bits, in f32 and in bf16 (the kernels' plain versions).  Also: the backward
generator's whole-apply form alone; that remat keeps fewer tensors for the
backward; and the kernel wrappers' calls per step, with and without remat,
against the launch tables of ``chip_smoke.py`` (on the CPU each wrapper
runs its plain version at the place it launches its kernel on the card)."""

import functools

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import chip_smoke
from neuroclear_tpu_torch.models import gan_common as gc
from neuroclear_tpu_torch.models.axial_to_lateral_gan_apollo_model import (
    LOSS_NAMES, ApolloModel)
from neuroclear_tpu_torch.nn.generators import DeepLinearGenerator, UNetDeconv
from neuroclear_tpu_torch.ops import KERNELS, conv3x3, inorm, wconv
from neuroclear_tpu_torch.options import train_options
from neuroclear_tpu_torch.utils.weights import init_flat, params_from_numpy

CROP = 24


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """One CPU thread for torch and BLAS: with a thread per core in each of
    the suite's six workers these steps run tens of times slower than alone
    (a 24^3 bf16 study step: 250 s against 5 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _model(precision, remat):
    argv = ["--dataroot", "unused", "--gan_mode", "lsgan", "--lambda_A", "5",
            "--randomize_projection_depth", "--projection_depth", "4",
            "--precision", precision] + (["--remat"] if remat else [])
    model = ApolloModel(train_options.build_parser().parse_args(argv), "cpu")
    model.init_weights(7)
    return model


def _inputs(model):
    gen = torch.Generator().manual_seed(11)
    real = torch.from_numpy(
        np.random.default_rng(5).random((1, CROP, CROP, CROP, 1)).astype(np.float32))
    return real, model.draw_probes((CROP,) * 3, gen)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_remat_step_is_bitwise_the_step_without(precision):
    runs = []
    for remat in (False, True):
        model = _model(precision, remat)
        real, draws = _inputs(model)
        losses, fake, rec, gg, dg = model.gradients(real, draws)
        model.apply_gradients(gg, dg)
        runs.append((losses, fake, rec, list(gg) + list(dg),
                     list(model.g_params) + list(model.d_params)))
    (la, fa, ra, ga, pa), (lb, fb, rb, gb, pb) = runs
    for name in LOSS_NAMES:
        assert torch.equal(la[name], lb[name]), name
    assert torch.equal(fa, fb) and torch.equal(ra, rb)
    assert len(ga) == len(gb)
    for i, (x, y) in enumerate(zip(ga, gb)):
        assert torch.equal(x, y), i
    for i, (x, y) in enumerate(zip(pa, pb)):
        assert torch.equal(x, y), i


def _saved_tensors(fn) -> int:
    """How many tensors autograd keeps for the backward of fn()."""
    count = [0]

    def pack(t):
        count[0] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return count[0]


@pytest.mark.parametrize("net_cls", [DeepLinearGenerator, UNetDeconv])
def test_generator_remat_is_bitwise_and_keeps_less(net_cls):
    """Each generator as the G loss runs it: its output and the gradients
    of a loss on it with respect to its parameters and its input, bitwise,
    with fewer tensors kept for the backward.  DeepLinearGenerator takes
    the whole-apply form (only its input is kept), UNetDeconv the
    per-block one."""
    net = net_cls(1, 1)
    net.load_state_dict(params_from_numpy(init_flat(net, seed=3), net))
    x0 = torch.from_numpy(np.random.default_rng(1).random((1, 16, 16, 16, 1)).astype(np.float32))
    cfg = {remat: gc.GanStepConfig(remat=remat) for remat in (False, True)}
    assert getattr(net, "block_remat", False) == (net_cls is UNetDeconv)
    outs = {}
    for remat in (False, True):
        x = x0.clone().requires_grad_(True)
        kept = _saved_tensors(lambda: gc.maybe_remat(net, cfg[remat])(x))
        y = gc.maybe_remat(net, cfg[remat])(x)
        loss = (y * y).sum()
        grads = torch.autograd.grad(loss, [x, *net.parameters()])
        outs[remat] = (kept, y.detach(), grads)
    (k0, y0, g0), (k1, y1, g1) = outs[False], outs[True]
    assert k1 < k0, (k1, k0)
    assert torch.equal(y0, y1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def _counting(monkeypatch, counts):
    """Replace every kernel wrapper with one that counts its calls."""
    for name, fn in KERNELS.items():
        module = conv3x3 if name == "conv3x3" else wconv if name.startswith("wconv") else inorm

        def wrap(*a, _fn=fn, _name=name, **k):
            counts[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(module, fn.__name__, functools.update_wrapper(wrap, fn))


@pytest.mark.parametrize("precision, remat, table", [
    ("bfloat16", False, "STEP_LAUNCHES"), ("bfloat16", True, "REMAT_STEP_LAUNCHES"),
    ("float32", False, "F32_STEP_LAUNCHES")])
def test_wrapper_calls_per_step_are_the_smokes_tables(monkeypatch, precision, remat, table):
    """One crop's step calls each kernel wrapper as often as chip_smoke.py
    asserts its launches on the card: remat adds the recomputed forwards of
    G_A's units (every unit but each block's last is run again by its
    block's recomputation, and every unit by its own) and G_B's W-pair conv;
    in f32 the W-pair conv's gate is closed."""
    counts = dict.fromkeys(KERNELS, 0)
    _counting(monkeypatch, counts)
    model = _model(precision, remat)
    real, draws = _inputs(model)
    losses, _, _, _, _ = model.gradients(real, draws)
    assert all(torch.isfinite(v) for v in losses.values())
    assert counts == getattr(chip_smoke, table)
