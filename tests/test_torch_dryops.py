"""The port's Dryops step (neuroclear_tpu_torch/models/
axial_to_lateral_gan_dryops_model.py) against the JAX package's
``make_dryops_step`` on the CPU: full-width G_A (UNetDeconv) and two
NLayerDiscriminators, a 24^3 crop, f32, projection depth up to 4, with the
probe draws the JAX keys make handed to the port; on JAX-initialised
Kaiming weights and on trained weights (the JAX study's Apollo G_A,
D_A_lateral and D_A_axial, ``study_state/apollo148s4``: Dryops has the same
three nets).

The JAX step is built with an optax transformation that keeps the gradients
it is given as its state (see tests/test_torch_athena.py).  Bars: losses
rtol 1e-4, the fake rtol 1e-4.  The accumulation cases are in
tests/test_torch_dryops_accum.py (their JAX step compiles apart, so a
worker of their own runs them).  Gradients are held against the JAX step
itself run in float64 (``jax.enable_x64``, a float64 compute dtype, the
norm's statistics and maps of ``neuroclear_tpu/ops/pallas_ops.py`` in their
input dtype instead of f32, ``jax.random.randint`` kept at its 32-bit draws
so the probes are the same; only the loss casts its prediction to f32,
which moves the gradients by ~1e-7): the port's f32 gradients within
``TOL`` relative L2 of it per tensor (1e-3; G_A 1e-2, where a ReLU mask of
the U-Net flips between f32 and float64, or between two f32 runs that sum
in another order, moving every G_A gradient below it: measured on these
inputs, G_A up to 8e-3 in the accumulation on one CPU thread and 6.7e-4
on several, the discriminators up to 2.2e-5; the port's own float64 step
lies within 1.4e-12 of this referee).  The JAX step's own f32
gradients are not the referee: its norm takes the variance in one f32
pass (E[x^2] - E[x]^2), and on these inputs they lie up to 1.4e-2 (G_A,
random weights) from its float64 step, and up to 0.70 (G_A's output
convolutions, two crops whose gradients nearly cancel) in the
accumulation.  Biases before an
instance norm (true gradient 0) within 1e-5 of their layer's weight
gradient norm.
"""

import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from threadpoolctl import threadpool_limits

import chip_smoke
from neuroclear_tpu.models import gan_common as jgc
from neuroclear_tpu.models.axial_to_lateral_gan_dryops_model import make_dryops_step
from neuroclear_tpu.nn import factory as jax_factory
from neuroclear_tpu.nn.core import flatten_params, unflatten_params
from neuroclear_tpu.ops import pallas_ops
from neuroclear_tpu_torch.models import create_model
from neuroclear_tpu_torch.models.axial_to_lateral_gan_dryops_model import (
    D_NAMES, D_PROBES, G_NAMES, G_PROBES, LOSS_NAMES, MODEL_NAMES, ProbeDraws)
from neuroclear_tpu_torch.ops import KERNELS, conv3x3, inorm, wconv
from neuroclear_tpu_torch.options import train_options
from neuroclear_tpu_torch.utils.weights import load_npz

CROP, DEPTH = 24, 4
STUDY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "study_state", "apollo148s4")
TOL = {"G_A": 1e-2, "D_A_lateral": 1e-3, "D_A_axial": 1e-3}
PRE_NORM = ("double_conv", "bottom_layer", "ex_double_conv2", "ex_conv1_1",
            "conv1", "conv2", "conv3")


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _capture():
    """An optax transformation whose state is the last gradients it saw."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (jax.tree.map(jnp.zeros_like, updates), updates))


def _port(flats, precision="float32", remat=False, extra=()):
    argv = ["--dataroot", "unused", "--model", "axial_to_lateral_gan_dryops", "--gan_mode",
            "lsgan", "--randomize_projection_depth", "--projection_depth", str(DEPTH),
            "--precision", precision, "--device", "cpu", *(["--remat"] if remat else []),
            *extra]
    model = create_model(train_options.build_parser(argv).parse_args(argv), "cpu")
    model.load_flats(flats)
    return model


def _flat_of(model, names, grads) -> dict:
    out = {}
    named = [(n, pn) for n in names for pn, _ in model.nets[n].named_parameters()]
    for (n, pn), g in zip(named, grads):
        prefix, leaf = pn.rsplit(".", 1)
        layer = model.nets[n].get_submodule(prefix)
        arr = layer.weight_to_jax(g) if leaf == "weight" else g
        out[f"{n}.{prefix}.{'w' if leaf == 'weight' else 'b'}"] = arr.detach().double().numpy()
    return out


def _jax_flat(tree: dict, names) -> dict:
    return {f"{n}.{k}": np.asarray(v, np.float64) for n in names
            for k, v in flatten_params(tree[n]).items()}


@functools.lru_cache(maxsize=None)
def _jax_nets() -> dict:
    nets = {"G_A": jax_factory.define_G(1, 1, 64, "unet_deconv", "instance", dimension=3)}
    for name in D_NAMES:
        nets[name] = jax_factory.define_D(1, 64, "basic", 3, "instance", dimension=2)
    return nets


def _weights(kind) -> dict:
    if kind == "trained":
        return {n: unflatten_params(load_npz(os.path.join(STUDY, f"iter_11000_net_{n}.npz")))
                for n in MODEL_NAMES}
    keys = jax.random.split(jax.random.PRNGKey(1), len(MODEL_NAMES))
    return {n: _jax_nets()[n].init(k, "kaiming", 0.02) for n, k in zip(MODEL_NAMES, keys)}


def _draws(rng) -> ProbeDraws:
    """The step's draws as make_dryops_step and ops/sampling.py make them."""
    k_depth, k_g, k_d = jax.random.split(rng, 3)
    depth = int(jax.random.randint(k_depth, (), 2, DEPTH + 1))

    def draw(plan, ks):
        return tuple(int(jax.random.randint(k, (), 0, CROP - depth if kind == "proj" else CROP))
                     for (kind, _, _, _), k in zip(plan, ks))

    return ProbeDraws(depth, draw(G_PROBES, jax.random.split(k_g, 3)),
                      draw(D_PROBES, jax.random.split(k_d, 6)))


class _Float64Config(jgc.GanStepConfig):
    @property
    def compute_dtype(self):
        return jnp.float64


@functools.lru_cache(maxsize=None)
def _jax_step_fn(accum, float64=False):
    """The JAX step for ``accum`` (compiled once) and its optimizer."""
    cfg = (_Float64Config if float64 else jgc.GanStepConfig)(
        gan_mode="lsgan", randomize_projection_depth=True, projection_depth=DEPTH,
        min_projection_depth=2, precision="float32", grad_accum=accum)
    optim = _capture()
    return make_dryops_step(_jax_nets(), optim, cfg), optim


@contextlib.contextmanager
def _jax_float64():
    """x64 on; the norm's sums and maps in their input dtype; 32-bit draws."""
    randint = jax.random.randint
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "randint", functools.partial(randint, dtype=jnp.int32))
        mp.setattr(pallas_ops, "_pair_sums", lambda a, b=None: (
            jnp.sum(a, axis=1), jnp.sum(a * (a if b is None else b), axis=1)))
        mp.setattr(pallas_ops, "_affine_map",
                   lambda x, scale, shift: x * scale[:, None, :] + shift[:, None, :])
        mp.setattr(pallas_ops, "_bwd_map", lambda g, y, rstd, mg, mgy: rstd[:, None, :] * (
            g - mg[:, None, :] - y * mgy[:, None, :]))
        yield


def _jax_step(params, rng, real, accum=1):
    """The f32 step's losses and fake, and the float64 step's gradients."""
    copy = lambda tree, dtype: jax.tree.map(  # noqa: E731  the step donates its inputs
        lambda a: jnp.array(a, dtype, copy=True), tree)

    def run(float64):
        step, optim = _jax_step_fn(accum, float64)
        dtype = jnp.float64 if float64 else jnp.float32
        gp = copy({k: params[k] for k in G_NAMES}, dtype)
        dp = copy({k: params[k] for k in D_NAMES}, dtype)
        state = {"G": optim.init(gp), "D": optim.init(dp)}
        _, _, state, losses, fake = step(gp, dp, state, rng, jnp.asarray(real, dtype),
                                         jnp.float32(1e-4))
        return losses, fake, {**_jax_flat(state["G"], G_NAMES),
                              **_jax_flat(state["D"], D_NAMES)}

    losses, fake, _ = run(False)
    with _jax_float64():
        *_, grads = run(True)
    return {k: float(v) for k, v in losses.items()}, np.asarray(fake), grads


def _real(seed, n=1):
    return np.random.default_rng(seed).random((n, CROP, CROP, CROP, 1)).astype(np.float32)


@pytest.fixture(scope="module", params=["random", "trained"])
def case(request):
    params = _weights(request.param)
    rng = jax.random.PRNGKey(7)
    real = _real(2)
    jl, jfake, jax64 = _jax_step(params, rng, real)
    model = _port({n: flatten_params(params[n]) for n in MODEL_NAMES})
    losses, fake, gg, dg = model.gradients(torch.from_numpy(real), _draws(rng))
    return dict(jl=jl, jfake=jfake, jax64=jax64, losses=losses, fake=fake.numpy(),
                port={**_flat_of(model, G_NAMES, gg), **_flat_of(model, D_NAMES, dg)})


def _is_pre_norm_bias(key: str) -> bool:
    parts = key.split(".")
    return parts[-1] == "b" and any(p.startswith(PRE_NORM) for p in parts[1:-1])


def _assert_grads(port: dict, ref: dict) -> None:
    """The module docstring's bars, tensor by tensor, against JAX's float64 step."""
    assert set(port) == set(ref)
    bad = {}
    for k in ref:
        p, r = port[k], ref[k]
        if _is_pre_norm_bias(k):
            assert np.abs(p - r).max() <= 1e-5 * np.linalg.norm(ref[k[:-1] + "w"]), k
            continue
        err = np.linalg.norm(p - r) / np.linalg.norm(r)
        if not err <= TOL[k.split(".")[0]]:
            bad[k] = err
    assert not bad, bad


def test_losses_match_jax(case):
    assert set(case["jl"]) == set(LOSS_NAMES)
    for name in LOSS_NAMES:
        assert float(case["losses"][name]) == pytest.approx(case["jl"][name], rel=1e-4), name


def test_fake_matches_jax(case):
    np.testing.assert_allclose(case["fake"], case["jfake"], rtol=1e-4,
                               atol=1e-4 * np.abs(case["jfake"]).max())


def test_gradients_match_float64_and_jax(case):
    _assert_grads(case["port"], case["jax64"])


def test_draw_probes_draws_the_depth_then_three_and_six_positions():
    model = _port({})
    gen = torch.Generator().manual_seed(0)
    for _ in range(50):
        d = model.draw_probes((CROP, 20, 16), gen)
        assert 2 <= d.depth <= DEPTH and len(d.g) == 3 and len(d.d) == 6
        for (kind, _, axis, _), pos in zip(G_PROBES + D_PROBES, d.g + d.d):
            n = (CROP, 20, 16)[axis]
            assert 0 <= pos < (n - d.depth if kind == "proj" else n)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_remat_step_is_bitwise_the_step_without(precision):
    outs = {}
    for remat in (False, True):
        model = _port({}, precision=precision, remat=remat)
        model.init_weights(6, "kaiming")
        draws = model.draw_probes((CROP,) * 3, torch.Generator().manual_seed(1))
        losses, fake, gg, dg = model.gradients(torch.from_numpy(_real(4)), draws)
        outs[remat] = (losses, fake, list(gg) + list(dg))
    (l0, f0, g0), (l1, f1, g1) = outs[False], outs[True]
    assert all(torch.equal(l0[k], l1[k]) for k in LOSS_NAMES)
    assert torch.equal(f0, f1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def _counting(monkeypatch, counts):
    for name, fn in KERNELS.items():
        module = conv3x3 if name == "conv3x3" else wconv if name.startswith("wconv") else inorm

        def wrap(*a, _fn=fn, _name=name, **k):
            counts[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(module, fn.__name__, functools.update_wrapper(wrap, fn))


@pytest.mark.parametrize("remat, table", [(False, "DRYOPS_STEP_LAUNCHES"),
                                          (True, "DRYOPS_REMAT_STEP_LAUNCHES")])
def test_wrapper_calls_per_step_are_the_smokes_tables(monkeypatch, remat, table):
    counts = dict.fromkeys(KERNELS, 0)
    _counting(monkeypatch, counts)
    model = _port({}, precision="bfloat16", remat=remat)
    model.init_weights(2, "kaiming")
    draws = model.draw_probes((CROP,) * 3, torch.Generator().manual_seed(3))
    losses, *_ = model.gradients(torch.from_numpy(_real(5)), draws)
    assert all(torch.isfinite(v) for v in losses.values())
    assert counts == getattr(chip_smoke, table)
