"""The port's Athena step (neuroclear_tpu_torch/models/
axial_to_lateral_gan_athena_model.py) against the JAX package's
``make_athena_step`` on the CPU, one step (tests/test_torch_athena_more.py
has the accumulation): full-width nets (UNetDeconv,
DeepLinearGenerator, six NLayerDiscriminators), 24^3 crops (every probe a
batch of 24 slices), f32, on JAX-initialised Kaiming weights and on the
study's trained nets (``study_state/athena148``, iteration 501), for the
study's ``--conversion_plane yz xy`` and for ``xz yz``; remat bitwise, the
D step's real-side axes, the resume from the study's nets with the
optimizer state, and the kernel wrappers' calls per step against
``chip_smoke.py``'s tables.

The JAX side is the package unmodified; its step is built with an optax
transformation that returns zero updates and keeps the gradients it is
given as its state, so the step hands back exactly its gradients (with
``--grad_accum 2``, the mean that ``grad_accum_scan`` gives).

Bars, as for Apollo (tests/test_torch_train_step.py): losses rtol 1e-4;
fake and rec rtol 1e-4; the discriminators' and G_B's gradients within 1e-3
relative L2 per tensor, G_A's within 1e-2 (a ReLU mask in the U-Net may
flip where the two packages' f32 forwards differ by ~1e-5, which moves every
G_A gradient below it by a few 1e-3; JAX's jitted step and its own op-by-op
VJP differ the same way); biases before an instance norm (true gradient 0)
within 1e-5 of their layer's weight gradient norm.

One measured exception, the discriminators, held at 1e-2: each probe is a
batch of 24 slices, and the last norm of the PatchGAN normalises 2 x 2
outputs per slice and channel, where f32 rounding is amplified.  On JAX's
own fake and rec, against the port's float64 evaluation, the JAX step's D
gradients lie up to 3.4e-3 off (D_A_xy at the trained weights), the port's
f32 ones within 5.1e-4 (measured on this suite's inputs): so the port is
held to 1e-3 of its own float64 D step, and to 1e-2 of JAX's.  G_B's
gradients come back through the same discriminators (up to 4.8e-3 off at
the trained weights) and are held at 1e-2 too.
"""

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
from neuroclear_tpu.models.axial_to_lateral_gan_athena_model import make_athena_step
from neuroclear_tpu.nn import factory as jax_factory
from neuroclear_tpu.nn.core import flatten_params, unflatten_params
from neuroclear_tpu_torch.models import create_model
from neuroclear_tpu_torch.models.axial_to_lateral_gan_athena_model import (
    D_NAMES, D_PAIRS, G_NAMES, LOSS_NAMES, MODEL_NAMES, PLANE_TO_AXIS, plane_axes)
from neuroclear_tpu_torch.ops import KERNELS, conv3x3, inorm, wconv
from neuroclear_tpu_torch.options import train_options
from neuroclear_tpu_torch.utils.weights import flat_from_module, load_npz

CROP, LAMBDA_A = 24, 5.0
STUDY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "study_state", "athena148")
PRE_NORM = ("double_conv", "bottom_layer", "ex_double_conv2", "ex_conv1_1",
            "conv1", "conv2", "conv3")
G_A_REL_L2 = 1e-2
D_REL_L2 = 1e-2  # against JAX; 1e-3 against float64 (see the module docstring)


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One CPU thread for torch and BLAS (six workers share the cores)."""
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


def _argv(planes, precision="float32", remat=False, extra=()):
    return ["--dataroot", "unused", "--model", "axial_to_lateral_gan_athena",
            "--conversion_plane", *planes, "--gan_mode", "lsgan", "--lambda_A", str(LAMBDA_A),
            "--precision", precision, "--device", "cpu", *(["--remat"] if remat else []),
            *extra]


def _port(planes, flats, **kw):
    argv = _argv(planes, **kw)
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
def _jax_nets():
    nets = {"G_A": jax_factory.define_G(1, 1, 64, "unet_deconv", "instance", dimension=3),
            "G_B": jax_factory.define_G(1, 1, 64, "deep_linear_gen", "instance", dimension=3)}
    for name in D_NAMES:
        nets[name] = jax_factory.define_D(1, 64, "basic", 3, "instance", dimension=2)
    return nets


def _weights(kind, nets) -> dict:
    """{NAME: JAX param tree}: Kaiming from a JAX key, or the study's nets."""
    if kind == "trained":
        return {n: unflatten_params(load_npz(os.path.join(STUDY, f"iter_501_net_{n}.npz")))
                for n in MODEL_NAMES}
    keys = jax.random.split(jax.random.PRNGKey(0), len(MODEL_NAMES))
    return {n: nets[n].init(k, "kaiming", 0.02) for n, k in zip(MODEL_NAMES, keys)}


@functools.lru_cache(maxsize=None)
def _jax_step_fn(planes, accum):
    """The JAX step for ``planes`` and ``accum`` (compiled once per pair)
    and its optimizer."""
    axes = plane_axes(planes)
    cfg = jgc.GanStepConfig(gan_mode="lsgan", lambda_A=LAMBDA_A, lambda_plane=(1, 1, 1),
                            precision="float32", grad_accum=accum)
    optim = _capture()
    return make_athena_step(_jax_nets(), optim, cfg,
                            (axes["target"], axes["source"], axes["remain"])), optim


def _jax_step(params, planes, real, accum=1):
    """(losses, fake, rec, g_grads, d_grads) of one JAX step."""
    step, optim = _jax_step_fn(tuple(planes), accum)
    copy = lambda tree: jax.tree.map(lambda a: jnp.array(a, copy=True), tree)  # noqa: E731
    gp = copy({k: params[k] for k in G_NAMES})  # the step donates its inputs
    dp = copy({k: params[k] for k in D_NAMES})
    state = {"G": optim.init(gp), "D": optim.init(dp)}
    _, _, state, losses, fake, rec = step(gp, dp, state, jnp.asarray(real), jnp.float32(1e-4))
    return ({k: float(v) for k, v in losses.items()}, np.asarray(fake), np.asarray(rec),
            _jax_flat(state["G"], G_NAMES), _jax_flat(state["D"], D_NAMES))


def _real(seed, n=1):
    return np.random.default_rng(seed).random((n, CROP, CROP, CROP, 1)).astype(np.float32)


CASES = {"random yz xy": ("random", ("yz", "xy")), "trained yz xy": ("trained", ("yz", "xy")),
         "random xz yz": ("random", ("xz", "yz"))}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    kind, planes = CASES[request.param]
    params = _weights(kind, _jax_nets())
    real = _real(1)
    jl, jfake, jrec, jg, jd = _jax_step(params, planes, real)
    model = _port(planes, {n: flatten_params(params[n]) for n in MODEL_NAMES})
    losses, fake, rec, gg, dg = model.gradients(torch.from_numpy(real))
    # the D step on JAX's own fake and rec
    total, _ = model.d_loss(*(torch.tensor(a) for a in (real, jfake, jrec)))
    dg_on_jax = torch.autograd.grad(total, model.d_params)
    for n in D_NAMES:
        model.nets[n].double()
    total, _ = model.d_loss(*(torch.from_numpy(a).double() for a in (real, jfake, jrec)))
    dg_f64 = torch.autograd.grad(total, model.d_params)
    return dict(jl=jl, jfake=jfake, jrec=jrec, jg=jg, jd=jd, losses=losses,
                fake=fake.numpy(), rec=rec.numpy(), pg=_flat_of(model, G_NAMES, gg),
                pd=_flat_of(model, D_NAMES, dg), pd_on_jax=_flat_of(model, D_NAMES, dg_on_jax),
                pd_f64=_flat_of(model, D_NAMES, dg_f64))


def _is_pre_norm_bias(key: str) -> bool:
    parts = key.split(".")
    return parts[-1] == "b" and any(p.startswith(PRE_NORM) for p in parts[1:-1])


def _assert_grads(port: dict, ref: dict, rel_l2: float) -> None:
    assert set(port) == set(ref)
    bad = {}
    for k in ref:
        a, b = ref[k], port[k]
        if _is_pre_norm_bias(k):
            assert np.abs(a - b).max() <= 1e-5 * np.linalg.norm(ref[k[:-1] + "w"]), k
            continue
        err = np.linalg.norm(a - b) / np.linalg.norm(a)
        if not err <= rel_l2:
            bad[k] = err
    assert not bad, bad


def test_losses_match_jax(case):
    assert set(case["jl"]) == set(LOSS_NAMES)
    for name in LOSS_NAMES:
        assert float(case["losses"][name]) == pytest.approx(case["jl"][name], rel=1e-4), name


def test_fake_and_rec_match_jax(case):
    for port, ref in ((case["fake"], case["jfake"]), (case["rec"], case["jrec"])):
        np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_discriminator_gradients_on_jaxs_fake_and_rec_match_jax_and_float64(case):
    _assert_grads(case["pd_on_jax"], case["pd_f64"], 1e-3)
    _assert_grads(case["pd_on_jax"], case["jd"], D_REL_L2)


def test_discriminator_and_backward_generator_gradients_match_jax(case):
    _assert_grads(case["pd"], case["jd"], D_REL_L2)
    g_b = {k: v for k, v in case["pg"].items() if k.startswith("G_B.")}
    _assert_grads(g_b, {k: case["jg"][k] for k in g_b}, D_REL_L2)


def test_forward_generator_gradients_match_jax(case):
    g_a = {k: v for k, v in case["pg"].items() if k.startswith("G_A.")}
    _assert_grads(g_a, {k: case["jg"][k] for k in g_a}, G_A_REL_L2)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_remat_step_is_bitwise_the_step_without(precision):
    outs = {}
    for remat in (False, True):
        model = _port(("yz", "xy"), {}, precision=precision, remat=remat)
        model.init_weights(5, "kaiming")
        losses, fake, rec, gg, dg = model.gradients(torch.from_numpy(_real(3)))
        outs[remat] = (losses, fake, rec, list(gg) + list(dg))
    (l0, f0, r0, g0), (l1, f1, r1, g1) = outs[False], outs[True]
    assert all(torch.equal(l0[k], l1[k]) for k in LOSS_NAMES)
    assert torch.equal(f0, f1) and torch.equal(r0, r1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_d_step_real_axes_are_the_jax_steps():
    """D_A_* all probe the real crop on the target axis; D_B_yz on the
    source and D_B_xz on the remaining axis (make_athena_step.d_loss_fn)."""
    assert D_PAIRS == [("D_A_xy", "target", "fake", "target"),
                       ("D_A_yz", "target", "fake", "source"),
                       ("D_A_xz", "target", "fake", "remain"),
                       ("D_B_xy", "target", "rec", "target"),
                       ("D_B_yz", "source", "rec", "source"),
                       ("D_B_xz", "remain", "rec", "remain")]
    assert plane_axes(("yz", "xy")) == {"source": 2, "target": 0, "remain": 1}
    assert PLANE_TO_AXIS == {"xy": 0, "xz": 1, "yz": 2}


def test_resume_from_the_study_restores_nets_and_optimizer_bit_for_bit(tmp_path):
    """``--continue_train --load_iter 501`` from study_state/athena148: the
    eight nets and the Adam state (the JAX layout, D then G) read back
    equal to the files."""
    os.makedirs(tmp_path / "athena148")
    for f in os.listdir(STUDY):
        os.symlink(os.path.join(STUDY, f), tmp_path / "athena148" / f)
    argv = _argv(("yz", "xy"), extra=["--checkpoints_dir", str(tmp_path), "--name", "athena148",
                                      "--continue_train", "--load_iter", "501",
                                      "--lr_policy", "constant"])
    opt = train_options.build_parser(argv).parse_args(argv)
    model = create_model(opt, "cpu")
    model.setup(opt)
    for n in MODEL_NAMES:
        want = load_npz(os.path.join(STUDY, f"iter_501_net_{n}.npz"))
        got = flat_from_module(model.nets[n])
        assert set(got) == set(want)
        assert all(np.array_equal(got[k], want[k]) for k in want), n
    with np.load(os.path.join(STUDY, "iter_501_optim.npz")) as data:
        want = {k: data[k] for k in data.files}
    got = model.optim_arrays()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _counting(monkeypatch, counts):
    for name, fn in KERNELS.items():
        module = conv3x3 if name == "conv3x3" else wconv if name.startswith("wconv") else inorm

        def wrap(*a, _fn=fn, _name=name, **k):
            counts[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(module, fn.__name__, functools.update_wrapper(wrap, fn))


@pytest.mark.parametrize("remat, table", [(False, "ATHENA_STEP_LAUNCHES"),
                                          (True, "ATHENA_REMAT_STEP_LAUNCHES")])
def test_wrapper_calls_per_step_are_the_smokes_tables(monkeypatch, remat, table):
    """One bf16 crop's step calls each kernel wrapper as often as
    chip_smoke.py asserts its launches on the card."""
    counts = dict.fromkeys(KERNELS, 0)
    _counting(monkeypatch, counts)
    model = _port(("yz", "xy"), {}, precision="bfloat16", remat=remat)
    model.init_weights(1, "kaiming")
    losses, *_ = model.gradients(torch.from_numpy(_real(4)))
    assert all(torch.isfinite(v) for v in losses.values())
    assert counts == getattr(chip_smoke, table)
