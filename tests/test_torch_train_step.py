"""The port's Apollo training step (neuroclear_tpu_torch/models/
axial_to_lateral_gan_apollo_model.py) against the JAX package's step on the
CPU: full-width nets (UNetDeconv, DeepLinearGenerator, four
NLayerDiscriminators) on JAX-initialised weights, a 24^3 crop (the smallest
cube the five-conv discriminator takes down to 1x1), projection depth up to
4, f32.

The JAX side is the package unmodified: ``make_apollo_step`` built with
``GanStepConfig(grad_accum=2, accum_host=True)`` exposes its per-crop
program ``host_step._micro``, which returns exactly one crop's losses,
fake, rec and gradients under the step's keys.  The port's probe draws are
derived here from the same key, as ``build_loss_fns`` splits it.

Bars: losses rtol 1e-4; fake and rec rtol 1e-4 (the U-Net's own bar,
tests/test_torch_unet.py); every gradient tensor within 1e-3 relative L2.
The biases of convs followed by an instance norm have a true gradient of 0;
both packages give f32 rounding noise there (~1e-7 against weight gradients
of norm ~10), so those are held to an absolute 1e-5 of their layer's weight
gradient norm instead.

One measured exception, G_A: a ReLU makes the gradient a discontinuous
function of the forward values.  The two packages' f32 forwards differ by up
to 2e-5 at ex_double_conv2's first norm, and one of its 221,184
pre-activations lies within that of 0, so its ReLU mask differs: that one
voxel-channel's gradient is routed differently, and every G_A gradient
below it moves by ~5e-3 relative L2.  JAX's jitted step and the same JAX
VJP run op by op differ from each other the same way (5.3e-3).  So G_A is
held at 1e-2 against the step, and the cotangent it receives at ``fake``
(through G_B, the probes and the frozen discriminators) at 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from neuroclear_tpu.models import gan_common as jgc
from neuroclear_tpu.models.axial_to_lateral_gan_apollo_model import make_apollo_step
from neuroclear_tpu.models.base_model import BaseModel as JaxBaseModel
from neuroclear_tpu.nn import factory as jax_factory
from neuroclear_tpu.nn.core import flatten_params
from neuroclear_tpu.nn.losses import l1_loss as jax_l1
from neuroclear_tpu_torch.options import train_options
from neuroclear_tpu_torch.models.axial_to_lateral_gan_apollo_model import (
    D_NAMES, D_PROBES, G_NAMES, G_PROBES, LOSS_NAMES, MODEL_NAMES, ApolloModel, ProbeDraws)
from neuroclear_tpu_torch.utils.weights import params_from_numpy

CROP, DEPTH, LR, BETA1, LAMBDA_A = 24, 4, 1e-4, 0.1, 5.0
PRE_NORM = ("double_conv", "bottom_layer", "ex_double_conv2", "ex_conv1_1",
            "conv1", "conv2", "conv3")
G_A_REL_L2 = 1e-2  # G_A against the step, see the module docstring


def _is_pre_norm_bias(key: str) -> bool:
    parts = key.split(".")
    return parts[-1] == "b" and any(p.startswith(PRE_NORM) for p in parts[1:-1])


def _opt(precision="float32"):
    return train_options.build_parser().parse_args(
        ["--dataroot", "unused", "--gan_mode", "lsgan", "--lambda_A", str(LAMBDA_A),
         "--projection_depth", str(DEPTH),
         "--randomize_projection_depth", "--precision", precision, "--lr", str(LR),
         "--beta1", str(BETA1)])


def _port_flat(model, names, grads) -> dict:
    """Gradients in the order of the model's parameters -> {NAME.path.w/b:
    array in the JAX layout}."""
    out = {}
    named = [(n, pn) for n in names for pn, _ in model.nets[n].named_parameters()]
    for (n, pn), g in zip(named, grads):
        prefix, leaf = pn.rsplit(".", 1)
        layer = model.nets[n].get_submodule(prefix)
        arr = layer.weight_to_jax(g) if leaf == "weight" else g
        out[f"{n}.{prefix}.{'w' if leaf == 'weight' else 'b'}"] = \
            arr.detach().double().numpy()
    return out


def _jax_flat(tree: dict, names) -> dict:
    return {f"{n}.{k}": np.asarray(v, np.float64) for n in names
            for k, v in flatten_params(tree[n]).items()}


@pytest.fixture(scope="module")
def case():
    nets = {"G_A": jax_factory.define_G(1, 1, 64, "unet_deconv", "instance", dimension=3),
            "G_B": jax_factory.define_G(1, 1, 64, "deep_linear_gen", "instance", dimension=3)}
    for name in D_NAMES:
        nets[name] = jax_factory.define_D(1, 64, "basic", 3, "instance", dimension=2)
    keys = jax.random.split(jax.random.PRNGKey(0), len(MODEL_NAMES) + 1)
    params = {n: nets[n].init(keys[i], "kaiming", 0.02) for i, n in enumerate(MODEL_NAMES)}
    cfg = jgc.GanStepConfig(gan_mode="lsgan", lambda_A=LAMBDA_A, lambda_plane=(1, 1, 1),
                            randomize_projection_depth=True, projection_depth=DEPTH,
                            min_projection_depth=2, beta1=BETA1, precision="float32",
                            grad_accum=2, accum_host=True)
    host_step = make_apollo_step(nets, jgc.make_adam(BETA1), cfg)
    rng = keys[-1]
    real = np.random.default_rng(1).random((1, CROP, CROP, CROP, 1)).astype(np.float32)
    gp = {k: params[k] for k in G_NAMES}
    dp = {k: params[k] for k in D_NAMES}
    zeros = lambda t: jax.tree.map(jnp.zeros_like, t)  # noqa: E731
    g_acc, d_acc, aux, fake, rec = host_step._micro(gp, dp, zeros(gp), zeros(dp), rng,
                                                    jnp.asarray(real))

    # the step's draws, as build_loss_fns and ops/sampling.py make them
    k_depth, k_g, k_d = jax.random.split(rng, 3)
    depth = int(jax.random.randint(k_depth, (), 2, DEPTH + 1))

    def draw(plan, ks):
        return tuple(int(jax.random.randint(k, (), 0, CROP - depth if kind == "proj" else CROP))
                     for (kind, _, _, _), k in zip(plan, ks))

    kg = jax.random.split(k_g, 6)
    draws = ProbeDraws(depth, draw(G_PROBES, kg), draw(D_PROBES, jax.random.split(k_d, 12)))

    # JAX op by op: the cotangent at fake (the G loss from fake on, as
    # g_loss_fn computes it)
    lam_t, lam_s, _ = cfg.lambda_norm
    d_apply = {k: (lambda k_: lambda x: nets[k_].apply(params[k_], x))(k) for k in D_NAMES}

    def loss_from_fake(fk):
        rc = nets["G_B"].apply(params["G_B"], fk)
        t = [jgc.g_gan(jgc.probe_proj(kg[i], fk, axis, depth, d_apply[d]), cfg)
             for i, axis, d in ((0, 0, "D_A_lateral"), (1, 1, "D_A_axial"),
                                (2, 2, "D_A_axial"))]
        t += [jgc.g_gan(jgc.probe_slice(kg[i], rc, axis, d_apply[d]), cfg)
              for i, axis, d in ((3, 0, "D_B_lateral"), (4, 1, "D_B_axial"),
                                 (5, 2, "D_B_axial"))]
        g_a = t[0] * lam_t + (t[1] * lam_s + t[2] * lam_s) * 0.5
        g_b = t[3] * lam_t + (t[4] * lam_s + t[5] * lam_s) * 0.5
        return g_a + g_b + jax_l1(rc, jnp.asarray(real)) * cfg.lambda_A

    h_jax = np.asarray(jax.grad(loss_from_fake)(fake))

    model = ApolloModel(_opt(), "cpu")
    model.load_flats({n: flatten_params(params[n]) for n in MODEL_NAMES})
    losses, pfake, prec, gg, dg = model.gradients(torch.from_numpy(real), draws)
    return dict(nets=nets, params=params, rng=rng, real=real, draws=draws, aux=aux,
                host_step=host_step,
                fake=np.asarray(fake), rec=np.asarray(rec), g_acc=g_acc, d_acc=d_acc,
                h_jax=h_jax, model=model, losses=losses, pfake=pfake.numpy(),
                prec=prec.numpy(), pg=_port_flat(model, G_NAMES, gg),
                pd=_port_flat(model, D_NAMES, dg),
                jg=_jax_flat(g_acc, G_NAMES), jd=_jax_flat(d_acc, D_NAMES))


def _assert_grads(port: dict, ref: dict, rel_l2: float) -> None:
    assert set(port) == set(ref)
    worst = {}
    for k in ref:
        a, b = ref[k], port[k]
        if _is_pre_norm_bias(k):
            w = ref[k[:-1] + "w"]
            assert np.abs(a - b).max() <= 1e-5 * np.linalg.norm(w), k
            continue
        worst[k] = np.linalg.norm(a - b) / np.linalg.norm(a)
    bad = {k: v for k, v in worst.items() if v > rel_l2}
    assert not bad, bad


def test_losses_match_jax(case):
    for name in LOSS_NAMES:
        assert float(case["losses"][name]) == pytest.approx(float(case["aux"][name]), rel=1e-4)


def test_fake_and_rec_match_jax(case):
    for port, ref in ((case["pfake"], case["fake"]), (case["prec"], case["rec"])):
        np.testing.assert_allclose(port, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_discriminator_and_backward_generator_gradients_match_jax(case):
    _assert_grads(case["pd"], case["jd"], 1e-3)
    g_b = {k: v for k, v in case["pg"].items() if k.startswith("G_B.")}
    _assert_grads(g_b, {k: case["jg"][k] for k in g_b}, 1e-3)


def test_forward_generator_gradients_match_jax(case):
    """G_A: the cotangent at fake within 1e-4 of JAX's, the gradients within
    1e-2 of the step's (see the module docstring)."""
    model, real = case["model"], torch.from_numpy(case["real"])
    fake = torch.tensor(case["fake"], requires_grad=True)
    total, _, _ = model.g_loss_given_fake(real, fake, case["draws"])
    (h,) = torch.autograd.grad(total, fake)
    h_jax = case["h_jax"]
    assert np.linalg.norm(h.numpy() - h_jax) <= 1e-4 * np.linalg.norm(h_jax)
    g_a = {k: v for k, v in case["pg"].items() if k.startswith("G_A.")}
    _assert_grads(g_a, {k: case["jg"][k] for k in g_a}, G_A_REL_L2)


def test_adam_matches_optax_on_identical_gradients(case):
    """One Adam step of both parameter sets from the JAX step's gradients:
    torch.optim.Adam against make_adam + apply_updates."""
    params = case["params"]
    model = ApolloModel(_opt(), "cpu")
    model.load_flats({n: flatten_params(params[n]) for n in MODEL_NAMES})
    grads = {}
    for names, acc in ((G_NAMES, case["g_acc"]), (D_NAMES, case["d_acc"])):
        for n in names:
            grads[n] = params_from_numpy(flatten_params(acc[n]), model.nets[n])
    g_grads = [grads[n][pn] for n in G_NAMES for pn, _ in model.nets[n].named_parameters()]
    d_grads = [grads[n][pn] for n in D_NAMES for pn, _ in model.nets[n].named_parameters()]
    model.apply_gradients(g_grads, d_grads)
    optim = jgc.make_adam(BETA1)
    for names, acc in ((G_NAMES, case["g_acc"]), (D_NAMES, case["d_acc"])):
        p = {n: params[n] for n in names}
        updates, _ = optim.update({n: acc[n] for n in names}, optim.init(p))
        new = _jax_flat(jgc.apply_updates(p, updates, LR), names)
        port = _port_flat(model, names, [q for n in names for q in model.nets[n].parameters()])
        for k, ref in new.items():
            # atol 1e-5 * lr: the update of a parameter whose gradient is
            # near eps (the pre-norm biases' noise) divides by |g| + 1e-8
            np.testing.assert_allclose(port[k], ref, rtol=1e-6, atol=1e-5 * LR, err_msg=k)


class _JaxCheckpoints(JaxBaseModel):
    """The JAX package's checkpoint code (``BaseModel.save_networks`` and
    ``_save_optim``, which its Apollo model inherits) around given
    parameters and Adam state."""

    def __init__(self, save_dir, params, opt_state):
        self.save_dir, self.params, self.opt_state = str(save_dir), params, opt_state
        self.model_names, self.lr_controllers = list(MODEL_NAMES), []

    set_input = forward = optimize_parameters = None


def test_next_step_from_a_jax_optimizer_state_matches_jax(case, tmp_path):
    """Resume across the packages: the JAX step's own update (Adam from a
    fresh state on its gradients), written by the JAX checkpoint code as
    iter_1 with its optimizer state, loads in the port; then each package
    takes the next step from there with the same crop and draws.  Its
    gradients agree at this file's bounds, and the port's Adam update from
    the loaded state, on the JAX step's gradients, equals optax's within
    2e-5 * lr (optax takes the bias corrections in float32, where
    1 - 0.999**2 keeps ~1e-5 relative; torch in float64)."""
    params, optim = case["params"], jgc.make_adam(BETA1)
    state1, params1 = {}, {}
    for key, names, acc in (("G", G_NAMES, case["g_acc"]), ("D", D_NAMES, case["d_acc"])):
        p = {n: params[n] for n in names}
        updates, state1[key] = optim.update({n: acc[n] for n in names}, optim.init(p))
        params1.update(jgc.apply_updates(p, updates, LR))
    _JaxCheckpoints(tmp_path, params1, state1).save_networks("iter_1")

    model = ApolloModel(_opt(), "cpu")
    model.save_dir = str(tmp_path)
    model.load_networks("iter_1")
    start = _jax_flat(params1, MODEL_NAMES)
    before = {**_port_flat(model, G_NAMES, list(model.g_params)),
              **_port_flat(model, D_NAMES, list(model.d_params))}
    for k, v in start.items():
        np.testing.assert_array_equal(before[k], v, err_msg=k)
    _, _, _, gg, dg = model.gradients(torch.from_numpy(case["real"]), case["draws"])

    zeros = lambda t: jax.tree.map(jnp.zeros_like, t)  # noqa: E731
    gp = {k: params1[k] for k in G_NAMES}
    dp = {k: params1[k] for k in D_NAMES}
    g_acc, d_acc, _, _, _ = case["host_step"]._micro(gp, dp, zeros(gp), zeros(dp), case["rng"],
                                                     jnp.asarray(case["real"]))
    pg, jg = _port_flat(model, G_NAMES, gg), _jax_flat(g_acc, G_NAMES)
    _assert_grads(_port_flat(model, D_NAMES, dg), _jax_flat(d_acc, D_NAMES), 1e-3)
    _assert_grads({k: v for k, v in pg.items() if k.startswith("G_B.")},
                  {k: v for k, v in jg.items() if k.startswith("G_B.")}, 1e-3)
    _assert_grads({k: v for k, v in pg.items() if k.startswith("G_A.")},
                  {k: v for k, v in jg.items() if k.startswith("G_A.")}, G_A_REL_L2)

    # Adam from the loaded state on the JAX step's gradients
    grads = {}
    for names, acc in ((G_NAMES, g_acc), (D_NAMES, d_acc)):
        for n in names:
            grads[n] = params_from_numpy(flatten_params(acc[n]), model.nets[n])
    model.apply_gradients(*[[grads[n][pn] for n in names
                             for pn, _ in model.nets[n].named_parameters()]
                            for names in (G_NAMES, D_NAMES)])
    for key, names, acc in (("G", G_NAMES, g_acc), ("D", D_NAMES, d_acc)):
        p = {n: params1[n] for n in names}
        updates, _ = optim.update({n: acc[n] for n in names}, state1[key])
        ref = _jax_flat(jgc.apply_updates(p, updates, LR), names)
        port = _port_flat(model, names, [q for n in names for q in model.nets[n].parameters()])
        for k, r in ref.items():
            np.testing.assert_allclose(port[k], r, rtol=1e-6, atol=2e-5 * LR, err_msg=k)


def _nets_rel_l2(a: dict, b: dict, nets) -> float:
    """Relative L2 over every tensor of ``nets`` but the pre-norm biases."""
    keys = [k for k in b if k.split(".")[0] in nets and not _is_pre_norm_bias(k)]
    num = sum(np.sum((a[k] - b[k]) ** 2) for k in keys)
    return float(np.sqrt(num / sum(np.sum(b[k] ** 2) for k in keys)))


def test_bf16_step_is_bounded_by_the_f32_step(case):
    """The same step in bf16 (f32 master weights, the kernels' plain
    versions on the CPU) against the f32 step, beside the JAX package's own
    bf16 step against its f32 step on the same inputs.  bf16 moves this
    random-weight step a lot (measured: G_A's gradients 35% relative L2 from
    f32 in both packages, through ~40 roundings and ReLU masks that flip),
    so the bar is relative to JAX's: per loss, the port's distance from f32
    at most twice JAX's plus 1% of the loss; for G_A, for G_B and for the
    four discriminators pooled (all their tensors but the pre-norm biases,
    which are noise), at most 1.5 times JAX's plus 0.02.  The
    discriminators are pooled because each one's error is a single draw of
    the same noise: measured per net, the port's was 0.6 to 2 times JAX's,
    either way round."""
    nets, params = case["nets"], case["params"]
    cfg = jgc.GanStepConfig(gan_mode="lsgan", lambda_A=LAMBDA_A, lambda_plane=(1, 1, 1),
                            randomize_projection_depth=True, projection_depth=DEPTH,
                            min_projection_depth=2, beta1=BETA1, precision="bfloat16",
                            grad_accum=2, accum_host=True)
    host_step = make_apollo_step(nets, jgc.make_adam(BETA1), cfg)
    gp = {k: params[k] for k in G_NAMES}
    dp = {k: params[k] for k in D_NAMES}
    zeros = lambda t: jax.tree.map(jnp.zeros_like, t)  # noqa: E731
    g_acc, d_acc, aux, _, _ = host_step._micro(gp, dp, zeros(gp), zeros(dp), case["rng"],
                                               jnp.asarray(case["real"]))
    jax_bf16 = {**_jax_flat(g_acc, G_NAMES), **_jax_flat(d_acc, D_NAMES)}
    jax_f32 = {**case["jg"], **case["jd"]}

    model = ApolloModel(_opt("bfloat16"), "cpu")
    model.load_flats({n: flatten_params(params[n]) for n in MODEL_NAMES})
    losses, fake, rec, gg, dg = model.gradients(torch.from_numpy(case["real"]), case["draws"])
    assert fake.dtype == torch.bfloat16 and rec.dtype == torch.bfloat16
    for name in LOSS_NAMES:
        ref = float(case["losses"][name])
        jax_err = abs(float(aux[name]) - float(case["aux"][name]))
        assert abs(float(losses[name]) - ref) <= 2 * jax_err + 1e-2 * abs(ref), name
    port_bf16 = {**_port_flat(model, G_NAMES, gg), **_port_flat(model, D_NAMES, dg)}
    port_f32 = {**case["pg"], **case["pd"]}
    for nets in (["G_A"], ["G_B"], D_NAMES):
        port_err = _nets_rel_l2(port_bf16, port_f32, nets)
        jax_err = _nets_rel_l2(jax_bf16, jax_f32, nets)
        assert port_err <= 1.5 * jax_err + 0.02, (nets, port_err, jax_err)


def test_probe_draws_fit_the_crop():
    """The trainer's own draws: depth in [2, projection_depth], window starts
    in [0, n - depth), slice indices in [0, n)."""
    model = ApolloModel(_opt(), "cpu")
    gen = torch.Generator().manual_seed(0)
    for _ in range(50):
        d = model.draw_probes((CROP, 20, 16), gen)
        assert 2 <= d.depth <= DEPTH
        for plan, pos in ((G_PROBES, d.g), (D_PROBES, d.d)):
            for (kind, _, axis, _), p in zip(plan, pos):
                n = (CROP, 20, 16)[axis]
                assert 0 <= p < (n - d.depth if kind == "proj" else n)


@pytest.fixture
def one_cpu_thread():
    """One CPU thread for torch and BLAS: with a thread per core in each of
    the suite's six workers these steps run tens of times slower than alone
    (a 24^3 bf16 study step: 250 s against 5 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _fresh_model(case, precision="float32"):
    model = ApolloModel(_opt(precision), "cpu")
    model.load_flats({n: flatten_params(case["params"][n]) for n in MODEL_NAMES})
    return model


def _second_crop():
    return np.random.default_rng(2).random((1, CROP, CROP, CROP, 1)).astype(np.float32)


@pytest.mark.usefixtures("one_cpu_thread")
def test_accumulated_step_matches_jax_host_step(case):
    """--grad_accum 2 on two crops under one step's draws: the JAX
    ``host_step`` itself against the port's ``accumulate`` and update.  The
    mean losses at rtol 1e-4; the summed gradients (two ``_micro`` calls
    from zero, as ``host_step`` adds them) at this file's bars; the update:
    the port's Adam on the JAX step's mean gradients equals ``host_step``'s
    parameters within 2e-5 * lr (the recorded Adam deviation), so the
    port's own step lies from JAX's by no more than its gradients explain
    (the port's Adam on the JAX gradients against on its own) plus that."""
    crops = np.concatenate([case["real"], _second_crop()])
    copy = lambda t: jax.tree.map(jnp.array, t)  # noqa: E731 (host_step donates)
    gp = {k: case["params"][k] for k in G_NAMES}
    dp = {k: case["params"][k] for k in D_NAMES}
    optim = jgc.make_adam(BETA1)
    state = {"G": optim.init(gp), "D": optim.init(dp)}
    g_new, d_new, _, jax_losses, _, _ = case["host_step"](
        copy(gp), copy(dp), copy(state), case["rng"], jnp.asarray(crops), np.float32(LR))
    jax_after = _jax_flat({**g_new, **d_new}, MODEL_NAMES)
    zeros = lambda t: jax.tree.map(jnp.zeros_like, t)  # noqa: E731
    g_sum, d_sum = zeros(gp), zeros(dp)
    for i in range(2):
        g_sum, d_sum, _, _, _ = case["host_step"]._micro(gp, dp, g_sum, d_sum, case["rng"],
                                                         jnp.asarray(crops[i:i + 1]))

    model = _fresh_model(case)
    losses, real, _, _, gg, dg = model.accumulate(lambda i: torch.from_numpy(crops[i:i + 1]), 2,
                                                  case["draws"])
    assert torch.equal(real, torch.from_numpy(crops[1:2]))
    for name in LOSS_NAMES:
        assert float(losses[name]) == pytest.approx(float(jax_losses[name]), rel=1e-4), name
    pg = {k: 2 * v for k, v in _port_flat(model, G_NAMES, gg).items()}
    pd = {k: 2 * v for k, v in _port_flat(model, D_NAMES, dg).items()}
    jg, jd = _jax_flat(g_sum, G_NAMES), _jax_flat(d_sum, D_NAMES)
    _assert_grads(pd, jd, 1e-3)
    _assert_grads({k: v for k, v in pg.items() if k.startswith("G_B.")},
                  {k: v for k, v in jg.items() if k.startswith("G_B.")}, 1e-3)
    _assert_grads({k: v for k, v in pg.items() if k.startswith("G_A.")},
                  {k: v for k, v in jg.items() if k.startswith("G_A.")}, G_A_REL_L2)

    model.apply_gradients(gg, dg)
    port_after = {**_port_flat(model, G_NAMES, list(model.g_params)),
                  **_port_flat(model, D_NAMES, list(model.d_params))}
    on_jax = _fresh_model(case)
    grads = {}
    for names, acc in ((G_NAMES, g_sum), (D_NAMES, d_sum)):
        for n in names:
            grads[n] = params_from_numpy({k: np.asarray(v) / 2 for k, v in
                                          flatten_params(acc[n]).items()}, on_jax.nets[n])
    on_jax.apply_gradients(*[[grads[n][pn] for n in names
                              for pn, _ in on_jax.nets[n].named_parameters()]
                             for names in (G_NAMES, D_NAMES)])
    on_jax_after = {**_port_flat(on_jax, G_NAMES, list(on_jax.g_params)),
                    **_port_flat(on_jax, D_NAMES, list(on_jax.d_params))}
    assert set(port_after) == set(jax_after)
    for k, ref in jax_after.items():
        np.testing.assert_allclose(on_jax_after[k], ref, rtol=1e-6, atol=2e-5 * LR, err_msg=k)
        explained = np.abs(port_after[k] - on_jax_after[k])
        assert np.all(np.abs(port_after[k] - ref)
                      <= explained + 2e-5 * LR + 1e-6 * np.abs(ref)), k


@pytest.mark.usefixtures("one_cpu_thread")
def test_accumulating_one_crop_twice_is_the_single_crop_step(case):
    """Accum-2 over one crop given twice is bitwise the accum-1 step: the
    accumulators hold 0 + g + g = 2g and (2g) / 2 = g exactly in f32, and the
    mean of two equal losses is the loss."""
    real = torch.from_numpy(case["real"])
    one, two = _fresh_model(case), _fresh_model(case)
    l1, _, _ = one.optimize_parameters(real, case["draws"])
    l2, _, _ = two.optimize_parameters_accum(lambda i: real, 2, case["draws"])
    for name in LOSS_NAMES:
        assert torch.equal(l1[name], l2[name]), name
    for p, q in zip(list(one.g_params) + list(one.d_params),
                    list(two.g_params) + list(two.d_params)):
        assert torch.equal(p, q)
    for oa, ob in ((one.optim_g, two.optim_g), (one.optim_d, two.optim_d)):
        for p, q in zip(oa.param_groups[0]["params"], ob.param_groups[0]["params"]):
            assert torch.equal(oa.state[p]["exp_avg"], ob.state[q]["exp_avg"])
            assert torch.equal(oa.state[p]["exp_avg_sq"], ob.state[q]["exp_avg_sq"])
