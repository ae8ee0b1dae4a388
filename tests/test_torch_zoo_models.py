"""The GAN step with the zoo's nets and norms (neuroclear_tpu_torch/models)
against the JAX package on the CPU, f32, with the probe draws the JAX keys
make handed to the port, on weights drawn by ``utils/weights.py::init_flat``
(Kaiming, random biases and batch-norm offsets) and carried to JAX:

  * Apollo with ``--netG unet_vanilla`` (16^3 crops: it pools three times,
    and at 8^3 its bottom norms see one voxel; a linear-kernel G_B and the
    pixel discriminator beside it);
  * ``--norm batch`` (Apollo with the production U-Net and the pixel
    discriminator at 16^3): the gradients of one step, then the running
    statistics after three steps, with and without ``--grad_accum 2``,
    against JAX's step followed by its ``BaseModel.refresh_norm_stats``;
    a checkpoint and its optimizer state written by either package loaded
    by the other, and the port's resume bit for bit;
  * ``--netD basic_SN`` and ``kernelGAN`` (with linear-kernel generators,
    24^3).

Each step's gradients are held directly against JAX's (``make_apollo_step``'s
micro-step): losses rtol 1e-4; fake and rec rtol 1e-4; per tensor relative
L2 1e-3, G_A's 1e-2 in the U-Net under the instance norm (a ReLU mask
flips where the two f32 forwards differ by ~1e-5, see
tests/test_torch_train_step.py; measured 1.3e-3 for the vanilla U-Net at
16^3.  At 24^3 with the production discriminators the JAX f32 step's
one-pass variance (E[x^2] - E[x]^2) through 14 norms put its own G_A
gradients 1.5e-2 and its G_A_axial loss 1.5e-4 off the port's, whose f32
forward lies 4x closer to JAX's op-by-op apply than the jitted step does:
hence the 16^3 crop.)  Biases before a norm (true gradient 0)
within 1e-5 of their layer's weight gradient norm; the JAX gradients of the
buffers (running statistics, spectral ``u``) exactly zero.  Running
statistics: rtol 1e-4 with an absolute floor of 2e-5, after three steps at
lr 1e-6: Adam moves every parameter by about lr whatever its gradient's
size, so a gradient entry that is noise (a bias before a norm, a small
entry of the 4^3 bottom block's weights) moves by up to 2 lr a step in
either direction; at lr 1e-4 that moved the bottom block's batch means by
2.3e-3 in three steps (measured), which would hide the refresh under the
optimizer's noise.

Then the kernel wrappers' calls per step against ``chip_smoke.py``'s
``VANILLA_STEP_LAUNCHES``, ``VANILLA_REMAT_STEP_LAUNCHES`` and
``BATCHNORM_STEP_LAUNCHES`` (bf16, counted as
tests/test_torch_dryops.py counts them), the vanilla step with ``--remat``
(one checkpoint around the whole net, JAX's fallback) bitwise the step
without.  One CPU thread."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import chip_smoke
from neuroclear_tpu.models import gan_common as jgc
from neuroclear_tpu.models.axial_to_lateral_gan_apollo_model import make_apollo_step
from neuroclear_tpu.models.base_model import BaseModel as JaxBaseModel
from neuroclear_tpu.nn import factory as jax_factory
from neuroclear_tpu.nn.core import flatten_params, unflatten_params
from neuroclear_tpu_torch.models.axial_to_lateral_gan_apollo_model import (
    D_NAMES, D_PROBES, G_NAMES, G_PROBES, LOSS_NAMES, MODEL_NAMES, ApolloModel, ProbeDraws)
from neuroclear_tpu_torch.nn.norms import BatchNorm
from neuroclear_tpu_torch.ops import KERNELS, conv3x3, inorm, wconv
from neuroclear_tpu_torch.options import train_options
from neuroclear_tpu_torch.utils.weights import init_flat, jax_leaves

DEPTH, LR, BETA1, LAMBDA_A = 4, 1e-4, 0.1, 5.0
STATS_LR = 1e-6  # the three-step running-statistics runs (see the docstring)
# modules whose bias reaches a norm through linear maps only (true gradient 0)
PRE_NORM = ("double_conv", "bottom_layer", "ex_double_conv", "ex_conv1_1", "conv1", "conv2",
            "conv3", "feat", "first_layer")
CONFIGS = {
    "vanilla": dict(netG="unet_vanilla", netG_B="linearkernel", netD="pixel",
                    norm="instance", crop=16),
    "batch": dict(netG="unet_deconv", netG_B="deep_linear_gen", netD="pixel", norm="batch",
                  crop=16),
    "basic_SN": dict(netG="linearkernel", netG_B="linearkernel", netD="basic_SN",
                     norm="instance", crop=24),
    "kernelGAN": dict(netG="linearkernel", netG_B="linearkernel_NC", netD="kernelGAN",
                      norm="instance", crop=24),
    # the smoke's vanilla and batchnorm phases: the production nets with
    # --netG unet_vanilla, and under --norm batch
    "production_vanilla": dict(netG="unet_vanilla", netG_B="deep_linear_gen", netD="basic",
                               norm="instance", crop=24),
    "production_batch": dict(netG="unet_deconv", netG_B="deep_linear_gen", netD="basic",
                             norm="batch", crop=24),
}


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _argv(config, precision="float32", extra=()):
    c = CONFIGS[config]
    return ["--dataroot", "unused", "--gan_mode", "lsgan", "--lambda_A", str(LAMBDA_A),
            "--projection_depth", str(DEPTH), "--randomize_projection_depth", "--precision",
            precision, "--beta1", str(BETA1), "--netG", c["netG"], "--netG_B",
            c["netG_B"], "--netD", c["netD"], "--norm", c["norm"], "--device", "cpu", *extra]


def _port(config, flats=None, precision="float32", extra=(), lr=LR):
    argv = _argv(config, precision, extra) + ["--lr", str(lr)]
    model = ApolloModel(train_options.build_parser(argv).parse_args(argv), "cpu")
    model.setup(train_options.build_parser(argv).parse_args(argv))
    if flats is not None:
        model.load_flats(flats)
    return model


@functools.lru_cache(maxsize=None)
def _flats(config) -> dict:
    """Kaiming weights with random biases and batch-norm offsets, drawn by
    the port's numpy init, in the JAX flat format."""
    model = _port(config)
    rng = np.random.default_rng(1)
    flats = {}
    for i, name in enumerate(MODEL_NAMES):
        flat = init_flat(model.nets[name], "kaiming", 0.02, i)
        for k, v in flat.items():
            if k.endswith((".b", ".offset")):
                flat[k] = (rng.normal(size=v.shape) * 0.1).astype(np.float32)
        flats[name] = flat
    return flats


@functools.lru_cache(maxsize=None)
def _jax_nets(config) -> dict:
    c = CONFIGS[config]
    nets = {"G_A": jax_factory.define_G(1, 1, 64, c["netG"], c["norm"], dimension=3),
            "G_B": jax_factory.define_G(1, 1, 64, c["netG_B"], c["norm"], dimension=3)}
    for name in D_NAMES:
        nets[name] = jax_factory.define_D(1, 64, c["netD"], 3, c["norm"], dimension=2)
    return nets


@functools.lru_cache(maxsize=None)
def _jax_step(config, accum):
    cfg = jgc.GanStepConfig(gan_mode="lsgan", lambda_A=LAMBDA_A, lambda_plane=(1, 1, 1),
                            randomize_projection_depth=True, projection_depth=DEPTH,
                            min_projection_depth=2, beta1=BETA1, precision="float32",
                            grad_accum=accum, accum_host=True)
    return make_apollo_step(_jax_nets(config), jgc.make_adam(BETA1), cfg)


def _jax_params(config) -> dict:
    return {n: unflatten_params(f) for n, f in _flats(config).items()}


def _draws(rng, crop) -> ProbeDraws:
    """The step's draws, as build_loss_fns and ops/sampling.py make them."""
    k_depth, k_g, k_d = jax.random.split(rng, 3)
    depth = int(jax.random.randint(k_depth, (), 2, DEPTH + 1))

    def draw(plan, ks):
        return tuple(int(jax.random.randint(k, (), 0, crop - depth if kind == "proj" else crop))
                     for (kind, _, _, _), k in zip(plan, ks))

    return ProbeDraws(depth, draw(G_PROBES, jax.random.split(k_g, 6)),
                      draw(D_PROBES, jax.random.split(k_d, 12)))


def _real(seed, crop):
    return np.random.default_rng(seed).random((1, crop, crop, crop, 1)).astype(np.float32)


def _port_flat(model, names, grads) -> dict:
    """Gradients in the order of the model's parameters -> {NAME.key: array
    in the JAX layout}."""
    out = {}
    for name, g in zip([(n, pn) for n in names for pn, _ in model.nets[n].named_parameters()],
                       grads):
        n, pn = name
        key, _, to_jax, *_ = next(e for e in jax_leaves(model.nets[n]) if e[1] == pn)
        out[f"{n}.{key}"] = to_jax(g).detach().double().numpy()
    return out


def _jax_flat(tree: dict, names) -> dict:
    return {f"{n}.{k}": np.asarray(v, np.float64) for n in names
            for k, v in flatten_params(tree[n]).items()}


def _is_pre_norm_bias(key: str) -> bool:
    parts = key.split(".")
    return parts[-1] == "b" and any(p.startswith(PRE_NORM) for p in parts[1:-1])


def _assert_grads(port: dict, ref: dict, g_a_tol: float) -> None:
    buffers = [k for k in ref if k not in port]
    assert all(k.endswith((".running_mean", ".running_var", ".u")) for k in buffers), buffers
    for k in buffers:  # the JAX step's gradients of its buffers are zero
        assert not np.any(ref[k]), k
    bad = {}
    for k, p in port.items():
        r = ref[k]
        if _is_pre_norm_bias(k):
            assert np.abs(p - r).max() <= 1e-5 * np.linalg.norm(ref[k[:-1] + "w"]), k
            continue
        err = np.linalg.norm(p - r) / np.linalg.norm(r)
        if not err <= (g_a_tol if k.startswith("G_A.") else 1e-3):
            bad[k] = err
    assert not bad, bad


@pytest.mark.parametrize("config, g_a_tol", [("vanilla", 1e-2), ("batch", 1e-3),
                                             ("basic_SN", 1e-3), ("kernelGAN", 1e-3)])
def test_step_matches_jax(config, g_a_tol):
    crop = CONFIGS[config]["crop"]
    params = _jax_params(config)
    rng, real = jax.random.PRNGKey(7), _real(2, crop)
    gp = {k: params[k] for k in G_NAMES}
    dp = {k: params[k] for k in D_NAMES}
    zeros = lambda t: jax.tree.map(jnp.zeros_like, t)  # noqa: E731
    g_acc, d_acc, aux, fake, rec = _jax_step(config, 2)._micro(gp, dp, zeros(gp), zeros(dp),
                                                               rng, jnp.asarray(real))
    model = _port(config, _flats(config))
    losses, pfake, prec, gg, dg = model.gradients(torch.from_numpy(real), _draws(rng, crop))
    for name in LOSS_NAMES:
        assert float(losses[name]) == pytest.approx(float(aux[name]), rel=1e-4), name
    for got, ref in ((pfake, fake), (prec, rec)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    _assert_grads({**_port_flat(model, G_NAMES, gg), **_port_flat(model, D_NAMES, dg)},
                  {**_jax_flat(g_acc, G_NAMES), **_jax_flat(d_acc, D_NAMES)}, g_a_tol)


class _JaxModel(JaxBaseModel):
    """The JAX package's ``BaseModel`` code (``refresh_norm_stats``,
    ``save_networks``, ``load_networks``) around given parameters and Adam
    state, without its constructor's initialisation."""

    def __init__(self, save_dir, params, opt_state, nets=None, names=MODEL_NAMES):
        self.save_dir, self.params, self.opt_state = str(save_dir), params, opt_state
        self.model_names, self.lr_controllers = list(names), []
        self.nets, self.isTrain = nets or _jax_nets("batch"), True
        self.opt = type("Opt", (), {"norm": "batch"})()

    set_input = forward = optimize_parameters = None


@functools.lru_cache(maxsize=None)
def _three_steps(accum):
    """The JAX model and the port's model after ``_jax_three_steps`` and
    ``_port_three_steps`` (computed once per accum; callers copy before they
    step on)."""
    jm, crops, keys = _jax_three_steps(accum)
    return jm, _port_three_steps(crops, keys, accum)


def _jax_three_steps(accum, tmp_path=None):
    """Three JAX steps on the batch-norm config, each followed by the
    refresh on the crop JAX's Apollo model refreshes on (the last one with
    --grad_accum); returns the model, the crops and the keys."""
    crop = CONFIGS["batch"]["crop"]
    params = _jax_params("batch")
    optim = jgc.make_adam(BETA1)
    gp = {k: params[k] for k in G_NAMES}
    dp = {k: params[k] for k in D_NAMES}
    state = {"G": optim.init(gp), "D": optim.init(dp)}
    jm = _JaxModel(tmp_path, dict(params), state)
    step = _jax_step("batch", accum)
    crops, keys = [], []
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        real = np.concatenate([_real(30 + 3 * i + j, crop) for j in range(accum)])
        gp = {k: jm.params[k] for k in G_NAMES}
        dp = {k: jm.params[k] for k in D_NAMES}
        if accum > 1:
            gp, dp, jm.opt_state, *_ = step(gp, dp, jm.opt_state, key,
                                            lambda j, r=real: jnp.asarray(r[j:j + 1]),
                                            jnp.float32(STATS_LR))
        else:
            gp, dp, jm.opt_state, *_ = step(gp, dp, jm.opt_state, key, jnp.asarray(real),
                                            jnp.float32(STATS_LR))
        jm.params.update(gp)
        jm.params.update(dp)
        jm.real = jnp.asarray(real[-1:])
        jm.refresh_norm_stats()
        crops.append(real)
        keys.append(key)
    return jm, crops, keys


def _port_three_steps(crops, keys, accum):
    crop = CONFIGS["batch"]["crop"]
    model = _port("batch", _flats("batch"), extra=["--grad_accum", str(accum)], lr=STATS_LR)
    for real, key in zip(crops, keys):
        draws = _draws(key, crop)
        if accum > 1:
            model.optimize_parameters_accum(lambda j, r=real: torch.from_numpy(r[j:j + 1]),
                                            accum, draws)
        else:
            model.optimize_parameters(torch.from_numpy(real), draws)
    return model


def _running_stats(flat_by_net: dict) -> dict:
    return {f"{n}.{k}": np.asarray(v) for n, f in flat_by_net.items() for k, v in f.items()
            if k.endswith((".running_mean", ".running_var"))}


def _port_stats(model) -> dict:
    from neuroclear_tpu_torch.utils.weights import flat_from_module

    return _running_stats({n: flat_from_module(model.nets[n]) for n in MODEL_NAMES})


@pytest.mark.parametrize("accum", [1, 2])
def test_running_statistics_after_three_steps_match_jax(accum):
    jm, model = _three_steps(accum)
    ref = _running_stats({n: flatten_params(jm.params[n]) for n in MODEL_NAMES})
    got = _port_stats(model)
    assert set(got) == set(ref) and len(ref) == 2 * (10 + 4)  # G_A's ten norms, one per D
    start = _running_stats(_flats("batch"))
    for k, r in ref.items():
        assert not np.allclose(r, start[k]), k  # refreshed
        np.testing.assert_allclose(got[k], r, rtol=1e-4, atol=2e-5, err_msg=k)


def test_dryops_accumulation_refreshes_on_the_batch_of_its_crops_as_jax():
    """JAX hands Athena and Dryops the (N, ...) batch under --grad_accum N
    (its Apollo takes a per-crop sampler, and refreshes on the last crop):
    their refresh runs on all N crops at once.  The port's Dryops step with
    --grad_accum 2 against JAX's ``refresh_norm_stats`` on the batch, from
    the port's updated weights and the buffers before the refresh."""
    from neuroclear_tpu_torch.models import create_model
    from neuroclear_tpu_torch.utils.weights import flat_from_module

    crop = CONFIGS["batch"]["crop"]
    names = ["G_A", "D_A_lateral", "D_A_axial"]
    argv = ["--dataroot", "unused", "--model", "axial_to_lateral_gan_dryops", "--gan_mode",
            "lsgan", "--projection_depth", str(DEPTH), "--netG", "unet_deconv", "--netD",
            "pixel", "--norm", "batch", "--grad_accum", "2", "--device", "cpu"]
    model = create_model(train_options.build_parser(argv).parse_args(argv), "cpu")
    flats = {n: _flats("batch")[n] for n in names}
    model.load_flats(flats)
    crops = np.concatenate([_real(50 + j, crop) for j in range(2)])
    model.optimize_parameters_accum(lambda j: torch.from_numpy(crops[j:j + 1]), 2,
                                    model.draw_probes((crop,) * 3, torch.Generator()))
    after = {n: flat_from_module(model.nets[n]) for n in names}
    nets = _jax_nets("batch")

    def jax_refresh(real):
        """JAX's refresh on ``real`` from the updated weights and the
        buffers before the refresh."""
        params = {n: unflatten_params({k: (flats[n][k] if k.endswith(
            ("running_mean", "running_var")) else v) for k, v in after[n].items()})
            for n in names}
        jm = _JaxModel(None, params, None, {n: nets[n] for n in names}, names)
        jm.real = jnp.asarray(real)
        jm.refresh_norm_stats()
        return _running_stats({n: flatten_params(jm.params[n]) for n in names})

    ref, got = jax_refresh(crops), _running_stats(after)
    assert set(got) == set(ref) and len(ref) == 2 * (10 + 2)
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, rtol=1e-4, atol=2e-5, err_msg=k)
    # not the last crop's refresh, which Apollo's would be
    last = jax_refresh(crops[-1:])
    assert max(np.abs(got[k] - last[k]).max() for k in last) > 1e-3


def test_batch_norm_checkpoints_load_across_packages_and_resume_bitwise(tmp_path):
    """JAX's three steps saved by its checkpoint code load in the port
    (weights, running statistics, Adam state with zero moments at the
    buffers); the port's checkpoint loads in JAX's code, equal; a port
    model reloaded from its own checkpoint takes the next step bit for bit
    as the one that wrote it."""
    crop = CONFIGS["batch"]["crop"]
    jm, port = _three_steps(1)
    jm.save_dir = str(tmp_path / "jax")
    jm.save_networks("iter_3")
    model = _port("batch")
    model.save_dir = str(tmp_path / "jax")
    model.load_networks("iter_3")
    assert model.optim_g.state and model.optim_d.state
    jax_optim = np.load(tmp_path / "jax" / "iter_3_optim.npz")
    port_optim = {k: v for k, v in model.optim_arrays().items() if not k.startswith("__lr")}
    assert set(port_optim) == set(jax_optim.files)
    for k in jax_optim.files:
        np.testing.assert_array_equal(port_optim[k], jax_optim[k], err_msg=k)
    from neuroclear_tpu_torch.utils.weights import flat_from_module

    for n in MODEL_NAMES:
        ref = flatten_params(jm.params[n])
        got = flat_from_module(model.nets[n])
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=f"{n}.{k}")

    # the port's own three steps, saved, read by JAX's code
    port = copy.deepcopy(port)
    port.save_dir = str(tmp_path / "port")
    port.save_networks("iter_3")
    back = _JaxModel(tmp_path / "port", {}, jm.opt_state)
    back.load_networks("iter_3")
    for n in MODEL_NAMES:
        got = flat_from_module(port.nets[n])
        for k, v in flatten_params(back.params[n]).items():
            np.testing.assert_array_equal(np.asarray(v), got[k], err_msg=f"{n}.{k}")
    flat, _ = jax.tree_util.tree_flatten(back.opt_state)
    saved = port.optim_arrays()
    for i, leaf in enumerate(flat):
        np.testing.assert_array_equal(np.asarray(leaf), saved[str(i)])

    # resume in the port: the next step from the reloaded model is the
    # writer's, bit for bit (weights, running statistics, Adam)
    resumed = _port("batch", lr=STATS_LR)
    resumed.save_dir = port.save_dir
    resumed.load_networks("iter_3")
    draws = _draws(jax.random.PRNGKey(40), crop)
    real = torch.from_numpy(_real(41, crop))
    for m in (port, resumed):
        m.optimize_parameters(real, draws)
    for n in MODEL_NAMES:
        a, b = port.nets[n].state_dict(), resumed.nets[n].state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), n
    for pa, pb in zip(port.g_params + port.d_params, resumed.g_params + resumed.d_params):
        sa = {**port.optim_g.state, **port.optim_d.state}[pa]
        sb = {**resumed.optim_g.state, **resumed.optim_d.state}[pb]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])


def test_batch_norm_modules_have_no_optimizer_slot_but_a_jax_one():
    model = _port("batch")
    bns = [m for n in MODEL_NAMES for m in model.nets[n].modules() if isinstance(m, BatchNorm)]
    assert len(bns) == 14
    params = {id(p) for p in model.g_params + model.d_params}
    assert all(id(m.running_mean) not in params and id(m.scale) in params for m in bns)
    arrays = model.optim_arrays()
    n_leaves = sum(len(flatten_params(unflatten_params(f))) for f in _flats("batch").values())
    assert len([k for k in arrays if not k.startswith("__lr")]) == 2 + 2 * n_leaves


def _counting(monkeypatch, counts):
    for name, fn in KERNELS.items():
        module = conv3x3 if name == "conv3x3" else wconv if name.startswith("wconv") else inorm

        def wrap(*a, _fn=fn, _name=name, **k):
            counts[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(module, fn.__name__, functools.update_wrapper(wrap, fn))


def _counted_step(monkeypatch, config, remat):
    counts = dict.fromkeys(KERNELS, 0)
    _counting(monkeypatch, counts)
    model = _port(config, precision="bfloat16", extra=["--remat"] if remat else [])
    model.init_weights(2, "kaiming")
    crop = 24
    draws = model.draw_probes((crop,) * 3, torch.Generator().manual_seed(3))
    out = model.gradients(torch.from_numpy(_real(5, crop)), draws)
    monkeypatch.undo()
    return counts, out


def test_vanilla_step_launches_are_the_smokes_tables_and_remat_is_bitwise(monkeypatch):
    (c0, (l0, f0, r0, g0, d0)) = _counted_step(monkeypatch, "production_vanilla", False)
    (c1, (l1, f1, r1, g1, d1)) = _counted_step(monkeypatch, "production_vanilla", True)
    assert c0 == chip_smoke.VANILLA_STEP_LAUNCHES
    assert c1 == chip_smoke.VANILLA_REMAT_STEP_LAUNCHES
    assert all(torch.isfinite(v) for v in l0.values())
    assert all(torch.equal(l0[k], l1[k]) for k in LOSS_NAMES)
    assert torch.equal(f0, f1) and torch.equal(r0, r1)
    assert all(torch.equal(a, b) for a, b in zip(list(g0) + list(d0), list(g1) + list(d1)))


def test_batch_norm_step_launches_are_the_smokes_table(monkeypatch):
    counts, (losses, *_) = _counted_step(monkeypatch, "production_batch", False)
    assert all(torch.isfinite(v) for v in losses.values())
    assert counts == chip_smoke.BATCHNORM_STEP_LAUNCHES
