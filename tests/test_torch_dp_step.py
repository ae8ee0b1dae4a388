"""The port's data-parallel Apollo step against the JAX package's, on the
CPU, f32: two gloo ranks under ``torchrun`` (``tests/test_torch_dp_worker.py``),
each taking one crop through the single-card step under ``DataParallel``
(the gradients and losses averaged over the ranks before one Adam update),
against JAX's step on the two-crop batch sharded over a two-device mesh of
the eight virtual CPU devices (the form of tests/test_parallel.py); the
port's single-process batch-2 step against JAX's batched step; and Athena's
and Dryops' batch-2 steps (narrow nets) against JAX's.

The nets: the production U-Net (G_A), the deep linear generator (G_B) and
the pixel discriminator at 16^3, under the instance norm and under
``--norm batch``, Kaiming weights with random biases and batch-norm offsets
drawn by the port's numpy init; the probe draws the JAX key makes, handed
to the port, one index for both crops.  JAX's gradients come from its
jitted step with ``optax.identity`` at lr 1e4 (the update is -1e4 g, which
keeps g to ~1e-7 relative after the subtraction).

Bounds, the step's usual ones (tests/test_torch_zoo_models.py): losses rtol
1e-4; per tensor 1e-3 relative L2, G_A's 1e-2 (a ReLU mask that flips
where two f32 forwards differ: JAX's own sharded and one-device steps lie
3.4e-3 apart at G_A under ``--norm batch``, measured); biases before a
norm (true gradient 0) within 1e-5 of their layer's weight gradient norm.
Under ``--norm batch`` the statistics are the global batch's, as JAX's over
its sharded batch: the two ranks against the single-process batch-2 step
(only the order of f32 sums differs) within ``BATCH_REL`` (1e-5 relative
L2) but for G_A (its usual 1e-2), and the running statistics after the step's refresh (each rank
on its crop, the sums all-reduced) against JAX's ``refresh_norm_stats`` on
the two-crop batch from the port's updated weights: rtol 1e-4, atol 2e-5.
After the step every parameter, buffer and Adam moment is equal on the two
ranks, bit for bit.  One CPU thread.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from threadpoolctl import threadpool_limits

from neuroclear_tpu.models import gan_common as jgc
from neuroclear_tpu.models.axial_to_lateral_gan_apollo_model import make_apollo_step
from neuroclear_tpu.models.base_model import BaseModel as JaxBaseModel
from neuroclear_tpu.nn import factory as jax_factory
from neuroclear_tpu.nn.core import flatten_params, unflatten_params
from neuroclear_tpu.parallel.mesh import get_mesh
from neuroclear_tpu_torch.models.axial_to_lateral_gan_apollo_model import (
    D_NAMES, D_PROBES, G_NAMES, G_PROBES, LOSS_NAMES, MODEL_NAMES, ApolloModel, ProbeDraws)
from neuroclear_tpu_torch.options import train_options
from neuroclear_tpu_torch.utils.weights import init_flat, jax_leaves
from test_torch_dp_worker import flats_arrays, run_ranks, save_case

CROP, DEPTH, BETA1, LAMBDA_A, LR = 16, 4, 0.1, 5.0, 1e-4
JAX_LR = 1e4
BATCH_REL = 1e-5
PRE_NORM = ("double_conv", "bottom_layer", "ex_double_conv", "ex_conv1_1", "conv1")
CONFIGS = {"instance": 1e-2, "batch": 1e-2}  # norm -> G_A's bound


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _argv(norm):
    return ["--dataroot", "unused", "--gan_mode", "lsgan", "--lambda_A", str(LAMBDA_A),
            "--projection_depth", str(DEPTH), "--randomize_projection_depth", "--beta1",
            str(BETA1), "--netG", "unet_deconv", "--netG_B", "deep_linear_gen", "--netD",
            "pixel", "--norm", norm, "--device", "cpu", "--lr", str(LR)]


def _port(norm, flats=None):
    argv = _argv(norm)
    opt = train_options.build_parser(argv).parse_args(argv)
    model = ApolloModel(opt, "cpu")
    model.setup(opt)
    if flats is not None:
        model.load_flats(flats)
    return model


@functools.lru_cache(maxsize=None)
def _flats(norm) -> dict:
    model = _port(norm)
    rng = np.random.default_rng(1)
    flats = {}
    for i, name in enumerate(MODEL_NAMES):
        flat = init_flat(model.nets[name], "kaiming", 0.02, 40 + i)
        for k, v in flat.items():
            if k.endswith((".b", ".offset")):
                flat[k] = (rng.normal(size=v.shape) * 0.1).astype(np.float32)
        flats[name] = flat
    return flats


@functools.lru_cache(maxsize=None)
def _jax_nets(norm) -> dict:
    nets = {"G_A": jax_factory.define_G(1, 1, 64, "unet_deconv", norm, dimension=3),
            "G_B": jax_factory.define_G(1, 1, 64, "deep_linear_gen", norm, dimension=3)}
    for name in D_NAMES:
        nets[name] = jax_factory.define_D(1, 64, "pixel", 3, norm, dimension=2)
    return nets


def _draws(rng) -> ProbeDraws:
    """The step's draws, as build_loss_fns and ops/sampling.py make them."""
    k_depth, k_g, k_d = jax.random.split(rng, 3)
    depth = int(jax.random.randint(k_depth, (), 2, DEPTH + 1))

    def draw(plan, ks):
        return tuple(int(jax.random.randint(k, (), 0, CROP - depth if kind == "proj" else CROP))
                     for (kind, _, _, _), k in zip(plan, ks))

    return ProbeDraws(depth, draw(G_PROBES, jax.random.split(k_g, 6)),
                      draw(D_PROBES, jax.random.split(k_d, 12)))


KEY = jax.random.PRNGKey(11)
CROPS = np.random.default_rng(12).random((2, CROP, CROP, CROP, 1)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_step(norm, sharded: bool):
    """JAX's step on the two-crop batch (sharded over a two-device mesh, or
    on one device): ({NAME.key: gradient}, losses)."""
    cfg = jgc.GanStepConfig(gan_mode="lsgan", lambda_A=LAMBDA_A, lambda_plane=(1, 1, 1),
                            randomize_projection_depth=True, projection_depth=DEPTH,
                            min_projection_depth=2, beta1=BETA1, precision="float32")
    optim = optax.identity()
    step = make_apollo_step(_jax_nets(norm), optim, cfg)
    params = {n: unflatten_params(f) for n, f in _flats(norm).items()}
    gp = {k: params[k] for k in G_NAMES}
    dp = {k: params[k] for k in D_NAMES}
    state = {"G": optim.init(gp), "D": optim.init(dp)}
    clone = lambda t: jax.tree.map(jnp.array, t)  # noqa: E731 (the step donates)
    batch = jnp.asarray(CROPS)
    if sharded:
        mesh = get_mesh(2)
        put = lambda t: jax.device_put(clone(t), NamedSharding(mesh, P()))  # noqa: E731
        batch = jax.device_put(batch, NamedSharding(mesh, P("data")))
        assert not batch.sharding.is_fully_replicated
        args = (put(gp), put(dp), put(state))
    else:
        args = (clone(gp), clone(dp), clone(state))
    g_new, d_new, _, losses, *_ = step(*args, KEY, batch, jnp.float32(JAX_LR))
    new = {**g_new, **d_new}
    grads = {}
    for n in MODEL_NAMES:
        before, after = flatten_params(params[n]), flatten_params(new[n])
        for k in before:
            grads[f"{n}.{k}"] = (np.asarray(before[k], np.float64)
                                 - np.asarray(after[k], np.float64)) / JAX_LR
    return grads, {k: float(v) for k, v in losses.items()}


def _port_flat(model, grads: dict) -> dict:
    """{"NAME.param": gradient array} -> {NAME.key: array in the JAX layout}."""
    out = {}
    for n in MODEL_NAMES:
        for key, pn, to_jax, _, _, param in jax_leaves(model.nets[n]):
            if param:
                g = torch.from_numpy(np.asarray(grads[f"{n}.{pn}"]))
                out[f"{n}.{key}"] = to_jax(g).double().numpy()
    return out


def _is_pre_norm_bias(key: str) -> bool:
    parts = key.split(".")
    return parts[-1] == "b" and any(p.startswith(PRE_NORM) for p in parts[1:-1])


def _assert_grads(port: dict, ref: dict, g_a_tol: float) -> None:
    """Per tensor within 1e-3 relative L2 (G_A within ``g_a_tol``); the
    buffers' JAX gradients exactly zero."""
    for k in set(ref) - set(port):
        assert k.endswith((".running_mean", ".running_var")) and not np.any(ref[k]), k
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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both configurations' one data-parallel step over two ranks."""
    tmp = tmp_path_factory.mktemp("dp_step")
    d = _draws(KEY)
    cases, arrays = [], {}
    for norm in CONFIGS:
        arrays.update({f"{norm}.flat/{k}": v for k, v in flats_arrays(_flats(norm)).items()})
        arrays[f"{norm}.crops"] = CROPS[None]
        cases.append({"prefix": f"{norm}.", "argv": _argv(norm),
                      "draws": [[d.depth, list(d.g), list(d.d)]]})
    save_case(tmp, {"cases": cases}, arrays)
    run_ranks("steps", tmp)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def _rank_grads(rank: dict, norm: str) -> dict:
    p = f"{norm}.grad."
    return {k[len(p):]: v for k, v in rank.items() if k.startswith(p)}


@pytest.mark.parametrize("norm", list(CONFIGS))
def test_two_rank_step_matches_jax_sharded_step(ranks, norm):
    grads, losses = _jax_step(norm, True)
    for name in LOSS_NAMES:
        got = float(ranks[0][f"{norm}.loss.{name}"])
        assert got == pytest.approx(losses[name], rel=1e-4), name
    model = _port(norm)
    _assert_grads(_port_flat(model, _rank_grads(ranks[0], norm)), grads, CONFIGS[norm])


@pytest.mark.parametrize("norm", list(CONFIGS))
def test_ranks_hold_equal_state_after_the_step(ranks, norm):
    keys = [k for k in ranks[0] if k.startswith(f"{norm}.step0.")]
    assert len(keys) > 3 * len([k for k in keys if ".adam." not in k]) // 2
    for k in keys:
        assert np.array_equal(ranks[0][k], ranks[1][k]), k


def _batch_step(norm):
    """The port's single-process step on the two-crop batch, without the
    update: (losses, {"NAME.param": gradient})."""
    model = _port(norm, _flats(norm))
    losses, _, _, gg, dg = model.gradients(torch.from_numpy(CROPS), _draws(KEY))
    named = [f"{n}.{pn}" for n in G_NAMES + D_NAMES
             for pn, _ in model.nets[n].named_parameters()]
    return model, losses, {k: g.numpy() for k, g in zip(named, list(gg) + list(dg))}


def test_batch_2_step_matches_jax_batched_step():
    model, losses, grads = _batch_step("instance")
    ref, ref_losses = _jax_step("instance", False)
    for name in LOSS_NAMES:
        assert float(losses[name]) == pytest.approx(ref_losses[name], rel=1e-4), name
    _assert_grads(_port_flat(model, grads), ref, CONFIGS["instance"])


def test_batch_norm_over_two_ranks_is_the_batch_2_step(ranks):
    """The two ranks' statistics are the global batch's: their averaged
    step is the single-process batch-2 step but for the order of f32 sums.
    Losses within ``BATCH_REL``, G_B's and each discriminator's gradients
    pooled within ``BATCH_REL`` relative L2 (measured: at most 1.5e-6);
    G_A's within its usual 1e-2 (measured 8.5e-4: the ReLU masks of its
    batch-normed units flip on the sums' last bits, as between JAX's own
    sharded and one-device steps).  A per-rank batch norm lies ~1e-1 away."""
    model, losses, grads = _batch_step("batch")
    for name in LOSS_NAMES:
        got = float(ranks[0][f"batch.loss.{name}"])
        assert got == pytest.approx(float(losses[name]), rel=BATCH_REL), name
    dp = _rank_grads(ranks[0], "batch")
    for net in MODEL_NAMES:
        keys = [k for k in grads if k.startswith(net + ".")]
        num = sum(float(np.sum((dp[k] - grads[k].astype(np.float64)) ** 2)) for k in keys)
        den = sum(float(np.sum(grads[k].astype(np.float64) ** 2)) for k in keys)
        assert (num / den) ** 0.5 <= (CONFIGS["batch"] if net == "G_A" else BATCH_REL), net


class _JaxModel(JaxBaseModel):
    """The JAX package's ``refresh_norm_stats`` around given parameters."""

    def __init__(self, params):
        self.params, self.model_names = params, list(MODEL_NAMES)
        self.nets, self.isTrain = _jax_nets("batch"), True
        self.opt = type("Opt", (), {"norm": "batch"})()

    set_input = forward = optimize_parameters = None


def test_running_statistics_over_two_ranks_match_jax_refresh(ranks):
    """Each rank refreshes on its crop with the sums all-reduced: JAX's
    refresh on the two-crop batch, from the port's updated weights and the
    buffers before the refresh."""
    model = _port("batch")
    flats = _flats("batch")
    state = {k[len("batch.step0."):]: v for k, v in ranks[0].items()
             if k.startswith("batch.step0.") and ".adam." not in k}
    params, got = {}, {}
    for n in MODEL_NAMES:
        flat = {}
        for key, pn, to_jax, _, _, param in jax_leaves(model.nets[n]):
            value = to_jax(torch.from_numpy(state[f"{n}.{pn}"])).numpy()
            if key.endswith(("running_mean", "running_var")):
                got[f"{n}.{key}"] = value
                value = flats[n][key]  # the refresh starts from the buffers before it
            flat[key] = value
        params[n] = unflatten_params(flat)
    jm = _JaxModel(params)
    jm.real = jnp.asarray(CROPS)
    jm.refresh_norm_stats()
    ref = {f"{n}.{k}": np.asarray(v) for n in MODEL_NAMES
           for k, v in flatten_params(jm.params[n]).items()
           if k.endswith(("running_mean", "running_var"))}
    assert set(got) == set(ref) and len(ref) == 2 * (10 + 4)  # G_A's ten norms, one per D
    for k, r in ref.items():
        assert not np.allclose(r, flats[k.split(".")[0]][k.split(".", 1)[1]]), k
        np.testing.assert_allclose(got[k], r, rtol=1e-4, atol=2e-5, err_msg=k)



# Athena and Dryops take the batch too (Athena's probes every slice of all N
# crops, Dryops' one index for all): narrow nets (linear-kernel generators,
# the pixel discriminator, instance norm) at 16^3, batch 2, against JAX's
# batched step.  Athena's discriminators and G_B at 1e-2, the repo's Athena
# bound (ROADMAP queue 3: the PatchGAN's last norm over few outputs per slice
# amplifies f32 rounding), the rest at 1e-3.
NARROW = {"athena": ("axial_to_lateral_gan_athena", ["--netG_B", "linearkernel"]),
          "dryops": ("axial_to_lateral_gan_dryops", ["--projection_depth", str(DEPTH),
                                                      "--randomize_projection_depth"])}


def _narrow_model(kind):
    from neuroclear_tpu_torch.models import create_model

    name, extra = NARROW[kind]
    argv = ["--dataroot", "unused", "--model", name, "--netG", "linearkernel", "--netD",
            "pixel", "--gan_mode", "lsgan", "--lambda_A", str(LAMBDA_A), "--beta1",
            str(BETA1), "--device", "cpu", *extra]
    opt = train_options.build_parser(argv).parse_args(argv)
    model = create_model(opt, "cpu")
    model.setup(opt)
    rng = np.random.default_rng(2)
    flats = {}
    for i, n in enumerate(model.model_names):
        flat = init_flat(model.nets[n], "kaiming", 0.02, 60 + i)
        flats[n] = {k: ((rng.normal(size=v.shape) * 0.1).astype(np.float32)
                        if k.endswith(".b") else v) for k, v in flat.items()}
    model.load_flats(flats)
    return model, flats


def _jax_narrow_step(kind, model, flats):
    from neuroclear_tpu.models.axial_to_lateral_gan_athena_model import make_athena_step
    from neuroclear_tpu.models.axial_to_lateral_gan_dryops_model import make_dryops_step

    nets = {n: (jax_factory.define_G(1, 1, 64, "linearkernel", "instance", dimension=3)
                if n.startswith("G") else
                jax_factory.define_D(1, 64, "pixel", 3, "instance", dimension=2))
            for n in model.model_names}
    optim = optax.identity()
    if kind == "athena":
        cfg = jgc.GanStepConfig(gan_mode="lsgan", lambda_A=LAMBDA_A, lambda_plane=(1, 1, 1),
                                precision="float32")
        a = model.axes
        step = functools.partial(make_athena_step(nets, optim, cfg,
                                                  (a["target"], a["source"], a["remain"])))
        call = lambda *args: step(*args[:3], *args[4:])  # noqa: E731 (no key)
    else:
        cfg = jgc.GanStepConfig(gan_mode="lsgan", randomize_projection_depth=True,
                                projection_depth=DEPTH, min_projection_depth=2,
                                precision="float32")
        call = make_dryops_step(nets, optim, cfg)
    params = {n: unflatten_params(f) for n, f in flats.items()}
    gp = {k: params[k] for k in model.G_NAMES}
    dp = {k: params[k] for k in model.D_NAMES}
    state = {"G": optim.init(gp), "D": optim.init(dp)}
    clone = lambda t: jax.tree.map(jnp.array, t)  # noqa: E731
    g_new, d_new, _, losses, *_ = call(clone(gp), clone(dp), clone(state), KEY,
                                       jnp.asarray(CROPS), jnp.float32(JAX_LR))
    new = {**g_new, **d_new}
    grads = {}
    for n in model.model_names:
        before, after = flatten_params(params[n]), flatten_params(new[n])
        for k in before:
            grads[f"{n}.{k}"] = (np.asarray(before[k], np.float64)
                                 - np.asarray(after[k], np.float64)) / JAX_LR
    return grads, {k: float(v) for k, v in losses.items()}


@pytest.mark.parametrize("kind", list(NARROW))
def test_athena_and_dryops_batch_2_steps_match_jax(kind):
    model, flats = _narrow_model(kind)
    ref, ref_losses = _jax_narrow_step(kind, model, flats)
    draws = _dryops_draws(KEY) if kind == "dryops" else None
    losses, *_, gg, dg = model.gradients(torch.from_numpy(CROPS), draws)
    for name in model.loss_names:
        assert float(losses[name]) == pytest.approx(ref_losses[name], rel=1e-4), name
    got = {}
    named = [(n, pn) for n in model.G_NAMES + model.D_NAMES
             for pn, _ in model.nets[n].named_parameters()]
    by_name = dict(zip(named, list(gg) + list(dg)))
    for n in model.model_names:
        for key, pn, to_jax, _, _, param in jax_leaves(model.nets[n]):
            if param:
                got[f"{n}.{key}"] = to_jax(by_name[(n, pn)]).double().numpy()
    loose = ("D_", "G_B.") if kind == "athena" else ()
    for k, g in got.items():
        tol = 1e-2 if k.startswith(loose) and loose else 1e-3
        if _is_pre_norm_bias(k):  # true gradient 0
            assert np.abs(g - ref[k]).max() <= 1e-5 * np.linalg.norm(ref[k[:-1] + "w"]), k
            continue
        assert np.linalg.norm(g - ref[k]) <= tol * np.linalg.norm(ref[k]), (k, np.linalg.norm(
            g - ref[k]) / np.linalg.norm(ref[k]))


def _dryops_draws(rng) -> ProbeDraws:
    """Dryops' draws, as make_dryops_step makes them (3 G probes, 6 D)."""
    from neuroclear_tpu_torch.models.axial_to_lateral_gan_dryops_model import (
        D_PROBES as DRY_D, G_PROBES as DRY_G)

    k_depth, k_g, k_d = jax.random.split(rng, 3)
    depth = int(jax.random.randint(k_depth, (), 2, DEPTH + 1))

    def draw(plan, ks):
        return tuple(int(jax.random.randint(k, (), 0, CROP - depth if kind == "proj" else CROP))
                     for (kind, _, _, _), k in zip(plan, ks))

    return ProbeDraws(depth, draw(DRY_G, jax.random.split(k_g, 3)),
                      draw(DRY_D, jax.random.split(k_d, 6)))
