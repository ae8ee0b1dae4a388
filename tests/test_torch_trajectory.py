"""A run of the port's Apollo training steps against the JAX package's, on
the CPU: K = 8 consecutive steps of the production nets (UNetDeconv,
DeepLinearGenerator, four NLayerDiscriminators) from JAX-initialised
weights and a fresh Adam, f32, on the same eight numpy 24^3 crops, each
step's probe draws taken from its JAX key as ``build_loss_fns`` splits it
(``tests/test_torch_train_step.py`` holds one step).  JAX runs its jitted
``make_apollo_step``; the port ``ApolloModel.optimize_parameters``.  Each
step's losses are checked, and after step K every parameter.

The bound comes from a measured reference spread: the port's f32 run
against the same run in float64 (nets, statistics, losses and Adam;
measured once on the CPU, one thread, by ``measure``: run this file
as a script).  That is the distance f32 rounding
alone puts between two runs of one program, and it grows from step to step
(the run is chaotic: Adam's first steps move each weight by about lr
whatever the size of its gradient, so a gradient whose sign rounding flips
moves its weight the other way, and a ReLU mask that flips reroutes a
gradient).  At the recipe's lr 1e-4 it grows too fast to hold anything: by
step 4 the losses lie 17% apart and after step 8 G_A's displacement 68%,
between the port's f32 and float64 runs and the same between JAX's f32 run
and the port's float64 one.  So the run takes lr 1e-5, where after each
step the losses of the f32 and float64 runs lie (largest relative
difference over the eleven losses) ``SPREAD_LOSS`` apart, and after step 8
the parameters' displacements from the start (relative L2, pooled per
net; the four discriminators pooled; the biases before a norm, whose true
gradient is 0, apart) ``SPREAD_DISP``.  The bars: each step's losses within
4x the largest spread up to that step (at least the one-step bar 1e-4),
the displacements within 2x theirs, the pre-norm biases within 4K lr of
JAX's.  Measured port against JAX: losses 2.2e-5, 1.1e-4, 2.7e-4, 1.3e-3,
3.3e-3, 4.8e-3, 2.7e-2, 2.9e-2; displacements G_A 0.149, G_B 0.0429, D
0.0252; pre-norm biases 11.2 lr.

A fault that builds up over steps fails it: with Adam's bias correction
frozen at step 1 (the optimizer's step count reset before every step) the
losses lie 0.19 from JAX's at step 3 (bar 1.1e-3) and the displacements
0.633, 0.380, 0.422 (bars 0.248, 0.0754, 0.0438): a copy of the port with
that fault fails 9 of this file's 12 tests.  One CPU thread.
"""

import contextlib
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from neuroclear_tpu.models import gan_common as jgc
from neuroclear_tpu.models.axial_to_lateral_gan_apollo_model import make_apollo_step
from neuroclear_tpu.nn import factory as jax_factory
from neuroclear_tpu.nn.core import flatten_params
from neuroclear_tpu_torch.models import gan_common as pgc
from neuroclear_tpu_torch.models.axial_to_lateral_gan_apollo_model import (
    D_NAMES, D_PROBES, G_NAMES, G_PROBES, LOSS_NAMES, MODEL_NAMES, ApolloModel, ProbeDraws)
from neuroclear_tpu_torch.options import train_options

K, CROP, DEPTH, LAMBDA_A, LR = 8, 24, 4, 5.0, 1e-5
SPREAD_LOSS = (8.1e-6, 5.9e-5, 2.7e-4, 9.4e-4, 3.9e-3, 2.8e-3, 1.6e-2, 4.4e-2)
SPREAD_DISP = {"G_A": 0.124, "G_B": 0.0377, "D": 0.0219}
GROUPS = {"G_A": ["G_A"], "G_B": ["G_B"], "D": list(D_NAMES)}
PRE_NORM = ("double_conv", "bottom_layer", "ex_double_conv2", "ex_conv1_1",
            "conv1", "conv2", "conv3")


def _is_pre_norm_bias(key: str) -> bool:
    parts = key.split(".")
    return parts[-1] == "b" and any(p.startswith(PRE_NORM) for p in parts[1:-1])


def _opt(lr: float):
    """The recipe's flags at 24^3 (the default Adam: beta1 0.1) and ``lr``."""
    return train_options.build_parser().parse_args(
        ["--dataroot", "unused", "--gan_mode", "lsgan", "--lambda_A", str(LAMBDA_A),
         "--projection_depth", str(DEPTH), "--randomize_projection_depth", "--precision",
         "float32", "--lr", str(lr)])


def _draws(rng) -> ProbeDraws:
    """The step's draws from its key, as build_loss_fns and ops/sampling.py
    make them."""
    k_depth, k_g, k_d = jax.random.split(rng, 3)
    depth = int(jax.random.randint(k_depth, (), 2, DEPTH + 1))

    def draw(plan, ks):
        return tuple(int(jax.random.randint(k, (), 0, CROP - depth if kind == "proj" else CROP))
                     for (kind, _, _, _), k in zip(plan, ks))
    return ProbeDraws(depth, draw(G_PROBES, jax.random.split(k_g, 6)),
                      draw(D_PROBES, jax.random.split(k_d, 12)))


def _port_flat(model) -> dict:
    """{NAME.path.w/b: parameter in the JAX layout, float64}."""
    out = {}
    for n in MODEL_NAMES:
        for pn, p in model.nets[n].named_parameters():
            prefix, leaf = pn.rsplit(".", 1)
            layer = model.nets[n].get_submodule(prefix)
            arr = layer.weight_to_jax(p.detach()) if leaf == "weight" else p.detach()
            out[f"{n}.{prefix}.{'w' if leaf == 'weight' else 'b'}"] = arr.double().numpy()
    return out


class _Float64Config(pgc.GanStepConfig):
    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.float64


def _case():
    """The JAX nets, their initial parameters, the crops and the step keys."""
    nets = {"G_A": jax_factory.define_G(1, 1, 64, "unet_deconv", "instance", dimension=3),
            "G_B": jax_factory.define_G(1, 1, 64, "deep_linear_gen", "instance", dimension=3)}
    for name in D_NAMES:
        nets[name] = jax_factory.define_D(1, 64, "basic", 3, "instance", dimension=2)
    keys = jax.random.split(jax.random.PRNGKey(0), len(MODEL_NAMES))
    params = {n: nets[n].init(keys[i], "kaiming", 0.02) for i, n in enumerate(MODEL_NAMES)}
    crops = np.random.default_rng(1).random((K, 1, CROP, CROP, CROP, 1)).astype(np.float32)
    return nets, params, crops, jax.random.split(jax.random.PRNGKey(1), K)


def _jax_run(case, lr: float):
    """K steps of JAX's jitted step: (each step's losses, the parameters)."""
    nets, params, crops, rngs = case
    beta1 = _opt(lr).beta1
    cfg = jgc.GanStepConfig(gan_mode="lsgan", lambda_A=LAMBDA_A, lambda_plane=(1, 1, 1),
                            randomize_projection_depth=True, projection_depth=DEPTH,
                            min_projection_depth=2, beta1=beta1, precision="float32")
    optim = jgc.make_adam(beta1)
    step = make_apollo_step(nets, optim, cfg)
    gp = {k: jax.tree.map(jnp.array, params[k]) for k in G_NAMES}  # the step donates them
    dp = {k: jax.tree.map(jnp.array, params[k]) for k in D_NAMES}
    state = {"G": optim.init(gp), "D": optim.init(dp)}
    out = []
    for i in range(K):
        gp, dp, state, losses, _, _ = step(gp, dp, state, rngs[i], jnp.asarray(crops[i]),
                                           np.float32(lr))
        out.append({k: float(v) for k, v in losses.items()})
    return out, {f"{n}.{k}": np.asarray(v, np.float64) for n in MODEL_NAMES
                 for k, v in flatten_params({**gp, **dp}[n]).items()}


def _port_run(case, lr: float, float64: bool = False, frozen: bool = False):
    """K steps of the port's model: (each step's losses, the parameters).
    ``float64``: nets, statistics, losses and Adam in float64; ``frozen``:
    Adam's step count reset before every step (its bias correction frozen
    at step 1)."""
    _, params, crops, rngs = case
    model = ApolloModel(_opt(lr), "cpu")
    model.load_flats({n: flatten_params(params[n]) for n in MODEL_NAMES})
    if float64:
        for net in model.nets.values():
            net.double()
        model.cfg = _Float64Config(**dataclasses.asdict(model.cfg))
    out = []
    for i in range(K):
        if frozen:
            for optim in (model.optim_g, model.optim_d):
                for st in optim.state.values():
                    st["step"].zero_()
        losses, *_ = model.optimize_parameters(torch.from_numpy(crops[i]), _draws(rngs[i]))
        out.append({k: float(v) for k, v in losses.items()})
    return out, _port_flat(model)


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


def _start(case) -> dict:
    return {f"{n}.{k}": np.asarray(v, np.float64) for n in MODEL_NAMES
            for k, v in flatten_params(case[1][n]).items()}


def _loss_rel(a: dict, b: dict) -> float:
    return max(abs(a[n] - b[n]) / abs(b[n]) for n in LOSS_NAMES)


def _displacement_rel(start: dict, a: dict, b: dict, group: str) -> float:
    """Relative L2 of a's displacement from ``start`` against b's, pooled
    over the group's tensors (pre-norm biases apart)."""
    keys = [k for k in b if k.split(".")[0] in GROUPS[group] and not _is_pre_norm_bias(k)]
    num = sum(np.sum(((a[k] - start[k]) - (b[k] - start[k])) ** 2) for k in keys)
    den = sum(np.sum((b[k] - start[k]) ** 2) for k in keys)
    return float(np.sqrt(num / den))


@pytest.fixture(scope="module")
def runs():
    case = _case()
    with _one_thread():
        port_losses, port = _port_run(case, LR)
        jax_losses, ref = _jax_run(case, LR)
    return {"start": _start(case), "port": port, "jax": ref, "port_losses": port_losses,
            "jax_losses": jax_losses}


@pytest.mark.parametrize("k", range(K))
def test_each_steps_losses_match_jax(runs, k):
    bar = max(1e-4, 4 * max(SPREAD_LOSS[:k + 1]))
    rel = _loss_rel(runs["port_losses"][k], runs["jax_losses"][k])
    assert rel <= bar, (k + 1, rel)


@pytest.mark.parametrize("group", list(GROUPS))
def test_parameters_after_the_run_match_jax(runs, group):
    """Each net's displacement from the start over the K steps (pre-norm
    biases apart) within 2x the f32-against-float64 spread of the JAX
    run's, relative L2."""
    assert set(runs["port"]) == set(runs["jax"])
    rel = _displacement_rel(runs["start"], runs["port"], runs["jax"], group)
    assert rel <= 2 * SPREAD_DISP[group]


def test_pre_norm_biases_stay_within_adams_reach(runs):
    """The biases before a norm carry no gradient but rounding noise, which
    Adam moves by about lr a step either way: within 4K lr of JAX's."""
    port, ref = runs["port"], runs["jax"]
    worst = max(float(np.abs(port[k] - ref[k]).max()) for k in ref if _is_pre_norm_bias(k))
    assert worst <= 4 * K * LR


def measure(lr: float) -> None:
    """The readings the bars come from, at ``lr``: the port's f32 run against
    its float64 run, JAX's f32 run against it, the port against JAX, and
    the port with Adam's bias correction frozen against JAX."""
    case = _case()
    start = _start(case)
    with _one_thread():
        runs = {"port": _port_run(case, lr), "port64": _port_run(case, lr, float64=True),
                "jax": _jax_run(case, lr), "frozen": _port_run(case, lr, frozen=True)}
    for a, b in (("port", "port64"), ("jax", "port64"), ("port", "jax"), ("frozen", "jax")):
        (la, fa), (lb, fb) = runs[a], runs[b]
        bias = max(float(np.abs(fa[k] - fb[k]).max()) for k in fb if _is_pre_norm_bias(k))
        print(f"{a} against {b} at lr {lr:g}: losses by step "
              + ", ".join(f"{_loss_rel(x, y):.2g}" for x, y in zip(la, lb))
              + "; displacements " + ", ".join(f"{g} {_displacement_rel(start, fa, fb, g):.3g}"
                                               for g in GROUPS)
              + f"; pre-norm biases {bias / lr:.3g} lr", flush=True)


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_trajectory.py [lr ...]
    for lr in map(float, sys.argv[1:] or [LR, 1e-4]):
        measure(lr)
