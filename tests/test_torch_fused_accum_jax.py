"""Apollo's ``--fused_accum`` step in the port
(``BaseModel.optimize_parameters_batch``) against the JAX package's
``--fused_accum`` step (``make_apollo_step`` with ``accum_host=False``: one
``grad_accum_scan`` program over the resident batch) on the CPU, two 24^3
crops, f32, full-width nets on JAX-initialised Kaiming weights.  The JAX
step is built with an optax transformation that hands its gradients back
(the mean of the crops'); the port's are taken as they reach its update.
Inputs and bars: tests/test_torch_train_step.py's (its two crops, from
seeds 1 and 2, on which its bars were set; losses rtol 1e-4; gradients 1e-3
relative L2 per tensor, G_A 1e-2, the biases before an instance norm within
1e-5 of their layer's weight gradient norm).  G_A's bar is that file's
ReLU-mask allowance, and it depends on the crops: on these the port's G_A
lies 5.4e-3 from JAX's fused step, on two crops from seed 5 1.59e-2, from
JAX's fused step and its per-crop step alike (which lie 3e-6 apart), the
discriminators and G_B within 3.5e-5 on both pairs."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from threadpoolctl import threadpool_limits

from neuroclear_tpu.models import gan_common as jgc
from neuroclear_tpu.models.axial_to_lateral_gan_apollo_model import make_apollo_step
from neuroclear_tpu.nn import factory as jax_factory
from neuroclear_tpu.nn.core import flatten_params
from neuroclear_tpu_torch.models.axial_to_lateral_gan_apollo_model import (
    D_NAMES, D_PROBES, G_NAMES, G_PROBES, LOSS_NAMES, MODEL_NAMES, ApolloModel, ProbeDraws)
from test_torch_train_step import (BETA1, CROP, DEPTH, G_A_REL_L2, LAMBDA_A, _assert_grads,
                                   _jax_flat, _opt, _port_flat)


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


def test_apollo_fused_step_matches_jaxs_fused_step():
    """JAX's ``--fused_accum`` step on two crops (its gradients, the mean
    that ``grad_accum_scan`` gives, handed back by the optimizer) against
    the port's fused step under the same draws (its gradients taken as
    they reach the update)."""
    nets = {"G_A": jax_factory.define_G(1, 1, 64, "unet_deconv", "instance", dimension=3),
            "G_B": jax_factory.define_G(1, 1, 64, "deep_linear_gen", "instance", dimension=3)}
    for name in D_NAMES:
        nets[name] = jax_factory.define_D(1, 64, "basic", 3, "instance", dimension=2)
    keys = jax.random.split(jax.random.PRNGKey(0), len(MODEL_NAMES) + 1)
    params = {n: nets[n].init(keys[i], "kaiming", 0.02) for i, n in enumerate(MODEL_NAMES)}
    cfg = jgc.GanStepConfig(gan_mode="lsgan", lambda_A=LAMBDA_A, lambda_plane=(1, 1, 1),
                            randomize_projection_depth=True, projection_depth=DEPTH,
                            min_projection_depth=2, beta1=BETA1, precision="float32",
                            grad_accum=2, accum_host=False)
    optim = _capture()
    step = make_apollo_step(nets, optim, cfg)
    rng = keys[-1]
    crops = np.concatenate([np.random.default_rng(seed).random((1, CROP, CROP, CROP, 1))
                            .astype(np.float32) for seed in (1, 2)])
    copy = lambda tree: jax.tree.map(lambda a: jnp.array(a, copy=True), tree)  # noqa: E731
    gp = copy({k: params[k] for k in G_NAMES})  # the step donates its inputs
    dp = copy({k: params[k] for k in D_NAMES})
    state = {"G": optim.init(gp), "D": optim.init(dp)}
    _, _, state, jax_losses, _, _ = step(gp, dp, state, rng, jnp.asarray(crops),
                                         jnp.float32(1e-4))
    jg, jd = _jax_flat(state["G"], G_NAMES), _jax_flat(state["D"], D_NAMES)

    # the step's draws from its key, as build_loss_fns splits it
    k_depth, k_g, k_d = jax.random.split(rng, 3)
    depth = int(jax.random.randint(k_depth, (), 2, DEPTH + 1))

    def draw(plan, ks):
        return tuple(int(jax.random.randint(k, (), 0, CROP - depth if kind == "proj" else CROP))
                     for (kind, _, _, _), k in zip(plan, ks))

    draws = ProbeDraws(depth, draw(G_PROBES, jax.random.split(k_g, 6)),
                       draw(D_PROBES, jax.random.split(k_d, 12)))
    model = ApolloModel(_opt(), "cpu")
    model.load_flats({n: flatten_params(params[n]) for n in MODEL_NAMES})
    seen = []
    model.apply_gradients = lambda g, d: seen.append((list(g), list(d)))
    losses, *_ = model.optimize_parameters_batch(torch.from_numpy(crops), draws)
    for name in LOSS_NAMES:
        assert float(losses[name]) == pytest.approx(float(jax_losses[name]), rel=1e-4), name
    (gg, dg), = seen
    pg, pd = _port_flat(model, G_NAMES, gg), _port_flat(model, D_NAMES, dg)
    _assert_grads(pd, jd, 1e-3)
    _assert_grads({k: v for k, v in pg.items() if k.startswith("G_B.")},
                  {k: v for k, v in jg.items() if k.startswith("G_B.")}, 1e-3)
    _assert_grads({k: v for k, v in pg.items() if k.startswith("G_A.")},
                  {k: v for k, v in jg.items() if k.startswith("G_A.")}, G_A_REL_L2)
