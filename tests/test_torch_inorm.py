"""The port's instance norm (neuroclear_tpu_torch/ops/inorm.py) against the
JAX package's ``pallas_ops.instance_norm_act``, on the CPU, where the
wrappers run their plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroclear_tpu.ops import pallas_ops
from neuroclear_tpu_torch.nn.core import InstanceNorm
from neuroclear_tpu_torch.ops import inorm

# f32 statistics summed in another order, then rsqrt: ~1e-6 relative
RTOL = 1e-5


@pytest.mark.parametrize("shape, act", [((2, 6, 5, 4, 64), "relu"),
                                        ((1, 3, 3, 3, 128), None),
                                        ((2, 4, 4, 2, 256), "relu")])
def test_instance_norm_act_matches_jax(shape, act):
    rng = np.random.default_rng(shape[-1])
    x = (rng.normal(size=shape) * 3.0 + 1.5).astype(np.float32)
    ref = np.asarray(pallas_ops.instance_norm_act(jnp.asarray(x), act))
    y = inorm.instance_norm_act(torch.from_numpy(x), act).numpy()
    np.testing.assert_allclose(y, ref, rtol=RTOL, atol=RTOL)


def test_plain_flag_gives_the_same_result():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(1, 4, 4, 4, 64)).astype(np.float32))
    a = InstanceNorm("relu")(x)
    b = InstanceNorm("relu", plain=True)(x)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_sums_against_float64(dtype):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(2, 1000, 64)).astype(np.float32)).to(dtype)
    s, scale, shift = inorm.pair_sums(x)
    assert s.dtype == torch.float32 and s.shape == (2, 2, 64)
    assert scale.shape == shift.shape == (2, 64) and scale.is_contiguous()
    xd = x.double()
    ref = torch.stack([xd.sum(1), (xd * xd).sum(1)], 1)
    mag = torch.stack([xd.abs().sum(1), (xd * xd).sum(1)], 1)
    assert ((s.double() - ref).abs() <= 1e-5 * mag).all()
    ref_scale, ref_shift = inorm.norm_coefficients(s, 1000)
    assert torch.equal(scale, ref_scale) and torch.equal(shift, ref_shift)


@pytest.mark.parametrize("shape", [(2, 300, 64), (1, 27, 128), (3, 50, 8)])
def test_pair_sums_coefficients_match_jax_forward(shape):
    """The plain triple's (scale, shift) against ``_inorm_fwd_impl``'s lines
    on ``_pair_sums`` (fold 1), f32, rtol 1e-5: f32 sums in another order,
    then rsqrt."""
    rng = np.random.default_rng(shape[1])
    x3 = (rng.normal(size=shape) * 2.5 + 1.0).astype(np.float32)
    s, ss = pallas_ops._pair_sums(jnp.asarray(x3), jnp.asarray(x3))
    mean = s / shape[1]
    var = jnp.maximum(ss / shape[1] - jnp.square(mean), 0.0)
    rstd = jax.lax.rsqrt(var + pallas_ops._EPS)
    sums, scale, shift = inorm.pair_sums(torch.from_numpy(x3))
    np.testing.assert_allclose(sums[:, 0].numpy(), np.asarray(s), rtol=RTOL,
                               atol=RTOL * float(jnp.abs(s).max()))
    np.testing.assert_allclose(sums[:, 1].numpy(), np.asarray(ss), rtol=RTOL)
    np.testing.assert_allclose(scale.numpy(), np.asarray(rstd), rtol=RTOL)
    np.testing.assert_allclose(shift.numpy(), np.asarray(-mean * rstd), rtol=RTOL, atol=RTOL)


def test_affine_map_act_rounds_once():
    """bf16 in, the map in f32, one rounding to bf16, the ReLU fused; an
    activation the port does not have is refused."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.normal(size=(2, 50, 64)).astype(np.float32)).to(torch.bfloat16)
    scale = torch.from_numpy(rng.random((2, 64), dtype=np.float32) + 0.5)
    shift = torch.from_numpy(rng.normal(size=(2, 64)).astype(np.float32))
    y = inorm.affine_map_act(x, scale, shift, "relu")
    ref = torch.relu(x.float() * scale[:, None] + shift[:, None]).to(torch.bfloat16)
    assert y.dtype == torch.bfloat16 and torch.equal(y, ref)
    with pytest.raises(NotImplementedError):
        inorm.affine_map_act(x, scale, shift, "tanh")


def test_norm_coefficients_match_jax_formula():
    """mean and rstd from the sums as _inorm_fwd_impl derives them."""
    rng = np.random.default_rng(17)
    x = (rng.normal(size=(2, 300, 8)) * 2 + 1).astype(np.float32)
    _, scale, shift = inorm.pair_sums(torch.from_numpy(x))
    mean = x.mean(1, dtype=np.float64)
    rstd = 1.0 / np.sqrt(x.var(1, dtype=np.float64) + 1e-5)
    np.testing.assert_allclose(scale.numpy(), rstd, rtol=RTOL)
    np.testing.assert_allclose(shift.numpy(), -mean * rstd, rtol=RTOL, atol=RTOL)
