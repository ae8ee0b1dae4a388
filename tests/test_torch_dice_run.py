"""The port's ``DiceInferencePipeline.run`` (the JAX package's non-streaming
entry point, which the port computes with ``run_streaming``) against the
JAX package's ``run`` and the port's ``run_streaming``, on the CPU.

Bounds: against JAX, 1 uint16 LSB with a stand-in generator (a sum order
that differs in the last f32 bit before the truncating cast), E2E_LSB with
the real UNetDeconv (the generator's own f32 bound, tests/test_torch_dice.py).
Against ``run_streaming``: equal, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from neuroclear_tpu.data.dicing import DiceGrid as JaxDiceGrid
from neuroclear_tpu.nn.core import unflatten_params
from neuroclear_tpu.nn.generators import UNetDeconv as JaxUNetDeconv
from neuroclear_tpu.parallel.dice_infer import DiceInferencePipeline as JaxPipeline
from neuroclear_tpu_torch.data.dicing import DiceGrid
from neuroclear_tpu_torch.nn.generators import UNetDeconv
from neuroclear_tpu_torch.parallel.dice_infer import DiceInferencePipeline
from neuroclear_tpu_torch.utils.weights import init_flat, params_from_numpy
from test_torch_dice import E2E_LSB, LSB, _jax_g, _TorchG


def _pipes(jax_g, jax_params, torch_g, shape, roi, overlap, b, **kw):
    return (JaxPipeline(jax_g, jax_params, JaxDiceGrid(shape, roi, overlap, b), 1 / 65535.0, **kw),
            DiceInferencePipeline(torch_g, DiceGrid(shape, roi, overlap, b), 1 / 65535.0,
                                  device="cpu", **kw))


@pytest.mark.parametrize("size, roi, overlap, b, batch, repetition, out_dtype, orig", [
    (28, 16, 4, 4, 3, False, np.uint16, (26, 27, 25)),  # 8 tiles in 3 batches, 1 zero-weight
    (28, 16, 4, 4, 2, True, np.uint16, None),           # flip-TTA
    (24, 16, 8, 4, 3, False, np.uint8, (23, 24, 22)),   # heavy overlap
    (28, 16, 4, 0, 4, False, None, (25, 26, 27)),       # no border cut, f32 out
])
def test_run_matches_jax_and_run_streaming(size, roi, overlap, b, batch, repetition,
                                           out_dtype, orig):
    rng = np.random.default_rng(size + overlap + batch + repetition)
    vol = rng.integers(0, 65535, (size, size, size)).astype(np.uint16)
    w = (rng.normal(size=(3, 3, 3, 1, 1)) * 0.5).astype(np.float32)
    jax_pipe, pipe = _pipes(_jax_g, {"w": jnp.asarray(w)}, _TorchG(w), vol.shape, roi, overlap,
                            b, tile_batch=batch, repetition=repetition, out_dtype=out_dtype,
                            orig_shape=orig)
    ref = jax_pipe.run(vol)
    out = pipe.run(vol)
    assert out.dtype == ref.dtype and out.shape == ref.shape == (orig or vol.shape)
    assert out.std() > 0
    scale = 1.0 if out_dtype is not None else 65535.0
    assert np.abs(out.astype(np.float64) - ref.astype(np.float64)).max() * scale <= LSB
    assert np.array_equal(out, pipe.run_streaming(vol))


@pytest.mark.parametrize("repetition", [False, True])
def test_run_with_unet_deconv_matches_jax_and_run_streaming(repetition):
    rng = np.random.default_rng(31 + repetition)
    vol = rng.integers(0, 65535, (20, 12, 12)).astype(np.uint16)
    flat = init_flat(UNetDeconv(1, 1), seed=9)
    net = UNetDeconv(1, 1)
    net.load_state_dict(params_from_numpy(flat, net))
    net.eval()
    shape = (28, 16, 16)  # two tiles along z, overlap 4
    vp = np.pad(vol, ((0, 8), (0, 4), (0, 4)))
    jax_pipe, pipe = _pipes(JaxUNetDeconv(1, 1).apply, unflatten_params(flat), net, shape, 16,
                            4, 4, tile_batch=3, repetition=repetition, out_dtype=np.uint16,
                            orig_shape=vol.shape)
    ref = jax_pipe.run(vp)
    out = pipe.run(vp)
    assert out.shape == ref.shape == vol.shape and out.std() > 0
    assert np.abs(out.astype(np.int64) - ref.astype(np.int64)).max() <= E2E_LSB
    assert np.array_equal(out, pipe.run_streaming(vp))


def test_run_refuses_more_than_one_device():
    """Two devices are two ranks: without a process group of world 2 the
    pipeline refuses them (tests/test_torch_dp_dice.py runs them)."""
    with pytest.raises(RuntimeError, match="process group of world 2"):
        DiceInferencePipeline(_TorchG(np.zeros((3, 3, 3, 1, 1), np.float32)),
                              DiceGrid((28,) * 3, 16, 4, 4), 1.0, n_devices=2, device="cpu")
