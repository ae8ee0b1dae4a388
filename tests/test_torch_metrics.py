"""The port's slab-streamed protocol metrics
(neuroclear_tpu_torch/parallel/metrics.py, torch on the CPU here) against
the JAX package's ``parallel/metrics.protocol_metrics`` and the host float64
path, on the shapes and slabs of tests/test_device_metrics.py: PSNR within
1e-3 dB and SSIM within 1e-4, the f32 streaming bound that test states; the
quantisation LUT bit-exact."""

import numpy as np
import pytest

from neuroclear_tpu.parallel import metrics as jax_metrics
from neuroclear_tpu_torch import test_dice
from neuroclear_tpu_torch.parallel import metrics
from neuroclear_tpu_torch.utils import imageops


def _volumes(shape, dtype=np.uint16, top=60000):
    rng = np.random.default_rng(0)
    gt = rng.integers(0, top, size=shape).astype(np.int64)
    real = np.clip(gt + rng.normal(0, top / 15, shape).astype(np.int64), 0, top)
    fake = np.clip(gt + rng.normal(0, top / 40, shape).astype(np.int64), 0, top)
    return real.astype(dtype), fake.astype(dtype), gt.astype(dtype)


@pytest.mark.parametrize("shape, slab, dtype, top", [((32, 28, 26), 9, np.uint16, 60000),
                                                      ((17, 16, 15), 64, np.uint16, 60000),
                                                      ((20, 12, 9), 5, np.uint8, 250)])
def test_protocol_metrics_match_jax_and_host(shape, slab, dtype, top):
    real, fake, gt = _volumes(shape, dtype, top)
    got = metrics.protocol_metrics(real, fake, gt, slab=slab, device="cpu")
    for ref in (jax_metrics.protocol_metrics(real, fake, gt, slab=slab),
                test_dice.host_metrics(real, fake, gt)):
        for k in ref:
            tol = 1e-3 if k.startswith("psnr") else 1e-4
            assert abs(got[k] - ref[k]) < tol, (k, got[k], ref[k])


def test_quant_lut_bit_exact():
    """lut[vol] equals the host double-quantise chain and the JAX LUT."""
    rng = np.random.default_rng(3)
    for scale in (60000, 900, 2):
        v = rng.integers(0, scale, size=(13, 11, 9)).astype(np.uint16)
        h = v
        for _ in range(2):
            h = imageops.normalize(imageops.standardize(h), np.uint8)
        lut = metrics._quant_lut(v)
        assert np.array_equal(lut[v], h)
        assert np.array_equal(lut, jax_metrics._quant_lut(v))


def test_switch_gate_and_refusals(monkeypatch):
    monkeypatch.setenv("NEUROCLEAR_DEVICE_METRICS", "0")
    assert not metrics.enabled()
    monkeypatch.delenv("NEUROCLEAR_DEVICE_METRICS")
    assert metrics.enabled()
    a = np.zeros((8, 8, 8), np.uint16)
    assert metrics.supported(a, a, a) and not metrics.supported(a.astype(np.float32), a, a)
    assert not metrics.supported(a[:5], a[:5], a[:5])
    with pytest.raises(ValueError):
        metrics.protocol_metrics(a, a, np.zeros((8, 8, 7), np.uint16), device="cpu")
    with pytest.raises(ValueError):
        metrics.protocol_metrics(a[:5], a[:5], a[:5], device="cpu")
