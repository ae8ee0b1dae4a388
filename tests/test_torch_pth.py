"""``.pth`` interchange with the original PyTorch NeuroClear: the port's
``utils/torch_export.py`` and ``python -m neuroclear_tpu_torch.export_checkpoint``
against the JAX package's ``utils/torch_export.py``, for unet_deconv,
deep_linear_gen and basic.

  * JAX ``export_pth`` -> the port's ``import_pth`` -> the port's network
    gives the JAX network's output on the same input (f32, rtol 1e-4 and
    atol 1e-5 as tests/test_torch_unet.py; the transposed convs' layout,
    where a wrong permutation or a spatial flip would hide, shows here);
  * the port's ``export_pth`` -> JAX ``import_pth`` -> arrays bitwise equal
    to the JAX parameters, and the two ``.pth`` files hold the same keys in
    the same order with equal tensors;
  * the CLI round trip ``.npz`` -> ``.pth`` -> ``.npz`` bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuroclear_tpu.nn import discriminators as JD
from neuroclear_tpu.nn import generators as JG
from neuroclear_tpu.nn.core import flatten_params, unflatten_params
from neuroclear_tpu.utils import torch_export as jax_tx
from neuroclear_tpu_torch import export_checkpoint
from neuroclear_tpu_torch.nn import factory
from neuroclear_tpu_torch.utils import torch_export as tx
from neuroclear_tpu_torch.utils.weights import load_npz, params_from_numpy

ARCHS = {
    # arch: (JAX network, the port's network, input shape, key)
    "unet_deconv": (lambda: JG.UNetDeconv(1, 1, norm="instance"),
                    lambda: factory.define_G(1, 1, 64, "unet_deconv"), (1, 12, 12, 8, 1), 1),
    "deep_linear_gen": (lambda: JG.DeepLinearGenerator(1, 1),
                        lambda: factory.define_G(1, 1, 64, "deep_linear_gen"), (1, 9, 8, 7, 1),
                        2),
    "basic": (lambda: JD.NLayerDiscriminator(1, 64, 3, "instance", dim=2),
              lambda: factory.define_D(1, 64, "basic"), (2, 40, 36, 1), 3),
}


def _jax_params(arch):
    jnet, _, _, key = ARCHS[arch]
    net = jnet()
    params = net.init(jax.random.PRNGKey(key), "kaiming", 0.02)
    # non-zero biases, so a bias put in the wrong place shows
    flat = {k: (np.asarray(v) + (0.01 * np.arange(v.size).reshape(v.shape) if k.endswith(".b")
                                 else 0)).astype(np.float32)
            for k, v in flatten_params(params).items()}
    return net, flat


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_jax_pth_runs_in_the_port(tmp_path, arch):
    jnet, flat = _jax_params(arch)
    path = str(tmp_path / "latest_net_G_A.pth")
    jax_tx.export_pth(unflatten_params(flat), arch, path)
    got = tx.import_pth(path, arch)
    assert sorted(got) == sorted(flat)
    for k in flat:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], flat[k]), k
    net = ARCHS[arch][1]()
    net.load_state_dict(params_from_numpy(got, net))
    x = np.random.default_rng(0).random(ARCHS[arch][2]).astype(np.float32)
    with torch.no_grad():
        ours = net(torch.from_numpy(x)).numpy()
    ref = np.asarray(jnet.apply(unflatten_params(flat), jnp.asarray(x)))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_port_pth_loads_in_jax(tmp_path, arch):
    _, flat = _jax_params(arch)
    ours, theirs = str(tmp_path / "port.pth"), str(tmp_path / "jax.pth")
    tx.export_pth(flat, arch, ours)
    jax_tx.export_pth(unflatten_params(flat), arch, theirs)
    back = flatten_params(jax_tx.import_pth(ours, arch))
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert np.array_equal(np.asarray(back[k]), flat[k]), k
    a = torch.load(ours, weights_only=True)
    b = torch.load(theirs, weights_only=True)
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) and a[k].is_contiguous() for k in a)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cli_round_trip_is_bitwise(tmp_path, arch):
    _, flat = _jax_params(arch)
    src = tmp_path / "iter_3_net_G_A.npz"
    np.savez(src, **flat)
    pth, back = tmp_path / "iter_3_net_G_A.pth", tmp_path / "back.npz"
    export_checkpoint.main(["--mode", "export", "--arch", arch, "--src", str(src),
                            "--dst", str(pth)])
    export_checkpoint.main(["--mode", "import", "--arch", arch, "--src", str(pth),
                            "--dst", str(back)])
    got = load_npz(str(back))
    assert sorted(got) == sorted(flat)
    for k in flat:
        assert np.array_equal(got[k], flat[k]), k
    assert jax_tx.import_pth(str(pth), arch).keys() == unflatten_params(flat).keys()
