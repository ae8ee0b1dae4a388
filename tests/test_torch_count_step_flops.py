"""The port's step FLOP count (``neuroclear_tpu_torch/scripts/count_step_flops.py``,
``ops/flops.py``) against the JAX script's (``scripts/count_step_flops.py``,
loaded by path and left as it is) on the CPU.

The JAX side runs as the script does: its ``main`` builds the Apollo model
from its own option set (captured here), and ``count_jaxpr`` walks the
jaxpr of the traced step at ``CROP``^3.  The port counts its step from
shapes (``count_from_shapes``: its gradients under a ``FakeTensorMode``).
Bound: 1e-6 relative; the two counts are equal to the FLOP (no term
differs: both count each conv as JAX's ``conv_general_dilated`` of the same
function, transposed convs with their dilation's zeros, and both runs
recompute under remat the same generator units, PyTorch's checkpoints
stopping early where JAX's partial evaluation drops the unneeded
recomputation).  The count does not depend on the conv route: the W-pair
kernel's plain versions, cuDNN's route (``NEUROCLEAR_PALLAS_WCONV=0``) and
the dense-K route (``NEUROCLEAR_PALLAS_CONV=1``) give the same total; the
hand wrappers' own counts (where they launch on the card) equal their plain
versions' counted products."""

import argparse
import contextlib
import importlib.util
import io
import os
import sys

import jax
import numpy as np
import pytest
import torch

from neuroclear_tpu_torch import bench
from neuroclear_tpu_torch.ops import conv3x3, flops, wconv
from neuroclear_tpu_torch.options import train_options
from neuroclear_tpu_torch.scripts import count_step_flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = 24
ROUTE_CROP = 64
REL = 1e-6


def load_jax_script(name: str):
    """The JAX package's ``scripts/<name>.py`` as a module, unedited."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


def jax_main_values(monkeypatch, argv: list) -> tuple:
    """(the JAX script's parsed arguments, the option set its ``main`` builds
    the model from), ``main`` stopped at the model's construction."""
    from neuroclear_tpu.models import axial_to_lateral_gan_apollo_model as apollo

    mod = load_jax_script("count_step_flops")
    got = {}
    parse = argparse.ArgumentParser.parse_args

    def record_args(self, args=None, namespace=None):
        got["args"] = parse(self, args, namespace)
        return got["args"]

    class Model:
        def __init__(self, opt):
            got["opt"] = opt
            raise _Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", record_args)
    monkeypatch.setattr(apollo, "AxialToLateralGANApolloModel", Model)
    monkeypatch.setattr(sys, "argv", ["count_step_flops.py", *argv])
    with pytest.raises(_Stop), contextlib.redirect_stderr(io.StringIO()):
        mod.main()
    return vars(got["args"]), got["opt"]


@pytest.fixture(scope="module")
def jax_counts(tmp_path_factory):
    """JAX's ``count_jaxpr`` of its traced step at CROP^3, by remat."""
    from neuroclear_tpu.models.axial_to_lateral_gan_apollo_model import (
        AxialToLateralGANApolloModel)

    mod = load_jax_script("count_step_flops")
    mp = pytest.MonkeyPatch()
    try:
        _, opt = jax_main_values(mp, [])
    finally:
        mp.undo()
    counts = {}
    for remat in (True, False):
        o = argparse.Namespace(**{**vars(opt), "remat": remat,
                                  "checkpoints_dir": str(tmp_path_factory.mktemp("ck"))})
        with contextlib.redirect_stdout(io.StringIO()):
            m = AxialToLateralGANApolloModel(o)
            m.setup(o)
        real = jax.ShapeDtypeStruct((1, CROP, CROP, CROP, 1), np.float32)
        lr = jax.ShapeDtypeStruct((), np.float32)
        g = {k: m.params[k] for k in ("G_A", "G_B")}
        d = {k: m.params[k] for k in m.model_names[2:]}
        traced = m._step.trace(g, d, m.opt_state, m.next_rng(), real, lr)
        counts[remat] = mod.count_jaxpr(traced.jaxpr.jaxpr)
    return counts


@pytest.fixture(scope="module")
def port_models():
    """The port's step model on the CPU, by remat (built once)."""
    return {remat: count_step_flops.build_model(CROP, remat, torch.device("cpu"))[0]
            for remat in (True, False)}


@pytest.mark.parametrize("remat", [True, False], ids=["hardware", "model"])
def test_count_equals_jax_count_jaxpr(jax_counts, port_models, remat):
    got = count_step_flops.count_from_shapes(CROP, remat, port_models[remat])
    want = jax_counts[remat]
    assert abs(got.total - want) <= REL * want, (got.total, want, dict(got.by_kind))
    assert got.total == want


def test_remat_adds_the_recomputed_forward(jax_counts, port_models):
    hw = count_step_flops.count_from_shapes(CROP, True, port_models[True])
    model = count_step_flops.count_from_shapes(CROP, False, port_models[False])
    assert hw.total > model.total
    # the backward is the same: the difference is the recomputed forward
    assert hw.by_kind["conv_backward"] == model.by_kind["conv_backward"]
    assert jax_counts[True] - jax_counts[False] == hw.total - model.total


@pytest.mark.parametrize("route", ["wconv_off", "dense_k"])
def test_count_does_not_depend_on_the_route(monkeypatch, port_models, route):
    """The W-pair route (its plain versions here, the default) against
    cuDNN's (``NEUROCLEAR_PALLAS_WCONV=0``, read at import: its value here)
    and the dense-K route (``NEUROCLEAR_PALLAS_CONV=1``, read per call), at
    ROUTE_CROP^3: the dense-K gate takes W >= 32 at half resolution."""
    model = port_models[True]
    base = count_step_flops.count_from_shapes(ROUTE_CROP, True, model)
    if route == "wconv_off":
        monkeypatch.setattr(wconv, "ENABLED", False)
    else:
        monkeypatch.setenv("NEUROCLEAR_PALLAS_CONV", "1")
    other = count_step_flops.count_from_shapes(ROUTE_CROP, True, model)
    assert other.total == base.total
    # the route did change: the products moved between conv and matmul
    assert dict(other.by_kind) != dict(base.by_kind), dict(base.by_kind)


@pytest.mark.parametrize("cin", [64, 128])
def test_hand_counts_equal_their_plain_versions(cin):
    """What each hand wrapper adds where it launches (``flops.hand``)
    against the counted products of its plain version, on the CPU."""
    rng = np.random.default_rng(cin)
    x = torch.from_numpy(rng.standard_normal((1, 4, 6, 8, cin)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((1, 4, 6, 8, 64)).astype(np.float32))
    wt = torch.from_numpy(rng.standard_normal((27, 64, cin)).astype(np.float32))
    wt128 = torch.from_numpy(rng.standard_normal((27, 128, cin)).astype(np.float32))
    cases = [(lambda: conv3x3.conv3d_plain(x, wt), conv3x3.conv_flops(x.shape, cin, 64)),
             (lambda: wconv.conv3d_dx_plain(g, wt), conv3x3.conv_flops(g.shape, 64, cin)),
             (lambda: wconv.conv3d_dw_plain(x, g), wconv.dw_flops(x.shape)),
             (lambda: conv3x3.conv3d_plain(x, wt128), conv3x3.conv_flops(x.shape, cin, 128))]
    for fn, want in cases:
        with flops.FlopCounter() as c:
            fn()
        assert c.total == want, (dict(c.by_kind), want)


def test_hand_wrappers_count_where_they_launch(monkeypatch):
    """The launch branch of each conv wrapper, reached with a tensor on the
    meta device and the kernel launch replaced by an empty result: the
    counter sees only the wrapper's own count."""
    def fake_launch(x, wt, bias, what):
        return torch.empty(x.shape[:4] + (wt.shape[1],), dtype=x.dtype, device=x.device)

    monkeypatch.setattr(wconv, "launch", fake_launch)
    monkeypatch.setattr(conv3x3, "launch", fake_launch)
    for fn in (wconv.conv3d, wconv.conv3d_dx, conv3x3.conv3d):
        monkeypatch.setattr(fn, "launches", 0)
    x = torch.empty((1, 4, 6, 8, 128), dtype=torch.bfloat16, device="meta")
    g = torch.empty((1, 4, 6, 8, 64), dtype=torch.bfloat16, device="meta")
    wt = torch.empty((27, 64, 128), dtype=torch.bfloat16, device="meta")
    bias = torch.empty(64, device="meta")
    with flops.FlopCounter() as c:
        wconv.conv3d(x, wt, bias)
        wconv.conv3d_dx(g, wt)
        conv3x3.conv3d(x, wt, bias)
    assert dict(c.by_kind) == {"wconv3x3x3": conv3x3.conv_flops(x.shape, 128, 64),
                               "wconv_dx": conv3x3.conv_flops(g.shape, 64, 128),
                               "conv3x3": conv3x3.conv_flops(x.shape, 128, 64)}
    assert (wconv.conv3d.launches, wconv.conv3d_dx.launches, conv3x3.conv3d.launches) == (1, 1, 1)


@pytest.mark.parametrize("argv", [[], ["--crop", "36"],
                                  ["--no-remat", "--step-seconds", "0.5", "--peak-tflops", "100"]])
def test_argv_parses_as_jax(monkeypatch, argv):
    """Every argument of the JAX script parses to its value; two defaults
    differ by design: no step time (the card measures it) and the H100's
    bf16 peak."""
    jax_args, _ = jax_main_values(monkeypatch, argv)
    port = vars(count_step_flops.parse_args(argv))
    assert port.pop("device") is None
    for key in ("step_seconds", "peak_tflops"):
        if f"--{key.replace('_', '-')}" not in argv:
            assert (jax_args.pop(key), port.pop(key)) == (
                {"step_seconds": 1.72, "peak_tflops": 197.0}[key],
                {"step_seconds": None, "peak_tflops": 989.0}[key])
    assert port == jax_args


def test_model_options_are_the_jax_scripts(monkeypatch):
    """The port's step model takes the JAX script's option set: every
    option both have, but the paths and the device."""
    _, jax_opt = jax_main_values(monkeypatch, [])
    port = vars(train_options.parse(bench.train_argv(CROP, True, "bfloat16", "cpu", "ck")))
    skip = {"checkpoints_dir", "name", "gpu_ids", "isTrain"}
    shared = sorted(k for k in vars(jax_opt) if k in port and k not in skip)
    assert len(shared) >= 25, shared
    for key in shared:
        want = getattr(jax_opt, key)
        got = port[key]
        assert (list(got) if isinstance(got, tuple) else got) == want, key


def test_cpu_main_prints_the_count(capsys):
    res = count_step_flops.main(["--crop", str(CROP), "--step-seconds", "0.5", "--device",
                                 "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "cpu" and res["route"] == "shapes"
    tf = res["flops"] / 1e12
    assert out[1] == (f"apollo step @ {CROP}^3 (hardware FLOPs incl. remat recompute): "
                      f"{tf:.2f} TFLOP (matmul/conv only)")
    assert out[2] == (f"at 0.5000 s/it synced -> {tf / 0.5:.1f} TFLOP/s achieved; MFU vs 989 "
                      f"bf16 peak = {tf / 0.5 / 989:.1%}")


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs a machine without one")
    with pytest.raises(SystemExit, match="count_step_flops: no CUDA device"):
        count_step_flops.main(["--crop", str(CROP)])
