"""Analytic FLOP count of the Apollo train step and its MFU on the card: the
port of the JAX package's ``scripts/count_step_flops.py``.

    python -m neuroclear_tpu_torch.scripts.count_step_flops [--crop 148]
        [--step-seconds S] [--no-remat] [--peak-tflops 989] [--device cpu]

The step is the production Apollo configuration that the JAX script builds
(``unet_deconv`` / ``deep_linear_gen`` / ``basic`` with three layers, lsgan,
lambda_A 5, the MIP depth drawn on [2, 10], bf16; the options of the port's
bench train leg, ``bench.train_argv``), on one crop^3 crop.  Its FLOPs are
counted by the JAX script's definition (``ops/flops.py``): the products of
every convolution and matmul, forward and backward; elementwise, norm and
reduction work excluded.  With remat (the default) the recomputed forward
is counted ("hardware FLOPs"); with ``--no-remat`` the step has none
("model FLOPs").

On the card the count is taken over one step as it runs there: the hand
kernels count themselves (``flops.hand``), cuDNN's convs and PyTorch's
products are counted as ``aten`` calls, so every conv route gives the same
total.  Without ``--step-seconds`` the step time is the median of
``STEPS`` warm synchronous steps on the card's clock (CUDA events, after
``WARM`` steps, the first of them the counted one).  With ``--device cpu``
the count comes from shapes alone (``count_from_shapes``: the step runs on
the kernels' plain versions under a ``FakeTensorMode``, no data, a few
seconds at 148^3), and a rate is printed only with ``--step-seconds``.
Without a card and without ``--device cpu`` it exits nonzero.

Prints the card's name and power limit, then the JAX script's two lines:
the TFLOP of the step, then the TFLOP/s achieved and the MFU against
``--peak-tflops`` (989: the H100 SXM's dense bf16 peak).
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import sys
import tempfile

import numpy as np
import torch

from .. import bench
from ..ops.flops import FlopCounter
from ..utils.card import card_line, cuda_seconds, no_tf32, tool_device

PEAK_TFLOPS = 989.0  # H100 SXM, dense bf16
WARM, STEPS = 2, 5


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--crop", type=int, default=148)
    ap.add_argument("--step-seconds", type=float, default=None,
                    help="a measured synced step time; by default the card measures it")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--peak-tflops", type=float, default=PEAK_TFLOPS,
                    help="bf16 peak of the card (H100 SXM dense: 989 TFLOP/s)")
    ap.add_argument("--device", default=None, help="the device (default: the card; cpu)")
    return ap.parse_args(argv)


def build_model(crop: int, remat: bool, dev: torch.device):
    """The step's Apollo model on ``dev``, Kaiming weights from seed 0, and
    its options."""
    from ..models import create_model
    from ..options import train_options

    with tempfile.TemporaryDirectory() as ckpt, contextlib.redirect_stdout(sys.stderr):
        opt = train_options.parse(bench.train_argv(crop, remat, "bfloat16", str(dev), ckpt))
        model = create_model(opt, dev)
        model.init_weights(opt.seed, opt.init_type, opt.init_gain)
        model.setup(opt)
    return model, opt


def count_from_shapes(crop: int, remat: bool, model=None) -> FlopCounter:
    """The step's FLOPs from shapes alone: its gradients on the CPU on a
    fake crop (``FakeTensorMode``: shapes and dtypes, no data), every conv
    on its plain version or cuDNN's route as the switches say."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if model is None:
        model, _ = build_model(crop, remat, torch.device("cpu"))
    draws = model.draw_probes((crop,) * 3, torch.Generator().manual_seed(0))
    with FakeTensorMode(allow_non_fake_inputs=True):
        real = torch.empty((1, crop, crop, crop, 1))
        with FlopCounter() as counter:
            model.gradients(real, draws)
    return counter


def measure(crop: int = 148, remat: bool = True, device=None, step_seconds=None,
            steps: int = STEPS) -> dict:
    """The count and, on the card without ``step_seconds``, the step time:
    {"flops", "by_kind", "step_seconds", "step_s" (every timed step), "card",
    "route" ("card" or "shapes")}."""
    dev = tool_device("count_step_flops", device)
    no_tf32()
    out = {"card": card_line(dev), "step_seconds": step_seconds, "step_s": []}
    if dev.type != "cuda":
        counter = count_from_shapes(crop, remat)
        out.update(flops=counter.total, by_kind=dict(counter.by_kind), route="shapes")
        return out
    model, opt = build_model(crop, remat, dev)
    x = np.random.default_rng(0).random((1, crop, crop, crop, 1), dtype=np.float32)
    real = torch.from_numpy(x).to(dev)
    gen = torch.Generator().manual_seed(opt.seed)

    def step():
        model.optimize_parameters(real, model.draw_probes(real.shape[1:4], gen))

    with FlopCounter() as counter:
        step()
    torch.cuda.synchronize(dev)
    out.update(flops=counter.total, by_kind=dict(counter.by_kind), route="card")
    if step_seconds is None:
        for _ in range(WARM - 1):
            step()
        out["step_s"] = [cuda_seconds(step, dev) for _ in range(steps)]
        out["step_seconds"] = statistics.median(out["step_s"])
    return out


def report(res: dict, crop: int, remat: bool, peak: float) -> list:
    """The card's line, then the JAX script's two."""
    tf = res["flops"] / 1e12
    basis = ("hardware FLOPs incl. remat recompute" if remat
             else "model FLOPs, no remat recompute")
    lines = [res["card"],
             f"apollo step @ {crop}^3 ({basis}): {tf:.2f} TFLOP (matmul/conv only)"]
    t = res["step_seconds"]
    if t is None:
        lines.append("no step time: the card measures it, or pass --step-seconds")
    else:
        lines.append(f"at {t:.4f} s/it synced -> {tf / t:.1f} TFLOP/s achieved; "
                     f"MFU vs {peak:.0f} bf16 peak = {tf / t / peak:.1%}")
    return lines


def main(argv=None) -> dict:
    a = parse_args(argv)
    res = measure(a.crop, not a.no_remat, a.device, a.step_seconds)
    for line in report(res, a.crop, not a.no_remat, a.peak_tflops):
        print(line, flush=True)
    return res


if __name__ == "__main__":
    main()
