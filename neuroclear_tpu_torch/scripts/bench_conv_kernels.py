"""Time each route of the U-Net's hot cout-64 3x3x3 convs at the production
shapes: the port of the JAX package's ``scripts/bench_conv_kernels.py``.

    python -m neuroclear_tpu_torch.scripts.bench_conv_kernels [reps] [sizes...]
        [--device cpu]

Defaults 10 and 148 224 (the training crop and the roi-204 inference
tile); ``CONV_BENCH_CIN`` (default "64 128": ``double_conv1.conv1`` and
``ex_conv1_1.conv0``), ``CONV_BENCH_DTYPE`` (default bfloat16) and
``CONV_BENCH_GRAD`` ("1": forward, input gradient and weight gradient, the
FLOPs x3; default "0": the forward).  Rows per (size, cin), cout 64:
  * ``cudnn``: ``F.conv3d`` on the channels-last view, plus the bias, as
    ``nn.core.Conv`` runs it off the hand routes (the library column of
    PERF.md's table); with the gradients, cuDNN's dgrad and wgrad;
  * ``wpair``: the W-pair kernel (``ops/wconv.py``), inside
    ``wconv.supported``; with the gradients its dx and dw kernels;
  * ``densek``: the dense-K kernel (``ops/conv3x3.py``) inside
    ``conv3x3.fits``; with the gradients its autograd Function, whose
    backward is cuDNN's (the kernel has no backward of its own).
The JAX script's ``zpack2`` and ``wpack2`` rows are XLA formulations that
pack lanes for the TPU's MXU; they have no counterpart on the card, and no
row stands for them.

Parity comes first: each hand route against ``F.conv3d`` in f32 (and, with
the gradients, against f32 autograd) at (1, 16, 24, 24, 64) x (3, 3, 3, 64,
64) * 0.05, in the script's dtype, relative to the reference's largest
magnitude, within ``PARITY_REL``; a miss exits nonzero.  Each row is one
warm call, then ``reps`` calls between two CUDA events, printed as the JAX
script's ``{size}^3 cin{cin}->64 {name}: ms TFLOP/s`` line; a row that
raises prints its ``FAILED`` line and the exit code is nonzero.  The hand
kernels take bfloat16 only.  Without a card and without ``--device cpu``
it exits nonzero; on the CPU every route runs its plain version, slowly.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import conv3x3, wconv
from ..utils.card import card_line, no_tf32, tool_device

COUT = 64
PARITY_X, PARITY_W = (1, 16, 24, 24, 64), (3, 3, 3, 64, 64)
# a bf16 route's error, relative to the reference's largest magnitude: the
# inputs rounded to bf16 (2^-9 each) move a 1,728-term sum by about 2^-8 of
# its spread, the output's own rounding adds 2^-9 of its value; the largest
# of 2.4M outputs stays well inside 1e-2
PARITY_REL = {"bfloat16": 1e-2, "float32": 1e-5}


def parse_args(argv=None, environ=None):
    env = os.environ if environ is None else environ
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("reps", nargs="?", type=int, default=10)
    ap.add_argument("sizes", nargs="*", type=int)
    ap.add_argument("--device", default=None, help="the device (default: the card; cpu)")
    a = ap.parse_args(argv)
    a.sizes = a.sizes or [148, 224]
    a.cins = [int(c) for c in env.get("CONV_BENCH_CIN", "64 128").split()]
    a.dtype = env.get("CONV_BENCH_DTYPE", "bfloat16")
    a.grad = env.get("CONV_BENCH_GRAD", "0") == "1"
    return a


def conv_flops(size: int, cin: int, grad: bool) -> int:
    """The JAX script's count: 2 x size^3 x 27 x cin x cout, x3 with the
    gradients."""
    return 2 * size ** 3 * 27 * cin * COUT * (3 if grad else 1)


def routes(size: int, cin: int) -> list:
    """The rows of one shape, in order."""
    shape = (1, size, size, size, cin)
    names = ["cudnn"]
    if wconv.supported(shape, cin, COUT, 3, 1, 1, 3):
        names.append("wpair")
    if conv3x3.fits(shape, cin, COUT, 3, 1, 1, 3):
        names.append("densek")
    return names


def _torch_weight(wt: torch.Tensor) -> torch.Tensor:
    """Packed (27, cout, cin) -> PyTorch's (cout, cin, 3, 3, 3)."""
    return wt.reshape(3, 3, 3, wt.shape[1], wt.shape[2]).permute(3, 4, 0, 1, 2)


def cudnn_conv(x, wt, bias):
    y = F.conv3d(x.movedim(-1, 1), _torch_weight(wt), None, 1, 1).movedim(1, -1)
    return y + bias.to(y.dtype)


def forward(name: str):
    """The route's forward: (x, packed weights, f32 bias) -> y."""
    return {"cudnn": cudnn_conv, "wpair": wconv.conv3d, "densek": conv3x3.conv3d}[name]


def with_gradients(name: str):
    """The route's forward, input gradient and weight gradient on the
    cotangent ``gy``: (x, wt, bias, gy) -> (y, dx, dw)."""
    if name == "wpair":
        def run(x, wt, bias, gy):
            return wconv.conv3d(x, wt, bias), wconv.conv3d_dx(gy, wt), wconv.conv3d_dw(x, gy)
        return run

    def run(x, wt, bias, gy):
        x, wt = x.detach().requires_grad_(), wt.detach().requires_grad_()
        with torch.enable_grad():
            y = (cudnn_conv(x, wt, bias) if name == "cudnn"
                 else conv3x3.Conv3x3Fn.apply(x, wt, bias, False))
            dx, dw = torch.autograd.grad(y, (x, wt), gy)
        return y.detach(), dx, dw
    return run


def parity(name: str, grad: bool, dtype: torch.dtype, dev: torch.device) -> float:
    """The route's largest error against f32 at the parity shape, relative
    to the f32 reference's largest magnitude (the worst of y, dx and dw
    with the gradients)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(PARITY_X).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.standard_normal(PARITY_W) * 0.05).astype(np.float32)).to(dev)
    wt = w.permute(0, 1, 2, 4, 3).reshape(27, COUT, PARITY_X[-1]).contiguous()
    bias = torch.zeros(COUT, device=dev)
    gy = torch.from_numpy(rng.standard_normal(PARITY_X[:4] + (COUT,)).astype(np.float32)).to(dev)
    if grad:
        ref = with_gradients("cudnn")(x, wt, bias, gy)
        got = with_gradients(name)(x.to(dtype), wt.to(dtype), bias, gy.to(dtype))
    else:
        ref, got = [cudnn_conv(x, wt, bias)], [forward(name)(x.to(dtype), wt.to(dtype), bias)]
    return max(float((r - g.float()).abs().max() / r.abs().max()) for r, g in zip(ref, got))


def time_row(fn, args, reps: int, dev: torch.device) -> float:
    """Seconds per call: one warm call, then ``reps`` between two CUDA
    events (on the CPU, the host's clock)."""
    fn(*args)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        return (time.perf_counter() - t0) / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def bench(a) -> dict:
    """Parity, then every row: {"card", "parity": {route: error}, "rows":
    [{"size", "cin", "name", "ms", "tflops"} or {..., "error"}], "ok"}."""
    dev = tool_device("bench_conv_kernels", a.device)
    no_tf32()
    dtype = torch.bfloat16 if a.dtype == "bfloat16" else torch.float32
    out = {"card": card_line(dev), "parity": {}, "rows": [], "ok": True}
    print(out["card"], flush=True)
    print(f"# device={dev} dtype={a.dtype} reps={a.reps} grad={int(a.grad)}", flush=True)
    for name in ("wpair", "densek"):
        err = parity(name, a.grad, dtype, dev)
        out["parity"][name] = err
        print(f"# {name} parity (f32 16x24x24{', fwd+dx+dw' if a.grad else ''}): "
              f"rel err {err:.2e} (bound {PARITY_REL[a.dtype]:.0e})", flush=True)
        if not err < PARITY_REL[a.dtype]:
            raise AssertionError(f"bench_conv_kernels: {name} parity {err:.3e} over "
                                 f"{PARITY_REL[a.dtype]:.0e}")
    rng = np.random.default_rng(0)
    for size in a.sizes:
        for cin in a.cins:
            gen = torch.Generator(device=dev).manual_seed(size * 1000 + cin)
            shape = (1, size, size, size, cin)
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            wt = (torch.randn((27, COUT, cin), generator=gen, device=dev) * 0.05).to(dtype)
            bias = torch.from_numpy(rng.standard_normal(COUT).astype(np.float32)).to(dev)
            args = (x, wt, bias)
            if a.grad:
                args += (torch.randn(shape[:4] + (COUT,), generator=gen,
                                     device=dev).to(dtype),)
            flops = conv_flops(size, cin, a.grad)
            for name in routes(size, cin):
                fn = with_gradients(name) if a.grad else forward(name)
                row = {"size": size, "cin": cin, "name": name}
                try:
                    t = time_row(fn, args, a.reps, dev)
                    row.update(ms=t * 1e3, tflops=flops / t / 1e12)
                    print(f"{size}^3 cin{cin}->64 {name:8s}: {t * 1e3:7.2f} ms  "
                          f"{flops / t / 1e12:6.1f} TFLOP/s", flush=True)
                except Exception as e:  # a row that fails is printed, and fails the run
                    row["error"] = f"{type(e).__name__}: {str(e)[:200]}"
                    out["ok"] = False
                    print(f"{size}^3 cin{cin}->64 {name:8s}: FAILED {row['error']}",
                          flush=True)
                out["rows"].append(row)
            del x, wt, args
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    res = bench(parse_args(argv))
    if not res["ok"]:
        sys.exit(1)
    return res


if __name__ == "__main__":
    main()
