"""Headline benchmark of the port: dice inference voxel rate at 900^3 and the
Apollo training step rate; the port of the JAX package's ``bench.py``.

    python -m neuroclear_tpu_torch.bench [--device cpu]

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "extra": {...}}
ALWAYS: any failure is reported inside the JSON (``extra.error`` / per-leg
error strings), never as a bare traceback with no line.

Baselines (BASELINE.md): reference inference on a GTX 1080-Ti = ~2.0
Mvoxel/s (900^3 in 5-8 min, README tile geometry 120/15/10); reference
training = 0.16 it/s at 148^3 crops (11k iterations in ~19 h).
``vs_baseline`` and ``train_vs_baseline`` divide by those two.

Legs, each in a fresh subprocess (``--leg``), so that a leg that dies (out
of memory, a kernel that fails to build) releases the card with its
process; the parent applies a per-leg timeout and keeps going:
  * probe: a 256x256 sum on the device, and its name; if it fails, no
    other leg runs;
  * inference at the README tile geometry (roi 120, overlap 15, border cut
    10), tile batch ``BENCH_TILE_BATCH_120``: the headline;
  * the Apollo step at 148^3 with ``--remat`` and at 108^3, in it/s;
  * inference at roi 204, tile batch ``BENCH_TILE_BATCH``.
Every inference leg runs the W-pair kernel (``NEUROCLEAR_PALLAS_WCONV=1``
in its environment): a leg that fails lands as its ``*_error`` key, with no
retry on another tile batch or on cuDNN, so the headline is always the
kernel path's or null.  The legs run on the card unless ``--device cpu`` is
given; without a card the record says so and no leg runs.

Env knobs: BENCH_SIZE (default 900), BENCH_TILE_BATCH (default 1, the
roi-204 leg), BENCH_TILE_BATCH_120 (default 4), BENCH_PRECISION (default
bfloat16), BENCH_TRAIN=0 to skip the train legs, BENCH_FAST_ONLY=1 to skip
the roi-204 leg, BENCH_LEG_TIMEOUT (default 1500 s), BENCH_TOTAL_BUDGET
(default 1800 s: a deadline across ALL legs; legs that no longer fit are
skipped and the partial record is printed).  A SIGTERM prints the legs
that landed.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# ---- total budget and partial record ---------------------------------------
# A global deadline gates every leg: a leg that cannot fit is skipped, not
# started; the record is built as the legs land, so a SIGTERM at any moment
# prints whatever legs already landed.
_T0 = time.time()
_TOTAL_BUDGET = float(os.environ.get("BENCH_TOTAL_BUDGET", "1800"))
_EMIT_RESERVE = 15.0  # seconds kept back for the JSON print
_RECORD = {"metric": "dice_inference_voxels_per_sec", "value": None,
           "unit": "voxel/s", "vs_baseline": None, "extra": {}}
_EMITTED = False
_CHILD = None  # the leg subprocess running (killed on SIGTERM)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INFER_BASELINE = 2.0e6  # voxel/s, GTX 1080-Ti (BASELINE.md)
TRAIN_BASELINE = 0.16   # it/s at 148^3 (BASELINE.md)


def _remaining() -> float:
    return _TOTAL_BUDGET - (time.time() - _T0) - _EMIT_RESERVE


def _emit():
    global _EMITTED
    if _EMITTED:
        return
    _EMITTED = True
    print(json.dumps(_RECORD), flush=True)


def _on_sigterm(signum, frame):
    _RECORD["extra"]["partial"] = "SIGTERM before all legs ran"
    _emit()
    if _CHILD is not None:
        try:
            _CHILD.kill()
        except Exception:
            pass
    os._exit(0)


def leg_command(leg_args: list) -> list:
    """The command line of one leg: this module under the running Python."""
    return [sys.executable, "-m", "neuroclear_tpu_torch.bench", *leg_args]


def leg_env(env: dict | None = None) -> dict:
    """The environment of a leg: this one, ``env`` on top, and the package's
    root on PYTHONPATH (a leg may start from any directory)."""
    full = dict(os.environ)
    full.update(env or {})
    full["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, full.get("PYTHONPATH")) if p)
    return full


def _precision() -> str:
    return os.environ.get("BENCH_PRECISION", "bfloat16")


# --------------------------------------------------------------------------
# legs (each runs in its own subprocess; prints one JSON line on stdout)
# --------------------------------------------------------------------------

def leg_probe(device=None) -> dict:
    """Device liveness and identity: a 256x256 sum on the device."""
    import torch

    from . import resolve_device

    dev = resolve_device(device)
    ok = float(torch.ones((256, 256), device=dev).sum()) == 256.0 * 256.0
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"ok": ok, "device": f"{dev.type}:{name}"}


def inference_pipeline(size: int, tile_batch: int, roi: int, ov: int, bc: int,
                       precision: str, device=None, flat: dict | None = None):
    """The inference leg's input and pipeline: (vol, vp, pipe).  ``vol`` is
    the (size,)*3 uint16 volume from numpy seed 0, ``vp`` it padded for
    dicing, ``pipe`` a ``DiceInferencePipeline`` over ``UNetDeconv(1, 1,
    norm="instance")`` with the JAX flat weights ``flat`` (by default
    Kaiming, gain 0.02, from numpy seed 0), uint16 out, on ``device``."""
    from . import resolve_device
    from .data.dicing import DiceGrid
    from .nn.generators import UNetDeconv
    from .parallel.dice_infer import DiceInferencePipeline
    from .utils.imageops import pad_for_dicing
    from .utils.weights import init_flat, params_from_numpy

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 65535, (size, size, size), dtype=np.uint16)
    vp = pad_for_dicing(vol, roi, ov)
    grid = DiceGrid(vp.shape, roi, ov, bc)
    net = UNetDeconv(1, 1, norm="instance")
    if flat is None:
        flat = init_flat(net, "kaiming", 0.02, seed=0)
    net.load_state_dict(params_from_numpy(flat, net))
    net.to(dev)
    pipe = DiceInferencePipeline(net, grid, 1 / 65535.0, tile_batch=tile_batch,
                                 precision=precision, out_dtype=np.uint16,
                                 orig_shape=vol.shape, device=dev)
    return vol, vp, pipe


def leg_inference(size: int, tile_batch: int, roi: int, ov: int, bc: int, device=None,
                  precision: str | None = None, flat: dict | None = None,
                  keep_volumes: bool = False) -> dict:
    """One untimed run of the pipeline, then a timed one that ends when the
    uint16 volume is on the host: {"vox_per_s", "steady_s", "first_s",
    "wpallas"}, and with ``keep_volumes`` "volumes" (the two runs'
    outputs; otherwise the first is freed before the second starts)."""
    from .ops import wconv
    from .utils.card import no_tf32

    no_tf32()
    vol, vp, pipe = inference_pipeline(size, tile_batch, roi, ov, bc,
                                       precision or _precision(), device, flat)
    t0 = time.perf_counter()
    out = pipe.run_streaming(vp)
    first = time.perf_counter() - t0
    volumes = [out] if keep_volumes else []
    del out
    gc.collect()
    t0 = time.perf_counter()
    out = pipe.run_streaming(vp)
    dt = time.perf_counter() - t0
    volumes.append(out)
    del out
    n_vox = vol.size
    print(f"# inference {size}^3 roi{roi}/ov{ov}/bc{bc} B{tile_batch}: "
          f"first (build + run) {first:.1f}s, "
          f"steady {dt:.2f}s -> {n_vox / dt / 1e6:.1f} Mvoxel/s", file=sys.stderr)
    res = {"vox_per_s": n_vox / dt, "steady_s": dt, "first_s": first,
           "wpallas": wconv.ENABLED}
    if keep_volumes:
        res["volumes"] = volumes
    return res


def train_argv(crop: int, remat: bool, precision: str, device, checkpoints_dir: str) -> list:
    """The trainer's argv of the train leg: the option set of the JAX
    bench's ``leg_train`` (the production Apollo configuration)."""
    argv = ["--dataroot", "bench", "--name", "bench", "--checkpoints_dir", checkpoints_dir,
            "--model", "axial_to_lateral_gan_apollo", "--input_nc", "1", "--output_nc", "1",
            "--ngf", "64", "--ndf", "64", "--netG", "unet_deconv", "--netG_B",
            "deep_linear_gen", "--netD", "basic", "--n_layers_D", "3", "--norm", "instance",
            "--init_type", "kaiming", "--init_gain", "0.02", "--no_dropout", "--gan_mode",
            "lsgan", "--lambda_A", "5", "--lambda_plane", "1", "1", "1",
            "--randomize_projection_depth", "--projection_depth", "10",
            "--min_projection_depth", "2", "--beta1", "0.1", "--lr", "1e-4", "--direction",
            "AtoB", "--lr_policy", "constant", "--n_epochs", "100", "--n_epochs_decay", "100",
            "--epoch_count", "1", "--lr_decay_iters", "50", "--seed", "0",
            "--precision", precision, "--crop_size", str(crop), str(crop), str(crop)]
    if remat:
        argv.append("--remat")
    if device is not None:
        argv += ["--device", str(device)]
    return argv


def leg_train(crop: int, remat: bool, device=None, precision: str | None = None,
              steps: int = 5) -> dict:
    """Synchronous step time (each step fetches its losses) of the
    production Apollo configuration at ``crop``^3, on the switch's default
    (the W-pair kernel): one warm step, then ``steps`` timed ones on one
    crop from numpy seed 0, each with fresh probe draws as the trainer
    draws them.  {"it_per_s", "step_ms" (the median), "wpallas", "losses"
    (the last step's)}."""
    import torch

    from . import resolve_device
    from .models import create_model
    from .ops import wconv
    from .options import device_of, train_options
    from .utils.card import no_tf32

    no_tf32()
    with tempfile.TemporaryDirectory() as ckpt, contextlib.redirect_stdout(sys.stderr):
        # stdout stays one JSON line
        opt = train_options.parse(train_argv(crop, remat, precision or _precision(), device,
                                             ckpt))
        dev = resolve_device(device_of(opt))
        model = create_model(opt, dev)
        model.init_weights(opt.seed, opt.init_type, opt.init_gain)
        model.setup(opt)
    x = np.random.default_rng(0).random((1, crop, crop, crop, 1), dtype=np.float32)
    real = torch.from_numpy(x).to(dev)
    gen = torch.Generator().manual_seed(opt.seed)
    names = model.loss_names

    def step() -> dict:
        draws = model.draw_probes(real.shape[1:4], gen)
        losses, *_ = model.optimize_parameters(real, draws)
        return dict(zip(names, torch.stack([losses[n] for n in names]).tolist()))

    step()  # warm
    ts = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses = step()
        ts.append(time.perf_counter() - t0)
    dt = statistics.median(ts)
    print(f"# train {crop}^3{' +remat' if remat else ''}: "
          f"{dt * 1000:.0f} ms/it -> {1 / dt:.2f} it/s", file=sys.stderr)
    return {"it_per_s": 1.0 / dt, "step_ms": dt * 1000, "wpallas": wconv.ENABLED,
            "losses": losses}


# --------------------------------------------------------------------------
# parent orchestration
# --------------------------------------------------------------------------

def _run_leg(leg_args: list, timeout_s: float, env: dict | None = None):
    """Spawn ``python -m neuroclear_tpu_torch.bench --leg ...``; return
    (parsed_json, None) or (None, error_string).  The child's stderr passes
    through.  The per-leg timeout is clamped to the global remaining budget;
    a leg that cannot get at least 60 s is skipped outright."""
    global _CHILD
    rem = _remaining()
    if rem < 60:
        return None, "skipped (total budget exhausted)"
    timeout_s = min(timeout_s, rem)
    _CHILD = subprocess.Popen(leg_command(leg_args), env=leg_env(env),
                              stdout=subprocess.PIPE, text=True)
    try:
        out, _ = _CHILD.communicate(timeout=timeout_s)
        rc = _CHILD.returncode
    except subprocess.TimeoutExpired:
        _CHILD.kill()
        _CHILD.communicate()
        _CHILD = None
        return None, f"timeout after {timeout_s:.0f}s"
    _CHILD = None
    for line in reversed((out or "").strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line), None
            except json.JSONDecodeError:
                break
    tail = (out or "").strip().splitlines()[-3:]
    return None, f"rc={rc}, no JSON ({' | '.join(tail)[:300]})"


def main(device: str | None = None):
    """The whole benchmark; every leg on ``device`` (the card when None)."""
    size = int(os.environ.get("BENCH_SIZE", "900"))
    leg_timeout = float(os.environ.get("BENCH_LEG_TIMEOUT", "1500"))
    tile_batch = int(os.environ.get("BENCH_TILE_BATCH", "1"))
    dev_args = [] if device is None else ["--device", str(device)]

    signal.signal(signal.SIGTERM, _on_sigterm)
    extra = _RECORD["extra"]

    from . import resolve_device

    try:
        resolve_device(device)
    except (RuntimeError, ValueError) as e:
        # no card and the CPU not asked for: nothing runs anywhere
        extra["error"] = f"device unavailable: {e}"
        _emit()
        return

    # liveness probe: on the card a failed probe means no usable card
    probe, err = _run_leg(["--leg", "probe", *dev_args], timeout_s=300)
    if not (probe and probe.get("ok")):
        extra["error"] = f"device probe failed: {err or probe}"
        _emit()
        return
    extra["device"] = probe["device"]

    def inference(roi, tb):
        """One inference leg on the W-pair kernel, in a fresh subprocess."""
        args = ["--leg", "inference", "--size", str(size), "--tile-batch", str(tb),
                "--roi", str(roi), "--ov", "15", "--bc", "10", *dev_args]
        return _run_leg(args, leg_timeout, env={"NEUROCLEAR_PALLAS_WCONV": "1"})

    # README geometry first: it is the headline (like-for-like with the
    # reference's 120/15/10 example flags), so a later leg cannot eat it
    r120, err120 = inference(120, int(os.environ.get("BENCH_TILE_BATCH_120", "4")))
    if r120:
        extra["inference_vox_per_s_roi120"] = round(r120["vox_per_s"], 1)
        extra["wpallas_roi120"] = r120["wpallas"]
        # the headline lands the moment its leg does, so a later SIGTERM
        # still carries it
        _RECORD["value"] = round(r120["vox_per_s"], 1)
        _RECORD["vs_baseline"] = round(r120["vox_per_s"] / INFER_BASELINE, 2)
    else:
        extra["inference_vox_per_s_roi120"] = None
        extra["roi120_error"] = err120

    # train legs before the roi-204 geometry: when the budget runs short the
    # optional leg is dropped, not the baseline train comparison
    if os.environ.get("BENCH_TRAIN", "1") != "0":
        t148, errt = _run_leg(["--leg", "train", "--crop", "148", "--remat", *dev_args],
                              leg_timeout)
        if t148:
            it148 = t148["it_per_s"]
            extra["train_iters_per_sec_148"] = round(it148, 3)
            extra["train_vs_baseline"] = round(it148 / TRAIN_BASELINE, 2)
            extra["train_11k_wallclock_hours"] = round(11000 / it148 / 3600, 2)
        else:
            extra["train148_error"] = errt
        t108, errt = _run_leg(["--leg", "train", "--crop", "108", *dev_args], leg_timeout)
        if t108:
            extra["train_iters_per_sec_108"] = round(t108["it_per_s"], 3)
        else:
            extra["train108_error"] = errt

    r204 = None
    if os.environ.get("BENCH_FAST_ONLY", "0") != "1":
        r204, err204 = inference(204, tile_batch)
        if r204:
            extra["inference_vox_per_s_roi204"] = round(r204["vox_per_s"], 1)
            extra["wpallas"] = r204["wpallas"]
        else:
            extra["roi204_error"] = err204
    if not r120 and not r204:
        extra["error"] = "all inference legs failed"

    extra["bench_elapsed_s"] = round(time.time() - _T0, 1)
    _emit()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--leg", choices=["probe", "inference", "train"])
    ap.add_argument("--size", type=int, default=900)
    ap.add_argument("--tile-batch", type=int, default=1)
    ap.add_argument("--roi", type=int, default=120)
    ap.add_argument("--ov", type=int, default=15)
    ap.add_argument("--bc", type=int, default=10)
    ap.add_argument("--crop", type=int, default=148)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the device of every leg (default: the card; cpu to run on the CPU)")
    return ap.parse_args(argv)


def run(argv=None) -> int:
    a = parse_args(argv)
    if a.leg is None:
        try:
            main(a.device)
        except Exception as e:  # the record must always hold a JSON line
            _RECORD["extra"]["error"] = f"{type(e).__name__}: {e}"
            _emit()
        return 0
    try:
        if a.leg == "probe":
            res = leg_probe(a.device)
        elif a.leg == "inference":
            res = leg_inference(a.size, a.tile_batch, a.roi, a.ov, a.bc, a.device)
        else:
            res = leg_train(a.crop, a.remat, a.device)
    except Exception as e:  # the parent reads this line as the leg's error
        print(f"# leg failed: {type(e).__name__}: {e}", flush=True)
        raise
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
