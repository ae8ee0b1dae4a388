"""Break the dice-inference wall clock down into upload, compute and
download: the port of the JAX package's ``scripts/profile_inference.py``.

    python -m neuroclear_tpu_torch.scripts.profile_inference [size] [roi] [ov] [bc]
        [--device cpu]

Defaults 900 204 15 10; ``BENCH_TILE_BATCH`` (default 1) is the tile
batch.  The pipeline is the port's bench leg's (``bench.inference_pipeline``:
``UNetDeconv`` with Kaiming weights from numpy seed 0, bf16, uint16 out) on
a uint16 volume from ``default_rng(0)``.  Each leg runs twice and each run
ends in a synchronisation (the host holding the result):
  1. H2D: the z-chunks uploaded as ``run_streaming`` uploads them
     (``DiceInferencePipeline.upload``);
  2. compute: the slab steps with the chunks already on the card, the code
     that ``run_streaming`` runs (``prepare`` and ``slab_rows``), with the
     device time of its tile batches (CUDA events around each
     tile batch, the pipeline's ``batch_span``);
  3. D2H: the emitted uint16 rows through the pipeline's host copier
     (pinned buffers, a side stream);
  3a. assembly: the rows on the host put together into the volume, as
     ``run_streaming`` ends (``host_volume``);
  3b. duplex: the chunks uploaded again while the copier drains the rows;
  4. end to end: ``run_streaming`` after one untimed run, with the device
     time of its tile batches beside its wall time.
The rows of leg 2, assembled as ``run_streaming`` assembles them
(``host_volume``), must equal leg 4's volume bit for bit, or it exits
nonzero.  Lines are the JAX script's ``# ...`` lines.  With ``--device
cpu`` it runs on the CPU and measures no device time; without a card and
without ``--device cpu`` it exits nonzero.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from .. import bench
from ..parallel.dice_infer import HostCopier
from ..utils.card import card_line, no_tf32, tool_device


def parse_args(argv=None, environ=None):
    env = os.environ if environ is None else environ
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("size", nargs="?", type=int, default=900)
    ap.add_argument("roi", nargs="?", type=int, default=204)
    ap.add_argument("ov", nargs="?", type=int, default=15)
    ap.add_argument("bc", nargs="?", type=int, default=10)
    ap.add_argument("--device", default=None, help="the device (default: the card; cpu)")
    a = ap.parse_args(argv)
    a.tile_batch = int(env.get("BENCH_TILE_BATCH", "1"))
    return a


class _Timer:
    """Seconds of a leg on the host's clock, the leg ending in a
    synchronisation of the card."""

    def __init__(self, dev: torch.device):
        self.dev = dev

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def __enter__(self):
        self.sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sync()
        self.s = time.perf_counter() - self.t0
        return False


@contextlib.contextmanager
def tile_events(pipe, on: bool = True):
    """Within it, with ``on``, each tile batch of ``pipe`` (its
    ``batch_span``) records a pair of CUDA events into the list it yields."""
    events = []
    if not on:
        yield events
        return

    @contextlib.contextmanager
    def span():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        events.append((start, end))

    pipe.batch_span = span
    try:
        yield events
    finally:
        pipe.batch_span = contextlib.nullcontext


def tile_seconds(events: list):
    """The summed device seconds of the recorded tile batches."""
    return sum(s.elapsed_time(e) for s, e in events) / 1e3


def compute_rows(pipe, vp: np.ndarray, chunks: list) -> tuple:
    """Leg 2: every slab's step on the chunks already on the device, as
    ``run_streaming`` runs it: (the run's state, the emitted rows)."""
    st = pipe.prepare(vp, chunks)
    return st, [pipe.slab_rows(st, i) for i in range(pipe.grid.z_steps)]


def profile(size: int, roi: int, ov: int, bc: int, tile_batch: int, device=None) -> dict:
    """Every leg, printed as it lands: {"card", "grid", "tile_batches",
    "legs": {name: [seconds, seconds]}, "tile_s": {"compute", "end_to_end"}
    (device seconds of the tile batches per run, None on the CPU),
    "bitwise" (leg 2 assembled against leg 4)}."""
    dev = tool_device("profile_inference", device)
    no_tf32()
    card = card_line(dev)
    print(card, flush=True)
    cuda = dev.type == "cuda"
    vol, vp, pipe = bench.inference_pipeline(size, tile_batch, roi, ov, bc, "bfloat16", dev)
    g = pipe.grid
    n_batches = -(-(g.y_steps * g.x_steps) // tile_batch) * g.z_steps
    print(f"# {size}^3 roi{roi}/ov{ov}/bc{bc}: padded {vp.shape}, "
          f"{g.z_steps}x{g.y_steps}x{g.x_steps} tiles, ext {roi + 2 * bc}, "
          f"B{tile_batch}: {n_batches} tile batches", flush=True)
    out = {"card": card, "grid": (g.z_steps, g.y_steps, g.x_steps),
           "tile_batches": n_batches, "legs": {}, "tile_s": {"compute": [], "end_to_end": []}}
    legs, timer = out["legs"], _Timer(dev)

    for trial in range(2):  # 1. H2D
        with timer:
            chunks = pipe.upload(vp)
        nbytes = sum(c.nbytes for c in chunks)
        legs.setdefault("h2d", []).append(timer.s)
        print(f"# H2D trial{trial}: {nbytes / 1e6:.0f} MB in {timer.s:.2f}s "
              f"-> {nbytes / timer.s / 1e6:.0f} MB/s", flush=True)

    for trial in range(2):  # 2. compute, inputs on the device
        with tile_events(pipe, cuda) as events, timer:
            st, emitted = compute_rows(pipe, vp, chunks)
        tiles = tile_seconds(events) if cuda else None
        legs.setdefault("compute", []).append(timer.s)
        out["tile_s"]["compute"].append(tiles)
        print(f"# compute trial{trial} ({'build+' if trial == 0 else ''}run): {timer.s:.2f}s "
              f"-> {vol.size / timer.s / 1e6:.1f} Mvoxel/s; tile batches on the device "
              + (f"{tiles:.2f}s" if cuda else "not measured on the CPU"), flush=True)

    out_bytes = sum(e.nbytes for e in emitted)
    for trial in range(2):  # 3. D2H of the emitted rows
        copier = HostCopier(dev)
        with timer:
            for e in emitted:
                copier.submit(e)
            arrays = copier.results()
        legs.setdefault("d2h", []).append(timer.s)
        print(f"# D2H trial{trial}: {out_bytes / 1e6:.0f} MB in {timer.s:.2f}s "
              f"-> {out_bytes / timer.s / 1e6:.0f} MB/s", flush=True)
    for trial in range(2):  # the host's assembly of the rows
        with timer:
            assembled = pipe.host_volume(st, arrays)
        legs.setdefault("assemble", []).append(timer.s)
        print(f"# assembly (host) trial{trial}: {assembled.nbytes / 1e6:.0f} MB in "
              f"{timer.s:.2f}s", flush=True)
    del arrays, st

    for trial in range(2):  # 3b. duplex: upload while the rows drain
        copier = HostCopier(dev)
        with timer:
            for e in emitted:
                copier.submit(e)
            up = pipe.upload(vp)
            copier.results()
        del up
        legs.setdefault("duplex", []).append(timer.s)
        tot = nbytes + out_bytes
        print(f"# duplex H2D+D2H trial{trial}: {tot / 1e6:.0f} MB total in {timer.s:.2f}s "
              f"-> {tot / timer.s / 1e6:.0f} MB/s aggregate", flush=True)
    del emitted, chunks

    steady = pipe.run_streaming(vp)  # 4. end to end, after one untimed run
    for trial in range(2):
        del steady
        with tile_events(pipe, cuda) as events, timer:
            steady = pipe.run_streaming(vp)
        tiles = tile_seconds(events) if cuda else None
        legs.setdefault("end_to_end", []).append(timer.s)
        out["tile_s"]["end_to_end"].append(tiles)
        print(f"# end-to-end steady trial{trial}: {timer.s:.2f}s -> "
              f"{size ** 3 / timer.s / 1e6:.1f} Mvoxel/s; tile batches on the device "
              + (f"{tiles:.2f}s" if cuda else "not measured on the CPU"), flush=True)
    out["bitwise"] = bool(assembled.shape == steady.shape and np.array_equal(assembled, steady))
    print(f"# compute rows assembled against run_streaming: "
          f"{'equal bit for bit' if out['bitwise'] else 'DIFFERENT'}", flush=True)
    return out


def main(argv=None) -> dict:
    a = parse_args(argv)
    res = profile(a.size, a.roi, a.ov, a.bc, a.tile_batch, a.device)
    if not res["bitwise"]:
        raise SystemExit("profile_inference: the compute leg's rows differ from run_streaming's")
    return res


if __name__ == "__main__":
    main()
