"""Device-memory footprint of one training step: the port of the JAX
package's ``scripts/mem_study.py``.

    python -m neuroclear_tpu_torch.scripts.mem_study [--crop 148]
        [--model axial_to_lateral_gan_apollo|..._athena|..._dryops]
        [--conversion_plane yz xy] [--remat | --no-remat] [--f32] [--hlo]
        [--device cpu]

Builds the JAX script's train argv (``train_argv``) with the port's
options, the model on the card with Kaiming weights from seed 0, and takes
one warm step (Adam's moments come to exist in it) and one measured step on
a zero crop^3 crop.  Prints one row per value, in GiB:
  * arguments: what the step takes and keeps, the counterpart of XLA's
    ``argument_size_in_bytes``: the parameters and the Adam state in the
    JAX layout (``argument_bytes``: the nets' JAX flat arrays, each
    optimizer's int32 count and its two f32 moments) and the input crop;
  * ``max_memory_allocated`` and ``max_memory_reserved`` over the measured
    step;
  * temp: the allocated peak less the arguments.
With ``--hlo``, the counterpart of XLA's largest buffers: the 20 largest
blocks that a third step allocates and holds at its peak, each with the
frame of the port that allocated it (the allocator's recorded history).
With ``--device cpu`` only the arguments are printed: the peak is read on
the card.  Without a card and without ``--device cpu`` it exits nonzero.

One departure from the JAX script: its argv gives Dryops ``--netG_B`` and
``--conversion_plane``, which the Dryops model does not take, so JAX's
parser refuses it; the port leaves the two options out for Dryops.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import tempfile

import torch

from ..utils.card import card_line, no_tf32, tool_device

GIB = 2 ** 30
TOP_BLOCKS = 20
# what the allocator records for --hlo: Python frames at each allocation
HISTORY = {"context": "alloc", "stacks": "python"}
_PACKAGE = "neuroclear_tpu_torch"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--crop", type=int, default=148)
    ap.add_argument("--model", default="axial_to_lateral_gan_apollo",
                    help="model variant to analyze (apollo/athena/dryops)")
    ap.add_argument("--conversion_plane", nargs=2, default=["yz", "xy"],
                    help="athena/dryops source+target planes")
    ap.add_argument("--remat", action="store_true", default=True)
    ap.add_argument("--no-remat", dest="remat", action="store_false")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--hlo", action="store_true",
                    help="also print the largest blocks alive at the peak")
    ap.add_argument("--device", default=None, help="the device (default: the card; cpu)")
    return ap.parse_args(argv)


def train_argv(args, checkpoints_dir: str) -> list:
    """The JAX script's train argv (``mem_study.py:38-55``), its scratch
    paths under ``checkpoints_dir``; Dryops without the two options it does
    not take."""
    c = args.crop
    argv = [
        "--dataroot", f"{checkpoints_dir}/unused", "--name", "memstudy",
        "--checkpoints_dir", checkpoints_dir,
        "--model", args.model,
        "--dataset_mode", "singlevolume",
        "--netG", "unet_deconv", "--netG_B", "deep_linear_gen",
        "--netD", "basic", "--gan_mode", "lsgan", "--init_type", "kaiming",
        "--norm", "instance", "--batch_size", "1",
        "--lambda_A", "5",
        "--crop_size", str(c), str(c), str(c),
        "--lr_policy", "constant", "--seed", "0",
    ]
    if "apollo" in args.model:
        argv += ["--lambda_plane", "1", "1", "1",
                 "--randomize_projection_depth", "--projection_depth", "10"]
    elif "dryops" in args.model:
        i = argv.index("--netG_B")
        del argv[i:i + 2]
    else:
        argv += ["--conversion_plane"] + list(args.conversion_plane)
    if not args.f32:
        argv += ["--precision", "bfloat16"]
    if args.remat:
        argv += ["--remat"]
    return argv


def build(args, dev: torch.device):
    """(model, opt) of the study's argv on ``dev``, weights from seed 0."""
    from ..models import create_model
    from ..options import train_options

    with tempfile.TemporaryDirectory() as ckpt, contextlib.redirect_stdout(sys.stderr):
        opt = train_options.parse(train_argv(args, ckpt) + ["--device", str(dev)])
        model = create_model(opt, dev)
        model.init_weights(opt.seed, opt.init_type, opt.init_gain)
        model.setup(opt)
    return model, opt


def argument_bytes(model) -> int:
    """The parameters and the Adam state in the JAX layout: every net's JAX
    flat arrays (buffers included, as the JAX parameter tree holds them),
    then each optimizer's count and moments (``optim_arrays``; zeros where
    no step has run yet, the same bytes)."""
    from ..models.base_model import optim_arrays
    from ..utils.weights import flat_from_module

    params = sum(a.nbytes for net in model.nets.values()
                 for a in flat_from_module(net).values())
    state = sum(a.nbytes for k, a in optim_arrays(model._optim_groups(), []).items()
                if not k.startswith("__lr"))
    return params + state


def _trace(dev: torch.device) -> list:
    return torch.cuda.memory._snapshot(dev)["device_traces"][dev.index or 0]


def largest_blocks(trace: list, n: int = TOP_BLOCKS) -> list:
    """The ``n`` largest blocks alive at the peak of the blocks that the
    recorded history ``trace`` allocated (blocks allocated before the
    recording, the arguments among them, are not in it): (bytes, where),
    where the innermost frame in the port."""
    live, total, peak, at_peak = {}, 0, -1, {}
    for ev in trace:
        action = ev["action"]
        if action == "alloc":
            live[ev["addr"]] = ev
            total += ev["size"]
            if total > peak:
                peak, at_peak = total, dict(live)
        elif action == "free_requested" and ev["addr"] in live:
            total -= live.pop(ev["addr"])["size"]
    rows = []
    for ev in sorted(at_peak.values(), key=lambda e: -e["size"])[:n]:
        frames = ev.get("frames") or []
        f = ([f for f in frames if _PACKAGE in f["filename"]] or frames or [None])[0]
        where = ("no frame recorded" if f is None else
                 f"{f['filename'].split(_PACKAGE + '/')[-1]}:{f['line']} {f['name']}")
        rows.append((ev["size"], where))
    return rows


def study(args) -> dict:
    """{"card", "arguments", and on the card "max_allocated",
    "max_reserved", "temp", "blocks" (with --hlo)} in bytes."""
    dev = tool_device("mem_study", args.device)
    no_tf32()
    model, _ = build(args, dev)
    crop = torch.zeros((1, args.crop, args.crop, args.crop, 1), device=dev)
    out = {"card": card_line(dev), "arguments": argument_bytes(model) + crop.nbytes}
    if dev.type != "cuda":
        return out
    gen = torch.Generator().manual_seed(0)

    def step():
        model.optimize_parameters(crop, model.draw_probes(crop.shape[1:4], gen))
        torch.cuda.synchronize(dev)

    step()
    torch.cuda.reset_peak_memory_stats(dev)
    step()
    out["max_allocated"] = torch.cuda.max_memory_allocated(dev)
    out["max_reserved"] = torch.cuda.max_memory_reserved(dev)
    out["temp"] = out["max_allocated"] - out["arguments"]
    if args.hlo:
        out["blocks"] = recorded_blocks(step, dev)
    return out


def recorded_blocks(step, dev: torch.device) -> list:
    """``largest_blocks`` of one more ``step`` under the allocator's
    recorded history (Python frames at each allocation)."""
    torch.cuda.memory._record_memory_history(max_entries=1_000_000, device=dev, **HISTORY)
    try:
        step()
        return largest_blocks(_trace(dev))
    finally:
        torch.cuda.memory._record_memory_history(enabled=None, device=dev)


def main(argv=None) -> dict:
    args = parse_args(argv)
    res = study(args)
    print(res["card"], flush=True)
    print(f"# {args.model} @ {args.crop}^3, {'f32' if args.f32 else 'bf16'}, "
          f"{'remat' if args.remat else 'no remat'}", flush=True)
    for key, label in (("arguments", "arguments (params+adam+input)"),
                       ("max_allocated", "max_memory_allocated"),
                       ("max_reserved", "max_memory_reserved"),
                       ("temp", "temp (peak - arguments)")):
        if key in res:
            print(f"{label:30s} {res[key] / GIB:9.3f} GiB", flush=True)
    if "max_allocated" not in res:
        print("the peak is read on the card: run without --device cpu", flush=True)
    for size, where in res.get("blocks", []):
        print(f"{size / 2 ** 20:10.1f} MiB  {where}", flush=True)
    return res


if __name__ == "__main__":
    main()
