"""Command-line options of the port's entry points, and what their two
parsers share: the JAX CLI's ``--gpu_ids`` beside the port's ``--device``,
the flags the JAX CLI declares and never reads, ``--suffix``,
``--direction`` and ``--debug``, and the options dump of
``BaseOptions.print_options``."""

from __future__ import annotations

import argparse
import os

from ..parallel.train_parallel import is_main, torchrun_env

ROADMAP = "(ROADMAP.md, queue 1)"


def add_gpu_ids(p: argparse.ArgumentParser) -> None:
    p.add_argument("--gpu_ids", default="0",
                   help="device ids as the JAX CLI takes them: -1 for the CPU, else the "
                        "first id names the card (cuda:<id>); several ids only under "
                        "torchrun, one per local rank")
    p.add_argument("--device", default=None,
                   help="cuda, cuda:<i> or cpu; when given it overrides --gpu_ids (under "
                        "torchrun, cuda means cuda:<LOCAL_RANK>)")


# flags the JAX parsers declare and no JAX code path reads: taken, with their
# JAX defaults, so that a JAX command line parses, and change nothing
UNREAD = {"--load_size": dict(type=int, default=286),
          "--no_pin_memory": dict(action="store_true"),
          "--display_winsize": dict(type=int, default=256),
          "--server": dict(default="not-specified")}
UNREAD_TRAIN = {"--momentum": dict(type=float, default=0.9),
                "--display_ncols": dict(type=int, default=4),
                "--display_server": dict(default="http://localhost"),
                "--display_env": dict(default="main"),
                "--display_port": dict(type=int, default=8097),
                "--dice_size": dict(type=int, nargs="+", default=[0, 0, 0])}
UNREAD_TEST = {"--ntest": dict(type=int, default=float("inf")),
               "--background_threshold": dict(type=float, nargs="+", default=[None, None]),
               "--reference_slice_range": dict(type=int, nargs="+", default=[None, None]),
               "--compare_with_gt": dict(action="store_true")}


def add_jax_flags(p: argparse.ArgumentParser, unread: dict) -> None:
    """``--suffix``, ``--direction``, ``--debug`` and the ``unread`` flags."""
    for flag, kw in {**UNREAD, **unread}.items():
        p.add_argument(flag, **kw, help="no effect: the JAX CLI declares it and never reads it")
    p.add_argument("--suffix", default="",
                   help="template appended to the name as _<suffix>, formatted from the parsed "
                        "options (e.g. '{netG}_{crop_size}')")
    p.add_argument("--direction", default="AtoB",
                   help="AtoB; the port's datasets hold no B volume")
    p.add_argument("--debug", action="store_true",
                   help="the JAX CLI's jax.profiler server: refused (use --profile_dir)")


def apply_jax_flags(opt, refuse_btoa: bool) -> None:
    """Refuse ``--debug`` (and ``--direction BtoA`` where ``refuse_btoa``:
    the step reads the missing B volume) with a pointer to ROADMAP.md;
    append the formatted ``--suffix`` to the name, as ``BaseOptions.parse``
    does after the date stamp."""
    if opt.debug:
        raise NotImplementedError(f"--debug (a jax.profiler server) is not ported {ROADMAP}; "
                                  "--profile_dir writes a torch.profiler trace")
    if opt.direction not in ("AtoB", "BtoA"):
        raise ValueError(f"--direction {opt.direction}: AtoB or BtoA")
    if refuse_btoa and opt.direction == "BtoA":
        raise NotImplementedError(f"--direction BtoA reads a B volume, which the port's "
                                  f"datasets do not hold {ROADMAP}")
    if opt.suffix:
        opt.name = opt.name + "_" + opt.suffix.format(**vars(opt))


def device_of(opt) -> str:
    """The device the options ask for: ``--device`` when given, else
    ``--gpu_ids`` parsed as the JAX CLI parses it (the non-negative ids; none
    means the CPU).  Under torchrun each process drives one card: local rank
    r takes ``cuda:<ids[r]>`` where ``--gpu_ids`` lists one id per local
    rank, else ``cuda:<r>`` (``--device cuda`` too).  Outside torchrun more
    than one id is refused: one process drives one card."""
    ids = [int(s) for s in str(opt.gpu_ids).split(",") if int(s) >= 0]
    env = torchrun_env()
    if env is None and len(ids) > 1:
        raise NotImplementedError(
            f"--gpu_ids {opt.gpu_ids}: one process drives one card; run one process per "
            f"card under torchrun (python -m torch.distributed.run --nproc_per_node "
            f"{len(ids)} -m neuroclear_tpu_torch.train_onecube ...) (ROADMAP.md, queue 3)")
    if opt.device is not None:
        if env is not None and opt.device == "cuda":
            return f"cuda:{env['local_rank']}"
        return opt.device
    if not ids:
        return "cpu"
    if env is None:
        return f"cuda:{ids[0]}"
    if len(ids) == env["local_world"]:
        return f"cuda:{ids[env['local_rank']]}"
    if len(ids) == 1:
        return f"cuda:{env['local_rank']}"
    raise ValueError(f"--gpu_ids {opt.gpu_ids}: under torchrun give one id per local rank "
                     f"({env['local_world']}), or none")


def refuse_other_values(opt, ported: dict) -> None:
    """NotImplementedError for a flag whose value is not in ``ported``
    ({flag: values the port runs})."""
    for flag, values in ported.items():
        if getattr(opt, flag) not in values:
            raise NotImplementedError(f"--{flag} {getattr(opt, flag)} is not ported yet "
                                      f"{ROADMAP}; the port takes {values}")


def print_options(opt, parser: argparse.ArgumentParser, path: str) -> None:
    """Print the options, marking those off their defaults, and write them
    to ``path``, as ``BaseOptions.print_options`` does (rank 0 alone under
    data parallelism)."""
    if not is_main():
        return
    lines = ["----------------- Options ---------------"]
    for k, v in sorted(vars(opt).items()):
        default = parser.get_default(k)
        comment = f"\t[default: {default}]" if v != default else ""
        lines.append("{:>25}: {:<30}{}".format(str(k), str(v), comment))
    lines.append("----------------- End -------------------")
    message = "\n".join(lines)
    print(message, flush=True)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wt") as f:
        f.write(message + "\n")
