"""Command-line options of the port's entry points, and what their two
parsers share: the JAX CLI's ``--gpu_ids`` beside the port's ``--device``,
and the options dump of ``BaseOptions.print_options``."""

from __future__ import annotations

import argparse
import os

ROADMAP = "(ROADMAP.md, queue 1)"


def add_gpu_ids(p: argparse.ArgumentParser) -> None:
    p.add_argument("--gpu_ids", default="0",
                   help="device ids as the JAX CLI takes them: -1 for the CPU, else the "
                        "first id names the card (cuda:<id>); one card only")
    p.add_argument("--device", default=None,
                   help="cuda, cuda:<i> or cpu; when given it overrides --gpu_ids")


def device_of(opt) -> str:
    """The device the options ask for: ``--device`` when given, else
    ``--gpu_ids`` parsed as the JAX CLI parses it (the non-negative ids; none
    means the CPU).  More than one id is refused: multi-GPU is not ported."""
    ids = [int(s) for s in str(opt.gpu_ids).split(",") if int(s) >= 0]
    if len(ids) > 1:
        raise NotImplementedError(f"--gpu_ids {opt.gpu_ids}: more than one card is not "
                                  f"ported yet {ROADMAP}")
    if opt.device is not None:
        return opt.device
    return f"cuda:{ids[0]}" if ids else "cpu"


def refuse_other_values(opt, ported: dict) -> None:
    """NotImplementedError for a flag whose value is not in ``ported``
    ({flag: values the port runs})."""
    for flag, values in ported.items():
        if getattr(opt, flag) not in values:
            raise NotImplementedError(f"--{flag} {getattr(opt, flag)} is not ported yet "
                                      f"{ROADMAP}; the port takes {values}")


def print_options(opt, parser: argparse.ArgumentParser, path: str) -> None:
    """Print the options, marking those off their defaults, and write them
    to ``path``, as ``BaseOptions.print_options`` does."""
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
