"""The roi-120 (README geometry) configuration sweep: tile batch x the W-pair
kernel on or off, one fresh ``bench --leg inference`` subprocess per pair;
the port of ``scripts/sweep_roi120.sh``.

    python -m neuroclear_tpu_torch.scripts.sweep_roi120 [SIZE] [--device cpu]

SIZE defaults to 900.  For B in 2, 4, 8 and W in 1, 0 it prints ``=== B=<B>
wpallas=<W>``, runs the leg under ``NEUROCLEAR_PALLAS_WCONV=<W>`` with a
timeout of ``SWEEP_LEG_TIMEOUT`` seconds (default 1800), and prints the
last two lines of its output (stderr and stdout together): the leg's
summary and its JSON.  Each leg runs alone on the card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from .. import bench

TILE_BATCHES = (2, 4, 8)
WPALLAS = (1, 0)


def leg_runs(size: int, device=None) -> list:
    """(argv, env) of each leg, in the sweep's order."""
    dev_args = [] if device is None else ["--device", str(device)]
    return [(bench.leg_command(["--leg", "inference", "--size", str(size), "--tile-batch",
                                str(b), "--roi", "120", "--ov", "15", "--bc", "10",
                                *dev_args]),
             bench.leg_env({"NEUROCLEAR_PALLAS_WCONV": str(w)}))
            for b in TILE_BATCHES for w in WPALLAS]


def _text(out) -> str:
    return out.decode(errors="replace") if isinstance(out, bytes) else (out or "")


def main(argv=None, run=subprocess.run) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("size", nargs="?", type=int, default=900)
    ap.add_argument("--device", default=None, help="the legs' device (default: the card)")
    a = ap.parse_args(argv)
    timeout = float(os.environ.get("SWEEP_LEG_TIMEOUT", "1800"))
    for argv_leg, env in leg_runs(a.size, a.device):
        b = argv_leg[argv_leg.index("--tile-batch") + 1]
        print(f"=== B={b} wpallas={env['NEUROCLEAR_PALLAS_WCONV']}", flush=True)
        try:
            out = _text(run(argv_leg, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, timeout=timeout).stdout)
        except subprocess.TimeoutExpired as e:
            out = _text(e.output)
        lines = out.strip().splitlines()[-2:]
        if lines:
            print("\n".join(lines), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
