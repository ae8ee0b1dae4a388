"""Best-checkpoint selection from a study's eval trajectory: the port of
``scripts/select_checkpoint.py``.

The study driver evaluates the protocol metrics (``test_dice``) at a ladder
of iterations; this parses every eval log, ranks the checkpoints by output
PSNR against the ground truth, and writes a machine-readable "selected"
line, which ``test_dice --load_iter`` then takes.

    python -m neuroclear_tpu_torch.scripts.select_checkpoint LOG_DIR [--write]

LOG_DIR holds the ``eval_<iter>.log`` files the driver writes; ``--write``
also writes the line to ``LOG_DIR/selected.txt`` (an atomic overwrite).
The line is the JAX script's, byte for byte.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys

# the eval log holds two protocol blocks: "Network Input vs. Groundtruth"
# then "Network Output vs. Groundtruth", each followed by "(psnr: X)"
_BLOCK = re.compile(
    r"Network (Input|Output) vs\. Groundtruth\s*\n\(psnr: ([0-9.+-eE]+)\)"
    r"(?:\s*\n\(ssim: ([0-9.+-eE]+)\))?")


def parse_eval_log(path):
    """{"input_psnr": x, "output_psnr": y, "output_ssim": z or None}, or
    None when the log holds no complete protocol block."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        return None
    out = {}
    for m in _BLOCK.finditer(text):
        which, psnr, ssim = m.group(1), float(m.group(2)), m.group(3)
        out[f"{which.lower()}_psnr"] = psnr
        if which == "Output":
            out["output_ssim"] = float(ssim) if ssim else None
    if "output_psnr" not in out:
        return None
    return out


def scan(log_dir):
    """[(iteration, metrics)] sorted by iteration; evals that produced no
    metrics are skipped."""
    rows = []
    for path in glob.glob(os.path.join(log_dir, "eval_*.log")):
        stem = os.path.basename(path)[len("eval_"):-len(".log")]
        if not stem.isdigit():
            continue
        m = parse_eval_log(path)
        if m is not None:
            rows.append((int(stem), m))
    rows.sort()
    return rows


def select(rows):
    """The argmax of the output PSNR; ties go to the earlier checkpoint
    (past the crossover, later is not better)."""
    if not rows:
        return None
    return max(rows, key=lambda r: (r[1]["output_psnr"], -r[0]))


def selected_line(rows) -> str:
    it, m = select(rows)
    return (f"selected: iter {it} output_psnr {m['output_psnr']:.4f}"
            f" (argmax over {len(rows)} evals; use with"
            f" test_dice.py --load_iter {it})")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Select the best checkpoint of a study.")
    ap.add_argument("log_dir")
    ap.add_argument("--write", action="store_true", help="also write LOG_DIR/selected.txt")
    a = ap.parse_args(argv)

    rows = scan(a.log_dir)
    if not rows:
        print("no parseable eval logs in", a.log_dir, file=sys.stderr)
        return 1
    for it, m in rows:
        print(f"iter {it:>6}  output_psnr {m['output_psnr']:.4f}"
              + (f"  ssim {m['output_ssim']:.4f}" if m.get("output_ssim")
                 is not None else "")
              + (f"  (input {m['input_psnr']:.4f})" if "input_psnr" in m
                 else ""))
    line = selected_line(rows)
    print(line, flush=True)
    if a.write:
        tmp = os.path.join(a.log_dir, ".selected.tmp")
        with open(tmp, "w") as f:
            f.write(line + "\n")
        os.replace(tmp, os.path.join(a.log_dir, "selected.txt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
