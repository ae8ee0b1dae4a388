"""The study queue's status at a glance: the port of
``scripts/study_status.sh``.

    python -m neuroclear_tpu_torch.scripts.study_status

One row per study of ``run_study_queue``: the newest complete checkpoint of
its bank in ``study_state/`` against the iterations that end it, whether
its final eval is done, the last line of its driver's log, then the last
three PSNR lines of its eval logs; last, the port's study processes that
are running.  The JAX script's note of a ``.study/STOP`` file is left out
with the file (``run_study_queue`` says why).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

from .run_quality_study import REPO
from .run_study_queue import STUDIES, bank_iter, study_dir

LIVE = ("train_onecube", "test_dice", "run_quality", "run_study_queue")


def rows(root: str = REPO) -> list:
    """The status lines of every study, banks under ``root/study_state``
    and logs under ``root/.study``."""
    out = []
    for study in STUDIES:
        log = study_dir(root, study.log)
        line = f"{study.bank:<14} banked {bank_iter(root, study.bank):>6} / {study.max_iters:<6}"
        if os.path.exists(os.path.join(log, "eval_final.done")):
            line += "  final-eval done"
        last = ""
        if os.path.exists(os.path.join(log, "driver.log")):
            with open(os.path.join(log, "driver.log")) as f:
                lines = f.read().splitlines()
            last = lines[-1] if lines else ""
        out.append(f"{line}  {last or '(no live log)'}")
        psnr = []
        for path in sorted(glob.glob(os.path.join(log, "eval_*.log"))):
            with open(path, errors="replace") as f:
                psnr += [ln.rstrip("\n") for ln in f if "psnr" in ln]
        out += ["    " + ln for ln in psnr[-3:]]
    return out


def live() -> list:
    """``  live: <pid> <command>`` for each running process of the study
    (read from /proc; none where it is absent)."""
    out = []
    for path in sorted(glob.glob("/proc/[0-9]*/cmdline")):
        pid = int(path.split("/")[2])
        try:
            with open(path, "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:
            continue
        if pid != os.getpid() and any(name in cmd for name in LIVE):
            out.append(f"  live: {pid} {cmd[:80]}")
    return out


def main(argv=None, root: str = REPO) -> int:
    argparse.ArgumentParser(description="The study queue's status.").parse_args(argv)
    for line in rows(root) + live():
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
