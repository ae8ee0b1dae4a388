"""The study queue: the port of ``scripts/run_study_queue.sh``.  It runs the
three simulation studies of ``docs/QUALITY.md`` in turn, each to its end,
resuming from its bank in ``study_state/``:

  1. s4: Apollo at 148^3 on the sigma_z = 4 volume (``--preset s4``), 11000
     iterations;
  2. ga8: Apollo with ``--grad_accum 8`` on the default volume, 1375
     iterations;
  3. athena: Athena (``--conversion_plane yz xy``) at 128^3 on the artifact
     volume (``--mode artifact``), host-window crops, 3000 iterations.

    python -m neuroclear_tpu_torch.scripts.run_study_queue [skip-names...]

e.g. ``s4`` to start with ga8.  For each study not skipped and not done, it
generates the study's 700^3 volumes under ``.study/`` of the repository
when they are absent (``generate_synthetic``), then runs the study's driver
(``run_quality_study``, a child process) on them with the knobs the JAX
queue sets in its environment.  A study is done when its bank holds an
``iter_*_optim.npz`` at or past its iteration count and its log directory
holds ``eval_final.done`` (the driver writes it after the final eval).

Left out of the JAX script: the ``.study/STOP`` file, which the TPU-era
``bench.py`` wrote to claim the chip from a running queue (the port's
benchmark stops no study), and the knobs that served it and the git
banking of the TPU dev harness (``CLEAR_STOP``, ``AUTOBANK``; the driver
leaves both out).  Where the JAX script ends with exit code 0 whatever its
studies did, this one goes on to the next study as the JAX script does and
ends with exit code 1 if a driver failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys

from .run_quality_study import PACKAGE, REPO, last_ckpt


@dataclasses.dataclass(frozen=True)
class Study:
    """One study of the queue: its skip name, its bank (the driver's NAME),
    the iterations that make it done, its directories under ``.study/``, the
    generator's flags and the driver's knobs."""
    skip: str
    bank: str
    max_iters: int
    data: str
    ckpt: str
    log: str
    gen_flags: tuple
    knobs: dict


STUDIES = (
    Study("s4", "apollo148s4", 11000, "sim700_s4", "ckpt_s4", "log_s4", ("--preset", "s4"),
          {"NAME": "apollo148s4", "RESULTS": "results_s4", "GEN_FLAGS": "--preset s4",
           "SEG_ITERS": "2000", "SEG_TIMEOUT": "4500", "WATCHDOG": "900"}),
    Study("ga8", "apollo148ga8", 1375, "sim700", "ckpt_ga8", "log_ga8", (),
          {"NAME": "apollo148ga8", "RESULTS": "results_ga8",
           "EXTRA_TRAIN_FLAGS": "--grad_accum 8", "SEG_ITERS": "250", "SAVE_FREQ": "25",
           "PRINT_FREQ": "7", "EVALS": "375 750 1125", "MAX_ITERS": "1375",
           "SEG_TIMEOUT": "4500", "WATCHDOG": "900"}),
    Study("athena", "athena148", 3000, "sim700_art", "ckpt_art", "log_art",
          ("--mode", "artifact"),
          {"NAME": "athena148", "RESULTS": "results_art", "GEN_FLAGS": "--mode artifact",
           "CROP": "128", "NEUROCLEAR_HOST_WINDOW": "1",
           "MODEL_FLAGS": "--model axial_to_lateral_gan_athena --conversion_plane yz xy",
           "EVALS": "1500 3000", "MAX_ITERS": "3000", "SEG_ITERS": "1000",
           "SEG_TIMEOUT": "4500", "WATCHDOG": "900"}),
)


def study_dir(root: str, name: str) -> str:
    return os.path.join(root, ".study", name)


def bank_iter(root: str, bank: str) -> int:
    """The newest complete checkpoint of ``study_state/<bank>``, or 0."""
    return last_ckpt(os.path.join(root, "study_state", bank))


def study_done(root: str, study: Study) -> bool:
    return (bank_iter(root, study.bank) >= study.max_iters
            and os.path.exists(os.path.join(study_dir(root, study.log), "eval_final.done")))


def run_module(module: str, argv: list, env: dict, root: str) -> int:
    """``python -m <PACKAGE>.<module> argv`` in ``root`` with ``env``: its
    exit code."""
    env = dict(env, PYTHONPATH=os.pathsep.join([REPO, *filter(None, [env.get("PYTHONPATH")])]))
    return subprocess.run([sys.executable, "-m", f"{PACKAGE}.{module}", *argv], env=env,
                          cwd=root).returncode


def main(argv=None, root: str = REPO, run=run_module) -> int:
    """Run the queue over the banks of ``root`` (the repository), writing
    under ``root/.study``; ``run(module, argv, env, root)`` runs one step
    (``run_module``: a child process).  The exit code: 1 if a volume could
    not be generated (the queue stops there, as the JAX script does) or a
    driver failed, else 0."""
    ap = argparse.ArgumentParser(description="Run the s4, ga8 and Athena studies in turn.")
    ap.add_argument("skip", nargs="*",
                    help=f"studies to skip, of {' '.join(s.skip for s in STUDIES)} (other "
                         "words are ignored, as by the JAX script)")
    skip = set(ap.parse_args(argv).skip)
    failed = []
    for study in STUDIES:
        if study.skip in skip or study_done(root, study):
            continue
        data = study_dir(root, study.data)
        if not os.path.isdir(os.path.join(data, "input")):
            gen = ["--out", data, "--size", "700", "--seed", "0", *study.gen_flags]
            if run("scripts.generate_synthetic", gen, dict(os.environ), root) != 0:
                return 1
        env = {**os.environ, **study.knobs,
               "RESULTS": study_dir(root, study.knobs["RESULTS"]),
               "BANK": os.path.join(root, "study_state", study.bank)}
        rc = run("scripts.run_quality_study",
                 [data, study_dir(root, study.ckpt), study_dir(root, study.log)], env, root)
        if rc != 0:
            print(f"study {study.skip} ({study.bank}): the driver exited {rc}", flush=True)
            failed.append(study.skip)
    print("study queue complete" + (f"; failed: {' '.join(failed)}" if failed else ""),
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
