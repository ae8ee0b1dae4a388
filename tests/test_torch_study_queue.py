"""The study queue (``python -m neuroclear_tpu_torch.scripts.run_study_queue``)
and its status (``...scripts.study_status``) against the JAX scripts
``scripts/run_study_queue.sh`` and ``scripts/study_status.sh``, on the CPU
with temporary banks: the driver and the data generation are replaced by a
recorder, so the cases show which studies run, in which order, with which
data, directories and knobs (each parsed from the JAX queue's own lines),
what the skip names skip and what counts as done.  The status rows are the
JAX script's, run by bash on the same tree.  Last, the quality-study
driver's default directories are the JAX script's."""

import os
import re
import shlex
import shutil
import subprocess
import sys

import pytest

from neuroclear_tpu_torch.scripts import run_quality_study, run_study_queue, study_status

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUEUE_SH = os.path.join(REPO, "scripts", "run_study_queue.sh")
# the JAX queue's knobs that served the TPU-era bench's STOP file and git
# banking, which the port leaves out (the driver reads neither)
LEFT_OUT = {"AUTOBANK", "CLEAR_STOP"}


def _jax_queue() -> list:
    """Per study of the JAX queue, in order: (skip name, bank, max iters,
    log dir, generator argv, the driver's environment assignments and
    arguments)."""
    sh = open(QUEUE_SH).read()
    out = []
    for block in re.findall(r'if \[\[ "\$SKIP" != \*" (\w+) "\* \]\] && (.*?)\nfi', sh, re.S):
        skip, body = block
        bank, iters, log = re.match(r"! study_done (\S+) (\d+) (\S+);", body).groups()
        gen = shlex.split(re.search(r"generate_synthetic\.py (.*?) \|\|", body, re.S)
                          .group(1).replace("\\\n", " "))
        call = re.search(r"\n  ([A-Z_]+=.*?scripts/run_quality_study\.sh .*?)\n", body + "\n",
                         re.S).group(1).replace("\\\n", " ")
        words = shlex.split(call)
        i = words.index("scripts/run_quality_study.sh")
        env = dict(w.split("=", 1) for w in words[:i])
        out.append((skip, bank, int(iters), log, gen, env, words[i + 1:]))
    return out


class Recorder:
    """Stands in for ``run_study_queue.run_module``: records each call and
    makes the generator's ``input`` directory."""

    def __init__(self, rcs=None):
        self.calls, self.rcs = [], rcs or {}

    def __call__(self, module, argv, env, root):
        self.calls.append((module, list(argv), dict(env), root))
        if module == "scripts.generate_synthetic":
            os.makedirs(os.path.join(argv[argv.index("--out") + 1], "input"), exist_ok=True)
        return self.rcs.get((module, len(self.calls)), 0)

    def drivers(self) -> list:
        return [c for c in self.calls if c[0] == "scripts.run_quality_study"]


def _rel(root, path: str) -> str:
    return os.path.relpath(path, root)


def _bank(root, name: str, its) -> None:
    os.makedirs(root / "study_state" / name, exist_ok=True)
    for it in its:
        (root / "study_state" / name / f"iter_{it}_optim.npz").write_bytes(b"")


def test_the_queue_runs_the_jax_studies_in_order(tmp_path, monkeypatch):
    """With empty banks every study runs, in the JAX queue's order: its
    volumes generated with the JAX queue's flags, then the driver on the
    JAX queue's directories with its knobs (paths under the root), the bank
    ``study_state/<NAME>`` and nothing of the TPU harness."""
    monkeypatch.setenv("GEN_FLAGS", "--inherited")
    rec = Recorder()
    assert run_study_queue.main([], root=str(tmp_path), run=rec) == 0
    jax = _jax_queue()
    assert [s.skip for s in run_study_queue.STUDIES] == [j[0] for j in jax] == [
        "s4", "ga8", "athena"]
    assert [c[0] for c in rec.calls] == ["scripts.generate_synthetic",
                                         "scripts.run_quality_study"] * 3
    for (skip, bank, iters, log, gen, env, args), (g, d) in zip(
            jax, zip(rec.calls[::2], rec.calls[1::2])):
        study = next(s for s in run_study_queue.STUDIES if s.skip == skip)
        assert (study.bank, study.max_iters, f".study/{study.log}") == (bank, iters, log)
        assert g[1][0] == "--out" and _rel(tmp_path, g[1][1]) == gen[1]
        assert g[1][2:] == gen[2:]
        assert [_rel(tmp_path, a) for a in d[1]] == args
        knobs = {k: v for k, v in d[2].items() if os.environ.get(k) != v}
        want = {k: v for k, v in env.items() if k not in LEFT_OUT}
        want["RESULTS"] = str(tmp_path / want["RESULTS"])
        want["BANK"] = str(tmp_path / "study_state" / bank)
        if "GEN_FLAGS" not in env:  # inherited by the driver, as in the shell
            assert d[2]["GEN_FLAGS"] == "--inherited"
        assert knobs == want
        assert d[2]["NAME"] == bank and not LEFT_OUT & set(d[2])
    athena = rec.drivers()[2][2]
    assert athena["NEUROCLEAR_HOST_WINDOW"] == "1" and athena["CROP"] == "128"


@pytest.mark.parametrize("skip, ran", [
    (["s4"], ["ga8", "athena"]), (["ga8", "athena"], ["s4"]),
    (["s4", "ga8", "athena"], []), (["unknown"], ["s4", "ga8", "athena"])])
def test_skip_names(tmp_path, skip, ran):
    rec = Recorder()
    assert run_study_queue.main(skip, root=str(tmp_path), run=rec) == 0
    assert [os.path.basename(c[1][2]) for c in rec.drivers()] == [
        f"log_{'art' if s == 'athena' else s}" for s in ran]


@pytest.mark.parametrize("its, final, done", [
    ([11000], True, True), ([11000, 12000], True, True), ([11000], False, False),
    ([10999], True, False), ([], True, False)])
def test_a_study_is_done_with_its_bank_and_final_eval(tmp_path, its, final, done):
    """Done: the bank's newest ``iter_*_optim.npz`` at or past MAX_ITERS and
    ``eval_final.done`` in the study's log dir; a net file alone is not a
    checkpoint."""
    _bank(tmp_path, "apollo148s4", its)
    (tmp_path / "study_state" / "apollo148s4" / "iter_20000_net_G_A.npz").write_bytes(b"")
    if final:
        os.makedirs(tmp_path / ".study" / "log_s4")
        (tmp_path / ".study" / "log_s4" / "eval_final.done").write_bytes(b"")
    rec = Recorder()
    run_study_queue.main(["ga8", "athena"], root=str(tmp_path), run=rec)
    assert len(rec.drivers()) == (0 if done else 1)
    assert run_study_queue.study_done(str(tmp_path), run_study_queue.STUDIES[0]) == done


def test_existing_volumes_are_not_generated_again(tmp_path):
    os.makedirs(tmp_path / ".study" / "sim700" / "input")
    rec = Recorder()
    run_study_queue.main(["s4", "athena"], root=str(tmp_path), run=rec)
    assert [c[0] for c in rec.calls] == ["scripts.run_quality_study"]


def test_a_failed_generation_stops_the_queue(tmp_path):
    rec = Recorder({("scripts.generate_synthetic", 1): 1})
    assert run_study_queue.main([], root=str(tmp_path), run=rec) == 1
    assert len(rec.calls) == 1


def test_a_failed_driver_does_not_stop_the_queue(tmp_path, capsys):
    rec = Recorder({("scripts.run_quality_study", 2): 1})
    assert run_study_queue.main([], root=str(tmp_path), run=rec) == 1
    assert len(rec.drivers()) == 3
    assert "failed: s4" in capsys.readouterr().out


def _status_tree(root) -> None:
    _bank(root, "apollo148s4", [10500, 11000])
    _bank(root, "apollo148ga8", [250])
    log = root / ".study" / "log_s4"
    os.makedirs(log)
    (log / "eval_final.done").write_bytes(b"")
    (log / "driver.log").write_text("=== segment 3 from iter 10500\nALL DONE 12:00:00\n")
    for it, rows in ((3000, 1), (11000, 2), (6000, 2)):
        (log / f"eval_{it}.log").write_text(
            "".join(f"line\npsnr input {it}.{i} psnr output 1{i}.0\n" for i in range(rows)))
    os.makedirs(root / ".study" / "log_art")
    (root / ".study" / "log_art" / "driver.log").write_text("")


def test_the_status_rows_are_the_jax_scripts(tmp_path):
    """``study_status``'s rows are those ``scripts/study_status.sh`` prints
    on the same banks and logs (run by bash from a copy of the script under
    the temporary root, which it takes as the repository); the running
    processes it lists are left out of the comparison."""
    _status_tree(tmp_path)
    os.makedirs(tmp_path / "scripts")
    shutil.copy(os.path.join(REPO, "scripts", "study_status.sh"), tmp_path / "scripts")
    out = subprocess.run(["bash", str(tmp_path / "scripts" / "study_status.sh")],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    jax = [ln for ln in out.splitlines() if not ln.startswith("  live:")]
    rows = study_status.rows(str(tmp_path))
    assert rows == jax
    assert rows[0].startswith("apollo148s4    banked  11000 / 11000   final-eval done  ALL DONE")
    assert rows[-1] == "athena148      banked      0 / 3000    (no live log)"


def test_the_status_lists_the_running_studies(capsys):
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)",
                             "run_study_queue"])
    try:
        assert any(ln.startswith(f"  live: {proc.pid} ") and "run_study_queue" in ln
                   for ln in study_status.live())
    finally:
        proc.kill()
        proc.wait()
    assert study_status.main([], root=REPO) == 0
    assert "apollo148s4" in capsys.readouterr().out


def test_the_drivers_default_directories_are_the_jax_scripts():
    """``DATA``, ``CKPT``, ``LOG`` and ``RESULTS`` default to the JAX
    script's ``/tmp`` paths (under ``$TMPDIR`` where it is set)."""
    sh = open(os.path.join(REPO, "scripts", "run_quality_study.sh")).read()
    defaults = dict(re.findall(r"^(\w+)=\$\{(?:\d|\w+):-(/tmp/\w+)\}$", sh, re.M))
    assert set(defaults) == {"DATA", "CKPT", "LOG", "RESULTS"}
    port = vars(run_quality_study.build_parser().parse_args([]))
    port["RESULTS"] = run_quality_study.knobs({})["RESULTS"]
    for name, key in (("DATA", "data"), ("CKPT", "ckpt"), ("LOG", "log"),
                      ("RESULTS", "RESULTS")):
        assert port[key] == os.path.join(run_quality_study.TMP,
                                         os.path.relpath(defaults[name], "/tmp"))
