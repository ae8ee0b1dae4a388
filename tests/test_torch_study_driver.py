"""The quality study's driver in the port
(``python -m neuroclear_tpu_torch.scripts.run_quality_study``) end to end
on the CPU at a tiny size: a 36^3 ``--preset s4`` volume, the production
nets at 24^3 crops, two segments of two iterations, evals at 2 and 4 and
the final one (the trainer resumes from N at N + 1, so the second segment
ends at 5), with ``test_dice`` at 32^3 tiles in f32 on the CPU through
``EVAL_FLAGS``; its steps in this process (``--inprocess``), and once as
child processes (the default).  It writes its eval and diagnostic logs and
``selected.txt`` (the argmax, byte for byte the JAX script's selection on
the same logs), resumes from a ``BANK`` directory, and exits nonzero when an
eval prints no PSNR.  Its train and eval commands are the JAX script's."""

import os
import re
import shlex
import shutil
import subprocess
import sys

import pytest
import torch
from threadpoolctl import threadpool_limits

from neuroclear_tpu_torch import test_dice
from neuroclear_tpu_torch.scripts import run_quality_study, select_checkpoint
from test_torch_study import _jax_script

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = {"NAME": "tiny", "MAX_ITERS": "4", "EVALS": "2 4", "SEG_ITERS": "2", "SAVE_FREQ": "2",
         "PRINT_FREQ": "1", "CROP": "24", "GEN_FLAGS": "--size 36 --preset s4",
         "EXTRA_TRAIN_FLAGS": "--device cpu",
         "EVAL_FLAGS": "--device cpu --precision float32 --dice_size 32 32 32 --overlap 4 "
                       "--border_cut 4"}


def _env(tmp, **knobs) -> dict:
    """The knobs, a results folder and no bank under ``tmp``."""
    return {**KNOBS, "RESULTS": str(tmp / "results"), "BANK": str(tmp / "no_bank"), **knobs}


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _inprocess(tmp, mp, **knobs) -> int:
    """The driver in this process (``--inprocess``) with TensorBoard left
    out (its import takes ~20 s here); its exit code."""
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    return run_quality_study.main([str(tmp / "data"), str(tmp / "ck"), str(tmp / "log"),
                                   "--inprocess"], environ=_env(tmp, **knobs))


@pytest.fixture(scope="module")
def study(tmp_path_factory, one_thread):
    """The study in this process; its checkpoints (a 220 MB set each: the
    production nets and their Adam state) are removed after the module."""
    tmp = tmp_path_factory.mktemp("study")
    with pytest.MonkeyPatch.context() as mp:
        rc = _inprocess(tmp, mp)
    yield tmp, rc
    shutil.rmtree(tmp / "ck", ignore_errors=True)


@pytest.fixture
def bank(study, tmp_path):
    """A bank of the first study's newest checkpoint set (iteration 5), and
    the study's data, under ``tmp_path``; the test's checkpoints are removed
    after it."""
    tmp, _ = study
    shutil.copytree(tmp / "data", tmp_path / "data")
    out = tmp_path / "bank"
    out.mkdir()
    for f in (tmp / "ck" / "tiny").glob("iter_5_*"):
        os.symlink(f, out / f.name)
    yield out
    shutil.rmtree(tmp_path / "ck", ignore_errors=True)


def _driver_log(log) -> str:
    return (log / "driver.log").read_text()


def test_the_study_runs_its_segments_and_evals(study):
    tmp, rc = study
    log = tmp / "log"
    assert rc == 0, _driver_log(log)
    text = _driver_log(log)
    assert re.findall(r"=== segment (\d+) from iter (\d+)", text) == [("1", "0"), ("2", "2")]
    assert re.findall(r"--- (?:final )?eval at (\d+)", text) == ["2", "4", "5"]
    assert text.rstrip().splitlines()[-1].startswith("ALL DONE")
    assert sorted(os.listdir(tmp / "data")) == ["gt", "input", "rotated"]
    assert run_quality_study.last_ckpt(str(tmp / "ck" / "tiny")) == 5
    train = (log / "train.log").read_text()
    assert train.count("reached --max_iters 2") == 2
    assert "restored optimizer state from" in train
    for it in (2, 4, 5):
        m = select_checkpoint.parse_eval_log(str(log / f"eval_{it}.log"))
        assert m is not None and m["output_ssim"] is not None and "input_psnr" in m, it
        diag = (log / f"diag_{it}.log").read_text().splitlines()
        assert [line.split(":")[0].strip() for line in diag[-3:]] == ["gt", "input", "output"]
        assert (tmp / "results" / "tiny" / f"test_latest_iter{it}" / "volumes" /
                f"output_volume_xy-view_iter-{it}.tif").exists()
    for done in ("eval_2.done", "eval_4.done", "eval_final.done"):
        assert (log / done).exists()


def test_selected_is_the_argmax_and_the_jax_scripts_bytes(study, tmp_path):
    tmp, _ = study
    log = tmp / "log"
    rows = select_checkpoint.scan(str(log))
    best = max(rows, key=lambda r: (r[1]["output_psnr"], -r[0]))[0]
    selected = (log / "selected.txt").read_text()
    assert selected.startswith(f"selected: iter {best} ")
    assert f"test_dice.py --load_iter {best})" in selected
    assert selected.strip() in _driver_log(log)
    for f in log.glob("eval_*.log"):
        shutil.copy(f, tmp_path)
    _jax_script("select_checkpoint").main([str(tmp_path), "--write"])
    assert (tmp_path / "selected.txt").read_bytes() == (log / "selected.txt").read_bytes()


def test_child_processes_run_the_final_eval(study, bank, tmp_path):
    """The default mode, each step a child process under its time limit:
    seeded from the first study's checkpoints with nothing left to train,
    the driver runs the final eval, its diagnosis and the selection, each as
    ``python -m`` of the port (the processes see no TensorBoard)."""
    tmp, _ = study
    stub = tmp_path / "_stub" / "tensorboard"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text('raise ImportError("TensorBoard is left out")\n')
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env.update(_env(tmp_path, BANK=str(bank), MAX_ITERS="5", EVALS=""),
               PYTHONPATH=os.pathsep.join([str(tmp_path / "_stub"), REPO]),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "neuroclear_tpu_torch.scripts.run_quality_study",
                           "data", "ck", "log"], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    log = tmp_path / "log"
    assert proc.returncode == 0, proc.stdout + proc.stderr + _driver_log(log)
    assert re.findall(r"--- (?:final )?eval at (\d+)", _driver_log(log)) == ["5"]
    assert not (log / "train.log").exists()
    assert select_checkpoint.parse_eval_log(str(log / "eval_5.log")) == \
        select_checkpoint.parse_eval_log(str(tmp / "log" / "eval_5.log"))
    assert (log / "diag_5.log").read_text() == (tmp / "log" / "diag_5.log").read_text()
    assert (log / "selected.txt").read_text().startswith("selected: iter 5 ")


def test_the_study_resumes_from_a_bank(bank, tmp_path, monkeypatch):
    """A cold working directory is seeded from ``BANK`` (the first study's
    checkpoint at iteration 5) and the next segment resumes from its newest
    complete checkpoint, Adam state included; with no ladder left only the
    final eval runs."""
    rc = _inprocess(tmp_path, monkeypatch, BANK=str(bank), MAX_ITERS="7", EVALS="")
    log = tmp_path / "log"
    assert rc == 0, _driver_log(log)
    text = _driver_log(log)
    assert f"seeded {tmp_path / 'ck' / 'tiny'} from bank {bank}" in text
    assert re.findall(r"=== segment (\d+) from iter (\d+)", text) == [("1", "5")]
    assert re.findall(r"--- (?:final )?eval at (\d+)", text) == ["8"]
    train = (log / "train.log").read_text()
    assert "restored optimizer state from" in train and "iter_5_optim.npz" in train
    assert run_quality_study.last_ckpt(str(tmp_path / "ck" / "tiny")) == 8
    assert (log / "selected.txt").read_text().startswith("selected: iter 8 ")


def test_an_eval_that_prints_no_psnr_stops_the_driver(bank, tmp_path, monkeypatch):
    """No fallback: an eval whose metrics do not print fails the driver with
    a nonzero exit, records why, and leaves no selection."""
    monkeypatch.setattr(test_dice, "compute_gt_metrics", lambda *a, **k: None)
    rc = _inprocess(tmp_path, monkeypatch, BANK=str(bank), MAX_ITERS="5", EVALS="")
    log = tmp_path / "log"
    assert rc != 0
    assert "eval_5 produced no psnr" in _driver_log(log)
    assert not (log / "eval_final.done").exists() and not (log / "selected.txt").exists()


def test_seeding_keys_on_the_optimizer_file(tmp_path):
    """A working directory whose newest set lacks its optimizer file (a save
    cut short) is still seeded; one holding a complete set is not."""
    bank, run = tmp_path / "bank", tmp_path / "ck" / "x"
    bank.mkdir()
    run.mkdir(parents=True)
    for f in ("iter_3_net_G_A.npz", "iter_3_optim.npz"):
        (bank / f).write_bytes(b"bank")
    (run / "iter_5_net_G_A.npz").write_bytes(b"partial")
    k = run_quality_study.knobs({"NAME": "x", "BANK": str(bank)})
    driver = run_quality_study.Driver(str(tmp_path / "d"), str(tmp_path / "ck"),
                                      str(tmp_path / "log"), k)
    assert run_quality_study.last_ckpt(str(run)) == 0
    driver.seed_from_bank()
    assert run_quality_study.last_ckpt(str(run)) == 3
    (bank / "iter_3_optim.npz").write_bytes(b"changed")
    driver.seed_from_bank()
    assert (run / "iter_3_optim.npz").read_bytes() == b"bank"


def _shell_words(block: str, values: dict) -> list:
    """A block of the JAX shell script with its ``$VAR``s substituted."""
    text = block.replace("\\\n", " ").replace('"', "")
    text = re.sub(r"\$\{?(\w+)\}?", lambda m: values.get(m.group(1), m.group(0)), text)
    return shlex.split(text)


def test_the_commands_are_the_jax_scripts():
    """``TRAIN_FLAGS`` and the eval's ``test_dice`` flags as
    ``scripts/run_quality_study.sh`` writes them, at its default knobs."""
    sh = open(os.path.join(REPO, "scripts", "run_quality_study.sh")).read()
    k = run_quality_study.knobs({})
    values = {**k, "DATA": "D", "CKPT": "C", "it": "7", "WATCHDOG": k["WATCHDOG"]}
    train = re.search(r'TRAIN_FLAGS="(.*?)"\n', sh, re.S).group(1)
    assert run_quality_study.train_flags(k, "D", "C") == _shell_words(train, values)
    ev = re.search(r"python test_dice\.py \\\n(.*?)> ", sh, re.S).group(1)
    words = _shell_words(ev.replace('"$@"', "--save_volume"), values)
    assert run_quality_study.eval_flags(k, "D", "C", 7) == words
    assert k["MODEL_FLAGS"].split() == re.search(
        r'MODEL_FLAGS=\$\{MODEL_FLAGS:-"(.*?)"\}', sh, re.S).group(1).replace("\\\n", " ").split()


def test_an_evals_wrapper_calls_are_the_smokes_count(study, monkeypatch):
    """The study's eval (bf16, the fused path) calls each kernel wrapper as
    often as ``chip_smoke.eval_launches`` counts the launches of an eval on
    the card: two W-pair convs and ten norms per tile batch."""
    import functools

    import chip_smoke
    from neuroclear_tpu_torch.ops import KERNELS, conv3x3, inorm, wconv

    tmp, _ = study
    counts = dict.fromkeys(KERNELS, 0)
    for name, fn in KERNELS.items():
        module = conv3x3 if name == "conv3x3" else wconv if name.startswith("wconv") else inorm

        def wrap(*a, _fn=fn, _name=name, **k):
            counts[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(module, fn.__name__, functools.update_wrapper(wrap, fn))
    k = run_quality_study.knobs({**_env(tmp / "bf16"), "EVAL_FLAGS": (
        "--device cpu --dice_size 32 32 32 --overlap 4 --border_cut 4")})
    res = test_dice.main(run_quality_study.eval_flags(k, str(tmp / "data"), str(tmp / "ck"), 4))
    assert res["metrics"] is not None
    shape = res["fake"].shape
    assert counts == chip_smoke.eval_launches(shape, roi=32, overlap=4, border=4)
    assert chip_smoke.dice_batches(shape, roi=32, overlap=4, border=4) > 1
