"""The port stands alone: ``neuroclear_tpu_torch`` (every module),
``chip_smoke`` and ``chip_smoke_faults`` import with ``jax``, ``PIL``,
``tifffile``, ``cv2`` and ``neuroclear_tpu`` blocked, as on a torch-only
machine with the card; and the entry points refuse to run when CUDA is
absent and the CPU was not asked for."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKER = """
import importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "PIL", "tifffile", "cv2", "neuroclear_tpu")

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())
"""


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", _BLOCKER + textwrap.dedent(code)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_port_and_chip_smoke_import_without_jax():
    proc = _run("""
        import pkgutil, importlib
        import neuroclear_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        import chip_smoke_faults
        loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not loaded, loaded
        print(len(names), "modules")
        print(" ".join(names))
    """)
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split()[0])
    assert n >= 51, proc.stdout
    for name in ("ops.rotation", "nn.schedulers", "options.train_options", "utils.visualizer",
                 "train", "data.warp", "data.cube_dataset", "data.simulationcrop_dataset",
                 "models.axial_to_lateral_gan_athena_model",
                 "models.axial_to_lateral_gan_dryops_model", "utils.image_pool", "nn.norms",
                 "nn.factory", "nn.generators", "nn.discriminators",
                 "parallel.train_parallel", "parallel.dice_infer", "utils.synthetic",
                 "scripts.generate_synthetic", "scripts.diagnose_quality",
                 "scripts.eval_saved_volumes", "scripts.select_checkpoint",
                 "scripts.run_quality_study"):
        assert f"neuroclear_tpu_torch.{name}" in proc.stdout.split(), name


def test_infer_main_refuses_without_cuda(tmp_path):
    """The inference entry point, ``test_dice.main``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs a machine without one")
    missing = tmp_path / "does_not_exist.npy"
    proc = _run(f"""
        from neuroclear_tpu_torch import test_dice
        try:
            test_dice.main(["--dataroot", {str(missing)!r}, "--results_dir", {str(tmp_path)!r},
                            "--dice_size", "16"])
        except RuntimeError as e:
            assert "CUDA" in str(e), e
            print("refused")
        else:
            raise SystemExit("main ran without a CUDA device")
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "refused"
    assert not any(tmp_path.iterdir())  # nothing was read or written


def test_epoch_trainer_refuses_without_cuda(tmp_path):
    """``train.main`` refuses before it reads or writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs a machine without one")
    proc = _run(f"""
        from neuroclear_tpu_torch import train
        try:
            train.main(["--dataroot", {str(tmp_path / "none")!r}, "--dataset_mode", "cube", "--seed", "0",
                        "--checkpoints_dir", {str(tmp_path)!r}])
        except RuntimeError as e:
            assert "CUDA" in str(e), e
            print("refused")
        else:
            raise SystemExit("main ran without a CUDA device")
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "refused"
    assert not any(tmp_path.iterdir())


def test_chip_smoke_exits_nonzero_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
