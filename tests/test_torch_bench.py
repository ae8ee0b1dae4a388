"""The port's benchmark (``neuroclear_tpu_torch/bench.py``) and its roi-120
sweep (``neuroclear_tpu_torch/scripts/sweep_roi120.py``) on the CPU: the
orchestration of the JAX ``bench.py`` (its tests in
``tests/test_utils_misc.py``, run here against the port's module), the
inference leg against the JAX bench's construction on the same volume and
weights, the train leg, the sweep's legs, and the refusal without a card.

Bound: the inference leg in f32 against JAX's pipeline, E2E_LSB for the
worst voxel (8 uint16 LSB: the real UNetDeconv's own f32 bound plus the
truncating cast, ``tests/test_torch_dice.py``; the 1 LSB of
``tests/test_torch_dice_run.py`` holds a stand-in generator) and half an
LSB for the mean.  Measured on the CPU: max 4, mean 0.28 LSB.
"""

import importlib
import json
import math
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_dice import E2E_LSB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN_LSB = 0.5


@pytest.fixture
def benchmod(monkeypatch):
    """A fresh copy of the module (its budget and record are read and made
    at import), with the SIGTERM handler that ``main`` installs put back."""
    import neuroclear_tpu_torch.bench as mod

    handler = signal.getsignal(signal.SIGTERM)

    def load():
        return importlib.reload(mod)

    yield load
    signal.signal(signal.SIGTERM, handler)


def _record(capsys) -> dict:
    out = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(out) == 1, out
    return json.loads(out[0])


def _inference_legs(calls: list, result: tuple):
    """A stand-in for ``_run_leg``: the probe passes; each inference leg is
    recorded as (tile batch, NEUROCLEAR_PALLAS_WCONV) and returns
    ``result``."""

    def run_leg(args, timeout_s, env=None):
        assert args[-2:] == ["--device", "cpu"]
        if args[1] == "probe":
            return {"ok": True, "device": "cpu:cpu"}, None
        calls.append((args[args.index("--tile-batch") + 1],
                      (env or {}).get("NEUROCLEAR_PALLAS_WCONV")))
        return result

    return run_leg


def test_bench_roi120_fallback_chain(benchmod, monkeypatch, capsys):
    """The headline roi-120 leg runs once, at BENCH_TILE_BATCH_120 with the
    W-pair kernel pinned on; when it fails there is no fallback to another
    tile batch or to cuDNN: the value stays null and the leg's error lands
    as ``roi120_error``."""
    monkeypatch.setenv("BENCH_TRAIN", "0")
    monkeypatch.setenv("BENCH_FAST_ONLY", "1")
    monkeypatch.delenv("BENCH_TILE_BATCH_120", raising=False)
    mod = benchmod()
    calls = []
    monkeypatch.setattr(mod, "_run_leg", _inference_legs(calls, (None, "CUDA out of memory")))
    mod.main("cpu")
    rec = _record(capsys)
    assert calls == [("4", "1")]
    assert rec["value"] is None and rec["vs_baseline"] is None
    assert rec["extra"]["roi120_error"] == "CUDA out of memory"
    assert not [k for k in rec["extra"] if "fallback" in k]
    assert rec["extra"]["device"] == "cpu:cpu"

    monkeypatch.setenv("BENCH_TILE_BATCH_120", "2")
    mod = benchmod()
    calls.clear()
    leg = {"vox_per_s": 4.2e6, "steady_s": 1.0, "first_s": 2.0, "wpallas": True}
    monkeypatch.setattr(mod, "_run_leg", _inference_legs(calls, (leg, None)))
    mod.main("cpu")
    rec = _record(capsys)
    assert calls == [("2", "1")]
    assert rec["value"] == 4.2e6 and rec["vs_baseline"] == 2.1
    assert rec["extra"]["wpallas_roi120"] is True


def test_bench_failed_probe_runs_no_leg(benchmod, monkeypatch, capsys):
    """A failed probe (one attempt) ends the bench: no other leg runs and
    the record carries the probe's error."""
    mod = benchmod()
    calls = []

    def fake_run_leg(args, timeout_s, env=None):
        calls.append(args[1])
        return None, "rc=1, no JSON (# leg failed: RuntimeError: no CUDA device)"

    monkeypatch.setattr(mod, "_run_leg", fake_run_leg)
    mod.main("cpu")
    rec = _record(capsys)
    assert calls == ["probe"]
    assert rec["value"] is None
    assert rec["extra"]["error"].startswith("device probe failed: rc=1")
    assert "device" not in rec["extra"]


def test_bench_total_budget_skips_legs(benchmod, monkeypatch, capsys):
    """With the global budget spent, no leg is spawned and the record still
    lands as one JSON line."""
    monkeypatch.setenv("BENCH_TOTAL_BUDGET", "0")
    monkeypatch.setenv("BENCH_TRAIN", "0")
    mod = benchmod()
    spawned = []
    monkeypatch.setattr(mod.subprocess, "Popen",
                        lambda *a, **k: spawned.append(a) or (_ for _ in ()).throw(
                            AssertionError("leg spawned despite zero budget")))
    mod.main("cpu")
    rec = _record(capsys)
    assert spawned == []
    assert rec["value"] is None
    assert "skipped (total budget exhausted)" in rec["extra"]["error"]


def test_bench_sigterm_emits_partial_record(benchmod, monkeypatch, capsys):
    """The SIGTERM handler prints the legs that landed, once."""
    mod = benchmod()
    exits = []
    monkeypatch.setattr(mod.os, "_exit", lambda code: exits.append(code))
    mod._RECORD["value"] = 4.4e6
    mod._RECORD["vs_baseline"] = 2.2
    mod._RECORD["extra"]["inference_vox_per_s_roi120"] = 4.4e6
    mod._on_sigterm(15, None)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["value"] == 4.4e6
    assert rec["extra"]["partial"].startswith("SIGTERM")
    assert exits == [0]
    mod._emit()  # the end of main must not print a second record
    assert capsys.readouterr().out == ""


def test_bench_always_emits_json_on_total_failure(benchmod, monkeypatch, capsys):
    """Every inference config failing still yields one JSON record (value
    null and the error)."""
    monkeypatch.setenv("BENCH_TRAIN", "0")
    monkeypatch.setenv("BENCH_FAST_ONLY", "0")
    mod = benchmod()

    def fake_run_leg(args, timeout_s, env=None):
        if args[1] == "probe":
            return {"ok": True, "device": "cpu:cpu"}, None
        return None, "boom"

    monkeypatch.setattr(mod, "_run_leg", fake_run_leg)
    mod.main("cpu")
    rec = _record(capsys)
    assert rec["value"] is None
    assert rec["extra"]["error"] == "all inference legs failed"
    assert "roi120_error" in rec["extra"]


def test_bench_train_legs_and_roi204_order(benchmod, monkeypatch, capsys):
    """The train legs (148^3 with --remat, then 108^3) land their it/s and
    the baseline ratios; roi 204 runs last, once, on the W-pair kernel."""
    monkeypatch.delenv("BENCH_TRAIN", raising=False)
    monkeypatch.delenv("BENCH_FAST_ONLY", raising=False)
    monkeypatch.delenv("BENCH_TILE_BATCH", raising=False)
    mod = benchmod()
    calls = []

    def fake_run_leg(args, timeout_s, env=None):
        calls.append((args[1], args[2:], (env or {}).get("NEUROCLEAR_PALLAS_WCONV")))
        if args[1] == "probe":
            return {"ok": True, "device": "cpu:cpu"}, None
        if args[1] == "train":
            return {"it_per_s": 4.0 if "--remat" in args else 8.0, "step_ms": 1.0}, None
        return {"vox_per_s": 1.0e7, "steady_s": 1.0, "first_s": 2.0,
                "wpallas": env["NEUROCLEAR_PALLAS_WCONV"] == "1"}, None

    monkeypatch.setattr(mod, "_run_leg", fake_run_leg)
    mod.main("cpu")
    rec = _record(capsys)
    assert [c[0] for c in calls] == ["probe", "inference", "train", "train", "inference"]
    assert calls[2][1] == ["--crop", "148", "--remat", "--device", "cpu"]
    assert calls[3][1] == ["--crop", "108", "--device", "cpu"]
    assert calls[4][1][:8] == ["--size", "900", "--tile-batch", "1", "--roi", "204", "--ov",
                               "15"]
    assert calls[4][2] == "1" and calls[1][2] == "1"
    ex = rec["extra"]
    assert ex["train_iters_per_sec_148"] == 4.0 and ex["train_vs_baseline"] == 25.0
    assert ex["train_iters_per_sec_108"] == 8.0
    assert ex["train_11k_wallclock_hours"] == round(11000 / 4.0 / 3600, 2)
    assert ex["wpallas_roi120"] is True and ex["wpallas"] is True
    assert rec["vs_baseline"] == 5.0
    assert not [k for k in ex if "error" in k or k.startswith("fallback")]


def test_bench_without_a_card_reports_it():
    """No card and no --device cpu: one JSON line that names the missing
    device; no leg runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs a machine without one")
    proc = subprocess.run([sys.executable, "-m", "neuroclear_tpu_torch.bench"], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["value"] is None
    assert rec["extra"]["error"].startswith("device unavailable") and "CUDA" in rec["extra"][
        "error"]
    assert "device" not in rec["extra"]


def test_run_leg_spawns_the_module_from_any_directory(benchmod, tmp_path, monkeypatch):
    """A real leg subprocess, started from another directory: its JSON line
    parsed; a leg that raises returns its error line (without a card, the
    missing device)."""
    monkeypatch.chdir(tmp_path)
    mod = benchmod()
    res, err = mod._run_leg(["--leg", "probe", "--device", "cpu"], 120)
    assert err is None and res == {"ok": True, "device": "cpu:cpu"}
    if torch.cuda.is_available():
        return
    res, err = mod._run_leg(["--leg", "probe"], 120)
    assert res is None
    assert err.startswith("rc=1, no JSON (# leg failed: RuntimeError: no CUDA device"), err


def test_inference_leg_matches_jax_bench_construction():
    """The port's inference leg in f32 at a small grid (18^3, roi 16,
    overlap 4, border cut 4: eight 24^3 tiles in batches of three) against
    the JAX bench's construction (bench.py:138-148) on the same volume,
    with the same weights."""
    from neuroclear_tpu.data.dicing import DiceGrid as JaxDiceGrid
    from neuroclear_tpu.nn import generators as G
    from neuroclear_tpu.nn.core import unflatten_params
    from neuroclear_tpu.parallel.dice_infer import DiceInferencePipeline as JaxPipeline
    from neuroclear_tpu.utils.imageops import pad_for_dicing as jax_pad
    from neuroclear_tpu_torch import bench
    from neuroclear_tpu_torch.nn.generators import UNetDeconv
    from neuroclear_tpu_torch.utils.weights import init_flat

    size, tb, roi, ov, bc = 18, 3, 16, 4, 4
    flat = init_flat(UNetDeconv(1, 1), "kaiming", 0.02, seed=0)
    res = bench.leg_inference(size, tb, roi, ov, bc, device="cpu", precision="float32",
                              flat=flat, keep_volumes=True)
    first, out = res["volumes"]
    assert res["wpallas"] is True and res["steady_s"] > 0 and res["first_s"] > 0
    assert res["vox_per_s"] == size ** 3 / res["steady_s"]
    assert np.array_equal(first, out)

    vol = np.random.default_rng(0).integers(0, 65535, (size,) * 3, dtype=np.uint16)
    vp = jax_pad(vol, roi, ov)
    ref = JaxPipeline(G.UNetDeconv(1, 1, norm="instance").apply, unflatten_params(flat),
                      JaxDiceGrid(vp.shape, roi, ov, bc), 1 / 65535.0, tile_batch=tb,
                      precision="float32", out_dtype=np.uint16,
                      orig_shape=vol.shape).run_streaming(vp)
    assert out.dtype == ref.dtype == np.uint16 and out.shape == ref.shape == vol.shape
    assert out.std() > 0
    d = np.abs(out.astype(np.int64) - ref.astype(np.int64))
    assert d.max() <= E2E_LSB and d.mean() <= MEAN_LSB, (d.max(), d.mean())


def test_train_leg_on_the_cpu():
    """The train leg at 24^3 on the CPU, two timed steps: finite losses and
    the record's keys."""
    from neuroclear_tpu_torch import bench
    from neuroclear_tpu_torch.models.axial_to_lateral_gan_apollo_model import LOSS_NAMES

    res = bench.leg_train(24, False, device="cpu", precision="float32", steps=2)
    assert set(res) == {"it_per_s", "step_ms", "wpallas", "losses"}
    assert res["it_per_s"] > 0 and math.isclose(res["step_ms"], 1000 / res["it_per_s"])
    assert res["wpallas"] is True
    assert list(res["losses"]) == list(LOSS_NAMES)
    assert all(math.isfinite(v) for v in res["losses"].values())
    json.dumps(res)


def test_sweep_runs_six_legs_in_order(monkeypatch, capsys):
    """scripts/sweep_roi120.sh's loop: B in 2, 4, 8, W in 1, 0, each an
    inference leg at roi 120 / 15 / 10 under NEUROCLEAR_PALLAS_WCONV=W,
    with the header and the leg's last two lines printed."""
    from neuroclear_tpu_torch.scripts import sweep_roi120

    monkeypatch.setenv("SWEEP_LEG_TIMEOUT", "7")
    seen = []

    def fake_run(argv, env=None, timeout=None, **kw):
        seen.append((argv, env["NEUROCLEAR_PALLAS_WCONV"], timeout))
        return subprocess.CompletedProcess(argv, 0, stdout="noise\n# summary\n{\"x\": 1}\n")

    assert sweep_roi120.main(["300"], run=fake_run) == 0
    want = [("2", "1"), ("2", "0"), ("4", "1"), ("4", "0"), ("8", "1"), ("8", "0")]
    assert [(a[a.index("--tile-batch") + 1], w) for a, w, _ in seen] == want
    for argv, _, timeout in seen:
        assert argv[:3] == [sys.executable, "-m", "neuroclear_tpu_torch.bench"]
        assert argv[3:] == ["--leg", "inference", "--size", "300", "--tile-batch",
                            argv[argv.index("--tile-batch") + 1], "--roi", "120", "--ov",
                            "15", "--bc", "10"]
        assert timeout == 7.0
    out = capsys.readouterr().out.splitlines()
    assert out == [ln for b, w in want for ln in (f"=== B={b} wpallas={w}", "# summary",
                                                  '{"x": 1}')]


def _sweep_rows() -> list:
    return [{"B": b, "wpallas": bool(w), "vox_per_s": 6.0e7, "steady_s": 12.0, "first_s": 13.0}
            for b in (2, 4, 8) for w in (1, 0)]


@pytest.mark.parametrize("fault", [None, "error", "route", "missing", "no rate"])
def test_smoke_checks_the_sweep_rows(fault):
    """``chip_smoke.py --bench`` passes the sweep only with its six legs in
    order, each with a voxel rate on the route its header asked for."""
    import chip_smoke

    rows = _sweep_rows()
    if fault == "error":
        rows[3] = {"B": 4, "wpallas": 0, "error": "no JSON"}
    elif fault == "route":
        rows[1]["wpallas"] = True
    elif fault == "missing":
        del rows[5]
    elif fault == "no rate":
        del rows[2]["vox_per_s"]
    if fault is None:
        chip_smoke.check_sweep_rows(rows)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.check_sweep_rows(rows)


@pytest.mark.parametrize("fault", ["error", "partial", "roi204 off the kernel", "no 108"])
def test_smoke_refuses_a_bench_record(fault):
    """The smoke's bench phase refuses a record with a leg's error, a
    partial record, roi 204 off the W-pair kernel or a train leg missing,
    before it looks at the device."""
    import chip_smoke

    extra = {"device": "cuda:NVIDIA H100 80GB HBM3", "inference_vox_per_s_roi120": 3.0e7,
             "wpallas_roi120": True, "train_iters_per_sec_148": 5.6,
             "train_iters_per_sec_108": 9.6, "inference_vox_per_s_roi204": 5.0e7,
             "wpallas": True}
    if fault == "error":
        extra["train148_error"] = "timeout after 240s"
    elif fault == "partial":
        extra["partial"] = "SIGTERM before all legs ran"
    elif fault == "roi204 off the kernel":
        extra["wpallas"] = False
    else:
        del extra["train_iters_per_sec_108"]
    rec = {"metric": "dice_inference_voxels_per_sec", "value": 3.0e7, "unit": "voxel/s",
           "vs_baseline": 15.0, "extra": extra}
    with pytest.raises(AssertionError):
        chip_smoke.check_bench_record(rec)
