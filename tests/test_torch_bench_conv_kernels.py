"""The port's conv benchmark (``neuroclear_tpu_torch/scripts/bench_conv_kernels.py``)
against the JAX script's (``scripts/bench_conv_kernels.py``, loaded by path
and left as it is) on the CPU.  The JAX script runs with its timing
replaced (each row takes 2^-40 s, so that its printed TFLOP/s carries the
row's FLOPs) and with its Pallas W-pair gate open as its own tests open it
(``ENABLED``, ``_INTERPRET``); the port's rows per shape are the JAX gates':
``wpair`` where ``pallas_wconv.supported`` takes the shape, ``densek``
where ``pallas_conv.supported`` does, ``cudnn`` for JAX's ``xla``; every
JAX row of a shape carries the port's FLOP count, x3 with
``CONV_BENCH_GRAD=1``.  The argv and the environment parse to the JAX
script's values.  On the CPU the port's rows run their plain versions:
the parity check holds within its bound, a route that raises prints its
``FAILED`` line and fails the run, a parity miss fails it."""

import re
import sys

import numpy as np
import pytest
import torch

from neuroclear_tpu_torch.ops import wconv
from neuroclear_tpu_torch.scripts import bench_conv_kernels as bck
from test_torch_count_step_flops import load_jax_script

T_ROW = 2.0 ** -40
ROW = re.compile(r"^(\d+)\^3 cin(\d+)->64 (\S+)\s*: +[0-9.]+ ms +([0-9.]+) TFLOP/s$")


@pytest.fixture(scope="module")
def jax_gates():
    """JAX's W-pair and dense-K gates, opened as on the TPU."""
    from neuroclear_tpu.ops import pallas_conv, pallas_wconv

    mp = pytest.MonkeyPatch()
    mp.setattr(pallas_wconv, "ENABLED", True)
    mp.setattr(pallas_wconv, "_INTERPRET", True)
    mp.setattr(pallas_conv, "_ENABLE", True)
    mp.setattr(pallas_conv, "_INTERPRET", True)
    yield pallas_wconv, pallas_conv
    mp.undo()


def jax_rows(monkeypatch, capsys, argv: list, env: dict) -> tuple:
    """(header line, {(size, cin): [(name, printed TFLOP/s)]}, reps) of the
    JAX script's ``main``: its parity on real data, its rows on stand-ins."""
    from neuroclear_tpu.ops import pallas_wconv

    mod = load_jax_script("bench_conv_kernels")
    real = np.random.default_rng(0)
    reps = []

    class Rng:
        def standard_normal(self, shape):
            if tuple(shape) in ((1, 16, 24, 24, 64), (3, 3, 3, 64, 64)):
                return real.standard_normal(shape)
            return np.zeros(tuple(shape[:1]) + (1,) * (len(shape) - 2) + shape[-1:])

    def timed(fn, x, w, n):
        reps.append(n)
        return T_ROW, 0.0

    monkeypatch.setattr(np.random, "default_rng", lambda seed: Rng())
    monkeypatch.setattr(mod, "timed", timed)
    monkeypatch.setattr(mod, "timed_grad", timed)
    monkeypatch.setattr(pallas_wconv, "_BWD_ENV", getattr(pallas_wconv, "_BWD_ENV", None))
    monkeypatch.setattr(sys, "argv", ["bench_conv_kernels.py", *argv])
    for k in ("CONV_BENCH_CIN", "CONV_BENCH_DTYPE", "CONV_BENCH_GRAD"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    capsys.readouterr()
    mod.main()
    lines = capsys.readouterr().out.splitlines()
    rows = {}
    for line in lines[1:]:
        m = ROW.match(line.strip())
        if m:
            rows.setdefault((int(m.group(1)), int(m.group(2))), []).append((m.group(3),
                                                                           m.group(4)))
    return lines[0], rows, reps


CASES = [([], {}), (["3", "148"], {"CONV_BENCH_GRAD": "1", "CONV_BENCH_CIN": "128"}),
         (["5", "224", "148"], {"CONV_BENCH_CIN": "64"})]


@pytest.mark.parametrize("argv,env", CASES, ids=["defaults", "grad", "sizes"])
def test_rows_and_flops_match_jax(jax_gates, monkeypatch, capsys, argv, env):
    pallas_wconv, pallas_conv = jax_gates
    _, rows, _ = jax_rows(monkeypatch, capsys, argv, env)
    a = bck.parse_args(argv, env)
    for (size, cin), got in rows.items():
        names = [name for name, _ in got]
        shape = (1, size, size, size, cin)
        pallas = pallas_wconv.supported(shape, cin, 64, 3, 1, 1, 3)
        dense = pallas_conv.supported(shape, (3, 3, 3, cin, 64), (1, 1, 1), "SAME", (1, 1, 1))
        assert names[:3] == ["xla", "zpack2", "wpack2"]
        assert (len(names) > 3) == pallas
        assert bck.routes(size, cin) == (["cudnn"] + ["wpair"] * pallas + ["densek"] * dense)
        flops = bck.conv_flops(size, cin, a.grad)
        assert {p for _, p in got} == {f"{flops / T_ROW / 1e12:.1f}"}


@pytest.mark.parametrize("argv,env", CASES + [(["2", "64"], {"CONV_BENCH_DTYPE": "float32"})],
                         ids=["defaults", "grad", "sizes", "f32"])
def test_argv_and_env_parse_as_jax(monkeypatch, capsys, argv, env):
    header, rows, reps = jax_rows(monkeypatch, capsys, argv, env)
    a = bck.parse_args(argv, env)
    assert list(dict.fromkeys(s for s, _ in rows)) == a.sizes
    assert list(dict.fromkeys(c for _, c in rows)) == a.cins
    assert set(reps) == {a.reps} and a.device is None
    assert f"dtype={a.dtype} reps={a.reps}" in header
    for (size, cin), got in rows.items():  # the gradient mode: the FLOPs x3
        flops = bck.conv_flops(size, cin, a.grad)
        assert {p for _, p in got} == {f"{flops / T_ROW / 1e12:.1f}"}


def _run(argv, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return bck.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("grad", ["0", "1"])
def test_cpu_rows_and_parity(monkeypatch, capsys, grad):
    res = _run(["1", "8"], {"CONV_BENCH_CIN": "64", "CONV_BENCH_GRAD": grad}, monkeypatch)
    assert set(res["parity"]) == {"wpair", "densek"}
    assert max(res["parity"].values()) < bck.PARITY_REL["bfloat16"]
    assert [r["name"] for r in res["rows"]] == ["cudnn", "wpair"]  # W 8: no dense-K gate
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "cpu"
    assert re.search(r"^8\^3 cin64->64 wpair   : +[0-9.]+ ms", out, re.M)


def test_a_failed_row_fails_the_run(monkeypatch, capsys):
    conv3d = wconv.conv3d

    def failing(x, wt, bias):
        if x.shape[1] != 16:  # the parity shape passes
            raise RuntimeError("no launch")
        return conv3d(x, wt, bias)

    monkeypatch.setattr(wconv, "conv3d", failing)
    with pytest.raises(SystemExit) as e:
        _run(["1", "8"], {"CONV_BENCH_CIN": "64"}, monkeypatch)
    assert e.value.code == 1
    assert "8^3 cin64->64 wpair   : FAILED RuntimeError: no launch" in capsys.readouterr().out


def test_a_parity_miss_fails_the_run(monkeypatch):
    conv3d = wconv.conv3d
    monkeypatch.setattr(wconv, "conv3d", lambda x, wt, bias: conv3d(x, wt, bias) * 1.05)
    with pytest.raises(AssertionError, match="wpair parity"):
        _run(["1", "8"], {"CONV_BENCH_CIN": "64"}, monkeypatch)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs a machine without one")
    with pytest.raises(SystemExit, match="bench_conv_kernels: no CUDA device"):
        bck.main(["1", "8"])
