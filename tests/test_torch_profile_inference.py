"""The port's inference profiler (``neuroclear_tpu_torch/scripts/profile_inference.py``)
on the CPU: its compute leg runs the code that ``run_streaming`` runs
(``DiceInferencePipeline.prepare`` / ``slab_rows`` / ``host_volume``), so
its rows, assembled, are ``run_streaming``'s volume bit for bit, on both
geometries of the pipeline (one upload per slab, and the whole
border-padded volume at extreme overlap) and at several tile batches; a
compute leg that skips a slab no longer is.  Its positional argv and
``BENCH_TILE_BATCH`` parse as the JAX script (``scripts/profile_inference.py``,
loaded by path and left as it is) reads them."""

import sys
import types

import numpy as np
import pytest
import torch

from neuroclear_tpu_torch import bench
from neuroclear_tpu_torch.parallel.dice_infer import DiceInferencePipeline
from neuroclear_tpu_torch.scripts import profile_inference
from test_torch_count_step_flops import _Stop, load_jax_script

# (size, roi, overlap, border cut): tiles of 16^3 and 12^3 (the U-Net pools
# twice); in the second a slab spans more than two chunks (step 5, ext 12)
GEOMETRIES = [(24, 12, 2, 2), (12, 8, 3, 2)]


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=["streamed", "whole"])
@pytest.mark.parametrize("tile_batch", [1, 3])
def test_compute_leg_is_run_streaming(geometry, tile_batch):
    size, roi, ov, bc = geometry
    _, vp, pipe = bench.inference_pipeline(size, tile_batch, roi, ov, bc, "bfloat16", "cpu")
    streamed = pipe._streamed()
    assert streamed == (geometry == GEOMETRIES[0])
    chunks = pipe.upload(vp)
    assert len(chunks) == (pipe.grid.z_steps if streamed else 1)
    st, rows = profile_inference.compute_rows(pipe, vp, chunks)
    assembled = pipe.host_volume(st, [r.numpy() for r in rows])
    out = pipe.run_streaming(vp)
    assert assembled.dtype == out.dtype == np.uint16 and out.shape == (size,) * 3
    assert np.array_equal(assembled, out)


def test_profile_legs_and_tile_batches(capsys):
    size, roi, ov, bc = GEOMETRIES[0]
    calls = []
    add_tiles = DiceInferencePipeline.add_tiles

    def counted(self, slab, batch, dest):
        calls.append(len(batch))
        return add_tiles(self, slab, batch, dest)

    mp = pytest.MonkeyPatch()
    mp.setattr(DiceInferencePipeline, "add_tiles", counted)
    try:
        res = profile_inference.profile(size, roi, ov, bc, 2, "cpu")
    finally:
        mp.undo()
    assert res["bitwise"]
    assert set(res["legs"]) == {"h2d", "compute", "d2h", "assemble", "duplex", "end_to_end"}
    assert all(len(v) == 2 and min(v) > 0 for v in res["legs"].values())
    assert res["tile_s"] == {"compute": [None, None], "end_to_end": [None, None]}
    # two compute runs and three end-to-end runs, each of tile_batches calls
    assert len(calls) == 5 * res["tile_batches"] and max(calls) == 2
    z, y, x = res["grid"]
    assert res["tile_batches"] == z * -(-(y * x) // 2)
    out = capsys.readouterr().out
    assert "# compute rows assembled against run_streaming: equal bit for bit" in out


def test_a_compute_leg_that_skips_a_slab_is_caught(monkeypatch):
    def skipping(pipe, vp, chunks):
        """Slab 1's rows emitted without its tiles."""
        st = pipe.prepare(vp, chunks)
        rows = []
        for i in range(pipe.grid.z_steps):
            batches, st.batches = st.batches, [] if i == 1 else st.batches
            rows.append(pipe.slab_rows(st, i))
            st.batches = batches
        return st, rows

    monkeypatch.setattr(profile_inference, "compute_rows", skipping)
    size, roi, ov, bc = GEOMETRIES[0]
    with pytest.raises(SystemExit, match="differ from run_streaming"):
        profile_inference.main([str(size), str(roi), str(ov), str(bc), "--device", "cpu"])


def jax_values(monkeypatch, argv: list, env: dict) -> dict:
    """The size, roi, overlap, border cut and tile batch that the JAX
    script reads, its ``main`` stopped at the pipeline's construction."""
    from neuroclear_tpu.data import dicing
    from neuroclear_tpu.nn import generators
    from neuroclear_tpu.parallel import dice_infer
    from neuroclear_tpu.utils import imageops

    mod = load_jax_script("profile_inference")
    got = {}

    class Rng:
        def integers(self, lo, hi, shape, dtype):
            got["size"] = shape[0]
            return np.zeros((2, 2, 2), dtype)

    def grid(shape, roi, ov, bc):
        got.update(roi=roi, ov=ov, bc=bc)
        return types.SimpleNamespace(step=1, z_steps=1, y_steps=1, x_steps=1)

    class Net:
        def __init__(self, *a, **k):
            self.apply = None

        def init(self, *a):
            return {}

    def pipeline(*a, tile_batch, **k):
        got["tile_batch"] = tile_batch
        raise _Stop

    monkeypatch.setattr(np.random, "default_rng", lambda seed: Rng())
    monkeypatch.setattr(imageops, "pad_for_dicing", lambda vol, roi, ov: vol)
    monkeypatch.setattr(dicing, "DiceGrid", grid)
    monkeypatch.setattr(generators, "UNetDeconv", Net)
    monkeypatch.setattr(dice_infer, "DiceInferencePipeline", pipeline)
    monkeypatch.setattr(sys, "argv", ["profile_inference.py", *argv])
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(_Stop):
        mod.main()
    return got


@pytest.mark.parametrize("argv,env", [([], {}), (["300", "120"], {"BENCH_TILE_BATCH": "4"}),
                                      (["900", "120", "15", "10"], {"BENCH_TILE_BATCH": "2"})])
def test_argv_and_env_parse_as_jax(monkeypatch, argv, env):
    monkeypatch.delenv("BENCH_TILE_BATCH", raising=False)
    want = jax_values(monkeypatch, argv, env)
    a = profile_inference.parse_args(argv, env)
    assert {"size": a.size, "roi": a.roi, "ov": a.ov, "bc": a.bc,
            "tile_batch": a.tile_batch} == want
    assert a.device is None


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs a machine without one")
    with pytest.raises(SystemExit, match="profile_inference: no CUDA device"):
        profile_inference.main(["24", "12", "2", "2"])
