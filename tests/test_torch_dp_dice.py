"""The sharded streaming tile pipeline (``DiceInferencePipeline(...,
n_devices=2)``, ``neuroclear_tpu_torch/parallel/dice_infer.py``) over two
gloo ranks under ``torchrun`` (``tests/test_torch_dp_worker.py``) on the CPU,
against the JAX package's ``n_devices=2`` ``run_streaming`` on two of the
eight virtual CPU devices and against the port's single-card pipeline.
JAX deals the slab's tiles to the ranks one by one, the port one card's
tile batches (so that a tile's bf16 output on the card is its one-card
one): the same sum in another f32 order.

Bounds: 1 uint16 LSB against both with the identity generator (the f32 sum
order in which the ranks' slab deltas join the accumulator; JAX's own
sharded bound, tests/test_dicing_assemble.py:140); with the real
``UNetDeconv`` (24^3 tiles) 1 LSB against the port's single card and
``E2E_LSB`` against JAX (the generator's own f32 bound,
tests/test_torch_dice.py).  ``run`` equals ``run_streaming`` bit for bit
on every rank, and both ranks return the same volume.  Three devices
under a world of two are refused (two without a process group:
tests/test_torch_dice_run.py).
"""

import numpy as np

from neuroclear_tpu.data.dicing import DiceGrid as JaxDiceGrid
from neuroclear_tpu.nn.core import unflatten_params
from neuroclear_tpu.nn.generators import UNetDeconv as JaxUNetDeconv
from neuroclear_tpu.parallel.dice_infer import DiceInferencePipeline as JaxPipeline
from neuroclear_tpu_torch.data.dicing import DiceGrid
from neuroclear_tpu_torch.nn.generators import UNetDeconv
from neuroclear_tpu_torch.parallel.dice_infer import DiceInferencePipeline
from neuroclear_tpu_torch.utils.weights import init_flat
from test_torch_dice import E2E_LSB
from test_torch_dp_worker import dice_net, flats_arrays, run_ranks, save_case

# (net, padded shape, roi, overlap, border, tile batch, flip-TTA, out dtype,
# original shape): several tiles a slab, each rank's share uneven
RUNS = [("identity", (28, 40, 52), 16, 4, 4, 2, False, "uint16", (27, 38, 50)),
        ("identity", (28, 28, 40), 16, 4, 4, 3, True, "uint8", None),
        ("identity", (28, 40, 40), 16, 4, 0, 2, False, None, (26, 39, 40)),
        ("unet", (28, 28, 40), 16, 4, 4, 2, False, "uint16", (26, 27, 38))]


def _jax_net(kind, flat):
    if kind == "identity":
        return (lambda params, x: x), {}
    return JaxUNetDeconv(1, 1).apply, unflatten_params(flat)


def test_two_ranks_match_jax_sharded_and_one_card(tmp_path):
    rng = np.random.default_rng(7)
    flat = init_flat(UNetDeconv(1, 1), seed=9)
    runs, arrays = [], flats_arrays({"flat/G": flat})
    for i, (net, shape, roi, overlap, b, batch, rep, out_dtype, orig) in enumerate(RUNS):
        arrays[f"vol{i}"] = rng.integers(0, 65535, shape).astype(np.uint16)
        runs.append({"net": net, "shape": shape, "roi": roi, "overlap": overlap, "border": b,
                     "batch": batch, "repetition": rep, "out_dtype": out_dtype,
                     "orig": orig})
    save_case(tmp_path, {"runs": runs}, arrays)
    run_ranks("dice", tmp_path)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    assert "world 2" in str(ranks[0]["refusal"])
    for i, (net, shape, roi, overlap, b, batch, rep, out_dtype, orig) in enumerate(RUNS):
        vol = arrays[f"vol{i}"]
        g, params = _jax_net(net, flat)
        kw = dict(tile_batch=batch, repetition=rep, out_dtype=out_dtype, orig_shape=orig)
        ref = JaxPipeline(g, params, JaxDiceGrid(shape, roi, overlap, b), 1 / 65535.0,
                          n_devices=2, **kw).run_streaming(vol)
        one = DiceInferencePipeline(dice_net(net, arrays), DiceGrid(shape, roi, overlap, b),
                                    1 / 65535.0, device="cpu", **kw).run_streaming(vol)
        out = ranks[0][f"out{i}"]
        assert out.shape == ref.shape == one.shape == (orig or shape) and out.std() > 0
        assert out.dtype == ref.dtype == one.dtype
        for r in range(2):
            assert np.array_equal(ranks[r][f"out{i}"], out)
            assert np.array_equal(ranks[r][f"run{i}"], out)
        scale = 1.0 if out_dtype is not None else 65535.0
        to_one, to_jax = (np.abs(out.astype(np.float64) - c.astype(np.float64)).max() * scale
                          for c in (one, ref))
        assert to_one <= 1, (i, to_one)
        assert to_jax <= (E2E_LSB if net == "unet" else 1), (i, to_jax)

