"""The rank program of the data-parallel CPU tests
(``tests/test_torch_dp_*.py``), and ``run_ranks``, which launches it.

    python -m torch.distributed.run --standalone --nproc_per_node W \
        tests/test_torch_dp_worker.py <task> <dir>

Each rank brings up gloo from torchrun's environment
(``train_parallel.maybe_initialize_distributed``), runs one CPU thread,
reads its case from ``<dir>/case.json`` and ``<dir>/inputs.npz`` and writes
``<dir>/rank<r>.npz``.  It imports torch, numpy and the port only (never
JAX), so the ranks start clean beside a test process that runs JAX.
``--standalone`` takes a free port from the system: no fixed port, so
several test workers launch at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


def run_ranks(task: str, workdir, world: int = 2, timeout: float = TIMEOUT_S,
              module: str | None = None, args=(), check: bool = True):
    """Launch ``world`` ranks of this program's ``task`` (or of ``python -m
    module args`` when ``module`` is given) under torchrun in ``workdir``
    (``world`` None: one process of ``module``, without torchrun); returns
    the finished process (stdout and stderr captured).  A hang is killed at
    ``timeout`` seconds and fails the caller.  The processes see no
    TensorBoard (a stub package that fails to import, which the trainers'
    visualizer reports and skips): its import takes ~20 s here."""
    target = ["-m", module, *args] if module else [os.path.abspath(__file__), task,
                                                     str(workdir)]
    if world is not None:
        target = ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                  str(world), *target]
    stub = os.path.join(str(workdir), "_stub", "tensorboard")
    os.makedirs(stub, exist_ok=True)
    with open(os.path.join(stub, "__init__.py"), "w") as f:
        f.write('raise ImportError("TensorBoard is left out of these test processes")\n')
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env["PYTHONPATH"] = os.pathsep.join([os.path.dirname(stub), ROOT,
                                         env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, *target], cwd=str(workdir), env=env,
                          capture_output=True, text=True, timeout=timeout)
    if check and proc.returncode != 0:
        raise AssertionError(f"{task or module} exited {proc.returncode}:\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-6000:]}")
    return proc


def save_case(workdir, case: dict, arrays: dict) -> None:
    with open(os.path.join(workdir, "case.json"), "w") as f:
        json.dump(case, f)
    np.savez(os.path.join(workdir, "inputs.npz"), **arrays)


def flats_arrays(flats: dict) -> dict:
    """{NAME: JAX flat dict} -> npz arrays keyed ``NAME/key``."""
    return {f"{n}/{k}": np.asarray(v) for n, f in flats.items() for k, v in f.items()}


def state_arrays(model) -> dict:
    """Every parameter and buffer of the nets (``NAME.param``) and both
    Adams' moments and steps (``adam.NAME.param.slot``)."""
    out = {}
    for name, net in model.nets.items():
        for pn, t in list(net.named_parameters()) + list(net.named_buffers()):
            out[f"{name}.{pn}"] = t.detach().cpu().numpy()
    for optim, names in ((model.optim_g, model.G_NAMES), (model.optim_d, model.D_NAMES)):
        for name in names:
            for pn, p in model.nets[name].named_parameters():
                for slot, v in optim.state.get(p, {}).items():
                    out[f"adam.{name}.{pn}.{slot}"] = v.detach().cpu().numpy()
    return out


def grads_arrays(model, g_grads, d_grads, prefix: str = "grad.") -> dict:
    names = [(n, pn) for n in model.G_NAMES for pn, _ in model.nets[n].named_parameters()]
    names += [(n, pn) for n in model.D_NAMES for pn, _ in model.nets[n].named_parameters()]
    return {f"{prefix}{n}.{pn}": g.detach().cpu().numpy()
            for (n, pn), g in zip(names, list(g_grads) + list(d_grads))}


# --------------------------------------------------------------- the ranks


def _inputs(workdir):
    with open(os.path.join(workdir, "case.json")) as f:
        case = json.load(f)
    with np.load(os.path.join(workdir, "inputs.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    return case, arrays


def _model(argv, arrays, prefix=""):
    from neuroclear_tpu_torch.models import create_model
    from neuroclear_tpu_torch.options import train_options

    opt = train_options.build_parser(argv).parse_args(argv)
    model = create_model(opt, "cpu")
    model.setup(opt)
    flats = {}
    for key, v in arrays.items():
        if key.startswith(prefix + "flat/"):
            name, k = key[len(prefix) + 5:].split("/", 1)
            flats.setdefault(name, {})[k] = v
    model.load_flats(flats)
    return model


def _draws(d):
    from neuroclear_tpu_torch.models.base_model import ProbeDraws

    return None if d is None else ProbeDraws(d[0], tuple(d[1]), tuple(d[2]))


def steps(workdir) -> None:
    """Per case of ``case.json``'s "cases" ({"prefix", "argv", "draws": one
    per step}; the inputs ``<prefix>flat/NAME/key`` and ``<prefix>crops``,
    (steps, W, z, y, x, 1)): the model from the flats under DataParallel,
    one step per entry on this rank's crop; records the first step's
    reduced losses and gradients and the state after each step."""
    from neuroclear_tpu_torch.parallel.train_parallel import DataParallel, rank

    case, arrays = _inputs(workdir)
    out = {}
    for c in case["cases"]:
        p = c["prefix"]
        model = _model(c["argv"], arrays, p)
        DataParallel(model)
        reduce = model.reduce_gradients
        captured = []

        def capture(losses, g, d, reduce=reduce, captured=captured):
            res = reduce(losses, g, d)
            captured.append(res)
            return res

        model.reduce_gradients = capture
        crops = arrays[p + "crops"]
        for s, d in enumerate(c["draws"]):
            r = rank()
            model.optimize_parameters(torch.from_numpy(crops[s, r:r + 1]), _draws(d))
            out.update({f"{p}step{s}.{k}": v for k, v in state_arrays(model).items()})
        losses, g, d = captured[0]
        out.update({f"{p}loss.{k}": v.numpy() for k, v in losses.items()})
        out.update(grads_arrays(model, g, d, p + "grad."))
    np.savez(os.path.join(workdir, f"rank{rank()}.npz"), **out)


def dice(workdir) -> None:
    """Per run of ``case.json``'s "runs" (grid, flags and generator:
    "identity", or "unet", a ``UNetDeconv`` from the flat ``flat/G/key``)
    the sharded streaming pipeline (``n_devices`` = world) and its ``run``
    on ``inputs.npz``'s ``vol<i>``; then a pipeline whose ``n_devices`` is
    not the world must raise."""
    from neuroclear_tpu_torch.data.dicing import DiceGrid
    from neuroclear_tpu_torch.parallel.dice_infer import DiceInferencePipeline
    from neuroclear_tpu_torch.parallel.train_parallel import rank, world

    case, arrays = _inputs(workdir)
    out = {}
    for i, c in enumerate(case["runs"]):
        grid = DiceGrid(tuple(c["shape"]), c["roi"], c["overlap"], c["border"])
        pipe = DiceInferencePipeline(dice_net(c["net"], arrays), grid, 1 / 65535.0,
                                     tile_batch=c["batch"], repetition=c["repetition"],
                                     n_devices=world(), out_dtype=c["out_dtype"],
                                     orig_shape=c["orig"], device="cpu")
        out[f"out{i}"] = pipe.run_streaming(arrays[f"vol{i}"])
        out[f"run{i}"] = pipe.run(arrays[f"vol{i}"])
    try:
        DiceInferencePipeline(lambda x: x, grid, 1.0, n_devices=world() + 1, device="cpu")
    except RuntimeError as e:
        out["refusal"] = np.asarray(str(e))
    np.savez(os.path.join(workdir, f"rank{rank()}.npz"), **out)


def dice_net(kind: str, arrays: dict):
    """The identity, or ``UNetDeconv`` on the flat ``flat/G/key`` of
    ``arrays``."""
    if kind == "identity":
        return lambda x: x
    from neuroclear_tpu_torch.nn.generators import UNetDeconv
    from neuroclear_tpu_torch.utils.weights import params_from_numpy

    net = UNetDeconv(1, 1)
    flat = {k[len("flat/G/"):]: v for k, v in arrays.items() if k.startswith("flat/G/")}
    net.load_state_dict(params_from_numpy(flat, net))
    return net


TASKS = {"steps": steps, "dice": dice}


def main() -> None:
    from neuroclear_tpu_torch.parallel.train_parallel import maybe_initialize_distributed

    task, workdir = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    if not maybe_initialize_distributed("cpu"):
        raise SystemExit("run under python -m torch.distributed.run")
    TASKS[task](workdir)


if __name__ == "__main__":
    main()
