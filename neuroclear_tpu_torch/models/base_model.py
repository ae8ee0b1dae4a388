"""The checkpoint side of ``neuroclear_tpu/models/base_model.py``: one
``{suffix}_net_{NAME}.npz`` per network in the JAX flat format, and the
optimizer state as ``{suffix}_optim.npz`` in the JAX layout, each written
atomically (a temporary file, then a rename), so that either package loads
what the other wrote.

The JAX package's optimizer state is ``{"D": ScaleByAdamState, "G":
ScaleByAdamState}`` (optax's ``count, mu, nu``), tree-flattened to arrays
``"0"`` .. ``"N-1"``: D's count, D's mu leaves, D's nu leaves, then G's.
The leaves of mu and nu follow JAX's dict order, sorted key by key along
each parameter's path ({net: {module: ... {"w", "b"}}}), with conv kernels
in the (k..., I, O) layout.  ``__lr{i}__`` holds the i-th learning-rate
controller's position (``LRController.state()``).  A ``torch.optim.Adam``
maps onto it as count -> every parameter's ``step``, mu -> ``exp_avg``, nu
-> ``exp_avg_sq``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.weights import flat_from_module, jax_named_params, load_npz, params_from_numpy, \
    to_numpy


def atomic_savez(path: str, arrays: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # a file handle: savez appends no '.npz'
        np.savez(f, **arrays)
    os.replace(tmp, path)


def save_networks(nets: dict, save_dir: str, suffix: str) -> list:
    """Write every net of ``nets`` ({NAME: module}); returns the paths."""
    os.makedirs(save_dir, exist_ok=True)
    paths = []
    for name, net in nets.items():
        path = os.path.join(save_dir, f"{suffix}_net_{name}.npz")
        atomic_savez(path, flat_from_module(net))
        paths.append(path)
    return paths


def load_networks(nets: dict, save_dir: str, suffix: str) -> None:
    """Load ``{suffix}_net_{NAME}.npz`` into every net of ``nets``."""
    for name, net in nets.items():
        path = os.path.join(save_dir, f"{suffix}_net_{name}.npz")
        print(f"loading the model from {path}", flush=True)
        net.load_state_dict(params_from_numpy(load_npz(path), net))


def _leaves(nets: dict):
    """(to_jax, from_jax, parameter) of every parameter of ``nets`` in the
    order of JAX's flattening of {NAME: param tree}."""
    entries = [((name, *key.split(".")), to_jax, from_jax, p)
               for name, net in nets.items() for key, to_jax, from_jax, p in jax_named_params(net)]
    entries.sort(key=lambda e: e[0])
    return [e[1:] for e in entries]


def optim_arrays(groups, lr_controllers) -> dict:
    """``groups``: [(optimizer, {NAME: net})] in JAX's order (D, then G).
    Returns the ``{suffix}_optim.npz`` arrays."""
    flat = []
    for optim, nets in groups:
        leaves = _leaves(nets)
        states = [optim.state.get(p, {}) for _, _, p in leaves]
        steps = {int(s["step"]) if s else 0 for s in states}
        if len(steps) != 1:
            raise RuntimeError(f"the parameters of one optimizer are at steps {sorted(steps)}")
        mu = [to_numpy(to_jax(s["exp_avg"])) if s else np.zeros(to_jax(p).shape, np.float32)
              for (to_jax, _, p), s in zip(leaves, states)]
        nu = [to_numpy(to_jax(s["exp_avg_sq"])) if s else np.zeros(to_jax(p).shape, np.float32)
              for (to_jax, _, p), s in zip(leaves, states)]
        flat += [np.asarray(steps.pop(), np.int32), *mu, *nu]
    arrays = {str(i): a for i, a in enumerate(flat)}
    for i, c in enumerate(lr_controllers):
        arrays[f"__lr{i}__"] = np.asarray(c.state(), np.float64)
    return arrays


def save_optim(path: str, groups, lr_controllers) -> None:
    atomic_savez(path, optim_arrays(groups, lr_controllers))


def load_optim(path: str, groups, lr_controllers) -> bool:
    """Restore the learning-rate controllers and the Adam state from
    ``path`` where it exists; as the JAX package does, a file whose leaf
    count does not match is reported and skipped.  Returns whether the
    optimizer state was restored."""
    if not os.path.exists(path):
        return False
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    for i, c in enumerate(lr_controllers):
        if f"__lr{i}__" in arrays:
            c.restore(arrays[f"__lr{i}__"])
    n = len([k for k in arrays if not k.startswith("__lr")])
    plan = [(optim, _leaves(nets)) for optim, nets in groups]
    if n != sum(1 + 2 * len(leaves) for _, leaves in plan):
        print(f"optimizer state at {path} does not match; skipping", flush=True)
        return False
    i = 0
    for optim, leaves in plan:
        count = float(arrays[str(i)])
        mu = [arrays[str(i + 1 + j)] for j in range(len(leaves))]
        nu = [arrays[str(i + 1 + len(leaves) + j)] for j in range(len(leaves))]
        i += 1 + 2 * len(leaves)
        for (_, from_jax, p), m, v in zip(leaves, mu, nu):
            def load(a):
                return from_jax(np.asarray(a, np.float32)).to(p.device).contiguous()
            optim.state[p] = {"step": torch.tensor(count, dtype=torch.float32),
                              "exp_avg": load(m), "exp_avg_sq": load(v)}
    print(f"restored optimizer state from {path}", flush=True)
    return True
