"""Weights across the two packages.

The JAX package checkpoints a network as a flat ``.npz`` of
``{module path}.w`` / ``{module path}.b`` arrays (``nn/core.py:287-307``,
written by ``models/base_model.py:241``), conv kernels in (k..., I, O)
order.  The port's modules keep the same paths and PyTorch's layouts;
``params_from_numpy`` reads that format and ``flat_from_module`` writes it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..nn.core import Conv, ConvTranspose

_LAYERS = (Conv, ConvTranspose)


def load_npz(path: str) -> dict:
    """A ``{suffix}_net_{NAME}.npz`` checkpoint as a flat {key: array} dict."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def params_from_numpy(flat: dict, net: nn.Module) -> dict:
    """The JAX flat dict -> a state dict for ``net``.  Raises on a key the
    net does not have, or on a parameter of the net that the dict lacks."""
    state = {}
    for key, arr in flat.items():
        prefix, leaf = key.rsplit(".", 1)
        layer = net.get_submodule(prefix)
        if not isinstance(layer, _LAYERS) or leaf not in ("w", "b"):
            raise KeyError(f"checkpoint key {key!r} has no counterpart in {type(net).__name__}")
        if leaf == "w":
            state[f"{prefix}.weight"] = layer.weight_from_jax(np.array(arr, np.float32))
        else:
            state[f"{prefix}.bias"] = torch.as_tensor(np.array(arr, np.float32))
    missing = set(net.state_dict()) - set(state)
    if missing:
        raise KeyError(f"checkpoint lacks {sorted(missing)}")
    return state


def jax_named_params(net: nn.Module) -> list:
    """(JAX flat key, to_jax, from_jax, parameter) of each of ``net``'s
    parameters: ``to_jax`` maps a tensor of the parameter's shape to the JAX
    layout, ``from_jax`` back."""
    out = []
    for name, layer in net.named_modules():
        if not isinstance(layer, _LAYERS):
            continue
        out.append((f"{name}.w", layer.weight_to_jax, layer.weight_from_jax, layer.weight))
        if layer.bias is not None:
            out.append((f"{name}.b", _same, torch.as_tensor, layer.bias))
    return out


def _same(t):
    return t


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A float32 numpy copy (never a view of a live parameter)."""
    return np.array(t.detach().to("cpu", torch.float32))


def flat_from_module(net: nn.Module) -> dict:
    """``net``'s parameters in the JAX flat format: {key: f32 numpy array},
    conv kernels as (k..., I, O)."""
    return {key: to_numpy(to_jax(p)) for key, to_jax, _, p in jax_named_params(net)}


INIT_TYPES = ("normal", "xavier", "kaiming", "orthogonal")


def fans(kshape, transpose: bool = False) -> tuple:
    """(fan_in, fan_out) of a kernel of JAX shape (k..., I, O) by torch's
    rule: fan_in = I * prod(k) for a conv; for a transposed conv, whose
    torch weight is (I, O, k...), torch keys off dim 1, so fan_in = O *
    prod(k) (``nn/core.py::_fans``)."""
    receptive = math.prod(kshape[:-2])
    i, o = kshape[-2:]
    if transpose:
        return o * receptive, i * receptive
    return i * receptive, o * receptive


def init_weight(rng: np.random.Generator, kshape, init_type: str, gain: float,
                transpose: bool = False) -> np.ndarray:
    """A float32 kernel of JAX shape (k..., I, O) drawn from ``rng`` as
    ``init_weight`` of the JAX package draws it: normal N(0, gain); xavier
    N(0, gain * sqrt(2 / (fan_in + fan_out))); kaiming N(0, sqrt(2 /
    fan_in)); orthogonal: the Q of a QR of a Gaussian matrix with the signs
    of R's diagonal folded in, on the (O, rest) flattening (rest in the
    order (k..., I)), times gain."""
    kshape = tuple(int(k) for k in kshape)
    fan_in, fan_out = fans(kshape, transpose)
    if init_type == "orthogonal":
        rows = kshape[-1]
        cols = math.prod(kshape) // rows
        q, r = np.linalg.qr(rng.standard_normal((max(rows, cols), min(rows, cols))))
        q = q * np.sign(np.diagonal(r))
        if rows < cols:
            q = q.T
        w = q[:rows, :cols] * gain
        w = w.reshape((rows,) + kshape[:-1]).transpose(tuple(range(1, len(kshape))) + (0,))
        return np.ascontiguousarray(w, np.float32)
    if init_type == "normal":
        std = gain
    elif init_type == "xavier":
        std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    elif init_type == "kaiming":
        std = math.sqrt(2.0 / fan_in)
    else:
        raise NotImplementedError(f"initialization method [{init_type}] is not implemented; "
                                  f"the port has {INIT_TYPES}")
    return (rng.standard_normal(kshape) * std).astype(np.float32)


def init_flat(net: nn.Module, init_type: str = "kaiming", gain: float = 0.02,
              seed: int = 0) -> dict:
    """Random weights for ``net`` in the JAX flat format, each kernel drawn
    by ``init_weight`` in module order from numpy seed ``seed`` (so both
    packages can load them), zero biases, as the JAX layers' ``init``
    methods give them."""
    rng = np.random.default_rng(seed)
    flat = {}
    for name, layer in net.named_modules():
        if not isinstance(layer, _LAYERS):
            continue
        w = layer.weight
        transpose = isinstance(layer, ConvTranspose)
        i, o = (w.shape[0], w.shape[1]) if transpose else (w.shape[1], w.shape[0])
        flat[f"{name}.w"] = init_weight(rng, tuple(w.shape[2:]) + (i, o), init_type, gain,
                                        transpose)
        if layer.bias is not None:
            flat[f"{name}.b"] = np.zeros((o,), np.float32)
    return flat


def count_params(net: nn.Module) -> int:
    return sum(p.numel() for p in net.parameters())
