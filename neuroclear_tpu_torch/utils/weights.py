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


def kaiming_flat(net: nn.Module, seed: int) -> dict:
    """Random weights for ``net`` in the JAX flat format, as the JAX
    package's ``init_weight(..., 'kaiming')`` draws them: N(0, 2 / fan_in)
    with torch's fan rule (fan_in = I*k^dim for a conv, O*k^dim for a
    transposed conv), zero biases.  Drawn from numpy, so both packages can
    load them."""
    rng = np.random.default_rng(seed)
    flat = {}
    for name, layer in net.named_modules():
        if not isinstance(layer, _LAYERS):
            continue
        w = layer.weight
        if isinstance(layer, Conv):
            o, i = w.shape[:2]
        else:
            i, o = w.shape[:2]
        ks = tuple(w.shape[2:])
        fan_in = (o if isinstance(layer, ConvTranspose) else i) * math.prod(ks)
        std = math.sqrt(2.0 / fan_in)
        flat[f"{name}.w"] = (rng.standard_normal(ks + (i, o)) * std).astype(np.float32)
        if layer.bias is not None:
            flat[f"{name}.b"] = np.zeros((o,), np.float32)
    return flat


def count_params(net: nn.Module) -> int:
    return sum(p.numel() for p in net.parameters())
