"""Weights across the two packages.

The JAX package checkpoints a network as a flat ``.npz`` of its parameter
tree's leaves under their dotted paths (``nn/core.py:287-307``, written by
``models/base_model.py:241``): a conv's, transposed conv's or linear
layer's ``w`` (kernels in (k..., I, O) order, linear weights (in, out)) and
``b``, a spectral conv's power-iteration vector ``u``, a batch norm's
``scale``, ``offset``, ``running_mean`` and ``running_var``, and the fixed
kernel's ``psf``.  The port's modules keep the same paths (a net's
``jax_paths`` renames a child where the port's name differs) and PyTorch's
layouts; ``params_from_numpy`` reads that format and ``flat_from_module``
writes it.  ``u``, the running statistics and ``psf`` are buffers in the
port: the optimizer does not see them (their gradient is zero in JAX, so
Adam leaves them as they are there too).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..nn.core import Conv, ConvTranspose, Linear
from ..nn.generators import FixedLinearKernel
from ..nn.norms import BatchNorm

_LAYERS = (Conv, ConvTranspose, Linear)


def load_npz(path: str) -> dict:
    """A ``{suffix}_net_{NAME}.npz`` checkpoint as a flat {key: array} dict."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _jax_prefix(net: nn.Module, name: str) -> str:
    """The JAX path of the module at ``name`` (each parent's ``jax_paths``
    renaming its children)."""
    out, module = [], net
    for part in name.split(".") if name else []:
        out.append(getattr(module, "jax_paths", {}).get(part, part))
        module = getattr(module, part)
    return ".".join(out)


def jax_leaves(net: nn.Module) -> list:
    """(JAX flat key, state-dict key, to_jax, from_jax, tensor, is_parameter)
    of every leaf of ``net``'s JAX parameter tree: ``to_jax`` maps a tensor
    of the leaf's shape to the JAX layout, ``from_jax`` back."""
    out = []
    for name, m in net.named_modules():
        jp = _jax_prefix(net, name)

        def leaf(jax_leaf, attr, to_jax=_same, from_jax=torch.as_tensor, param=True):
            key = f"{jp}.{jax_leaf}" if jp else jax_leaf
            sd = f"{name}.{attr}" if name else attr
            out.append((key, sd, to_jax, from_jax, getattr(m, attr), param))

        if isinstance(m, _LAYERS):
            leaf("w", "weight", m.weight_to_jax, m.weight_from_jax)
            if m.bias is not None:
                leaf("b", "bias")
            if getattr(m, "spectral", False):
                leaf("u", "u", param=False)
        elif isinstance(m, BatchNorm):
            leaf("scale", "scale")
            leaf("offset", "offset")
            leaf("running_mean", "running_mean", param=False)
            leaf("running_var", "running_var", param=False)
        elif isinstance(m, FixedLinearKernel):
            leaf("psf", "psf", param=False)
    return out


def params_from_numpy(flat: dict, net: nn.Module) -> dict:
    """The JAX flat dict -> a state dict for ``net``.  Raises on a key the
    net does not have, or on a leaf of the net that the dict lacks."""
    leaves = {key: (sd, from_jax) for key, sd, _, from_jax, _, _ in jax_leaves(net)}
    state = {}
    for key, arr in flat.items():
        if key not in leaves:
            raise KeyError(f"checkpoint key {key!r} has no counterpart in {type(net).__name__}")
        sd, from_jax = leaves[key]
        state[sd] = from_jax(np.array(arr, np.float32))
    missing = set(net.state_dict()) - set(state)
    if missing:
        raise KeyError(f"checkpoint lacks {sorted(missing)}")
    return state


def _same(t):
    return t


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A float32 numpy copy (never a view of a live parameter)."""
    return np.array(t.detach().to("cpu", torch.float32))


def flat_from_module(net: nn.Module) -> dict:
    """``net``'s leaves in the JAX flat format: {key: f32 numpy array},
    conv kernels as (k..., I, O)."""
    return {key: to_numpy(to_jax(t)) for key, _, to_jax, _, t, _ in jax_leaves(net)}


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
    """Random weights for ``net`` in the JAX flat format, drawn from numpy
    seed ``seed`` in module order as the JAX layers' ``init`` methods give
    them: each kernel or linear weight by ``init_weight``, then a spectral
    conv's ``u`` ~ N(0, 1); zero biases; a batch norm's ``scale`` ~ N(1,
    gain), ``offset`` 0, running statistics 0 and 1; a fixed kernel's PSF as
    the module holds it (the JAX net has no init)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, _, to_jax, _, t, _ in jax_leaves(net):
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "w":
            kshape = tuple(to_jax(t).shape)
            flat[key] = init_weight(rng, kshape, init_type, gain,
                                    to_jax is ConvTranspose.weight_to_jax)
        elif leaf == "u":
            flat[key] = rng.standard_normal(t.shape).astype(np.float32)
        elif leaf == "scale":
            flat[key] = (1.0 + rng.standard_normal(t.shape) * gain).astype(np.float32)
        elif leaf in ("b", "offset", "running_mean"):
            flat[key] = np.zeros(t.shape, np.float32)
        elif leaf == "running_var":
            flat[key] = np.ones(t.shape, np.float32)
        else:
            flat[key] = to_numpy(to_jax(t))
    return flat


def count_params(net: nn.Module) -> int:
    return sum(p.numel() for p in net.parameters())
