"""Checkpoint interchange with the original PyTorch NeuroClear, the port's own
copy of ``neuroclear_tpu/utils/torch_export.py``: between the JAX flat
``.npz`` layout (``{module path}.w`` / ``.b``, conv kernels (k..., I, O))
and the original's ``{suffix}_net_{NAME}.pth`` state dicts, with its key
names and tensor layouts, for the production networks:

  * unet_deconv      (the original's Unet_deconv)
  * deep_linear_gen  (DeepLinearGenerator)
  * basic            (the n_layers=3 PatchGAN, instance norm)

A conv kernel is (O, I, k...) in the original, a transposed conv's (I, O,
k...).  The JAX package stores a transposed kernel in the original's
orientation and flips it spatially inside ``apply``, as does the port's
``ConvTranspose`` (``F.conv_transpose3d``), so each conversion is an axis
permutation with no flip.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch


def _t_conv(w):  # (*k, I, O) -> (O, I, *k)
    nd = w.ndim
    return np.transpose(w, (nd - 1, nd - 2) + tuple(range(nd - 2)))


def _f_conv(w):  # (O, I, *k) -> (*k, I, O)
    nd = w.ndim
    return np.transpose(w, tuple(range(2, nd)) + (1, 0))


def _t_convT(w):  # (*k, I, O) -> (I, O, *k)
    nd = w.ndim
    return np.transpose(w, (nd - 2, nd - 1) + tuple(range(nd - 2)))


def _f_convT(w):  # (I, O, *k) -> (*k, I, O)
    nd = w.ndim
    return np.transpose(w, tuple(range(2, nd)) + (0, 1))


# (JAX module path, the original's key prefix, kind)
UNET_DECONV_MAP = [
    ("double_conv1.conv0", "double_conv1.convolution.0", "conv"),
    ("double_conv1.conv1", "double_conv1.convolution.3", "conv"),
    ("double_conv2.conv0", "double_conv2.convolution.0", "conv"),
    ("double_conv2.conv1", "double_conv2.convolution.3", "conv"),
    ("bottom_layer.conv0", "bottom_layer.convolution.0", "conv"),
    ("bottom_layer.conv1", "bottom_layer.convolution.3", "conv"),
    ("bottom_layer.conv2", "bottom_layer.convolution.6", "conv"),
    ("t_conv2", "t_conv2", "convT"),
    ("ex_double_conv2.conv0", "ex_double_conv2.convolution.0", "conv"),
    ("ex_double_conv2.conv1", "ex_double_conv2.convolution.3", "conv"),
    ("t_conv1", "t_conv1", "convT"),
    ("ex_conv1_1.conv0", "ex_conv1_1.convolution.0", "conv"),
    ("one_by_one", "one_by_one", "conv"),
    ("one_by_one_2", "one_by_one_2", "conv"),
]

DEEP_LINEAR_MAP = [
    ("first_layer", "first_layer", "conv"),
    ("feat0", "feature_block.0", "conv"),
    ("feat1", "feature_block.1", "conv"),
    ("feat2", "feature_block.2", "conv"),
    ("feat3", "feature_block.3", "conv"),
    ("final_layer", "final_layer", "conv"),
]

# the PatchGAN's Sequential: the modules without parameters (activations and
# norms) take the slots 1, 3, 4, 6, 7, 9 and 10
PATCHGAN_MAP = [
    ("conv0", "model.0", "conv"),
    ("conv1", "model.2", "conv"),
    ("conv2", "model.5", "conv"),
    ("conv3", "model.8", "conv"),
    ("conv_out", "model.11", "conv"),
]

NET_MAPS = {
    "unet_deconv": UNET_DECONV_MAP,
    "deep_linear_gen": DEEP_LINEAR_MAP,
    "basic": PATCHGAN_MAP,
}


def params_to_state_dict(flat: dict, arch: str) -> "OrderedDict[str, np.ndarray]":
    """A JAX flat dict -> the original's state dict (numpy, its layouts)."""
    out = OrderedDict()
    for ours, theirs, kind in NET_MAPS[arch]:
        w = np.asarray(flat[ours + ".w"], np.float32)
        out[theirs + ".weight"] = _t_convT(w) if kind == "convT" else _t_conv(w)
        if ours + ".b" in flat:
            out[theirs + ".bias"] = np.asarray(flat[ours + ".b"], np.float32)
    return out


def state_dict_to_params(state_dict, arch: str) -> dict:
    """The original's state dict (numpy arrays or tensors) -> a JAX flat
    dict."""
    flat = {}
    for ours, theirs, kind in NET_MAPS[arch]:
        w = np.asarray(state_dict[theirs + ".weight"], np.float32)
        flat[ours + ".w"] = np.ascontiguousarray(_f_convT(w) if kind == "convT" else _f_conv(w))
        bkey = theirs + ".bias"
        if bkey in state_dict:
            flat[ours + ".b"] = np.asarray(state_dict[bkey], np.float32)
    return flat


def export_pth(flat: dict, arch: str, path: str) -> None:
    """Write a ``.pth`` that the original's ``load_networks`` reads."""
    sd = OrderedDict((k, torch.from_numpy(np.ascontiguousarray(v)))
                     for k, v in params_to_state_dict(flat, arch).items())
    torch.save(sd, path)


def import_pth(path: str, arch: str) -> dict:
    """Read an original ``.pth`` (tensors only) as a JAX flat dict."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return state_dict_to_params({k: v.numpy() for k, v in sd.items()}, arch)
