"""Overlap-tile ("dice") inference on the card: the port of
``neuroclear_tpu/parallel/dice_infer.py::DiceInferencePipeline`` (``run``
and ``run_streaming``).

The raw volume goes to the device once, as per-slab z-chunks.  Each z-slab
is assembled on the device with its reflect border (z edges from flipped
chunk rows, y/x edges by a reflect pad), cut into (roi + 2*border_cut)^3
tiles, run through the generator in batches of ``tile_batch`` (with flip-TTA
when ``repetition``), trimmed and added into a (roi, Y, X) f32 accumulator.
After each slab its finished rows are normalised by the separable coverage
counts, cropped and cast to the output dtype on the device, and copied into
pinned host memory on a side stream while the next slab computes (the JAX
package's ``copy_to_host_async``); the overlap tail rolls into the next slab.

``run`` is ``run_streaming``: the JAX package's ``run`` keeps a full-volume
accumulator and pads the last tile batch with zero-weight tiles, which adds
the same tiles in the same order, so the port gives both entry points the
one pipeline and the one answer.  Departures from the JAX package, neither
of which changes the result: the last tile batch of a slab may be short
(eager PyTorch needs no padded batches), and the emitted rows keep their
(rows, Y, X) shape.  The sharded multi-device paths wait for the multi-GPU
slice (ROADMAP.md, queue 1 item 9).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..data.dicing import DiceGrid

_OUT_DTYPES = (None, "uint8", "uint16")


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Raw samples to the device in their own width (uint16 travels as an
    int16 view and is widened back by ``_to_float``)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint16:
        arr = arr.view(np.int16)
    elif arr.dtype not in (np.uint8, np.float32):
        arr = arr.astype(np.float32)
    return torch.from_numpy(arr).to(device)


def _to_float(t: torch.Tensor, raw_dtype) -> torch.Tensor:
    if raw_dtype == np.uint16:
        return (t.to(torch.int32) & 0xFFFF).float()
    return t.float()


def _reflect_yx(slab: torch.Tensor, b: int) -> torch.Tensor:
    """numpy 'reflect' pad of the last two dims of a (Z, Y, X) tensor."""
    return F.pad(slab[None], (b, b, b, b), mode="reflect")[0]


def _emit_rows(acc, row_inv, inv_cy, inv_cx, out_dtype, oy, ox, take):
    """Coverage-normalise, crop and cast the first ``take`` rows of the slab
    accumulator.  uint16 leaves as int16 holding value - 32768 (exact), which
    ``_host_rows`` turns back."""
    emit = acc[:take] * row_inv[:take, None, None]
    emit = emit * inv_cy[None, :, None] * inv_cx[None, None, :]
    emit = emit[:, :oy, :ox]
    if out_dtype == "uint16":
        q = (torch.clamp(emit, 0.0, 1.0) * (2 ** 16 - 1)).to(torch.int32)
        return (q - 32768).to(torch.int16)
    if out_dtype == "uint8":
        return (torch.clamp(emit, 0.0, 1.0) * 255.0).to(torch.uint8)
    return emit.contiguous()


def _host_rows(arr: np.ndarray, out_dtype) -> np.ndarray:
    if out_dtype == "uint16":
        return arr.view(np.uint16) ^ np.uint16(0x8000)
    return arr


class _HostCopier:
    """Device-to-host copies into pinned buffers on a side stream, so each
    slab's rows travel while the next slab computes."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.buffers = []

    def submit(self, t: torch.Tensor) -> None:
        if not self.cuda:
            self.buffers.append(t)
            return
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.stream.wait_stream(torch.cuda.current_stream(t.device))
        with torch.cuda.stream(self.stream):
            host.copy_(t, non_blocking=True)
        t.record_stream(self.stream)
        self.buffers.append(host)

    def results(self) -> list:
        if self.cuda:
            self.stream.synchronize()
        return [h.numpy() for h in self.buffers]


class DiceInferencePipeline:
    """net: a generator module on ``device`` taking (N, D, H, W, 1) tiles.
    precision: compute dtype of the generator ('float32' or 'bfloat16');
    accumulation is always f32.  out_dtype: 'uint16' or 'uint8' casts on the
    device; None returns [0, 1] f32.  orig_shape: crop the dicing pad off on
    the device."""

    def __init__(self, net, grid: DiceGrid, inv_scale: float, tile_batch: int = 4,
                 repetition: bool = False, n_devices: int = 1, precision: str = "float32",
                 out_dtype=None, orig_shape=None, device=None):
        if n_devices != 1:
            raise NotImplementedError(f"n_devices {n_devices}: the sharded pipeline is not "
                                      "ported yet (ROADMAP.md, queue 1 item 9)")
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"precision {precision!r}: float32 or bfloat16")
        out_dtype = np.dtype(out_dtype).name if out_dtype is not None else None
        if out_dtype not in _OUT_DTYPES:
            raise ValueError(f"out_dtype {out_dtype!r}: one of {_OUT_DTYPES}")
        self.net = net
        self.grid = grid
        self.inv_scale = float(inv_scale)
        self.tile_batch = int(tile_batch)
        self.repetition = repetition
        self.compute_dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
        self.out_dtype = out_dtype
        self.orig_shape = tuple(orig_shape) if orig_shape is not None else None
        self.device = resolve_device(device)

    def _generate(self, x: torch.Tensor) -> torch.Tensor:
        """G on a (n, ext, ext, ext, 1) batch -> (n, roi, roi, roi) f32."""
        if self.repetition:
            y = self.net(torch.cat([x, x.flip(1), x.flip(2), x.flip(3)], dim=0))
            y0, yz, yy, yx = y.chunk(4, dim=0)
            y = (y0 + yz.flip(1) + yy.flip(2) + yx.flip(3)) * 0.25
        else:
            y = self.net(x)
        y = y[..., 0].float()
        b = self.grid.border_cut
        return y[:, b:-b, b:-b, b:-b] if b > 0 else y

    def run(self, vol_padded: np.ndarray) -> np.ndarray:
        """The JAX package's non-streaming entry point: the same volume as
        ``run_streaming``, which computes it."""
        return self.run_streaming(vol_padded)

    @torch.inference_mode()
    def run_streaming(self, vol_padded: np.ndarray, on_rows=None) -> np.ndarray:
        """vol_padded: dicing-padded (z, y, x) raw volume (not border-padded).
        Returns the assembled volume, cropped to orig_shape when set."""
        g = self.grid
        b, roi, step = g.border_cut, g.roi_size, g.step
        ext = roi + 2 * b
        dev = self.device
        vol_np = np.asarray(vol_padded)
        Zp, Yp, Xp = vol_np.shape
        raw = vol_np.dtype

        if step >= ext - step and g.z_steps > 1 and step > b:
            # one upload per slab's own rows; a slab borrows the previous
            # chunk's tail and the next chunk's head on the device
            chunks = []
            for i in range(g.z_steps):
                z1 = (i + 1) * step if i < g.z_steps - 1 else Zp
                chunks.append(_upload(vol_np[i * step:z1], dev))

            def slab_volume(i):
                parts = []
                if i == 0:
                    if b > 0:  # reflect: rows b..1 of chunk 0
                        parts.append(chunks[0][1:b + 1].flip(0))
                else:
                    parts.append(chunks[i - 1][step - b:])
                parts.append(chunks[i])
                if i < g.z_steps - 1:
                    parts.append(chunks[i + 1][:ext - b - step])
                elif b > 0:  # reflect: the last b rows mirrored
                    parts.append(chunks[i][-b - 1:-1].flip(0))
                slab = _to_float(torch.cat(parts, dim=0), raw)
                return _reflect_yx(slab, b) if b > 0 else slab
        else:
            # extreme overlap (a slab spans more than two chunks)
            vol_bc = np.pad(vol_np, ((b, b),) * 3, mode="reflect") if b > 0 else vol_np
            whole = _to_float(_upload(vol_bc, dev), raw)

            def slab_volume(i):
                return whole[i * step:i * step + ext]

        offs_yx = [(y * step, x * step) for y in range(g.y_steps) for x in range(g.x_steps)]
        inv_cz = torch.from_numpy(1.0 / g.coverage_1d(g.z_steps)).to(dev)
        inv_cy = torch.from_numpy(1.0 / g.coverage_1d(g.y_steps)).to(dev)
        inv_cx = torch.from_numpy(1.0 / g.coverage_1d(g.x_steps)).to(dev)
        oz, oy, ox = self.orig_shape if self.orig_shape else (Zp, Yp, Xp)

        acc = torch.zeros((roi, Yp, Xp), dtype=torch.float32, device=dev)
        copier = _HostCopier(dev)
        takes = []
        B = self.tile_batch
        for i in range(g.z_steps):
            slab = slab_volume(i)
            for j in range(0, len(offs_yx), B):
                batch = offs_yx[j:j + B]
                tiles = torch.stack([slab[:ext, y:y + ext, x:x + ext] for y, x in batch])
                y = self._generate((tiles * self.inv_scale).to(self.compute_dtype)[..., None])
                for k, (y0, x0) in enumerate(batch):
                    acc[:, y0:y0 + roi, x0:x0 + roi] += y[k]
            take = roi if i == g.z_steps - 1 else step
            row_inv = inv_cz[i * step:i * step + roi]
            copier.submit(_emit_rows(acc, row_inv, inv_cy, inv_cx, self.out_dtype,
                                     oy, ox, take))
            takes.append(take)
            # roll: tail rows [step, roi) seed the next slab; the rest zero
            acc[:roi - step] = acc[step:].clone()
            acc[roi - step:] = 0

        rows, z_done = [], 0
        for arr, take in zip(copier.results(), takes):
            r = _host_rows(arr, self.out_dtype).reshape(take, oy, ox)[:max(0, oz - z_done)]
            if r.shape[0]:
                if on_rows is not None:
                    on_rows(r)
                rows.append(r)
                z_done += r.shape[0]
        return np.concatenate(rows, axis=0)
