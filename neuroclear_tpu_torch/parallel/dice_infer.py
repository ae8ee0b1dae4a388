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
(rows, Y, X) shape.

``n_devices`` = W > 1 is JAX's sharded streaming pipeline
(``_make_sharded_slab_step``) under an initialized process group of world W
(one process per card, ``parallel/train_parallel.py``): each rank runs its
share of a slab's tiles into a zero f32 (roi, Y, X) delta, one
``all_reduce`` SUM per slab merges the ranks' deltas, and every rank adds
the delta to its accumulator, emits the slab's rows and rolls the tail as
one card does, so every rank returns the volume.  The sum is the one card's
but for the f32 order in which the deltas join (within 1 uint16 LSB).
JAX's non-streaming ``_scan_sharded`` has no counterpart: ``run`` is
``run_streaming`` here too.  One departure from JAX, which deals the tiles
one by one (rank d takes tiles d, d + W, ...): the port deals one card's
tile batches (rank d takes batches d, d + W, ... of ``tile_batch`` tiles in
dicing order), so every tile runs in the batch, and at the place in it, that
it has on one card.  A tile's bf16 output on the card depends on both (its
batch's size, ROADMAP queue 3, and its place: the norm's statistics kernel
splits a batch's rows into blocks from the batch's first row); dealt one by
one, the shipped 9 tiles a slab at tile batch 2 over 2 ranks moved the
volume by up to 512 LSB from one card's.  Rank 0 then takes batches [0, 1],
[4, 5], [8] of each slab and rank 1 [2, 3], [6, 7].
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist
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


class HostCopier:
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


@dataclasses.dataclass
class _Stream:
    """One ``run_streaming`` run on the device: the raw samples' dtype, the
    chunks (``DiceInferencePipeline.upload``; ``streamed``: one per slab,
    else the one border-padded whole, widened to f32 once as ``whole``), the
    coverage weights along z, y and x, this rank's tile batches of (y, x)
    offsets, the output's (z, y, x) and the (roi, Y, X) f32 accumulator."""
    raw: np.dtype
    streamed: bool
    chunks: list
    whole: torch.Tensor | None
    inv_cz: torch.Tensor
    inv_cy: torch.Tensor
    inv_cx: torch.Tensor
    batches: list
    out_shape: tuple
    acc: torch.Tensor


class DiceInferencePipeline:
    """net: a generator module on ``device`` taking (N, D, H, W, 1) tiles.
    precision: compute dtype of the generator ('float32' or 'bfloat16');
    accumulation is always f32.  out_dtype: 'uint16' or 'uint8' casts on the
    device; None returns [0, 1] f32.  orig_shape: crop the dicing pad off on
    the device."""

    def __init__(self, net, grid: DiceGrid, inv_scale: float, tile_batch: int = 4,
                 repetition: bool = False, n_devices: int = 1, precision: str = "float32",
                 out_dtype=None, orig_shape=None, device=None):
        if n_devices != 1 and not (dist.is_initialized()
                                   and dist.get_world_size() == n_devices):
            world = dist.get_world_size() if dist.is_initialized() else None
            raise RuntimeError(f"n_devices {n_devices} runs one rank per card: it needs an "
                               f"initialized process group of world {n_devices} (torchrun), "
                               f"not {'none' if world is None else f'world {world}'}")
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"precision {precision!r}: float32 or bfloat16")
        out_dtype = np.dtype(out_dtype).name if out_dtype is not None else None
        if out_dtype not in _OUT_DTYPES:
            raise ValueError(f"out_dtype {out_dtype!r}: one of {_OUT_DTYPES}")
        self.net = net
        self.n_devices = int(n_devices)
        self.grid = grid
        self.inv_scale = float(inv_scale)
        self.tile_batch = int(tile_batch)
        self.repetition = repetition
        self.compute_dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
        self.out_dtype = out_dtype
        self.orig_shape = tuple(orig_shape) if orig_shape is not None else None
        self.device = resolve_device(device)
        # entered around each tile batch (``add_tiles``): a profiler's span
        self.batch_span = contextlib.nullcontext

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

    @staticmethod
    def _merge(delta: torch.Tensor) -> None:
        """The ranks' slab deltas summed, in place on every rank."""
        dist.all_reduce(delta)

    def run(self, vol_padded: np.ndarray) -> np.ndarray:
        """The JAX package's non-streaming entry point: the same volume as
        ``run_streaming``, which computes it."""
        return self.run_streaming(vol_padded)

    def _take(self, i: int) -> int:
        """The rows slab i emits: a step's, or roi for the last."""
        g = self.grid
        return g.roi_size if i == g.z_steps - 1 else g.step

    def _streamed(self) -> bool:
        """Whether each slab takes its rows from at most three z-chunks (one
        upload per slab), rather than from the border-padded whole volume
        (extreme overlap: a slab spans more than two chunks)."""
        g = self.grid
        b, step = g.border_cut, g.step
        ext = g.roi_size + 2 * b
        return step >= ext - step and g.z_steps > 1 and step > b

    def upload(self, vol_padded: np.ndarray) -> list:
        """The raw volume on the device as ``run_streaming`` takes it: one
        z-chunk per slab's own rows (a slab borrows the previous chunk's
        tail and the next chunk's head there), or at extreme overlap the
        border-padded whole volume as the one chunk."""
        g = self.grid
        b, step = g.border_cut, g.step
        vol_np = np.asarray(vol_padded)
        if self._streamed():
            zp = vol_np.shape[0]
            return [_upload(vol_np[i * step:(i + 1) * step if i < g.z_steps - 1 else zp],
                            self.device) for i in range(g.z_steps)]
        vol_bc = np.pad(vol_np, ((b, b),) * 3, mode="reflect") if b > 0 else vol_np
        return [_upload(vol_bc, self.device)]

    @torch.inference_mode()
    def prepare(self, vol_padded: np.ndarray, chunks=None) -> _Stream:
        """One run's state: the chunks (uploaded here unless given), the
        coverage weights, this rank's tile batches and a zero accumulator."""
        g = self.grid
        vol_np = np.asarray(vol_padded)
        dev = self.device
        chunks = self.upload(vol_np) if chunks is None else chunks
        offs_yx = [(y * g.step, x * g.step) for y in range(g.y_steps) for x in range(g.x_steps)]
        B, nd = self.tile_batch, self.n_devices
        batches = [offs_yx[j:j + B] for j in range(0, len(offs_yx), B)]
        _, yp, xp = vol_np.shape
        streamed = self._streamed()
        return _Stream(
            raw=vol_np.dtype, streamed=streamed, chunks=chunks,
            whole=None if streamed else _to_float(chunks[0], vol_np.dtype),
            inv_cz=torch.from_numpy(1.0 / g.coverage_1d(g.z_steps)).to(dev),
            inv_cy=torch.from_numpy(1.0 / g.coverage_1d(g.y_steps)).to(dev),
            inv_cx=torch.from_numpy(1.0 / g.coverage_1d(g.x_steps)).to(dev),
            batches=batches[dist.get_rank()::nd] if nd > 1 else batches,
            out_shape=self.orig_shape if self.orig_shape else vol_np.shape,
            acc=torch.zeros((g.roi_size, yp, xp), dtype=torch.float32, device=dev))

    def slab_volume(self, st: _Stream, i: int) -> torch.Tensor:
        """Slab i as f32 (ext, Y + 2b, X + 2b), reflect border included."""
        g = self.grid
        b, step, chunks = g.border_cut, g.step, st.chunks
        ext = g.roi_size + 2 * b
        if not st.streamed:
            return st.whole[i * step:i * step + ext]
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
        slab = _to_float(torch.cat(parts, dim=0), st.raw)
        return _reflect_yx(slab, b) if b > 0 else slab

    def add_tiles(self, slab: torch.Tensor, batch, dest: torch.Tensor) -> None:
        """One tile batch: the tiles at the (y, x) offsets of ``batch`` cut
        from ``slab``, through the generator, added into ``dest``."""
        roi = self.grid.roi_size
        ext = roi + 2 * self.grid.border_cut
        tiles = torch.stack([slab[:ext, y:y + ext, x:x + ext] for y, x in batch])
        y = self._generate((tiles * self.inv_scale).to(self.compute_dtype)[..., None])
        for k, (y0, x0) in enumerate(batch):
            dest[:, y0:y0 + roi, x0:x0 + roi] += y[k]

    @torch.inference_mode()
    def slab_rows(self, st: _Stream, i: int) -> torch.Tensor:
        """Slab i: its tiles added into the accumulator (one card) or into a
        zero delta that the slab's one all-reduce merges (a rank), then its
        finished rows emitted on the device (``_emit_rows``) and the overlap
        tail rolled to the accumulator's head.  Returns the emitted rows."""
        g = self.grid
        roi, step = g.roi_size, g.step
        acc = st.acc
        slab = self.slab_volume(st, i)
        dest = acc if self.n_devices == 1 else torch.zeros_like(acc)
        for batch in st.batches:
            with self.batch_span():
                self.add_tiles(slab, batch, dest)
        if self.n_devices > 1:
            self._merge(dest)
            acc += dest
        _, oy, ox = st.out_shape
        rows = _emit_rows(acc, st.inv_cz[i * step:i * step + roi], st.inv_cy, st.inv_cx,
                          self.out_dtype, oy, ox, self._take(i))
        # roll: tail rows [step, roi) seed the next slab; the rest zero
        acc[:roi - step] = acc[step:].clone()
        acc[roi - step:] = 0
        return rows

    def host_volume(self, st: _Stream, arrays: list, on_rows=None) -> np.ndarray:
        """The volume from the emitted rows on the host, slab by slab, each
        handed to ``on_rows`` as it is placed; cropped to orig_shape."""
        oz, oy, ox = st.out_shape
        rows, z_done = [], 0
        for i, arr in enumerate(arrays):
            r = _host_rows(arr, self.out_dtype).reshape(self._take(i), oy, ox)
            r = r[:max(0, oz - z_done)]
            if r.shape[0]:
                if on_rows is not None:
                    on_rows(r)
                rows.append(r)
                z_done += r.shape[0]
        return np.concatenate(rows, axis=0)

    @torch.inference_mode()
    def run_streaming(self, vol_padded: np.ndarray, on_rows=None) -> np.ndarray:
        """vol_padded: dicing-padded (z, y, x) raw volume (not border-padded).
        Returns the assembled volume, cropped to orig_shape when set."""
        st = self.prepare(vol_padded)
        copier = HostCopier(self.device)
        for i in range(self.grid.z_steps):
            copier.submit(self.slab_rows(st, i))
        return self.host_volume(st, copier.results(), on_rows)
