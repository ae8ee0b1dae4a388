"""Baseline-TIFF and ``.npy`` I/O in numpy alone: the port's counterpart of
``neuroclear_tpu/utils/tiffio.py``, which needs PIL and a native codec.

``imwrite`` and ``StreamingTiffWriter`` write the layout of the JAX
package's ``StreamingTiffWriter``, which is byte-identical to its native
``tiff_write``: little-endian, header | page 0 | IFD 0 | page 1 | IFD 1 | ...,
one strip per page, ten tags per IFD.  ``imread`` and ``probe`` read any
uncompressed baseline TIFF: strips, either byte order, one sample per pixel,
8- or 16-bit unsigned or 32-bit float samples, one page or many.  Where the
JAX package falls back to PIL (a compressed, tiled or otherwise exotic
file), this module raises an error that names the file and the tag.
"""

from __future__ import annotations

import os

import numpy as np

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8,
              16: 8}
_INT_TYPES = {1: "u1", 3: "u2", 4: "u4", 6: "i1", 8: "i2", 9: "i4", 16: "u8"}
_DTYPES = {(8, 1): np.uint8, (16, 1): np.uint16, (32, 3): np.float32}
_TAG_NAMES = {256: "ImageWidth", 257: "ImageLength", 258: "BitsPerSample",
              259: "Compression", 273: "StripOffsets", 277: "SamplesPerPixel",
              279: "StripByteCounts", 317: "Predictor", 322: "TileWidth",
              339: "SampleFormat"}


class TiffFormatError(ValueError):
    """A TIFF this reader does not take: the message names the file and the
    tag."""


def _refuse(path: str, tag: int, what: str) -> TiffFormatError:
    return TiffFormatError(f"{path}: TIFF tag {tag} ({_TAG_NAMES.get(tag, 'unknown')}) "
                           f"{what}; only uncompressed baseline TIFF is read "
                           "(8/16-bit unsigned or 32-bit float, one sample per pixel)")


class _Page:
    """One IFD's geometry: shape, dtype and strip (offset, bytes) pairs."""

    def __init__(self, path: str, tags: dict):
        def one(tag, default=None):
            v = tags.get(tag)
            if v is None:
                if default is None:
                    raise _refuse(path, tag, "is missing")
                return default
            return int(v[0])

        if one(259, 1) != 1:
            raise _refuse(path, 259, f"is {one(259)} (compressed)")
        if 322 in tags:
            raise _refuse(path, 322, "is present (tiled)")
        if one(277, 1) != 1:
            raise _refuse(path, 277, f"is {one(277)}")
        if one(317, 1) != 1:
            raise _refuse(path, 317, f"is {one(317)}")
        bits, fmt = one(258, 1), one(339, 1)
        if (bits, fmt) not in _DTYPES:
            tag = 258 if bits not in (8, 16, 32) else 339
            raise _refuse(path, tag, f"gives {bits}-bit samples of format {fmt}")
        self.dtype = np.dtype(_DTYPES[bits, fmt])
        self.shape = (one(257), one(256))
        self.strips = list(zip((int(v) for v in tags[273]), (int(v) for v in tags[279])))
        if sum(n for _, n in self.strips) < self.shape[0] * self.shape[1] * self.dtype.itemsize:
            raise _refuse(path, 279, "holds fewer bytes than the page")


def _parse(path: str):
    """(byte-order character, [_Page, ...]) of a TIFF file."""
    with open(path, "rb") as f:
        head = f.read(8)
        if head[:2] not in (b"II", b"MM"):
            raise TiffFormatError(f"{path}: not a TIFF file")
        bo = "<" if head[:2] == b"II" else ">"
        magic = int(np.frombuffer(head, bo + "u2", 1, 2)[0])
        if magic != 42:
            raise TiffFormatError(f"{path}: TIFF version {magic} (BigTIFF is not read)")
        off = int(np.frombuffer(head, bo + "u4", 1, 4)[0])
        pages, seen = [], set()
        while off:
            if off in seen:
                raise TiffFormatError(f"{path}: IFD chain loops at offset {off}")
            seen.add(off)
            f.seek(off)
            n = int(np.frombuffer(f.read(2), bo + "u2")[0])
            raw = f.read(12 * n + 4)
            tags = {}
            for i in range(n):
                e = raw[12 * i:12 * i + 12]
                tag, typ = (int(v) for v in np.frombuffer(e, bo + "u2", 2))
                count = int(np.frombuffer(e, bo + "u4", 1, 4)[0])
                if typ not in _INT_TYPES:
                    continue  # a rational or ASCII tag: nothing the reader needs
                size = _TYPE_SIZE[typ] * count
                if size <= 4:
                    data = e[8:8 + size]
                else:
                    here = f.tell()
                    f.seek(int(np.frombuffer(e, bo + "u4", 1, 8)[0]))
                    data = f.read(size)
                    f.seek(here)
                tags[tag] = np.frombuffer(data, bo + _INT_TYPES[typ], count)
            pages.append(_Page(path, tags))
            off = int(np.frombuffer(raw, bo + "u4", 1, 12 * n)[0])
    if not pages:
        raise TiffFormatError(f"{path}: no image in the file")
    first = pages[0]
    for p in pages[1:]:
        if p.shape != first.shape or p.dtype != first.dtype:
            raise TiffFormatError(f"{path}: pages differ in shape or sample type")
    return bo, pages


def probe(path: str):
    """((z, y, x), dtype) of a stack without reading its pixel data."""
    if path.endswith(".npy"):
        arr = np.load(path, mmap_mode="r")
        return arr.shape, arr.dtype
    _, pages = _parse(path)
    return (len(pages),) + pages[0].shape, pages[0].dtype


def imread(path: str) -> np.ndarray:
    """A 2D image or a (z, y, x) stack, in native byte order."""
    if path.endswith(".npy"):
        return np.load(path)
    bo, pages = _parse(path)
    h, w = pages[0].shape
    dt = pages[0].dtype
    out = np.empty((len(pages), h, w), dt.newbyteorder(bo))
    flat = out.reshape(len(pages), -1).view(np.uint8)
    with open(path, "rb") as f:
        for z, page in enumerate(pages):
            pos, need = 0, flat.shape[1]
            for off, nbytes in page.strips:
                take = min(nbytes, need - pos)
                if take <= 0:
                    break
                f.seek(off)
                if f.readinto(memoryview(flat[z, pos:pos + take])) != take:
                    raise TiffFormatError(f"{path}: strip at {off} runs past the end")
                pos += take
    out = out.astype(dt, copy=False)
    return out[0] if len(pages) == 1 else out


def imwrite(path: str, arr: np.ndarray) -> None:
    """Save a 2D image or a (z, y, x) stack as (multi-page) TIFF, or as
    ``.npy`` by its suffix.  uint8, uint16 and float32 are written as they
    are; float64 as float32 (as the JAX package's PIL fallback writes it)."""
    arr = np.asarray(arr)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".npy"):
        np.save(path, arr)
        return
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    if arr.ndim not in (2, 3):
        raise ValueError(f"{path}: a 2D image or a 3D stack, got shape {arr.shape}")
    a3 = arr[None] if arr.ndim == 2 else arr
    with StreamingTiffWriter(path, a3.shape, a3.dtype) as w:
        w.write_rows(a3)


class StreamingTiffWriter:
    """Incremental multi-page TIFF writer, a copy of the JAX package's: the
    layout of ``imwrite`` (all offsets a function of the declared shape),
    with the pages given in ordered chunks, so the tile pipeline can encode
    the output volume as its rows arrive.  The file must fit classic TIFF
    (< 4 GB): callers check ``StreamingTiffWriter.fits(shape, dtype)``."""

    _IFD_ENTRIES = 10
    _IFD_SIZE = 2 + _IFD_ENTRIES * 12 + 4

    def __init__(self, path: str, shape, dtype):
        z, h, w = (int(s) for s in shape)
        dtype = np.dtype(dtype)
        if dtype not in (np.uint8, np.uint16, np.float32):
            raise ValueError(f"unsupported dtype {dtype}")
        if not self.fits(shape, dtype):
            raise ValueError("volume exceeds the classic-TIFF 4 GB limit")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.shape, self.dtype, self.path = (z, h, w), dtype, path
        self._page_bytes = h * w * dtype.itemsize
        self._z_written = 0
        self._f = open(path, "wb")
        first_ifd = 8 + self._page_bytes  # header | page0 | ifd0
        self._f.write(np.array([0x4949, 42], "<u2").tobytes()
                      + np.array([first_ifd], "<u4").tobytes())

    @classmethod
    def fits(cls, shape, dtype) -> bool:
        z, h, w = (int(s) for s in shape)
        total = 8 + z * (h * w * np.dtype(dtype).itemsize + cls._IFD_SIZE)
        return total < 0xFFFFFFF0

    def _ifd(self, i: int) -> bytes:
        z, h, w = self.shape
        bits = self.dtype.itemsize * 8
        data_off = 8 + i * (self._page_bytes + self._IFD_SIZE)
        next_off = (data_off + 2 * self._page_bytes + self._IFD_SIZE
                    if i + 1 < z else 0)
        sample_fmt = 3 if self.dtype == np.float32 else 1
        # (tag, type, count, value) rows, in the tag order of tiff_write
        rows = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 1, bits),
                (259, 3, 1, 1), (262, 3, 1, 1), (273, 4, 1, data_off),
                (277, 3, 1, 1), (278, 4, 1, h),
                (279, 4, 1, self._page_bytes), (339, 3, 1, sample_fmt)]
        out = [np.array([self._IFD_ENTRIES], "<u2").tobytes()]
        for tag, typ, count, value in rows:
            out.append(np.array([tag, typ], "<u2").tobytes()
                       + np.array([count, value], "<u4").tobytes())
        out.append(np.array([next_off], "<u4").tobytes())
        return b"".join(out)

    def write_rows(self, rows: np.ndarray) -> None:
        """Append one or more complete pages (rows.shape = (n, H, W))."""
        rows = np.ascontiguousarray(rows, self.dtype)
        if rows.ndim == 2:
            rows = rows[None]
        z, h, w = self.shape
        if rows.shape[1:] != (h, w):
            raise ValueError(f"page shape {rows.shape[1:]} != {(h, w)}")
        if self._z_written + rows.shape[0] > z:
            raise ValueError("more pages than declared")
        for page in rows:
            self._f.write(page.astype(self.dtype.newbyteorder("<"), copy=False).tobytes())
            self._f.write(self._ifd(self._z_written))
            self._z_written += 1

    def close(self) -> None:
        if self._f is not None:
            f, self._f = self._f, None
            f.close()
            if self._z_written != self.shape[0]:
                os.unlink(self.path)  # never leave a truncated stack behind
                raise ValueError(f"wrote {self._z_written} of {self.shape[0]} pages")

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None and self._f is not None:
            self._f.close()
            self._f = None
            if os.path.exists(self.path):
                os.unlink(self.path)
            return False
        self.close()
        return False
