"""The port's numpy TIFF codec (neuroclear_tpu_torch/utils/tiffio.py) against
the JAX package's ``utils/tiffio.py`` (native codec, PIL fallback), on the
CPU: byte-equal files, files read across the packages, big-endian and
multi-strip files, and the refusal of what the codec does not read."""

import numpy as np
import pytest
from PIL import Image

from neuroclear_tpu.utils import tiffio as jax_tiffio
from neuroclear_tpu_torch.utils import tiffio

CASES = [(dt, shape) for dt in (np.uint8, np.uint16, np.float32)
         for shape in ((7, 9), (4, 6, 5))]


def _array(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return rng.normal(size=shape).astype(np.float32)
    return rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)


@pytest.mark.parametrize("dtype, shape", CASES)
def test_imwrite_byte_equal_to_jax_and_read_across(tmp_path, dtype, shape):
    assert jax_tiffio._native() is not None, "the native codec is not built"
    a = _array(dtype, shape)
    port, native, stream = (str(tmp_path / f"{n}.tif") for n in ("port", "native", "stream"))
    tiffio.imwrite(port, a)
    jax_tiffio.imwrite(native, a)
    a3 = a[None] if a.ndim == 2 else a
    with jax_tiffio.StreamingTiffWriter(stream, a3.shape, a3.dtype) as w:
        w.write_rows(a3)
    data = open(port, "rb").read()
    assert data == open(native, "rb").read() == open(stream, "rb").read()
    for got in (jax_tiffio.imread(port), tiffio.imread(native)):
        assert got.dtype == a.dtype and np.array_equal(got, a)
    assert tiffio.probe(port) == ((1,) + a.shape if a.ndim == 2 else a.shape, np.dtype(dtype))


def test_streaming_writer_in_chunks_equals_imwrite(tmp_path):
    a = _array(np.uint16, (6, 5, 7), 1)
    tiffio.imwrite(str(tmp_path / "whole.tif"), a)
    assert tiffio.StreamingTiffWriter.fits(a.shape, a.dtype)
    with tiffio.StreamingTiffWriter(str(tmp_path / "chunks.tif"), a.shape, a.dtype) as w:
        for z0 in (0, 2, 5):
            w.write_rows(a[z0:z0 + {0: 2, 2: 3, 5: 1}[z0]])
    assert (tmp_path / "whole.tif").read_bytes() == (tmp_path / "chunks.tif").read_bytes()
    w = tiffio.StreamingTiffWriter(str(tmp_path / "short.tif"), a.shape, a.dtype)
    w.write_rows(a[:2])
    with pytest.raises(ValueError):
        w.close()  # a truncated stack is removed
    assert not (tmp_path / "short.tif").exists()


def test_reads_files_pil_wrote(tmp_path):
    """The JAX package's PIL fallback (float64 stacks as float32 pages) and a
    PIL-written 16-bit page: other strip layouts and extra tags."""
    a = _array(np.float32, (3, 10, 12), 2)
    jax_tiffio.imwrite(str(tmp_path / "f64.tif"), a.astype(np.float64))
    assert np.array_equal(tiffio.imread(str(tmp_path / "f64.tif")), a)
    b = _array(np.uint16, (40, 33), 3)
    Image.fromarray(b, mode="I;16").save(str(tmp_path / "pil16.tif"))
    got = tiffio.imread(str(tmp_path / "pil16.tif"))
    assert got.dtype == np.uint16 and np.array_equal(got, b)


def _big_endian_tiff(path, a, rows_per_strip):
    """A big-endian multi-page stack with several strips per page, SHORT
    dimension tags and the strip tables stored out of line."""
    z, h, w = a.shape
    strips = -(-h // rows_per_strip)
    page = a.dtype.itemsize * h * w
    body = bytearray(b"MM" + np.array([42], ">u2").tobytes() + np.array([8], ">u4").tobytes())
    fmt = 3 if a.dtype == np.float32 else 1
    for i in range(z):
        n_tags = 9
        ifd_at = len(body)
        tables = ifd_at + 2 + 12 * n_tags + 4
        data_at = tables + 8 * strips
        offsets = [data_at + s * rows_per_strip * w * a.dtype.itemsize for s in range(strips)]
        counts = [min(rows_per_strip, h - s * rows_per_strip) * w * a.dtype.itemsize
                  for s in range(strips)]
        nxt = data_at + page if i + 1 < z else 0
        tags = [(256, 3, 1, w), (257, 3, 1, h), (258, 3, 1, 8 * a.dtype.itemsize),
                (259, 3, 1, 1), (262, 3, 1, 1), (273, 4, strips, tables),
                (278, 3, 1, rows_per_strip), (279, 4, strips, tables + 4 * strips),
                (339, 3, 1, fmt)]
        body += np.array([n_tags], ">u2").tobytes()
        for tag, typ, count, value in tags:
            body += np.array([tag, typ], ">u2").tobytes() + np.array([count], ">u4").tobytes()
            body += (np.array([value, 0], ">u2").tobytes() if typ == 3 and count == 1
                     else np.array([value], ">u4").tobytes())
        body += np.array([nxt], ">u4").tobytes()
        body += np.array(offsets, ">u4").tobytes() + np.array(counts, ">u4").tobytes()
        body += a[i].astype(a.dtype.newbyteorder(">")).tobytes()
    with open(path, "wb") as f:
        f.write(bytes(body))


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_reads_big_endian_multi_strip_stack(tmp_path, dtype):
    a = _array(dtype, (3, 11, 6), 4)
    path = str(tmp_path / "mm.tif")
    _big_endian_tiff(path, a, rows_per_strip=4)
    got = tiffio.imread(path)
    assert got.dtype == a.dtype and np.array_equal(got, a)
    assert tiffio.probe(path) == (a.shape, np.dtype(dtype))


def test_refuses_compressed_and_exotic_files(tmp_path):
    a = _array(np.uint16, (2, 5, 6), 5)
    path = tmp_path / "c.tif"
    tiffio.imwrite(str(path), a)
    data = bytearray(path.read_bytes())
    # the first IFD's Compression entry (tag 259, 4th of ten) -> 5 (LZW)
    ifd = int(np.frombuffer(bytes(data[4:8]), "<u4")[0])
    entry = ifd + 2 + 3 * 12
    assert int(np.frombuffer(bytes(data[entry:entry + 2]), "<u2")[0]) == 259
    data[entry + 8:entry + 10] = np.array([5], "<u2").tobytes()
    path.write_bytes(bytes(data))
    with pytest.raises(tiffio.TiffFormatError, match=r"c\.tif.*259"):
        tiffio.imread(str(path))
    rgb = tmp_path / "rgb.tif"
    Image.fromarray(_array(np.uint8, (4, 5, 3), 6), mode="RGB").save(str(rgb))
    with pytest.raises(tiffio.TiffFormatError, match=r"rgb\.tif.*(277|258)"):
        tiffio.imread(str(rgb))
    with pytest.raises(ValueError):
        tiffio.imwrite(str(tmp_path / "x.tif"), np.zeros((2, 2, 2, 2), np.uint8))


def test_npy_round_trip(tmp_path):
    a = _array(np.uint16, (3, 4, 5), 7)
    tiffio.imwrite(str(tmp_path / "v.npy"), a)
    assert np.array_equal(tiffio.imread(str(tmp_path / "v.npy")), a)
    assert tiffio.probe(str(tmp_path / "v.npy")) == (a.shape, a.dtype)
