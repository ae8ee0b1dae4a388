"""An 8-bit grayscale PNG writer on ``zlib`` and ``struct`` alone (the machine
with the card has no PIL): signature, IHDR, one IDAT of the rows each with
filter byte 0 (None), IEND (PNG specification, ISO/IEC 15948)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_gray8(img: np.ndarray) -> bytes:
    """A 2D uint8 array (height, width) as PNG bytes."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint8 or 0 in img.shape:
        raise ValueError(f"an 8-bit grayscale PNG takes a non-empty 2D uint8 array, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape
    rows = np.zeros((h, w + 1), np.uint8)  # column 0: each row's filter byte, 0
    rows[:, 1:] = img
    # width, height, bit depth 8, colour type 0 (grayscale), compression,
    # filter and interlace methods 0
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_gray8(path: str, img: np.ndarray) -> None:
    data = encode_gray8(img)
    with open(path, "wb") as f:
        f.write(data)


def read_header(path: str) -> tuple:
    """(width, height, bit depth, colour type) from a PNG's IHDR; raises
    ValueError when the signature or the IHDR is not a PNG's."""
    with open(path, "rb") as f:
        head = f.read(33)
    if len(head) < 33 or head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG (signature or IHDR missing)")
    (length,) = struct.unpack(">I", head[8:12])
    crc = struct.unpack(">I", head[29:33])[0]
    if length != 13 or zlib.crc32(head[12:29]) & 0xFFFFFFFF != crc:
        raise ValueError(f"{path}: IHDR of length {length} or with a bad CRC")
    w, h, depth, colour = struct.unpack(">IIBB", head[16:26])
    return w, h, depth, colour
