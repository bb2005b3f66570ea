"""PNG encoding with ``zlib`` and ``struct`` alone, so that nothing the
port writes (server replies, ``translate`` outputs, TensorBoard image
summaries) needs an imaging library: 8-bit RGB, no interlace, every row
with filter 0, one zlib stream."""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """uint8 [H, W, 3] -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected a uint8 [H, W, 3] image, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, 3 * w)], axis=1)
    return (PNG_SIGNATURE
            + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + png_chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + png_chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 [H, W, 3] image to ``path`` as a PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(img))
