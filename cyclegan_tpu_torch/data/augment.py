"""Test-time image preprocessing: the port's own copy of the JAX
package's ``data/augment.py`` ``preprocess_test`` (bilinear resize with
TF2's half-pixel centres, then [-1, 1] normalisation)."""

from __future__ import annotations

import numpy as np


def normalize_image(img: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [-1, 1]."""
    return img.astype(np.float32) / 127.5 - 1.0


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize with half-pixel centres (tf.image.resize's default).
    img: [H, W, C] -> [out_h, out_w, C] float32."""
    img = np.asarray(img, np.float32)
    in_h, in_w = img.shape[:2]
    if (in_h, in_w) == (out_h, out_w):
        return img

    def coords(out_n, in_n):
        c = (np.arange(out_n, dtype=np.float32) + 0.5) * (in_n / out_n) - 0.5
        lo = np.floor(c)
        frac = c - lo
        i0 = np.clip(lo, 0, in_n - 1).astype(np.int64)
        i1 = np.clip(lo + 1, 0, in_n - 1).astype(np.int64)
        return i0, i1, frac.astype(np.float32)

    y0, y1, fy = coords(out_h, in_h)
    x0, x1, fx = coords(out_w, in_w)
    top = img[y0][:, x0] * (1 - fx)[None, :, None] + img[y0][:, x1] * fx[None, :, None]
    bot = img[y1][:, x0] * (1 - fx)[None, :, None] + img[y1][:, x1] * fx[None, :, None]
    return top * (1 - fy)[:, None, None] + bot * fy[:, None, None]


def preprocess_test(img: np.ndarray, crop_size: int = 256) -> np.ndarray:
    """Resize to crop_size x crop_size, then normalise to [-1, 1]."""
    return normalize_image(resize_bilinear(img.astype(np.float32),
                                           crop_size, crop_size))
