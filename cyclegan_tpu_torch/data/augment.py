"""Image preprocessing: the port's own copy of the JAX package's
``data/augment.py``, with the reference's semantics.

  train: random horizontal flip -> bilinear resize to 286 -> random crop
         256 -> [-1, 1]
  test:  bilinear resize to 256 -> [-1, 1]

Bilinear resize uses TF2's half-pixel centres. The random decisions of one
training image (flip, crop offsets) come from one numpy stream per
(seed, split, epoch, index), drawn here for both the numpy and the native
(C++, ``data/native.py``) path, so the two take the same decisions.
"""

from __future__ import annotations

import numpy as np


def normalize_image(img: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [-1, 1]."""
    return img.astype(np.float32) / 127.5 - 1.0


def quantize_uint8(img: np.ndarray) -> np.ndarray:
    """float32 [0, 255] -> uint8, rounding half to even (as the native
    path's ``std::nearbyint``): the caches' format."""
    return np.rint(np.clip(img, 0, 255)).astype(np.uint8)


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


def draw_augment_params(rng: np.random.Generator, resize_size: int,
                        crop_size: int):
    """One training image's decisions (flip, oy, ox), in the order both
    paths draw them."""
    flip = rng.random() < 0.5
    max_off = resize_size - crop_size
    oy = int(rng.integers(0, max_off + 1))
    ox = int(rng.integers(0, max_off + 1))
    return flip, oy, ox


def preprocess_train(img: np.ndarray, rng: np.random.Generator,
                     resize_size: int = 286, crop_size: int = 256,
                     use_native: bool | None = None, normalize: bool = True,
                     allow_flip: bool = True) -> np.ndarray:
    """Random flip -> resize -> random crop -> normalise, through the native
    library where it builds (``use_native=None``), else numpy.
    ``normalize=False`` returns the uint8 cache format. ``allow_flip=False``
    drops the mirror after the decisions are drawn, so the crop offsets do
    not depend on it."""
    flip, oy, ox = draw_augment_params(rng, resize_size, crop_size)
    flip = flip and allow_flip
    if use_native is None or use_native:
        from cyclegan_tpu_torch.data import native

        if native.available():
            return native.preprocess_one(img, resize_size, flip, oy, ox,
                                         crop_size, normalize=normalize)
        if use_native:
            raise RuntimeError("native preprocessing requested but the "
                               "library does not build here")
    if flip:
        img = img[:, ::-1]
    img = resize_bilinear(img.astype(np.float32), resize_size, resize_size)
    img = img[oy:oy + crop_size, ox:ox + crop_size]
    return normalize_image(img) if normalize else quantize_uint8(img)


def preprocess_test(img: np.ndarray, crop_size: int = 256,
                    normalize: bool = True) -> np.ndarray:
    """Resize to crop_size x crop_size, then normalise to [-1, 1];
    ``normalize=False`` returns the uint8 cache format."""
    img = resize_bilinear(img.astype(np.float32), crop_size, crop_size)
    return normalize_image(img) if normalize else quantize_uint8(img)
