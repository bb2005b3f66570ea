"""Dataset sources: the port's own copy of the JAX package's
``data/sources.py``. A source yields the four splits trainA, trainB,
testA and testB as uint8 RGB images:

- ``FolderSource``: a directory with trainA/ trainB/ testA/ testB/ image
  folders (the CycleGAN dataset layout). ``.npy`` files are read with
  numpy; raster formats need PIL.
- ``SyntheticSource``: index-seeded numpy blobs (an 8x8 grid of random
  colours, upscaled, plus Gaussian noise), so that every run, and the JAX
  package's ``main.py --data_source synthetic``, sees the same images
  without files.

TFDS needs a download and is not ported.
"""

from __future__ import annotations

import os
import zlib
from typing import Protocol

import numpy as np

SPLITS = ("trainA", "trainB", "testA", "testB")


def split_tag(split: str) -> int:
    """Stable cross-process tag for a split name (crc32, not Python's
    salted ``hash``)."""
    return zlib.crc32(split.encode()) & 0xFFFF


class Source(Protocol):
    name: str

    def split_size(self, split: str) -> int: ...

    def load(self, split: str, index: int) -> np.ndarray:
        """One uint8 RGB image [H, W, 3]."""
        ...


class SyntheticSource:
    """Deterministic synthetic uint8 RGB images, index-seeded."""

    def __init__(self, train_size: int = 64, test_size: int = 16,
                 image_size: int = 256):
        self.name = "synthetic"
        self._sizes = {"trainA": train_size, "trainB": train_size,
                       "testA": test_size, "testB": test_size}
        self._hw = image_size

    def split_size(self, split: str) -> int:
        return self._sizes[split]

    def load(self, split: str, index: int) -> np.ndarray:
        """One uint8 [H, W, 3] image."""
        seed = split_tag(split) * 100003 + index
        rng = np.random.RandomState(seed % (2**31))
        hw = self._hw
        low = rng.randint(0, 256, size=(8, 8, 3), dtype=np.uint8).astype(np.float32)
        reps = (hw + 7) // 8
        img = np.kron(low, np.ones((reps, reps, 1), np.float32))[:hw, :hw]
        img += rng.randn(hw, hw, 3) * 8.0
        return np.clip(img, 0, 255).astype(np.uint8)


def load_image_file(path: str) -> np.ndarray:
    """One image file as uint8 RGB [H, W, 3]: ``.npy`` with numpy, raster
    formats with PIL, which only they need."""
    if path.lower().endswith(".npy"):
        arr = np.load(path, allow_pickle=False)
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(
                f"{path}: reading raster images needs PIL, which is not "
                "installed; give the images as .npy files (uint8 HWC)") from e
        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGB"))
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    return arr


class FolderSource:
    """trainA/trainB/testA/testB folders of images under ``root``."""

    EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".npy")

    def __init__(self, root: str):
        self.name = f"folder:{root}"
        self.root = root
        self._files = {}
        for split in SPLITS:
            d = os.path.join(root, split)
            if not os.path.isdir(d):
                raise FileNotFoundError(f"missing split directory: {d}")
            files = sorted(os.path.join(d, f) for f in os.listdir(d)
                           if f.lower().endswith(self.EXTS))
            if not files:
                raise FileNotFoundError(f"no images in {d}")
            self._files[split] = files

    def split_size(self, split: str) -> int:
        return len(self._files[split])

    def load(self, split: str, index: int) -> np.ndarray:
        return load_image_file(self._files[split][index])


def resolve_source(data_config) -> Source:
    """The source a ``DataConfig`` names: synthetic, a folder (also
    ``auto`` with a ``data_dir``), or, for ``auto`` without one, synthetic,
    as the JAX package falls back where TFDS is not installed."""
    c = data_config

    def synthetic():
        return SyntheticSource(c.synthetic_train_size, c.synthetic_test_size,
                               image_size=c.crop_size)

    if c.source == "synthetic":
        return synthetic()
    if c.source == "folder" or (c.source == "auto" and c.data_dir):
        if not c.data_dir:
            raise ValueError(f"domain {c.domain!r}: source 'folder' needs a "
                             "data_dir (--data_dir)")
        return FolderSource(c.data_dir)
    if c.source == "tfds":
        raise ValueError(
            "data source 'tfds' is not ported yet: it needs a download; "
            "use --data_source folder with --data_dir, or synthetic")
    print(f"data source 'auto' without a data_dir: using synthetic images "
          f"({c.synthetic_train_size} train / {c.synthetic_test_size} test "
          "per domain); TFDS is not ported")
    return synthetic()
