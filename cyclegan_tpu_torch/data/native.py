"""ctypes binding of the native (C++) preprocessing library
(``cyclegan_tpu_torch/native/cgdata.cpp``): the port's copy of the JAX
package's ``data/native.py``.

At first use ``g++`` builds the source into ``cyclegan_tpu_torch/_build/``
(git-ignored), under a name hashed from the source, the flags and the
host's CPU (``-march=native`` builds for it), written to a temporary name
and moved into place with ``os.replace``, as ``ops/cuda/build.py`` builds
the kernels. Where no compiler is found or the build fails,
``available()`` is False and the pipeline takes the numpy
path (``data/augment.py``), which runs the same algorithm.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(PACKAGE_DIR, "native", "cgdata.cpp")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")
GXX_TIMEOUT_S = 120
# The C ABI revision this binding needs (cgdata.cpp cg_version).
ABI_VERSION = 2

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _host_cpu() -> str:
    """The CPU's model and feature flags, which ``-march=native`` builds
    for: a tree copied to another machine builds its own library."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [line for line in f
                     if line.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines)))
    except OSError:
        return platform.machine() + platform.processor()


def library_path() -> str:
    digest = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(GXX_FLAGS).encode())
    digest.update(_host_cpu().encode())
    return os.path.join(BUILD_DIR, f"libcgdata_{digest.hexdigest()[:16]}.so")


def build() -> Optional[str]:
    """Compile the source unless its library exists; its path, or None
    where there is no ``g++`` or it fails."""
    target = library_path()
    if os.path.exists(target):
        return target
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.tmp{os.getpid()}"
    try:
        proc = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True,
                              timeout=GXX_TIMEOUT_S)
        if proc.returncode != 0 or not os.path.exists(tmp):
            return None
        os.replace(tmp, target)
        return target
    except (OSError, subprocess.TimeoutExpired):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _bind(path: str) -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(path)
        lib.cg_version.restype = ctypes.c_int
        if int(lib.cg_version()) != ABI_VERSION:
            return None
    except (OSError, AttributeError):
        return None
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    one = [u8p] + [ctypes.c_int] * 8
    batch = [u8p] + [ctypes.c_int] * 5 + [i32p] * 3 + [ctypes.c_int]
    lib.cg_preprocess.argtypes = one + [f32p]
    lib.cg_preprocess_u8.argtypes = one + [u8p]
    lib.cg_preprocess_batch.argtypes = batch + [f32p, ctypes.c_int]
    lib.cg_preprocess_batch_u8.argtypes = batch + [u8p, ctypes.c_int]
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The library, built at the first call; None where it does not
    build."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            path = build()
            _lib = _bind(path) if path else None
        return _lib


def available() -> bool:
    return load() is not None


def preprocess_one(img: np.ndarray, resize: int, flip: bool, oy: int,
                   ox: int, crop: int, normalize: bool = True) -> np.ndarray:
    """Fused flip -> resize -> crop of one uint8 [H, W, 3] image: float32
    in [-1, 1], or uint8 with ``normalize=False``."""
    lib = load()
    if lib is None:
        raise RuntimeError("the native preprocessing library is unavailable")
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((crop, crop, 3), np.float32 if normalize else np.uint8)
    fn = lib.cg_preprocess if normalize else lib.cg_preprocess_u8
    fn(img, img.shape[0], img.shape[1], resize, resize, int(flip), int(oy),
       int(ox), crop, out)
    return out


def preprocess_batch(imgs: np.ndarray, resize: int, flips: np.ndarray,
                     oys: np.ndarray, oxs: np.ndarray, crop: int,
                     n_threads: int = 0, normalize: bool = True) -> np.ndarray:
    """``preprocess_one`` over a same-sized uint8 batch [N, H, W, 3] on a
    thread pool (``n_threads`` 0: one per core)."""
    lib = load()
    if lib is None:
        raise RuntimeError("the native preprocessing library is unavailable")
    imgs = np.ascontiguousarray(imgs, np.uint8)
    n, h, w, _ = imgs.shape
    out = np.empty((n, crop, crop, 3), np.float32 if normalize else np.uint8)
    fn = lib.cg_preprocess_batch if normalize else lib.cg_preprocess_batch_u8
    fn(imgs, n, h, w, resize, resize, np.ascontiguousarray(flips, np.int32),
       np.ascontiguousarray(oys, np.int32), np.ascontiguousarray(oxs, np.int32),
       crop, out, n_threads)
    return out
