"""Build the port's CUDA sources into one shared library and bind it.

The sources in ``cyclegan_tpu_torch/csrc/`` include no PyTorch header.
One ``nvcc`` call compiles them for ``sm_90a`` into a shared library with a
plain C interface, which ``ctypes`` loads; tensors pass as ``data_ptr()``
integers and the stream as ``torch.cuda.current_stream().cuda_stream``.

The library lands in ``cyclegan_tpu_torch/_build/`` (git-ignored), named
by a hash of the sources and flags, so a changed source builds anew and
an unchanged one loads at once. It is written under a temporary name and
moved into place with ``os.replace``: there is no lock file, so a killed
build never makes a later one wait. Nothing builds when the package is
imported; the first wrapper call on a CUDA tensor builds and loads.
``-Xptxas -v`` makes ptxas report each kernel's registers, shared memory,
stack frame and spills; the report is kept beside the library
(``ptxas_report``), so a library that is already built still has it.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import re
import shutil
import subprocess

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 300

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every entry point: pointers and the stream as void*.
SIGNATURES = {
    # x, scale, bias, y, mean, inv, partials, counters, n, hw, c, eps, then
    # the plan (ForwardPlan.launch_args: vec, tile, group, band, slabs,
    # waves, smem_bytes), stream
    "cg_instance_norm_forward": [_P] * 8 + [_I] * 3 + [_F] + [_I] * 7 + [_P],
    # x, scale, bias, y, mean, inv, partials, counters, n, h, w, c, pad,
    # slope, eps, the plan, stream
    "cg_epilogue_forward": [_P] * 8 + [_I] * 5 + [_F, _F] + [_I] * 7 + [_P],
    # x, kernel, scale, bias, conv_out, y, part_mean, part_m2, tickets,
    # mean, inv, n, h, w, cin, cout, pad, eps, vec, then the plan
    # (UpsamplePlan.launch_args: patch rows, patch cols, tile, depth,
    # stages, smem_bytes), stream
    "cg_upsample_forward": [_P] * 11 + [_I] * 6 + [_F] + [_I] * 7 + [_P],
    # x, kernel_q, kernel_scale, then as cg_upsample_forward from scale
    "cg_upsample_int8_forward": [_P] * 12 + [_I] * 6 + [_F] + [_I] * 7 + [_P],
    # x, scale, mean, inv, g, dx, dscale_nc, dbias_nc, n, hw, c, then the
    # plan (BackwardPlan.launch_args: vec, tile, cluster, band, smem_bytes,
    # keep), stream
    "cg_instance_norm_backward": [_P] * 8 + [_I] * 3 + [_I] * 6 + [_P],
    # x, scale, bias, mean, inv, g, dx, dscale_nc, dbias_nc, n, h, w, c,
    # pad, slope, the plan, stream
    "cg_epilogue_backward": [_P] * 9 + [_I] * 5 + [_F] + [_I] * 6 + [_P],
    # fold, mask, vec, cluster, smem_bytes -> clusters the card holds at once
    "cg_norm_backward_active_clusters": [_I] * 5,
    "cg_error_string": [_I],
}


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    found = candidate if os.path.exists(candidate) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {candidate} and on PATH): the CUDA "
            "kernels build only where the CUDA toolkit is installed")
    return found


def library_path() -> str:
    """Path of the library for the current sources and flags."""
    digest = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libcyclegan_kernels_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources unless the library for them exists; return its
    path. Raises with nvcc's output when it fails or runs out of time."""
    target = library_path()
    if os.path.exists(target):
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.tmp{os.getpid()}"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *sources()]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=NVCC_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc ran past {NVCC_TIMEOUT_S} s: {' '.join(cmd)}\n"
            f"{e.stderr or ''}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    with open(f"{target}.ptxas.txt", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, target)
    return target


def ptxas_report(path: str | None = None) -> dict[str, dict]:
    """Per kernel (its mangled name), what ``-Xptxas -v`` reported when the
    library at ``path`` (the current one by default) was built: registers,
    static shared memory bytes, stack frame bytes and spill stores and
    loads in bytes."""
    with open(f"{path or library_path()}.ptxas.txt") as f:
        text = f.read()
    report, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            report.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            report[name].update(stack_bytes=int(m.group(1)),
                                spill_store_bytes=int(m.group(2)),
                                spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[name]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            report[name]["smem_bytes"] = int(smem.group(1)) if smem else 0
    return report


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built library with ``argtypes``/``restype`` set on every entry
    point; builds it on first use."""
    lib = ctypes.CDLL(build())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cg_error_string.restype = ctypes.c_char_p
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        reason = library().cg_error_string(status).decode()
        raise RuntimeError(f"{name} failed: CUDA error {status} ({reason})")
