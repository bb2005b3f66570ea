"""Run manifest: the event that makes a telemetry stream self-describing.
The port's form of the JAX package's ``obs/manifest.py``.

Written once at startup, before any step event, so a JSONL file carries
everything needed to interpret (and reproduce) the run it describes:
full config tree, the device, software versions, git SHA, host topology,
and the argv that launched it. The fields are the JAX manifest's, with
CUDA's counterparts: ``versions`` names torch, its CUDA version, python
and numpy; ``mesh.platform`` is "gpu" or "cpu" and ``mesh.device_kind``
the card's name; ``host`` is process 0 of 1. With
``query_devices=False`` nothing touches CUDA (translate and the server
write their manifest before the engine exists).
"""

from __future__ import annotations

import dataclasses
import os
import platform as _platform
import subprocess
import sys
import time
from typing import Optional

from cyclegan_tpu_torch.obs.jsonl import EVENT_SCHEMA_VERSION


def git_sha(cwd: Optional[str] = None) -> Optional[str]:
    """Best-effort repo SHA (None outside a git checkout)."""
    if cwd is None:
        cwd = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=cwd, capture_output=True, text=True, timeout=10,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def _versions() -> dict:
    v = {"python": sys.version.split()[0]}
    try:
        import torch

        v["torch"] = torch.__version__
        v["cuda"] = torch.version.cuda
    except Exception:
        pass
    try:
        import numpy

        v["numpy"] = numpy.__version__
    except Exception:
        pass
    return v


def build_manifest(config=None, plan=None, query_devices: bool = True,
                   device=None, **extra) -> dict:
    """Assemble the manifest payload (the caller logs it as an event).

    `config` is the frozen Config dataclass (serialized whole); `plan` an
    object with ``n_devices`` (the port runs one device: None). With
    `query_devices` the mesh names ``device`` (a torch.device; by default
    the card where there is one, else the CPU); with
    `query_devices=False` nothing touches CUDA.
    """
    mani: dict = {
        "schema_version": EVENT_SCHEMA_VERSION,
        "unix_time": round(time.time(), 3),
        "argv": list(sys.argv),
        "hostname": _platform.node(),
        "pid": os.getpid(),
        "versions": _versions(),
        "git_sha": git_sha(),
    }
    if config is not None:
        mani["config"] = dataclasses.asdict(config)
    if extra:
        mani.update(extra)

    mesh: dict = {}
    if plan is not None:
        mesh["n_devices"] = plan.n_devices
    if query_devices:
        import torch

        if device is None:
            device = torch.device("cuda" if torch.cuda.is_available()
                                  else "cpu")
        device = torch.device(device)
        on_card = device.type == "cuda"
        # One device: no data or spatial split.
        mesh.setdefault("n_devices", 1)
        mesh.setdefault("n_data", 1)
        mesh.setdefault("n_spatial", 1)
        mesh["platform"] = "gpu" if on_card else "cpu"
        mesh["device_kind"] = (torch.cuda.get_device_name(device)
                               if on_card else "cpu")
        mani["host"] = {
            "process_index": 0,
            "process_count": 1,
            "local_device_count": (torch.cuda.device_count() if on_card
                                   else 1),
        }
    if mesh:
        mani["mesh"] = mesh
    return mani
