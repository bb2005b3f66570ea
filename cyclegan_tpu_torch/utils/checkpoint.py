"""Verified checkpoint ring with auto-resume: the port's copy of the JAX
package's ``utils/checkpoint.py``, writing torch files in place of Orbax.

A slot is a directory of ``torch.save`` files: the four networks'
parameters keyed by their flax names in the flax layout (``convert.py``),
so ``g.pt`` and ``f.pt`` read back as the flat flax dicts that
``translate --weights`` takes; the four Adams' ``state_dict``s; and the
step. It is written into a temporary directory and renamed into place,
so a slot is never seen half-written.

- ``keep=1`` keeps one overwritten slot named ``checkpoint``; ``keep=K>1``
  names slots ``checkpoint-e<epoch:05d>`` and prunes to the K newest
  after each commit.
- After the commit a manifest ``<slot>.manifest.json`` records each
  file's sha256 and bytes, and the sha256 of the state's tensors
  themselves (``state_digest``), so a reload can be held bitwise against
  what was saved.
- ``restore`` walks the slots newest first and takes the newest that
  passes ``verify`` (the files re-hashed against the manifest); it names
  the corrupt slots it skipped and the one it fell back to, and raises
  when every slot is corrupt. A slot without a manifest (a crash between
  the rename and the manifest) is complete and accepted as unverified.
- ``meta.json`` beside the slots holds the newest save's epoch and the
  architecture (``Config.model_meta``).

Not ported: Orbax slots, retries of I/O, and partial restore.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import List, Optional, Tuple

import numpy as np
import torch

from cyclegan_tpu_torch.convert import (
    NETWORKS,
    discriminator_state_from_flax,
    flax_from_state_dict,
    generator_state_from_flax,
)
from cyclegan_tpu_torch.train.state import CycleGANState

_RING_RE = re.compile(r"^checkpoint-e(\d+)$")
_LEGACY = "checkpoint"


def _cpu(obj):
    """``obj`` with every tensor copied to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def slot_contents(state: CycleGANState) -> dict:
    """file stem -> what ``torch.save`` writes there, all on the CPU."""
    out = {"step": {"step": int(state.step)}}
    for name, net, opt in zip(NETWORKS, state.networks, state.optimizers):
        out[name] = {k: torch.from_numpy(v)
                     for k, v in flax_from_state_dict(net.state_dict()).items()}
        out[f"{name}_opt"] = _cpu(opt.state_dict())
    return out


def _digest_update(h, obj) -> None:
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    elif isinstance(obj, dict):
        for k in sorted(obj, key=str):
            h.update(str(k).encode())
            _digest_update(h, obj[k])
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _digest_update(h, v)
    else:
        h.update(repr(obj).encode())


def state_digest(state: CycleGANState) -> str:
    """sha256 over every tensor and value a slot holds for ``state``: equal
    for two states exactly when their weights, Adam moments and counts and
    step are bitwise equal."""
    h = hashlib.sha256()
    _digest_update(h, slot_contents(state))
    return h.hexdigest()


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class Checkpointer:
    def __init__(self, output_dir: str, keep: int = 1):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.dir = os.path.abspath(os.path.join(output_dir, "checkpoints"))
        os.makedirs(self.dir, exist_ok=True)
        self.keep = int(keep)
        self.meta_path = os.path.join(self.dir, "meta.json")
        self._last_slot: Optional[str] = None

    # -- slot bookkeeping --------------------------------------------------

    def _slot_path(self, epoch: int) -> str:
        if self.keep == 1:
            return os.path.join(self.dir, _LEGACY)
        return os.path.join(self.dir, f"checkpoint-e{int(epoch):05d}")

    @staticmethod
    def _manifest_path(slot: str) -> str:
        return slot + ".manifest.json"

    def _slot_epoch(self, name: str) -> int:
        m = _RING_RE.match(name)
        if m is not None:
            return int(m.group(1))
        manifest = self.read_manifest(os.path.join(self.dir, name))
        if manifest is not None and "epoch" in manifest:
            return int(manifest["epoch"])
        return int(self.read_meta().get("epoch", -1))

    def slots(self) -> List[Tuple[int, str]]:
        """Complete slots, newest first, as (epoch, path). Temporary
        directories of saves that did not finish are never slots."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        out = [(self._slot_epoch(name), os.path.join(self.dir, name))
               for name in names
               if (name == _LEGACY or _RING_RE.match(name))
               and os.path.isdir(os.path.join(self.dir, name))]
        out.sort(reverse=True)
        return out

    @property
    def slot(self) -> str:
        """The newest slot's path (the save target before any save)."""
        if self._last_slot is not None:
            return self._last_slot
        existing = self.slots()
        return existing[0][1] if existing else os.path.join(self.dir, _LEGACY)

    def exists(self) -> bool:
        return bool(self.slots())

    # -- save --------------------------------------------------------------

    def save(self, state: CycleGANState, epoch: int,
             meta: Optional[dict] = None) -> dict:
        """Write the slot of ``epoch``, then its manifest and ``meta.json``
        (``meta`` plus the epoch), then prune the ring. Returns the
        manifest."""
        slot = self._slot_path(epoch)
        contents = slot_contents(state)
        digest = hashlib.sha256()
        _digest_update(digest, contents)
        tmp = f"{slot}.tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for stem, obj in contents.items():
            torch.save(obj, os.path.join(tmp, f"{stem}.pt"))
        if os.path.exists(slot):  # keep=1: the one slot is overwritten
            old = f"{slot}.old{os.getpid()}"
            os.replace(slot, old)
            os.replace(tmp, slot)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.replace(tmp, slot)
        self._last_slot = slot
        manifest = self._write_manifest(slot, epoch, digest.hexdigest())
        record = dict(meta or {}, epoch=int(epoch), slot=os.path.basename(slot))
        tmp_meta = self.meta_path + ".tmp"
        with open(tmp_meta, "w") as f:
            json.dump(record, f)
        os.replace(tmp_meta, self.meta_path)
        self._prune()
        return manifest

    def _write_manifest(self, slot: str, epoch: int, digest: str) -> dict:
        files, total = {}, 0
        for name in sorted(os.listdir(slot)):
            path = os.path.join(slot, name)
            nbytes = os.path.getsize(path)
            files[name] = {"sha256": _sha256_file(path), "bytes": nbytes}
            total += nbytes
        record = {"slot": os.path.basename(slot), "epoch": int(epoch),
                  "n_files": len(files), "total_bytes": total,
                  "state_sha256": digest, "files": files}
        path = self._manifest_path(slot)
        with open(path + ".tmp", "w") as f:
            json.dump(record, f)
        os.replace(path + ".tmp", path)
        return record

    def _prune(self) -> None:
        """Drop the slots beyond the ``keep`` newest, with their
        manifests."""
        for _, path in self.slots()[self.keep:]:
            shutil.rmtree(path, ignore_errors=True)
            try:
                os.remove(self._manifest_path(path))
            except OSError:
                pass

    # -- verification ------------------------------------------------------

    def read_manifest(self, slot: str) -> Optional[dict]:
        try:
            with open(self._manifest_path(slot)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def verify(self, slot: Optional[str] = None) -> Tuple[bool, str]:
        """Re-hash one slot (the newest by default) against its manifest;
        (ok, detail)."""
        if slot is None:
            existing = self.slots()
            if not existing:
                return False, "no checkpoint slots exist"
            slot = existing[0][1]
        if not os.path.isdir(slot):
            return False, f"slot {os.path.basename(slot)} does not exist"
        manifest = self.read_manifest(slot)
        if manifest is None:
            return True, "unverified (no manifest)"
        files = manifest.get("files", {})
        for rel, info in sorted(files.items()):
            path = os.path.join(slot, rel)
            if not os.path.isfile(path):
                return False, f"missing file {rel}"
            try:
                ok = _sha256_file(path) == info.get("sha256")
            except OSError as e:
                return False, f"unreadable file {rel} ({e})"
            if not ok:
                return False, f"sha256 mismatch in {rel}"
        return True, (f"verified ({len(files)} files, "
                      f"{manifest.get('total_bytes', 0)} bytes)")

    # -- restore -----------------------------------------------------------

    def read_meta(self) -> dict:
        """``meta.json``, or {} where it is missing or unreadable."""
        try:
            with open(self.meta_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def load_slot(self, state: CycleGANState, slot: str) -> CycleGANState:
        """Load ``slot`` into ``state`` in place, onto its device."""
        device = next(state.g.parameters()).device

        def load(stem):
            return torch.load(os.path.join(slot, f"{stem}.pt"),
                              map_location=device, weights_only=True)

        state.step = int(load("step")["step"])
        for name, net, opt in zip(NETWORKS, state.networks, state.optimizers):
            to_state_dict = (discriminator_state_from_flax
                             if name.startswith("d")
                             else generator_state_from_flax)
            params = {k: np.asarray(v.cpu()) for k, v in load(name).items()}
            channels = int(params["Conv_0/kernel"].shape[2])
            net.load_state_dict(to_state_dict(params, channels))
            opt.load_state_dict(load(f"{name}_opt"))
        return state

    def restore(self, state: CycleGANState) -> Tuple[CycleGANState, int]:
        """Load the newest verified slot into ``state``; (state, the epoch
        after the slot's)."""
        existing = self.slots()
        if not existing:
            raise FileNotFoundError(f"no checkpoint slots under {self.dir}")
        failures: List[str] = []
        for epoch, slot in existing:
            ok, detail = self.verify(slot)
            if not ok:
                failures.append(f"{os.path.basename(slot)}: {detail}")
                continue
            state = self.load_slot(state, slot)
            self._last_slot = slot
            if failures:
                print(f"checkpoint slot(s) failed verification "
                      f"[{'; '.join(failures)}]; fell back to verified slot "
                      f"{os.path.basename(slot)} (epoch {epoch})")
            return state, int(epoch) + 1
        raise RuntimeError(
            f"every checkpoint slot failed verification: "
            f"{'; '.join(failures)} — no slot is safe to restore")

    def restore_if_exists(self, state: CycleGANState
                          ) -> Tuple[CycleGANState, int, bool]:
        """Auto-resume: (state, start epoch, resumed)."""
        if self.exists():
            state, epoch = self.restore(state)
            return state, epoch, True
        return state, 0, False

    def restore_for_cli(self, state: CycleGANState
                        ) -> Tuple[CycleGANState, int, bool]:
        """``restore_if_exists`` for the inference CLI: a failed restore
        exits with the error and its likeliest cause."""
        try:
            return self.restore_if_exists(state)
        except Exception as e:
            raise SystemExit(
                f"checkpoint restore failed: {type(e).__name__}: {e}\n"
                "If the error lists slots that failed verification, every "
                "ring slot's sha256 manifest mismatched: the checkpoint "
                "directory is corrupt; re-fetch it or retrain. If it is a "
                "parameter shape mismatch, the flags given differ from the "
                "architecture in checkpoints/meta.json.") from e

