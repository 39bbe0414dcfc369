"""Checkpointing (``repro/train/checkpoint.py``): flat-key npz + JSON
manifest, an asynchronous writer, and restore onto a device.

The layout is the reference's, ``step-{n}.npz`` beside ``manifest.json`` with
``/``-joined keys (``params/embed``, ``opt/m/...``, ``opt/step``), so a
checkpoint written by either package restores in the other.  Restore puts
the arrays on ``device``: the card unless the caller asks for the CPU, and
without a card it raises.  numpy has no bf16 type, so a bf16 tensor is saved
as its 16-bit pattern (int16) and the manifest records every key's dtype
(``dtypes``); restore views those bits as bf16 again.  A manifest without
``dtypes`` (the reference's) restores each array in its own type.  Resharding onto a mesh waits for the port's
sharding work.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models.params import flatten as _flatten
from ..models.params import unflatten as _unflatten


def _host_arrays(state) -> Tuple[dict, dict]:
    """(flat key -> numpy copy of each tensor, flat key -> its dtype's name).
    A copy even on the CPU, so the in-place updates of later steps do not
    reach a pending write; a bf16 tensor as its bits, int16."""
    arrays, dtypes = {}, {}
    for k, v in _flatten(state).items():
        v = v.detach().to("cpu", copy=True)
        dtypes[k] = str(v.dtype).removeprefix("torch.")
        arrays[k] = (v.view(torch.int16) if v.dtype == torch.bfloat16 else v).numpy()
    return arrays, dtypes


def _write(path: str, host: Tuple[dict, dict], step: int,
           extra: Optional[dict]) -> None:
    arrays, dtypes = host
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f".tmp-{step}.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, os.path.join(path, f"step-{step}.npz"))
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"step": step, "keys": sorted(arrays), "dtypes": dtypes,
                   "extra": extra or {}}, f)


def save_checkpoint(path: str, state, step: int, *,
                    extra: Optional[dict] = None) -> None:
    _write(path, _host_arrays(state), step, extra)


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training (one in flight at a time);
    a failed write raises from the next ``save`` or ``wait``."""

    def __init__(self, path: str):
        self.path = path
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, state, step: int, extra=None) -> None:
        self.wait()
        host = _host_arrays(state)  # the snapshot, on the caller's thread

        def write():
            try:
                _write(self.path, host, step, extra)
            except Exception as e:  # reported by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError(f"checkpoint write to {self.path} failed") from error


def latest_step(path: str) -> Optional[int]:
    mf = os.path.join(path, "manifest.json")
    if not os.path.exists(mf):
        return None
    with open(mf) as f:
        return json.load(f)["step"]


def restore_checkpoint(path: str, *, step: Optional[int] = None,
                       device="cuda") -> Tuple[Any, int, dict]:
    """(state tree of tensors on ``device``, step, extra) of a checkpoint;
    the latest one unless ``step`` is given."""
    device = resolve_device(device)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = manifest.get("dtypes", {})
    with np.load(os.path.join(path, f"step-{step}.npz")) as data:
        flat = {k: _tensor(data[k], dtypes.get(k)).to(device) for k in data.files}
    return _unflatten(flat), step, manifest.get("extra", {})


def _tensor(a: np.ndarray, dtype: Optional[str]) -> torch.Tensor:
    """A saved array as a tensor: bf16 from its recorded bits, any other in
    its own type."""
    t = torch.from_numpy(np.array(a))
    if dtype == "bfloat16":
        if t.dtype != torch.int16:
            raise ValueError(f"a bf16 entry must be saved as int16 bits, got {t.dtype}")
        return t.view(torch.bfloat16)
    return t
