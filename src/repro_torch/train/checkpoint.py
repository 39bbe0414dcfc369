"""Checkpointing (``repro/train/checkpoint.py``): flat-key npz + JSON
manifest, an asynchronous writer, and restore onto a device or a mesh.

The layout is the reference's, ``step-{n}.npz`` beside ``manifest.json`` with
``/``-joined keys (``params/embed``, ``opt/m/...``, ``opt/step``), so a
checkpoint written by either package restores in the other.  Restore puts
the arrays on ``device``: the card unless the caller asks for the CPU, and
without a card it raises.  numpy has no bf16 type, so a bf16 tensor is saved
as its 16-bit pattern (int16) and the manifest records every key's dtype
(``dtypes``); restore views those bits as bf16 again.  A manifest without
``dtypes`` (the reference's) restores each array in its own type.

A DTensor is saved whole, gathered from its shards.  Under a process group
of more than one rank a save is collective: every rank gathers (``full_tensor``
is a collective), rank 0 alone writes, and no rank returns before the
checkpoint is complete on disk (see ``_outcome``).  Restore with ``mesh`` and
``specs`` places each key they cover onto that mesh, whatever mesh (or
none) wrote the checkpoint: the reference's elastic restart onto a new
cluster shape.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..kernels.shards import is_dtensor
from ..models.params import flatten as _flatten
from ..models.params import unflatten as _unflatten
from ..models.sharding import place_flat


def _group() -> Tuple[int, int]:
    """(this process's rank, the number of ranks that save together): (0, 1)
    without an initialised process group."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _host_arrays(state, keep: bool = True) -> Optional[Tuple[dict, dict]]:
    """(flat key -> numpy copy of each tensor, flat key -> its dtype's name).
    A copy even on the CPU, so the in-place updates of later steps do not
    reach a pending write; a bf16 tensor as its bits, int16.  Every rank
    gathers each DTensor, since ``full_tensor`` is a collective; a rank that
    does not write (``keep`` False) drops what it gathered and gets None."""
    arrays, dtypes = {}, {}
    for k, v in _flatten(state).items():
        if is_dtensor(v):
            v = v.full_tensor()
        if not keep:
            continue
        v = v.detach().to("cpu", copy=True)
        dtypes[k] = str(v.dtype).removeprefix("torch.")
        arrays[k] = (v.view(torch.int16) if v.dtype == torch.bfloat16 else v).numpy()
    return (arrays, dtypes) if keep else None


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


def _outcome(error: Optional[BaseException]) -> Optional[str]:
    """The barrier after a write on a group of more than one rank: rank 0,
    once its write has ended, broadcasts ``error`` (None, or what its write
    raised, as text), and every other rank waits for it.  So no rank returns
    before the checkpoint is complete on disk, and a failed write reaches
    every rank, which raises it, rather than leaving them at a barrier
    that rank 0 never reaches."""
    import torch.distributed as dist
    box = [None if error is None else repr(error)]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def save_checkpoint(path: str, state, step: int, *,
                    extra: Optional[dict] = None) -> None:
    rank, world = _group()
    host = _host_arrays(state, keep=rank == 0)
    if world == 1:
        _write(path, host, step, extra)
        return
    error = None
    if rank == 0:
        try:
            _write(path, host, step, extra)
        except Exception as e:  # raised below, once every rank knows
            error = e
    failed = _outcome(error)
    if error is not None:
        raise error
    if failed is not None:
        raise RuntimeError(f"checkpoint write to {path} failed on rank 0: "
                           f"{failed}")


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training (one in flight at a time);
    a failed write raises from the next ``save`` or ``wait``.  Under a group
    of more than one rank every rank calls ``save`` and ``wait`` alike: rank
    0 writes on its thread, and ``wait`` is the barrier (``_outcome``) on
    every rank, on the caller's thread, where the group's other collectives
    run, so it keeps their order."""

    def __init__(self, path: str):
        self.path = path
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._shared = False  # a multi-rank save whose barrier is pending

    def save(self, state, step: int, extra=None) -> None:
        self.wait()
        rank, world = _group()
        host = _host_arrays(state, keep=rank == 0)  # the snapshot, here
        self._shared = world > 1
        if host is None:
            return

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
        error, self._error = self._error, None
        failed = None
        if self._shared:
            self._shared = False
            failed = _outcome(error)
        if error is not None:
            raise RuntimeError(f"checkpoint write to {self.path} failed") from error
        if failed is not None:
            raise RuntimeError(f"checkpoint write to {self.path} failed on "
                               f"rank 0: {failed}")


def latest_step(path: str) -> Optional[int]:
    mf = os.path.join(path, "manifest.json")
    if not os.path.exists(mf):
        return None
    with open(mf) as f:
        return json.load(f)["step"]


def restore_checkpoint(path: str, *, step: Optional[int] = None,
                       device="cuda", mesh=None,
                       specs=None) -> Tuple[Any, int, dict]:
    """(state tree, step, extra) of a checkpoint; the latest one unless
    ``step`` is given.  Without a mesh every tensor comes back on
    ``device``.  With ``mesh`` and ``specs`` (a tree of ``P`` over some of
    the checkpoint's keys, say ``{"params": lm.param_pspecs(cfg, mesh)}``),
    the counterpart of the reference's ``shardings``: each key that
    ``specs`` covers comes back as a DTensor placed by its spec, of whose
    array only this rank's block is copied to ``device``
    (``sharding.distribute``); every other key (``opt/step``, say) a plain
    tensor on ``device``."""
    if (mesh is None) != (specs is None):
        raise ValueError("restore onto a mesh takes both mesh= and specs=")
    device = resolve_device(device)
    place = {}
    if mesh is not None:
        if device.type != mesh.device_mesh.device_type:
            raise ValueError(f"restore onto a {mesh.device_mesh.device_type} "
                             f"mesh needs a device of that type, not {device}")
        place = _flatten(specs)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = manifest.get("dtypes", {})
    with np.load(os.path.join(path, f"step-{step}.npz")) as data:
        missing = sorted(set(place) - set(data.files))
        if missing:
            raise KeyError(f"specs cover keys the checkpoint lacks: {missing}")
        flat = place_flat(((k, _tensor(data[k], dtypes.get(k)))
                           for k in data.files), mesh, place, device)
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
