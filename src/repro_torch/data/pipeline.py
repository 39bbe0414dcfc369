"""Deterministic synthetic token pipeline with host-side prefetch
(``repro/data/pipeline.py``).

``SyntheticTokens`` draws the reference's batches with numpy, byte for byte
for every (seed, step), so a restart that replays the stream position
reproduces the run.  ``shard_batch`` moves a batch to a device (the card
unless the caller asks for the CPU) and, given a mesh, places each array's
batch dimension on the mesh's ("pod", "data") axes, as the reference does:
every rank draws the same batch and keeps its own rows.  ``Prefetcher``
produces batches on a background thread into a bounded queue.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from .. import resolve_device
from ..models.sharding import ACT_RULES, distribute, spec_for


class SyntheticTokens:
    """Zipf-ish synthetic LM tokens; labels are next-token shifted."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 start_step: int = 0):
        self.vocab = vocab
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.step = start_step

    def next_batch(self) -> dict:
        rng = np.random.default_rng((self.seed << 32) + self.step)
        self.step += 1
        # zipf-like marginal over the vocab, cheap to sample
        u = rng.random((self.batch, self.seq + 1))
        toks = np.minimum((self.vocab * u ** 2.5).astype(np.int32),
                          self.vocab - 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()


def shard_batch(batch: dict, device="cuda", mesh=None) -> dict:
    """The batch's arrays as tensors on ``device`` (int32 kept); under a
    ``mesh``, DTensors whose batch dimension is sharded by the activation
    rules (replicated where it does not divide)."""
    device = resolve_device(device)
    out = {k: v if isinstance(v, torch.Tensor) else
           torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    out = {k: v.to(device) for k, v in out.items()}
    if mesh is None:
        return out
    return {k: distribute(v, mesh, spec_for(
                v.shape, ("batch",) + (None,) * (v.dim() - 1), mesh,
                rules=ACT_RULES))
            for k, v in out.items()}


class Prefetcher:
    """Bounded background prefetch of batches moved to ``device``."""

    def __init__(self, source: SyntheticTokens, device="cuda", depth: int = 2):
        self.source = source
        self.device = resolve_device(device)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self._stop.is_set():
            b = shard_batch(self.source.next_batch(), self.device)
            while not self._stop.is_set():
                try:
                    self.q.put(b, timeout=0.1)
                    break
                except queue.Full:
                    pass

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def stop(self, timeout: float = 10.0) -> None:
        """Ends the producer thread and waits for it."""
        self._stop.set()
        self.thread.join(timeout)
        if self.thread.is_alive():
            raise RuntimeError("the prefetch thread did not stop")
