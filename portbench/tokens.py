"""The one generator of token traffic: a frozen copy of the program's
``SyntheticTokens`` draw.  A batch is a function of (seed, index) alone:
numpy's ``default_rng((seed << 32) + index)``, u uniform in [0, 1), token
min(floor(V u^power), V - 1), a Zipf-like marginal that favours low ids.
Every seed gets the same sizes; only the ids differ."""
from __future__ import annotations

import numpy as np


def draw(seed: int, index: int, batch: int, length: int, vocab: int,
         power: float) -> np.ndarray:
    """(batch, length) int32 token ids."""
    rng = np.random.default_rng((int(seed) << 32) + int(index))
    u = rng.random((batch, length))
    return np.minimum((vocab * u ** power).astype(np.int32), vocab - 1)


def train_batch(seed: int, index: int, traffic: dict, vocab: int) -> dict:
    """Tokens and next-token labels of one training step."""
    t = draw(seed, index, traffic["batch"], traffic["seq"] + 1, vocab,
             traffic["zipf_power"])
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def prompts(seed: int, index: int, traffic: dict, vocab: int) -> np.ndarray:
    """The prompts of one batch of requests; warm-up batches take negative
    indices, which no measured batch takes."""
    return draw(seed, (1 << 31) + index if index < 0 else index,
                traffic["batch"], traffic["prompt_len"], vocab,
                traffic["zipf_power"])
