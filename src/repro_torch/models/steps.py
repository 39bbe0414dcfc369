"""Serving step functions: prefill and single-token decode
(``repro/models/steps.py``)."""
from __future__ import annotations

from ..configs.base import ArchConfig
from .lm import LM, forward, logits_from_hidden


def make_prefill_step(cfg: ArchConfig, impl: str = "auto", cache_len=None):
    def prefill_step(model: LM, batch):
        params = model.tree()
        h, cache = forward(params, cfg, batch["tokens"], mode="prefill",
                           impl=impl, cache_len=cache_len)
        return logits_from_hidden(params, h[:, -1:], cfg), cache

    return prefill_step


def make_decode_step(cfg: ArchConfig, impl: str = "auto"):
    def decode_step(model: LM, cache, tokens, pos: int):
        """Updates ``cache`` in place and returns it."""
        params = model.tree()
        h, cache = forward(params, cfg, tokens, mode="decode", cache=cache,
                           pos=pos, impl=impl)
        return logits_from_hidden(params, h, cfg), cache

    return decode_step
