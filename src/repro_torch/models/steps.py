"""Step functions (``repro/models/steps.py``): training (AdamW and the
sequence-chunked cross-entropy), prefill, and single-token decode."""
from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from ..configs.base import ArchConfig
from ..train.compression import compress_grads
from ..train.optimizer import OptConfig, adamw_update, init_opt_state
from .lm import LM, forward, init_params, logits_from_hidden
from .params import flatten, unflatten


def chunked_ce_loss(params, h, labels, cfg: ArchConfig) -> torch.Tensor:
    """Mean cross-entropy without materialising (B, S, V) logits: the
    sequence in chunks of C = min(ce_chunk, S) (one chunk of S when C does
    not divide S), each chunk's f32 logits recomputed in the backward."""
    B, S, _ = h.shape
    C = min(cfg.ce_chunk, S)
    if S % C:
        C = S  # fallback: single chunk
    emb = params["embed"]

    def chunk_fn(hh, ll):
        logits = torch.einsum("bcd,vd->bcv", hh.float(), emb.float())
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, ll[..., None].long())[..., 0]
        return (lse - gold).sum()

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, C):
        total = total + torch.utils.checkpoint.checkpoint(
            chunk_fn, h[:, c0:c0 + C], labels[:, c0:c0 + C],
            use_reentrant=False)
    return total / (B * S)


def make_train_step(cfg: ArchConfig, oc: Optional[OptConfig] = None,
                    impl: str = "auto", grad_compression: str = "none"):
    """grad_compression="int8" enables error-feedback int8 gradient
    compression (state["gerr"] holds the feedback accumulator).  The step
    returns (state, {"loss", "grad_norm"}), the parameters and moments
    updated in place."""
    oc = oc or OptConfig()
    if grad_compression not in ("none", "int8"):
        raise ValueError(f"unknown grad_compression {grad_compression!r}")

    def train_step(state, batch):
        params = state["params"]
        flat = flatten(params)
        for p in flat.values():  # a restored state holds plain tensors
            p.requires_grad_(True)
        h, _ = forward(params, cfg, batch["tokens"], mode="train",
                       enc_embeds=batch.get("enc_embeds"), impl=impl)
        loss = chunked_ce_loss(params, h, batch["labels"], cfg)
        grads = torch.autograd.grad(loss, list(flat.values()),
                                    allow_unused=True, materialize_grads=True)
        grads = unflatten(dict(zip(flat, grads)))
        new_state = {}
        if grad_compression == "int8":
            grads, new_state["gerr"] = compress_grads(grads, state.get("gerr"))
        new_params, new_opt, gn = adamw_update(params, grads, state["opt"], oc)
        new_state.update({"params": new_params, "opt": new_opt})
        return new_state, {"loss": loss.detach(), "grad_norm": gn}

    return train_step


def make_prefill_step(cfg: ArchConfig, impl: str = "auto", cache_len=None):
    def prefill_step(model: LM, batch):
        params = model.tree()
        h, cache = forward(params, cfg, batch["tokens"], mode="prefill",
                           enc_embeds=batch.get("enc_embeds"), impl=impl,
                           cache_len=cache_len)
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


def enc_embeds(cfg: ArchConfig, batch: int, device) -> torch.Tensor:
    """An encoder-decoder's input frames as the reference's launchers feed
    them (the audio frontend is a stub): zeros of (batch, enc_seq, d_model)
    in the compute dtype."""
    return torch.zeros((batch, cfg.enc_seq, cfg.d_model), device=device,
                       dtype=getattr(torch, cfg.compute_dtype))


def init_train_state(cfg: ArchConfig, generator: torch.Generator):
    """Random trainable parameters drawn from ``generator`` (on its device)
    and zero AdamW moments."""
    params = init_params(cfg, generator, trainable=True).tree()
    return {"params": params, "opt": init_opt_state(params)}
