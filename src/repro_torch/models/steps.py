"""Step functions (``repro/models/steps.py``): training (AdamW and the
sequence-chunked cross-entropy), prefill, and single-token decode.

Under a mesh (``sharding.mesh_context``, DTensor parameters and batch) the
same steps run sharded: the CE chunk's logits are constrained to the vocab
on `model`, and each gradient is placed as its parameter before AdamW (the
all-reduce or reduce-scatter over the ranks that share the batch)."""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..kernels.shards import is_dtensor
from ..train.compression import compress_grads
from ..train.optimizer import OptConfig, adamw_update, init_opt_state
from .lm import LM, forward, init_params, logits_from_hidden
from .params import flatten, unflatten
from .sharding import constrain, einsum, remat


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
        logits = einsum("bcd,vd->bcv", hh.float(), emb.float())
        logits = constrain(logits, "batch", None, "vocab")
        return (_logsumexp(logits) - _label_logits(logits, ll)).sum()

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, C):
        total = total + remat(chunk_fn, h[:, c0:c0 + C],
                              labels[:, c0:c0 + C])
    return total / (B * S)


def _vocab_axis(logits):
    """The mesh dimension that shards a DTensor's vocab (its last
    dimension), or None."""
    from torch.distributed.tensor import Shard
    return next((i for i, p in enumerate(logits.placements)
                 if isinstance(p, Shard) and p.dim == logits.dim() - 1), None)


def _logsumexp(logits):
    """``torch.logsumexp`` over the vocab.  Where a mesh shards the vocab,
    each rank takes the max and the sum of exponentials over its shard and
    only those (a (B, C) max and sum) cross the mesh, as GSPMD partitions
    the reduction, not the whole chunk's logits."""
    if not is_dtensor(logits) or _vocab_axis(logits) is None:
        return torch.logsumexp(logits, dim=-1)
    from torch.distributed.tensor import Replicate
    place = list(logits.placements)
    place[_vocab_axis(logits)] = Replicate()
    m = logits.detach().amax(dim=-1, keepdim=True) \
        .redistribute(logits.device_mesh, place)
    return torch.exp(logits - m).sum(-1).log() + m[..., 0]


def _label_logits(logits, labels):
    """Each position's logit of its label.  Under a mesh whose `model` axis
    shards the vocab, each rank gathers the labels that fall in its shard
    and zeros elsewhere, and the logit is the sum over the shards (a partial
    sum, reduced where it is used), as GSPMD gathers along a sharded
    dimension."""
    if not is_dtensor(logits):
        return torch.gather(logits, -1, labels[..., None].long())[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, vocab = logits.device_mesh, _vocab_axis(logits)
    keep, rows, out = [], [], []
    for i, p in enumerate(logits.placements):
        batch = isinstance(p, Shard) and p.dim == 0
        keep.append(p if batch or i == vocab else Replicate())
        rows.append(p if batch else Replicate())
        out.append(p if batch else Partial() if i == vocab else Replicate())
    local = logits.redistribute(mesh, keep).to_local(grad_placements=keep)
    lab = labels.redistribute(mesh, rows).to_local().long()
    if vocab is None:
        gold = torch.gather(local, -1, lab[..., None])[..., 0]
    else:
        V = local.shape[-1]
        lab = lab - mesh.get_local_rank(vocab) * V
        gold = torch.where((lab >= 0) & (lab < V), torch.gather(
            local, -1, lab.clamp(0, V - 1)[..., None])[..., 0], 0)
    return DTensor.from_local(gold, mesh, out, run_check=False)


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
        grads = unflatten({k: _placed_as(g, flat[k])
                           for k, g in zip(flat, grads)})
        new_state = {}
        if grad_compression == "int8":
            grads, new_state["gerr"] = compress_grads(grads, state.get("gerr"))
        new_params, new_opt, gn = adamw_update(params, grads, state["opt"], oc)
        new_state.update({"params": new_params, "opt": new_opt})
        return new_state, {"loss": loss.detach(), "grad_norm": gn}

    return train_step


def _placed_as(grad, param):
    """A DTensor gradient, perhaps a partial sum over the ranks that share
    the batch, redistributed to its parameter's placements."""
    if not is_dtensor(grad) or grad.placements == param.placements:
        return grad
    return grad.redistribute(param.device_mesh, param.placements)


def _tree(model):
    """The parameter tree of an ``LM``, or a tree itself (the dry run's
    DTensors)."""
    return model.tree() if isinstance(model, LM) else model


def make_prefill_step(cfg: ArchConfig, impl: str = "auto", cache_len=None):
    def prefill_step(model: LM, batch):
        params = _tree(model)
        h, cache = forward(params, cfg, batch["tokens"], mode="prefill",
                           enc_embeds=batch.get("enc_embeds"), impl=impl,
                           cache_len=cache_len)
        return logits_from_hidden(params, h[:, -1:], cfg), cache

    return prefill_step


def make_decode_step(cfg: ArchConfig, impl: str = "auto"):
    def decode_step(model: LM, cache, tokens, pos: int):
        """Updates ``cache`` in place and returns it."""
        params = _tree(model)
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
