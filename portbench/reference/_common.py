"""What the two families' plain references share: the parameter layout's
bookkeeping, the products at a chosen precision, the norm, RoPE, plain
attention, the tied LM head with its cross-entropy, AdamW with the
launcher's schedule, and the loops of a training step and a prefill.

Plain f32 PyTorch, with TF32 off.  Nothing here imports the program: the
formulas follow the models' published descriptions, in the layout of
parameters the benchmark makes (stacked layers under ``dec/stack/b0/``,
as the program stores them), and each departure is named where it is made.

``precision`` is "f32" (the oracle), "bf16" or "fp8": every product's two
operands, the embedding's output and the residual stream after each
residual add are rounded to that type (fp8 as e4m3 with one scale a tensor,
from its largest magnitude), the rest stays f32.  The gradient passes the
rounding straight through.  "fp8" is the control: the reference in the
next precision below the program's bf16.
"""
from __future__ import annotations

import math
import zlib

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as cp

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ------------------------------------------------------------------ weights
def leaf_seed(seed: int, key: str) -> int:
    """The seed of one parameter: the run's seed and the key's name."""
    return (int(seed) * 1_000_003 + zlib.crc32(key.encode())) % (1 << 62)


def make_leaf(spec: tuple, seed: int, device) -> torch.Tensor:
    """One f32 parameter of ``(key, shape, init, fan_in)``, made on
    ``device`` in one call: normal / sqrt(fan_in), ones, zeros, Mamba2's
    A_log = log(linspace(1, 16, H)) along the last dimension, or Mamba2's
    dt_bias, softplus^-1 of a dt log-uniform in [1e-3, 0.1]."""
    key, shape, init, fan_in = spec
    if init == "ones":
        return torch.ones(shape, device=device)
    if init == "zeros":
        return torch.zeros(shape, device=device)
    if init == "a_log":
        a = torch.linspace(1.0, 16.0, shape[-1], device=device)
        return torch.log(a).expand(shape).clone()
    g = torch.Generator(device=device).manual_seed(leaf_seed(seed, key))
    if init == "dt_bias":
        u = torch.rand(shape, generator=g, device=device)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        return dt + torch.log(-torch.expm1(-dt))
    t = torch.randn(shape, generator=g, device=device)
    return t.mul_(1.0 / math.sqrt(fan_in))


def stacked(key: str) -> bool:
    return key.startswith("dec/stack/")


# ----------------------------------------------------------------- products
def quantize(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` rounded to the type of ``precision``: the products' operands
    and the activations the program keeps in its compute type (the
    embedding's output, the residual stream)."""
    if precision == "f32":
        return x
    with torch.no_grad():
        if precision == "bf16":
            q = x.to(torch.bfloat16).float()
        elif precision == "fp8":
            scale = FP8_MAX / x.abs().amax().float().clamp_min(1e-30)
            q = (x * scale).to(torch.float8_e4m3fn).float() / scale
        else:
            raise ValueError(f"unknown precision {precision!r}")
    return x + (q - x).detach()


def ein(eq: str, a, b, precision: str):
    return torch.einsum(eq, quantize(a, precision), quantize(b, precision))


def mm(a, b, precision: str):
    return quantize(a, precision) @ quantize(b, precision)


# ------------------------------------------------------------------ layers
def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """Rotary positions on the two halves of each head (the rotate-half
    form): x (B, S, H, hd) at positions 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(half, device=x.device, dtype=torch.float32)
                    / half)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, precision: str):
    """Softmax attention over the causal pairs, scaled by 1/sqrt(hd); GQA:
    query head h reads key/value head h // (H / KH).  q (B, S, H, hd), k and
    v (B, S, KH, hd) -> (B, S, H, hd)."""
    B, S, H, hd = q.shape
    KH = k.shape[2]
    qg = q.reshape(B, S, KH, H // KH, hd)
    s = ein("bqhgd,bkhd->bhgqk", qg, k, precision) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    o = ein("bhgqk,bkhd->bqhgd", p, v, precision)
    return o.reshape(B, S, H, hd)


# -------------------------------------------------------------- the LM head
def ce_sum(h, embed, labels, precision: str, chunk: int = 1024):
    """Sum over positions of the cross-entropy of the tied head's f32
    logits, in chunks of the sequence, each recomputed in the backward."""
    def part(hh, ll, e):
        logits = ein("bcd,vd->bcv", hh, e, precision)
        gold = logits.gather(-1, ll[..., None].long())[..., 0]
        return (torch.logsumexp(logits, -1) - gold).sum()

    total = h.new_zeros(())
    for c0 in range(0, h.shape[1], chunk):
        total = total + cp.checkpoint(part, h[:, c0:c0 + chunk],
                                      labels[:, c0:c0 + chunk], embed,
                                      use_reentrant=False)
    return total


# ---------------------------------------------------------------- training
def lr_at(step: int, opt: dict) -> float:
    """The launcher's schedule: linear warm-up, then a cosine down to
    ``min_lr_frac`` of the rate."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((step - opt["warmup_steps"])
                / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    cos = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 \
        * (1 + math.cos(math.pi * t))
    return opt["lr"] * warm * cos


def _layers(flat: dict) -> dict:
    """Each parameter as the parts the reference steps alone: a stacked one
    as its layers' views, any other whole."""
    out = {}
    for key, t in flat.items():
        for i, part in enumerate(t.unbind(0) if stacked(key) else (t,)):
            out[(key, i)] = part
    return out


def _layer_leaves(flat: dict) -> dict:
    """The parts of ``_layers`` as leaves that autograd can hold."""
    return {k: t.detach().requires_grad_(True)
            for k, t in _layers(flat).items()}


def _per_key(values: dict) -> dict:
    """Norms over each key's leaves, from their squared norms."""
    out = {}
    for (key, _), sq in values.items():
        out[key] = out.get(key, 0.0) + sq
    return {k: math.sqrt(v) for k, v in out.items()}


def _start(specs: list, seed: int, start, device) -> tuple:
    """(parameters, first moments, second moments, steps taken) to train
    from: the model made from the seed with zero moments, or ``start``'s
    host tensors copied to ``device``."""
    if start is None:
        flat = {s[0]: make_leaf(s, seed, device) for s in specs}
        zeros = {k: torch.zeros_like(t) for k, t in flat.items()}
        return flat, zeros, {k: t.clone() for k, t in zeros.items()}, 0
    copy = lambda name: {s[0]: start[name][s[0]].to(device, copy=True)
                         for s in specs}
    return copy("params"), copy("m"), copy("v"), int(start["step"])


def train(family, c: dict, specs: list, seed: int, batches: list,
          opt: dict, precision: str, device, start: dict = None) -> dict:
    """``len(batches)`` AdamW steps of a freshly made model, or with
    ``start`` ({"params", "m", "v": host tensors by key, "step": the steps
    they have taken}) of that state.  Returns each step's loss, each
    parameter's first gradient as the optimizer takes it (clipped) as a
    norm, and each parameter's change over the steps as a norm.
    ``family.block(p, x, c, precision)`` is one layer of the stack."""
    no_tf32()
    flat, m_flat, v_flat, step0 = _start(specs, seed, start, device)
    leaves = _layer_leaves(flat)
    m, v = _layers(m_flat), _layers(v_flat)
    decay = {key: flat[key].dim() >= 2 for key in flat}
    losses, first_grad = [], None
    for step, batch in enumerate(batches, start=step0 + 1):
        loss = lm_loss(family, c, leaves, batch, precision) \
            / batch["tokens"].numel()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = dict(zip(leaves, grads))
        gn = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        clip = torch.clamp(opt["clip_norm"] / gn.clamp_min(1e-9), max=1.0)
        if step == step0 + 1:
            first_grad = _per_key({k: float(((g * clip) ** 2).sum())
                                   for k, g in grads.items()})
        lr = lr_at(step, opt)
        c1, c2 = 1 - opt["b1"] ** step, 1 - opt["b2"] ** step
        with torch.no_grad():
            for k, p in leaves.items():
                g = grads[k] * clip
                m[k].mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
                v[k].mul_(opt["b2"]).add_((1 - opt["b2"]) * g * g)
                delta = (m[k] / c1) / (torch.sqrt(v[k] / c2) + opt["eps"])
                if decay[k[0]]:  # decoupled decay on the stacked matrices
                    delta = delta + opt["weight_decay"] * p
                p.sub_(lr * delta)
        losses.append(float(loss.detach()))
        del grads, loss
    del leaves, m, v, m_flat, v_flat
    change = {}
    with torch.no_grad():
        for s in specs:
            p0 = make_leaf(s, seed, device) if start is None \
                else start["params"][s[0]].to(device)
            change[s[0]] = float(torch.linalg.vector_norm(flat[s[0]] - p0))
            del p0
    return {"losses": losses, "grad_norms": first_grad, "change_norms": change}


def lm_loss(family, c: dict, leaves: dict, batch: dict, precision: str):
    """Summed cross-entropy of a batch: embedding, the stack (each layer
    recomputed in the backward), the final norm and the tied head."""
    x = quantize(leaves[("embed", 0)][batch["tokens"].long()], precision)
    layer_keys = sorted({k for (k, _) in leaves if stacked(k)})
    prefix = "dec/stack/b0/"
    for i in range(c["n_layers"]):
        p = {k[len(prefix):]: leaves[(k, i)] for k in layer_keys}
        x = cp.checkpoint(lambda x, p=p: family.block(p, x, c, precision)[0],
                          x, use_reentrant=False)
    h = rmsnorm(x, leaves[("final_norm", 0)], c["norm_eps"])
    return ce_sum(h, leaves[("embed", 0)], batch["labels"], precision)


# ----------------------------------------------------------------- prefill
@torch.no_grad()
def prefill(family, c: dict, flat: dict, tokens, precision: str,
            want_cache: bool) -> dict:
    """The f32 logits of each prompt's last position, (B, V), and with
    ``want_cache`` what each layer leaves for decoding, stacked over the
    layers under the cache's keys."""
    no_tf32()
    x = quantize(flat["embed"][tokens.long()], precision)
    prefix = "dec/stack/b0/"
    layer_keys = [k for k in flat if stacked(k)]
    caches = []
    for i in range(c["n_layers"]):
        p = {k[len(prefix):]: flat[k][i] for k in layer_keys}
        x, cache = family.block(p, x, c, precision)
        if want_cache:
            caches.append(cache)
    h = rmsnorm(x[:, -1:], flat["final_norm"], c["norm_eps"])
    logits = ein("bsd,vd->bsv", h, flat["embed"], precision)[:, 0]
    out = {"logits": logits}
    if want_cache:
        out["cache"] = {prefix + name: torch.stack([cc[name] for cc in caches])
                        for name in caches[0]}
    return out
