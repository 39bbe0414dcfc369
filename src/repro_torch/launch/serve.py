"""Serving launcher: static-batch prefill + decode loop
(``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium --no-reduced

Serves synthetic requests: each round admits up to --batch requests,
prefills them together, then decodes all sequences in lockstep until the
longest is done (length sampled per request).  An encoder-decoder config
(whisper-medium) is fed zero encoder frames, as the reference feeds them.
Runs on ``cuda`` unless ``--device cpu`` is given; without a card it raises
rather than fall back.
``--no-reduced`` serves the published width (the reference's flag could not
be turned off).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import ARCHS
from ..models.lm import init_params
from ..models.steps import enc_embeds, make_decode_step, make_prefill_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Serve and return the run's counts and host-clock times."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = ARCHS[args.arch].reduced() if args.reduced else ARCHS[args.arch]
    rng = np.random.default_rng(args.seed)
    model = init_params(cfg, torch.Generator(device).manual_seed(args.seed))
    cache_len = args.prompt_len + args.max_new
    prefill = make_prefill_step(cfg, cache_len=cache_len)
    decode = make_decode_step(cfg)

    done = rounds = total_tokens = decode_steps = 0
    prefill_s = decode_s = 0.0
    t0 = time.perf_counter()
    with torch.inference_mode():
        while done < args.requests:
            n = min(args.batch, args.requests - done)
            prompts = rng.integers(0, cfg.vocab, size=(args.batch, args.prompt_len))
            lengths = rng.integers(4, args.max_new + 1, size=args.batch)
            batch = {"tokens": torch.from_numpy(prompts).to(device)}
            if cfg.enc_dec:  # the audio frontend is a stub: zero frames
                batch["enc_embeds"] = enc_embeds(cfg, args.batch, device)
            t = time.perf_counter()
            logits, cache = prefill(model, batch)
            tok = logits[:, -1].argmax(dim=-1)[:, None]
            _sync(device)
            prefill_s += time.perf_counter() - t
            t = time.perf_counter()
            for i in range(int(lengths.max()) - 1):
                logits, cache = decode(model, cache, tok, args.prompt_len + i)
                tok = logits[:, -1].argmax(dim=-1)[:, None]
                decode_steps += 1
            _sync(device)
            decode_s += time.perf_counter() - t
            total_tokens += int(lengths[:n].sum())
            done += n
            rounds += 1
            print(f"[serve] round done: {done}/{args.requests} requests, "
                  f"{total_tokens} tokens, "
                  f"{total_tokens / (time.perf_counter() - t0):.1f} tok/s")
    seconds = time.perf_counter() - t0
    print(f"[serve] complete in {seconds:.1f}s")
    return {"arch": cfg.name, "device": str(device), "rounds": rounds, "requests": done,
            "tokens": total_tokens, "seconds": seconds,
            "tok_per_s": total_tokens / seconds,
            "prefill_ms": 1e3 * prefill_s / rounds,
            "decode_ms_per_token": 1e3 * decode_s / max(decode_steps, 1)}


if __name__ == "__main__":
    main()
