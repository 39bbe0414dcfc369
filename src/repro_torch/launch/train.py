"""Training launcher (``repro/launch/train.py``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --no-reduced --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m --no-reduced --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --steps 20

Trains an LM (dense, Mamba2 or RG-LRU hybrid) on deterministic synthetic
tokens with AdamW, periodic
asynchronous checkpoints and restart-resume (a resumed run replays the data
stream from the saved step).  Runs on ``cuda`` unless ``--device cpu`` is
given; without a card it raises rather than fall back.  ``--reduced``
(off by default, as the reference's ``store_true``) trains the small
structure-preserving config.  Mesh sharding waits for the port's sharding
work, so there is no ``--mesh``.
"""
from __future__ import annotations

import argparse
import collections
import math
import time

import torch

from .. import resolve_device
from ..configs import ARCHS
from ..data.pipeline import SyntheticTokens, shard_batch
from ..kernels import LAUNCHES
from ..models import lm
from ..models.steps import init_train_state, make_train_step
from ..train.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from ..train.optimizer import OptConfig


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Train; returns the final state with the run's per-step losses, step
    times (host clock, synchronised), kernel launches and peak device
    memory."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="structure-preserving small config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()

    start_step = 0
    state = init_train_state(cfg, torch.Generator(device).manual_seed(args.seed))
    if args.checkpoint_dir and latest_step(args.checkpoint_dir) is not None:
        state, start_step, _ = restore_checkpoint(args.checkpoint_dir,
                                                  device=device)
        print(f"[train] resumed from step {start_step}")

    oc = OptConfig(lr=args.lr, total_steps=max(args.steps, 1000))
    step_fn = make_train_step(cfg, oc)
    src = SyntheticTokens(cfg.vocab, args.batch, args.seq, seed=args.seed,
                          start_step=start_step)
    ckpt = AsyncCheckpointer(args.checkpoint_dir) if args.checkpoint_dir else None

    n_params = lm.num_params(cfg)
    print(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M "
          f"batch={args.batch} seq={args.seq} steps={args.steps}")
    tok_per_step = args.batch * args.seq
    losses, step_ms, launches = [], [], []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        t = time.perf_counter()
        before = collections.Counter(LAUNCHES)
        batch = shard_batch(src.next_batch(), device)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # waits for the step
        _sync(device)
        step_ms.append(1e3 * (time.perf_counter() - t))
        launches.append(dict(LAUNCHES - before))
        losses.append(loss)
        if not math.isfinite(loss):
            raise FloatingPointError(f"loss diverged at step {step + 1}: {loss}")
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            dt = time.perf_counter() - t0
            tps = tok_per_step * (step + 1 - start_step) / max(dt, 1e-9)
            print(f"[train] step={step + 1} loss={loss:.4f} tok/s={tps:,.0f}")
        if ckpt and (step + 1) % args.checkpoint_every == 0:
            ckpt.save(state, step + 1)
    if ckpt:
        ckpt.save(state, args.steps)
        ckpt.wait()
        print(f"[train] checkpointed at {args.checkpoint_dir}")
    return {"state": state, "arch": cfg.name, "device": str(device),
            "start_step": start_step, "steps": args.steps,
            "tokens_per_step": tok_per_step, "losses": losses,
            "step_ms": step_ms, "launches": launches,
            "max_memory_allocated": torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None}


if __name__ == "__main__":
    main()
