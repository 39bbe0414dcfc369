"""Training launcher (``repro/launch/train.py``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --no-reduced --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m --no-reduced --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-3b-a800m --no-reduced --batch 4 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --no-reduced --batch 4 --seq 2048 --mesh 1x1

Trains an LM (dense, mixture of experts, Mamba2, RG-LRU hybrid or
encoder-decoder, the last fed zero encoder frames as in the reference) on
deterministic synthetic tokens with AdamW, periodic
asynchronous checkpoints and restart-resume (a resumed run replays the data
stream from the saved step).  Runs on ``cuda`` unless ``--device cpu`` is
given; without a card it raises rather than fall back.  ``--reduced``
(off by default, as the reference's ``store_true``) trains the small
structure-preserving config.  ``--mesh DxM`` trains on a (data, model)
mesh of D*M ranks, one device each: the parameters and moments placed by
``lm.param_pspecs`` as DTensors, the batch on ``data``, the step under
``sharding.mesh_context``.  It takes the process group the caller started
(one process per device); with none, a 1 x 1 mesh runs on a group of this
process alone.  A mesh that needs more ranks or devices than there are
raises.  On one card the only real mesh is 1 x 1, which computes what the
run without a mesh computes.  A run resumes on any mesh, or none, whatever
mesh wrote its checkpoint: the restore places each rank's blocks straight
from the file (``restore_checkpoint(mesh=, specs=)``), and a save on a mesh
of several ranks is written once, by rank 0.
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
from ..kernels.shards import is_dtensor
from ..models import lm
from ..models.params import flatten, unflatten
from ..models.sharding import mesh_context, place_flat
from ..models.steps import enc_embeds, init_train_state, make_train_step
from ..train.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from ..train.optimizer import OptConfig


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _start_mesh(spec: str, device: torch.device):
    """(mesh, whether this call started the process group) for ``--mesh
    DxM``."""
    import torch.distributed as dist
    from .mesh import make_mesh
    d, m = (int(x) for x in spec.split("x"))
    n = d * m
    started = False
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"--mesh {spec} needs {n} processes, one device each; start "
                "them with their process group (torchrun), or use --mesh 1x1")
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
        started = True
    if device.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"--mesh {spec} needs {n} devices; this machine has "
                         f"{torch.cuda.device_count()}")
    try:
        return make_mesh((d, m), ("data", "model"), device.type), started
    except Exception:
        if started:
            dist.destroy_process_group()
        raise


def _state_specs(cfg, mesh) -> dict:
    """The train state's specs: the parameters and both AdamW moments by
    ``lm.param_pspecs``; the step count, outside them, stays a plain
    tensor."""
    ps = lm.param_pspecs(cfg, mesh)
    return {"params": ps, "opt": {"m": ps, "v": ps}}


def main(argv=None):
    """Train; returns the final state with the run's per-step losses, step
    times (host clock, synchronised), kernel launches, peak device memory,
    and the wall seconds of its restore and of its last checkpoint (the
    snapshot and the write; None without one)."""
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
    ap.add_argument("--mesh", default=None,
                    help="DxM: a (data, model) mesh, one device a rank")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()

    mesh, started = _start_mesh(args.mesh, device) if args.mesh else (None, False)
    try:
        specs = _state_specs(cfg, mesh) if mesh is not None else None
        start_step, restore_s = 0, None
        if args.checkpoint_dir and latest_step(args.checkpoint_dir) is not None:
            _sync(device)
            t = time.perf_counter()
            state, start_step, _ = restore_checkpoint(
                args.checkpoint_dir, device=device, mesh=mesh, specs=specs)
            _sync(device)
            restore_s = time.perf_counter() - t
            print(f"[train] resumed from step {start_step}")
        else:
            state = init_train_state(
                cfg, torch.Generator(device).manual_seed(args.seed))
            state = unflatten(place_flat(flatten(state).items(), mesh,
                                         flatten(specs or {})))
        out = _train(args, cfg, device, state, start_step, mesh)
        out["restore_s"] = restore_s
        return out
    finally:
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()


def _train(args, cfg, device, state, start_step: int, mesh):
    oc = OptConfig(lr=args.lr, total_steps=max(args.steps, 1000))
    step_fn = make_train_step(cfg, oc)
    src = SyntheticTokens(cfg.vocab, args.batch, args.seq, seed=args.seed,
                          start_step=start_step)
    ckpt = AsyncCheckpointer(args.checkpoint_dir) if args.checkpoint_dir else None

    n_params = lm.num_params(cfg)
    print(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M "
          f"batch={args.batch} seq={args.seq} steps={args.steps}"
          + (f" mesh={dict(mesh.shape)}" if mesh is not None else ""))
    tok_per_step = args.batch * args.seq
    losses, step_ms, launches = [], [], []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        t = time.perf_counter()
        before = collections.Counter(LAUNCHES)
        batch = src.next_batch()
        if cfg.enc_dec:
            batch["enc_embeds"] = enc_embeds(cfg, args.batch, device)
        batch = shard_batch(batch, device, mesh)
        with mesh_context(mesh):
            state, metrics = step_fn(state, batch)
        loss = metrics["loss"]
        loss = float(loss.full_tensor() if is_dtensor(loss) else loss)
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
    checkpoint_s = None
    if ckpt:
        t = time.perf_counter()
        ckpt.save(state, args.steps)
        ckpt.wait()
        checkpoint_s = time.perf_counter() - t
        print(f"[train] checkpointed at {args.checkpoint_dir}")
    return {"state": state, "arch": cfg.name, "device": str(device),
            "start_step": start_step, "steps": args.steps,
            "tokens_per_step": tok_per_step, "losses": losses,
            "step_ms": step_ms, "launches": launches,
            "checkpoint_s": checkpoint_s,
            "max_memory_allocated": torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None}


if __name__ == "__main__":
    main()
