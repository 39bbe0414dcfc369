"""Prefill of batch scoring: a closed loop of batches of prompts, each
asking for its first token, the next batch due when the last has ended,
as ``repro_torch.launch.serve`` prefills a round.

Set-up makes the weights on the device from the seed, wraps them in the
program's ``models.lm.LM`` and takes ``models.steps.make_prefill_step``;
it warms the cell's one shape on ``warmup_batches`` batches that the window
never sends.  Under ``torch.inference_mode`` the window prefills batch i
(``tokens.prompts(seed, i)``), takes the argmax of the last logits and
reads it on the host; a request's time to first token runs from when its
batch was due to then.  The caches of ``cache_checked_batches`` batches
picked by the seed among the first ``cache_pick_from`` are copied to the
host for the check, so that the device's peak holds only what the program
allocates, and the next batch is due once that copy has ended; the other
caches are freed.

The check draws ``checked_batches`` batches of the window by the seed (the
kept ones among them) and runs the reference over each once (numbers in
``compare.py``)."""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import compare, tokens
from ..reference import _common as ref


def _batch(run, index: int) -> tuple:
    """Prefills batch ``index``: (served tokens on the host, the cache, the
    data seconds)."""
    from repro_torch.data.pipeline import shard_batch
    tr, B = run.traffic, run.traffic["batch"]
    t0 = time.perf_counter()
    with record_function("portbench.data"):
        p = tokens.prompts(run.seed, index, tr, run.c["vocab"])
        if run.fault == "half_batch":  # the rest answered from these rows
            p = p[:B // 2]
        batch = shard_batch({"tokens": p}, run.device)
    t1 = time.perf_counter()
    with record_function("portbench.step"):
        logits, cache = run.step(run.model, batch)
        first = logits[:, -1].argmax(dim=-1)
    with record_function("portbench.read"):
        served = first.cpu().numpy()
    if run.fault == "half_batch":
        served = np.concatenate([served, served])[:B]
    if run.fault == "token_altered":
        served = served.copy()
        served[0] = (served[0] + 1) % run.c["vocab"]
    return served, cache, t1 - t0


def setup(run) -> None:
    from repro_torch.models.lm import LM
    from repro_torch.models.params import unflatten
    from repro_torch.models.steps import make_prefill_step
    tr = run.traffic
    run.model = LM(run.cfg, unflatten({
        s[0]: ref.make_leaf(s, run.seed, run.device) for s in run.specs}))
    run.step = make_prefill_step(run.cfg, cache_len=tr["cache_len"])
    pick = np.random.default_rng([run.seed, 7])
    run.cache_keep = sorted(int(i) for i in pick.choice(
        tr["cache_pick_from"], tr["cache_checked_batches"], replace=False))
    run.kept, run.served = {}, []
    with torch.inference_mode():
        for i in range(tr["warmup_batches"]):
            _batch(run, -1 - i)


def _keep(cache, fault) -> dict:
    """A host copy of a batch's cache."""
    from repro_torch.models.params import flatten
    flat = flatten(cache)
    if fault == "unchanged":  # the cache never written
        flat = {k: torch.zeros_like(v) for k, v in flat.items()}
    return {k: v.to("cpu", copy=True) for k, v in flat.items()}


def window(run, seconds: float) -> None:
    tr, B = run.traffic, run.traffic["batch"]
    data_s, latencies, failed = [], [], 0
    index = 0
    t0 = due = time.perf_counter()
    with torch.inference_mode():
        while True:
            served, cache, d = _batch(run, index)
            t = time.perf_counter()
            latencies += [t - due] * B
            data_s.append(d)
            failed += int(((served < 0) | (served >= run.c["vocab"])).sum())
            run.served.append(served)
            if index in run.cache_keep:
                run.kept[index] = _keep(cache, run.fault)
                t = time.perf_counter()
            del cache
            index += 1
            due = t
            if t - t0 >= seconds and index > max(run.cache_keep):
                break
    run.window = {"kind": "prefill", "units": index, "seconds": t - t0,
                  "tokens": index * B * tr["prompt_len"], "batch": B,
                  "seq": tr["prompt_len"], "data_s": data_s,
                  "latencies_s": latencies, "attempted": index * B,
                  "failed": failed}


def profiled_units(run) -> int:
    return run.traffic["profile_batches"]


def unit(run) -> None:
    """One more batch after the window's, never one the check reads."""
    run.extra = getattr(run, "extra", 0) + 1
    with torch.inference_mode():
        _batch(run, run.window["units"] + run.extra)


def release(run) -> None:
    del run.model, run.step


def sample(run) -> list:
    """The batches the check compares: the kept caches' and more drawn by
    the seed from the window's, ``checked_batches`` in all."""
    n = run.window["units"]
    others = [i for i in range(n) if i not in run.cache_keep]
    want = min(len(others), run.traffic["checked_batches"]
               - len(run.cache_keep))
    rng = np.random.default_rng([run.seed, 11])
    drawn = rng.choice(others, want, replace=False) if want > 0 else []
    return sorted(set(run.cache_keep) | {int(i) for i in drawn})


def reference_weights(run) -> dict:
    return {s[0]: ref.make_leaf(s, run.seed, run.device) for s in run.specs}


def reference_logits(run, flat: dict, index: int, precision: str,
                     want_cache: bool) -> dict:
    p = tokens.prompts(run.seed, index, run.traffic, run.c["vocab"])
    tok = torch.from_numpy(np.ascontiguousarray(p)).to(run.device)
    return ref.prefill(run.family, run.c, flat, tok, precision, want_cache)


def _steady(values, stat) -> float:
    values = list(values)
    return float(stat(values)) if np.isfinite(values).all() else float("inf")


def check(run) -> dict:
    flat = reference_weights(run)
    gaps, errs = [], []
    for i in sample(run):
        out = reference_logits(run, flat, i, "f32", i in run.kept)
        gaps += compare.served_gaps(out["logits"], run.served[i]).tolist()
        if i in run.kept:
            errs += compare.cache_errors(run.kept[i], out["cache"])
        del out
    run.check_detail = {"gaps": gaps, "cache_errs": errs}
    return {"logit_gap_mean": _steady(gaps, np.mean),
            "cache_err_median": _steady(errs, np.median),
            "cache_err_max": _steady(errs, np.max)}
