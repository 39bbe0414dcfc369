"""Training: one job's closed loop of AdamW steps, each started when the
last has ended, as ``repro_torch.launch.train`` runs them.

Set-up makes the weights on the device from the seed, builds the train
state and the program's step (``models.steps.make_train_step``), and drives
it through the first ``checked_steps`` steps with the window's own call and
feed; those are the warm-up, and what they leave is read for the check:
each step's loss, each parameter's first gradient as the optimizer took it
(its first moment after one step over 1 - b1) and each parameter's change
(against the weights made again from the seed).  The window then runs
steps until ``seconds`` have passed, each on its own batch of the seed,
and reads each loss on the host as the launcher does.  Step i's batch is
``tokens.train_batch(seed, i)``: rows that all differ.

Once the window (and any profiled stretch) has ended, ``release`` copies
the program's parameters and moments to the host and drives
``late_steps`` more steps through the same call, as warm as the window's
last: their losses, first gradient (from the first moment's change) and
change are read the same way, and the reference takes those steps from the
host copy.  So a path that the program takes only after its first steps is
checked too; the start is checked from the seed's own weights."""
from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from .. import compare, tokens
from ..reference import _common as ref


def _sync(run) -> None:
    if str(run.device).startswith("cuda"):
        torch.cuda.synchronize()


def _faulty(step_fn, fault, warm: int):
    """The program's step, broken as ``fault`` says (the tests' faults);
    "unchanged_when_warm" leaves the state unchanged from step ``warm`` on,
    as a path taken only after the first steps could."""
    if fault in ("unchanged", "unchanged_when_warm"):
        import copy
        calls = [0]

        def step(state, batch):
            calls[0] += 1
            if fault == "unchanged_when_warm" and calls[0] <= warm:
                return step_fn(state, batch)
            _, metrics = step_fn(copy.deepcopy(state), batch)
            return state, metrics
        return step
    if fault == "loss_altered":
        def step(state, batch):
            state, metrics = step_fn(state, batch)
            return state, dict(metrics, loss=metrics["loss"] + 1.0)
        return step
    return step_fn


def _step(run) -> tuple:
    """One step through the window's call: (loss on the host, data seconds)."""
    from repro_torch.data.pipeline import shard_batch
    t0 = time.perf_counter()
    with record_function("portbench.data"):
        batch = tokens.train_batch(run.seed, run.next_index, run.traffic,
                                   run.c["vocab"])
        if run.fault == "half_batch":  # the mean over the rest
            batch = {k: v[:len(v) // 2] for k, v in batch.items()}
        batch = shard_batch(batch, run.device)
    t1 = time.perf_counter()
    with record_function("portbench.step"):
        run.state, metrics = run.step_fn(run.state, batch)
    with record_function("portbench.read"):
        loss = float(metrics["loss"])
        _sync(run)
    run.next_index += 1
    return loss, t1 - t0


def setup(run) -> None:
    from repro_torch.models.params import flatten, unflatten
    from repro_torch.models.steps import make_train_step
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    tr = run.traffic
    params = unflatten({s[0]: ref.make_leaf(s, run.seed, run.device)
                        for s in run.specs})
    run.state = {"params": params, "opt": init_opt_state(params)}
    run.step_fn = _faulty(make_train_step(run.cfg, OptConfig(**tr["opt"])),
                          run.fault, tr["checked_steps"])
    run.next_index = 0
    losses, first = [], None
    for i in range(tr["checked_steps"]):
        losses.append(_step(run)[0])
        if i == 0:
            keep = 1.0 - tr["opt"]["b1"]
            first = {k: float(torch.linalg.vector_norm(m)) / keep
                     for k, m in flatten(run.state["opt"]["m"]).items()}
    now = flatten(run.state["params"])
    change = {}
    with torch.no_grad():
        for s in run.specs:
            p0 = ref.make_leaf(s, run.seed, run.device)
            change[s[0]] = float(torch.linalg.vector_norm(now[s[0]] - p0))
            del p0
    run.readings = {"losses": losses, "grad_norms": first,
                    "change_norms": change}
    _sync(run)


def window(run, seconds: float) -> None:
    tr = run.traffic
    data_s, failed, steps = [], 0, 0
    t0 = time.perf_counter()
    while True:
        loss, d = _step(run)
        steps += 1
        data_s.append(d)
        failed += not math.isfinite(loss)
        t = time.perf_counter()
        if t - t0 >= seconds:
            break
    run.window = {"kind": "train", "units": steps, "seconds": t - t0,
                  "tokens": steps * tr["batch"] * tr["seq"],
                  "batch": tr["batch"], "seq": tr["seq"],
                  "data_s": data_s, "latencies_s": None,
                  "attempted": steps, "failed": failed}


def profiled_units(run) -> int:
    return run.traffic["profile_steps"]


def unit(run) -> None:
    _step(run)


def _host(tree) -> dict:
    from repro_torch.models.params import flatten
    return {k: t.detach().to("cpu", copy=True)
            for k, t in flatten(tree).items()}


def _late(run) -> None:
    """The late steps after the window, from a host copy of the state."""
    from repro_torch.models.params import flatten
    _sync(run)
    opt = run.state["opt"]
    start = {"params": _host(run.state["params"]), "m": _host(opt["m"]),
             "v": _host(opt["v"]), "step": run.next_index}
    first = run.next_index
    losses = [_step(run)[0] for _ in range(run.traffic["late_steps"])]
    b1 = run.traffic["opt"]["b1"]
    grads, change = {}, {}
    with torch.no_grad():
        for k, m in flatten(run.state["opt"]["m"]).items():
            m0 = start["m"][k].to(m.device)
            grads[k] = float(torch.linalg.vector_norm(m - b1 * m0)) / (1 - b1)
        for k, p in flatten(run.state["params"]).items():
            p0 = start["params"][k].to(p.device)
            change[k] = float(torch.linalg.vector_norm(p - p0))
    del m0, p0
    run.late = {"start": start, "first": first,
                "readings": {"losses": losses, "grad_norms": grads,
                             "change_norms": change}}


def release(run) -> None:
    _late(run)
    del run.state, run.step_fn


def reference_batches(run, first: int, count: int) -> list:
    out = []
    for i in range(first, first + count):
        b = tokens.train_batch(run.seed, i, run.traffic, run.c["vocab"])
        out.append({k: torch.from_numpy(np.ascontiguousarray(v))
                    .to(run.device) for k, v in b.items()})
    return out


def reference(run, precision: str) -> dict:
    """The reference's readings of the checked steps from the seed's
    weights, and of the late steps from the program's host copy."""
    tr, late = run.traffic, run.late
    args = (run.family, run.c, run.specs, run.seed)
    early = ref.train(*args, reference_batches(run, 0, tr["checked_steps"]),
                      tr["opt"], precision, run.device)
    return early, ref.train(*args, reference_batches(
        run, late["first"], tr["late_steps"]), tr["opt"], precision,
        run.device, start=late["start"])


def compared(run, early: dict, late: dict) -> dict:
    """The check's numbers for readings (the program's, or the reference's
    in its place) against the f32 reference's, early and late."""
    out = compare.train(early, run.ref32[0])
    out.update({"late_" + k: v for k, v in
                compare.train(late, run.ref32[1]).items()})
    return out


def check(run) -> dict:
    run.ref32 = reference(run, "f32")
    return compared(run, run.readings, run.late["readings"])
