"""The readings that a cell's limits are set from, on the chip, at the
cell's own size, in one process (the benchmark's runs never run this):

    python3 portbench/calibrate.py --workload granite-moe-3b-a800m.train \
        --seeds 1,2,3 --control-seeds 4,5,6 [--faults half_batch] \
        [--seconds 30] [--precisions fp8,bf16] [--detail]

For each of ``--seeds``: the program as a run drives it (set-up, a window
of ``--seconds``, for training the late steps), then the check's numbers
against the f32 reference.  For each of ``--control-seeds``: the control,
the reference computed in fp8 put in the program's place, read by the same
numbers (for prefill: the gap of the token the fp8 reference puts first,
and its cache, on the same prompts; for training the late steps start from
the state of a program run, whose own numbers are read too), and each of
``--faults`` planted in the program's timed path.  ``--precisions`` reads
the reference in bf16 as well; ``--detail`` adds what the numbers were
taken from (each step's loss, each parameter's norms, each layer's cache
error).  One JSON line a reading on standard output."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free():
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def program(harness, name, seed, seconds, fault=None, device="cuda",
            detail=None, **overrides) -> dict:
    """The check's numbers for the program's run; with a dict ``detail``,
    what they were taken from is put there."""
    run = harness.new_run(name, seed, device, fault=fault, **overrides)
    harness.measure(run, seconds, False, time.perf_counter())
    values = run.loop.check(run)
    if detail is not None:
        detail.update(_detail(run))
    del run
    _free()
    return values


def _detail(run) -> dict:
    if run.traffic["kind"] == "train":
        return {"program": run.readings, "late": run.late["readings"],
                "reference": run.ref32}
    return getattr(run, "check_detail", {})


def control(harness, name, seed, seconds=5.0, device="cuda",
            precisions=("fp8",), detail=None, **overrides) -> dict:
    """{precision: the check's numbers for the reference in that precision
    put in the program's place}; for training also {"program": the
    program's numbers} of the run whose state the late steps start from."""
    import numpy as np
    from portbench import compare
    run = harness.new_run(name, seed, device, **overrides)
    out = {}
    if run.traffic["kind"] == "train":
        harness.measure(run, seconds, False, time.perf_counter())
        out["program"] = run.loop.check(run)
        if detail is not None:
            detail.update(_detail(run))
        _free()
        for p in precisions:
            low = run.loop.reference(run, p)
            _free()
            out[p] = run.loop.compared(run, *low)
            if detail is not None:
                detail[p] = low
        return out
    drv, tr = run.loop, run.traffic
    flat = drv.reference_weights(run)
    gaps = {p: [] for p in precisions}
    errs = {p: [] for p in precisions}
    for i in range(tr["checked_batches"]):
        want = i < tr["cache_checked_batches"]
        ref32 = drv.reference_logits(run, flat, i, "f32", want)
        for p in precisions:
            low = drv.reference_logits(run, flat, i, p, want)
            gaps[p] += compare.served_gaps(
                ref32["logits"], low["logits"].argmax(-1).cpu().numpy()
            ).tolist()
            if want:
                errs[p] += compare.cache_errors(low["cache"], ref32["cache"])
            del low
        del ref32
    del flat
    _free()
    for p in precisions:
        out[p] = {"logit_gap_mean": float(np.mean(gaps[p])),
                  "cache_err_median": float(np.median(errs[p])),
                  "cache_err_max": float(np.max(errs[p]))}
        if detail is not None:
            detail[p] = {"gaps": gaps[p], "cache_errs": errs[p]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--precisions", default="fp8",
                    choices=("fp8", "fp8,bf16"))
    ap.add_argument("--detail", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    faults = [f for f in args.faults.split(",") if f]
    precisions = tuple(p for p in args.precisions.split(",") if p)
    head = {"workload": args.workload, "device": torch.cuda.get_device_name(0)}

    def emit(**kw):
        print(json.dumps(dict(head, **kw)), flush=True)

    for seed in seeds:
        t = time.perf_counter()
        d = {} if args.detail else None
        v = program(harness, args.workload, seed, args.seconds, detail=d)
        emit(seed=seed, reading="program", values=v, detail=d,
             seconds=time.perf_counter() - t)
    for seed in controls:
        t = time.perf_counter()
        d = {} if args.detail else None
        v = control(harness, args.workload, seed, args.seconds,
                    precisions=precisions, detail=d)
        for p, vals in v.items():
            reading = "program" if p == "program" else f"control_{p}"
            emit(seed=seed, reading=reading, values=vals,
                 seconds=time.perf_counter() - t)
        if d is not None:
            emit(seed=seed, reading="control_detail", detail=d)
        for fault in faults:
            t = time.perf_counter()
            v = program(harness, args.workload, seed, args.seconds, fault)
            emit(seed=seed, reading=f"fault_{fault}", values=v,
                 seconds=time.perf_counter() - t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
