"""One run of one cell: set-up, the measured window, the traced stretch,
the check of what the window produced, and the result line.

Everything that belongs to one cell is found by name, so that a later cell,
configuration, traffic mix, model family or metric is new files and new
entries in ``BENCHMARK.json``, with no edit here:

    configs/<config>.json     the configuration as run ("config"), its
                              "arch" in the program's registry, its
                              "family", source and cuts
    traffic/<traffic>.json    the traffic's parameters; its "kind" names
                              the loop, loops/<kind>.py
    reference/<family>.py     the family's plain reference ("layout",
                              "block")
    metrics/<metric>.py       the reader of one metric ("read(run)")
    limits/<cell>.json        the limit of each number the check compares

The loop of a kind has ``setup``, ``window``, ``unit`` (one more step
or batch, for the profiled stretch), ``profiled_units``, ``release`` and
``check`` (see ``loops/train.py``).  The program is imported from
``repro_torch`` alone; a run that finds JAX or the JAX package loaded after
its window fails.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import sys
import time
import types
from pathlib import Path

from . import trace as tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class BenchError(RuntimeError):
    pass


def load(sub: str, name: str) -> dict:
    path = HERE / sub / f"{name}.json"
    if not path.exists():
        raise BenchError(f"no {sub} file {path.name} under {HERE.name}/{sub}")
    return json.loads(path.read_text())


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_of(name: str) -> dict:
    for cell in benchmark()["workloads"]:
        if cell["name"] == name:
            return cell
    raise BenchError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(name: str, section: str) -> list:
    """The metrics of ``section`` that cell ``name`` reports."""
    return [m for m in benchmark()[section]
            if name in m.get("workloads", [name])]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def program_config(arch: str, c: dict):
    """The program's configuration object: its registry entry with every
    number of the configuration file put in."""
    from repro_torch.configs import ARCHS
    fields = {f.name for f in dataclasses.fields(ARCHS[arch])}
    unknown = sorted(set(c) - fields)
    if unknown:
        raise BenchError(f"configuration keys the program lacks: {unknown}")
    return dataclasses.replace(ARCHS[arch], **c)


def check_layout(cfg, specs: list) -> None:
    """The reference's parameter layout is the program's, key for key and
    shape for shape."""
    from repro_torch.models.lm import model_defs
    from repro_torch.models.params import flatten
    prog = {k: tuple(d.shape) for k, d in flatten(model_defs(cfg)).items()}
    mine = {s[0]: tuple(s[1]) for s in specs}
    if prog != mine:
        raise BenchError(f"parameter layouts differ: program {prog}, "
                         f"reference {mine}")


def new_run(name: str, seed: int, device: str, config: dict = None,
            traffic: dict = None, fault: str = None):
    """The run's state: its cell, configuration, traffic, family, loop and
    parameter layout.  ``config`` and ``traffic`` override the files' values
    and ``fault`` breaks the timed path (the tests' use)."""
    cell = cell_of(name)
    conf = load("configs", cell["config"])
    c = dict(conf["config"], **(config or {}))
    tr = dict(load("traffic", cell["traffic"]), **(traffic or {}))
    family = importlib.import_module(f"portbench.reference.{conf['family']}")
    loop = importlib.import_module(f"portbench.loops.{tr['kind']}")
    cfg = program_config(conf["arch"], c)
    specs = family.layout(c)
    check_layout(cfg, specs)
    return types.SimpleNamespace(
        name=name, cell=cell, conf=conf, c=c, cfg=cfg, traffic=tr,
        family=family, loop=loop, specs=specs, seed=int(seed),
        device=device, fault=fault,
        n_params=sum(math.prod(s[1]) for s in specs),
        trace=None, window=None, setup_s=None, memory_peak_bytes=None)


def _cuda(run) -> bool:
    return str(run.device).startswith("cuda")


def measure(run, seconds: float, trace: bool, t_start: float) -> None:
    """Set-up, the window and, with ``trace``, the profiled stretch after
    it; then the program's state is freed."""
    import torch
    run.loop.setup(run)
    if _cuda(run):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - t_start
    run.loop.window(run, seconds)
    run.memory_peak_bytes = torch.cuda.max_memory_allocated() \
        if _cuda(run) else 0
    if trace:
        run.trace = tracing.profile(lambda: run.loop.unit(run),
                                    run.loop.profiled_units(run))
    found = forbidden_modules()
    if found:
        raise BenchError(f"JAX or the JAX package is loaded: {found}")
    run.loop.release(run)
    gc.collect()
    if _cuda(run):
        torch.cuda.empty_cache()


def judge(run) -> tuple:
    """(correct, {number: (value, limit)}): what the window produced against
    the reference, each number within its limit."""
    limits = load("limits", run.name)
    values = run.loop.check(run)
    if set(values) != set(limits):
        raise BenchError(f"the check gives {sorted(values)}, the limits "
                         f"file {sorted(limits)}")
    checks = {k: (values[k], limits[k]) for k in sorted(limits)}
    correct = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    return correct and run.window["failed"] == 0, checks


def read_metrics(run, specs: list, required: bool) -> dict:
    out = {}
    for m in specs:
        reader = importlib.import_module(f"portbench.metrics.{m['name']}")
        value = reader.read(run)
        if value is None:
            if required:
                raise BenchError(f"metric {m['name']} read nothing")
            continue
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(run, correct: bool, checks: dict, trace: bool) -> dict:
    import torch
    metrics = read_metrics(run, metrics_of(run.name, "per_layer"), False) \
        if trace else read_metrics(run, metrics_of(run.name, "end_to_end"),
                                   True)
    cuda = _cuda(run)
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": run.cell["chips"],
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": bool(correct), "attempted": run.window["attempted"],
           "failed": run.window["failed"], "metrics": metrics,
           "device": device}
    if trace:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.wall_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", **overrides) -> dict:
    run = new_run(name, seed, device, **overrides)
    measure(run, seconds, trace, t_start)
    correct, checks = judge(run)
    return result(run, correct, checks, trace)
