"""The port's trace-driven simulator (``repro_torch.cluster``, verbatim
copies of ``repro.cluster``'s simulator, traces and fleet table) with its
baseline schedulers (``repro_torch.schedulers``), against the reference:

- every scheduler of ``examples/simulate_trace.py`` (No-Packing, Stratus,
  Synergy, Owl, Eva on the numpy engine) gives the same
  ``Metrics.summary()`` in both packages on a 40-job ``alibaba_like_trace``
  (seed 42, gavel durations; ``SimConfig(seed=1)``);
- Eva on the port's packer (``engine="torch:cpu"``, f64) runs that trace to
  the end, every job finished, and each of its packs places every task it
  was given exactly once;
- on a 20-job trace every one of those packs gives the numpy engine's set
  of (type, sorted task rows) on copies of the same inputs.  The rows'
  order within a record may differ (the port lists them class by class),
  and Eva's ensemble reads it: the full configuration's per-instance TNRP
  sums run in that order (``core/full_reconfig.py::evaluate_assignments``,
  called at ``core/scheduler.py:389``), so a near tie between the full and
  the partial reconfiguration may fall the other way and the two engines'
  bills differ (``tools/pack_order.py``).

Each trace is drawn with fresh id counters swapped into both packages'
``cluster.traces`` and ``core.cluster_types``, the originals put back, so
the two packages' ids agree and the reference's process-wide counters stay
where they were (checked after the file's tests).
"""
import contextlib
import importlib
import itertools

import pytest
import torch

import torch_engine_cases as cases

N_JOBS = 40


@pytest.fixture(autouse=True, scope="module")
def _reference_id_counters_untouched():
    before = cases.counters()
    yield
    assert cases.counters() == before


@contextlib.contextmanager
def _fresh_counters(pkg):
    traces = importlib.import_module(pkg + ".cluster.traces")
    cluster_types = importlib.import_module(pkg + ".core.cluster_types")
    saved = traces._job_ids, traces._task_ids, cluster_types._task_counter
    traces._job_ids, traces._task_ids = itertools.count(1), \
        itertools.count(1_000_000)
    cluster_types._task_counter = itertools.count()
    try:
        yield
    finally:
        traces._job_ids, traces._task_ids, cluster_types._task_counter = saved


def _simulate(pkg, scheduler, engine="numpy", n_jobs=N_JOBS):
    """One run of ``examples/simulate_trace.py``'s loop in package ``pkg``;
    returns its metrics and jobs."""
    cluster = importlib.import_module(pkg + ".cluster")
    core = importlib.import_module(pkg + ".core")
    baselines = importlib.import_module(pkg + ".schedulers")
    cat = core.aws_catalog()
    make = {"no-packing": lambda: core.NoPackingScheduler(cat),
            "stratus": lambda: baselines.StratusScheduler(cat),
            "synergy": lambda: baselines.SynergyScheduler(cat),
            "owl": lambda: baselines.OwlScheduler(cat, core.M_TRUE),
            "eva": lambda: core.EvaScheduler(cat, engine=engine)}[scheduler]
    with _fresh_counters(pkg):
        jobs = cluster.alibaba_like_trace(n_jobs=n_jobs, seed=42,
                                          duration_model="gavel")
        return cluster.Simulator(cat, jobs, make(),
                                 cluster.SimConfig(seed=1)).run(), jobs


@pytest.mark.parametrize("scheduler", ["no-packing", "stratus", "synergy",
                                       "owl", "eva"])
def test_simulation_matches_reference(scheduler):
    ref, _ = _simulate("repro", scheduler)
    port, jobs = _simulate("repro_torch", scheduler)
    assert port.summary() == ref.summary()
    assert ref.total_cost > 0
    assert all(j.completion_time is not None for j in jobs)


def test_eva_on_the_torch_packer_runs_the_trace(monkeypatch):
    from repro_torch.core import engine_torch
    packs = []
    real = engine_torch.pack_torch

    def checked(*args, device):
        out = real(*args, device=device)
        rows = sorted(r for _, rs in out for r in rs)
        packs.append(rows == list(range(args[0].shape[0])))
        return out
    monkeypatch.setattr(engine_torch, "pack_torch", checked)
    torch.set_default_dtype(torch.float64)
    try:
        m, jobs = _simulate("repro_torch", "eva", engine="torch:cpu")
    finally:
        torch.set_default_dtype(torch.float32)
    assert len(jobs) == N_JOBS and m.total_cost > 0
    assert all(j.completion_time is not None for j in jobs)
    assert packs and all(packs)


def test_torch_packs_are_the_numpy_engines_sets(monkeypatch):
    from repro_torch.core import engine_torch
    from repro_torch.core.full_reconfig import _pack_numpy
    same = []
    real = engine_torch.pack_torch

    def compared(*args, device):
        copy = list(args) + [None] * (8 - len(args))
        if copy[7] is not None:  # the packers spend the budget in place
            copy[7] = copy[7].copy()
        out = real(*args, device=device)
        same.append(sorted((k, sorted(r)) for k, r in out)
                    == sorted((k, sorted(r)) for k, r in _pack_numpy(*copy)))
        return out
    monkeypatch.setattr(engine_torch, "pack_torch", compared)
    torch.set_default_dtype(torch.float64)
    try:
        _, jobs = _simulate("repro_torch", "eva", engine="torch:cpu",
                            n_jobs=20)
    finally:
        torch.set_default_dtype(torch.float32)
    assert all(j.completion_time is not None for j in jobs)
    assert same and all(same), f"{same.count(False)} of {len(same)} packs"
