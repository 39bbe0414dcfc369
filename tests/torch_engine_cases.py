"""The cases on which ``tests/test_torch_engine.py`` (f32) and
``tests/test_torch_engine_x64.py`` (f64) hold the port's fleet-scale packer
(``engine="torch:cpu"``: ``core/engine_torch.py`` over the plain version of
the packing pass, ``kernels/pack_fill/ref.py``) against the JAX package's
``engine="jax"``: those of ``tests/test_engines.py``'s ``test_jax_*`` and of
``tests/test_incremental.py::test_incremental_jax_engine_matches_numpy``,
and fleets of multi-task jobs against the numpy engine.  ``precision`` is
"f32" or "f64"; the caller sets both packages' dtype.

- f32: the canonical partition (each instance's type with its sorted task
  ids, the list sorted) is equal where interference is off; with
  interference on, the hourly cost agrees to 1e-6 relative and every task
  is placed exactly once (``test_jax_matches_numpy``'s standard);
- f64: the canonical partition is equal.

Every task is made with an explicit id, so the reference's process-wide id
counters do not move.
"""
import importlib
import types

import numpy as np
import pytest

from repro.core.catalog import FAMILIES
from repro.core.workloads import NUM_WORKLOADS


def counters():
    """The reference's process-wide id counters, as text."""
    from repro.cluster import traces
    from repro.core import cluster_types
    return (repr(traces._job_ids), repr(traces._task_ids),
            repr(cluster_types._task_counter))


def _pkg(name):
    core = importlib.import_module(name + ".core")
    return types.SimpleNamespace(
        core=core, catalog=importlib.import_module(name + ".core.catalog"),
        Task=importlib.import_module(name + ".core.cluster_types").Task)


JAX, PORT = _pkg("repro"), _pkg("repro_torch")


def tasks_of(pkg, workloads, jobs=None, start=0):
    jobs = range(start, start + len(workloads)) if jobs is None else jobs
    return pkg.core.TaskSet([
        pkg.core.make_task(job_id=int(j), workload=int(w), task_id=start + i)
        for i, (j, w) in enumerate(zip(jobs, workloads))])


def table_of(pkg, seed, default):
    rng = np.random.default_rng(seed)
    t = pkg.core.ThroughputTable(NUM_WORKLOADS, default=default)
    for _ in range(25):
        w1, w2 = rng.integers(NUM_WORKLOADS, size=2)
        t.record(int(w1), (int(w2),), float(rng.uniform(0.7, 1.0)))
    return t


def _random_catalog(pkg, seed):
    """``tests/test_engines.py::_random_catalog``: continuous costs, random
    sizes, anchored by the three largest AWS types."""
    rng = np.random.default_rng(seed)
    types_ = [t for t in pkg.catalog.AWS_CATALOG
              if t.name in ("p3.16xlarge", "c7i.24xlarge", "r7i.24xlarge")]
    for i in range(int(rng.integers(6, 12))):
        fam = FAMILIES[int(rng.integers(len(FAMILIES)))]
        if fam == "p3":
            gpu = float(rng.integers(1, 9))
            cap = (gpu, 8.0 * gpu, 61.0 * gpu)
        else:
            cpu = float(2 ** rng.integers(1, 7))
            cap = (0.0, cpu, cpu * (2.0 if fam == "c7i" else 8.0))
        types_.append(pkg.core.InstanceType(f"rnd-{seed}-{i}", fam, cap,
                                            float(rng.uniform(0.05, 30.0))))
    return pkg.core.Catalog.from_types(types_)


def canon(cfg):
    return sorted((int(k), tuple(sorted(int(t) for t in ts)))
                  for k, ts in cfg.assignments)


def _covers(cfg, tasks):
    return sorted(int(t) for _, ts in cfg.assignments for t in ts) == \
        sorted(tasks.ids.tolist())


def _compare(precision, jx, pt, cat, tasks, interference, cost_cat=None):
    """The port's configuration ``pt`` against the JAX engine's ``jx``."""
    if precision == "f64" or not interference:
        assert canon(pt) == canon(jx)
    else:
        cost_cat = cat if cost_cat is None else cost_cat
        assert pt.total_hourly_cost(cost_cat) == pytest.approx(
            jx.total_hourly_cost(cost_cat), rel=1e-6)
        assert _covers(pt, tasks) and _covers(jx, tasks)


def _both(case, **kw):
    """One case in both packages: (jax config, port config, port catalog,
    port tasks)."""
    out = []
    for pkg, engine in ((JAX, "jax"), (PORT, "torch:cpu")):
        tasks, cat, table, extra = case(pkg)
        out.append((pkg.core.full_reconfiguration(
            tasks, cat, table, engine=engine, **extra, **kw), cat, tasks))
    (jx, _, _), (pt, cat, tasks) = out
    return jx, pt, cat, tasks


def check_seeded(precision, seed, interference):
    workloads = np.random.default_rng(seed).integers(NUM_WORKLOADS, size=50)

    def case(pkg):
        return (tasks_of(pkg, workloads, start=1000 * seed), pkg.core.aws_catalog(),
                table_of(pkg, seed, 0.97) if interference else None, {})
    jx, pt, cat, tasks = _both(case, interference_aware=interference,
                               multi_task_aware=True)
    _compare(precision, jx, pt, cat, tasks, interference)


def check_random_catalog(precision, seed):
    workloads = np.random.default_rng(seed).integers(NUM_WORKLOADS, size=45)

    def case(pkg):
        return (tasks_of(pkg, workloads, start=1000 * seed),
                _random_catalog(pkg, seed), None, {})
    jx, pt, cat, tasks = _both(case, interference_aware=False,
                               multi_task_aware=True)
    _compare(precision, jx, pt, cat, tasks, False)


def check_type_mask(precision):
    """The GPU family masked out, as ``test_jax_type_mask_matches_numpy``."""
    cat0 = PORT.core.aws_catalog()
    mask = np.array([t.family != "p3" for t in cat0.types])
    cpu_ok = []
    for w in range(NUM_WORKLOADS):
        one = tasks_of(PORT, [w])
        try:
            if np.isfinite(PORT.core.reservation_prices(one, cat0,
                                                        type_mask=mask)[0]):
                cpu_ok.append(w)
        except ValueError:  # fits no unmasked type
            pass
    rng = np.random.default_rng(5)
    workloads = [int(rng.choice(cpu_ok)) for _ in range(30)]

    def case(pkg):
        return (tasks_of(pkg, workloads, start=7000), pkg.core.aws_catalog(),
                None, {"type_mask": mask})
    jx, pt, cat, tasks = _both(case, interference_aware=False,
                               multi_task_aware=True)
    _compare(precision, jx, pt, cat, tasks, False)
    assert all(mask[k] for k, _ in pt.assignments)


def check_region_caps(precision):
    """Region caps on the dispersed three-region market, as
    ``test_jax_region_caps_match_numpy``; the budget each region spends is
    the reference's."""
    workloads = np.random.default_rng(9).integers(NUM_WORKLOADS, size=35)

    def case(pkg):
        cat = pkg.core.multi_region_catalog(
            pkg.core.dispersed_demo_regions(3)).at(3600.0)
        return (tasks_of(pkg, workloads, start=8000), cat, None,
                {"region_caps": [3, None, 4]})
    jx, pt, cat, tasks = _both(case, interference_aware=False,
                               multi_task_aware=True)
    _compare(precision, jx, pt, cat, tasks, False)
    for cfg in (jx, pt):
        per_region = np.bincount([cat.region_of(k) for k, _ in cfg.assignments],
                                 minlength=3)
        assert per_region[0] <= 3 and per_region[2] <= 4


def check_table3(precision):
    specs = [(2, 8, 24), (1, 4, 10), (0, 6, 20), (0, 4, 12)]

    def case(pkg):
        ts = pkg.core.TaskSet([pkg.Task(i, i, i, {"p3": tuple(map(float, s))})
                               for i, s in enumerate(specs)])
        return ts, pkg.core.table3_catalog(), None, {}
    jx, pt, cat, tasks = _both(case, interference_aware=False,
                               multi_task_aware=False)
    _compare(precision, jx, pt, cat, tasks, False)
    assert pt.total_hourly_cost(cat) == pytest.approx(12.8)


def check_incremental(precision):
    """``test_incremental_jax_engine_matches_numpy``'s fleet (40 single-task
    jobs, seed 3, planned by the numpy engine): two dirty instances, one
    evacuated, repacked by each package's engine."""
    rng = np.random.default_rng(3)
    workloads = [int(rng.integers(NUM_WORKLOADS)) for _ in range(40)]
    got = []
    for pkg, engine in ((JAX, "jax"), (PORT, "torch:cpu")):
        tasks = tasks_of(pkg, workloads, start=30_000)
        cat = pkg.core.aws_catalog()
        kw = dict(interference_aware=False, multi_task_aware=True)
        plan = pkg.core.full_reconfiguration(tasks, cat, None, engine="numpy",
                                             **kw)
        live = tuple(pkg.core.LiveInstance(i, k, tuple(t))
                     for i, (k, t) in enumerate(plan.assignments))
        dirty, evac = {live[0].instance_id, live[1].instance_id}, \
            {live[0].instance_id}
        cfg, fallback = pkg.core.incremental_reconfiguration(
            tasks, live, dirty, set(), cat, None, evacuate=evac, engine=engine,
            **kw)
        assert fallback is None
        got.append(canon(cfg))
    assert got[0] == got[1]


def fleet_arrays(seed, n=200, job_sizes=(1,)):
    """(tasks, catalog, rp, job rp) of a random fleet of jobs whose sizes are
    drawn from ``job_sizes``, in the port, on the AWS catalog."""
    rng = np.random.default_rng(seed)
    workloads, jobs, j = [], [], 0
    while len(workloads) < n:
        w = int(rng.integers(NUM_WORKLOADS))
        for _ in range(int(rng.choice(job_sizes))):
            workloads.append(w)
            jobs.append(j)
        j += 1
    tasks = tasks_of(PORT, workloads[:n], jobs[:n], start=50_000)
    cat = PORT.core.aws_catalog()
    rp = PORT.core.reservation_prices(tasks, cat)
    return tasks, cat, rp, PORT.core.job_rp_sums(tasks, rp)


def check_varied_keys(precision):
    """Multi-task jobs: each job's tasks share its RP sum, so keys vary
    within a workload.  The reference's class collapse cannot unpack
    ``np.unique``'s result there; the port's matches the numpy engine
    (f64: the canonical partition; f32: the cost to 1e-6 and coverage)."""
    for seed, interference in ((1, False), (2, True)):
        tasks, cat, _, _ = fleet_arrays(seed, n=120, job_sizes=(1, 2, 3, 4))
        table = table_of(PORT, seed, 0.95) if interference else None
        kw = dict(interference_aware=interference, multi_task_aware=True)
        np_cfg = PORT.core.full_reconfiguration(tasks, cat, table,
                                                engine="numpy", **kw)
        pt = PORT.core.full_reconfiguration(tasks, cat, table,
                                            engine="torch:cpu", **kw)
        _compare(precision, np_cfg, pt, cat, tasks, True)
        ref_tasks = tasks_of(JAX, tasks.workloads.tolist(),
                           tasks.job_ids.tolist(), start=50_000)
        with pytest.raises(ValueError, match="not enough values to unpack"):
            JAX.core.full_reconfiguration(
                ref_tasks, JAX.core.aws_catalog(),
                table_of(JAX, seed, 0.95) if interference else None,
                engine="jax", **kw)
