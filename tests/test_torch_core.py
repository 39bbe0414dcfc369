"""The port's copy of Eva's scheduling core (``repro_torch.core``, ``obs``,
``policies``, ``autoscale``, ``cluster``, ``schedulers``) against the
reference package.

- Each copied file reads as its original, apart from the engine table of
  ``core/full_reconfig.py``, which in the port packs with ``engine="torch"``
  (``core/engine_torch.py``) and has no JAX engine.  The port's own files
  there are ``core/engine_torch.py`` and ``cluster/localcloud.py``.
- The paper's worked examples (Table 3, the §4.2 walkthrough) hold on the
  port.
- Seeded multi-round scenarios, in which tasks arrive and leave, each
  package's configuration is fed back to it as the live view and
  co-location throughputs are reported, give the same assignments and the
  same migration plan round by round in both packages, on the AWS catalog
  and on the physical mode's local catalog, in every mode and with
  incremental reaction rounds under spot revocations.

Every task is made with an explicit id, so the reference's process-wide id
counters stay where they were (checked after the file's tests).
"""
import importlib
import pathlib
import types

import numpy as np
import pytest

from repro_torch.core import (EvaScheduler, TaskSet, full_reconfiguration,
                              reservation_prices, table3_catalog)
from repro_torch.core.cluster_types import Task

REPO = pathlib.Path(__file__).resolve().parents[1]
COPIED = (
    [f"core/{m}.py" for m in (
        "__init__", "catalog", "cluster_types", "ensemble", "full_reconfig",
        "partial_reconfig", "plan", "reservation_price", "scheduler",
        "serving", "throughput_table", "workloads")]
    + [f"obs/{m}.py" for m in (
        "__init__", "events", "metrics", "profiler", "recorder", "report",
        "trace")]
    + [f"policies/{m}.py" for m in (
        "__init__", "base", "layers", "portfolio", "pressure", "slo",
        "stability")]
    + [f"autoscale/{m}.py" for m in ("__init__", "admission", "forecast")]
    + [f"core/{m}.py" for m in ("hetero", "ilp")]
    + [f"cluster/{m}.py" for m in ("__init__", "fleet", "simulator", "traces")]
    + [f"schedulers/{m}.py" for m in (
        "__init__", "common", "no_packing", "owl", "stratus", "synergy")])
PORT_ONLY = ["core/engine_torch.py", "cluster/localcloud.py"]
# The one place the copy differs: the port packs with its own engine.
ENGINE_TABLE = {
    "repro": '''    if engine == "jax":
        from .engine_jax import pack_jax
        packer = pack_jax
    else:
        packer = {"python": _pack_python, "numpy": _pack_numpy}[engine]
''',
    "repro_torch": '''    if engine == "jax":
        raise ValueError("engine='jax': the port packs with engine='torch' "
                         "(on the card) or engine='torch:cpu'")
    elif engine in ("torch", "torch:cpu"):
        from .engine_torch import pack_torch
        device = "cpu" if engine == "torch:cpu" else "cuda"

        def packer(*args):
            return pack_torch(*args, device=device)
    else:
        packer = {"python": _pack_python, "numpy": _pack_numpy}[engine]
'''}


@pytest.fixture(autouse=True, scope="module")
def _reference_id_counters_untouched():
    from repro.cluster import traces
    from repro.core import cluster_types

    def counters():
        return (repr(traces._job_ids), repr(traces._task_ids),
                repr(cluster_types._task_counter))

    before = counters()
    yield
    assert counters() == before


def test_the_copy_is_every_file_of_its_packages():
    port = REPO / "src" / "repro_torch"
    have = sorted(str(p.relative_to(port)) for d in (
        "core", "obs", "policies", "autoscale", "cluster", "schedulers")
                  for p in (port / d).glob("*.py"))
    assert have == sorted(COPIED + PORT_ONLY)


@pytest.mark.parametrize("rel", COPIED)
def test_copy_is_verbatim(rel):
    ref = (REPO / "src" / "repro" / rel).read_text()
    port = (REPO / "src" / "repro_torch" / rel).read_text()
    if rel == "core/full_reconfig.py":
        assert ref.count(ENGINE_TABLE["repro"]) == 1
        ref = ref.replace(ENGINE_TABLE["repro"], ENGINE_TABLE["repro_torch"])
    assert port == ref


def table3_tasks():
    # tau1..tau4 of Table 3(b): single-task jobs, workloads 0..3
    specs = [(2, 8, 24), (1, 4, 10), (0, 6, 20), (0, 4, 12)]
    return TaskSet([Task(task_id=i, job_id=i, workload=i,
                         demands={"p3": tuple(map(float, s))})
                    for i, s in enumerate(specs)])


def test_reservation_prices_match_table3():
    assert reservation_prices(table3_tasks(), table3_catalog()).tolist() == \
        [12.0, 3.0, 0.8, 0.4]


@pytest.mark.parametrize("engine", ["python", "numpy", "torch:cpu"])
def test_full_reconfiguration_walkthrough(engine):
    """§4.2: tau1, tau2, tau4 on it1, tau3 alone on it3; $12.8 an hour
    against $16.2 with no packing."""
    tasks, cat = table3_tasks(), table3_catalog()
    cfg = full_reconfiguration(tasks, cat, table=None,
                               interference_aware=False,
                               multi_task_aware=False, engine=engine)
    got = sorted((cat.types[k].name, tuple(sorted(tids)))
                 for k, tids in cfg.assignments)
    assert got == [("it1", (0, 1, 3)), ("it3", (2,))]
    assert cfg.total_hourly_cost(cat) == pytest.approx(12.8)
    assert reservation_prices(tasks, cat).sum() == pytest.approx(16.2)


def test_jax_engine_raises():
    """The port has no JAX engine; the error names its own."""
    with pytest.raises(ValueError, match="engine='torch'"):
        full_reconfiguration(table3_tasks(), table3_catalog(), table=None,
                             engine="jax")
    sched = EvaScheduler(table3_catalog(), engine="jax")
    from repro_torch.core import SchedulerView
    tasks = table3_tasks()
    view = SchedulerView(time=0.0, tasks=tasks, pending_ids=set(
        tasks.ids.tolist()), live=[], task_workload={i: i for i in range(4)})
    with pytest.raises(ValueError, match="engine='torch'"):
        sched.schedule(view)


# --- pick for pick over seeded multi-round scenarios -------------------------

LOCAL_TYPES = [("local.large", "c7i", (0, 4, 16), 1.0),
               ("local.small", "c7i", (0, 2, 8), 0.55),
               ("local.micro", "c7i", (0, 1, 4), 0.30)]
ROUNDS = 12


def _package(name):
    core = importlib.import_module(name + ".core")
    return types.SimpleNamespace(
        core=core,
        InstanceType=importlib.import_module(name + ".core.catalog").InstanceType,
        SpotLayer=importlib.import_module(name + ".policies").SpotLayer,
        PressureSignal=importlib.import_module(
            name + ".policies.pressure").PressureSignal)


def _catalog(pkg, which):
    if which == "aws":
        return pkg.core.aws_catalog()
    return pkg.core.Catalog.from_types([pkg.InstanceType(*t)
                                        for t in LOCAL_TYPES])


def _events(which, seed):
    """Per round: arrivals (task id, job id, workload, demand or None), the
    jobs that leave, throughput reports, and whether a live instance gets a
    spot revocation notice.  Plain data, replayed by both packages."""
    rng = np.random.default_rng(seed)
    n_work = 10
    next_tid, next_job, live_jobs, rounds = 0, 0, [], []
    for r in range(ROUNDS):
        n_new = (12 if which == "aws" else 4) if r == 0 else int(rng.integers(0, 4))
        arrivals = []
        for _ in range(n_new):
            size = int(rng.choice([1, 1, 1, 2, 4])) if which == "aws" else 1
            w = int(rng.integers(0, n_work))
            demand = None if which == "aws" else \
                (0.0, float(c := int(rng.integers(1, 3))), 4.0 * c)
            for _ in range(size):
                arrivals.append((next_tid, next_job, w, demand))
                next_tid += 1
            live_jobs.append(next_job)
            next_job += 1
        leave = []
        if r > 0 and live_jobs:
            for _ in range(int(rng.integers(0, 3))):
                if len(live_jobs) > 1:
                    leave.append(live_jobs.pop(int(rng.integers(0, len(live_jobs)))))
        reports = [(int(rng.integers(0, n_work)),
                    tuple(int(x) for x in rng.integers(0, n_work,
                                                       int(rng.integers(1, 3)))),
                    float(rng.uniform(0.5, 1.0)))
                   for _ in range(int(rng.integers(0, 4)))]
        rounds.append({"arrivals": arrivals, "leave": leave,
                       "reports": reports, "revoke": r % 3 == 2})
    return rounds


def _replay(name, which, mode, incremental, events):
    """Drives one package's EvaScheduler through ``events`` as the physical
    mode does (each round's plan applied to the live instances, which are
    the next round's view); returns each round's assignments and plan."""
    pkg = _package(name)
    cat = _catalog(pkg, which)
    kw = {"policies": [pkg.SpotLayer()], "incremental": True} if incremental else {}
    sched = pkg.core.EvaScheduler(cat, mode=mode, **kw)
    tasks, job_of, instances, out = {}, {}, {}, []
    next_iid = 0
    for r, ev in enumerate(events):
        now = 600.0 * (r + 1)
        for tid, job, w, demand in ev["arrivals"]:
            tasks[tid] = (pkg.core.make_task(job, w, task_id=tid) if demand is None
                          else pkg.core.Task(task_id=tid, job_id=job, workload=w,
                                             demands={"p3": demand}))
            job_of[tid] = job
        for job in ev["leave"]:
            for tid in [t for t, j in job_of.items() if j == job]:
                del tasks[tid], job_of[tid]
                for inst in instances.values():
                    inst["tasks"].discard(tid)
        if ev["arrivals"] or ev["leave"]:
            sched.on_event(now)
        for w, colo, value in ev["reports"]:
            sched.observe_single(w, list(colo), value)
        live = [pkg.core.LiveInstance(i, inst["type"], tuple(sorted(inst["tasks"])))
                for i, inst in instances.items()]
        revoked = None
        if ev["revoke"] and incremental:
            busy = [i.instance_id for i in live if i.task_ids]
            if busy:
                revoked = {min(busy)}
                sched.on_pressure(pkg.PressureSignal("spot", tuple(revoked), now))
        placed = {t for inst in instances.values() for t in inst["tasks"]}
        view = pkg.core.SchedulerView(
            time=now, tasks=pkg.core.TaskSet([tasks[t] for t in sorted(tasks)]),
            pending_ids={t for t in tasks if t not in placed}, live=live,
            task_workload={t: tasks[t].workload for t in tasks},
            revoked=revoked)
        config = sched.schedule(view)
        plan = pkg.core.diff_configs(live, config)
        slot_inst = {}
        for slot, (k, tids, matched) in enumerate(plan.slots):
            if matched is None:
                matched, next_iid = next_iid, next_iid + 1
                instances[matched] = {"type": k, "tasks": set()}
            slot_inst[slot] = matched
        for mig in plan.migrations:
            if mig.src_instance is not None:
                instances[mig.src_instance]["tasks"].discard(mig.task_id)
            instances[slot_inst[mig.dst_slot]]["tasks"].add(mig.task_id)
        for iid in plan.terminations:
            instances.pop(iid, None)
        out.append({
            "assignments": [(int(k), tuple(int(t) for t in tids))
                            for k, tids in config.assignments],
            "slots": [(int(k), tuple(tids), m) for k, tids, m in plan.slots],
            "migrations": [(m.task_id, m.src_instance, m.dst_slot)
                           for m in plan.migrations],
            "terminations": list(plan.terminations),
            "launches": list(plan.launches)})
    return out, sched


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode,incremental", [
    ("ensemble", False), ("full-only", False), ("partial-only", False),
    ("ensemble", True)])
@pytest.mark.parametrize("which", ["aws", "local"])
def test_scheduler_matches_reference_pick_for_pick(which, mode, incremental,
                                                   seed):
    events = _events(which, 100 * seed + (which == "local"))
    ref, ref_sched = _replay("repro", which, mode, incremental, events)
    port, port_sched = _replay("repro_torch", which, mode, incremental, events)
    for r, (a, b) in enumerate(zip(ref, port)):
        assert a == b, f"round {r} differs"
    # the scenario did work: tasks were placed and, later, some moved
    assert any(r["assignments"] for r in ref)
    assert ref_sched.rounds == port_sched.rounds == ROUNDS
    assert ref_sched.full_adoptions == port_sched.full_adoptions
    if incremental:
        assert port_sched.incremental_rounds == ref_sched.incremental_rounds > 0
