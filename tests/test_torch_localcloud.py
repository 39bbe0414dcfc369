"""The port's physical mode (``repro_torch.cluster.localcloud``) on the CPU,
against the JAX package's.

- The reference's scenario (``tests/test_localcloud.py``): Eva schedules two
  30-step jobs to completion on the port's ``LocalCloud``.
- A port worker, restored from the reference's initial state, trains as
  many steps as the reference's worker does with its jitted step, and its
  state matches (``tests/test_torch_train.py``'s tolerances: m and v 1e-4;
  parameters 4 lr a step, absolute, since a gradient element below the two
  packages' f32 noise may flip the sign of its Adam update).
- A worker stopped at step 3 and resumed to 6 ends bit for bit where an
  uninterrupted 6-step worker ends.
- Without a card ``LocalCloud`` raises unless it is given ``device="cpu"``;
  a worker that raises ends ``LocalCloud.run`` with its error at the next
  round, the other workers stopped; launch counts taken on many threads at once are exact.

Every task is made with an explicit id, so the reference's process-wide id
counters stay where they were (checked after the file's tests).
"""
import collections
import os
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.cluster import localcloud as jax_localcloud
from repro.configs import ARCHS as JAX_ARCHS
from repro.models.steps import init_train_state as jax_init_train_state
from repro.train import checkpoint as jax_ckpt
from repro_torch.cluster.localcloud import LocalCloud, LocalJob, _Worker
from repro_torch.configs import ARCHS
from repro_torch.core import Catalog, EvaScheduler
from repro_torch.core.catalog import InstanceType
from repro_torch import kernels
from repro_torch.train.checkpoint import restore_checkpoint
from repro_torch.train.optimizer import OptConfig, lr_at

TOL = dict(rtol=1e-4, atol=1e-4)


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


def _catalog():
    return Catalog.from_types([
        InstanceType("local.large", "c7i", (0, 4, 16), 1.0),
        InstanceType("local.small", "c7i", (0, 2, 8), 0.55),
    ])


@pytest.mark.slow
def test_local_cluster_trains_real_jobs(tmp_path):
    catalog = _catalog()
    jobs = [
        LocalJob(job_id=1, workload=7, arch_cfg=ARCHS["smollm-135m"].reduced(),
                 total_steps=30, demand=(0, 1, 4), standalone_sps=20.0),
        LocalJob(job_id=2, workload=6, arch_cfg=ARCHS["qwen3-0.6b"].reduced(),
                 total_steps=30, demand=(0, 1, 4), standalone_sps=15.0),
    ]
    cloud = LocalCloud(catalog, EvaScheduler(catalog), jobs, round_s=2.0,
                       workdir=str(tmp_path), device="cpu")
    out = cloud.run(timeout_s=420)
    assert out["all_done"], out
    assert out["cost"] > 0
    assert all(s >= 30 for s in out["steps"].values())
    assert cloud.workers == {}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v.detach().numpy() if
                                         isinstance(v, torch.Tensor) else v)
    return out


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-0.6b", "mamba2-780m"])
def test_worker_matches_reference_worker(arch, tmp_path):
    """Both workers start from the reference's initial state for job 4, as
    a migrated task restarts from its checkpoint, and train 5 steps."""
    steps, job_id = 5, 4
    init = jax_init_train_state(JAX_ARCHS[arch].reduced(),
                                jax.random.PRNGKey(job_id))
    for d in ("ref", "port"):
        jax_ckpt.save_checkpoint(str(tmp_path / d), init, 0)
    ref_job = jax_localcloud.LocalJob(job_id, 7, JAX_ARCHS[arch].reduced(),
                                      steps, (0, 1, 4))
    jax_localcloud._Worker(ref_job, str(tmp_path / "ref")).run()
    job = LocalJob(job_id, 7, ARCHS[arch].reduced(), steps, (0, 1, 4))
    worker = _Worker(job, str(tmp_path / "port"), device="cpu")
    worker.run()
    assert worker.error is None
    assert (job.steps_done, job.done) == (ref_job.steps_done, ref_job.done) \
        == (steps, True)
    ref, ref_step, _ = jax_ckpt.restore_checkpoint(str(tmp_path / "ref"))
    got, got_step, _ = restore_checkpoint(str(tmp_path / "port"), device="cpu")
    assert got_step == ref_step == steps
    ref, got = _flat(ref), _flat(got)
    assert sorted(got) == sorted(ref)
    oc = OptConfig(total_steps=max(steps, 10))
    bound = 4 * sum(float(lr_at(t, oc)) for t in range(1, steps + 1))
    for key in ref:
        tol = dict(rtol=0, atol=bound) if key.startswith("params/") else TOL
        np.testing.assert_allclose(got[key].astype(np.float64),
                                   ref[key].astype(np.float64), err_msg=key,
                                   **tol)
    assert int(got["opt/step"]) == steps


def test_stopped_worker_resumes_bit_for_bit(tmp_path):
    cfg = ARCHS["smollm-135m"].reduced()

    def run(path, total):
        job = LocalJob(5, 7, cfg, total, (0, 1, 4))
        worker = _Worker(job, str(path), device="cpu")
        worker.run()
        assert worker.error is None and job.steps_done == total and job.done
        return restore_checkpoint(str(path), device="cpu")

    run(tmp_path / "cut", 3)
    resumed, step, _ = run(tmp_path / "cut", 6)
    whole, whole_step, _ = run(tmp_path / "whole", 6)
    assert step == whole_step == 6
    resumed, whole = _flat(resumed), _flat(whole)
    assert sorted(resumed) == sorted(whole)
    for key in whole:
        np.testing.assert_array_equal(resumed[key], whole[key], err_msg=key)


def test_no_card_raises_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    catalog = _catalog()
    jobs = [LocalJob(1, 7, ARCHS["smollm-135m"].reduced(), 2, (0, 1, 4))]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalCloud(catalog, EvaScheduler(catalog), jobs, workdir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _Worker(jobs[0], str(tmp_path))
    cloud = LocalCloud(catalog, EvaScheduler(catalog), jobs,
                       workdir=str(tmp_path), device="cpu")
    assert cloud.device == torch.device("cpu")


def test_worker_failure_ends_the_run(tmp_path):
    """A job that cannot train beside one that can: its worker keeps the
    error, and the next round raises it instead of waiting out the timeout,
    with the other job's worker stopped and its checkpoint written."""
    catalog = _catalog()
    jobs = [LocalJob(1, 7, None, 30, (0, 1, 4), standalone_sps=20.0),
            LocalJob(2, 7, ARCHS["smollm-135m"].reduced(), 10**6, (0, 1, 4),
                     standalone_sps=20.0)]
    cloud = LocalCloud(catalog, EvaScheduler(catalog), jobs, round_s=0.05,
                       workdir=str(tmp_path), device="cpu")
    started = []
    start = cloud._start_worker
    cloud._start_worker = lambda tid: (start(tid), started.append(
        cloud.workers.get(tid)))
    t0 = time.time()
    with pytest.raises(RuntimeError, match="job 1") as info:
        cloud.run(timeout_s=120)
    assert time.time() - t0 < 60
    assert isinstance(info.value.__cause__, AttributeError)
    assert not jobs[0].done and not jobs[1].done
    assert cloud.workers == {}
    assert {w.job.job_id for w in started} == {1, 2}
    assert not any(w.is_alive() for w in started)
    assert os.path.exists(cloud._ckpt_dir(2))


class _YieldingCounter(collections.Counter):
    """A Counter whose read lets other threads run before the write that
    follows it, as a thread switch between the two would."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


def test_launch_counts_are_exact_across_threads(monkeypatch):
    counts = _YieldingCounter()
    monkeypatch.setattr(kernels, "LAUNCHES", counts)
    threads, each = (os.cpu_count() or 1) + 1, 500
    workers = [threading.Thread(
        target=lambda: [kernels.count_launch("k") for _ in range(each)])
        for _ in range(threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert counts["k"] == threads * each
