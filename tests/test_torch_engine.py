"""The port's fleet-scale packer against the JAX package's in f32 (both
packages' default precision), on the cases of ``tests/torch_engine_cases.py``
(``tests/test_torch_engine_x64.py`` runs them in f64), and its host side and
its pass:

- ``_collapse_classes`` equals the reference's on constant-key inputs;
- fleets of multi-task jobs, whose per-job RP sums vary within a workload,
  take the varied-keys branch, where the reference raises and the port
  matches the numpy engine;
- the plain pass returns what the reference's jitted pass returns from the
  same padded inputs, element for element;
- a record buffer forced to overflow is retried to the unforced records;
- the packer's profiler span; ``engine="torch"`` without a card raises.

The reference's process-wide id counters stay where they were (checked
after the file's tests).
"""
import jax
import numpy as np
import pytest
import torch

import torch_engine_cases as cases
from repro.core import engine_jax
from repro.core.workloads import NUM_WORKLOADS
from repro_torch.core import engine_torch
from repro_torch.kernels.pack_fill import ops as pack_ops
from repro_torch.obs import profiler

PRECISION = "f32"


@pytest.fixture(autouse=True, scope="module")
def _reference_id_counters_untouched():
    before = cases.counters()
    yield
    assert cases.counters() == before


@pytest.fixture(autouse=True)
def _f32():
    assert not jax.config.jax_enable_x64
    assert torch.get_default_dtype() == torch.float32


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("interference", [False, True])
def test_torch_matches_jax(seed, interference):
    cases.check_seeded(PRECISION, seed, interference)


@pytest.mark.parametrize("seed", [10, 11, 12, 13, 14, 15])
def test_torch_matches_jax_random_catalog(seed):
    cases.check_random_catalog(PRECISION, seed)


def test_torch_type_mask_matches_jax():
    cases.check_type_mask(PRECISION)


def test_torch_region_caps_match_jax():
    cases.check_region_caps(PRECISION)


def test_torch_table3_walkthrough():
    cases.check_table3(PRECISION)


def test_incremental_torch_matches_jax():
    cases.check_incremental(PRECISION)


def test_varied_keys_match_numpy_where_the_reference_raises():
    cases.check_varied_keys(PRECISION)


@pytest.mark.parametrize("merge", [False, True])
def test_collapse_classes_matches_reference(merge):
    tasks, _, rp, jr = cases.fleet_arrays(0)
    args = (tasks.workloads, rp, jr, tasks.demand_by_family, merge)
    for a, b in zip(engine_torch._collapse_classes(*args),
                    engine_jax._collapse_classes(*args)):
        np.testing.assert_array_equal(a, b)


def _spy(monkeypatch, forced=None):
    """Records every call of the pass: (inputs, max_fills, outputs); with
    ``forced``, the first call runs at that many records instead."""
    calls = []
    real = pack_ops.pack_all_types

    def spy(*args, max_fills):
        mf = forced if forced is not None and not calls else max_fills
        out = real(*args, max_fills=mf)
        calls.append((args, mf, out))
        return out
    monkeypatch.setattr(pack_ops, "pack_all_types", spy)
    return calls


def test_pass_returns_what_the_reference_returns(monkeypatch):
    """The plain pass against the reference's jitted pass, from the same
    padded inputs (interference on, multi-task jobs), element for element."""
    tasks, cat, rp, jr = cases.fleet_arrays(6, n=90, job_sizes=(1, 2, 3))
    calls = _spy(monkeypatch)
    engine_torch.pack_torch(tasks.demand_by_family, tasks.workloads, rp, jr,
                            cat, cases.table_of(cases.PORT, 6, 0.95)
                            .pairwise_matrix(), device="cpu")
    (args, max_fills, ours), = calls
    theirs = engine_jax._pack_all_types(
        *(jax.numpy.asarray(a.numpy()) for a in args), max_fills=max_fills)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_forced_overflow_retries_to_the_unforced_records(monkeypatch):
    tasks, cat, rp, jr = cases.fleet_arrays(4, n=80, job_sizes=(1, 2))
    args = (tasks.demand_by_family, tasks.workloads, rp, jr, cat,
            np.ones((NUM_WORKLOADS, NUM_WORKLOADS)))
    calls = _spy(monkeypatch)
    plain = engine_torch.pack_torch(*args, device="cpu")
    (_, _, unforced), = calls
    assert not bool(unforced[5])
    n = int(unforced[4])
    assert n > 4
    monkeypatch.undo()
    forced = _spy(monkeypatch, forced=2)
    assert engine_torch.pack_torch(*args, device="cpu") == plain
    assert [mf for _, mf, _ in forced] == [2, calls[0][1] * 2]
    first, second = forced[0][2], forced[1][2]
    assert bool(first[5]) and not bool(second[5])
    assert int(first[4]) == int(second[4]) == n  # every fill counted
    assert torch.equal(first[0], unforced[0])  # and the budget spent
    for got, rows in ((first, 2), (second, n)):
        for a, b in zip(got[1:4], unforced[1:4]):
            assert torch.equal(a[:rows], b[:rows])


def test_torch_pack_span_and_no_card():
    """The packer's profiler span carries the reference's tags; on the CPU
    its stage is ``execute``.  ``engine="torch"`` needs a card."""
    tasks, cat, _, _ = cases.fleet_arrays(7, n=40)
    prof = profiler.Profiler()
    profiler.activate(prof)
    try:
        cases.PORT.core.full_reconfiguration(tasks, cat, None,
                                             engine="torch:cpu")
    finally:
        profiler.activate(None)
    spans = [s for s in prof.spans if s.name == "torch_pack"]
    assert [s.tags for s in spans] == [
        {"stage": "execute", "max_fills": 256, "n_tasks": 40}]
    if torch.cuda.is_available():
        pytest.skip("a card is present: engine='torch' runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cases.PORT.core.full_reconfiguration(tasks, cat, None, engine="torch")
    view = cases.PORT.core.SchedulerView(
        time=0.0, tasks=tasks, pending_ids=set(tasks.ids.tolist()), live=[],
        task_workload=dict(zip(tasks.ids.tolist(), tasks.workloads.tolist())))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cases.PORT.core.EvaScheduler(cat, engine="torch").schedule(view)
