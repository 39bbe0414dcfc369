"""The port's fleet-scale packer against the JAX package's in f64
(``jax_enable_x64`` and ``torch.set_default_dtype(torch.float64)``, both
reset in ``finally``), on the cases of ``tests/torch_engine_cases.py``: the
canonical partition is equal on every case, interference on or off, and
equals the numpy engine's on fleets of multi-task jobs.  The reference's
process-wide id counters stay where they were (checked after the file's
tests).
"""
import jax
import pytest
import torch

import torch_engine_cases as cases

PRECISION = "f64"


@pytest.fixture(autouse=True, scope="module")
def _reference_id_counters_untouched():
    before = cases.counters()
    yield
    assert cases.counters() == before


@pytest.fixture(autouse=True)
def _f64():
    jax.config.update("jax_enable_x64", True)
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)
        torch.set_default_dtype(torch.float32)


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
