"""A module-scoped fixture for the port's tests that import the reference:
they must leave ``repro``'s process-wide id counters
(``repro.cluster.traces._job_ids``, ``_task_ids`` and
``repro.core.cluster_types._task_counter``) where they found them, since
``tests/test_invariants.py`` reads them.  A test file takes it with
``from torch_id_counters import reference_id_counters_untouched``."""
import pytest


@pytest.fixture(autouse=True, scope="module")
def reference_id_counters_untouched():
    from repro.cluster import traces
    from repro.core import cluster_types

    def counters():
        return (repr(traces._job_ids), repr(traces._task_ids),
                repr(cluster_types._task_counter))

    before = counters()
    yield
    assert counters() == before
