"""The benchmark is found by name: every cell, configuration, traffic kind,
family and metric of BENCHMARK.json has its files, and the run fails
without a card."""
import importlib
import json
import os
import subprocess
import sys

import pytest

import _small
from portbench import harness

BENCH = harness.benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files(cell):
    spec = harness.cell_of(cell)
    conf = harness.load("configs", spec["config"])
    tr = harness.load("traffic", spec["traffic"])
    importlib.import_module(f"portbench.reference.{conf['family']}")
    loop = importlib.import_module(f"portbench.loops.{tr['kind']}")
    for f in ("setup", "window", "unit", "profiled_units", "release",
              "check"):
        assert callable(getattr(loop, f))
    assert harness.load("limits", cell)
    for section in ("end_to_end", "per_layer"):
        for m in harness.metrics_of(cell, section):
            reader = importlib.import_module(f"portbench.metrics.{m['name']}")
            assert callable(reader.read)
    cfg = harness.program_config(conf["arch"], conf["config"])
    harness.check_layout(cfg, importlib.import_module(
        f"portbench.reference.{conf['family']}").layout(conf["config"]))
    entry = next(c for c in BENCH["configs"] if c["name"] == spec["config"])
    assert entry["source"] == conf["source"]
    assert entry["reduced"] == conf["reduced"]
    assert entry["file"] == f"portbench/configs/{spec['config']}.json"


def test_run_without_a_card_prints_no_result():
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, os.path.join(_small.ROOT, "portbench", "run.py"),
         "--workload", BENCH["workloads"][0]["name"], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=_small.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_names_its_paths():
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert json.loads(json.dumps(BENCH)) == BENCH
