"""Nothing the benchmark loads is JAX or the JAX package, compared by the
whole top-level name of each loaded module; the references load nothing of
the program either.  Each check runs in a fresh interpreter."""
import json
import os
import subprocess
import sys

import pytest

import _small

CODE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import importlib
for m in {mods!r}:
    importlib.import_module(m)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

HARNESS = ["portbench.harness", "portbench.run", "portbench.calibrate",
           "portbench.loops.train", "portbench.loops.prefill",
           "portbench.trace", "repro_torch.models.steps",
           "repro_torch.data.pipeline"]
METRICS = sorted("portbench.metrics." + f[:-3] for f in os.listdir(
    os.path.join(_small.ROOT, "portbench", "metrics"))
    if f.endswith(".py") and f != "__init__.py")
REFERENCES = ["portbench.reference.moe", "portbench.reference.ssm",
              "portbench.counts.flops", "portbench.counts.kernels",
              "portbench.counts.categories", "portbench.compare",
              "portbench.tokens"]


def _top_names(mods):
    code = CODE.format(root=_small.ROOT,
                       src=os.path.join(_small.ROOT, "src"), mods=mods)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("mods,banned", [
    (HARNESS + METRICS, {"jax", "jaxlib", "flax", "repro"}),
    (REFERENCES, {"jax", "jaxlib", "flax", "repro", "repro_torch"}),
])
def test_no_forbidden_module(mods, banned):
    names = _top_names(mods)
    assert not names & banned, names & banned
    if "portbench.harness" in mods:
        assert "repro_torch" in names


def test_forbidden_modules_compares_whole_names():
    from portbench import harness
    sys.modules.setdefault("repro_torch_lookalike", sys)
    try:
        assert "repro_torch_lookalike" not in harness.forbidden_modules()
    finally:
        del sys.modules["repro_torch_lookalike"]
