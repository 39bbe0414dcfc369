"""The port's dry run (``repro_torch.launch.{specs,trace_analysis,dryrun}``)
on the CPU.

- The kernels' flop formulas: the tiles the attention kernels compute, and
  a custom op counted by ``trace_analysis`` as its formula says.
- The reference test's own dry-run cells, in a subprocess with a timeout of
  its own (the fake process groups live and die there): reduced smollm-135m
  and granite-moe-3b-a800m on a 2 x 2 mesh, reduced mamba2-780m on
  2 x 2 x 2, a train step of (64, 8) and a decode step under
  ``inference-tp``, on fake CPU tensors (the kernels' plain versions).
  Positive FLOPs and collective bytes, decode ok, and a useful ratio
  (``model_flops / n_chips`` over the counted per-device FLOPs) inside a
  stated range; a single sharded matmul counts exactly its shard's FLOPs.
"""
import json
import os
import subprocess
import sys

import pytest
import torch
from torch_id_counters import reference_id_counters_untouched  # noqa: F401

from repro_torch.kernels import flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


# ---- the kernels' flop formulas -----------------------------------------
@pytest.mark.parametrize("S,causal,window,bm,bn", [
    (2048, True, None, 128, 64), (1500, False, None, 128, 64),
    (4096, True, 2048, 128, 64), (300, True, 40, 64, 64), (1, True, None, 64, 64),
    (129, True, 1, 64, 32)])
def test_attention_tiles_are_those_the_kernel_walks(S, causal, window, bm, bn):
    """Against a brute-force walk: a query tile visits every key tile that
    holds a key one of its rows sees, from the window's first tile on."""
    want = 0
    for q0 in range(0, S, bm):
        rows = range(q0, min(S, q0 + bm))
        lo = min(max(0, i - window + 1) if window else 0 for i in rows)
        hi = max(i + 1 if causal else S for i in rows)
        want += len(range(lo // bn * bn, hi, bn))
    assert flops.attention_tiles(S, causal, window, bm, bn) == want


def test_a_kernel_op_counts_its_formula():
    """On fake CUDA tensors the wrappers reach their custom ops, whose fake
    implementations give the shapes; ``analyze_step`` counts each op's
    flop formula, and nothing is launched."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd, flash_attention_fwd)
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_fwd
    from repro_torch.launch.trace_analysis import analyze_step
    before = dict(LAUNCHES)
    with FakeTensorMode():
        q = torch.empty(2, 300, 4, 64, dtype=torch.bfloat16, device="cuda")
        k = torch.empty(2, 300, 2, 64, dtype=torch.bfloat16, device="cuda")
        got = analyze_step(lambda: flash_attention_fwd(q, k, k, window=100))
        assert got["flops"] == flops.flash_fwd(2, 300, 4, 64, True, 100, 128,
                                               64)
        o, lse = flash_attention_fwd(q, k, k, return_lse=True)
        assert o.shape == q.shape and lse.shape == (2, 4, 300)
        got = analyze_step(lambda: flash_attention_bwd(q, k, k, o, lse, o))
        assert got["flops"] == flops.flash_bwd(2, 300, 4, 64, True, None, 64)
        a = torch.empty(3, 50, 16, device="cuda")
        assert analyze_step(lambda: rglru_scan_fwd(a, a))["flops"] \
            == flops.rglru_scan(3, 50, 16)
    assert dict(LAUNCHES) == before


# ---- the reference test's cells, in a subprocess -------------------------
DRYRUN_SCRIPT = r"""
import json
import torch
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import fake_process_group, make_mesh
from repro_torch.launch.trace_analysis import analyze_step
from repro_torch.models.sharding import distribute, P
from torch._subclasses.fake_tensor import FakeTensorMode

out = {}
for name, multi_pod in (("smollm-135m", False), ("granite-moe-3b-a800m", False),
                        ("mamba2-780m", True)):
    cfg = ARCHS[name].reduced()
    mesh = (((2, 2, 2), ("pod", "data", "model")) if multi_pod
            else ((2, 2), ("data", "model")))
    r = run_cell(name, "t", multi_pod=multi_pod, mesh_shape=mesh,
                 device="cpu", cfg=cfg, shape=ShapeSpec("t", "train", 64, 8))
    d = run_cell(name, "d", multi_pod=multi_pod, mesh_shape=mesh,
                 device="cpu", cfg=cfg, shape=ShapeSpec("d", "decode", 64, 8),
                 profile="inference-tp")
    out[name] = {"flops": r["hlo_flops"], "coll": r["collective_bytes"],
                 "useful_ratio": r["roofline"]["useful_ratio"],
                 "state": r["state_bytes_per_device"]["total"],
                 "decode_ok": d["ok"] and d["hlo_flops"] > 0}

# reduced granite-moe on a 16-way model axis: its 8 experts do not divide
# it and its expert FFN's 32 columns do, so the experts' outputs leave their
# FFN as partial sums, scattered over the features for the combine
r = run_cell("granite-moe-3b-a800m", "t", multi_pod=False,
             mesh_shape=((1, 16), ("data", "model")), device="cpu",
             cfg=ARCHS["granite-moe-3b-a800m"].reduced(),
             shape=ShapeSpec("t", "train", 64, 8))
out["granite-moe-3b-a800m 1x16"] = {
    "flops": r["hlo_flops"], "coll": r["collective_bytes"],
    "reduce_scatter": r["collective_by_kind"].get("reduce-scatter", 0)}

# one matmul, its rows sharded on data and its columns on model: this rank
# computes a (4 x 32) @ (32 x 8) block
with fake_process_group(4):
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    with FakeTensorMode():
        x = distribute(torch.empty(8, 32), mesh, P("data", None))
        w = distribute(torch.empty(32, 16), mesh, P(None, "model"))
        res = analyze_step(lambda: x @ w)
out["matmul"] = {"flops": res["flops"], "coll": res["collective_bytes"]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def dryrun_cells():
    proc = subprocess.run([sys.executable, "-c", DRYRUN_SCRIPT], env=_env(),
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_moe_experts_that_do_not_divide_the_mesh(dryrun_cells):
    r = dryrun_cells["granite-moe-3b-a800m 1x16"]
    assert r["flops"] > 0 and r["coll"] > 0 and r["reduce_scatter"] > 0


def test_a_sharded_matmul_counts_its_shard(dryrun_cells):
    assert dryrun_cells["matmul"] == {"flops": 2 * 4 * 32 * 8, "coll": 0}


@pytest.mark.parametrize("name", ["smollm-135m", "granite-moe-3b-a800m",
                                  "mamba2-780m"])
def test_dryrun_small_mesh(dryrun_cells, name):
    """The reference test's assertions, and the useful ratio's range.

    Upper bound 0.75: remat runs each layer's forward (and each CE chunk's
    head) twice, so a rank executes at least 8 of the model's 6 N FLOPs a
    token for its share.  Lower bounds: work every rank repeats lowers the
    ratio: the plain attention at S = 64 computes every (query, key) pair,
    not the causal half the model counts, and each rank computes the CE head
    over its batch rows whole where the vocab (256) splits; 0.4.  The
    reduced MoE's capacity factor is its expert count (drop-free), so the
    expert FFNs run E x cap = 8 S K rows for the S K the model counts; 0.15.
    """
    r = dryrun_cells[name]
    assert r["flops"] > 0, name
    assert r["coll"] > 0, name
    assert r["decode_ok"], name
    assert r["state"] > 0, name
    low = 0.15 if name == "granite-moe-3b-a800m" else 0.4
    assert low <= r["useful_ratio"] <= 0.75, r
