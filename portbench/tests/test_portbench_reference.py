"""The benchmark's plain references against the program's plain path
(``impl="reference"`` on CPU tensors) at each configuration's reduced
size, through the harness's own check: training's losses, first gradients
and changes, early and after the window, prefill's served tokens and
cache."""
import pytest

import _small

# f32 on both sides at the reduced size: what is left is the order of sums
TOL = {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-4,
       "late_loss_gap": 1e-5, "late_grad_gap": 1e-4, "late_change_gap": 1e-4,
       "logit_gap_mean": 1e-5, "cache_err_median": 1e-5,
       "cache_err_max": 1e-5}


@pytest.mark.parametrize("cell", _small.CELLS)
def test_reference_matches_program(cell):
    import time
    from portbench import harness
    out = harness.run_cell(cell, 2 ** 31 + 17, 0.2, False,
                           time.perf_counter(), device="cpu",
                           **_small.overrides(cell))
    for k, v in out["checks"].items():
        assert v["value"] <= TOL[k], (k, v)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("family", ["moe", "ssm"])
def test_reference_prefill_cache_is_its_forward(family):
    """The reference's prefill gives the last logits of its own forward
    over the prompt, and a cache of every layer."""
    import torch
    from portbench import harness
    from portbench.reference import _common
    cell = {"moe": "granite-moe-3b-a800m.prefill",
            "ssm": "mamba2-780m.train"}[family]
    o = _small.overrides(cell)
    run = harness.new_run(cell, 5, "cpu", **o)
    flat = {s[0]: _common.make_leaf(s, 5, "cpu") for s in run.specs}
    tok = torch.randint(0, run.c["vocab"], (2, 16))
    full = _common.prefill(run.family, run.c, flat, tok, "f32", True)
    part = _common.prefill(run.family, run.c, flat, tok[:, :8], "f32", False)
    assert full["logits"].shape == (2, run.c["vocab"])
    assert not torch.equal(full["logits"], part["logits"])
    for v in full["cache"].values():
        assert v.shape[0] == run.c["n_layers"] and torch.isfinite(v).all()
