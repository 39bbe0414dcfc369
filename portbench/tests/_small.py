"""Small sizes for the CPU tests: each configuration's reduced form (the
program's ``ArchConfig.reduced``, products in f32) and short traffic."""
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TRAFFIC = {
    "train": {"batch": 2, "seq": 32},
    "prefill": {"batch": 2, "prompt_len": 32, "cache_len": 33,
                "checked_batches": 4, "cache_checked_batches": 2,
                "cache_pick_from": 3, "profile_batches": 2},
}
CELLS = ["granite-moe-3b-a800m.train", "mamba2-780m.train",
         "granite-moe-3b-a800m.prefill"]


def overrides(cell: str, **config) -> dict:
    """``config`` and ``traffic`` for ``harness.run_cell`` at the small
    size; a MoE keeps the published capacity factor, so experts drop."""
    from portbench import harness
    from repro_torch.configs import ARCHS
    spec = harness.cell_of(cell)
    conf = harness.load("configs", spec["config"])
    c = dataclasses.asdict(ARCHS[conf["arch"]].reduced())
    for k in ("name", "family"):
        c.pop(k)
    if c["moe"]:
        c["capacity_factor"] = conf["config"]["capacity_factor"]
    c.update(config)
    kind = harness.load("traffic", spec["traffic"])["kind"]
    return {"config": c, "traffic": dict(TRAFFIC[kind])}
