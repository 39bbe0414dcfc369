"""``repro_torch.launch.train --mesh`` on the CPU: a 1 x 1 mesh on a gloo
group of one rank (a ``FileStore`` under tmp_path, no port) gives the losses
of the run without a mesh, bit for bit; a 2 x 2 mesh of four processes gives
them to f32 rounding; a mesh larger than the process group raises."""
import json
import os
import subprocess
import sys

import pytest
from torch_id_counters import reference_id_counters_untouched  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


def _train_argv(arch: str, *extra: str) -> list:
    return ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
            "--batch", "4", "--seq", "16", "--log-every", "100", *extra]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m",
                                  "mamba2-780m"])
def test_mesh_1x1_trains_the_losses_of_no_mesh(arch, tmp_path):
    import torch.distributed as dist
    from repro_torch.launch import train
    plain = train.main(_train_argv(arch))
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        meshed = train.main(_train_argv(arch, "--mesh", "1x1"))
    finally:
        dist.destroy_process_group()
    assert meshed["losses"] == plain["losses"]
    assert meshed["launches"] == plain["launches"]


def test_mesh_needs_its_ranks():
    """A mesh larger than the process group raises; nothing falls back."""
    from repro_torch.launch import train
    with pytest.raises(ValueError, match="needs 4 processes"):
        train.main(_train_argv("qwen3-0.6b", "--mesh", "2x2"))
    import torch.distributed as dist
    assert not dist.is_initialized()


MESH_SCRIPT = r"""
import json, os, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, store, arch, q):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank,
                            world_size=4)
    from repro_torch.launch import train
    out = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--steps", "3", "--batch", "4", "--seq", "16",
                      "--log-every", "100", "--mesh", "2x2"])
    dist.destroy_process_group()
    q.put((rank, out["losses"]))


if __name__ == "__main__":
    arch, store = sys.argv[1], sys.argv[2]
    ctx = mp.get_context("spawn")
    q = ctx.SimpleQueue()
    procs = [ctx.Process(target=run, args=(r, store, arch, q))
             for r in range(4)]
    for p in procs:
        p.start()
    losses = dict(q.get() for _ in procs)
    for p in procs:
        p.join(60)
    print(json.dumps(losses))
"""


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m",
                                  "mamba2-780m", "recurrentgemma-2b"])
def test_mesh_2x2_trains_the_losses_of_no_mesh(arch, tmp_path):
    """Four processes on a gloo group (a FileStore, no port): batch on data,
    heads, FFN, experts and channels on model, gradients reduced onto their
    parameters' placements.  Every rank reads the same losses, those of the
    run without a mesh to f32 rounding (sums in another order)."""
    from repro_torch.launch import train
    plain = train.main(_train_argv(arch))["losses"]
    script = tmp_path / "mesh.py"
    script.write_text(MESH_SCRIPT)
    proc = subprocess.run(
        [sys.executable, str(script), arch, str(tmp_path / "store")],
        env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    losses = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(losses) == ["0", "1", "2", "3"]
    for got in losses.values():
        assert got == pytest.approx(plain, rel=1e-5, abs=1e-5)
