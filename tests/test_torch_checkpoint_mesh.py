"""The port's checkpoints across meshes on the CPU, in gloo processes (a
``FileStore`` under tmp_path, no port): a save on a mesh of several ranks is
written once, by rank 0, complete before any rank returns; a failed write
raises on every rank; ``restore_checkpoint(mesh=, specs=)`` places a
checkpoint, the reference's or the port's, onto another mesh, each rank's
block the one its spec gives it, as the reference's
``restore_checkpoint(shardings=)`` does; and the train launcher resumes a
2 x 2 run on 4 x 2 or with no mesh, a run without a mesh on 1 x 1."""
import json
import os
import shutil
import subprocess
import sys
import types
import zipfile

import numpy as np
import pytest
import torch
from torch_id_counters import reference_id_counters_untouched  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-0.6b"


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


def _train_argv(steps: int, *extra: str) -> list:
    return ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
            str(steps), "--batch", "4", "--seq", "16", "--log-every", "100",
            *extra]


# Runs ``job`` (a function of the script below) on ``world`` spawned ranks of
# a gloo group and prints {rank: what it returned} as the last line; a rank
# that raises sends its traceback instead, so the parent never waits on it.
SPAWN = r"""
import json, sys, traceback
import torch.multiprocessing as mp


def run(rank, world, store, job, arg, q):
    import datetime
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=180))
    try:
        q.put((rank, globals()[job](rank, arg)))
    except BaseException:
        q.put((rank, {"error": traceback.format_exc()}))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    world, store, job, arg = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=run, args=(r, world, store, job, arg, q),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    out = dict(q.get(timeout=400) for _ in procs)
    for p in procs:
        p.join(60)
    print(json.dumps(out))
"""

JOBS = r"""
import os
import numpy as np
import torch

TRAIN = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--batch",
         "4", "--seq", "16", "--log-every", "100"]


def bits(t):
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def blocks(flat, path):
    # each DTensor's local block and this rank's coordinate
    from repro_torch.kernels.shards import is_dtensor
    local = {k: v.to_local() for k, v in flat.items() if is_dtensor(v)}
    np.savez(path, **{k: bits(v) for k, v in local.items()})
    coord = next(v for v in flat.values() if is_dtensor(v)).device_mesh.get_coordinate()
    own = all(v.untyped_storage().nbytes() == v.nbytes for v in local.values())
    return list(coord), own


def small_state(mesh):
    # a seeded state every rank builds alike: sharded f32, bf16, replicated
    # and plain leaves
    from repro_torch.models.sharding import P, distribute
    g = torch.Generator().manual_seed(7)
    w = torch.randn(8, 6, generator=g)
    b = torch.randn(6, generator=g).to(torch.bfloat16)
    return {"w": distribute(w, mesh, P("data", "model")),
            "b": distribute(b, mesh, P("model")),
            "r": distribute(torch.randn(4, generator=g), mesh, P()),
            "step": torch.tensor(5, dtype=torch.int32)}


def two_by_two(rank, d):
    # the launcher on 2 x 2 with a checkpoint every step, then the
    # checkpointer alone: two asynchronous saves and a synchronous one, and
    # writes that fail on rank 0
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import flatten
    from repro_torch.train.checkpoint import AsyncCheckpointer, save_checkpoint
    out = train.main(TRAIN + ["--steps", "2", "--mesh", "2x2",
                              "--checkpoint-dir", os.path.join(d, "run"),
                              "--checkpoint-every", "1"])
    coord, _ = blocks(flatten(out["state"]), os.path.join(d, f"blocks-{rank}.npz"))
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    state = small_state(mesh)
    ckpt = AsyncCheckpointer(os.path.join(d, "async"))
    ckpt.save(state, 1)
    ckpt.save(state, 2)
    ckpt.wait()
    save_checkpoint(os.path.join(d, "sync"), state, 3)
    failed = {}
    bad = os.path.join(d, "a-file", "ckpt")  # under a file: unwritable
    ckpt = AsyncCheckpointer(bad)
    ckpt.save(state, 1)
    try:
        ckpt.wait()
    except RuntimeError as e:
        failed["async"] = repr(e.__cause__ or e)
    try:
        save_checkpoint(bad, state, 1)
    except Exception as e:
        failed["sync"] = repr(e)
    import torch.distributed as dist
    dist.barrier()  # every rank got here: none hangs after a failed write
    return {"losses": out["losses"], "coord": coord, "failed": failed}


def four_by_two(rank, d):
    # the reference's checkpoint restored onto 4 x 2, then the 2 x 2 run
    # resumed on 4 x 2 to step 4
    from repro_torch.configs import ARCHS
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.params import flatten
    from repro_torch.train.checkpoint import restore_checkpoint
    cfg = ARCHS["smollm-135m"].reduced()
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    tree, step, _ = restore_checkpoint(
        os.path.join(d, "ref"), device="cpu", mesh=mesh,
        specs={"params": lm.param_pspecs(cfg, mesh)})
    flat = flatten(tree)
    coord, own = blocks(flat, os.path.join(d, f"ref-blocks-{rank}.npz"))
    with np.load(os.path.join(d, "ref", f"step-{step}.npz")) as data:
        whole = all(np.array_equal(bits(v.full_tensor()), data[k])
                    for k, v in flat.items())
    del tree, flat
    out = train.main(TRAIN + ["--steps", "4", "--mesh", "4x2",
                              "--checkpoint-dir", os.path.join(d, "resume-4x2")])
    return {"coord": coord, "own": own, "whole": whole,
            "start_step": out["start_step"], "losses": out["losses"]}
"""


def _spawn(tmp, world: int, job: str, arg: str) -> dict:
    script = tmp / "spawn.py"
    script.write_text(JOBS + SPAWN)
    proc = subprocess.run(
        [sys.executable, str(script), str(world), str(tmp / f"store-{job}"),
         job, arg], env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(out, key=int) == [str(r) for r in range(world)]
    errors = [r["error"] for r in out.values() if "error" in r]
    assert not errors, errors[0]
    return {int(r): v for r, v in out.items()}


def _block(a: np.ndarray, spec, coord: dict, sizes: dict) -> np.ndarray:
    """The block of ``a`` that a partition spec gives the device at
    ``coord``: each dimension split evenly over its mesh axes, the first
    name outermost (``jax.sharding.PartitionSpec``'s rule)."""
    index = []
    for d in range(a.ndim):
        entry = spec[d] if d < len(spec) else None
        if entry is None:
            index.append(slice(None))
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        i, n = 0, 1
        for name in names:
            i, n = i * sizes[name] + coord[name], n * sizes[name]
        size = a.shape[d] // n
        index.append(slice(i * size, (i + 1) * size))
    return a[tuple(index)]


def _mesh_shape(**sizes):
    # what spec resolution reads of a mesh: its axis sizes, in order
    return types.SimpleNamespace(shape=dict(sizes), axis_names=tuple(sizes))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2 x 2 processes, then the 4 x 2 ones, on one directory: the
    reference's save of reduced smollm-135m parameters is made first."""
    import jax
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.models.lm import init_params
    from repro.train.checkpoint import save_checkpoint
    d = tmp_path_factory.mktemp("ckpt-mesh")
    cfg = JAX_ARCHS["smollm-135m"].reduced()
    save_checkpoint(str(d / "ref"), {"params": init_params(
        cfg, jax.random.PRNGKey(0))}, step=1)
    (d / "a-file").write_text("")
    two = _spawn(d, 4, "two_by_two", str(d))
    # the resumed runs each take a copy of the 2 x 2 run's checkpoint
    for copy in ("resume-4x2", "resume-plain"):
        shutil.copytree(d / "run", d / copy)
    four = _spawn(d, 8, "four_by_two", str(d))
    return {"dir": d, "two": two, "four": four}


@pytest.fixture(scope="module")
def uninterrupted():
    from repro_torch.launch import train
    return train.main(_train_argv(4))["losses"]


def test_reference_checkpoint_restores_onto_4x2_block_for_block(runs):
    """The reference's checkpoint on eight ranks: each rank's shard is, bit
    for bit, the block of the reference's array that the reference's spec on
    a 4 x 2 mesh gives its coordinate; its storage is that block alone; every
    ``full_tensor`` is the whole array."""
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.models.lm import param_pspecs
    from repro.train.checkpoint import _flatten
    d = runs["dir"]
    sizes = {"data": 4, "model": 2}
    specs = _flatten({"params": param_pspecs(
        JAX_ARCHS["smollm-135m"].reduced(), _mesh_shape(**sizes))})
    with np.load(d / "ref" / "step-1.npz") as data:
        ref = {k: data[k] for k in data.files}
    assert set(specs) == set(ref)
    assert any(any(e is not None for e in s) for s in specs.values())
    for rank, got in runs["four"].items():
        assert got["whole"] and got["own"]
        coord = dict(zip(sizes, got["coord"]))
        with np.load(d / f"ref-blocks-{rank}.npz") as blocks:
            assert set(blocks.files) == set(ref)
            for k, a in ref.items():
                want = _block(a, tuple(specs[k]), coord, sizes)
                assert blocks[k].dtype == a.dtype, k
                np.testing.assert_array_equal(blocks[k], want, err_msg=k)


def test_mesh_2x2_run_writes_one_complete_checkpoint(runs):
    """Four ranks that checkpoint every step all return, and leave each step
    written once and whole: the train state's every key, no temporary."""
    d = runs["dir"] / "run"
    assert sorted(os.listdir(d)) == ["manifest.json", "step-1.npz",
                                     "step-2.npz"]
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["step"] == 2
    keys = set(manifest["keys"])
    assert "opt/step" in keys and "params/embed" in keys
    params = {k.removeprefix("params/") for k in keys
              if k.startswith("params/")}
    for moment in ("opt/m/", "opt/v/"):
        assert {k.removeprefix(moment) for k in keys
                if k.startswith(moment)} == params
    with np.load(d / "step-2.npz") as data:
        assert set(data.files) == keys


def test_2x2_checkpoint_restores_without_mesh_to_the_bit(runs):
    """The 2 x 2 run's checkpoint restored with no mesh: plain tensors, each
    rank's final shard exactly its block of them."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.shards import is_dtensor
    from repro_torch.models import lm
    from repro_torch.models.params import flatten
    from repro_torch.train.checkpoint import restore_checkpoint
    d = runs["dir"]
    tree, step, _ = restore_checkpoint(str(d / "run"), device="cpu")
    flat = flatten(tree)
    assert step == 2
    assert all(type(v) is torch.Tensor and not is_dtensor(v)
               for v in flat.values())
    sizes = {"data": 2, "model": 2}
    ps = lm.param_pspecs(ARCHS[ARCH].reduced(), _mesh_shape(**sizes))
    specs = flatten({"params": ps, "opt": {"m": ps, "v": ps}})
    assert set(flat) == set(specs) | {"opt/step"}
    for rank, got in runs["two"].items():
        coord = dict(zip(sizes, got["coord"]))
        with np.load(d / f"blocks-{rank}.npz") as blocks:
            assert set(blocks.files) == set(specs)
            for k, spec in specs.items():
                np.testing.assert_array_equal(
                    blocks[k], _block(flat[k].numpy(), spec, coord, sizes),
                    err_msg=k)


def test_resume_on_4x2_gives_the_uninterrupted_losses(runs, uninterrupted):
    """Elastic re-scaling, 4 ranks to 8: the 2 x 2 checkpoint resumed on 4 x 2
    trains steps 3-4 to the losses of the run without a mesh."""
    for got in runs["four"].values():
        assert got["start_step"] == 2
        assert got["losses"] == pytest.approx(uninterrupted[2:], rel=1e-5,
                                              abs=1e-5)


def test_resume_without_mesh_gives_the_uninterrupted_losses(runs, uninterrupted):
    from repro_torch.launch import train
    out = train.main(_train_argv(4, "--checkpoint-dir",
                                 str(runs["dir"] / "resume-plain")))
    assert out["start_step"] == 2
    assert out["losses"] == pytest.approx(uninterrupted[2:], rel=1e-5, abs=1e-5)
    for got in runs["two"].values():
        assert got["losses"] == pytest.approx(uninterrupted[:2], rel=1e-5,
                                              abs=1e-5)


def test_chain_resumes_on_1x1_and_without_mesh_to_the_bit(tmp_path,
                                                          uninterrupted):
    """The card's chain at reduced size: 2 steps without a mesh and a
    checkpoint, ``--mesh 1x1`` to step 3 (a restore onto the mesh), no mesh
    to step 4 (a restore of what the mesh wrote): every loss that of the
    uninterrupted run, bit for bit, and no process group left."""
    import torch.distributed as dist
    from repro_torch.launch import train
    ckpt = str(tmp_path / "ckpt")
    first = train.main(_train_argv(2, "--checkpoint-dir", ckpt))
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        meshed = train.main(_train_argv(3, "--checkpoint-dir", ckpt,
                                        "--mesh", "1x1"))
    finally:
        dist.destroy_process_group()
    last = train.main(_train_argv(4, "--checkpoint-dir", ckpt))
    assert (meshed["start_step"], last["start_step"]) == (2, 3)
    assert first["losses"] + meshed["losses"] + last["losses"] == uninterrupted
    assert meshed["restore_s"] > 0 and first["checkpoint_s"] > 0
    assert not dist.is_initialized()


def _members(path) -> list:
    with zipfile.ZipFile(path) as z:  # the members' bytes, not the zip's
        return [(name, z.read(name)) for name in z.namelist()]  # timestamps


def test_multi_rank_saves_match_a_single_process_save(runs, tmp_path):
    """Two asynchronous saves and a synchronous one on four ranks give the
    files one process writes of the same state, byte for byte."""
    from repro_torch.train.checkpoint import save_checkpoint
    g = torch.Generator().manual_seed(7)
    w = torch.randn(8, 6, generator=g)
    b = torch.randn(6, generator=g).to(torch.bfloat16)
    state = {"w": w, "b": b, "r": torch.randn(4, generator=g),
             "step": torch.tensor(5, dtype=torch.int32)}
    d = runs["dir"]
    for name, step in (("async", 2), ("sync", 3)):
        save_checkpoint(str(tmp_path / name), state, step)
        assert _members(d / name / f"step-{step}.npz") == _members(
            tmp_path / name / f"step-{step}.npz")
        assert (d / name / "manifest.json").read_bytes() == (
            tmp_path / name / "manifest.json").read_bytes()
    assert sorted(os.listdir(d / "async")) == ["manifest.json", "step-1.npz",
                                               "step-2.npz"]


def test_failed_write_raises_on_every_rank(runs):
    """A write that fails on rank 0 raises there, from ``wait`` and from
    ``save_checkpoint``, with its own error; every other rank learns of it
    from rank 0 and raises too, and all reach the barrier after it."""
    for rank, got in runs["two"].items():
        assert set(got["failed"]) == {"async", "sync"}, rank
        for text in got["failed"].values():
            if rank == 0:
                assert "NotADirectoryError" in text or "FileExistsError" in text
            else:
                assert "failed on rank 0" in text


@pytest.fixture
def one_rank(tmp_path):
    """A 1 x 1 CPU mesh on a gloo group of this process, destroyed after."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        yield make_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


def _saved(tmp_path) -> str:
    from repro_torch.train.checkpoint import save_checkpoint
    g = torch.Generator().manual_seed(3)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, {
        "params": {"w": torch.randn(4, 6, generator=g).to(torch.bfloat16),
                   "b": torch.randn(6, generator=g)},
        "opt": {"step": torch.tensor(2, dtype=torch.int32)}}, 2)
    return path


@pytest.mark.parametrize("case", ["mesh_alone", "specs_alone", "missing_key"])
def test_restore_onto_a_mesh_raises_on_a_partial_request(case, tmp_path,
                                                         one_rank):
    from repro_torch.models.sharding import P
    from repro_torch.train.checkpoint import restore_checkpoint
    path = _saved(tmp_path)
    kwargs = {"mesh_alone": {"mesh": one_rank},
              "specs_alone": {"specs": {"params": {"w": P(None, None)}}},
              "missing_key": {"mesh": one_rank,
                              "specs": {"params": {"u": P(None)}}}}[case]
    with pytest.raises(KeyError if case == "missing_key" else ValueError):
        restore_checkpoint(path, device="cpu", **kwargs)


def test_a_key_outside_specs_comes_back_plain(tmp_path, one_rank):
    """Covered keys come back as DTensors (bf16 from its bits), which take
    ``requires_grad`` as the train step sets it; ``opt/step`` and a key the
    specs leave out come back plain, as the reference's ``jnp.asarray``."""
    from repro_torch.kernels.shards import is_dtensor
    from repro_torch.models.sharding import P
    from repro_torch.train.checkpoint import restore_checkpoint
    path = _saved(tmp_path)
    plain, _, _ = restore_checkpoint(path, device="cpu")
    tree, step, _ = restore_checkpoint(path, device="cpu", mesh=one_rank,
                                       specs={"params": {"w": P(None, None)}})
    w = tree["params"]["w"]
    assert step == 2 and is_dtensor(w) and w.dtype == torch.bfloat16
    assert torch.equal(w.to_local().view(torch.int16),
                       plain["params"]["w"].view(torch.int16))
    assert w.requires_grad_(True).is_leaf and w.requires_grad
    for got, want in ((tree["params"]["b"], plain["params"]["b"]),
                      (tree["opt"]["step"], plain["opt"]["step"])):
        assert not is_dtensor(got) and torch.equal(got, want)
    assert tree["opt"]["step"].dtype == torch.int32 and tree["opt"]["step"].dim() == 0
