"""The port's training path (``repro_torch.models.steps``, ``train/``,
``data/pipeline.py``, ``launch/train.py``) against the JAX package.

The same parameters (made by ``repro.models.lm.init_params`` and carried
over with ``repro_torch.convert``) and the same numpy batches go through
both packages on the CPU, where both take their plain attention (the
reference's jnp path; the port's plain version, differentiated by
autograd).  Tolerances, with their reasons:
- loss and grad_norm 1e-5 absolute and relative: f32 sums over a few
  layers in another order;
- every gradient leaf and both AdamW moments 1e-4 (the model tests' TOL):
  the same sums, carried through the backward;
- updated parameters: a gradient element smaller than the two packages'
  f32 noise may change sign, which moves Adam's update of that element by at
  most twice its size (|m̂| / sqrt(v̂) ≤ 2 in the first steps) times the
  learning rate, so the bound is 4 Σ lr over the steps taken, absolute.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.models.lm import forward as jax_forward
from repro.models.lm import init_params as jax_init_params
from repro.models.steps import chunked_ce_loss as jax_ce
from repro.models.steps import make_train_step as jax_train_step
from repro.train import checkpoint as jax_ckpt
from repro.train.compression import compress_grads as jax_compress
from repro.train.optimizer import OptConfig as JaxOptConfig
from repro.train.optimizer import adamw_update as jax_adamw
from repro.train.optimizer import init_opt_state as jax_init_opt
from repro.train.optimizer import lr_at as jax_lr_at
from repro_torch.configs import ARCHS
from repro_torch.convert import module_from_tree
from repro_torch.data.pipeline import Prefetcher, SyntheticTokens, shard_batch
from repro_torch.launch import train
from repro_torch.models.lm import forward
from repro_torch.models.params import flatten
from repro_torch.models.steps import chunked_ce_loss, make_train_step
from repro_torch.train import checkpoint
from repro_torch.train.compression import compress_grads
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                        init_opt_state, lr_at)

TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
CASES = {  # tests/test_torch_models.py's dense cases and the recurrent ones
    "smollm-135m": {},
    "qwen3-0.6b": {},
    "qwen3-0.6b-local": {"attn_kind": "local", "local_window": 8},
    "mamba2-780m": {},
    "recurrentgemma-2b": {},
}
B, S = 2, 16


def _configs(case):
    arch = case.replace("-local", "")
    over = CASES[case]
    return (dataclasses.replace(JAX_ARCHS[arch].reduced(), **over),
            dataclasses.replace(ARCHS[arch].reduced(), **over))


def _states(case, seed=0):
    """The JAX train state and the port's, from the same parameters."""
    jcfg, tcfg = _configs(case)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    model = module_from_tree(jax.device_get(jparams), tcfg, device="cpu")
    params = model.tree()
    return (jcfg, {"params": jparams, "opt": jax_init_opt(jparams)},
            tcfg, {"params": params, "opt": init_opt_state(params)})


def _batches(vocab, n, seed=3):
    src = SyntheticTokens(vocab, B, S, seed=seed)
    return [src.next_batch() for _ in range(n)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close_trees(got, ref, **tol):
    got, ref = flatten(got), jax_ckpt._flatten(ref)
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(_np(got[key]), _np(ref[key]), err_msg=key,
                                   **tol)


def _grads(jcfg, jstate, tcfg, tstate, batch):
    """Each package's loss and gradients of one batch."""
    def loss_fn(p):
        h, _ = jax_forward(p, jcfg, jnp.asarray(batch["tokens"]), mode="train")
        return jax_ce(p, h, jnp.asarray(batch["labels"]), jcfg)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jstate["params"])
    tb = shard_batch(batch, "cpu")
    flat = flatten(tstate["params"])
    for p in flat.values():
        p.requires_grad_(True)
    h, _ = forward(tstate["params"], tcfg, tb["tokens"], mode="train")
    tloss = chunked_ce_loss(tstate["params"], h, tb["labels"], tcfg)
    tgrads = torch.autograd.grad(tloss, list(flat.values()))
    return jloss, jgrads, tloss, dict(zip(flat, tgrads))


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_every_gradient_match_jax(case):
    jcfg, jstate, tcfg, tstate = _states(case)
    jloss, jgrads, tloss, tgrads = _grads(jcfg, jstate, tcfg, tstate,
                                          _batches(tcfg.vocab, 1)[0])
    np.testing.assert_allclose(_np(tloss), _np(jloss), **LOSS_TOL)
    _close_trees(tgrads, jgrads, **TOL)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_train_steps_match_jax(case, steps):
    """``make_train_step`` of both packages, ``steps`` steps in a row:
    loss and grad_norm each step, then params, m, v and step."""
    jcfg, jstate, tcfg, tstate = _states(case)
    oc_j, oc_t = JaxOptConfig(total_steps=1000), OptConfig(total_steps=1000)
    jstep = jax.jit(jax_train_step(jcfg, oc_j))
    tstep = make_train_step(tcfg, oc_t)
    for batch in _batches(tcfg.vocab, steps):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, shard_batch(batch, "cpu"))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(_np(tm[key]), _np(jm[key]), err_msg=key,
                                       **LOSS_TOL)
    bound = 4 * sum(float(lr_at(t, oc_t)) for t in range(1, steps + 1))
    _close_trees(tstate["params"], jstate["params"], rtol=0, atol=bound)
    _close_trees(tstate["opt"]["m"], jstate["opt"]["m"], **TOL)
    _close_trees(tstate["opt"]["v"], jstate["opt"]["v"], **TOL)
    assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"]) == steps
    assert tstate["opt"]["step"].dtype == torch.int32


def test_int8_compressed_step_matches_jax():
    jcfg, jstate, tcfg, tstate = _states("qwen3-0.6b")
    jstep = jax.jit(jax_train_step(jcfg, JaxOptConfig(), grad_compression="int8"))
    tstep = make_train_step(tcfg, OptConfig(), grad_compression="int8")
    for batch in _batches(tcfg.vocab, 2):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, shard_batch(batch, "cpu"))
        np.testing.assert_allclose(_np(tm["loss"]), _np(jm["loss"]), **LOSS_TOL)
    _close_trees(tstate["gerr"], jstate["gerr"], **TOL)


@pytest.mark.parametrize("S_,chunk", [(16, 4), (12, 5), (8, 8), (6, 16)])
def test_chunked_ce_loss_and_its_gradient_match_jax(S_, chunk):
    """Chunks that divide S, and the single-chunk fallback when they do not
    (12 % 5) or when the chunk exceeds S."""
    jcfg, tcfg = (dataclasses.replace(c, ce_chunk=chunk)
                  for c in _configs("qwen3-0.6b"))
    rng = np.random.default_rng(S_ + chunk)
    h = rng.normal(size=(2, S_, tcfg.d_model)).astype(np.float32)
    emb = rng.normal(size=(tcfg.vocab, tcfg.d_model)).astype(np.float32) / 8
    labels = rng.integers(0, tcfg.vocab, size=(2, S_)).astype(np.int32)
    jloss, (jgh, jge) = jax.value_and_grad(
        lambda h_, e_: jax_ce({"embed": e_}, h_, jnp.asarray(labels), jcfg),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(emb))
    th = torch.from_numpy(h).requires_grad_()
    te = torch.from_numpy(emb).requires_grad_()
    tloss = chunked_ce_loss({"embed": te}, th, torch.from_numpy(labels), tcfg)
    tgh, tge = torch.autograd.grad(tloss, (th, te))
    np.testing.assert_allclose(_np(tloss), _np(jloss), **LOSS_TOL)
    np.testing.assert_allclose(_np(tgh), _np(jgh), **TOL)
    np.testing.assert_allclose(_np(tge), _np(jge), **TOL)


@pytest.mark.parametrize("step", [0, 4, 150])
def test_adamw_update_matches_jax(step):
    """One AdamW update from identical params, grads and moments, at a
    learning rate where it is visible: clipping (the norm is above 1), bias
    correction at step + 1, and decay of every leaf with two or more
    dimensions (the stacked norm scale (3, 8) too), none of a vector.  f32
    on both sides: 1e-6 relative, 1e-7 absolute."""
    rng = np.random.default_rng(step)
    shapes = {"w": (6, 5), "norm": (3, 8), "bias": (7,)}
    tree = lambda scale: {k: (rng.normal(size=s) * scale).astype(np.float32)
                          for k, s in shapes.items()}
    p, g, m = tree(1.0), tree(2.0), tree(0.1)
    v = {k: np.abs(x) for k, x in tree(0.01).items()}
    oc_j = JaxOptConfig(lr=1e-2, warmup_steps=10, total_steps=200)
    oc_t = OptConfig(lr=1e-2, warmup_steps=10, total_steps=200)
    jp, jopt, jgn = jax_adamw(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
        {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v),
         "step": jnp.asarray(step, jnp.int32)}, oc_j)
    t = lambda d: {k: torch.from_numpy(x.copy()) for k, x in d.items()}
    tp, topt, tgn = adamw_update(
        t(p), t(g), {"m": t(m), "v": t(v),
                     "step": torch.tensor(step, dtype=torch.int32)}, oc_t)
    np.testing.assert_allclose(_np(tgn), _np(jgn), rtol=1e-6)
    assert float(tgn) > 1  # the update is clipped
    for got, ref in ((tp, jp), (topt["m"], jopt["m"]), (topt["v"], jopt["v"])):
        _close_trees(got, ref, rtol=1e-6, atol=1e-7)
    assert int(topt["step"]) == step + 1
    for k in shapes:  # the update moved every leaf
        assert np.abs(_np(tp[k]) - p[k]).min() > 0


def test_lr_schedule_matches_jax():
    """Warm-up, cosine and floor, steps 0 to 1200 (f32 on both sides)."""
    oc_j = JaxOptConfig(total_steps=1000)
    oc_t = OptConfig(total_steps=1000)
    steps = np.arange(0, 1201)
    jl = np.asarray([jax_lr_at(jnp.asarray(s, jnp.int32), oc_j) for s in steps])
    tl = lr_at(torch.from_numpy(steps.astype(np.int32)), oc_t).numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-6, atol=0)
    assert tl[0] == 0 and tl[100] == pytest.approx(3e-4)
    assert tl[1200] == pytest.approx(3e-5)


@pytest.mark.parametrize("with_error", [False, True])
def test_compress_grads_matches_jax(with_error):
    """The same gradients (and error state) give the same int8
    quantize-dequantize and errors, to the bit: max, division, round half to
    even and product in f32 on both sides."""
    rng = np.random.default_rng(11)
    grads = {"a": rng.normal(size=(5, 7)).astype(np.float32),
             "b": {"c": (rng.normal(size=(9,)) * 1e-3).astype(np.float32),
                   "d": np.zeros((3, 2), np.float32)}}
    # values halfway between two quanta, to hold both to half-to-even
    grads["a"][0, :3] = np.float32(127 / 2.5) * np.array([0.5, 1.5, 2.5]) / 127
    grads["a"][0, 3] = 2.5
    err = ({"a": rng.normal(size=(5, 7)).astype(np.float32) * 1e-2,
            "b": {"c": np.zeros(9, np.float32), "d": np.ones((3, 2), np.float32)}}
           if with_error else None)
    jc, je = jax_compress(jax.tree.map(jnp.asarray, grads),
                          jax.tree.map(jnp.asarray, err) if err else None)
    to_t = lambda t: {k: to_t(v) if isinstance(v, dict) else torch.from_numpy(v)
                      for k, v in t.items()}
    tc, te = compress_grads(to_t(grads), to_t(err) if err else None)
    for got, ref in ((tc, jc), (te, je)):
        got, ref = flatten(got), jax_ckpt._flatten(ref)
        for key in ref:
            np.testing.assert_array_equal(_np(got[key]), _np(ref[key]), key)


@pytest.mark.parametrize("start_step", [0, 5])
def test_synthetic_tokens_are_byte_equal(start_step):
    ours = SyntheticTokens(1000, 3, 17, seed=7, start_step=start_step)
    ref = JaxTokens(1000, 3, 17, seed=7, start_step=start_step)
    for _ in range(3):
        a, b = ours.next_batch(), ref.next_batch()
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes()


def test_prefetcher_serves_the_stream_in_order_and_stops():
    pre = Prefetcher(SyntheticTokens(100, 2, 8, seed=1), device="cpu", depth=2)
    try:
        got = [next(pre) for _ in range(4)]
    finally:
        pre.stop()
    assert not pre.thread.is_alive()
    ref = SyntheticTokens(100, 2, 8, seed=1)
    for batch in got:
        want = ref.next_batch()
        assert batch["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(batch["tokens"].numpy(), want["tokens"])


def test_checkpoints_restore_in_either_package(tmp_path):
    """A train state written by the JAX package restores in the port, and
    one written by the port (synchronously and asynchronously) restores in
    the JAX package, leaf for leaf, under the same keys and dtypes."""
    jcfg, jstate, tcfg, tstate = _states("smollm-135m")
    tstate["opt"]["step"] += 3
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), jstate, 4, extra={"x": 1})
    restored, step, extra = checkpoint.restore_checkpoint(str(tmp_path / "jax"),
                                                          device="cpu")
    assert (step, extra) == (4, {"x": 1})
    _close_trees(restored, jstate, rtol=0, atol=0)
    assert restored["opt"]["step"].dtype == torch.int32

    checkpoint.save_checkpoint(str(tmp_path / "port"), tstate, 2)
    ckpt = checkpoint.AsyncCheckpointer(str(tmp_path / "port"))
    ckpt.save(tstate, 3)
    ckpt.wait()
    assert checkpoint.latest_step(str(tmp_path / "port")) == 3
    for step in (2, 3):
        jrestored, jstep, _ = jax_ckpt.restore_checkpoint(str(tmp_path / "port"),
                                                          step=step)
        assert jstep == step
        _close_trees(tstate, jrestored, rtol=0, atol=0)
        assert jrestored["opt"]["step"].dtype == jnp.int32
    assert sorted(os.listdir(tmp_path / "port")) == [
        "manifest.json", "step-2.npz", "step-3.npz"]


def test_bf16_train_state_checkpoints_bit_for_bit(tmp_path):
    """A train state with bf16 parameters (a reference tree made at
    ``param_dtype="bfloat16"``, carried over) saves, synchronously and
    asynchronously, as 16-bit patterns with every key's dtype in the
    manifest, and restores bit for bit in the same dtypes."""
    jcfg, tcfg = (dataclasses.replace(c, param_dtype="bfloat16")
                  for c in _configs("mamba2-780m"))
    model = module_from_tree(
        jax.device_get(jax_init_params(jcfg, jax.random.PRNGKey(1))), tcfg,
        device="cpu")
    params = model.tree()
    state = {"params": params, "opt": init_opt_state(params)}
    state["opt"]["step"] += 5
    flat = flatten(state)
    assert {t.dtype for k, t in flat.items() if k.startswith("params/")} == {
        torch.bfloat16}
    checkpoint.save_checkpoint(str(tmp_path), state, 1)
    ckpt = checkpoint.AsyncCheckpointer(str(tmp_path))
    ckpt.save(state, 2)
    ckpt.wait()
    with open(tmp_path / "manifest.json") as f:
        dtypes = json.load(f)["dtypes"]
    assert dtypes == {k: str(t.dtype)[6:] for k, t in flat.items()}
    for step in (1, 2):
        restored, got_step, _ = checkpoint.restore_checkpoint(
            str(tmp_path), step=step, device="cpu")
        got = flatten(restored)
        assert got_step == step and sorted(got) == sorted(flat)
        for key, want in flat.items():
            assert got[key].dtype == want.dtype, key
            bits = (lambda t: t.view(torch.int16)) if want.dtype == torch.bfloat16 \
                else (lambda t: t)
            assert torch.equal(bits(got[key]), bits(want)), key


def test_restore_defaults_to_the_card_and_raises_without_one(tmp_path,
                                                             monkeypatch):
    checkpoint.save_checkpoint(str(tmp_path), {"w": torch.zeros(2)}, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.restore_checkpoint(str(tmp_path))


SMALL = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
         "--log-every", "1"]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-780m",
                                  "recurrentgemma-2b"])
def test_train_launcher_reduced_on_cpu(arch):
    out = train.main(SMALL + ["--arch", arch, "--steps", "3"])
    assert out["arch"] == f"{arch}-reduced" and out["device"] == "cpu"
    assert len(out["losses"]) == len(out["step_ms"]) == 3
    assert all(np.isfinite(out["losses"]))
    assert out["launches"] == [{}, {}, {}]  # the CPU launches no kernel
    assert out["max_memory_allocated"] is None
    assert int(out["state"]["opt"]["step"]) == 3


def test_resume_reproduces_the_uninterrupted_run(tmp_path):
    """Three steps in one run, against two steps, a checkpoint, and a
    resumed run that replays the data stream from step 2."""
    whole = train.main(SMALL + ["--steps", "3"])
    first = train.main(SMALL + ["--steps", "2", "--checkpoint-dir",
                                str(tmp_path)])
    resumed = train.main(SMALL + ["--steps", "3", "--checkpoint-dir",
                                  str(tmp_path)])
    assert first["losses"] == whole["losses"][:2]
    assert resumed["start_step"] == 2 and len(resumed["losses"]) == 1
    np.testing.assert_allclose(resumed["losses"][0], whole["losses"][2],
                               rtol=1e-6, atol=0)
    assert checkpoint.latest_step(str(tmp_path)) == 3


def test_train_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1"])


def test_moe_blocks_do_not_train_yet():
    """Mixture-of-experts blocks are not ported: train mode raises, as
    prefill does."""
    cfg = ARCHS["granite-moe-3b-a800m"].reduced()
    with pytest.raises(NotImplementedError, match="not ported yet"):
        forward({}, cfg, torch.zeros(1, 4, dtype=torch.int32), mode="train")
