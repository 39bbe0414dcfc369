"""The port's models (``repro_torch.models``: dense, mixture of experts,
Mamba2, RG-LRU hybrid and encoder-decoder) against the JAX package.

The same parameters (made by ``repro.models.lm.init_params`` and carried
over with ``repro_torch.convert``) and the same numpy inputs go through both.
Reduced configs compute in f32; tolerance 1e-4 absolute and relative, for
sums taken in another order through two layers and the f32 LM head.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models import rglru as jrg
from repro.models import ssm as jssm
from repro.models.lm import init_cache as jax_init_cache
from repro.models.lm import init_params as jax_init_params
from repro.models.lm import num_params as jax_num_params
from repro.models.steps import make_decode_step as jax_decode_step
from repro.models.steps import make_prefill_step as jax_prefill_step
from repro.train.checkpoint import _flatten as jax_flatten
from repro_torch.configs import ARCHS
from repro_torch.convert import module_from_tree, state_dict_from_tree
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trg
from repro_torch.models import ssm as tssm
from repro_torch.models.lm import init_cache, init_params, num_params
from repro_torch.models.params import flatten, unflatten
from repro_torch.models.steps import make_decode_step, make_prefill_step

TOL = dict(rtol=1e-4, atol=1e-4)
CASES = {
    "qwen3-0.6b": {},
    "smollm-135m": {},
    # local attention: ring-layout cache, windowed prefill and decode
    "qwen3-0.6b-local": {"attn_kind": "local", "local_window": 8},
    "mamba2-780m": {},
    # two SSM groups: B and C read by group, heads h // (H/G)
    "mamba2-780m-g2": {"ssm_groups": 2},
    # (rglru, rglru, attn) stack plus two rglru tail layers; local window 8,
    # MQA at head_dim 16
    "recurrentgemma-2b": {},
    # dense stacks of other widths: MHA, GQA 32/8, qk-norm
    "granite-3-2b": {},
    "command-r-35b": {},
    "chameleon-34b": {},
    # mixture of experts (reduced: 8 experts, top 2, drop-free capacity);
    # deepseek-moe-16b with a dense first layer (dec/pre0) and 2 shared experts
    "granite-moe-3b-a800m": {},
    "deepseek-moe-16b": {},
    # encoder-decoder: a 2-layer non-causal encoder over 16 frames,
    # cross-attention, absolute sinusoidal positions, biases, GELU
    "whisper-medium": {},
}
SSM = sorted(c for c in CASES if c.startswith("mamba2"))
RGLRU = ["recurrentgemma-2b"]
MOE = ["deepseek-moe-16b", "granite-moe-3b-a800m"]
ENCDEC = ["whisper-medium"]
DENSE = sorted(set(CASES) - set(SSM) - set(RGLRU) - set(MOE) - set(ENCDEC))


def _configs(case):
    arch = case.replace("-local", "").replace("-g2", "")
    over = CASES[case]
    return (dataclasses.replace(JAX_ARCHS[arch].reduced(), **over),
            dataclasses.replace(ARCHS[arch].reduced(), **over))


def _pair(case, seed=0):
    jcfg, tcfg = _configs(case)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    model = module_from_tree(jax.device_get(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, model


def _layer0(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


def _close(got, ref, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(ref, np.float32), **(tol or TOL))


def _x(shape, seed=1):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def test_rmsnorm_and_rope():
    jx, tx = _x((2, 5, 4, 16))
    js, ts = _x((16,), seed=2)
    _close(tl.rmsnorm(tx, ts, 1e-6), jl.rmsnorm(jx, js, 1e-6))
    pos = np.arange(3, 8)
    for theta in (1e4, 1e6):
        _close(tl.rope(tx, torch.from_numpy(pos), theta),
               jl.rope(jx, jnp.asarray(pos), theta))


def _block0(model):
    """Layer 0 of the stacked superblock b0, as views."""
    return {k: {n: t[0] for n, t in v.items()} if isinstance(v, dict) else v[0]
            for k, v in model.tree()["dec"]["stack"]["b0"].items()}


@pytest.mark.parametrize("case", DENSE)
def test_dense_layers(case):
    jcfg, tcfg, jparams, model = _pair(case)
    jp = _layer0(jparams["dec"]["stack"]["b0"])
    tp = _block0(model)
    S = 6
    jx, tx = _x((2, S, tcfg.d_model))
    pos_j, pos_t = jnp.arange(S), torch.arange(S)
    for got, ref in zip(tl._proj_qkv(tp["attn"], tx, tx, tcfg, pos_t, pos_t, True),
                        jl._proj_qkv(jp["attn"], jx, jx, jcfg, pos_j, pos_j, True)):
        _close(got, ref)
    _close(tl.mlp_apply(tp["mlp"], tx, tcfg), jl.mlp_apply(jp["mlp"], jx, jcfg))
    window = tcfg.local_window if tcfg.attn_kind == "local" else None
    ty, (tk, tv) = tl.attention_full_seq(tp["attn"], tx, tcfg, causal=True,
                                         window=window)
    jy, (jk, jv) = jl.attention_full_seq(jp["attn"], jx, jcfg, causal=True,
                                         window=window)
    for got, ref in ((ty, jy), (tk, jk), (tv, jv)):
        _close(got, ref)


@pytest.mark.parametrize("case", SSM)
def test_ssm_block_prefill_and_decode(case):
    """The causal conv, then one Mamba2 block in prefill (S = 12 pads to the
    reduced chunk of 8) and in one decode step against its cache."""
    jcfg, tcfg, jparams, model = _pair(case)
    jp = _layer0(jparams["dec"]["stack"]["b0"])["ssm"]
    tp = _block0(model)["ssm"]
    S = 12
    ju, tu = _x((2, S, tp["conv_w"].shape[1]), seed=3)
    _close(tssm._causal_conv(tu, tp["conv_w"], tp["conv_b"]),
           jssm._causal_conv(ju, jp["conv_w"], jp["conv_b"]))
    jx, tx = _x((2, S, tcfg.d_model))
    ty, tcache = tssm.ssm_block(tp, tx, tcfg, "prefill")
    jy, jcache = jssm.ssm_block(jp, jx, jcfg, "prefill")
    _close(ty, jy)
    assert set(tcache) == set(jcache) == {"conv", "state"}
    for key in jcache:
        _close(tcache[key], jcache[key])
    jx1, tx1 = _x((2, 1, tcfg.d_model), seed=4)
    ty, tcache2 = tssm.ssm_block(tp, tx1, tcfg, "decode", tcache)
    jy, jcache = jssm.ssm_block(jp, jx1, jcfg, "decode", jcache)
    assert tcache2 is tcache  # updated in place
    _close(ty, jy)
    for key in jcache:
        _close(tcache[key], jcache[key])


@pytest.mark.parametrize("case", RGLRU)
def test_rglru_block_prefill_and_decode(case):
    """One RG-LRU block (layer 0 of the stacked b0) in prefill and in two
    decode steps against its cache; then the tail layer's block."""
    jcfg, tcfg, jparams, model = _pair(case)
    S = 12
    jx, tx = _x((2, S, tcfg.d_model))
    for jp, tp in ((_layer0(jparams["dec"]["stack"]["b0"])["rec"],
                    _block0(model)["rec"]),
                   (jparams["dec"]["tail1"]["rec"],
                    model.tree()["dec"]["tail1"]["rec"])):
        ty, tcache = trg.rglru_block(tp, tx, tcfg, "prefill")
        jy, jcache = jax.jit(jrg.rglru_block, static_argnums=(2, 3))(
            jp, jx, jcfg, "prefill")
        _close(ty, jy)
        assert set(tcache) == set(jcache) == {"conv", "h"}
        assert tcache["h"].dtype == torch.float32
        for key in jcache:
            _close(tcache[key], jcache[key])
        for step in range(2):
            jx1, tx1 = _x((2, 1, tcfg.d_model), seed=4 + step)
            ty, tcache2 = trg.rglru_block(tp, tx1, tcfg, "decode", tcache)
            jy, jcache = jax.jit(jrg.rglru_block, static_argnums=(2, 3))(
                jp, jx1, jcfg, "decode", jcache)
            assert tcache2 is tcache  # updated in place
            _close(ty, jy)
            for key in jcache:
                _close(tcache[key], jcache[key])


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_then_greedy_decode(case):
    jcfg, tcfg, jparams, model = _pair(case)
    B, S, new = 2, 12, 4
    jbatch, tbatch = _prompts(tcfg, B, S)
    j_prefill = jax.jit(jax_prefill_step(jcfg, cache_len=S + new))
    j_decode = jax.jit(jax_decode_step(jcfg))
    t_prefill = make_prefill_step(tcfg, cache_len=S + new)
    t_decode = make_decode_step(tcfg)

    jlog, jcache = j_prefill(jparams, jbatch)
    with torch.inference_mode():
        tlog, tcache = t_prefill(model, tbatch)
    _close(tlog, jlog)
    _close_caches(tcache, jcache, case)

    jtok = jnp.argmax(jlog[:, -1], axis=-1)[:, None]
    ttok = tlog[:, -1].argmax(dim=-1)[:, None]
    for i in range(new):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jlog, jcache = j_decode(jparams, jcache, jtok, jnp.int32(S + i))
        with torch.inference_mode():
            tlog, tcache2 = t_decode(model, tcache, ttok, S + i)
        assert tcache2 is tcache  # updated in place
        _close(tlog, jlog)
        jtok = jnp.argmax(jlog[:, -1], axis=-1)[:, None]
        ttok = tlog[:, -1].argmax(dim=-1)[:, None]
    _close_caches(tcache, jcache, case)


def _prompts(tcfg, B, S, seed=5):
    """A batch of B prompts of S tokens for both packages; an
    encoder-decoder config also gets (B, enc_seq, D) random encoder frames."""
    prompts = np.random.default_rng(seed).integers(0, tcfg.vocab, size=(B, S))
    jbatch = {"tokens": jnp.asarray(prompts, jnp.int32)}
    tbatch = {"tokens": torch.from_numpy(prompts)}
    if tcfg.enc_dec:
        jbatch["enc_embeds"], tbatch["enc_embeds"] = _x(
            (B, tcfg.enc_seq, tcfg.d_model), seed=seed + 1)
    return jbatch, tbatch


def _close_caches(tcache, jcache, case):
    """Every entry of the two caches (stacked blocks and tail layers), under
    the reference's keys."""
    tflat, jflat = flatten(tcache), jax_flatten(jcache)
    assert set(tflat) == set(jflat)
    kinds = {"conv", "state"} if case in SSM else \
        {"conv", "h", "k", "v", "pos"} if case in RGLRU else \
        {"k", "v", "pos", "xk", "xv"} if case in ENCDEC else {"k", "v", "pos"}
    assert {key.rsplit("/", 1)[1] for key in tflat} == kinds
    for key in jflat:
        _close(tflat[key], jflat[key])


@pytest.mark.parametrize("case", SSM + RGLRU)
def test_short_prompt_prefills_and_decodes(case):
    """A 2-token prompt, shorter than the conv window's W - 1 = 3: the port
    pads the conv cache with zeros (the JAX package's next decode step fails
    there, so the port is its own reference).  Decoding t after (t0, t1)
    gives the last-position prefill logits of (t0, t1, t)."""
    _, tcfg, _, model = _pair(case)
    tokens = torch.from_numpy(
        np.random.default_rng(7).integers(0, tcfg.vocab, size=(2, 3)))
    with torch.inference_mode():
        _, cache = make_prefill_step(tcfg, cache_len=3)(
            model, {"tokens": tokens[:, :2]})
        convs = {k: t for k, t in flatten(cache).items() if k.endswith("conv")}
        assert convs and all(t.shape[-2] == tcfg.conv_width - 1
                              for t in convs.values())
        got, _ = make_decode_step(tcfg)(model, cache, tokens[:, 2:], 2)
        want, _ = make_prefill_step(tcfg)(model, {"tokens": tokens})
    _close(got, want[:, -1:].numpy())


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_count_params_matches_reference(name):
    assert num_params(ARCHS[name]) == jax_num_params(JAX_ARCHS[name])
    assert num_params(ARCHS[name].reduced()) == \
        jax_num_params(JAX_ARCHS[name].reduced())


def test_module_keys_are_the_checkpoint_keys_and_convert_checks_both_ways():
    jcfg, tcfg, jparams, model = _pair("qwen3-0.6b")
    flat = jax_flatten(jax.device_get(jparams))
    assert set(model.state_dict()) == set(flat)
    for key, t in model.state_dict().items():
        assert tuple(t.shape) == flat[key].shape
    tree = jax.device_get(jparams)
    del tree["dec"]["stack"]["b0"]["attn"]["qn"]
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_tree(tree, tcfg)
    tree = jax.device_get(jparams)
    tree["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unexpected"):
        state_dict_from_tree(tree, tcfg)
    tree = jax.device_get(jparams)
    tree["final_norm"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="final_norm"):
        state_dict_from_tree(tree, tcfg)


def test_convert_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """The no-card machine is made here, whatever machine runs the test."""
    jcfg, tcfg = _configs("smollm-135m")
    tree = jax.device_get(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module_from_tree(tree, tcfg)
    model = module_from_tree(tree, tcfg, device="cpu")
    assert {t.device.type for t in model.state_dict().values()} == {"cpu"}


def test_random_init_is_seeded_and_shaped():
    cfg = ARCHS["smollm-135m"].reduced()
    a = init_params(cfg, torch.Generator().manual_seed(3)).state_dict()
    b = init_params(cfg, torch.Generator().manual_seed(3)).state_dict()
    want = state_dict_from_tree(
        jax.device_get(jax_init_params(JAX_ARCHS["smollm-135m"].reduced(),
                                       jax.random.PRNGKey(0))),
        cfg)
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in want.items()}
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_cache_matches_reference(case):
    jcfg, tcfg = _configs(case)
    ref = jax_flatten(jax_init_cache(jcfg, 2, 20))
    flat = flatten(init_cache(tcfg, 2, 20, "cpu"))
    assert set(flat) == set(ref)
    for key, t in flat.items():
        assert tuple(t.shape) == ref[key].shape
        assert str(t.dtype).split(".")[1] == str(ref[key].dtype)
        assert not t.any()


@pytest.mark.parametrize("case", ["qwen3-0.6b", "mamba2-780m", "recurrentgemma-2b"])
def test_bf16_tree_converts_and_matches_jax(case):
    """A reference tree made at ``param_dtype="bfloat16"`` (``ml_dtypes``
    arrays) carries over by its 16-bit pattern, every leaf bf16 with the
    reference's bits; prefill and one decode step then match the JAX package
    at the f32 parity tolerance (1e-4): the reduced configs compute in f32,
    both packages widen the same bf16 weights exactly, and so differ only in
    the order of f32 sums, as at f32 parameters."""
    jcfg, tcfg = (dataclasses.replace(c, param_dtype="bfloat16")
                  for c in _configs(case))
    jparams = jax.device_get(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    model = module_from_tree(jparams, tcfg, device="cpu")
    tflat, jflat = flatten(model.tree()), jax_flatten(jparams)
    assert set(tflat) == set(jflat)
    for key, a in jflat.items():
        assert a.dtype.name == "bfloat16" and tflat[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(tflat[key].view(torch.int16).numpy(),
                                      np.asarray(a).view(np.int16), err_msg=key)
    B, S = 2, 12
    prompts = np.random.default_rng(5).integers(0, tcfg.vocab, size=(B, S))
    jlog, jcache = jax.jit(jax_prefill_step(jcfg, cache_len=S + 1))(
        jparams, {"tokens": jnp.asarray(prompts, jnp.int32)})
    with torch.inference_mode():
        tlog, tcache = make_prefill_step(tcfg, cache_len=S + 1)(
            model, {"tokens": torch.from_numpy(prompts)})
    _close(tlog, jlog)
    tok = np.array(jnp.argmax(jlog[:, -1], axis=-1))[:, None]
    jlog, _ = jax.jit(jax_decode_step(jcfg))(jparams, jcache, jnp.asarray(tok),
                                             jnp.int32(S))
    with torch.inference_mode():
        tlog, _ = make_decode_step(tcfg)(model, tcache, torch.from_numpy(tok), S)
    _close(tlog, jlog)


def _tree0(tree):
    """Layer 0 of a stacked tree (nested dicts of tensors), as views."""
    return {k: _tree0(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


def _moe_pair(case, **over):
    """The reduced config's layer-0 MoE parameters in both packages."""
    jcfg, tcfg = (dataclasses.replace(c, **over) for c in _configs(case))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = module_from_tree(jax.device_get(jparams), tcfg, device="cpu")
    return (jcfg, _layer0(jparams["dec"]["stack"]["b0"])["moe"], tcfg,
            _tree0(model.tree()["dec"]["stack"]["b0"])["moe"])


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_top_k_breaks_ties_to_the_lower_index_as_jax(k):
    """Rows built with exact ties, among them ``[1, 3, 3, 2, 3]`` (top 2:
    JAX picks experts 1 and 2; ``torch.topk`` on the CPU gave 2 and 4)."""
    rows = np.array([[1, 3, 3, 2, 3, 0], [0.25] * 6, [5, 5, 1, 5, 0, 5],
                     [2, 1, 2, 1, 2, 1], [0, 0, 0, 1, 1, 1]], np.float32)
    rows = np.concatenate([rows, np.random.default_rng(k).integers(
        0, 3, size=(20, 6)).astype(np.float32)])
    jv, ji = jax.lax.top_k(jnp.asarray(rows), k)
    tv, ti = tmoe.top_k(torch.from_numpy(rows), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if k == 2:
        np.testing.assert_array_equal(ti[0].numpy(), [1, 2])


@pytest.mark.parametrize("case", MOE)
def test_moe_routing_ties_match_jax(case):
    """A router whose columns come in groups of three equal ones and inputs
    of small integers, so the f32 logits of many tokens tie exactly across
    the top-k cut (both packages compute them exactly): the chosen experts,
    and so the layer's output, are the reference's (f32, 1e-4)."""
    jcfg, jp, tcfg, tp = _moe_pair(case)
    E, D = tcfg.n_experts, tcfg.d_model
    rng = np.random.default_rng(3)
    router = rng.integers(-1, 2, size=(D, E)).astype(np.float32)
    router = router[:, np.arange(E) // 3]  # experts 0-2, 3-5, ... tie
    x = rng.integers(-1, 2, size=(2, 24, D)).astype(np.float32)
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    probs = np.sort(np.asarray(jax.nn.softmax(jnp.asarray(x) @ router)), -1)
    K = tcfg.top_k
    assert (probs[..., -K] == probs[..., -K - 1]).mean() > 0.3  # ties at the cut
    _close(tmoe.moe_apply(tp, torch.from_numpy(x), tcfg),
           jmoe.moe_apply(jp, jnp.asarray(x), jcfg))


@pytest.mark.parametrize("case", MOE)
def test_moe_apply_drops_over_capacity_and_matches_jax(case):
    """At the full configs' capacity factor (1.25; the reduced configs are
    drop-free) and 40 tokens a row, some assignments overflow their expert
    and are dropped.  The output and the gradients of the parameters and of
    x match the JAX package in f32 at 1e-4: the dispatch buffer holds the
    same rows, and each token's K contributions are summed in token order
    where the reference scatter-adds them in the sort's order."""
    jcfg, jp, tcfg, tp = _moe_pair(case, capacity_factor=1.25)
    jx, tx = _x((2, 40, tcfg.d_model), seed=9)
    _, experts = tmoe.route(tp, tx, tcfg)
    cap = tmoe.capacity(tcfg, 40)
    dropped = int((tmoe.positions(experts, tcfg.n_experts) >= cap).sum())
    assert cap == int(40 * tcfg.top_k / tcfg.n_experts * 1.25) and dropped > 0
    jw, tw = _x((2, 40, tcfg.d_model), seed=10)

    def jloss(p, x):
        return (jmoe.moe_apply(p, x, jcfg) * jw).sum()

    jy = jmoe.moe_apply(jp, jx, jcfg)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    tflat = {k: t.detach().clone().requires_grad_() for k, t in flatten(tp).items()}
    tx.requires_grad_()
    ty = tmoe.moe_apply(unflatten(tflat), tx, tcfg)
    grads = torch.autograd.grad((ty * tw).sum(), [tx, *tflat.values()])
    _close(ty, jy)
    _close(grads[0], jgx)
    jflat = jax_flatten(jgp)
    assert set(jflat) == set(tflat)
    for key, g in zip(tflat, grads[1:]):
        _close(g, jflat[key])


@pytest.mark.parametrize("case", MOE)
def test_moe_oracle_at_one_token_matches_jax(case):
    """Decode (S == 1) takes the dense oracle, which drops nothing, in both
    packages; the oracle also matches at S > 1 (f32, 1e-4)."""
    jcfg, jp, tcfg, tp = _moe_pair(case, capacity_factor=1.25)
    jx, tx = _x((3, 1, tcfg.d_model), seed=11)
    _close(tmoe.moe_apply(tp, tx, tcfg), jmoe.moe_apply(jp, jx, jcfg))
    _close(tmoe.moe_apply_oracle(tp, tx, tcfg), jmoe.moe_apply_oracle(jp, jx, jcfg))
    jx, tx = _x((2, 7, tcfg.d_model), seed=12)
    _close(tmoe.moe_apply_oracle(tp, tx, tcfg), jmoe.moe_apply_oracle(jp, jx, jcfg))


def test_whisper_layers_match_jax():
    """The sinusoidal position embedding at positions 0..2047 (f32, 1e-4:
    the angles reach 2047 rad, where sin and cos of the same f32 angle
    differ between libraries by a few ulp of the angle), and one decoder
    layer's cross-attention over encoder states of another length, from
    the encoder's output and from given K/V."""
    pos = np.arange(2048)
    _close(tl.sinusoidal_embedding(torch.from_numpy(pos), 64),
           jl.sinusoidal_embedding(jnp.asarray(pos), 64))
    jcfg, tcfg, jparams, model = _pair("whisper-medium")
    jp = _layer0(jparams["dec"]["stack"]["b0"])["xattn"]
    tp = _block0(model)["xattn"]
    assert {"bq", "bv"} <= set(tp) and "bk" not in tp
    jx, tx = _x((2, 5, tcfg.d_model), seed=13)
    je, te = _x((2, tcfg.enc_seq, tcfg.d_model), seed=14)
    ty, (tk, tv) = tl.cross_attention(tp, tx, tcfg, enc_out=te)
    jy, (jk, jv) = jl.cross_attention(jp, jx, jcfg, enc_out=je)
    for got, ref in ((ty, jy), (tk, jk), (tv, jv)):
        _close(got, ref)
    ty, _ = tl.cross_attention(tp, tx, tcfg, enc_kv=(tk, tv))
    _close(ty, jy)


def test_whisper_decode_reads_the_encoder_cache():
    """Prefill writes each decoder layer's cross-attention K/V (``xk``,
    ``xv``: (layers, B, enc_seq, KH, hd)) as the reference's cache holds
    them; decode reads them, leaves them bit for bit as they were, and
    matches the reference's logits (1e-4)."""
    jcfg, tcfg, jparams, model = _pair("whisper-medium")
    B, S = 2, 6
    jbatch, tbatch = _prompts(tcfg, B, S, seed=21)
    jlog, jcache = jax.jit(jax_prefill_step(jcfg, cache_len=S + 2))(jparams, jbatch)
    with torch.inference_mode():
        tlog, tcache = make_prefill_step(tcfg, cache_len=S + 2)(model, tbatch)
    enc = {k: tcache["dec"]["stack"]["b0"][k].clone() for k in ("xk", "xv")}
    want = (tcfg.n_layers, B, tcfg.enc_seq, tcfg.n_kv_heads, tcfg.hd)
    for k, t in enc.items():
        assert tuple(t.shape) == want and t.abs().max() > 0
        _close(t, jcache["dec"]["stack"]["b0"][k])
    tok = np.array(jnp.argmax(jlog[:, -1], axis=-1))[:, None]
    for i in range(2):
        jlog, jcache = jax.jit(jax_decode_step(jcfg))(
            jparams, jcache, jnp.asarray(tok), jnp.int32(S + i))
        with torch.inference_mode():
            tlog, _ = make_decode_step(tcfg)(model, tcache, torch.from_numpy(tok),
                                             S + i)
        _close(tlog, jlog)
        for k, t in enc.items():
            assert torch.equal(tcache["dec"]["stack"]["b0"][k], t)
            _close(tcache["dec"]["stack"]["b0"][k], jcache["dec"]["stack"]["b0"][k])
        tok = np.array(jnp.argmax(jlog[:, -1], axis=-1))[:, None]


def test_encoder_decoder_needs_its_frames():
    cfg = ARCHS["whisper-medium"].reduced()
    model = init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="enc_embeds"):
        make_prefill_step(cfg)(model, {"tokens": torch.zeros(1, 4, dtype=torch.long)})
