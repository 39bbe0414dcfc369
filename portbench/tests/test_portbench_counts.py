"""The frozen counts, pinned to hand counts at the cells' shapes."""
import math

import pytest

import _small  # noqa: F401  (puts the checkout on the path)
from portbench import harness
from portbench.counts import categories, flops, kernels


def _conf(name):
    conf = harness.load("configs", name)
    fam = __import__(f"portbench.reference.{conf['family']}",
                     fromlist=["layout"])
    n = sum(math.prod(s[1]) for s in fam.layout(conf["config"]))
    return conf["config"], n


def test_parameter_counts():
    c, n = _conf("granite-moe-3b-a800m")
    assert n == 3_298_793_472
    assert flops.active_params(c, n) == 882_874_368
    c, n = _conf("mamba2-780m")
    assert n == 780_161_280 and flops.active_params(c, n) == n


@pytest.mark.parametrize("config,kind,expect", [
    ("granite-moe-3b-a800m", "train", 48_342_843_260_928),
    ("mamba2-780m", "train", 42_057_338_978_304),
    ("granite-moe-3b-a800m", "prefill", 16_114_281_086_976),
])
def test_model_flops(config, kind, expect):
    """6 N_active B S + 3 L attn for training, 2 N_active B S + L attn for a
    prefill, at batch 4 x 2048: granite 6 * 882,874,368 * 8,192 +
    3 * 32 * (2 * 4 * 2048^2 * 24 * 64); mamba2 6 * 780,161,280 * 8,192 +
    3 * 48 * 2 * 8,192 * (256 * 3072 + 2 * 3072 * 128)."""
    c, n = _conf(config)
    assert flops.model_flops(c, n, kind, 4, 2048) == expect


def test_flash_counts_are_the_causal_pairs():
    pairs = 2048 * 2049 // 2
    f, b = kernels.flash_fwd(4, 2048, 24, 8, 64, lse=True)
    assert f == 4 * 4 * 24 * 64 * pairs
    assert b == 2 * (2 * 4 * 2048 * 24 * 64 + 2 * 4 * 2048 * 8 * 64) \
        + 4 * 4 * 24 * 2048
    f, b = kernels.flash_bwd(4, 2048, 24, 8, 64)
    assert f == 10 * 4 * 24 * 64 * pairs
    # a tile-counting yardstick (whole 128 x 64 diagonal tiles) would read more
    tiles = sum(-(-min(2048, q0 + 128) // 64) for q0 in range(0, 2048, 128))
    assert 4 * 64 * 128 * 64 * 4 * 24 * tiles > kernels.flash_fwd(
        4, 2048, 24, 8, 64, lse=False)[0]
    assert kernels.bound_s(*kernels.flash_fwd(4, 2048, 24, 8, 64, lse=True)) \
        == pytest.approx(5.2117e-5, rel=1e-4)


def test_ssd_counts():
    Bt, S, H, P, G, N, Q = 4, 2048, 48, 64, 1, 128, 256
    pairs, nc = Q * (Q + 1) // 2, S // Q
    fwd = (2 * Bt * nc * G * N * pairs + 2 * Bt * nc * H * P * pairs
           + 2 * 2 * Bt * S * H * P * N + 2 * Bt * nc * H * P * N)
    f, b = kernels.ssd_fwd(Bt, S, H, P, G, N, Q)
    assert f == fwd
    assert b == 2 * (2 * Bt * S * H * P + 2 * Bt * S * G * N) \
        + 4 * Bt * S * H + 8 * H + 4 * Bt * H * P * N
    f, _ = kernels.ssd_bwd(Bt, S, H, P, G, N, Q)
    assert f == 2 * fwd + 2 * Bt * nc * G * N * pairs
    # memory-bound at this shape: bytes over 3.35e12
    assert kernels.bound_s(*kernels.ssd_fwd(Bt, S, H, P, G, N, Q)) == \
        pytest.approx(b / 3.35e12)


@pytest.mark.parametrize("name,group", [
    ("void flash_attn_fwd_tc_kernel<64>(FwdParams)", categories.HAND_WRITTEN),
    ("void flash_attn_bwd_dkdv_wg_kernel<64>(BwdParams)", categories.HAND_WRITTEN),
    ("ssd_bwd_chunk_tc_kernel", categories.HAND_WRITTEN),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT", categories.MATMUL_BF16),
    ("ampere_sgemm_128x64_nn", categories.MATMUL_F32),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", categories.OTHER),
    ("Memcpy HtoD (Pageable -> Device)", categories.OTHER),
])
def test_categories(name, group):
    assert categories.category(name) == group


def test_kernel_parts():
    fp, sp = categories.flash_part, categories.ssd_part
    assert fp("void flash_attn_fwd_tc_kernel<64>") == "fwd"
    assert fp("void flash_attn_bwd_dkdv_wg_kernel<64>") == "bwd"
    assert fp("flash_attn_bwd_dq_wg_kernel") == "bwd_other"
    assert fp("flash_attn_bwd_pre_kernel") == "bwd_other"
    assert sp("ssd_chunk_scan_kernel") == "fwd"
    assert sp("ssd_chunk_state_kernel") == "fwd_other"
    assert sp("ssd_state_pass_kernel") == "fwd_other"
    assert sp("ssd_bwd_chunk_tc_kernel") == "bwd"
    assert sp("ssd_bwd_dstate_tc_kernel") == "bwd_other"
    assert fp("ampere_sgemm") is None and sp("ampere_sgemm") is None
