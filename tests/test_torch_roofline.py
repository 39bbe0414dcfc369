"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's: its analytic functions equal the reference's exactly, for every
registry arch and every shape (the reference's formulas; the reference's own
dry run, ``tests/test_dryrun_machinery.py``, fails, so its numbers are no
oracle), and a row names its bottleneck."""
import pytest
from torch_id_counters import reference_id_counters_untouched  # noqa: F401

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.launch import roofline as jax_roofline
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import roofline


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_roofline_functions_equal_the_reference(name):
    cfg, jcfg = ARCHS[name], JAX_ARCHS[name]
    assert roofline.active_params(cfg) == jax_roofline.active_params(jcfg)
    for shape in sorted(SHAPES):
        s, js = SHAPES[shape], JAX_SHAPES[shape]
        assert roofline.attention_flops_per_layer(cfg, s.seq, s.batch) \
            == jax_roofline.attention_flops_per_layer(jcfg, js.seq, js.batch)
        assert roofline.model_flops(cfg, s) \
            == jax_roofline.model_flops(jcfg, js)
        for n_chips in (256, 512):
            assert roofline.analytic_memory_bytes(cfg, s, n_chips) \
                == jax_roofline.analytic_memory_bytes(jcfg, js, n_chips)
        assert roofline.cache_bytes(cfg, s.batch, s.seq) \
            == jax_roofline.cache_bytes(jcfg, js.batch, js.seq), shape


def test_roofline_row_names_its_bottleneck():
    cfg, shape = ARCHS["qwen3-0.6b"], SHAPES["train_4k"]
    row = roofline.roofline_row(
        {"arch": cfg.name, "shape": "train_4k", "mesh": "single_pod",
         "n_chips": 256, "hlo_flops": 1e15, "collective_bytes": 1e9},
        cfg, shape)
    assert row["bottleneck"] == "compute"
    assert row["t_compute_s"] == 1e15 / roofline.PEAK_FLOPS
    assert row["useful_ratio"] == roofline.model_flops(cfg, shape) / 256 / 1e15
