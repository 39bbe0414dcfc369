"""The port's partition specs (``repro_torch.models.lm.param_pspecs`` and
``cache_pspecs``) against the reference's: every registry model's parameter
tree and decode cache tree (``decode_32k``'s batch and context), under the
three profiles, on the 16 x 16 and 2 x 16 x 16 production shapes (the
``FakeMesh`` stub of ``tests/test_sharding_rules.py``), entry for entry."""
import pytest
from jax.sharding import PartitionSpec as JP
from torch_id_counters import reference_id_counters_untouched  # noqa: F401

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.models import lm as jax_lm
from repro_torch.configs import ARCHS
from repro_torch.models import lm
from repro_torch.models.sharding import PROFILES


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESH = FakeMesh({"data": 16, "model": 16})
MESH3 = FakeMesh({"pod": 2, "data": 16, "model": 16})


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _same(port: dict, ref: dict) -> None:
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert isinstance(ref[k], JP), k
        assert tuple(port[k]) == tuple(ref[k]), (k, port[k], ref[k])


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_and_cache_specs_match_the_reference(name):
    cfg, jcfg = ARCHS[name], JAX_ARCHS[name]
    shape = JAX_SHAPES["decode_32k"]
    for profile in sorted(PROFILES):
        for mesh in (MESH, MESH3):
            _same(_flat(lm.param_pspecs(cfg, mesh, profile)),
                  _flat(jax_lm.param_pspecs(jcfg, mesh, profile)))
            _same(_flat(lm.cache_pspecs(cfg, shape.batch, shape.seq, mesh,
                                        profile)),
                  _flat(jax_lm.cache_pspecs(jcfg, shape.batch, shape.seq,
                                            mesh, profile)))
