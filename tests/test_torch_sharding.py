"""The port's logical-axis sharding (``repro_torch.models.sharding``) against
the reference's (``repro.models.sharding``).

- ``tests/test_sharding_rules.py``'s eight cases through the port's
  ``spec_for``, on the same ``FakeMesh`` stub (a mesh's ``shape`` alone);
- (``tests/test_torch_sharding_specs.py``: every registry model's
  parameter and cache specs against the reference's);
- the order in which a dimension sharded over several mesh axes jointly is
  split: on 2 x 2 and 2 x 2 x 2 meshes each rank's block under the port's
  DTensor placements (the port's ``distribute``, and DTensor's own offset)
  is the block JAX's ``PartitionSpec`` gives that device (a subprocess with
  eight host devices for JAX and a fake process group for each rank);
- ``constrain`` returns its input outside a mesh.
"""
import json
import os
import subprocess
import sys

import torch
from torch_id_counters import reference_id_counters_untouched  # noqa: F401

from repro_torch.models.sharding import (ACT_RULES, PROFILES, P, constrain,
                                         mesh_context, spec_for)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESH = FakeMesh({"data": 16, "model": 16})
MESH3 = FakeMesh({"pod": 2, "data": 16, "model": 16})


# ---- tests/test_sharding_rules.py's cases, through the port -------------
def test_vocab_divisible_shards_on_model():
    assert spec_for((256000, 8192), ("vocab", "embed+"), MESH) \
        == P("model", "data")


def test_vocab_indivisible_falls_back():
    spec = spec_for((51865, 1024), ("vocab", "embed+"), MESH)
    assert spec[0] is None
    assert spec[1] == "data"


def test_kv_heads_indivisible_replicates():
    spec = spec_for((128, 32768, 8, 128), ("batch", None, "kv_heads", None),
                    MESH)
    assert spec == P("data", None, None, None)


def test_no_axis_reuse_within_param():
    spec = spec_for((64, 128, 4096), ("heads", "ffn", None), MESH)
    assert spec[0] == "model" and spec[1] is None


def test_batch_one_replicates():
    assert spec_for((1, 1), ("batch", None), MESH, rules=ACT_RULES) \
        == P(None, None)


def test_multipod_batch_uses_pod_and_data():
    assert spec_for((256, 4096), ("batch", None), MESH3, rules=ACT_RULES) \
        == P(("pod", "data"), None)


def test_fsdp_profile_shards_over_both_axes():
    spec = spec_for((8192, 22528), ("embed", "ffn"), MESH,
                    rules=PROFILES["fsdp"][0])
    assert spec[0] == ("data", "model")


def test_inference_tp_profile_no_fsdp_dim():
    spec = spec_for((8192, 64, 128), ("embed", "heads", "head_dim"), MESH,
                    rules=PROFILES["inference-tp"][0])
    assert spec == P(None, "model", None)


# ---- the joint-axis shard order, against JAX's PartitionSpec ------------
ORDER_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax
import numpy as np
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from repro_torch.launch.mesh import fake_process_group, make_mesh
from repro_torch.models.sharding import P, distribute, placements

CASES = [  # (mesh shape, axes, tensor shape, spec)
    ((2, 2), ("data", "model"), (8, 4), (("data", "model"), None)),
    ((2, 2), ("data", "model"), (8, 4), ("data", "model")),
    ((2, 2), ("data", "model"), (8, 4), ("model", "data")),
    ((2, 2, 2), ("pod", "data", "model"), (8, 4), (("pod", "data"), None)),
    ((2, 2, 2), ("pod", "data", "model"), (8, 4), (("pod", "data"), "model")),
    ((2, 2, 2), ("pod", "data", "model"), (16, 4),
     (("pod", "data", "model"), None)),
    ((2, 2, 2), ("pod", "data", "model"), (8, 4), (("data", "model"), "pod")),
]
out = []
for dims, axes, shape, spec in CASES:
    n = int(np.prod(dims))
    jmesh = jax.make_mesh(dims, axes, devices=jax.devices()[:n])
    index = NamedSharding(jmesh, JP(*spec)).devices_indices_map(shape)
    full = torch.arange(int(np.prod(shape))).reshape(shape)
    for coord in np.ndindex(*dims):
        rank = int(np.ravel_multi_index(coord, dims))
        want = full[tuple(index[jmesh.devices[coord]])]
        with fake_process_group(n, rank=rank):
            mesh = make_mesh(dims, axes, "cpu")
            assert tuple(mesh.device_mesh.get_coordinate()) == coord
            got = distribute(full, mesh, P(*spec)).to_local()
            lshape, offset = compute_local_shape_and_global_offset(
                shape, mesh.device_mesh, placements(P(*spec), mesh))
            block = full[tuple(slice(o, o + s) for o, s in zip(offset, lshape))]
        out.append({"case": repr((dims, spec)), "coord": list(coord),
                    "distribute": bool(torch.equal(got, want)),
                    "dtensor": bool(torch.equal(block, want))})
print(json.dumps(out))
"""


def test_joint_axes_shard_in_jax_order():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", ORDER_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(rows) == 3 * 4 + 4 * 8
    bad = [r for r in rows if not (r["distribute"] and r["dtensor"])]
    assert not bad, bad


def test_constrain_is_the_identity_outside_a_mesh():
    x = torch.randn(2, 3, 4)
    assert constrain(x, "batch", None, "heads") is x
    with mesh_context(None):
        assert constrain(x, "batch", None, "heads") is x
