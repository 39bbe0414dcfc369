"""Multi-pod dry run (``repro/launch/dryrun.py``): trace every (architecture
× input shape) cell's step on the production meshes and extract the roofline
terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k --mesh single_pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --arch smollm-135m --shape decode_32k

A cell runs its step once on fake DTensors (``launch.specs``) over a fake
process group of the mesh's size, created and destroyed inside the cell:
no data, no memory, nothing allocated on the card.  On ``--device cuda``
(the default) the fake tensors are CUDA tensors, so the kernels' custom ops
are traced with their flop formulas; ``--device cpu`` traces the plain
versions instead, as the wrappers take them for a CPU tensor.  Results are
cached per cell in a JSON file so interrupted sweeps resume for free.

Per cell we record:
  * per-device FLOPs, collective bytes by kind and collectives
    (``trace_analysis.analyze_step``),
  * per-device bytes of the state's local shards (parameters, AdamW
    moments, decode cache) beside the card's HBM (``roofline.HBM_BYTES``),
  * ``roofline.roofline_row``: the three roofline terms against the H100's
    constants,
  * the trace's wall seconds.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from ..configs import ARCHS, SHAPES, shape_applicable
from ..models import lm
from ..models.params import flatten, spec_tree
from ..models.sharding import PROFILES, mesh_context
from ..models.steps import make_decode_step, make_prefill_step, make_train_step
from . import roofline
from .mesh import fake_process_group, make_mesh
from .specs import input_specs
from .trace_analysis import analyze_step


def step_fn(cfg, kind: str):
    if kind == "train":
        return make_train_step(cfg)
    if kind == "prefill":
        return make_prefill_step(cfg)
    return make_decode_step(cfg)


def state_bytes(cfg, shape, mesh, profile: str = "2d") -> dict:
    """Bytes of this rank's shards of the parameters, the AdamW moments
    (training) and the decode cache."""
    def local(defs, default):
        specs = flatten(spec_tree(defs, mesh, PROFILES[profile][0]))
        total = 0
        for key, d in flatten(defs).items():
            split = math.prod(mesh.shape[n] for e in specs[key] if e is not None
                              for n in ((e,) if isinstance(e, str) else e))
            dtype = getattr(torch, d.dtype or default)
            total += math.prod(d.shape) // split \
                * torch.empty((), dtype=dtype).element_size()
        return total

    out = {"params": local(lm.model_defs(cfg), cfg.param_dtype)}
    if shape.kind == "train":
        out["moments"] = 2 * out["params"]
    if shape.kind == "decode":
        out["cache"] = local(lm.cache_defs(cfg, shape.batch, shape.seq),
                             cfg.compute_dtype)
    out["total"] = sum(out.values())
    return out


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             profile: str = "2d", mesh_shape=None, device: str = "cuda",
             cfg=None, shape=None):
    """One cell on the production mesh (or a logical ``mesh_shape`` re-mesh
    of the pod, or any (shape, axes) given as ``mesh_shape``); ``cfg`` and
    ``shape`` replace the registry's (reduced configs, small shapes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = cfg or ARCHS[arch]
    shape = shape or SHAPES[shape_name]
    if mesh_shape is None:
        dims = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    elif isinstance(mesh_shape[0], int):  # a DxM re-mesh of the pod
        dims, axes = tuple(mesh_shape), ("data", "model")
    else:
        dims, axes = mesh_shape
    n_chips = math.prod(dims)
    with fake_process_group(n_chips):
        mesh = make_mesh(dims, axes, device)
        t0 = time.perf_counter()
        with FakeTensorMode(), mesh_context(mesh, profile):
            inputs = input_specs(cfg, shape, mesh, profile, device)
            res = analyze_step(step_fn(cfg, shape.kind), *inputs)
        trace_s = time.perf_counter() - t0
        held = state_bytes(cfg, shape, mesh, profile)
    out = {"arch": arch, "shape": shape_name, "profile": profile,
           "mesh": "multi_pod" if multi_pod else "single_pod",
           "mesh_shape": "x".join(map(str, dims)), "device": device,
           "n_chips": n_chips, "ok": True, "trace_s": trace_s,
           # the reference's key for the per-device FLOPs
           "hlo_flops": res["flops"], "kernel_flops": res["kernel_flops"],
           "collective_bytes": res["collective_bytes"],
           "collective_by_kind": res["collective_by_kind"],
           "collective_ops": res["collective_ops"],
           "collective_sites": dict(list(res["collective_sites"].items())[:8]),
           "state_bytes_per_device": held, "hbm_bytes": roofline.HBM_BYTES,
           "fits": held["total"] <= roofline.HBM_BYTES}
    out["roofline"] = roofline.roofline_row(out, cfg, shape)
    out["bottleneck"] = out["roofline"]["bottleneck"]
    return out


def cells(archs=None, shapes=None):
    for a in sorted(archs or ARCHS):
        for s in (shapes or SHAPES):
            if shape_applicable(ARCHS[a], SHAPES[s]):
                yield a, s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--mesh", choices=["single_pod", "multi_pod", "both"],
                    default="both")
    ap.add_argument("--profile", default="2d",
                    choices=["2d", "fsdp", "inference-tp"])
    ap.add_argument("--mesh-shape", default=None,
                    help="logical DxM re-mesh of the 256-chip pod, e.g. 64x4")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device: cuda traces the kernels, "
                         "cpu their plain versions")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):  # --force re-runs cells but never drops data
        with open(args.out) as f:
            results = json.load(f)

    meshes = (["single_pod", "multi_pod"] if args.mesh == "both"
              else [args.mesh])
    todo = [(a, s, m) for a, s in cells(args.arch, args.shape)
            for m in meshes]
    print(f"dry-run: {len(todo)} cells, device={args.device}")
    mesh_shape = None
    if args.mesh_shape:
        mesh_shape = tuple(int(x) for x in args.mesh_shape.split("x"))
    for a, s, m in todo:
        key = f"{a}|{s}|{m}" + ("" if args.profile == "2d"
                                else f"|{args.profile}")
        if mesh_shape:
            key += f"|mesh{args.mesh_shape}"
        if args.device != "cuda":
            key += f"|{args.device}"
        if key in results and results[key].get("ok") and not args.force:
            print(f"[cached] {key}")
            continue
        print(f"[run]    {key} ...", flush=True)
        try:
            r = run_cell(a, s, multi_pod=(m == "multi_pod"),
                         profile=args.profile, mesh_shape=mesh_shape,
                         device=args.device)
        except Exception as e:
            r = {"arch": a, "shape": s, "mesh": m, "ok": False,
                 "error": f"{type(e).__name__}: {e}",
                 "traceback": traceback.format_exc()[-2000:]}
            print(f"  FAILED: {r['error']}")
        results[key] = r
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        if r.get("ok"):
            print(f"  ok: trace={r['trace_s']:.1f}s "
                  f"flops={r['hlo_flops']:.3g} "
                  f"coll={r['collective_bytes']:.3g}B "
                  f"state={r['state_bytes_per_device']['total']:.3g}B "
                  f"bottleneck={r['bottleneck']}")
    bad = [k for k, v in results.items() if not v.get("ok")]
    print(f"done: {len(results) - len(bad)} ok, {len(bad)} failed")
    for k in bad:
        print(f"  FAIL {k}: {results[k].get('error')}")
    return results


if __name__ == "__main__":
    main()
