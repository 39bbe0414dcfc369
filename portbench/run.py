"""Runs one cell of the benchmark once, on the machine it is started on:

    python3 portbench/run.py --workload granite-moe-3b-a800m.train \
        --seed 12345 --seconds 30 --trace 0

From the root of a checkout (``src`` is put on the path here).  Exits
non-zero, printing no result, without as many CUDA devices as the cell asks
for, or where JAX or the JAX package is loaded once the window has closed.
With ``--trace 0`` the result's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer ones, read from a profiled stretch after
the window.  The last lines on standard error give each number the check
compared beside its limit; the last line on standard output is the result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    # the program builds its kernels under build/ in the checkout; any
    # Triton cache goes there too, at a fixed path
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    import torch
    from portbench import harness
    try:
        chips = harness.cell_of(args.workload)["chips"]
    except Exception as e:  # an unknown cell or a missing BENCHMARK.json
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"[portbench] {args.workload} seed {args.seed} on "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          file=sys.stderr, flush=True)
    try:
        out = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), T_START)
    except Exception:
        traceback.print_exc()
        return 1
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package is loaded: {found}",
              file=sys.stderr)
        return 1
    for k, v in out["checks"].items():
        print(f"[check] {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(f"[check] correct {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
