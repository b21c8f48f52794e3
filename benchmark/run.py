"""Run one cell of the benchmark of lif_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks
for. It builds the cell's scene on the card from the seed, warms up,
drives the cell's entry point in a closed loop for --seconds, checks a
seeded sample of the frames against the plain reference, and prints one
JSON line last on standard output: the cell's end-to-end metrics with
--trace 0, its per-layer metrics (from torch.profiler over the window)
with --trace 1. The numbers compared, each with its limit, are the last
lines on standard error. Without the cards it exits 3 and prints no
result; where a module of JAX or of the JAX package was loaded in the
run, it names it on standard error, exits 4 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "benchmark" / ".cache"
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
# load from one process with few threads: the host path is one Python
# thread, and idle worker pools only add jitter
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.lifbench import harness

    torch.set_num_threads(1)

    try:
        result, rows = harness.run(ROOT, args.workload, args.seed,
                                   args.seconds, bool(args.trace), T_START)
    except harness.NoDevice as err:
        print(f"no result: {err}", file=sys.stderr)
        return 3
    except harness.Forbidden as err:
        print(f"no result: {err}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for name, value, limit in rows:
        held = "not held" if limit is None else f"limit {limit!r}"
        print(f"check {name} {value!r} {held}", file=sys.stderr)
    print(f"check correct {result['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
