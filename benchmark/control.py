"""The readings a cell's check limits are set from.

    python3 benchmark/control.py --workload <cell> --seeds S1 S2 ... \
        [--control-seeds S1 S2 S3] [--fault NAME] [--seconds 2] [--out FILE]

For each seed, in one process: the cell's set-up and a short window at
its own load, then the numbers of the check (lifbench/check.py) for the
program's sampled frames against the float32 reference (the lower
reading), and, on the control seeds, for the control: the cell's
reference computed in bfloat16, put in the program's place at the same
poses, against the float32 reference (the upper reading). With --fault,
each seed instead makes a whole run (trace off) with that fault of
lifbench/faults.py planted around the entry call, and reports its
numbers and whether it came out correct. One JSON line a seed and side.
The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.lifbench import check, faults, harness  # noqa: E402


def readings(root, workload, seed, seconds, control, device=None,
             overrides=None):
    """[(side, numbers)] of one seed: 'program', and 'control' if asked."""
    cell = harness.Cell(root, workload, overrides)
    dev = harness.resolve_device(cell.spec["chips"], device)
    sess = harness.Session(cell, seed, dev)
    sess.warm()
    sample = sess.sampler()
    sess.window(seconds, sample)
    sess.release()
    pairs, _ = sess.compare(sample.slots)
    out = [("program", check.gaps(pairs))]
    if control:
        low, _ = sess.compare(sample.slots, dtype=torch.bfloat16)
        slots = [s._replace(frame=ref) for s, (_, ref) in zip(sample.slots,
                                                              low)]
        out.append(("control", check.gaps(sess.compare(slots)[0])))
    return out


def fault_reading(root, workload, seed, seconds, fault, device=None,
                  overrides=None):
    """(numbers, correct) of one run with `fault` planted."""
    res, rows = harness.run(root, workload, seed, seconds, False,
                            time.perf_counter(), device,
                            faults.FAULTS[fault], overrides)
    return {k: v for k, v, _ in rows}, res["correct"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    lines = []
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        t = time.perf_counter()
        if args.fault:
            numbers, correct = fault_reading(ROOT, args.workload, seed,
                                             args.seconds, args.fault)
            sides = [(f"fault:{args.fault}", numbers, correct)]
        else:
            sides = [(side, numbers, None) for side, numbers in readings(
                ROOT, args.workload, seed, args.seconds,
                seed in args.control_seeds)]
        for side, numbers, correct in sides:
            rec = {"cell": args.workload, "seed": seed, "side": side,
                   "numbers": numbers, "s": time.perf_counter() - t}
            if correct is not None:
                rec["correct"] = correct
            lines.append(json.dumps(rec))
            print(lines[-1], flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
