"""Spreads and bounds from runs of the benchmark.

    python3 benchmark/spread.py RESULTS.jsonl [...]

Each input line is {"cell": name, "set": k, "trace": 0 or 1, "result":
<a run's last line>}; traced runs are left out. Prints, for each metric, each cell's spread per set, the widest
spread and the bound lifbench.bounds sets from it.
"""

import json
import statistics
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.lifbench import bounds  # noqa: E402


def main(paths):
    runs = defaultdict(list)
    for path in paths:
        with open(path) as f:
            for line in f:
                if line.strip():
                    rec = json.loads(line)
                    if rec.get("trace"):
                        continue
                    for name, m in rec["result"]["metrics"].items():
                        runs[name, rec["cell"], rec["set"]].append(m["value"])
    metrics = sorted({k[0] for k in runs})
    for name in metrics:
        sets = {k[1:]: v for k, v in runs.items() if k[0] == name}
        for (cell, s), v in sorted(sets.items()):
            print(f"{name} {cell} set {s}: n={len(v)} median="
                  f"{statistics.median(v)!r} spread={bounds.spread(v):.5f}")
        good = [v for v in sets.values() if len(v) >= 2]
        if good:
            print(f"{name}: widest {max(map(bounds.spread, good)):.5f} "
                  f"bound {bounds.bound(good):.4f}")


if __name__ == "__main__":
    main(sys.argv[1:])
