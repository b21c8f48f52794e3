#!/usr/bin/env python3
"""Run lif_tpu_torch.bench.throughput on the card.

That module says what it measures, its options and what it prints;
``python3 bench_torch.py --help`` lists the options."""

import sys

from lif_tpu_torch.bench.throughput import main

if __name__ == "__main__":
    sys.exit(main())
