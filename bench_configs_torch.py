#!/usr/bin/env python3
"""Run lif_tpu_torch.bench.configs on the card.

That module says what it measures, its options and what it prints;
``python3 bench_configs_torch.py --help`` lists the options."""

import sys

from lif_tpu_torch.bench.configs import main

if __name__ == "__main__":
    sys.exit(main())
