"""The arithmetic that sets a bound from measured runs.

A set is the runs of one cell on one code; its spread is the distance
between the first and third quartiles (Python's statistics.quantiles,
n=4) as a share of the median. A metric's bound is about five times the
widest spread over the cells, never under 1%, and at most 25%.
"""

from __future__ import annotations

import statistics

FACTOR = 5.0
FLOOR = 0.01
CEILING = 0.25


def spread(values) -> float:
    """Interquartile distance over the median of one set of runs."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(statistics.median(values))


def bound(sets) -> float:
    """The bound of a metric from its sets of runs (every cell's two
    sets): FACTOR times the widest spread, between FLOOR and CEILING."""
    widest = max(spread(v) for v in sets)
    return min(CEILING, max(FLOOR, FACTOR * widest))
