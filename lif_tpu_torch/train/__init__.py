"""Scene fitting: gradient refinement of depth and pose through the soft
plane sweep (fit.py) and its losses (losses.py)."""

from . import fit, losses  # noqa: F401
