"""Site-visit schedules (sublattice proposal orders).

A schedule is an int32 array of site indices, visited in order by every
walker at once; 1D chains visit the even sites, then the odd ones.
"""

from __future__ import annotations

import numpy as np


def chain_checkerboard(n: int) -> np.ndarray:
    """1D: even sites then odd sites."""
    return np.concatenate([np.arange(0, n, 2), np.arange(1, n, 2)]).astype(np.int32)
