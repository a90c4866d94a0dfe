"""Site-visit schedules (sublattice proposal orders).

A schedule is an int32 array of site indices, visited in order by every
walker at once, colour class by colour class, so that the sites proposed in
a row never interact: 1D chains visit the even sites, then the odd ones;
the square lattice its black then its white sites; the triangular lattice
its three colours.
"""

from __future__ import annotations

import numpy as np


def chain_checkerboard(n: int) -> np.ndarray:
    """1D: even sites then odd sites."""
    return np.concatenate([np.arange(0, n, 2), np.arange(1, n, 2)]).astype(np.int32)


def square_checkerboard(l: int) -> np.ndarray:
    """2D square L x L (site = i*L + j): black (i+j even) then white."""
    i, j = np.meshgrid(np.arange(l), np.arange(l), indexing="ij")
    sites = (i * l + j).ravel()
    color = ((i + j) % 2).ravel()
    return np.concatenate([sites[color == 0], sites[color == 1]]).astype(np.int32)


def triangular_threecolor(l: int) -> np.ndarray:
    """2D sheared-triangular L x L: the 3-colouring c = (i + j) mod 3, valid
    for the neighbour offsets {(-1,-1), (-1,0), (0,-1), (0,1), (1,0), (1,1)}
    (each has (di + dj) % 3 != 0)."""
    i, j = np.meshgrid(np.arange(l), np.arange(l), indexing="ij")
    sites = (i * l + j).ravel()
    color = ((i + j) % 3).ravel()
    return np.concatenate([sites[color == c] for c in range(3)]).astype(np.int32)


def sequential(n: int) -> np.ndarray:
    """Plain 0..N-1 sweep (the measurement sampler's order)."""
    return np.arange(n, dtype=np.int32)
