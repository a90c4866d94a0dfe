"""Exact reference energies (numpy only).

The port's own copy of what its benchmark needs from the JAX package's
``utils/exact.py``: the port imports nothing of the JAX package, not even a
module that uses no JAX. The dense and Lanczos oracles stay there; the
port's tests call them.
"""

from __future__ import annotations

import numpy as np


def tfi_chain_exact_energy(n: int, h: float, j: float) -> float:
    """Exact ground-state energy of the periodic transverse-field Ising chain
    at any even N, by Jordan-Wigner free fermions (Pfeuty, Ann. Phys. 57, 79
    (1970)):

        E0 = -sum_m sqrt(J^2 + h^2 - 2 |J h| cos k_m),  k_m = (2m + 1) pi / N,

    m = 0..N-1, the antiperiodic sector that holds the finite-N ground state.
    For even N both signs of J and h are gauge-equivalent, so only |J| and
    |h| enter (the sign conventions of ``hamiltonians.TFIChain``)."""
    if n % 2 == 1:
        raise ValueError("even N required (sublattice gauge for the J sign)")
    k = (2.0 * np.arange(n) + 1.0) * np.pi / n
    return float(-np.sum(np.sqrt(j * j + h * h - 2.0 * abs(j * h) * np.cos(k))))
