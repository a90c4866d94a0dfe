"""Exact diagonalization of small spin and Hubbard systems (numpy and scipy).

The port's own copy of the JAX package's ``utils/exact.py``, every public
function with its name, signature and conventions: the port imports nothing
of the JAX package, not even a module that uses no JAX, and the card's
machine has no JAX. These are the hard anchors of the port's tests, of its
example studies and of ``chip_smoke.py``: ground-state energies for the TFI
family in the reference's conventions

    H = sum_{i<j} J_ij sigma^z_i sigma^z_j + h sum_i sigma^x_i

(s = +-1 eigenbasis of sigma^z; local energy htilda = diag + h * sum_i
psi(flip_i s)/psi(s), optionally scaled 1/L for LITFIChain), and the
Jordan-Wigner Hubbard chain of ``hamiltonians.HubbardChain``. Basis index
bit i is site i, with s = +1 for bit value 0.
"""

from __future__ import annotations

import math

import numpy as np


def _spins_table(n: int) -> np.ndarray:
    """(2^n, n) array of s_i = +-1; bit 0 of the index is site 0, with
    s = +1 for bit value 0."""
    idx = np.arange(2**n)[:, None]
    bits = (idx >> np.arange(n)[None, :]) & 1
    return 1.0 - 2.0 * bits


def _litfi_couplings(n: int, j: float, alpha: float, pbc: bool) -> np.ndarray:
    """J_ik = j / d(i, k)^alpha, d the (circular, with pbc) distance; zero diagonal."""
    i, k = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    d = np.abs(i - k).astype(np.float64)
    if pbc:
        d = np.minimum(d, n - d)
    with np.errstate(divide="ignore"):
        jm = j * d**-alpha
    np.fill_diagonal(jm, 0.0)
    return jm


def tfi_hamiltonian_dense(j_matrix: np.ndarray, h: float, scale: float = 1.0) -> np.ndarray:
    """Dense H for H = 0.5*sum_{i,j} J_ij sz_i sz_j + h*sum_i sx_i, scaled.

    j_matrix is the full symmetric coupling matrix with zero diagonal (the
    0.5 matches diag = 0.5 * s.J.s of the local energies).
    """
    n = j_matrix.shape[0]
    dim = 2**n
    s = _spins_table(n)
    ham = np.diag(0.5 * np.einsum("ki,ij,kj->k", s, j_matrix, s)).astype(np.float64)
    rows = np.arange(dim)
    for i in range(n):  # sigma^x_i flips bit i
        ham[rows, rows ^ (1 << i)] += h
    return ham * scale


def tfi_chain_dense(n: int, h: float, j: float) -> np.ndarray:
    jm = np.zeros((n, n))
    for i in range(n):
        jm[i, (i + 1) % n] += j
        jm[(i + 1) % n, i] += j
    return tfi_hamiltonian_dense(jm, h)


def litfi_chain_dense(n: int, h: float, j: float, alpha: float, pbc: bool = True) -> np.ndarray:
    # per-site energy scale 1/L, as LITFIChain's local energy
    return tfi_hamiltonian_dense(_litfi_couplings(n, j, alpha, pbc), h, scale=1.0 / n)


def hubbard_chain_dense(
    l: int,
    u: float,
    t: float,
    pbc: bool = True,
    v: np.ndarray | None = None,
    scale_per_site: bool = True,
) -> np.ndarray:
    """Dense Jordan-Wigner spin-basis Hubbard chain H matching
    hamiltonians.HubbardChain's local-energy conventions (occupied = +1;
    inputs [0, L) up, [L, 2L) down).

    H[s, s'] is built so that Etilde(s) = sum_s' H[s, s'] psi(s')/psi(s)."""
    n = 2 * l
    dim = 2**n
    s = _spins_table(n)
    ham = np.zeros((dim, dim))
    idx = np.arange(dim)

    def flip2(a, b):
        return idx ^ (1 << a) ^ (1 << b)

    for off in (0, l):  # interior hopping, both directions, both flavors
        for i in range(l - 1):
            for a, b in ((off + i, off + i + 1), (off + i + 1, off + i)):
                ham[idx, flip2(a, b)] += -0.25 * t * (1.0 + s[:, a]) * (1.0 - s[:, b])
        if pbc:  # the wrap bond carries the Jordan-Wigner string of the sites between
            a, b = off, off + l - 1
            string = np.prod(-s[:, off + 1 : off + l - 1], axis=1)
            ham[idx, flip2(a, b)] += -0.25 * t * 2.0 * string * (1.0 - s[:, a] * s[:, b])
    diag = 0.25 * u * np.sum((1.0 + s[:, :l]) * (1.0 + s[:, l:]), axis=1)  # onsite
    if v is not None:  # the site potential
        diag = diag + 0.5 * np.sum(np.asarray(v)[None, :] * (1.0 + s), axis=1)
    ham[idx, idx] += diag
    if scale_per_site:
        ham /= l
    return ham


def sector_restrict(ham: np.ndarray, l: int, n_up: int, n_down: int) -> tuple[np.ndarray, np.ndarray]:
    """Restrict a 2L-spin Hubbard H to the (n_up, n_down) particle sector.
    Returns (H_sector, basis indices)."""
    occ = (1 + _spins_table(2 * l)) / 2
    sel = np.where((occ[:, :l].sum(1) == n_up) & (occ[:, l:].sum(1) == n_down))[0]
    return ham[np.ix_(sel, sel)], sel


def ground_energy(ham: np.ndarray) -> float:
    return float(np.linalg.eigvalsh(ham)[0])


def ground_state(ham: np.ndarray) -> tuple[float, np.ndarray]:
    w, v = np.linalg.eigh(ham)
    return float(w[0]), v[:, 0]


def spins_to_index(spins: np.ndarray) -> np.ndarray:
    """Map (-1/+1)^n spin rows to basis indices of _spins_table ordering."""
    n = spins.shape[-1]
    bits = ((1.0 - spins) / 2).astype(np.int64)
    return (bits << np.arange(n)).sum(axis=-1)


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


def litfi_ground_state_lanczos(n: int, theta: float, alpha: float, pbc: bool = True) -> tuple[float, np.ndarray]:
    """(E0, psi0) of the long-range AFM TFI chain (J = sin theta,
    h = -cos theta, 1/L scale: LITFIChain's conventions) by sparse Lanczos.

    The dense builder (litfi_chain_dense) caps out around N = 14; this
    matrix-free operator reaches N ~ 22 on a host: the diagonal is computed
    once over all 2^N states and the sigma^x term is N bit-flip gathers per
    matvec."""
    from scipy.sparse.linalg import LinearOperator, eigsh

    jm = _litfi_couplings(n, math.sin(theta), alpha, pbc)
    dim = 2**n
    s = _spins_table(n)
    diag = (0.5 / n) * np.einsum("ki,ij,kj->k", s, jm, s)
    hn = -math.cos(theta) / n
    flips = [np.arange(dim) ^ (1 << b) for b in range(n)]

    def matvec(v):
        out = diag * v
        for f in flips:
            out = out + hn * v[f]
        return out

    w, v = eigsh(LinearOperator((dim, dim), matvec=matvec, dtype=np.float64), k=1, which="SA")
    return float(w[0]), v[:, 0]


def litfi_binder_exact(n: int, theta: float, alpha: float, pbc: bool = True) -> dict:
    """Exact ground-state staggered-magnetization moments and Binder
    cumulant of the LITFI chain: m_s = (1/N) sum_i (-1)^i s_i over
    |psi0(s)|^2 (the distribution the stag estimator samples,
    drivers.measure -what=stag)."""
    _, psi = litfi_ground_state_lanczos(n, theta, alpha, pbc)
    p = psi**2
    p /= p.sum()
    stag = (_spins_table(n) * np.where(np.arange(n) % 2 == 0, 1.0, -1.0)).sum(axis=1) / n
    m1 = float(np.abs(stag) @ p)
    m2 = float((stag**2) @ p)
    m4 = float((stag**4) @ p)
    return {"m1": m1, "m2": m2, "m4": m4, "U": 1.0 - m4 / (3.0 * m2**2)}
