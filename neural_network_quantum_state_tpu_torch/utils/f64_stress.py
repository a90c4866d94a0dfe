"""Inputs that stress the arithmetic of the float64 instances of the energy
kernel (``csrc/energy.cu``, ``ops/energy.py::offdiag_sum_cuda``), the sweep
kernel (``csrc/sweep_f64.cu``) and the exchange kernel
(``csrc/exchange_f64.cu``): large |Re w|, products that leave the double
range, units near a zero of cosh. Made from a numpy seed; their tests and
``chip_smoke.py`` hold the instances to the plain float64 versions on
them."""

from __future__ import annotations

import math

import numpy as np

# The cases of f64_stress_inputs, every float64 kernel's.
F64_STRESS = ("scale 0.4", "large Re w", "overflow", "near a zero of cosh", "Re w 25")


def f64_stress_inputs(case: str, has_c: bool, seed: int = 0, n: int = 16, k: int = 64):
    """(w, b, a, c, spins) as complex128 / float64 numpy arrays, made from
    `seed`, for one of ``F64_STRESS``: the RBM family (c None) or the FFNN
    family (a None). "scale 0.4": every parameter 0.4 (N(0, 1) + i N(0, 1)),
    H = 64. "large Re w": the same with one weight in 16 at |Re w| in [2, 3],
    where cosh(2w) - tanh(y) sinh(2w) would cancel, H = 96. "overflow":
    H = 512 and Re w of site 0 in [1, 1.5] at every unit, so that the
    product of that site's factors leaves the double range without a running
    exponent (above it for s = +1, below for -1) while the ratio stays
    moderate. "near a zero of cosh": H = 64, and in four walkers one unit
    each at y within 1e-3 (both planes) of i pi/2. "Re w 25": H = 128, Re w
    of site 0 at 25 and Re b shifted by -25 at every unit, so that a flip of
    s_0 = +1 takes each unit's factor |c + u e^{4 s w}|^2 to about e^{200}
    (four of them leave the double range) and its cosh ratio to about e^{50};
    without c, Re a_0 brings the median walker's ratio |psi'/psi| of that
    flip to 1, so that it is decided by the uniforms."""
    rng = np.random.default_rng(seed)
    h = {"scale 0.4": 64, "large Re w": 96, "overflow": 512, "near a zero of cosh": 64, "Re w 25": 128}[case]

    def cnormal(*shape, scale=0.4):
        return scale * (rng.normal(size=shape) + 1j * rng.normal(size=shape))

    w, b = cnormal(n, h), cnormal(h)
    a, c = (None, cnormal(h)) if has_c else (cnormal(n), None)
    spins = np.where(rng.random((k, n)) < 0.5, -1.0, 1.0)
    if case == "large Re w":
        big = rng.random((n, h)) < 1.0 / 16
        w.real[big] = np.sign(rng.normal(size=int(big.sum()))) * rng.uniform(2.0, 3.0, size=int(big.sum()))
    elif case == "overflow":
        w.real[0] = rng.uniform(1.0, 1.5, size=h)
    elif case == "near a zero of cosh":
        for walker, unit in zip(range(4), rng.choice(h, size=4, replace=False)):
            y = spins[walker] @ w[:, unit] + b[unit]
            target = complex(rng.uniform(-1e-3, 1e-3), math.pi / 2 + rng.uniform(-1e-3, 1e-3))
            b[unit] += target - y
    elif case == "Re w 25":
        w.real[0] = 25.0
        b.real -= 25.0
        if not has_c:
            y = spins[spins[:, 0] > 0] @ w + b
            ln_ratio = (np.log(np.abs(np.cosh(y - 50.0))) - np.log(np.abs(np.cosh(y)))).sum(1)
            a.real[0] = 0.5 * np.median(ln_ratio)  # |psi'/psi|^2 = e^{-4 Re a_0 + 2 ln_ratio}
    return w, b, a, c, spins
