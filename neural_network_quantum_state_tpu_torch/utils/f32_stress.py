"""Inputs that stress the arithmetic of the float32 factor-form megakernel
(``csrc/sweep_energy.cu``, ``ops/sweep_energy.py::sweeps_offdiag_cuda``):
weights at the edge of its range, units near a zero of cosh, large |Re y|.
Made from a numpy seed; its tests and ``chip_smoke.py`` hold the kernel (and
its numpy model) to the plain megakernel in float64 on them, since the plain
float32 version's dln = ln psi' - ln psi loses |ln psi| 2^-24 there (about
3e-4 at the |ln psi| of 5000 that "Re w 20" reaches)."""

from __future__ import annotations

import math

import numpy as np

# The cases of f32_stress_inputs.
F32_STRESS = ("Re w 20", "near a zero of cosh", "large Re y")
# The megakernel's range (ops/engine.py F32_MAX_RE_W), which "Re w 20" sits on.
STRESS_RE_W = 20.0


def f32_stress_inputs(case: str, seed: int = 0, n: int = 16, k: int = 64):
    """(w, b, a, spins) as complex128 / float64 numpy arrays of the RBM family
    (the megakernel's), made from `seed`, every parameter 0.4 (N(0, 1) +
    i N(0, 1)) but as the case says. "Re w 20": H = 128, Re w of site 0 at
    20 and Re b shifted by -20 at every unit, so that a flip of s_0 takes each
    unit's factor |c + u e^{4 s w}|^2 to about e^{160} (two of them leave the
    float32 range) and its cosh ratio to about e^{40}; Re a_0 brings the
    median walker's ratio |psi'/psi| of that flip to 1, so that it is decided
    by the uniforms. "near a zero of cosh": H = 64, and in four walkers one
    unit each at y within 1e-3 (both planes) of i pi/2. "large Re y": H = 80
    and Re b shifted by 50 of a random sign at every unit, so that every
    e^{-2|Re y|} is subnormal in float32."""
    rng = np.random.default_rng(seed)
    h = {"Re w 20": 128, "near a zero of cosh": 64, "large Re y": 80}[case]

    def cnormal(*shape, scale=0.4):
        return scale * (rng.normal(size=shape) + 1j * rng.normal(size=shape))

    w, b, a = cnormal(n, h), cnormal(h), cnormal(n)
    spins = np.where(rng.random((k, n)) < 0.5, -1.0, 1.0)
    if case == "Re w 20":
        w.real[0] = STRESS_RE_W
        b.real -= STRESS_RE_W
        y = spins[spins[:, 0] > 0] @ w + b
        ln_ratio = (np.log(np.abs(np.cosh(y - 2.0 * STRESS_RE_W))) - np.log(np.abs(np.cosh(y)))).sum(1)
        a.real[0] = 0.5 * np.median(ln_ratio)  # |psi'/psi|^2 = e^{-4 Re a_0 + 2 ln_ratio}
    elif case == "near a zero of cosh":
        for walker, unit in zip(range(4), rng.choice(h, size=4, replace=False)):
            y = spins[walker] @ w[:, unit] + b[unit]
            target = complex(rng.uniform(-1e-3, 1e-3), math.pi / 2 + rng.uniform(-1e-3, 1e-3))
            b[unit] += target - y
    elif case == "large Re y":
        b.real += 50.0 * np.where(rng.random(h) < 0.5, -1.0, 1.0)
    return w, b, a, spins
