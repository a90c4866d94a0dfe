"""Numerically stable complex log-cosh and tanh.

For z = x + iy:

    ln cosh z = ln( (1+e^{-2|x|}) cos y ,  (1-e^{-2|x|}) sin y * sgn x )
                + |x| - ln 2

which never overflows for large |x| (cosh z ~ e^{|x|}/2). The split-plane
form is kept because the CUDA kernels evaluate exactly these planes; the
complex wrappers take and return native complex tensors.

``logcosh_re_cos``, ``logcosh_ri_cs`` and ``rotate_phase`` are the plain
forms of the sweep and energy kernels' arithmetic (``csrc/rbm.cuh``): Re ln
cosh from cos y alone, both planes from (cos y, sin y), and the angle
addition that gives a flipped unit's (cos, sin) from the walker's and a
table of cos/sin 2 Im w.
"""

from __future__ import annotations

import math

import torch

LN2 = 0.6931471805599453
BRANCH_CUT_TOL = 1e-4  # |Arg cosh y| this close to pi counts as on the cut
# ... in float64, where a kernel and the plain version take the phase to
# ~1e-15 of its terms, so that only phases this close to pi may part
BRANCH_CUT_TOL_F64 = 1e-10


def _sign(x: torch.Tensor) -> torch.Tensor:
    """+1 for x >= 0 (including -0.0), -1 for x < 0."""
    return 1.0 - 2.0 * (x < 0).to(x.dtype)


def logcosh_ri_cs(x: torch.Tensor, cos_y: torch.Tensor, sin_y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable ln cosh(x + iy) on split planes from cos y and sin y; returns
    (real, imag)."""
    absx = x.abs()
    e = torch.exp(-2.0 * absx)
    re = (1.0 + e) * cos_y
    im = (1.0 - e) * sin_y * _sign(x)
    mag = 0.5 * torch.log(re * re + im * im)
    return mag + (absx - LN2), torch.atan2(im, re)


def logcosh_ri(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable ln cosh(x + iy) on split planes; returns (real, imag)."""
    return logcosh_ri_cs(x, torch.cos(y), torch.sin(y))


def logcosh_re_cos(x: torch.Tensor, cos_y: torch.Tensor) -> torch.Tensor:
    """Re ln cosh(x + iy) from cos y alone, the sweep kernel's form:
    4 e^{-2|x|} |cosh(x + iy)|^2 = (1 - e)^2 + 4 e cos^2 y with e = e^{-2|x|}
    (the TPU sweep kernel's 1 + e^2 + 2 e cos 2y, written as a sum of two
    terms >= 0, which does not cancel near the zeros of cosh)."""
    absx = x.abs()
    e = torch.exp(-2.0 * absx)
    return 0.5 * torch.log((1.0 - e) ** 2 + 4.0 * e * cos_y * cos_y) + (absx - LN2)


def rotate_phase(cos_y, sin_y, cos_2w, sin_2w, s):
    """(cos, sin) of y - 2 s w for s = +-1 by angle addition from (cos y,
    sin y) and (cos 2w, sin 2w), the energy kernel's flipped unit."""
    return cos_y * cos_2w + s * sin_y * sin_2w, sin_y * cos_2w - s * cos_y * sin_2w


def logcosh(z: torch.Tensor) -> torch.Tensor:
    """Stable ln cosh z for a complex tensor."""
    return torch.complex(*logcosh_ri(z.real, z.imag))


def near_branch_cut(y: torch.Tensor) -> torch.Tensor:
    """Whether any hidden unit (last axis) of y has |Arg cosh y| within
    ``BRANCH_CUT_TOL`` of pi (``BRANCH_CUT_TOL_F64`` for complex128 y),
    reducing that axis. The phase is the principal value, so ln cosh jumps by
    2 pi i across the negative real axis, and ln psi by 2 pi i c_j with
    complex output weights: two evaluations of one such unit may land on
    opposite sides."""
    tol = BRANCH_CUT_TOL_F64 if y.dtype == torch.complex128 else BRANCH_CUT_TOL
    return (logcosh_ri(y.real, y.imag)[1].abs() > math.pi - tol).any(-1)


def tanh_ri(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """tanh(x + iy) on split planes, stable for large |x|:

        tanh(x+iy) = (sinh 2x + i sin 2y) / (cosh 2x + cos 2y)

    with numerator and denominator scaled by e^{-2|x|}.
    """
    e = torch.exp(-2.0 * x.abs())
    num_re = _sign(x) * 0.5 * (1.0 - e * e)
    num_im = e * torch.sin(2.0 * y)
    inv = 1.0 / (0.5 * (1.0 + e * e) + e * torch.cos(2.0 * y))
    return num_re * inv, num_im * inv


def tanh(z: torch.Tensor) -> torch.Tensor:
    """Stable tanh z for a complex tensor."""
    return torch.complex(*tanh_ri(z.real, z.imag))
