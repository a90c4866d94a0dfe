"""Numerically stable complex log-cosh and tanh.

For z = x + iy:

    ln cosh z = ln( (1+e^{-2|x|}) cos y ,  (1-e^{-2|x|}) sin y * sgn x )
                + |x| - ln 2

which never overflows for large |x| (cosh z ~ e^{|x|}/2). The split-plane
form is kept because the CUDA kernels evaluate exactly these planes; the
complex wrappers take and return native complex tensors.
"""

from __future__ import annotations

import torch

LN2 = 0.6931471805599453


def _sign(x: torch.Tensor) -> torch.Tensor:
    """+1 for x >= 0 (including -0.0), -1 for x < 0."""
    return 1.0 - 2.0 * (x < 0).to(x.dtype)


def logcosh_ri(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable ln cosh(x + iy) on split planes; returns (real, imag)."""
    absx = x.abs()
    e = torch.exp(-2.0 * absx)
    re = (1.0 + e) * torch.cos(y)
    im = (1.0 - e) * torch.sin(y) * _sign(x)
    mag = 0.5 * torch.log(re * re + im * im)
    return mag + (absx - LN2), torch.atan2(im, re)


def logcosh(z: torch.Tensor) -> torch.Tensor:
    """Stable ln cosh z for a complex tensor."""
    return torch.complex(*logcosh_ri(z.real, z.imag))


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
