"""Dtype policy helpers.

A single real ``dtype`` (``torch.float32`` or ``torch.float64``) selects the
precision of a machine; the matching complex dtype is derived. Unlike the
JAX package, float64 needs no global switch and runs on the card as well.
"""

from __future__ import annotations

import torch

_COMPLEX_OF = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def complex_dtype(dtype: torch.dtype) -> torch.dtype:
    """Complex dtype matching a real dtype (f32 -> c64, f64 -> c128)."""
    return dtype if dtype in _COMPLEX_OF.values() else _COMPLEX_OF[dtype]
