"""Machine (ansatz) protocol.

A Machine is a frozen config object whose methods are functions of explicit
state:

- ``params``: dict of raw complex parameter tensors,
- ``Work``: effective dense weights built from params (symmetry expansion),
- ``Cache``: per-walker (spins, y, sa), threaded through the sampler.

The flattened parameter order of each machine matches the JAX package's
(and the reference's ``variables_`` layout), so SR vectors and gradients
compare entry by entry.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping

import numpy as np
import torch

from neural_network_quantum_state_tpu_torch.dtypes import complex_dtype
from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Machine:
    """Base class: static shape info + functional methods."""

    n_inputs: int
    dtype: Any = torch.float32  # real dtype (f32/f64); parameters are complex of it

    @property
    def n_vars(self) -> int:
        raise NotImplementedError

    @property
    def n_hidden(self) -> int:
        """Effective hidden-unit count H of the expanded Work."""
        raise NotImplementedError

    def param_spec(self) -> list[tuple[str, tuple[int, ...]]]:
        """(name, shape) list in flattened-parameter order."""
        raise NotImplementedError

    def init_params(self, g: torch.Generator) -> Params:
        raise NotImplementedError

    def make_work(self, params: Params) -> Work:
        """Expand raw params into effective dense (W, b, a, c)."""
        raise NotImplementedError

    def grad_log(self, params: Params, cache: Cache) -> torch.Tensor:
        """Closed-form O_k = d ln psi / d theta, flattened: (K, n_vars) complex."""
        raise NotImplementedError

    @property
    def complex_dtype(self) -> torch.dtype:
        return complex_dtype(self.dtype)

    def flatten_params(self, params: Params) -> torch.Tensor:
        return torch.cat([params[name].reshape(-1) for name, _ in self.param_spec()])

    def unflatten_params(self, vec: torch.Tensor) -> Params:
        out, off = {}, 0
        for name, shape in self.param_spec():
            size = math.prod(shape)
            out[name] = vec[off : off + size].reshape(shape)
            off += size
        return out

    def update_params(self, params: Params, dx_flat: torch.Tensor, lr: float) -> Params:
        """theta <- theta - lr * dx."""
        dx = self.unflatten_params(dx_flat)
        return {k: params[k] - dx[k] * lr for k in params}

    def _normal(self, g: torch.Generator, shape, scale: float, imag_scale: float | None = None) -> torch.Tensor:
        """Complex Gaussian init: re ~ scale * N(0, 1), im ~ imag_scale * N(0, 1).

        The RBM family scales both planes alike (imag_scale None); the FFNN
        family scales only the imaginary plane by a further 0.1.
        """
        re = torch.randn(shape, generator=g, dtype=self.dtype, device=g.device)
        im = torch.randn(shape, generator=g, dtype=self.dtype, device=g.device)
        return torch.complex(scale * re, (scale if imag_scale is None else imag_scale) * im)

    def _zeros(self, shape, device) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.complex_dtype, device=device)


def params_from_jax(machine: Machine, params_np: Mapping[str, Any], device="cuda") -> Params:
    """The JAX package's parameter dict as this package's complex tensors.

    Each value is a complex numpy array or an (re, im) pair of real arrays
    (the JAX package's split-complex ``C``), named and shaped as
    ``machine.param_spec()`` says.
    """
    out = {}
    for name, shape in machine.param_spec():
        v = params_np[name]
        if isinstance(v, (tuple, list)):
            v = np.asarray(v[0]) + 1j * np.asarray(v[1])
        v = np.asarray(v)
        if v.shape != tuple(shape):
            raise ValueError(f"param {name!r}: shape {v.shape}, expected {tuple(shape)}")
        out[name] = torch.as_tensor(v.astype(np.complex128), device=device).to(machine.complex_dtype)
    return out
