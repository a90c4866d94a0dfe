"""pynqs-compatible sampling API (reference L9; the JAX package's
``api/sampler.py``).

Drop-in behavioral equivalent of python/pynqs/sampler.py:11-71 backed by the
pybind11 module _pynqs_gpu (gpu/src/pywrapping_sampler.cu:20-132): the
``RBM``/``FFNN`` classes dispatch on floatType x symmType, ``init`` takes
the same kwargs (nInputs, nHiddens [= alpha for symmetric types], nChains,
seedNumber, seedDistance, path_to_load, init_mcmc_steps), and the three
sampling primitives return NumPy arrays:

    do_mcmc_steps(nms); get_spinStates(); get_lnpsi();
    get_lnpsi_for_fixed_spins(spins)

so the reference's python/meas_{smag,renyi,fidelity}.py scripts run
unmodified against this backend. It is built on ``AmplitudeSampler``: on
the card each ``do_mcmc_steps`` is one launch of the sweep kernel. The
sampler runs on the card unless the constructor is given ``device="cpu"``
(the reference scripts pass no device). seedDistance (TRNG4
block-splitting) is accepted for signature parity; the generator is seeded
with seedNumber alone, and draws the random parameters and then the chains.
"""

from __future__ import annotations

import numpy as np
import torch

from neural_network_quantum_state_tpu_torch.measurements.sampler import AmplitudeSampler
from neural_network_quantum_state_tpu_torch.models import (
    FFNN as FFNNMachine,
    FFNNTrSymm,
    RBM as RBMMachine,
    RBMTrSymm,
    RBMZ2PrSymm,
)
from neural_network_quantum_state_tpu_torch.ops.rng import make_generator
from neural_network_quantum_state_tpu_torch.utils.checkpoint import load_reference_text

_FLOAT_TYPES = {"float32": torch.float32, "float64": torch.float64}


def _argchecker(kwargs, required):
    for arg in required:
        if arg not in kwargs:
            raise Exception("You omit an essential argument registered in :", required)


class _SamplerBase:
    _dispatch: dict  # symmType -> (machine_cls, hidden_kwarg)

    def __init__(self, device: torch.device | str = "cuda", **kwargs):
        _argchecker(kwargs, ["floatType", "symmType"])
        if kwargs["floatType"] not in _FLOAT_TYPES or kwargs["symmType"] not in self._dispatch:
            raise Exception(" --hint:  floatType: float32 or float64 / symmType: " + ", ".join(self._dispatch))
        self._floatType = kwargs["floatType"]
        self._symmType = kwargs["symmType"]
        self._device = torch.device(device)

    def init(self, **kwargs):
        _argchecker(
            kwargs,
            ["nInputs", "nHiddens", "nChains", "seedNumber", "seedDistance", "path_to_load", "init_mcmc_steps"],
        )
        machine_cls, hidden_kwarg = self._dispatch[self._symmType]
        self._nInputs = int(kwargs["nInputs"])
        self._nChains = int(kwargs["nChains"])
        machine = machine_cls(
            n_inputs=self._nInputs,
            dtype=_FLOAT_TYPES[self._floatType],
            **{hidden_kwarg: int(kwargs["nHiddens"])},
        )
        g = make_generator(int(kwargs["seedNumber"]) % (2**31), self._device)
        params = machine.init_params(g)
        path = str(kwargs["path_to_load"])
        try:
            params = load_reference_text(machine, path, device=self._device)
        except (FileNotFoundError, ValueError):
            # reference prints a warning and keeps the random init
            print(f"# --- file-path: {path} is not exist...")
        self._impl = AmplitudeSampler(machine, params, self._nChains, key=g, device=self._device)
        self._impl.warm_up(int(kwargs["init_mcmc_steps"]))

    # -- the three primitives the reference binding exposes ---------------
    def do_mcmc_steps(self, mcmc_steps: int):
        self._impl.do_mcmc_steps(int(mcmc_steps))

    def get_spinStates(self) -> np.ndarray:
        return self._impl.spins.cpu().numpy().reshape([-1, self._nInputs])

    def get_lnpsi(self) -> np.ndarray:
        return self._impl.lnpsi.cpu().numpy()

    def get_lnpsi_for_fixed_spins(self, spinStates) -> np.ndarray:
        spins = np.asarray(spinStates, dtype=self._floatType).reshape([self._nChains, self._nInputs])
        return self._impl.log_psi(torch.as_tensor(spins)).cpu().numpy()


class RBM(_SamplerBase):
    """symmType: 'None' | 'tr' | 'z2pr' (sampler.py:26-39)."""

    _dispatch = {
        "None": (RBMMachine, "n_hiddens"),
        "tr": (RBMTrSymm, "alpha"),
        "z2pr": (RBMZ2PrSymm, "alpha"),
    }


class FFNN(_SamplerBase):
    """symmType: 'None' | 'tr'."""

    _dispatch = {
        "None": (FFNNMachine, "n_hiddens"),
        "tr": (FFNNTrSymm, "alpha"),
    }
