"""Shared driver plumbing: model/ansatz registry lookups, checkpoint-prefix
naming matching the reference drivers' conventions, float formatting (the
JAX package's ``drivers/common.py``: the same prefixes letter for letter).

Reference: the 15 CPU + 21 GPU main()s (SURVEY.md 2.6) are near-identical
per (lattice x ansatz); here one parameterized trainer + one measurement
driver cover the grid, preserving the -name=value CLI, multi-value
hyperparameter sweeps and file-naming schemes
(e.g. 'RBMTrSymmLICH-L{L}NF{nf}A{a}T{t}V{v}', LICH-train_rbmtrsymm.cu:94;
'CH-Nv{N}Nh{M}Hf{h}V{v}', CH-train_rbm.cpp:69-73).
"""

from __future__ import annotations

import logging
import sys

import numpy as np

from neural_network_quantum_state_tpu_torch.hamiltonians import (
    HubbardChain,
    LITFIChain,
    TFIChain,
    TFICheckerBoard,
    TFISQ,
    TFITRI,
)
from neural_network_quantum_state_tpu_torch.models import REGISTRY as MODEL_REGISTRY

_ANSATZ_LABEL = {
    "rbm": "RBM",
    "rbmtrsymm": "RBMTrSymm",
    "rbmsfsymm": "RBMSfSymm",
    "rbmz2prsymm": "RBMZ2PrSymm",
    "ffnn": "FFNN",
    "ffnntrsymm": "FFNNTrSymm",
    "ffnnsfsymm": "FFNNSfSymm",
}

_ALPHA_ANSATZE = {"rbmtrsymm", "rbmsfsymm", "rbmz2prsymm", "ffnntrsymm", "ffnnsfsymm"}


def enable_cli_logging() -> None:
    """Surface package log messages (e.g. the VMC large-V solve_dtype
    resolution note) on driver stdout with the banner's "# " prefix.

    Scoped to the package logger - NOT logging.basicConfig - so other
    libraries' loggers keep their stderr handlers and never pollute driver
    stdout (campaign scripts parse it with `tail -1`)."""
    log = logging.getLogger("neural_network_quantum_state_tpu_torch")
    if not log.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("# %(message)s"))
        log.addHandler(handler)
        log.setLevel(logging.INFO)


def remove_zeros(val: float) -> str:
    """Trailing-zero-stripped float string (remove_zeros_in_str,
    LICH-train_rbmtrsymm.cu:113-120)."""
    s = f"{val:.6f}".rstrip("0").rstrip(".")
    return s


def build_machine(ansatz: str, n_inputs: int, n_hidden: int, dtype):
    cls = MODEL_REGISTRY[ansatz]
    if ansatz in _ALPHA_ANSATZE:
        return cls(n_inputs=n_inputs, alpha=n_hidden, dtype=dtype)
    return cls(n_inputs=n_inputs, n_hiddens=n_hidden, dtype=dtype)


def hamiltonian_kwargs(model: str, l_sites: int, args, theta: float | None = None,
                       alpha: float | None = None) -> dict:
    """build_hamiltonian kwargs from CLI args - the single definition of
    the coupling conventions (LICH theta -> (j, h), harmonic-trap vector)
    shared by the train driver and measure -what=energy, so a trained
    state is always re-evaluated against exactly the Hamiltonian it was
    trained on. theta/alpha override the CLI values for grid sweeps."""
    import math

    model = model.lower()
    kw: dict = {"pbc": bool(args.find("pbc", int))}
    if model == "lich":
        theta = args.find("theta", float) if theta is None else theta
        alpha = args.find("alpha", float) if alpha is None else alpha
        kw.update(j=math.sin(theta), h=-math.cos(theta), alpha=alpha)
    elif model == "hubbard":
        n_up, n_down = args.mfind("npar", int)
        kw.update(u=args.find("U", float), t=args.find("t", float), n_up=n_up, n_down=n_down)
        trap = args.find("trap", float)
        if trap != 0.0:
            # harmonic trap V(i) = trap*(i-(L-1)/2)^2, same on both spin
            # flavors (generate_harmonic_potential,
            # fermi_hubbard_CH-train_rbm.cu:117-128)
            centered = np.arange(l_sites) - (l_sites - 1.0) / 2.0
            kw.update(v=tuple(np.tile(trap * centered**2, 2)))
    elif model == "cb":
        # J1-J2 checkerboard couplings (-J maps to the reference's -J1;
        # -J2 per CB-train_ffnn.cpp:24, default 0)
        kw.update(h=args.find("h", float), j1=args.find("J", float), j2=args.find("J2", float))
    else:
        kw.update(h=args.find("h", float), j=args.find("J", float))
    return kw


def build_hamiltonian(model: str, n_inputs: int, **kw):
    model = model.lower()
    if model == "ch":
        return TFIChain(n_sites=n_inputs, h=kw["h"], j=kw.get("j", -1.0))
    if model == "lich":
        return LITFIChain(
            n_sites=n_inputs, h=kw["h"], j=kw["j"], alpha=kw["alpha"], pbc=kw.get("pbc", True)
        )
    if model == "sq":
        return TFISQ(n_sites=n_inputs, h=kw["h"], j=kw.get("j", -1.0))
    if model == "tri":
        return TFITRI(n_sites=n_inputs, h=kw["h"], j=kw.get("j", 1.0))
    if model == "cb":
        return TFICheckerBoard(
            n_sites=n_inputs, h=kw["h"], j1=kw.get("j1", -1.0), j2=kw.get("j2", 0.0), pbc=kw.get("pbc", True)
        )
    if model == "hubbard":
        return HubbardChain(
            n_sites=n_inputs,
            u=kw["u"],
            t=kw.get("t", 1.0),
            n_up=kw["n_up"],
            n_down=kw["n_down"],
            pbc=kw.get("pbc", True),
            v=kw.get("v"),
        )
    raise ValueError(f"unknown model '{model}'")


def checkpoint_prefix(path: str, model: str, ansatz: str, n: int, nh: int, ver, **kw) -> str:
    """Reference-style hyperparameter-encoding file prefixes."""
    label = _ANSATZ_LABEL[ansatz]
    model = model.lower()
    if model == "lich":
        return (
            f"{path}/{label}LICH-L{n}NF{nh}A{remove_zeros(kw['alpha'])}"
            f"T{remove_zeros(kw['theta'])}V{ver}"
        )
    if model == "ch" and ansatz == "rbm":
        return f"{path}/CH-Nv{n}Nh{nh}Hf{remove_zeros(kw['h'])}V{ver}"
    if model == "ch":
        return f"{path}/{label}CH-N{n}A{nh}H{remove_zeros(kw['h'])}V{ver}"
    if model == "hubbard":
        return f"{path}/{label}HB-L{n // 2}U{remove_zeros(kw['u'])}V{ver}"
    return f"{path}/{label}{model.upper()}-N{n}A{nh}H{remove_zeros(kw['h'])}V{ver}"
