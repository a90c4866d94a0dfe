"""The reference's ``pynqs`` python package, on this port.

The reference's measurement scripts open with ``from pynqs import sampler``
(python/meas_renyi.py:3, meas_smag.py:3, meas_fidelity.py:3) against the
pybind11 binding ``_pynqs_gpu``. This package re-exports the port's
compatible surface (``neural_network_quantum_state_tpu_torch.api.sampler``)
under that name: ``from neural_network_quantum_state_tpu_torch.pynqs import
sampler``. Reference: python/pynqs/__init__.py:1.
"""

from . import sampler

__all__ = ["sampler"]
