"""CLI drivers: the parameterized train and measure entry points (the JAX
package's ``drivers``)."""

from neural_network_quantum_state_tpu_torch.drivers import common, measure, train

__all__ = ["common", "measure", "train"]
