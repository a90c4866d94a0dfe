"""CLI drivers: the parameterized train entry point (the JAX package's
``drivers``; its measure driver is not ported yet)."""

from neural_network_quantum_state_tpu_torch.drivers import common, train

__all__ = ["common", "train"]
