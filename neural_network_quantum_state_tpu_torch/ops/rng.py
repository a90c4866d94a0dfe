"""Random-number helpers over an explicit ``torch.Generator``.

The JAX package threads threefry keys; here every random draw takes a
generator that lives on the device of the tensors it fills. The two
frameworks give different numbers from the same seed, so tests make their
inputs with numpy and hand them to both.
"""

from __future__ import annotations

import torch


def make_generator(seed: int, device: torch.device | str) -> torch.Generator:
    """A seeded generator on `device`."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def uniform_block(g: torch.Generator, shape: tuple[int, ...], dtype=torch.float32) -> torch.Tensor:
    """U[0,1) block on the generator's device, e.g. (n_steps, K) accept draws."""
    return torch.rand(shape, generator=g, dtype=dtype, device=g.device)


def random_spins(g: torch.Generator, n_walkers: int, n_sites: int, dtype=torch.float32) -> torch.Tensor:
    """Uniform random {-1,+1} spin states (K, N)."""
    bits = torch.randint(0, 2, (n_walkers, n_sites), generator=g, device=g.device)
    return (2 * bits - 1).to(dtype)


def sector_spins(g: torch.Generator, n_walkers: int, n_sites: int, n_particles: int, dtype=torch.float32) -> torch.Tensor:
    """(K, n_sites) states with exactly n_particles sites at +1 (occupied)
    per walker, placed uniformly at random."""
    ranks = torch.rand((n_walkers, n_sites), generator=g, device=g.device).argsort(1)
    return torch.where(ranks < n_particles, 1.0, -1.0).to(dtype)
