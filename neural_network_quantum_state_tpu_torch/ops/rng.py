"""Random-number helpers over an explicit ``torch.Generator``, and the
Philox4x32-10 streams of the sweep and exchange kernels.

The JAX package threads threefry keys; here every random draw takes a
generator that lives on the device of the tensors it fills. The two
frameworks give different numbers from the same seed, so tests make their
inputs with numpy and hand them to both.

On the card the sweep and exchange kernels draw their uniforms themselves,
from a Philox4x32-10 counter stream (Salmon et al., SC'11) on a 64-bit key
that the caller draws once per call from the state's generator
(``PhiloxDraws``, ``ExchangeDraws``). ``philox_uniforms`` makes the same
numbers with int64 tensor arithmetic, so the plain versions decide on the
kernels' streams. A draw's ``row0`` offsets the walker row of the counter:
the shards of a walker mesh (``parallel/mesh.py``) share one key, each at
its first global walker row, and so draw the columns of the unsharded call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Philox4x32-10's multipliers and Weyl key increments (the Random123 constants).
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF
# Counter word 3 of each stream: the sweep's flip and swap-phase uniforms, the
# exchange kernel's selection and acceptance uniforms.
FLIP_STREAM, SWAP_STREAM, SELECT_STREAM, ACCEPT_STREAM = 0, 1, 2, 3


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


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of m * x for x in [0, 2^32), in int64 without
    overflow: x is split into 16-bit halves, each product below 2^48."""
    p_lo, p_hi = m * (x & 0xFFFF), m * (x >> 16)
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32_10(counter, key):
    """Philox4x32-10 of four int64 counter-word tensors (broadcastable, each
    in [0, 2^32)) under a key of two such words; returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def philox_uniforms(key: torch.Tensor, stream: int, shape: tuple[int, int], row0: int = 0) -> torch.Tensor:
    """(T, K) float32 uniforms in [0, 1) on the key's device: element (t, k) is
    word t % 4 of Philox4x32-10 at counter (t // 4, row0 + k, 0, stream) under
    ``key`` ((2,) int64 words in [0, 2^32)), made from its top 24 bits as
    (bits >> 8) * 2^-24 (the TPU kernel's conversion). ``stream`` is
    FLIP_STREAM or SWAP_STREAM, which the sweep kernel draws (csrc/rbm.cuh
    ``FlipDraws``), or SELECT_STREAM or ACCEPT_STREAM, which the exchange
    kernel draws (csrc/exchange.cu ``ExchangeDraws``; its tempered instance
    also draws SWAP_STREAM). Columns row0.. of a call with more walkers are
    the columns of a call at ``row0``."""
    n_rows, k = shape
    dev = key.device
    blocks = torch.arange((n_rows + 3) // 4, dtype=torch.int64, device=dev)[:, None]
    rows = torch.arange(row0, row0 + k, dtype=torch.int64, device=dev)[None, :]
    words = philox4x32_10((blocks, rows, 0, stream), (key[0], key[1]))
    # row t of the stacked (blocks, 4, K) words: word t % 4 of block t // 4
    bits = torch.stack(torch.broadcast_tensors(*words), dim=1).reshape(-1, k)[:n_rows]
    return (bits >> 8).to(torch.float32) * 2.0**-24


def philox_key(g: torch.Generator) -> torch.Tensor:
    """A fresh (2,) int64 key of two 32-bit words on the generator's device."""
    return torch.randint(0, 1 << 32, (2,), generator=g, dtype=torch.int64, device=g.device)


class PhiloxDraws(NamedTuple):
    """The uniforms of one sweep call, drawn on the chip: ``n_rounds`` rows of
    flip uniforms and, with n_beta > 1, the swap uniforms of each sweep (row
    2 s + parity of the swap stream). Every call takes a fresh key, which
    alone keeps the calls' streams apart. ``row0``: the first walker's row in
    the counter (a shard's first global walker row; 0 without a mesh)."""

    key: torch.Tensor  # (2,) int64 words in [0, 2^32), on the walkers' device
    n_rounds: int
    row0: int = 0

    def flips(self, k: int) -> torch.Tensor:
        """(n_rounds, K) flip uniforms."""
        return philox_uniforms(self.key, FLIP_STREAM, (self.n_rounds, k), self.row0)

    def swaps(self, n_sweeps: int, k: int) -> torch.Tensor:
        """(n_sweeps, 2, K) swap uniforms (even-pair, then odd-pair phase)."""
        return philox_uniforms(self.key, SWAP_STREAM, (2 * n_sweeps, k), self.row0).reshape(n_sweeps, 2, k)


class ExchangeDraws(NamedTuple):
    """The uniforms of one exchange call, drawn on the chip: ``n_steps`` rows
    of selection and of acceptance uniforms, on the selection and acceptance
    streams of a fresh key (one per call, which alone keeps the calls'
    streams apart), and with n_beta > 1 the swap uniforms of each sweep on
    the swap stream, in the layout of ``PhiloxDraws.swaps``; ``row0`` as
    there."""

    key: torch.Tensor  # (2,) int64 words in [0, 2^32), on the walkers' device
    n_steps: int
    row0: int = 0

    def selection(self, k: int) -> torch.Tensor:
        """(n_steps, K) bond-selection uniforms."""
        return philox_uniforms(self.key, SELECT_STREAM, (self.n_steps, k), self.row0)

    def acceptance(self, k: int) -> torch.Tensor:
        """(n_steps, K) acceptance uniforms."""
        return philox_uniforms(self.key, ACCEPT_STREAM, (self.n_steps, k), self.row0)

    def swaps(self, n_sweeps: int, k: int) -> torch.Tensor:
        """(n_sweeps, 2, K) swap uniforms (even-pair, then odd-pair phase)."""
        return philox_uniforms(self.key, SWAP_STREAM, (2 * n_sweeps, k), self.row0).reshape(n_sweeps, 2, k)
