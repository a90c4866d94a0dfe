"""The exchange kernel's plain twins in PyTorch: the site -> incident-bonds
table, the incremental active-bond mask, and the plain exchange rounds on
the kernel's Philox streams.

The incidence table is held to the JAX exchange kernel's bond selector
matrices (``pallas_exchange._bond_matrices``: (P0 + P1)^T counts the ends of
each bond at each site); the incremental mask update after a pair flip, the
kernel's way of keeping the mask, to a full recompute from the spins
(hypothesis over ring, two-ring and random bond tables); the plain exchange
on ``ExchangeDraws`` to the same rounds on the tensors they stand for, and
to the exact particle-sector |psi|^2. The kernel itself is held to these on
the card (test_torch_gpu.py).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from neural_network_quantum_state_tpu.ops.pallas_exchange import _bond_matrices
from neural_network_quantum_state_tpu_torch.hamiltonians import HubbardChain
from neural_network_quantum_state_tpu_torch.models import FFNN, RBM
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops import exchange as exchange_ops
from neural_network_quantum_state_tpu_torch.ops.rng import ExchangeDraws, make_generator, philox_key
from neural_network_quantum_state_tpu_torch.sampler import init_state, kawasaki


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _random_bonds(rng, n, b):
    """(b, 2) int32 bonds with ends drawn at random in [0, n): repeated bonds
    and self-loops included."""
    return rng.integers(0, n, size=(b, 2)).astype(np.int32)


def _tables(rng):
    n = 12
    return {
        "ring": (kawasaki.ring_bonds(n), n),
        "two-rings": (kawasaki.two_ring_bonds(n // 2), n),
        "random": (_random_bonds(rng, n, n), n),
        "random-self-loops": (np.concatenate([_random_bonds(rng, n, 8), [[3, 3], [5, 5]]]).astype(np.int32), n),
    }


@pytest.mark.parametrize("kind", ["ring", "two-rings", "random", "random-self-loops", "long-ring", "one-bond"])
def test_incidence_table_lists_each_bond_once_per_end(kind, rng):
    """Site i's entries are the bonds with an end at i, in bond order, a
    bond joining i to itself twice; their counts are the JAX kernel's
    (P0 + P1)^T."""
    more = {"long-ring": (kawasaki.ring_bonds(300), 300),  # bonds past the kernel's register words
            "one-bond": (np.asarray([[1, 0]], dtype=np.int32), 3)}  # a site without bonds
    bonds, n = more[kind] if kind in more else _tables(rng)[kind]
    ptr, idx = exchange_ops.incidence_table(torch.as_tensor(bonds), n)
    assert ptr.dtype == idx.dtype == torch.int32
    assert tuple(ptr.shape) == (n + 1,) and tuple(idx.shape) == (2 * len(bonds),)
    for i in range(n):
        want = [b for b in range(len(bonds)) for e in (0, 1) if bonds[b, e] == i]
        assert idx[ptr[i]:ptr[i + 1]].tolist() == want
    counts = np.zeros((n, len(bonds)), dtype=np.int64)
    for i in range(n):
        for b in idx[ptr[i]:ptr[i + 1]].tolist():
            counts[i, b] += 1
    np.testing.assert_array_equal(counts, _bond_matrices(bonds, n)[3].astype(np.int64))


def _active(spins, bonds):
    return spins[:, bonds[:, 0]] * spins[:, bonds[:, 1]] < 0


@settings(max_examples=40, deadline=None, database=None)
@given(kind=st.sampled_from(["ring", "two-rings", "random", "random-self-loops"]), seed=st.integers(0, 2**31 - 1),
       rounds=st.integers(1, 6))
def test_incremental_mask_update_equals_full_recompute(kind, seed, rounds):
    """After pair flips of chosen active bonds on the accepted walkers, the
    mask updated from the incidence table (the kernel's update) is the mask
    recomputed from the new spins."""
    rng = np.random.default_rng(seed)
    bonds, n = _tables(rng)[kind]
    tb = torch.as_tensor(bonds).long()
    ptr, idx = exchange_ops.incidence_table(torch.as_tensor(bonds), n)
    k = 16
    spins = torch.as_tensor(np.where(rng.random((k, n)) < 0.5, -1.0, 1.0))
    active = _active(spins, tb)
    for _ in range(rounds):
        bond, nb = exchange_ops.select_active_bond(active, torch.as_tensor(rng.random(k)))
        i, j = tb[bond, 0], tb[bond, 1]
        accept = torch.as_tensor(rng.random(k) < 0.6) & (nb > 0)
        rows = torch.arange(k)
        flip = 1.0 - 2.0 * accept.double()
        spins = spins.clone()
        spins[rows, i] *= flip
        spins[rows, j] *= flip
        active = exchange_ops.update_active(active, ptr, idx, i, j, accept)
        assert torch.equal(active, _active(spins, tb))


@pytest.mark.parametrize("b", [1, 31, 64, 300])
def test_select_active_bond_takes_the_target_th_active_bond(b, rng):
    """The pick the kernel makes by popcounts over its mask words, as the
    plain version makes it: the (target+1)-th active bond in bond order with
    target = min(floor(u nb), nb - 1); masks of 1 to 300 bonds (past the
    kernel's four register words), walkers without an active bond among
    them (bond B-1, nb 0)."""
    k = 64
    active = torch.as_tensor(rng.random((k, b)) < rng.random((k, 1)))
    active[0] = False
    active[1] = True
    u = torch.as_tensor(rng.random(k), dtype=torch.float32)
    u[2] = 0.99999994  # the largest float32 below 1
    bond, nb = exchange_ops.select_active_bond(active, u)
    for w in range(k):
        on = torch.nonzero(active[w]).flatten().tolist()
        assert int(nb[w]) == len(on)
        if not on:
            assert int(bond[w]) == b - 1
            continue
        target = min(int(np.floor(np.float32(u[w]) * np.float32(len(on)))), len(on) - 1)
        assert int(bond[w]) == on[target]


def test_kernel_incidence_is_built_once_per_bond_tensor():
    bonds = torch.as_tensor(kawasaki.ring_bonds(8))
    first = exchange_ops.kernel_incidence(bonds, 8)
    assert exchange_ops.kernel_incidence(bonds, 8) is first
    bonds[0, 1] = 3  # an in-place edit makes a new table
    again = exchange_ops.kernel_incidence(bonds, 8)
    assert again is not first and again[1].tolist() != first[1].tolist()


def _machine(kind, n, h, rng):
    tm = RBM(n_inputs=n, n_hiddens=h, dtype=torch.float64) if kind == "rbm" else FFNN(n_inputs=n, n_hiddens=h,
                                                                                     dtype=torch.float64)
    return tm.make_work({name: torch.as_tensor(0.3 * (rng.normal(size=s) + 1j * rng.normal(size=s)))
                         for name, s in tm.param_spec()})


@pytest.mark.parametrize("kind", ["rbm", "ffnn"])
def test_plain_exchange_on_draws_takes_their_uniforms(kind, rng):
    """exchange_plain given ExchangeDraws decides exactly as on the
    (selection, acceptance) blocks they stand for; draws with an acceptance
    block, or a selection block without one, are refused."""
    l, k, n_steps = 4, 48, 24
    ham = HubbardChain(n_sites=2 * l, n_up=2, n_down=2)
    work = _machine(kind, 2 * l, 6, rng)
    bonds = torch.as_tensor(ham.bonds)
    cache, ln = engine.full_forward(work, ham.init_spins(make_generator(4, "cpu"), k, torch.float64))
    draws = ExchangeDraws(torch.tensor([0x9E3779B9, 12345], dtype=torch.int64), n_steps)
    got = exchange_ops.exchange_plain(work, cache, ln, bonds, draws)
    want = exchange_ops.exchange_plain(work, cache, ln, bonds, draws.selection(k), draws.acceptance(k))
    assert torch.equal(got[0].spins, want[0].spins) and torch.equal(got[1], want[1])
    assert float(got[2]) == float(want[2]) and 0 < float(got[2]) < n_steps * k
    with pytest.raises(ValueError, match="from the stream"):
        exchange_ops.exchange_plain(work, cache, ln, bonds, draws, draws.acceptance(k))
    with pytest.raises(ValueError, match="acceptance uniforms beside"):
        exchange_ops.exchange_plain(work, cache, ln, bonds, draws.selection(k))


def test_plain_exchange_on_draws_samples_sector_psi2(rng):
    """chi^2 of the plain exchange rounds on Philox draws (a fresh key per
    call, as the sampler draws on the card) against exact |psi|^2 in the
    (1, 1) sector of L = 3."""
    l, k = 3, 1024
    n = 2 * l
    work = _machine("rbm", n, 8, rng)
    ham = HubbardChain(n_sites=n, n_up=1, n_down=1)
    bonds = torch.as_tensor(ham.bonds)
    idx = np.arange(2**n)
    bits = (idx[:, None] >> np.arange(n)[None, :]) & 1
    occ = 1 - bits
    in_sector = (occ[:, :l].sum(1) == 1) & (occ[:, l:].sum(1) == 1)
    p = np.exp(2.0 * engine.log_psi(work, torch.as_tensor(1.0 - 2.0 * bits[in_sector])).real.numpy())
    p /= p.sum()
    pos = {int(sid): i for i, sid in enumerate(idx[in_sector])}

    g = make_generator(9, "cpu")
    state = init_state(work, ham.init_spins(g, k, torch.float64), g)
    cache, ln = state.cache, state.lnpsi
    counts = np.zeros(len(pos))
    bit_w = np.asarray([1 << b for b in range(n)])
    for i in range(50):
        cache, ln, _ = exchange_ops.exchange_plain(work, cache, ln, bonds, ExchangeDraws(philox_key(g), ham.n_unit_steps))
        if i >= 10:
            for sid in ((1.0 - cache.spins.numpy()) / 2.0 @ bit_w).astype(int):
                counts[pos[sid]] += 1  # KeyError = left the sector
    total = counts.sum()
    chi2 = float(np.sum((counts - total * p) ** 2 / (total * p)))
    tv = 0.5 * float(np.abs(counts / total - p).sum())
    assert chi2 / (len(pos) - 1) < 3.0, (chi2, tv)
    assert tv < 0.03, tv
    assert p.max() > 2 * p.min()
