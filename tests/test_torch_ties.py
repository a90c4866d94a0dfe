"""The tempered exchange's near-tie finder (``utils/ties.py``), on the CPU.

``chip_smoke.py`` phase 3 gates its float32 tempered exchange checks by
chain: a chain that parts from the plain version at a decision within
``ties.NEAR`` float32 roundings of a tie is set apart. Here the finder runs
on constructed inputs: one decision placed at its tie, the others far from
theirs, and a stand-in for the kernel's spins that parts in two chains.
"""

import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu_torch.hamiltonians import HubbardChain
from neural_network_quantum_state_tpu_torch.models import RBM
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops.exchange import select_active_bond, tempered_exchange_plain
from neural_network_quantum_state_tpu_torch.ops.rng import make_generator, uniform_block
from neural_network_quantum_state_tpu_torch.utils import ties

L, K, N_BETA, SWEEPS, FAR_U = 4, 8, 4, 2, 1e-3


@pytest.fixture(scope="module")
def case():
    ham = HubbardChain(n_sites=2 * L, u=4.0, t=1.0, n_up=2, n_down=2, pbc=True)
    machine = RBM(n_inputs=2 * L, n_hiddens=8)
    g = make_generator(5, "cpu")
    work = machine.make_work({k: 10.0 * v for k, v in machine.init_params(g).items()})
    cache, lnpsi = engine.full_forward(work, ham.init_spins(g, K))
    bonds = torch.as_tensor(ham.bonds)
    n_unit = ham.n_unit_steps
    u_sel = uniform_block(g, (SWEEPS * n_unit, K))
    u_acc = torch.full((SWEEPS * n_unit, K), FAR_U)  # far from every tie but the one placed below
    u_swap = torch.full((SWEEPS, 2, K), FAR_U)
    # the first proposal of a chain-0 row with dln > 0: u = 1 = exp(2 beta min(dln, 0)), its tie
    b = bonds.long()
    bond, nb = select_active_bond(cache.spins[:, b[:, 0]] * cache.spins[:, b[:, 1]] < 0, u_sel[0])
    dln = engine.flip2_log_psi_per_walker(work, cache, b[bond, 0], b[bond, 1]).real - lnpsi.real
    rows = [r for r in range(N_BETA) if dln[r] > 0 and nb[r] > 0]
    assert rows, "no chain-0 row with an uphill first proposal"
    u_acc[0, rows[0]] = 1.0
    return work, cache, lnpsi, bonds, (u_sel, u_acc, u_swap), n_unit


def _kernel_standin(path, rows):
    """The plain path's spins after each sweep, with the given rows flipped
    from the first sweep on: a kernel that parts there."""
    out = []
    for spins, _, _ in path:
        s = spins.clone()
        s[rows] = -s[rows]
        out.append(s)
    return out


def test_plain_margins_replay_the_plain_tempered_exchange(case):
    work, cache, lnpsi, bonds, uniforms, n_unit = case
    path, n_near = ties.plain_margins(work, cache.spins, bonds, uniforms, N_BETA, n_unit)
    want, _, _ = tempered_exchange_plain(work, cache, lnpsi, bonds, uniforms[0], uniforms[1], n_beta=N_BETA,
                                         n_unit=n_unit, swap_uniforms=uniforms[2])
    assert len(path) == SWEEPS
    assert torch.equal(path[-1][0], want.spins)
    assert n_near >= 1  # the placed tie
    assert all(bool(torch.isfinite(best).all()) for _, best, _ in path)


def test_finder_calls_only_the_decision_at_its_tie_a_near_tie(case):
    work, cache, lnpsi, bonds, uniforms, n_unit = case
    path, _ = ties.plain_margins(work, cache.spins, bonds, uniforms, N_BETA, n_unit)
    far_row = N_BETA + 1  # a row of chain 1, every decision of which is far from its tie
    kernel = _kernel_standin(path, [1, far_row])
    chains = ties.parting_chains(path, kernel, N_BETA)
    assert [ch["chain"] for ch in chains] == [0, 1]
    near, far = chains
    assert near["first_sweep"] == far["first_sweep"] == 1
    assert near["near_tie"] and near["margin_in_roundings"] < ties.NEAR
    assert near["margin"] == 0.0
    assert not far["near_tie"] and far["margin_in_roundings"] > 100 * ties.NEAR
    assert far["margin"] > 1e-3
    differ = torch.zeros(K, dtype=torch.bool)
    differ[[1, far_row]] = True
    gate = ties.tie_gate(chains, differ, N_BETA, mismatch_max=1e-3)
    assert gate["rows_apart"] == 2 and gate["other_rows"] == 1 and gate["near_tie_chains"] == 1
    assert gate["near_rows"].tolist() == [True] * N_BETA + [False] * N_BETA
    assert not gate["passes"]  # one of 2 chains at a near-tie is 50% > 1%; one other row of 8 > 1e-3


def test_gate_passes_near_tie_chains_within_their_share():
    k, n_beta = 4096, 4  # phase 3's shape: 1024 chains
    chains = [{"chain": c, "near_tie": True} for c in (3, 17)]
    differ = torch.zeros(k, dtype=torch.bool)
    differ[[12, 13, 14, 15, 68, 69, 70]] = True  # 7 rows (over 4 of 4096), all in the two near-tie chains
    gate = ties.tie_gate(chains, differ, n_beta, mismatch_max=1e-3)
    assert gate["passes"] and gate["other_rows"] == 0
    differ[np.arange(100, 105)] = True  # 5 rows apart outside them: over 4 of 4096
    assert not ties.tie_gate(chains, differ, n_beta, mismatch_max=1e-3)["passes"]
    many = [{"chain": c, "near_tie": True} for c in range(11)]  # 11 of 1024 chains > 1%
    assert not ties.tie_gate(many, torch.zeros(k, dtype=torch.bool), n_beta, mismatch_max=1e-3)["passes"]
