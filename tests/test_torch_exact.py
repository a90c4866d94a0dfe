"""The port's exact diagonalization (``utils/exact.py``) against the JAX
package's on the same inputs, and the port's precision-anchor ED stages
against the port's dense ground energy."""

import math

import numpy as np
import pytest

from neural_network_quantum_state_tpu.utils import exact as jexact
from neural_network_quantum_state_tpu_torch.examples import precision_anchor
from neural_network_quantum_state_tpu_torch.utils import exact

PUBLIC = ("tfi_hamiltonian_dense", "tfi_chain_dense", "litfi_chain_dense", "hubbard_chain_dense", "sector_restrict",
          "ground_energy", "ground_state", "spins_to_index", "tfi_chain_exact_energy", "litfi_ground_state_lanczos",
          "litfi_binder_exact")


def test_every_public_oracle_of_the_jax_module_is_ported():
    jax_public = {k for k, v in vars(jexact).items() if callable(v) and not k.startswith("_") and
                  getattr(v, "__module__", "") == jexact.__name__}
    assert jax_public == set(PUBLIC)
    assert all(callable(getattr(exact, name)) for name in PUBLIC)


@pytest.mark.parametrize("n", [6, 8])
def test_spins_table_and_index_match(n):
    s = exact._spins_table(n)
    np.testing.assert_array_equal(s, jexact._spins_table(n))
    rows = np.random.default_rng(n).choice([-1.0, 1.0], size=(50, n))
    np.testing.assert_array_equal(exact.spins_to_index(rows), jexact.spins_to_index(rows))
    np.testing.assert_array_equal(exact.spins_to_index(s), np.arange(2**n))


@pytest.mark.parametrize("n", [6, 8, 10])
def test_tfi_builders_match(n):
    jm = np.random.default_rng(n).normal(size=(n, n))
    jm = jm + jm.T
    np.fill_diagonal(jm, 0.0)
    np.testing.assert_allclose(exact.tfi_hamiltonian_dense(jm, -0.7, 0.3), jexact.tfi_hamiltonian_dense(jm, -0.7, 0.3),
                               rtol=0, atol=1e-12)
    a, b = exact.tfi_chain_dense(n, h=-1.0, j=-1.0), jexact.tfi_chain_dense(n, h=-1.0, j=-1.0)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    assert exact.ground_energy(a) == pytest.approx(jexact.ground_energy(b), abs=1e-10)
    assert exact.tfi_chain_exact_energy(n, -1.0, -1.0) == pytest.approx(jexact.tfi_chain_exact_energy(n, -1.0, -1.0),
                                                                        abs=1e-10)


@pytest.mark.parametrize("n,alpha,pbc", [(6, 2.0, True), (8, 2.5, True), (10, 2.5, True), (8, 3.0, False)])
def test_litfi_builder_and_ground_state_match(n, alpha, pbc):
    h, j = -math.cos(2.0), math.sin(2.0)
    a = exact.litfi_chain_dense(n, h=h, j=j, alpha=alpha, pbc=pbc)
    b = jexact.litfi_chain_dense(n, h=h, j=j, alpha=alpha, pbc=pbc)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    e, psi = exact.ground_state(a)
    je, jpsi = jexact.ground_state(b)
    assert e == pytest.approx(je, abs=1e-10)
    np.testing.assert_allclose(psi**2, jpsi**2, rtol=0, atol=1e-10)  # the sign of an eigenvector is free


@pytest.mark.parametrize("pbc,v", [(True, None), (False, (0.1, -0.2, 0.3, 0.05, 0.0, 0.2, -0.1, 0.4))])
def test_hubbard_builder_and_sectors_match(pbc, v):
    l = 4
    a = exact.hubbard_chain_dense(l, u=4.0, t=1.0, pbc=pbc, v=v)
    b = jexact.hubbard_chain_dense(l, u=4.0, t=1.0, pbc=pbc, v=v)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    for n_up, n_down in ((2, 2), (1, 3)):
        sa, ia = exact.sector_restrict(a, l, n_up, n_down)
        sb, ib = jexact.sector_restrict(b, l, n_up, n_down)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_allclose(sa, sb, rtol=0, atol=1e-12)
        assert exact.ground_energy(sa) == pytest.approx(jexact.ground_energy(sb), abs=1e-10)


def test_litfi_lanczos_matches_dense_at_n12():
    n, theta, alpha = 12, 2.0, 2.5
    e, psi = exact.litfi_ground_state_lanczos(n, theta, alpha)
    e_dense, psi_dense = exact.ground_state(exact.litfi_chain_dense(n, h=-math.cos(theta), j=math.sin(theta),
                                                                     alpha=alpha))
    assert e == pytest.approx(e_dense, abs=1e-9)
    np.testing.assert_allclose(psi**2, psi_dense**2, rtol=0, atol=1e-8)
    je, jpsi = jexact.litfi_ground_state_lanczos(n, theta, alpha)
    assert e == pytest.approx(je, abs=1e-10)
    np.testing.assert_allclose(psi**2, jpsi**2, rtol=0, atol=1e-8)


@pytest.mark.parametrize("theta", [0.9, 2.0])
def test_litfi_binder_matches_at_n10(theta):
    got, want = exact.litfi_binder_exact(10, theta, 2.5), jexact.litfi_binder_exact(10, theta, 2.5)
    assert set(got) == set(want) == {"m1", "m2", "m4", "U"}
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-9)


@pytest.mark.parametrize("n,stage", [(10, "ed"), (10, "ed_sector"), (12, "ed_sector")])
def test_precision_anchor_ed_stages_match_dense(n, stage, tmp_path):
    """The port's counterpart of tests/test_mixed_precision.py's ED check:
    the anchor's chunked and sector Lanczos against the dense ground energy."""
    run = {"ed": precision_anchor.run_ed, "ed_sector": precision_anchor.run_ed_sector}[stage]
    e0 = run(n, str(tmp_path))
    dense = exact.ground_energy(exact.litfi_chain_dense(n, h=-math.cos(precision_anchor.THETA),
                                                        j=math.sin(precision_anchor.THETA),
                                                        alpha=precision_anchor.ALPHA_J, pbc=True))
    assert e0 == pytest.approx(dense, abs=1e-9)
    assert (tmp_path / f"precision_anchor_ed_N{n}.json").exists()
