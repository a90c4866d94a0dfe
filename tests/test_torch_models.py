"""PyTorch port vs the JAX package: the seven machines of the registry, the
engine functions that take per-walker flips, hidden-subset training and
parameters carried across from the JAX package's init.

All comparisons run in float64 on the CPU at N=8, H <= 24, on the same numpy
spins and parameters; the two packages evaluate the same formulas and agree
to rounding (1e-10 relative). The engine functions and grad_log of every
machine are held in test_torch_ops.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu import models as jmodels
from neural_network_quantum_state_tpu.ops import engine as jengine
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu_torch import models as tmodels
from neural_network_quantum_state_tpu_torch.models import params_from_jax
from neural_network_quantum_state_tpu_torch.ops import engine

from test_torch_ops import KINDS, _both, _machines, _np, _t

TOL = 1e-10
NEW_KINDS = ["RBMSfSymm", "RBMZ2PrSymm", "FFNN", "FFNNTrSymm", "FFNNSfSymm"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL * np.abs(_np(want)).max())


def test_registry_matches_jax():
    assert set(tmodels.REGISTRY) == set(jmodels.REGISTRY)
    assert {cls.__name__ for cls in tmodels.REGISTRY.values()} == {cls.__name__ for cls in jmodels.REGISTRY.values()}
    assert isinstance(tmodels.get_machine("FFNNTrSymm", n_inputs=8, alpha=2), tmodels.FFNNTrSymm)
    with pytest.raises(KeyError):
        tmodels.get_machine("cnn", n_inputs=8)


@pytest.mark.parametrize("kind", KINDS)
def test_n_vars_and_work_shapes(kind):
    jm, tm = _machines()[kind]
    params = tm.init_params(torch.Generator().manual_seed(0))
    assert tm.n_vars == jm.n_vars == tm.flatten_params(params).numel()
    work = tm.make_work(params)
    assert tuple(work.w.shape) == (tm.n_inputs, tm.n_hidden) and tuple(work.b.shape) == (tm.n_hidden,)
    assert (work.a is None) == (kind in ("RBMSfSymm", "RBMZ2PrSymm") or kind.startswith("FFNN"))
    assert (work.c is None) == kind.startswith("RBM")


@pytest.mark.parametrize("kind", KINDS)
def test_per_walker_flips_match_jax(kind, rng):
    """flip_log_psi_per_walker, flip2_log_psi_per_walker and
    all_flip2_log_psi (the Kawasaki proposal and the Hubbard hopping
    estimator) with the machine's a and c."""
    jm, tm, jp, tp, spins = _both(kind, rng)
    jwork, work = jm.make_work(jp), tm.make_work(tp)
    jcache, _ = jengine.full_forward(jwork, jnp.asarray(spins))
    cache, _ = engine.full_forward(work, _t(spins))
    k, n = spins.shape
    i, j = rng.integers(0, n, size=k), rng.integers(0, n, size=k)
    _close(engine.flip_log_psi_per_walker(work, cache, _t(i)),
           jengine.flip_log_psi_per_walker(jwork, jcache, jnp.asarray(i)))
    _close(engine.flip2_log_psi_per_walker(work, cache, _t(i), _t(j)),
           jengine.flip2_log_psi_per_walker(jwork, jcache, jnp.asarray(i), jnp.asarray(j)))
    a_idx, b_idx = np.arange(n - 1), np.arange(1, n)
    _close(engine.all_flip2_log_psi(work, cache, _t(a_idx), _t(b_idx)),
           jengine.all_flip2_log_psi(jwork, jcache, jnp.asarray(a_idx), jnp.asarray(b_idx)))
    # the per-walker flip of one site everywhere is flip_log_psi of that site
    torch.testing.assert_close(engine.flip_log_psi_per_walker(work, cache, torch.full((k,), 3)),
                               engine.flip_log_psi(work, cache, 3), rtol=0, atol=1e-13)


@pytest.mark.parametrize("kind, nodes", [("RBM", [2, 5, 11]), ("FFNN", [1, 4, 7]), ("FFNN", [0, 0, 9])],
                         ids=["RBM", "FFNN", "FFNN-repeated-node"])
def test_partial_grad_and_update_match_jax(kind, nodes, rng):
    """grad_log_partial and update_params_partial in the reference's
    partial layouts (as tests/test_ffnn_partial.py and
    tests/test_parity_extras.py:82), against the JAX package's; a repeated
    node accumulates its updates as JAX's .at[].add does."""
    jm, tm, jp, tp, spins = _both(kind, rng)
    jcache, _ = jengine.full_forward(jm.make_work(jp), jnp.asarray(spins))
    cache, _ = engine.full_forward(tm.make_work(tp), _t(spins))
    got = tm.grad_log_partial(tp, cache, nodes)
    _close(got, jm.grad_log_partial(jp, jcache, nodes))
    dx = rng.normal(size=got.shape[1]) + 1j * rng.normal(size=got.shape[1])
    jnew = jm.update_params_partial(jp, C(jnp.asarray(dx.real), jnp.asarray(dx.imag)), 0.1, nodes)
    new = tm.update_params_partial(tp, _t(dx), 0.1, nodes)
    assert set(new) == set(tp)
    for name in tp:
        _close(new[name], jnew[name])
    others = [j for j in range(tm.n_hidden) if j not in nodes]
    w = "w" if kind == "RBM" else "wi1"
    torch.testing.assert_close(new[w][:, others], tp[w][:, others], rtol=0, atol=0)


@pytest.mark.parametrize("kind", NEW_KINDS)
def test_params_from_jax_init(kind):
    """The JAX package's own initial parameters (split-complex pairs)
    carried across: the same ln psi on the same spins, in float64."""
    jm, tm = _machines()[kind]
    jp = jm.init_params(jax.random.PRNGKey(3))
    tp = params_from_jax(tm, {name: (np.asarray(v.re), np.asarray(v.im)) for name, v in jp.items()}, device="cpu")
    assert [(name, tuple(v.shape)) for name, v in tp.items()] == [(name, tuple(s)) for name, s in tm.param_spec()]
    spins = np.where(np.random.default_rng(3).random((16, tm.n_inputs)) < 0.5, -1.0, 1.0)
    _, jln = jengine.full_forward(jm.make_work(jp), jnp.asarray(spins))
    _, ln = engine.full_forward(tm.make_work(tp), _t(spins))
    _close(ln, jln)


@pytest.mark.parametrize("kind", ["FFNN", "FFNNTrSymm", "FFNNSfSymm"])
def test_ffnn_init_scales_only_the_imaginary_plane(kind):
    """The FFNN family's init draws the imaginary plane at 0.1 of the real
    one (the JAX package's imag_scale); the RBM family's planes alike."""
    _, tm = _machines(n=16)[kind]
    params = tm.init_params(torch.Generator().manual_seed(1))
    ratio = float(params["wi1"].imag.std() / params["wi1"].real.std())
    assert 0.07 < ratio < 0.13, ratio
    rbm = tmodels.RBM(n_inputs=16, n_hiddens=32, dtype=torch.float64).init_params(torch.Generator().manual_seed(1))
    assert 0.8 < float(rbm["w"].imag.std() / rbm["w"].real.std()) < 1.25
