"""PyTorch port vs the JAX package: log-cosh, engine, models.

Inputs are made with numpy from a seed and handed to both packages; all
comparisons run in float64 on the CPU, where the two evaluate the same
formulas and agree to rounding (1e-12).
"""

import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu.models import RBM as JRBM
from neural_network_quantum_state_tpu.models import RBMTrSymm as JRBMTrSymm
from neural_network_quantum_state_tpu.ops import engine as jengine
from neural_network_quantum_state_tpu.ops import logcosh as jlogcosh
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu_torch.models import RBM, RBMTrSymm, params_from_jax
from neural_network_quantum_state_tpu_torch.ops import engine, logcosh

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-12


def _np(c):
    """JAX split-complex C (or real array) -> numpy."""
    if isinstance(c, C):
        return np.asarray(c.re) + 1j * np.asarray(c.im)
    return np.asarray(c)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _machines(n=8):
    return {
        "RBM": (JRBM(n_inputs=n, n_hiddens=12, dtype=jnp.float64), RBM(n_inputs=n, n_hiddens=12, dtype=torch.float64)),
        "RBMTrSymm": (JRBMTrSymm(n_inputs=n, alpha=2, dtype=jnp.float64), RBMTrSymm(n_inputs=n, alpha=2, dtype=torch.float64)),
    }


def _random_params(jm, rng, scale=0.3):
    return {
        name: scale * (rng.normal(size=shape) + 1j * rng.normal(size=shape))
        for name, shape in jm.param_spec()
    }


def _both(kind, rng, k=32):
    """(jax machine, port machine, jax params, port params, spins numpy)."""
    jm, tm = _machines()[kind]
    p_np = _random_params(jm, rng)
    jp = {k_: C(jnp.asarray(v.real), jnp.asarray(v.imag)) for k_, v in p_np.items()}
    tp = params_from_jax(tm, p_np, device="cpu")
    spins = np.where(rng.random((k, jm.n_inputs)) < 0.5, -1.0, 1.0)
    return jm, tm, jp, tp, spins


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("fn", ["logcosh_ri", "tanh_ri"])
def test_split_planes_match_jax(fn, rng):
    # wide x range: the stable formulas must not overflow at |x| ~ 40
    x = np.concatenate([rng.normal(size=400) * 3.0, [-40.0, -0.0, 0.0, 40.0]])
    y = np.concatenate([rng.normal(size=400) * 4.0, [1.0, 2.0, -3.0, 0.5]])
    want = getattr(jlogcosh, fn)(jnp.asarray(x), jnp.asarray(y))
    got = getattr(logcosh, fn)(_t(x), _t(y))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_complex_wrappers_match_numpy(rng):
    z = rng.normal(size=200) + 1j * rng.normal(size=200)
    np.testing.assert_allclose(logcosh.logcosh(_t(z)).numpy(), np.log(np.cosh(z)), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(logcosh.tanh(_t(z)).numpy(), np.tanh(z), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["RBM", "RBMTrSymm"])
def test_full_forward_matches_jax(kind, rng):
    jm, tm, jp, tp, spins = _both(kind, rng)
    jcache, jln = jengine.full_forward(jm.make_work(jp), jnp.asarray(spins))
    cache, ln = engine.full_forward(tm.make_work(tp), _t(spins))
    np.testing.assert_allclose(cache.y.numpy(), _np(jcache.y), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(cache.sa.numpy(), _np(jcache.sa), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ln.numpy(), _np(jln), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["RBM", "RBMTrSymm"])
def test_flip_commit_and_all_flips_match_jax(kind, rng):
    jm, tm, jp, tp, spins = _both(kind, rng)
    jwork, work = jm.make_work(jp), tm.make_work(tp)
    jcache, _ = jengine.full_forward(jwork, jnp.asarray(spins))
    cache, _ = engine.full_forward(work, _t(spins))
    site = 3
    np.testing.assert_allclose(
        engine.flip_log_psi(work, cache, site).numpy(), _np(jengine.flip_log_psi(jwork, jcache, site)), rtol=TOL, atol=TOL
    )
    accept = rng.random(spins.shape[0]) < 0.5
    jc2 = jengine.commit_flip(jwork, jcache, site, jnp.asarray(accept))
    c2 = engine.commit_flip(work, cache, site, _t(accept))
    np.testing.assert_array_equal(c2.spins.numpy(), np.asarray(jc2.spins))
    np.testing.assert_allclose(c2.y.numpy(), _np(jc2.y), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(c2.sa.numpy(), _np(jc2.sa), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(cache.spins.numpy(), spins)  # input left unchanged
    sites = np.arange(jm.n_inputs)
    np.testing.assert_allclose(
        engine.all_flip_log_psi(work, cache, _t(sites)).numpy(),
        _np(jengine.all_flip_log_psi(jwork, jcache, jnp.asarray(sites))),
        rtol=TOL, atol=TOL,
    )


@pytest.mark.parametrize("kind", ["RBM", "RBMTrSymm"])
def test_grad_log_matches_jax(kind, rng):
    jm, tm, jp, tp, spins = _both(kind, rng)
    jcache, _ = jengine.full_forward(jm.make_work(jp), jnp.asarray(spins))
    cache, _ = engine.full_forward(tm.make_work(tp), _t(spins))
    got = tm.grad_log(tp, cache)
    assert got.shape == (spins.shape[0], tm.n_vars)
    np.testing.assert_allclose(got.numpy(), _np(jm.grad_log(jp, jcache)), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["RBM", "RBMTrSymm"])
def test_flatten_and_update_params_match_jax(kind, rng):
    jm, tm, jp, tp, _ = _both(kind, rng)
    np.testing.assert_allclose(tm.flatten_params(tp).numpy(), _np(jm.flatten_params(jp)), rtol=0, atol=0)
    dx = rng.normal(size=tm.n_vars) + 1j * rng.normal(size=tm.n_vars)
    jnew = jm.update_params(jp, C(jnp.asarray(dx.real), jnp.asarray(dx.imag)), 0.05)
    new = tm.update_params(tp, _t(dx), 0.05)
    for name in tp:
        np.testing.assert_allclose(new[name].numpy(), _np(jnew[name]), rtol=TOL, atol=TOL)


def test_params_from_jax_takes_pairs_and_checks_shapes(rng):
    jm, tm = _machines()["RBMTrSymm"]
    p_np = _random_params(jm, rng)
    pairs = {k: (v.real, v.imag) for k, v in p_np.items()}
    a, b = params_from_jax(tm, p_np, device="cpu"), params_from_jax(tm, pairs, device="cpu")
    for name in a:
        assert a[name].dtype == torch.complex128
        np.testing.assert_array_equal(a[name].numpy(), b[name].numpy())
    p_np["w"] = p_np["w"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tm, p_np, device="cpu")


def _port_sources():
    pkg = REPO / "neural_network_quantum_state_tpu_torch"
    return sorted(pkg.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_sources_name_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|neural_network_quantum_state_tpu)(\.|\s|$)", re.M)
    offenders = [str(p) for p in _port_sources() if pattern.search(p.read_text())]
    assert not offenders, offenders
    assert len(_port_sources()) > 10


def test_port_imports_without_jax():
    """Import every module of the port in a process where JAX and the JAX
    package cannot be imported."""
    modules = [
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in _port_sources()
        if p.name != "chip_smoke.py"
    ]
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['neural_network_quantum_state_tpu'] = None\n"
        f"import importlib\nfor m in {modules!r}:\n    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
