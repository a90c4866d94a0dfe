"""The port's checkpoints against the JAX package's.

Reference text (``utils/checkpoint.py``): for every machine of the registry,
float32 (8 digits) and float64 (15), the port writes byte for byte the
files the JAX package writes for the same parameters (carried over with
``params_from_jax``), each package reads the other's files to the same
values, and both parse the recorded flagship run. Structured npz: each
package reads the other's params, step and spins; a JAX file's threefry key
seeds the port's generator deterministically, and a port file restores its
generator's state. A checkpoint of another machine is refused. Orbax
directories: tests/test_torch_orbax.py.
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu import models as jmodels
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu.utils import checkpoint as jck
from neural_network_quantum_state_tpu_torch import models as tmodels
from neural_network_quantum_state_tpu_torch.models import params_from_jax
from neural_network_quantum_state_tpu_torch.utils import checkpoint as tck

from test_torch_ops import KINDS, _SHAPES, _np

DTYPES = {"float32": (jnp.float32, torch.float32), "float64": (jnp.float64, torch.float64)}
FLAGSHIP_RUN = Path(__file__).resolve().parents[1] / "runs" / "RBMTrSymmLICH-L64NF4A2.5T2V1"


def _pair(kind, dtype, rng, n=8):
    """(JAX machine, port machine, JAX params, port params, complex numpy
    params) with entries spread over magnitudes 1e-8..1e6 and signed zeros,
    so every branch of %g (fixed, exponent, -0) is written."""
    jdt, tdt = DTYPES[dtype]
    jm = jmodels.get_machine(kind, n_inputs=n, dtype=jdt, **_SHAPES[kind])
    tm = tmodels.get_machine(kind, n_inputs=n, dtype=tdt, **_SHAPES[kind])
    p_np = {}
    for name, shape in jm.param_spec():
        z = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * 10.0 ** rng.uniform(-8, 6, size=shape)
        flat = z.reshape(-1)
        flat[:2] = [0.0, complex(-0.0, 0.0)][: flat.size]
        p_np[name] = z
    jp = {k: C(jnp.asarray(v.real, jdt), jnp.asarray(v.imag, jdt)) for k, v in p_np.items()}
    tp = params_from_jax(tm, p_np, device="cpu")
    return jm, tm, jp, tp, p_np


def _files(paths):
    return {os.path.basename(p): Path(p).read_bytes() for p in paths}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", KINDS)
def test_reference_text_is_byte_identical_to_jax(kind, dtype, tmp_path, rng):
    """The same files, byte for byte, at the default precision (8 digits for
    float32, 15 for float64) and at an explicit one."""
    jm, tm, jp, tp, _ = _pair(kind, dtype, rng)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    for precision in (None, 11):
        jw = jck.save_reference_text(jm, jp, str(tmp_path / "j" / "run"), precision=precision)
        tw = tck.save_reference_text(tm, tp, str(tmp_path / "t" / "run"), precision=precision)
        assert _files(tw) == _files(jw)
    text = Path(tw[0]).read_text()
    assert text.endswith(")\n") and "  " not in text


@pytest.mark.parametrize("kind", KINDS)
def test_each_package_loads_the_others_text(kind, tmp_path, rng):
    """Each package reads the other's files to the same values (float64,
    15 digits: both parse the same text)."""
    jm, tm, jp, tp, _ = _pair(kind, "float64", rng)
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    jck.save_reference_text(jm, jp, jpath)
    tck.save_reference_text(tm, tp, tpath)
    for path in (jpath, tpath):
        got_t = tck.load_reference_text(tm, path, device="cpu")
        got_j = jck.load_reference_text(jm, path)
        for name, _ in tm.param_spec():
            assert np.array_equal(got_t[name].numpy(), _np(got_j[name]))
            np.testing.assert_allclose(got_t[name].numpy(), tp[name].numpy(), rtol=1e-14, atol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flagship_run_parses_the_same(dtype):
    """The recorded flagship run (RBMTrSymm, N=64, alpha=4), the N=64 anchor's
    warm start, parses to the same values in both packages."""
    jdt, tdt = DTYPES[dtype]
    jm = jmodels.RBMTrSymm(n_inputs=64, alpha=4, dtype=jdt)
    tm = tmodels.RBMTrSymm(n_inputs=64, alpha=4, dtype=tdt)
    got_t = tck.load_reference_text(tm, str(FLAGSHIP_RUN), device="cpu")
    got_j = jck.load_reference_text(jm, str(FLAGSHIP_RUN))
    assert tm.flatten_params(got_t).numel() == tm.n_vars == 261
    for name, _ in tm.param_spec():
        assert got_t[name].dtype == tm.complex_dtype
        assert np.array_equal(got_t[name].numpy(), _np(got_j[name]))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["RBM", "RBMTrSymm", "FFNN"])
def test_npz_cross_loads_both_ways(kind, dtype, tmp_path, rng):
    """Params, step and spins cross both ways; the port's file carries its
    generator's state (JAX reads no key from it), a JAX file's key seeds the
    port's generator, the same file the same stream."""
    jm, tm, jp, tp, _ = _pair(kind, dtype, rng)
    spins = np.where(rng.random((16, 8)) < 0.5, -1.0, 1.0)
    jpath, tpath = str(tmp_path / "j.state.npz"), str(tmp_path / "t.state.npz")
    jck.save_npz(jpath, jm, jp, step=42, key=jax.random.PRNGKey(3), spins=jnp.asarray(spins, DTYPES[dtype][0]))
    g = torch.Generator().manual_seed(5)
    tck.save_npz(tpath, tm, tp, step=17, generator=g, spins=torch.as_tensor(spins, dtype=tm.dtype))

    p2, step, gen, sp = tck.load_npz(jpath, tm, device="cpu")
    assert step == 42 and np.array_equal(sp.numpy(), spins) and sp.dtype == tm.dtype
    for name, _ in tm.param_spec():
        assert np.array_equal(p2[name].numpy(), _np(jp[name]))
    again = tck.load_npz(jpath, tm, device="cpu")[2]
    assert torch.equal(torch.rand(4, generator=gen), torch.rand(4, generator=again))

    jp2, jstep, key, jsp = jck.load_npz(tpath, jm)
    assert jstep == 17 and key is None and np.array_equal(np.asarray(jsp), spins)
    for name, _ in tm.param_spec():
        assert np.array_equal(_np(jp2[name]), tp[name].numpy())


def test_npz_restores_the_generator_state(tmp_path, rng):
    """A port file resumed on the device type it was saved from continues
    the saving generator's stream; saved without a generator or spins, the
    file holds neither."""
    tm = tmodels.RBMTrSymm(n_inputs=8, alpha=2, dtype=torch.float64)
    tp = tm.init_params(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(11)
    torch.rand(7, generator=g)
    tck.save_npz(str(tmp_path / "a.npz"), tm, tp, step=3, generator=g, spins=torch.ones(4, 8, dtype=torch.float64))
    _, step, g2, _ = tck.load_npz(str(tmp_path / "a.npz"), tm, device="cpu")
    assert step == 3 and torch.equal(torch.rand(5, generator=g), torch.rand(5, generator=g2))
    tck.save_npz(str(tmp_path / "b.npz"), tm, tp)
    assert tck.load_npz(str(tmp_path / "b.npz"), tm, device="cpu")[2:] == (None, None)


def test_wrong_machine_is_rejected(tmp_path):
    """An npz of another machine and a text file of another size raise."""
    m1 = tmodels.RBM(n_inputs=6, n_hiddens=4, dtype=torch.float64)
    m2 = tmodels.RBMTrSymm(n_inputs=6, alpha=2, dtype=torch.float64)
    m3 = tmodels.RBMTrSymm(n_inputs=6, alpha=3, dtype=torch.float64)
    g = torch.Generator().manual_seed(0)
    tck.save_npz(str(tmp_path / "m1.npz"), m1, m1.init_params(g))
    with pytest.raises(ValueError, match="checkpoint is for RBM"):
        tck.load_npz(str(tmp_path / "m1.npz"), m2, device="cpu")
    tck.save_reference_text(m2, m2.init_params(g), str(tmp_path / "m2"))
    with pytest.raises(ValueError, match="expected"):
        tck.load_reference_text(m3, str(tmp_path / "m2"), device="cpu")

