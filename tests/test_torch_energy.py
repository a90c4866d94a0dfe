"""PyTorch port vs the JAX package: off-diagonal local energy and the Ising
local energies.

The plain off-diagonal sum is held to the JAX package's chunked path in
float64 (1e-10; every machine of the registry) and, in float32, to the JAX
Pallas kernel run in interpret mode, at that kernel's own bars: 3e-6
relative for the RBM family, 2e-4 for the FFNN family's output weights. The
interpret-mode oracles are computed in a child process (``interpret_oracles``),
never in the pytest worker. The CUDA kernel's tests are in test_torch_gpu.py.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu.hamiltonians import LITFIChain as JLITFIChain
from neural_network_quantum_state_tpu.hamiltonians import TFIChain as JTFIChain
from neural_network_quantum_state_tpu.hamiltonians.ising import _offdiag_sum as j_offdiag_sum
from neural_network_quantum_state_tpu import models as jmodels
from neural_network_quantum_state_tpu.ops import engine as jengine
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu_torch.hamiltonians import LITFIChain, TFIChain
from neural_network_quantum_state_tpu_torch import models as tmodels
from neural_network_quantum_state_tpu_torch.models import params_from_jax
from neural_network_quantum_state_tpu_torch.ops import energy, engine
from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work
from neural_network_quantum_state_tpu_torch.ops.rng import make_generator

from test_torch_ops import KINDS, _SHAPES


def _np(c):
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def _t(x):
    return torch.as_tensor(np.asarray(x))


# The shapes at which the interpret-mode oracles run the JAX Pallas energy
# kernel (walkers, walkers per block): the RBM family at the JAX package's own
# kernel test's K=128 in blocks of 64, the FFNN family's output weights c at
# K=64 in blocks of 32. The oracles run in a child process
# (interpret_oracles), so the worker never compiles an interpret kernel that
# a JAX test compiles again: in one worker, with the FFNN case at the JAX
# test's shapes, tests/test_pallas_energy.py::test_offdiag_kernel_matches_xla
# deadlocked in JAX's interpret mode in four of seven full runs of the suite.
# test_ffnn_interpret_shapes_differ_from_the_jax_tests still holds the FFNN
# shapes apart from the JAX tests'.
RBM_INTERPRET_K, RBM_INTERPRET_BLOCK = 128, 64
FFNN_INTERPRET_K, FFNN_INTERPRET_BLOCK = 64, 32
INTERPRET_N, INTERPRET_SEED = 16, 1234
INTERPRET_CASES = [  # (kind, walkers, block)
    ("RBM", RBM_INTERPRET_K, RBM_INTERPRET_BLOCK),
    ("RBMTrSymm", RBM_INTERPRET_K, RBM_INTERPRET_BLOCK),
    ("FFNN", FFNN_INTERPRET_K, FFNN_INTERPRET_BLOCK),
    ("FFNNTrSymm", FFNN_INTERPRET_K, FFNN_INTERPRET_BLOCK),
]
INTERPRET_TIMEOUT_S = 600

# The child: for each case, the JAX machine's initial parameters (as the JAX
# package's own kernel test takes them) and random spins from numpy, the
# float32 forward, and the Pallas energy kernel in interpret mode; writes the
# inputs and the sums to an .npz.
_ORACLE_CHILD = r"""
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from neural_network_quantum_state_tpu import models as jmodels
from neural_network_quantum_state_tpu.ops import engine as jengine
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu.ops.pallas_energy import pallas_offdiag_sum

out_path, spec = sys.argv[1], json.loads(sys.argv[2])
n = spec["n"]
rng = np.random.default_rng(spec["seed"])
arrays = {}
for kind, kw, k, block in spec["cases"]:
    jm = jmodels.get_machine(kind, n_inputs=n, dtype=jnp.float32, **kw)
    params = {p: np.asarray(v.re) + 1j * np.asarray(v.im) for p, v in jm.init_params(jax.random.PRNGKey(0)).items()}
    spins = np.where(rng.random((k, n)) < 0.5, -1.0, 1.0).astype(np.float32)
    jp = {p: C(jnp.asarray(v.real, np.float32), jnp.asarray(v.imag, np.float32)) for p, v in params.items()}
    jwork = jm.make_work(jp)
    jcache, jln = jengine.full_forward(jwork, jnp.asarray(spins))
    want = pallas_offdiag_sum(jwork, jcache, jln, jnp.arange(n, dtype=jnp.int32), block_k=block, interpret=True)
    arrays[kind + "/spins"] = spins
    arrays[kind + "/want"] = np.asarray(want.re) + 1j * np.asarray(want.im)
    for p, v in params.items():
        arrays[kind + "/param/" + p] = v
np.savez(out_path, **arrays)
"""


@pytest.fixture(scope="module")
def interpret_oracles(tmp_path_factory):
    """The four interpret-mode oracles, computed by one child process (with
    JAX_PLATFORMS=cpu) within INTERPRET_TIMEOUT_S: a deadlocked child fails
    the tests that read it instead of hanging the suite."""
    out = tmp_path_factory.mktemp("interpret") / "oracles.npz"
    spec = {"n": INTERPRET_N, "seed": INTERPRET_SEED,
            "cases": [(kind, _SHAPES[kind], k, block) for kind, k, block in INTERPRET_CASES]}
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(root), *filter(None, [os.environ.get("PYTHONPATH")])]))
    proc = subprocess.run([sys.executable, "-c", _ORACLE_CHILD, str(out), json.dumps(spec)], cwd=root, env=env,
                          capture_output=True, text=True, timeout=INTERPRET_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(out) as f:
        return {name: f[name] for name in f.files}


def _interpret_case(oracles, kind):
    """The port's float32 machine, cache and ln psi on the child's inputs, and
    the child's interpret-mode sums."""
    tm = tmodels.get_machine(kind, n_inputs=INTERPRET_N, dtype=torch.float32, **_SHAPES[kind])
    prefix = f"{kind}/param/"
    p_np = {name[len(prefix):]: v for name, v in oracles.items() if name.startswith(prefix)}
    work = tm.make_work(params_from_jax(tm, p_np, device="cpu"))
    cache, ln = engine.full_forward(work, _t(oracles[f"{kind}/spins"]))
    return work, cache, ln, oracles[f"{kind}/want"]


def _setup(kind, n, k, rng, f64=True, scale=0.4):
    """Same machine, parameters and spins in both packages."""
    dj, dt = (jnp.float64, torch.float64) if f64 else (jnp.float32, torch.float32)
    kw = _SHAPES[kind]
    jm, tm = jmodels.get_machine(kind, n_inputs=n, dtype=dj, **kw), tmodels.get_machine(kind, n_inputs=n, dtype=dt, **kw)
    p_np = {name: scale * (rng.normal(size=s) + 1j * rng.normal(size=s)) for name, s in jm.param_spec()}
    npdt = np.float64 if f64 else np.float32
    jp = {name: C(jnp.asarray(v.real, npdt), jnp.asarray(v.imag, npdt)) for name, v in p_np.items()}
    spins = np.where(rng.random((k, n)) < 0.5, -1.0, 1.0).astype(npdt)
    jwork = jm.make_work(jp)
    jcache, jln = jengine.full_forward(jwork, jnp.asarray(spins))
    work = tm.make_work(params_from_jax(tm, p_np, device="cpu"))
    cache, ln = engine.full_forward(work, _t(spins))
    return (jwork, jcache, jln), (work, cache, ln)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_offdiag_matches_jax_f64(kind, rng):
    n = 16
    (jwork, jcache, jln), (work, cache, ln) = _setup(kind, n, 64, rng)
    want = _np(j_offdiag_sum(jwork, jcache, jln, n, fused=False))
    got = energy.offdiag_sum_plain(work, cache, ln).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("kind", ["RBM", "RBMTrSymm"])
def test_plain_offdiag_matches_pallas_interpret_f32(kind, interpret_oracles):
    """float32 plain path vs the JAX Pallas energy kernel (interpret mode, in
    the child process) on the inputs of the JAX package's own kernel test
    (initial parameters, random spins, K=128 in blocks of 64): max|difference|
    within 3e-6 of max|sum|, the kernel's bar against the XLA path."""
    work, cache, ln, want = _interpret_case(interpret_oracles, kind)
    assert want.shape == (RBM_INTERPRET_K,)
    got = energy.offdiag_sum(work, cache, ln).numpy()
    assert got.dtype == np.complex64
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 3e-6, rel


@pytest.mark.parametrize("kind", ["FFNN", "FFNNTrSymm"])
def test_plain_offdiag_matches_pallas_interpret_ffnn_f32(kind, interpret_oracles):
    """float32 plain path vs the JAX Pallas energy kernel's branch with
    output weights c (interpret mode, in the child process) on inputs like
    the JAX package's own test's (initial parameters, random spins, N=16), at
    that test's bar against the XLA path: rtol = atol = 2e-4 on each plane.
    The shapes are FFNN_INTERPRET_K and FFNN_INTERPRET_BLOCK, not that test's."""
    work, cache, ln, want = _interpret_case(interpret_oracles, kind)
    assert work.c is not None and work.a is None
    assert want.shape == (FFNN_INTERPRET_K,)
    got = energy.offdiag_sum(work, cache, ln)
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.real.numpy(), want.real, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.imag.numpy(), want.imag, rtol=2e-4, atol=2e-4)


def test_ffnn_interpret_shapes_differ_from_the_jax_tests():
    """The interpret-mode oracle with output weights c takes no pair
    (walker count, block size) of a JAX package test file that runs the
    energy kernel (the tests/test_pallas*.py that call pallas_offdiag_sum),
    and no port test runs such a kernel in interpret mode outside the
    child's source; see FFNN_INTERPRET_K."""
    pairs = set()
    for path in Path(__file__).parent.glob("test_pallas*.py"):
        src = path.read_text()
        if "pallas_offdiag_sum(" not in src:
            continue
        ks = {int(v) for v in re.findall(r"\bk(?:, \w+)* = [^,\n]+, (\d+)", src)}
        blocks = {int(v) for v in re.findall(r"block_k=(\d+)", src)}
        assert ks and blocks, path.name
        pairs |= {(k, b) for k in ks for b in blocks}
    assert pairs
    assert (FFNN_INTERPRET_K, FFNN_INTERPRET_BLOCK) not in pairs, sorted(pairs)
    for path in Path(__file__).parent.glob("test_torch_*.py"):
        src = path.read_text().replace(_ORACLE_CHILD, "") if path.name == Path(__file__).name else path.read_text()
        assert not re.search(r"interpret\s*=\s*True", src), path.name


def test_chunked_plain_path_matches_one_chunk(rng, monkeypatch):
    n = 16
    _, (work, cache, ln) = _setup("RBMTrSymm", n, 32, rng)
    whole = energy.offdiag_sum_plain(work, cache, ln)
    monkeypatch.setattr(energy, "OFFDIAG_CHUNK_ELEMS", 32 * work.w.shape[1] * 5)  # chunks of 5 sites
    np.testing.assert_allclose(energy.offdiag_sum_plain(work, cache, ln).numpy(), whole.numpy(), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("ham", ["LITFIChain", "TFIChain"])
def test_local_energy_matches_jax(ham, rng):
    n = 16
    (jwork, jcache, jln), (work, cache, ln) = _setup("RBMTrSymm", n, 64, rng)
    if ham == "LITFIChain":
        jh, th = (cls(n_sites=n, h=-0.5, j=0.866, alpha=2.5, pbc=True) for cls in (JLITFIChain, LITFIChain))
    else:
        jh, th = (cls(n_sites=n, h=-1.0, j=-1.0) for cls in (JTFIChain, TFIChain))
    np.testing.assert_array_equal(th.schedule(), jh.schedule())
    want = _np(jh.local_energy(jwork, jcache, jln))
    np.testing.assert_allclose(th.local_energy(work, cache, ln).numpy(), want, rtol=1e-10, atol=1e-10)


def test_litfi_init_spins_and_j_matrix_match_jax():
    jh, th = JLITFIChain(n_sites=10, j=0.9), LITFIChain(n_sites=10, j=0.9)
    np.testing.assert_array_equal(th.j_matrix, jh.j_matrix)
    want = np.asarray(jh.init_spins(jax.random.PRNGKey(0), 4, jnp.float32))
    np.testing.assert_array_equal(th.init_spins(make_generator(0, "cpu"), 4).numpy(), want)
    with pytest.raises(ValueError, match="even L"):
        LITFIChain(n_sites=9)


def test_wrapper_runs_plain_on_cpu_and_kernel_refuses_cpu(rng):
    _, (work, cache, ln) = _setup("RBMTrSymm", 16, 32, rng, f64=False)
    calls, launches = energy.offdiag_sum_plain.calls, energy.offdiag_sum_cuda.launches
    np.testing.assert_array_equal(energy.offdiag_sum(work, cache, ln).numpy(), energy.offdiag_sum_plain(work, cache, ln).numpy())
    assert energy.offdiag_sum_plain.calls == calls + 2
    with pytest.raises(ValueError, match="CUDA"):
        energy.offdiag_sum_cuda(work, cache)
    assert energy.offdiag_sum_cuda.launches == launches


def test_off_cpu_tensors_never_run_the_plain_sum(rng):
    """A tensor off the CPU goes to the kernel or raises: float64 and
    float32 (the kernel's two instances) reach the kernel's input checks,
    which want a CUDA device (here the tensors are on the meta device); a
    dtype with no instance (float16) is not ported (NotImplementedError)."""
    calls = energy.offdiag_sum_plain.calls
    launches = (energy.offdiag_sum_cuda.launches, energy.offdiag_sum_cuda.launches_f64)
    for f64, half, err in ((True, False, ValueError), (False, False, ValueError), (False, True, NotImplementedError)):
        _, (work, cache, ln) = _setup("RBMTrSymm", 16, 8, rng, f64=f64)
        meta_work = Work(*(None if t is None else t.to("meta") for t in work))
        meta_cache = Cache(*(t.to("meta") for t in cache))
        if half:
            meta_cache = meta_cache._replace(spins=meta_cache.spins.half())
        with pytest.raises(err):
            energy.offdiag_sum(meta_work, meta_cache, ln.to("meta"))
    assert energy.offdiag_sum_plain.calls == calls
    assert (energy.offdiag_sum_cuda.launches, energy.offdiag_sum_cuda.launches_f64) == launches
