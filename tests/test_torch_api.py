"""The port's pynqs-compatible sampler API (``api/sampler.py``) on the CPU,
through its alias ``neural_network_quantum_state_tpu_torch.pynqs``.

The JAX package's API tests (``tests/test_api.py:22,72,93``) on the port: the
reference's meas_renyi.py access pattern against exact S2, the shapes and
the missing-checkpoint warning, the dispatch errors; the alias surface
(``tests/test_pynqs_scripts.py:29``, whose root ``pynqs`` stays the JAX
package's); and ``get_lnpsi_for_fixed_spins`` equal to the JAX API's on the
same text checkpoint and the same spins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu.api import sampler as j_api
from neural_network_quantum_state_tpu.models import RBMTrSymm as JRBMTrSymm
from neural_network_quantum_state_tpu.utils.checkpoint import save_reference_text as j_save
from neural_network_quantum_state_tpu_torch import api
from neural_network_quantum_state_tpu_torch.models import FFNN, RBMTrSymm
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops.rng import make_generator
from neural_network_quantum_state_tpu_torch.pynqs import sampler
from neural_network_quantum_state_tpu_torch.utils.checkpoint import save_reference_text

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _make_ckpt(tmp_path, n, alpha, seed=0):
    machine = RBMTrSymm(n_inputs=n, alpha=alpha, dtype=torch.float64)
    params = {k: 2.0 * v for k, v in machine.init_params(make_generator(seed, CPU)).items()}
    prefix = str(tmp_path / f"RBMTrSymmCH-N{n}A{alpha}")
    save_reference_text(machine, params, prefix)
    return machine, params, prefix


def _kwargs(n, hidden, chains, path, steps):
    return {"nInputs": n, "nHiddens": hidden, "nChains": chains, "seedDistance": 123456789,
            "init_mcmc_steps": steps, "path_to_load": path}


def test_pynqs_alias_surface():
    """The port's alias re-exports the port's API, as the root pynqs does
    the JAX package's; the root pynqs is untouched."""
    import pynqs as root_pynqs
    from neural_network_quantum_state_tpu_torch import pynqs

    assert sampler.RBM is api.sampler.RBM is api.RBM and sampler.FFNN is api.FFNN
    assert pynqs.__all__ == ["sampler"]
    assert root_pynqs.sampler.RBM is j_api.RBM
    ns: dict = {}
    exec("from neural_network_quantum_state_tpu_torch.pynqs import sampler", ns)
    assert ns["sampler"].RBM is api.sampler.RBM


def test_pynqs_renyi_script_pattern(tmp_path):
    """test_api.py:22: the exact access pattern of python/meas_renyi.py:30-59
    on two samplers of a loaded checkpoint, against exact S2 (0.1)."""
    n, alpha, n_chains = 8, 2, 512
    machine, params, prefix = _make_ckpt(tmp_path, n, alpha)
    kwargs = _kwargs(n, alpha, n_chains, prefix, 100)
    rbms = [sampler.RBM(floatType="float64", symmType="tr", device=CPU) for _ in range(2)]
    for i, rbm in enumerate(rbms):
        kwargs["seedNumber"] = (i + 1) * kwargs["seedDistance"]
        rbm.init(**kwargs)

    l = n // 2
    nmeas, nms = 30, 3
    tr2 = np.zeros(nmeas)
    for i in range(nmeas):
        rbms[0].do_mcmc_steps(nms)
        rbms[1].do_mcmc_steps(nms)
        spins0, spins1 = rbms[0].get_spinStates(), rbms[1].get_spinStates()
        lnpsi_0, lnpsi_1 = rbms[0].get_lnpsi(), rbms[1].get_lnpsi()
        spins2, spins3 = spins0.copy(), spins1.copy()
        spins2[:, :l] = spins1[:, :l]
        spins3[:, :l] = spins0[:, :l]
        lnpsi_2 = rbms[0].get_lnpsi_for_fixed_spins(spins2)
        lnpsi_3 = rbms[1].get_lnpsi_for_fixed_spins(spins3)
        tr2[i] = np.mean(np.exp(lnpsi_2 + lnpsi_3 - lnpsi_0 - lnpsi_1)).real
    renyi = -np.log(np.mean(tr2))

    idx = np.arange(2**n)
    spins = 1.0 - 2.0 * ((idx[:, None] >> np.arange(n)[None, :]) & 1)
    psi = np.exp(engine.log_psi(machine.make_work(params), torch.as_tensor(spins)).numpy())
    psi /= np.linalg.norm(psi)
    psi_mat = psi.reshape(2 ** (n - l), 2**l)
    rho_a = psi_mat.T @ psi_mat.conj()
    s2_exact = -np.log(np.real(np.trace(rho_a @ rho_a)))
    assert abs(renyi - s2_exact) < 0.1, (renyi, s2_exact)


@pytest.mark.parametrize("cls, symm, dtype", [("RBM", "None", "float32"), ("FFNN", "tr", "float64"),
                                              ("RBM", "z2pr", "float64")])
def test_api_shapes_and_load_warning(cls, symm, dtype, tmp_path, capsys):
    """test_api.py:72 (RBM float32 there): a missing checkpoint prints the
    reference's warning and keeps the random parameters; the primitives
    return numpy arrays of the reference's shapes; ln psi on the sampled
    spins equals the sampler's own (1e-5 in float32, 1e-12 in float64);
    each do_mcmc_steps is one sampler call."""
    rbm = getattr(sampler, cls)(floatType=dtype, symmType=symm, device=CPU)
    rbm.init(**_kwargs(6, 2 if symm != "None" else 4, 32, str(tmp_path / "missing"), 10), seedNumber=7)
    assert "is not exist" in capsys.readouterr().out
    s = rbm.get_spinStates()
    assert isinstance(s, np.ndarray) and s.shape == (32, 6) and set(np.unique(s)).issubset({-1.0, 1.0})
    ln = rbm.get_lnpsi()
    assert ln.shape == (32,) and np.iscomplexobj(ln)
    tol = 1e-5 if dtype == "float32" else 1e-12
    np.testing.assert_allclose(rbm.get_lnpsi_for_fixed_spins(s), ln, rtol=tol, atol=tol)
    rbm.do_mcmc_steps(3)
    assert rbm.get_spinStates().shape == (32, 6)


def test_api_bad_dispatch():
    """test_api.py:93: unknown float and symmetry types, and a missing init
    argument, raise as the reference's binding does."""
    with pytest.raises(Exception):
        sampler.RBM(floatType="float16", symmType="None")
    with pytest.raises(Exception):
        sampler.FFNN(floatType="float32", symmType="z2pr")
    rbm = sampler.RBM(floatType="float64", symmType="None", device=CPU)
    with pytest.raises(Exception, match="essential argument"):
        rbm.init(nInputs=4, nHiddens=4)


def test_lnpsi_for_fixed_spins_matches_the_jax_api(tmp_path):
    """Both packages' API load one text checkpoint (written by the JAX
    package) and give the same ln psi on the same fixed spins (1e-10); the
    port's checkpoint load keeps its values (the warning is not printed)."""
    n, alpha, chains = 8, 2, 64
    jm = JRBMTrSymm(n_inputs=n, alpha=alpha, dtype=jnp.float64)
    jp = jax.tree_util.tree_map(lambda x: 3.0 * x, jm.init_params(jax.random.PRNGKey(5)))
    prefix = str(tmp_path / "jax_ckpt")
    j_save(jm, jp, prefix)
    kw = dict(_kwargs(n, alpha, chains, prefix, 5), seedNumber=11)
    j_rbm = j_api.RBM(floatType="float64", symmType="tr")
    j_rbm.init(**kw)
    t_rbm = sampler.RBM(floatType="float64", symmType="tr", device=CPU)
    t_rbm.init(**kw)
    spins = np.where(np.random.default_rng(6).random((chains, n)) < 0.5, 1.0, -1.0)
    np.testing.assert_allclose(t_rbm.get_lnpsi_for_fixed_spins(spins), j_rbm.get_lnpsi_for_fixed_spins(spins),
                               rtol=1e-10, atol=1e-10)
    # the port's own sampled spins, through both
    s = t_rbm.get_spinStates()
    np.testing.assert_allclose(j_rbm.get_lnpsi_for_fixed_spins(s), t_rbm.get_lnpsi(), rtol=1e-10, atol=1e-10)


def test_api_ffnn_machine_dispatch():
    """floatType x symmType pick the reference's machine with its hidden
    keyword: nHiddens is the hidden count of 'None' and alpha of 'tr'."""
    ffnn = sampler.FFNN(floatType="float32", symmType="None", device=CPU)
    ffnn.init(**_kwargs(6, 5, 16, "/nonexistent", 0), seedNumber=1)
    assert isinstance(ffnn._impl.machine, FFNN) and ffnn._impl.machine.n_hiddens == 5
    assert ffnn._impl.machine.dtype == torch.float32
    tr = sampler.RBM(floatType="float64", symmType="tr", device=CPU)
    tr.init(**_kwargs(6, 3, 16, "/nonexistent", 0), seedNumber=1)
    assert isinstance(tr._impl.machine, RBMTrSymm) and tr._impl.machine.alpha == 3
