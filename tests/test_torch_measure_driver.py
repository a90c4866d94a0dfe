"""The port's measure driver on the CPU against the JAX package's.

``neural_network_quantum_state_tpu_torch.drivers.measure.main(argv,
device="cpu")`` runs every ``-what`` mode of the JAX driver on checkpoints
written by the port's ``save_reference_text`` (a spin chain of 8 sites, a
3x3 lattice for ``neel`` and the L = 4 Hubbard chain): its values lie
within error of exact enumeration over the 2^N basis, its printed lines
have the JAX driver's format (the JAX driver runs the same command at a
tiny size; the numbers differ, their formats may not), its output files
the JAX driver's shape and ``np.savetxt`` layout, and ``-mesh=2`` gives
the one-device run's values (``tests/test_torch_mesh_drivers.py`` holds
every mesh path).
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu.drivers import measure as j_measure
from neural_network_quantum_state_tpu_torch.drivers import measure
from neural_network_quantum_state_tpu_torch.drivers.common import build_hamiltonian, build_machine
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops.rng import make_generator
from neural_network_quantum_state_tpu_torch.utils.checkpoint import save_reference_text

N = 8


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _all_spins(n):
    idx = np.arange(2**n)
    return 1.0 - 2.0 * ((idx[:, None] >> np.arange(n)[None, :]) & 1)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Text checkpoints of seeded, scaled parameters (|psi|^2 far from
    uniform), written by the port, and each state's psi over the basis."""
    root = tmp_path_factory.mktemp("measure")
    out = {}
    for name, ansatz, n, nf, seed, scale in (("A", "rbmtrsymm", N, 2, 1, 3.0), ("B", "rbmtrsymm", N, 2, 2, 3.0),
                                             ("Q", "rbm", 9, 6, 3, 3.0), ("H", "rbm", N, 8, 4, 3.0)):
        machine = build_machine(ansatz, n, nf, torch.float64)
        params = {k: scale * v for k, v in machine.init_params(make_generator(seed, "cpu")).items()}
        save_reference_text(machine, params, str(root / name))
        ln = engine.log_psi(machine.make_work(params), torch.as_tensor(_all_spins(n)))
        out[name] = (str(root / name), np.exp(ln.numpy()), machine, params)
    return out


SPIN = ["-ansatz=rbmtrsymm", f"-L={N}", "-nf=2", "-dtype=float64"]
HUB = ["-ansatz=rbm", f"-L={N}", "-nf=8", "-npar=1,1", "-dtype=float64"]
TINY = ["-ns=16", "-niter=2", "-nms=1", "-nwarm=2"]

# mode: (base options, extra options, measure options for the port's run)
MODES = {
    "energy": (SPIN, ["-what=energy", "-model=LICH", "-theta=1.2", "-alpha=2.5"],
               ["-ns=1024", "-niter=20", "-nms=2", "-nwarm=100"]),
    "energy_hubbard": (HUB, ["-what=energy", "-model=hubbard", "-U=4", "-t=1", "-trap=0.5"],
                       ["-ns=1024", "-niter=20", "-nms=2", "-nwarm=100"]),
    "renyi": (SPIN, ["-what=renyi", "-l=4"], ["-ns=1024", "-niter=20", "-nms=2", "-nwarm=100"]),
    "renyi_inc": (SPIN, ["-what=renyi_inc", "-l=4", "-z2q=1"], ["-ns=128", "-niter=20", "-nms=1", "-nwarm=40"]),
    "renyi_inc_hybrid": (SPIN, ["-what=renyi_inc", "-l=3", "-l0=1", "-init=neel", "-nbeta=2"],
                         ["-ns=128", "-niter=20", "-nms=1", "-nwarm=40", "-mchunk=8"]),
    "fidelity": (SPIN, ["-what=fidelity", "-nbeta=2"], ["-ns=1024", "-niter=20", "-nms=2", "-nwarm=100"]),
    "overlap": (SPIN, ["-what=overlap"], ["-ns=1024", "-niter=20", "-nms=2", "-nwarm=100"]),
    "smag": (SPIN, ["-what=smag"], ["-ns=1024", "-niter=20", "-nms=2", "-nwarm=100"]),
    "stag": (SPIN, ["-what=stag", "-nbeta=auto"], ["-ns=1024", "-niter=20", "-nms=2", "-nwarm=100"]),
    "corrratio": (SPIN, ["-what=corrratio"], ["-ns=1024", "-niter=20", "-nms=2", "-nwarm=100"]),
    "neel": (["-ansatz=rbm", "-L=9", "-nf=6", "-dtype=float64"], ["-what=neel"],
             ["-ns=1024", "-niter=20", "-nms=2", "-nwarm=100"]),
    "zz": (SPIN, ["-what=zz"], ["-ns=1024", "-niter=20", "-nms=2", "-nwarm=100"]),
    "xx": (SPIN, ["-what=xx"], ["-ns=512", "-niter=10", "-nms=2", "-nwarm=100"]),
    "opdm": (HUB, ["-what=opdm", "-site=1"], ["-ns=1024", "-niter=20", "-nms=2", "-nwarm=100"]),
    "density": (HUB, ["-what=density", "-nbeta=2"], ["-ns=1024", "-niter=20", "-nms=2", "-nwarm=100"]),
}
FILES = {"zz": [".zz.dat"], "xx": [".x.dat", ".xx.dat"], "opdm": [".opdm1.dat"], "density": [".density.dat"]}
_NUMBER = re.compile(r"[-+]?(\d+)\.(\d+)(e[-+]\d+)?")


def _template(text: str) -> list[str]:
    """The printed lines with every number replaced by its format (digits
    after the point, an exponent), the banner lines kept whole."""
    return [_NUMBER.sub(lambda m: f"<.{len(m.group(2))}{'e' if m.group(3) else 'f'}>", line)
            for line in text.splitlines() if line.strip()]


def _prefixes(mode, ckpts):
    name = {"energy_hubbard": "H", "opdm": "H", "density": "H", "neel": "Q"}.get(mode, "A")
    extra = [f"-prefix2={ckpts['B'][0]}"] if mode in ("fidelity", "overlap") else []
    return name, [f"-prefix={ckpts[name][0]}"] + extra


def _exact_check(mode, got, ckpts):
    """The port's values against exact enumeration, at the JAX tests' bars."""
    name, _ = _prefixes(mode, ckpts)
    _, psi, machine, params = ckpts[name]
    n = machine.n_inputs
    s = _all_spins(n)
    p = np.abs(psi) ** 2
    p /= p.sum()
    if mode in ("smag", "stag", "neel"):
        if mode == "smag":
            coeff = np.ones(n)
        elif mode == "stag":
            coeff = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
        else:
            i, j = np.meshgrid(np.arange(3), np.arange(3), indexing="ij")
            coeff = ((-1.0) ** (i + j)).ravel()
        m = np.abs(s @ coeff) / n
        for g, k in zip(got, (1, 2, 4)):
            assert abs(g - (p * m**k).sum()) < 0.02, (mode, got)
    elif mode == "zz":
        np.testing.assert_allclose(got, (s[:, :, None] * s[:, None, :] * p[:, None, None]).sum(0), atol=0.04)
    elif mode == "xx":
        idx, norm2 = np.arange(2**n), np.sum(np.abs(psi) ** 2)
        want_s = [np.real(np.vdot(psi, psi[idx ^ (1 << i)])) / norm2 for i in range(n)]
        want_ss = np.array([[np.real(np.vdot(psi, psi[idx ^ (1 << i) ^ (1 << j)])) / norm2 if i != j else 1.0
                             for j in range(n)] for i in range(n)])
        np.testing.assert_allclose(got[0], want_s, atol=0.04)
        np.testing.assert_allclose(got[1], want_ss, atol=0.05)
    elif mode in ("renyi", "renyi_inc", "renyi_inc_hybrid"):
        l = 3 if mode == "renyi_inc_hybrid" else 4
        psi_n = psi / np.linalg.norm(psi)
        mat = psi_n.reshape(2 ** (n - l), 2**l)
        rho = mat.T @ mat.conj()
        want = -np.log(np.real(np.trace(rho @ rho)))
        if mode == "renyi":
            assert abs(got - want) < 0.08, (got, want)
        else:
            assert abs(got[0] - want) < max(5 * got[1], 0.05), (got, want)
    elif mode in ("fidelity", "overlap"):
        psi2 = ckpts["B"][1]
        if mode == "fidelity":
            want = abs(np.vdot(psi, psi2)) / (np.linalg.norm(psi) * np.linalg.norm(psi2))
            assert abs(got[0] - want) < 10 * got[1] + 0.03, (got, want)
        else:
            want = np.vdot(psi, psi2) / np.sum(np.abs(psi) ** 2)
            assert abs(got - want) < 0.05, (got, want)
    elif mode == "corrratio":
        ks = [np.pi, np.pi + 2 * np.pi / n]
        sk = [(p * np.abs(s @ np.exp(1j * k * np.arange(n))) ** 2).sum() / n for k in ks]
        assert abs(got[0] - sk[1] / sk[0]) < max(5 * got[1], 0.05), (got, sk)
    elif mode in ("energy", "energy_hubbard", "opdm", "density"):
        _exact_physics(mode, got, psi, machine, params, s)


def _exact_physics(mode, got, psi, machine, params, s):
    """Energies as <psi|H|psi> from the port's local energy summed over the
    basis (exact for the sampled distribution); fermion observables over
    the (1, 1) sector."""
    n = machine.n_inputs
    if mode == "energy":
        ham = build_hamiltonian("lich", n, j=np.sin(1.2), h=-np.cos(1.2), alpha=2.5, pbc=True)
        keep = np.ones(len(s), bool)
    else:
        l = n // 2
        keep = ((s[:, :l] > 0).sum(1) == 1) & ((s[:, l:] > 0).sum(1) == 1)
        v = tuple(np.tile(0.5 * (np.arange(l) - (l - 1) / 2.0) ** 2, 2))
        ham = build_hamiltonian("hubbard", n, u=4.0, t=1.0, n_up=1, n_down=1, v=v)
    p = np.where(keep, np.abs(psi) ** 2, 0.0)
    p /= p.sum()
    if mode in ("energy", "energy_hubbard"):
        work = machine.make_work(params)
        cache, ln = engine.full_forward(work, torch.as_tensor(s[keep]))
        e_loc = ham.local_energy(work, cache, ln).numpy()
        want = float(np.sum(p[keep] * e_loc.real))
        e, err = got
        assert abs(e.real - want) < 5 * err + 0.02, (e, err, want)
    elif mode == "density":
        want = (p[:, None] * (1 + s) / 2).sum(0)
        assert abs(got.sum() - 2.0) < 1e-9
        np.testing.assert_allclose(got, want, atol=0.05)
    else:  # opdm row of site 1: m = 0 is the double occupancy
        l = n // 2
        assert len(got) == l - 1
        assert abs(got[0].real - (p * 0.25 * (1 + s[:, 1]) * (1 + s[:, l + 1])).sum()) < 0.03


@pytest.mark.parametrize("mode", list(MODES))
def test_measure_mode_matches_jax_format_and_exact_values(mode, ckpts, capsys, tmp_path):
    base, what, sizes = MODES[mode]
    name, prefixes = _prefixes(mode, ckpts)
    prefix = ckpts[name][0]
    # the JAX driver at a tiny size: its printed format and output files
    j_measure.main(base + what + prefixes + TINY)
    jax_out = capsys.readouterr().out
    jax_files = {}
    for suffix in FILES.get(mode, []):
        jax_files[suffix] = np.loadtxt(prefix + suffix)
        shutil.copy(prefix + suffix, tmp_path / ("jax" + suffix))
        os.remove(prefix + suffix)
    # the port's driver, the same command at the same tiny size (format) ...
    measure.main(base + what + prefixes + TINY, device="cpu")
    assert _template(capsys.readouterr().out) == _template(jax_out)
    for suffix, want in jax_files.items():
        got = np.loadtxt(prefix + suffix)
        assert got.shape == want.shape
        with open(prefix + suffix) as f, open(tmp_path / ("jax" + suffix)) as g:
            assert _template(f.read()) == _template(g.read())  # np.savetxt's layout
    # ... and at a size for the values
    got = measure.main(base + what + prefixes + sizes, device="cpu")
    capsys.readouterr()
    _exact_check(mode, got, ckpts)


def test_measure_refuses_a_mesh_and_unknown_modes(ckpts):
    """-mesh=2 measures what one device does, decision for decision; a mesh
    whose shards the walkers do not divide is refused (the JAX package's
    error), as are unknown modes and -what=energy without a model."""
    one = measure.main(SPIN + ["-what=smag", f"-prefix={ckpts['A'][0]}"] + TINY, device="cpu")
    two = measure.main(SPIN + ["-what=smag", f"-prefix={ckpts['A'][0]}", "-mesh=2"] + TINY, device="cpu")
    np.testing.assert_allclose(two, one, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="whole replica groups"):
        measure.main(SPIN + ["-what=smag", f"-prefix={ckpts['A'][0]}", "-mesh=3"] + TINY, device="cpu")
    with pytest.raises(ValueError, match="unknown measurement"):
        measure.main(SPIN + ["-what=nothing", f"-prefix={ckpts['A'][0]}"] + TINY, device="cpu")
    with pytest.raises(ValueError, match="requires -model"):
        measure.main(SPIN + ["-what=energy", f"-prefix={ckpts['A'][0]}"] + TINY, device="cpu")
    assert measure.OPTIONS == j_measure.OPTIONS and measure.DEFAULTS == j_measure.DEFAULTS
