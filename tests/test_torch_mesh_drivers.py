"""The walker mesh through the port's entry points on the CPU: the train and
measure drivers (``-mesh``, ``-gridmesh``, ``-resume`` on a mesh) and the
measurement samplers' ``mesh=``.

The JAX package's oracles (``tests/test_drivers.py:170,210,235,451``,
``tests/test_measurements.py:146,175,524,567``,
``tests/test_fermion_meas.py:64,124``) hold a mesh run to a one-device run
within statistical error, or to exact enumeration. Here a mesh run draws
the one-device run's random numbers, so where the JAX test compares two
runs the port's are held equal (float64: the walkers to the bit, the
values to 1e-10); where it compares with exact values the port keeps its
bar.
"""

import os

import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu_torch.drivers import measure, train
from neural_network_quantum_state_tpu_torch.measurements.fermion import density_profile
from neural_network_quantum_state_tpu_torch.measurements import (
    AmplitudeSampler,
    FermionAmplitudeSampler,
    opdm_pair,
    renyi2_entropy,
    renyi2_increment,
    spin_x_correlation,
    spontaneous_magnetization,
)
from neural_network_quantum_state_tpu_torch.models import RBM
from neural_network_quantum_state_tpu_torch.parallel import Sharded, make_mesh
from neural_network_quantum_state_tpu_torch.utils.checkpoint import load_npz

from test_torch_fermion_meas import L, N_DN, N_UP, _exact_opdm
from test_torch_fermion_meas import _machine as _fermion_machine
from test_torch_measurements import N, _all_spins, _machine, _psi_vector
from test_torch_renyi_increment import _exact_s2

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _train(argv, path):
    os.makedirs(path, exist_ok=True)
    return train.main(argv + [f"-path={path}"], device=CPU)


def _energies(res):
    return [h["energy"] for h in res["history"]]


CH = ["-model=CH", "-ansatz=rbmtrsymm", "-L=8", "-nf=2", "-ns=128", "-nwarm=40", "-lr=2e-2", "-dtype=float64",
      "-rsd=1e-12"]


# ------------------------------------------------------------------ train driver
def test_train_driver_on_mesh_matches_one_device(tmp_path):
    """test_drivers.py:210 (-mesh=8 with -solvedtype=float64; energies
    finite and descending there): the mesh run's steps equal the one-device
    run's to 1e-10, and its .state.npz holds the same gathered walkers."""
    argv = CH + ["-niter=40", "-solvedtype=float64"]
    one = _train(argv, tmp_path / "one")[0]
    res = _train(argv + ["-mesh=8"], tmp_path / "mesh")[0]
    np.testing.assert_allclose(_energies(res), _energies(one), rtol=0, atol=1e-10)
    assert _energies(res)[-1] < _energies(res)[0]
    m = res["machine"]
    _, step_m, _, spins_m = load_npz(res["prefix"] + ".state.npz", m, device=CPU)
    _, step_1, _, spins_1 = load_npz(one["prefix"] + ".state.npz", m, device=CPU)
    assert step_m == step_1 == 40 and torch.equal(spins_m, spins_1)


def test_train_grid_parallel_submeshes(tmp_path):
    """test_drivers.py:235: -gridmesh=4 trains two theta points at the same
    time on 4-shard submeshes, saving two distinct checkpoints; each equals
    its serial one-device run to 1e-10."""
    argv = ["-model=LICH", "-ansatz=rbmtrsymm", "-L=8", "-nf=2", "-ns=64", "-niter=12", "-nwarm=30", "-lr=2e-2",
            "-theta=0.5,1.2", "-alpha=2.5", "-dtype=float64", "-rsd=1e-9"]
    grid = _train(argv + ["-gridmesh=4"], tmp_path / "grid")
    serial = _train(argv, tmp_path / "serial")
    assert len(grid) == 2 and len({r["prefix"] for r in grid}) == 2
    for g, s in zip(grid, serial):
        assert os.path.basename(g["prefix"]) == os.path.basename(s["prefix"])
        assert os.path.exists(g["prefix"]) and np.isfinite(_energies(g)[-1])
        np.testing.assert_allclose(_energies(g), _energies(s), rtol=0, atol=1e-10)


def test_train_structured_resume_on_mesh(tmp_path):
    """test_drivers.py:451: -resume with -mesh=2 continues at the saved step
    (the parameters replicated, the walkers re-sharded), as a one-device
    resume of the same file does (1e-10); a mesh run's file resumes on one
    device too; a walker-count mismatch is rejected."""
    common = CH + ["-nrec=20"]
    res = _train(common + ["-niter=20"], tmp_path)
    prefix = os.path.basename(res[0]["prefix"])
    os.makedirs(tmp_path / "m")
    on_mesh = train.main(common + ["-niter=6", f"-resume={tmp_path}/{prefix}.state.npz", "-mesh=2",
                                   f"-path={tmp_path / 'm'}"], device=CPU)
    on_one = train.main(common + ["-niter=6", f"-resume={tmp_path}/{prefix}.state.npz",
                                  f"-path={tmp_path / 'm'}"], device=CPU)
    assert on_mesh[0]["history"][0]["step"] == 20
    np.testing.assert_allclose(_energies(on_mesh[0]), _energies(on_one[0]), rtol=0, atol=1e-10)
    back = train.main(common + ["-niter=2", f"-resume={tmp_path}/m/{prefix}.state.npz", f"-path={tmp_path / 'm'}"],
                      device=CPU)
    assert back[0]["history"][0]["step"] == 26
    bad = [a if not a.startswith("-ns=") else "-ns=256" for a in common]
    with pytest.raises(ValueError, match="walkers"):
        train.main(bad + ["-niter=2", f"-resume={prefix}", "-mesh=2", f"-path={tmp_path}"], device=CPU)


# ---------------------------------------------------------------- measure driver
def test_measure_driver_on_mesh_matches_single_device(tmp_path):
    """test_drivers.py:170 (|m1 - m1_mesh| < 0.05 there): -mesh=8 stag and
    renyi, with the same seed, give the one-device values to 1e-10."""
    res = _train(CH + ["-niter=20"], tmp_path)
    common = ["-ansatz=rbmtrsymm", "-L=8", "-nf=2", "-ns=256", f"-prefix={res[0]['prefix']}", "-niter=10",
              "-nms=2", "-nwarm=40", "-dtype=float64", "-seed=3"]
    for what in (["-what=stag"], ["-what=renyi", "-l=4"]):
        one = measure.main(common + what, device=CPU)
        got = measure.main(common + what + ["-mesh=8"], device=CPU)
        np.testing.assert_allclose(np.asarray(got, dtype=float), np.asarray(one, dtype=float), rtol=0, atol=1e-10)
        assert np.all(np.isfinite(np.asarray(got, dtype=float)))


# ------------------------------------------------------------ measurement samplers
def test_mesh_sharded_estimators_match_single_device():
    """test_measurements.py:146 (0.03 and 0.08 there): the magnetization and
    the two-replica Renyi swap estimator on an 8-shard mesh, the two
    replicas sharing one sharding, equal the one-device values (1e-10)."""
    m1, p1 = _machine(3)
    mesh = make_mesh(8, device=CPU)
    single = spontaneous_magnetization(AmplitudeSampler(m1, p1, n_walkers=512, key=31, device=CPU), 10, 2, 60)
    smp = AmplitudeSampler(m1, p1, n_walkers=512, key=31, mesh=mesh)
    assert isinstance(smp.state.lnpsi, Sharded) and smp.spins.shape == (512, N)
    sharded = spontaneous_magnetization(smp, 10, 2, 60)
    np.testing.assert_allclose(sharded, single, rtol=0, atol=1e-10)
    q = [AmplitudeSampler(m1, p1, n_walkers=512, key=k, device=CPU) for k in (33, 34)]
    r = [AmplitudeSampler(m1, p1, n_walkers=512, key=k, mesh=mesh) for k in (33, 34)]
    s2_single = renyi2_entropy(q[0], q[1], l=3, n_iterations=10, n_sweeps=2, n_warmup=60)
    s2_mesh = renyi2_entropy(r[0], r[1], l=3, n_iterations=10, n_sweeps=2, n_warmup=60)
    assert abs(s2_mesh - s2_single) < 1e-10


def test_mesh_plus_tempering_estimator():
    """test_measurements.py:175: tempered sampling on the sharded walker
    axis (each shard whole replica groups), the beta = 1 readout against
    exact enumeration within 0.03."""
    m1, p1 = _machine(7)
    p = np.abs(_psi_vector(m1, p1)) ** 2
    p /= p.sum()
    want_m1 = float((p * np.abs(_all_spins(N).mean(axis=1))).sum())
    smp = AmplitudeSampler(m1, p1, n_walkers=4096, key=41, n_beta=4, mesh=make_mesh(8, device=CPU))
    m1_got, _, _ = spontaneous_magnetization(smp, n_iterations=30, n_sweeps=2, n_warmup=150)
    assert abs(m1_got - want_m1) < 0.03, (m1_got, want_m1)


def test_renyi2_increment_mesh_matches_single_device():
    """test_measurements.py:524: the sharded levels x walkers batch gives the
    one-device chains (1e-6 there, 1e-10 here), and the tempered ladder on
    the mesh meets exact S2."""
    m1, p1 = _machine(2)
    kwargs = dict(n_iterations=10, n_sweeps=1, n_warmup=20, walkers_per_level=128, key=21)
    s2_one, err_one, lv_one = renyi2_increment(m1, p1, 4, device=CPU, **kwargs)
    s2_mesh, err_mesh, lv_mesh = renyi2_increment(m1, p1, 4, mesh=make_mesh(8, device=CPU), **kwargs)
    np.testing.assert_allclose([s2_mesh, err_mesh], [s2_one, err_one], rtol=0, atol=1e-10)
    np.testing.assert_allclose(lv_mesh, lv_one, rtol=0, atol=1e-10)
    s2_q, _, _ = renyi2_increment(m1, p1, 4, mesh=make_mesh(4, device=CPU), z2_quadrature=True, **kwargs)
    s2_q1, _, _ = renyi2_increment(m1, p1, 4, device=CPU, z2_quadrature=True, **kwargs)
    assert abs(s2_q - s2_q1) < 1e-10
    s2_pt, err_pt, _ = renyi2_increment(m1, p1, 4, mesh=make_mesh(8, device=CPU), n_beta=2,
                                        **dict(kwargs, n_iterations=25, n_warmup=40, walkers_per_level=256))
    s2_exact = _exact_s2(m1, p1, 4)
    assert abs(s2_pt - s2_exact) < max(6 * err_pt, 0.1), (s2_pt, s2_exact, err_pt)


def test_spin_x_correlation_production_shape_mesh():
    """test_measurements.py:567 (N = 128, H = 512, marked slow there) at the
    LITFI flagship's N = 64, H = 256 on an 8-shard mesh with 64 walkers
    (its N^2 two-site flips take about 35 s at N = 128 on one CPU
    worker): finite, bounded, of the right shapes."""
    n, h = 64, 256
    m = RBM(n_inputs=n, n_hiddens=h, dtype=torch.float32)
    from neural_network_quantum_state_tpu_torch.ops.rng import make_generator

    p = m.init_params(make_generator(0, CPU))
    smp = AmplitudeSampler(m, p, n_walkers=64, key=50, mesh=make_mesh(8, device=CPU))
    s, ss = spin_x_correlation(smp, n_iterations=2, n_sweeps=1, n_warmup=2)
    assert s.shape == (n,) and ss.shape == (n, n)
    assert np.all(np.isfinite(s)) and np.all(np.isfinite(ss))
    assert np.all(np.abs(s) <= 1.05) and np.all(np.abs(ss) <= 1.05)


def test_opdm_on_mesh_matches_single_device():
    """test_fermion_meas.py:64: the sharded OPDM estimate meets exact
    enumeration within 0.03, equals the one-device estimate on the same key
    (1e-10), and every shard keeps every walker in its sector."""
    machine, params = _fermion_machine(4)
    want = _exact_opdm(machine, params, 0, 1)
    smp = FermionAmplitudeSampler(machine, params, n_walkers=4096, n_up=N_UP, n_down=N_DN, key=7,
                                  mesh=make_mesh(8, device=CPU))
    got = opdm_pair(smp, 0, 1, n_iterations=25, n_sweeps=2, n_warmup=150)
    assert abs(got.real - want.real) < 0.03, (got, want)
    for part in smp.state.cache.spins:
        assert torch.equal(((1 + part[:, :L]) / 2).sum(1), torch.full((part.shape[0],), float(N_UP), dtype=part.dtype))
        assert torch.equal(((1 + part[:, L:]) / 2).sum(1), torch.full((part.shape[0],), float(N_DN), dtype=part.dtype))
    one = FermionAmplitudeSampler(machine, params, n_walkers=512, n_up=N_UP, n_down=N_DN, key=7, device=CPU)
    two = FermionAmplitudeSampler(machine, params, n_walkers=512, n_up=N_UP, n_down=N_DN, key=7,
                                  mesh=make_mesh(4, device=CPU))
    assert abs(opdm_pair(two, 0, 1, 5, 2, 20) - opdm_pair(one, 0, 1, 5, 2, 20)) < 1e-10


def test_fermion_sampler_fused_on_mesh_matches_single_device():
    """test_fermion_meas.py:124 (use_fused + mesh; 0.05 there): the density
    profile on a mesh equals the one-device fused sampler's on the same key
    (1e-10), sums to the particle number, and keeps every sector; tempered
    (n_beta = 2) as well."""
    l = 3
    machine = RBM(n_inputs=2 * l, n_hiddens=8, dtype=torch.float32)
    from neural_network_quantum_state_tpu_torch.ops.rng import make_generator

    params = machine.init_params(make_generator(3, CPU))
    for nb, fused in ((1, True), (2, False)):
        f1 = FermionAmplitudeSampler(machine, params, 256, 1, 1, key=5, use_fused=fused, n_beta=nb, device=CPU)
        f2 = FermionAmplitudeSampler(machine, params, 256, 1, 1, key=5, use_fused=fused, n_beta=nb,
                                     mesh=make_mesh(8, device=CPU))
        d1, d2 = density_profile(f1, 10, 2, 30), density_profile(f2, 10, 2, 30)
        assert abs(d2.sum() - 2.0) < 1e-5
        np.testing.assert_allclose(d2, d1, rtol=0, atol=1e-10)
        s = f2.spins.numpy()
        assert np.all(((1 + s[:, :l]) / 2).sum(1) == 1) and np.all(((1 + s[:, l:]) / 2).sum(1) == 1)
