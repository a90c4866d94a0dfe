"""The port's walker mesh (``parallel/mesh.py``) on the CPU.

A sharded sampler reproduces the unsharded one decision for decision: on
the CPU every sampler call draws its uniform blocks for all walkers and each
shard takes its columns; on the card each shard launches on the call's one
Philox key at its first global walker row, which the plain versions check
here through ``philox_uniforms(row0=)``. So the shards' spins equal one
device's to the bit, ln psi to 1e-12, and a sharded VMC's energies equal the
one-device run's to 1e-10 in float64 (only the order of the SR sums
differs), on the 1D, 2D and TP meshes. The JAX package's mesh oracles:
``tests/test_e2e.py:66`` (a mesh run converges to exact diagonalization)
here at its bar, and JAX's own sharded SR solve and local energy on its 8
virtual CPU devices (XLA paths: float64, no Pallas kernel) against the
port's shards on the same inputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_network_quantum_state_tpu as jnqs
from neural_network_quantum_state_tpu.hamiltonians import LITFIChain as JLITFIChain
from neural_network_quantum_state_tpu.models import RBMTrSymm as JRBMTrSymm
from neural_network_quantum_state_tpu.ops import engine as jengine
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu.optim import sr as jsr
from neural_network_quantum_state_tpu.utils.exact import ground_energy, tfi_chain_dense
from neural_network_quantum_state_tpu_torch import VMC, VMCConfig
from neural_network_quantum_state_tpu_torch.hamiltonians import HubbardChain, LITFIChain, TFIChain
from neural_network_quantum_state_tpu_torch.models import RBM, RBMTrSymm, params_from_jax
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops.rng import (
    ACCEPT_STREAM,
    FLIP_STREAM,
    SELECT_STREAM,
    SWAP_STREAM,
    ExchangeDraws,
    PhiloxDraws,
    make_generator,
    philox_uniforms,
    random_spins,
)
from neural_network_quantum_state_tpu_torch.ops.sweep import replica_betas
from neural_network_quantum_state_tpu_torch.optim import sr
from neural_network_quantum_state_tpu_torch.parallel import (
    PARAM_AXIS,
    SLICE_AXIS,
    WALKER_AXIS,
    Sharded,
    gather,
    make_mesh,
    make_mesh_2d,
    make_mesh_tp,
    make_submeshes,
    n_devices,
    o_mat_spec,
    replicate_tree,
    shard_map,
    shard_walker_tree,
    walker_axes,
)
from neural_network_quantum_state_tpu_torch.parallel import mesh as meshlib
from neural_network_quantum_state_tpu_torch.sampler import kawasaki, metropolis, tempering

CPU = "cpu"
MESHES = {
    "1d8": lambda: make_mesh(8, device=CPU),
    "2d": lambda: make_mesh_2d(2, 4, device=CPU),
    "tp": lambda: make_mesh_tp(2, 4, device=CPU),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(c):
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def _c(x):
    return C(jnp.asarray(np.real(x)), jnp.asarray(np.imag(x)))


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------- the mesh
def test_mesh_layouts():
    """make_mesh places its shards round-robin over the visible devices of
    one type (the CPU has one), or takes a device list; the 2D and TP meshes
    shape the same list; every axis carries walkers, and o_mat_spec gives
    JAX's layout of the log-derivative matrix (column blocks over a TP
    mesh's params axis)."""
    m = make_mesh(8, device=CPU)
    assert m.devices == (torch.device("cpu"),) * 8 and m.shape == (8,) and n_devices(m) == 8
    assert walker_axes(m) == (WALKER_AXIS,) and o_mat_spec(m) == ((WALKER_AXIS,),)
    m2 = make_mesh_2d(2, 4, device=CPU)
    assert m2.shape == (2, 4) and walker_axes(m2) == (SLICE_AXIS, WALKER_AXIS)
    assert o_mat_spec(m2) == ((SLICE_AXIS, WALKER_AXIS),)
    tp = make_mesh_tp(2, 4, device=CPU)
    assert tp.shape == (2, 4) and o_mat_spec(tp) == ((WALKER_AXIS,), PARAM_AXIS)
    assert make_mesh(["cpu", "cpu"]).size == 2 and n_devices(None) == 1
    subs = make_submeshes(3, 2, device=CPU)
    assert [s.size for s in subs] == [2, 2, 2]
    with pytest.raises(ValueError):
        meshlib.Mesh((torch.device("cpu"),) * 3, (2, 2), ("a", "b"))


def test_shard_gather_and_replicate_guard():
    """shard_walker_tree splits the leaves with K rows into contiguous
    shards and leaves the rest; gather joins them in walker order;
    replicate_tree never splits, also an (N, H) weight with N == K (the
    JAX package's guard, mesh.py:128-137)."""
    mesh = make_mesh(4, device=CPU)
    k = 8
    spins = torch.arange(k * 3, dtype=torch.float64).reshape(k, 3)
    weight = torch.ones(k, 5, dtype=torch.complex128)  # N == K
    tree = {"spins": spins, "count": torch.zeros(()), "other": torch.ones(3)}
    out = shard_walker_tree(tree, mesh, k)
    assert isinstance(out["spins"], Sharded) and len(out["spins"]) == 4
    assert all(p.is_contiguous() and p.shape == (2, 3) for p in out["spins"])
    assert out["spins"].shape == (8, 3) and out["spins"].offsets() == [0, 2, 4, 6]
    assert out["count"] is tree["count"] and out["other"] is tree["other"]
    assert torch.equal(gather(out["spins"]), spins)
    rep = replicate_tree({"w": weight}, mesh)
    assert isinstance(rep["w"], torch.Tensor) and rep["w"].shape == (k, 5)
    with pytest.raises(ValueError, match="split"):
        shard_walker_tree(spins, make_mesh(3, device=CPU), k)
    # shard_map: one call per shard, the others' tensors shared
    doubled = shard_map(lambda s, w: s * w[0, 0].real, out["spins"], weight)
    assert torch.equal(gather(doubled), spins)


def test_replica_copies_a_tensor_once_per_device():
    """shard_map's copy of a replicated tensor on another device (here the
    meta device, as a second card would be): the tensor itself on its own
    device, one copy per tensor and device while the tensor lives, a new
    copy after an in-place change, and the entry dropped with the tensor."""
    meta = torch.device("meta")
    x = torch.ones(4, 3, dtype=torch.complex128)
    assert meshlib.replica(x, x.device) is x
    first = meshlib.replica(x, meta)
    assert first.device == meta and first.shape == x.shape
    assert meshlib.replica(x, meta) is first
    mesh = make_mesh([CPU, "meta"])
    seen = []
    shard_map(lambda s, w: seen.append(w), Sharded([torch.zeros(1), torch.zeros(1, device=meta)], mesh), x)
    assert seen[0] is x and seen[1] is first
    x.add_(1.0)
    assert meshlib.replica(x, meta) is not first
    key = id(x)
    del x, seen[:]
    assert key not in meshlib._replicas


@pytest.mark.parametrize("stream", [FLIP_STREAM, SWAP_STREAM, SELECT_STREAM, ACCEPT_STREAM])
def test_philox_row0_takes_the_columns_of_the_unsharded_block(stream):
    """philox_uniforms(row0=r) on k walkers are columns r .. r + k of the
    block of all walkers, bit for bit, and the draws' row0 reaches them."""
    key = torch.tensor([0x12345678, 0x9ABCDEF0], dtype=torch.int64)
    full = philox_uniforms(key, stream, (37, 64))
    for r, k in ((0, 16), (16, 16), (32, 32), (63, 1)):
        assert torch.equal(philox_uniforms(key, stream, (37, k), row0=r), full[:, r:r + k])
    d = PhiloxDraws(key, 37, row0=32)
    assert torch.equal(d.flips(32), philox_uniforms(key, FLIP_STREAM, (37, 64))[:, 32:])
    e = ExchangeDraws(key, 37, row0=16)
    assert torch.equal(e.selection(16), philox_uniforms(key, SELECT_STREAM, (37, 64))[:, 16:32])
    assert torch.equal(e.swaps(3, 16), PhiloxDraws(key, 0).swaps(3, 64)[..., 16:32])


# ------------------------------------------------------ samplers, shard by shard
K, N, H = 64, 8, 12


def _flip_case(nb, seed=0):
    machine = RBM(n_inputs=N, n_hiddens=H, dtype=torch.float64)
    g = make_generator(seed, CPU)
    params = {k: 3.0 * v for k, v in machine.init_params(g).items()}
    work = machine.make_work(params)
    state = metropolis.init_state(work, random_spins(g, K, N, torch.float64), g)
    return work, state, torch.as_tensor(TFIChain(n_sites=N).schedule(), dtype=torch.int32)


def _exchange_case(seed=0):
    machine = RBM(n_inputs=N, n_hiddens=H, dtype=torch.float64)
    g = make_generator(seed, CPU)
    params = {k: 3.0 * v for k, v in machine.init_params(g).items()}
    work = machine.make_work(params)
    ham = HubbardChain(n_sites=N, n_up=2, n_down=1)
    state = metropolis.init_state(work, ham.init_spins(g, K, torch.float64), g)
    return work, state, torch.as_tensor(ham.bonds, dtype=torch.int32), ham.n_unit_steps


def _fresh(state, seed):
    """The state with a freshly seeded generator (one per run)."""
    return state._replace(generator=make_generator(seed, CPU))


SAMPLERS = {
    "flip": lambda work, st, case: metropolis.sweeps(work, st, case, 3),
    "tempered": lambda work, st, case: tempering.tempering_sweeps(work, st, case, 3, 4),
    "block_flip": lambda work, st, case: metropolis.block_flip_moves(
        work, metropolis.sweeps(work, st, case, 1), n_moves=3,
        beta=replica_betas(4, K // 4, torch.float64)),
    "exchange": lambda work, st, case: kawasaki.exchange_sweeps(work, st, case[0], 3, case[1]),
    "tempered_exchange": lambda work, st, case: kawasaki.tempered_exchange_sweeps(work, st, case[0], 3, case[1], 4),
}


@pytest.mark.parametrize("layout", sorted(MESHES))
@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_sharded_sampler_makes_the_unsharded_decisions(sampler, layout):
    """Every sampler on every mesh layout: the sharded call's spins equal
    the one-device call's to the bit, ln psi and y to 1e-12, and the
    acceptance counters (summed over the shards) are equal."""
    if "exchange" in sampler:
        work, state, bonds, n_unit = _exchange_case()
        case = (bonds, n_unit)
    else:
        work, state, case = _flip_case(4)
    one = SAMPLERS[sampler](work, _fresh(state, 5), case)
    mesh = MESHES[layout]()
    sharded = shard_walker_tree(_fresh(state, 5), mesh, K)
    got = SAMPLERS[sampler](work, sharded, case)
    assert isinstance(got.lnpsi, Sharded) and len(got.lnpsi) == 8
    assert torch.equal(gather(got.cache.spins), one.cache.spins)
    np.testing.assert_allclose(gather(got.lnpsi).numpy(), one.lnpsi.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(gather(got.cache.y).numpy(), one.cache.y.numpy(), rtol=0, atol=1e-12)
    assert float(got.n_accepted) == float(one.n_accepted) and float(got.n_proposed) == float(one.n_proposed)
    if "exchange" in sampler:  # every walker keeps its sector, shard by shard
        for p in got.cache.spins:
            assert torch.equal((p[:, :N // 2] > 0).sum(1), torch.full((p.shape[0],), 2))


@pytest.mark.parametrize("nb", [1, 4])
@pytest.mark.parametrize("kind", ["sweep", "exchange"])
def test_philox_mode_per_shard_takes_the_kernel_stream(kind, nb):
    """The card's mode on the plain versions: one sampler call's Philox key,
    each shard at its first global walker row (split_draws), makes the
    decisions of the unsharded call on that key."""
    mesh = make_mesh(4, device=CPU)
    key = torch.tensor([7, 11], dtype=torch.int64)
    if kind == "sweep":
        work, state, sched = _flip_case(nb)
        draws = PhiloxDraws(key, 2 * N)
        run = lambda st, d: shard_map(  # noqa: E731
            lambda w, c, ln, dd: metropolis.metropolis_sweeps(w, c, ln, sched, dd, nb, rows=True),
            work, st.cache, st.lnpsi, d)
    else:
        work, state, bonds, n_unit = _exchange_case()
        draws = ExchangeDraws(key, 2 * n_unit)
        run = lambda st, d: shard_map(  # noqa: E731
            lambda w, c, ln, dd: kawasaki.exchange_steps(w, c, ln, bonds, dd, None, nb, n_unit),
            work, st.cache, st.lnpsi, d)
    c1, ln1, rows1 = run(state, draws)
    sharded = shard_walker_tree(state, mesh, K)
    c2, ln2, rows2 = run(sharded, meshlib.split_draws(draws, sharded.lnpsi))
    assert torch.equal(gather(c2.spins), c1.spins)
    np.testing.assert_allclose(gather(ln2).numpy(), ln1.numpy(), rtol=0, atol=1e-12)
    assert torch.equal(gather(rows2, dim=1), rows1)


def test_tuner_on_a_sharded_state():
    """tune_n_beta on a sharded state chooses as on one device (shards of
    whole replica groups: n_devices skips the ladders that would split
    one), with the same diagnostics."""
    work, state, sched = _flip_case(1)
    nb1, d1 = tempering.tune_n_beta(work, _fresh(state, 3), sched, candidates=(2, 4, 16), warm_sweeps=2,
                                    probe_sweeps=2, n_devices=8)
    mesh = make_mesh(8, device=CPU)
    nb2, d2 = tempering.tune_n_beta(work, shard_walker_tree(_fresh(state, 3), mesh, K), sched,
                                    candidates=(2, 4, 16), warm_sweeps=2, probe_sweeps=2, n_devices=8)
    assert nb1 == nb2 and sorted(d1) == sorted(d2) and 16 not in d1
    for nb in d1:
        np.testing.assert_allclose(d2[nb]["swap"], d1[nb]["swap"], rtol=0, atol=1e-15)
        np.testing.assert_allclose(d2[nb]["flip"], d1[nb]["flip"], rtol=0, atol=1e-15)


def test_sharded_tempered_odd_ladder_large_shards():
    """test_fused_sharded.py:199's shape, on the port: n_beta = 3 with 1152
    walkers a shard (more than 1024, not a multiple of it) on 8 shards, one
    sweep; every spin +-1, ln psi finite, flips accepted, and the shards
    equal one device."""
    n = 8
    machine = RBMTrSymm(n_inputs=n, alpha=1, dtype=torch.float64)
    g = make_generator(0, CPU)
    params = machine.init_params(g)
    ham = TFIChain(n_sites=n, h=-1.0, j=-1.0)
    k = 8 * 1152
    work = machine.make_work(params)
    state = metropolis.init_state(work, ham.init_spins(g, k, torch.float64), g)
    sched = torch.as_tensor(ham.schedule(), dtype=torch.int32)
    one = tempering.tempering_sweeps(work, _fresh(state, 2), sched, 1, 3)
    got = tempering.tempering_sweeps(work, shard_walker_tree(_fresh(state, 2), make_mesh(8, device=CPU), k), sched, 1, 3)
    spins = gather(got.cache.spins)
    assert bool((spins.abs() == 1.0).all()) and bool(torch.isfinite(gather(got.lnpsi).real).all())
    assert float(got.n_accepted) > 0 and torch.equal(spins, one.cache.spins)


# --------------------------------------------------------------- SR over shards
def _o_and_e(rng, k=256, v=30):
    o = rng.normal(size=(k, v)) + 1j * rng.normal(size=(k, v)) + (0.3 + 0.2j)
    e = -1.0 + 0.3 * rng.normal(size=k) + 0.05j * rng.normal(size=k)
    return o, e


@pytest.mark.parametrize("layout", sorted(MESHES))
def test_sr_sums_over_shards_match_one_device(layout, rng):
    """<E>, rsd, F, aO, diag S, the CG matvec, the dense S and every solver
    of the sharded O equal one device's."""
    o, e = _o_and_e(rng)
    mesh = MESHES[layout]()
    os_, es = shard_walker_tree((_t(o), _t(e)), mesh, o.shape[0])
    for a, b in zip(sr.energy_and_rsd(_t(e)), sr.energy_and_rsd(es)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-13, atol=0)
    f, a_o = sr.force_vector(_t(o), _t(e))
    f2, a2 = sr.force_vector(os_, es)
    np.testing.assert_allclose(f2.numpy(), f.numpy(), rtol=0, atol=1e-13)
    np.testing.assert_allclose(a2.numpy(), a_o.numpy(), rtol=0, atol=1e-13)
    d, d2 = sr.sr_diag(_t(o), a_o), sr.sr_diag(os_, a2)
    np.testing.assert_allclose(d2.numpy(), d.numpy(), rtol=0, atol=1e-13)
    x = torch.as_tensor(rng.normal(size=o.shape[1]) + 1j * rng.normal(size=o.shape[1]))
    np.testing.assert_allclose(sr._s_matvec(os_, a2, d2, 0.5)(x).numpy(), sr._s_matvec(_t(o), a_o, d, 0.5)(x).numpy(),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(sr.build_s_matrix(os_, a2).numpy(), sr.build_s_matrix(_t(o), a_o).numpy(),
                               rtol=0, atol=1e-13)
    for solve in (lambda oo, ee: sr.sr_cg_solve(oo, ee, 1e-2, tol=1e-10)[0],
                  lambda oo, ee: sr.sr_minsr_solve(oo, ee, 1e-2)[0],
                  lambda oo, ee: sr.sr_dense_solve(oo, ee, 1e-2, torch.linalg.solve),
                  lambda oo, ee: sr.sr_dense_solve_accumulated([(oo, ee), (oo, ee)], 1e-2, torch.linalg.solve),
                  lambda oo, ee: sr.sgd_diag_solve(oo, ee, 1e-2)):
        np.testing.assert_allclose(solve(os_, es).numpy(), solve(_t(o), _t(e)).numpy(), rtol=0, atol=1e-10)


def test_sharded_cg_solve_matches_jax_on_its_mesh(rng):
    """JAX's own walker-sharded SR CG solve (O and E placed over its 8
    virtual CPU devices with the JAX package's shard_walker_tree) against
    the port's 8 shards, on the same inputs: dx to 1e-8, as the unsharded
    comparison of tests/test_torch_sr.py."""
    o, e = _o_and_e(rng, k=256)
    jmesh = jnqs.parallel.make_mesh()
    jo, je = jnqs.parallel.shard_walker_tree((_c(o), _c(e)), jmesh, o.shape[0])
    jx, jres = jsr.sr_cg_solve(jo, je, jnp.asarray(1.0), tol=1e-5, max_iters=30)
    os_, es = shard_walker_tree((_t(o), _t(e)), make_mesh(8, device=CPU), o.shape[0])
    x, res = sr.sr_cg_solve(os_, es, 1.0, tol=1e-5, max_iters=30)
    assert res.iterations == int(jres.iterations)
    np.testing.assert_allclose(x.numpy(), _np(jx), rtol=1e-8, atol=1e-8)


def test_local_energy_sharded_matches_jax_on_its_mesh():
    """Hamiltonian.local_energy_sharded: JAX's (shard_map over its 8
    devices; float64, so its XLA path) and the port's (one call per shard)
    on the same spins and parameters agree to 1e-10, and the port's
    shards equal its one-device local energy."""
    n, k = 12, 64
    jm = JRBMTrSymm(n_inputs=n, alpha=2, dtype=jnp.float64)
    jp = jax.tree_util.tree_map(lambda x: 3.0 * x, jm.init_params(jax.random.PRNGKey(3)))
    spins = np.where(np.random.default_rng(4).random((k, n)) < 0.5, 1.0, -1.0)
    jham = JLITFIChain(n_sites=n, h=-0.5, j=0.866, alpha=2.5, pbc=True)
    jwork = jm.make_work(jp)
    jcache, jln = jengine.full_forward(jwork, jnp.asarray(spins))
    jmesh = jnqs.parallel.make_mesh()
    jc, jl = jnqs.parallel.shard_walker_tree((jcache, jln), jmesh, k)
    want = _np(jham.local_energy_sharded(jnqs.parallel.replicate_tree(jwork, jmesh), jc, jl, jmesh))
    tm = RBMTrSymm(n_inputs=n, alpha=2, dtype=torch.float64)
    work = tm.make_work(params_from_jax(tm, {kk: (np.asarray(v.re), np.asarray(v.im)) for kk, v in jp.items()},
                                        device=CPU))
    ham = LITFIChain(n_sites=n, h=-0.5, j=0.866, alpha=2.5, pbc=True)
    cache, ln = engine.full_forward(work, torch.as_tensor(spins))
    c_sh, l_sh = shard_walker_tree((cache, ln), make_mesh(8, device=CPU), k)
    got = ham.local_energy_sharded(work, c_sh, l_sh)
    assert isinstance(got, Sharded)
    np.testing.assert_allclose(gather(got).numpy(), want, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(gather(got).numpy(), ham.local_energy(work, cache, ln).numpy(), rtol=0, atol=1e-13)


# ------------------------------------------------------------------ VMC on a mesh
def _train(mesh, steps=20, solver="cg", hubbard=False, n_beta=1, **cfg):
    if hubbard:
        machine = RBM(n_inputs=8, n_hiddens=8, dtype=torch.float64)
        ham = HubbardChain(n_sites=8, u=4.0, t=1.0, n_up=2, n_down=2)
    else:
        machine = RBM(n_inputs=6, n_hiddens=12, dtype=torch.float64)
        ham = TFIChain(n_sites=6, h=-1.0, j=-1.0)
    config = VMCConfig(n_walkers=256, learning_rate=1e-2, solver=solver, n_beta=n_beta, seed=4, **cfg)
    vmc = VMC(machine, ham, config, mesh=mesh, device=CPU)
    params, state = vmc.init()
    state = vmc.warm_up(params, state, 20)
    params, state, hist, _ = vmc.run(params, state, steps)
    return [h["energy"] for h in hist], gather(state.cache.spins)


@pytest.mark.parametrize(
    "case",
    [dict(solver="cg"), dict(solver="lu"), dict(solver="minsr"), dict(hubbard=True), dict(n_beta=2)],
    ids=["cg", "lu", "minsr", "hubbard", "n_beta2"],
)
def test_vmc_on_a_mesh_matches_one_device(case):
    """VMC(mesh=make_mesh(8)) against VMC() with the same seed over 20 SR
    steps: the walkers equal to the bit, the energies to 1e-10."""
    e1, s1 = _train(None, **case)
    e8, s8 = _train(make_mesh(8, device=CPU), **case)
    np.testing.assert_allclose(e8, e1, rtol=0, atol=1e-10)
    assert torch.equal(s8, s1)


def test_2d_and_tp_meshes_match_the_1d_mesh():
    """test_fused_sharded.py:247 and :276 (rtol 1e-4 there): the 2D
    multi-slice mesh and the TP mesh, whose walkers shard over all their
    devices, take the 1D mesh's steps to 1e-10."""
    e1, s1 = _train(make_mesh(8, device=CPU), steps=15)
    for mesh in (make_mesh_2d(2, 4, device=CPU), make_mesh_tp(2, 4, device=CPU)):
        e, s = _train(mesh, steps=15)
        np.testing.assert_allclose(e, e1, rtol=0, atol=1e-10)
        assert torch.equal(s, s1)


def test_sharded_run_converges_to_exact():
    """tests/test_e2e.py:66 on the port: RBM(6, 12) on the TFI chain, K=256,
    CG, over the 8-shard mesh, converges to exact diagonalization within
    5e-3."""
    n = 6
    machine = RBM(n_inputs=n, n_hiddens=12, dtype=torch.float64)
    ham = TFIChain(n_sites=n, h=-1.0, j=-1.0)
    vmc = VMC(machine, ham, VMCConfig(n_walkers=256, learning_rate=1e-2, solver="cg", seed=4),
              mesh=make_mesh(8, device=CPU), device=CPU)
    params, state = vmc.init()
    state = vmc.warm_up(params, state, 150)
    params, state, history, _ = vmc.run(params, state, 250)
    e = float(np.mean([h["energy"] for h in history[-20:]]))
    e_exact = ground_energy(tfi_chain_dense(n, h=-1.0, j=-1.0))
    assert abs(e - e_exact) / abs(e_exact) < 5e-3, (e, e_exact)


def test_vmc_mesh_refusals_and_collapse_escalation_keep_the_mesh():
    """The JAX package's checks (vmc.py:173-188): walkers a multiple of the
    mesh's devices times n_beta, and no "compensated" energy under a mesh.
    A collapsed run on a mesh escalates to tempering on the same mesh, and
    a reseed draws for all walkers: both as on one device."""
    machine = RBM(n_inputs=6, n_hiddens=12, dtype=torch.float64)
    ham = TFIChain(n_sites=6, h=-1.0, j=-1.0)
    mesh = make_mesh(8, device=CPU)
    with pytest.raises(ValueError, match="mesh devices"):
        VMC(machine, ham, VMCConfig(n_walkers=256, n_beta=64), mesh=mesh)
    with pytest.raises(ValueError, match="single-device anchor"):
        VMC(machine, ham, VMCConfig(n_walkers=256, energy_dtype="compensated"), mesh=mesh)
    # a collapse: rsd below the threshold for collapse_patience steps
    import neural_network_quantum_state_tpu_torch.vmc as vmc_mod

    def run(mesh_, escalate):
        # 1024 walkers: the tempered run's 256 beta = 1 rows still exceed V = 90
        cfg = VMCConfig(n_walkers=1024, learning_rate=1e-2, seed=4, collapse_patience=1, collapse_escalate_nbeta=escalate,
                        collapse_requil_sweeps=2)
        vmc = VMC(machine, ham, cfg, mesh=mesh_, device=CPU)
        params, state = vmc.init()
        state = vmc.warm_up(params, state, 20)  # the all-up start would leave S at roundoff
        old = vmc_mod._COLLAPSE_RSD
        vmc_mod._COLLAPSE_RSD = 10.0  # every step counts as collapsed
        try:
            params, state, hist, _ = vmc.run(params, state, 3)
        finally:
            vmc_mod._COLLAPSE_RSD = old
        assert vmc.n_remediations >= 1
        return [h["energy"] for h in hist], gather(state.cache.spins)

    for escalate in (4, 1):  # tempering, then a reseed
        e1, s1 = run(None, escalate)
        e8, s8 = run(mesh, escalate)
        np.testing.assert_allclose(e8, e1, rtol=0, atol=1e-10)
        assert torch.equal(s8, s1)


def test_vmc_mesh_solver_modes(rng):
    """The dense solve with n_accumulations rounds, the diag(S) EMA
    preconditioner, MINRES-QLP and the float64 energy mode of a float32
    machine on a mesh take the one-device steps."""
    for case in (dict(solver="lu", n_accumulations=2), dict(precond_ema=0.9), dict(solver="minresqlp"),
                 dict(solver="auto", cg_max_iters=2)):
        e1, s1 = _train(None, steps=4, **case)
        e8, s8 = _train(make_mesh(8, device=CPU), steps=4, **case)
        np.testing.assert_allclose(e8, e1, rtol=0, atol=1e-10)
        assert torch.equal(s8, s1)
    machine = RBM(n_inputs=6, n_hiddens=12, dtype=torch.float32)
    ham = TFIChain(n_sites=6, h=-1.0, j=-1.0)
    out = []
    for mesh in (None, make_mesh(4, device=CPU)):
        cfg = VMCConfig(n_walkers=256, seed=4, energy_dtype=torch.float64)
        vmc = VMC(machine, ham, dataclasses.replace(cfg), mesh=mesh, device=CPU)
        params, state = vmc.init()
        params, state, hist, _ = vmc.run(params, vmc.warm_up(params, state, 5), 3)
        out.append([h["energy"] for h in hist])
    np.testing.assert_allclose(out[1], out[0], rtol=1e-6, atol=0)
