"""The port's train driver on the CPU: the train cases of test_drivers.py.

``neural_network_quantum_state_tpu_torch.drivers.train.main(argv,
device="cpu")`` with the JAX driver's options: a train run (prefix, text
checkpoint and metrics written, energies descending), a theta grid, the
Hubbard chain with and without a trap, accumulated dense SR, periodic
auto-save and structured resume (the step count and the lambda schedule
continue), ``-nbeta=auto`` and ``-solvedtype``, ``-mesh`` and ``-gridmesh``
(held to the one-device and the serial run; more in
``tests/test_torch_mesh_drivers.py``), and ``-ckpt=orbax`` (auto-save and
resume of the ``.orbax`` directory, on one device and on a mesh). The JAX
driver runs twice in this module: a ``-niter=0`` warm start of both
drivers from the same text checkpoint writes the same file, byte for byte,
under the same name, and the port's driver resumes a JAX ``-ckpt=orbax``
run. The file names
of every model and ansatz are the JAX driver's.
"""

import json
import os

import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu.drivers import common as j_common
from neural_network_quantum_state_tpu.drivers import train as j_train
from neural_network_quantum_state_tpu_torch.drivers import common as t_common
from neural_network_quantum_state_tpu_torch.drivers import train
from neural_network_quantum_state_tpu_torch.models import RBMTrSymm
from neural_network_quantum_state_tpu_torch.utils.checkpoint import save_reference_text


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _main(argv):
    return train.main(argv, device="cpu")


def test_train_writes_checkpoints_and_descends(tmp_path):
    """test_drivers.py::test_train_then_measure_roundtrip, its train half."""
    res = _main(["-model=CH", "-ansatz=rbmtrsymm", "-L=8", "-nf=2", "-ns=128", "-niter=60", "-nwarm=60",
                 "-lr=2e-2", "-dtype=float64", f"-path={tmp_path}", "-rsd=1e-9"])
    assert len(res) == 1
    prefix = res[0]["prefix"]
    assert os.path.basename(prefix) == "RBMTrSymmCH-N8A2H-1V1"
    for suffix in ("", ".metrics.jsonl", ".state.npz"):
        assert os.path.exists(prefix + suffix)
    energies = [h["energy"] for h in res[0]["history"]]
    assert len(energies) == 60 and energies[-1] < energies[0]  # descending
    recs = [json.loads(line) for line in open(prefix + ".metrics.jsonl")]
    assert [r["step"] for r in recs] == list(range(60))
    assert set(recs[0]) == {"step", "t", "energy", "rsd", "cg_iters", "lam"}


def test_train_grid_sweep(tmp_path):
    res = _main(["-model=LICH", "-ansatz=rbmtrsymm", "-L=8", "-nf=2", "-ns=64", "-niter=10", "-nwarm=20",
                 "-theta=1.8,2.2", "-alpha=2", "-dtype=float64", f"-path={tmp_path}"])
    assert len(res) == 2
    prefixes = {r["prefix"] for r in res}
    assert len(prefixes) == 2  # theta encoded in names
    assert all("T1.8" in p or "T2.2" in p for p in prefixes)


@pytest.mark.parametrize(
    "extra, L, ns, files",
    [(["-nwarm=30", "-niter=15"], 3, 64, ("Dw.dat", "Da.dat", "Db.dat")),
     (["-nwarm=40", "-niter=15", "-trap=0.5", "-lr=1e-2", "-rsd=1e-9"], 4, 128, ("Dw.dat",))],
    ids=["smoke", "trap"],
)
def test_train_hubbard(extra, L, ns, files, tmp_path):
    """test_drivers.py::test_train_hubbard_smoke and ::test_train_hubbard_with_trap
    (its train half): the exchange sampler keeps every walker in its sector."""
    res = _main(["-model=hubbard", "-ansatz=rbm", f"-L={L}", "-nf=8", f"-ns={ns}", "-U=4", "-npar=1,1",
                 "-dtype=float64", f"-path={tmp_path}", *extra])
    prefix = res[0]["prefix"]
    assert os.path.basename(prefix) == f"RBMHB-L{L}U4V1"
    assert all(os.path.exists(prefix + f) for f in files)
    assert np.isfinite([h["energy"] for h in res[0]["history"]]).all()


def test_train_j2_na_flags_wired(tmp_path):
    """test_drivers.py::test_train_j2_na_flags_wired: -J2 reaches the
    checkerboard and -na=2 runs accumulated dense SR through the CLI."""
    args = train.DriverArgs(["-model=CB", "-h=-1.5", "-J=-1", "-J2=0.3", "-ansatz=ffnn", "-L=16", "-nf=32",
                             "-ns=64", "-niter=1"], train.OPTIONS, train.DEFAULTS, prog="t")
    ham = t_common.build_hamiltonian("cb", 16, **t_common.hamiltonian_kwargs("cb", 16, args))
    assert ham.j2 == 0.3 and ham.j1 == -1.0
    res = _main(["-model=CH", "-ansatz=rbm", "-L=6", "-nf=6", "-ns=64", "-niter=8", "-nwarm=30", "-na=2",
                 "-solver=lu", "-dtype=float64", f"-path={tmp_path}"])
    assert len(res) == 1 and np.isfinite(res[0]["history"][-1]["energy"])


def test_train_autosave_and_structured_resume(tmp_path):
    """test_drivers.py::test_train_autosave_and_structured_resume: -nrec
    auto-saves the structured state; -resume restores params, step,
    generator and walkers, so the step count and lambda continue."""
    common = ["-model=CH", "-ansatz=rbmtrsymm", "-L=8", "-nf=2", "-ns=128", "-nwarm=60", "-lr=2e-2",
              "-dtype=float64", f"-path={tmp_path}", "-rsd=1e-12", "-nrec=25"]
    res = _main(common + ["-niter=60"])
    prefix = res[0]["prefix"]
    assert os.path.exists(prefix + ".state.npz")  # auto-saved + final
    res2 = _main(common + ["-niter=40", f"-resume={os.path.basename(prefix)}"])
    hist2 = res2[0]["history"]
    assert hist2[0]["step"] == 60 and hist2[-1]["step"] == 99
    recs = [json.loads(line) for line in open(prefix + ".metrics.jsonl")]
    lam_by_step = {r["step"]: r["lam"] for r in recs}
    assert abs(lam_by_step[60] - 100.0 * 0.9**61) < 1e-3
    e1 = np.mean([h["energy"] for h in res[0]["history"][-10:]])
    e2 = np.mean([h["energy"] for h in hist2[-10:]])
    assert e2 <= e1 + 0.05


def test_train_orbax_autosave_and_resume(tmp_path):
    """test_drivers.py::test_train_orbax_autosave_and_resume: -ckpt=orbax
    auto-saves an .orbax directory in place of .state.npz, and -resume
    restores params, step, generator and walkers from it, so the step count
    and lambda continue."""
    common = ["-model=CH", "-ansatz=rbmtrsymm", "-L=8", "-nf=2", "-ns=128", "-nwarm=60", "-lr=2e-2",
              "-dtype=float64", f"-path={tmp_path}", "-rsd=1e-12", "-nrec=25", "-ckpt=orbax"]
    res = _main(common + ["-niter=60"])
    prefix = res[0]["prefix"]
    assert os.path.isdir(prefix + ".orbax") and not os.path.exists(prefix + ".state.npz")
    res2 = _main(common + ["-niter=40", f"-resume={os.path.basename(prefix)}"])
    hist2 = res2[0]["history"]
    assert hist2[0]["step"] == 60 and hist2[-1]["step"] == 99
    recs = [json.loads(line) for line in open(prefix + ".metrics.jsonl")]
    lam_by_step = {r["step"]: r["lam"] for r in recs}
    assert abs(lam_by_step[60] - 100.0 * 0.9**61) < 1e-3
    names = sorted(os.path.basename(prefix) + s for s in ("", ".metrics.jsonl", ".orbax"))
    assert sorted(os.listdir(tmp_path)) == names  # no .state.npz, no temporary directory left


def test_train_orbax_sharded_roundtrip_on_mesh(tmp_path):
    """test_drivers.py::test_train_orbax_sharded_roundtrip_on_mesh: a -mesh=4
    run saves the gathered walkers and a mesh-resumed run re-shards them."""
    common = ["-model=CH", "-ansatz=rbmtrsymm", "-L=8", "-nf=2", "-ns=128", "-nwarm=40", "-lr=2e-2",
              "-dtype=float64", f"-path={tmp_path}", "-rsd=1e-12", "-nrec=20", "-ckpt=orbax", "-mesh=4"]
    prefix = os.path.basename(_main(common + ["-niter=20"])[0]["prefix"])
    res2 = _main(common + ["-niter=10", f"-resume={prefix}"])
    assert res2[0]["history"][0]["step"] == 20
    assert np.isfinite(res2[0]["history"][-1]["energy"])


def test_port_resumes_a_jax_orbax_run(tmp_path):
    """The JAX driver's -ckpt=orbax run (OCDBT, zstd) resumed by the port's
    driver: the step count and lambda continue, the walkers are the saved
    ones and the generator is seeded from the JAX key."""
    common = ["-model=CH", "-ansatz=rbmtrsymm", "-L=8", "-nf=2", "-ns=64", "-nwarm=20", "-lr=2e-2",
              "-dtype=float64", f"-path={tmp_path}", "-rsd=1e-12", "-nrec=5", "-ckpt=orbax"]
    prefix = j_train.main(common + ["-niter=10"])[0]["prefix"]
    assert os.path.isdir(prefix + ".orbax")
    res = _main(common + ["-niter=5", f"-resume={prefix}.orbax"])
    hist = res[0]["history"]
    assert [h["step"] for h in hist] == list(range(10, 15))
    recs = [json.loads(line) for line in open(prefix + ".metrics.jsonl")]
    lam_by_step = {r["step"]: r["lam"] for r in recs}
    assert abs(lam_by_step[10] - 100.0 * 0.9**11) < 1e-3
    assert np.isfinite([h["energy"] for h in hist]).all()


def test_resume_refuses_another_walker_count(tmp_path):
    """A structured checkpoint resumes only with its own walker count."""
    common = ["-model=CH", "-ansatz=rbmtrsymm", "-L=8", "-nf=2", "-nwarm=5", "-dtype=float64", f"-path={tmp_path}"]
    prefix = _main(common + ["-ns=64", "-niter=2"])[0]["prefix"]
    with pytest.raises(ValueError, match="walkers"):
        _main(common + ["-ns=32", "-niter=2", f"-resume={prefix}.state.npz"])


@pytest.mark.parametrize(
    "argv",
    [["-model=CH", "-ansatz=rbmtrsymm", "-L=8", "-nf=2"],
     ["-model=hubbard", "-ansatz=rbm", "-L=4", "-nf=8", "-npar=1,1", "-trap=0.5"]],
    ids=["flip", "exchange"],
)
def test_nbeta_auto_and_solvedtype(argv, tmp_path, capsys):
    """-nbeta=auto tunes the ladder on the warmed walkers (the flip probe,
    or the sector-keeping exchange probe for the Hubbard chain) and prints
    the JAX driver's "# nbeta=auto" lines; -solvedtype=float64 reaches the
    solve; the run finishes with finite energies."""
    res = _main(argv + ["-ns=64", "-niter=4", "-nwarm=20", "-nbeta=auto", "-solvedtype=float64",
                        f"-path={tmp_path}"])
    out = capsys.readouterr().out
    chosen = [line for line in out.splitlines() if line.startswith("# nbeta=auto -> n_beta=")]
    assert len(chosen) == 1 and "# nbeta=auto probe n_beta=2: swap/pair" in out
    assert int(chosen[0].rsplit("=", 1)[1]) in (2, 4, 8, 16)
    assert np.isfinite([h["energy"] for h in res[0]["history"]]).all()


@pytest.mark.parametrize(
    "extra",
    [["-mesh=4"], ["-gridmesh=2", "-theta=1.8,2.2"]],
    ids=["mesh", "gridmesh"],
)
def test_unported_options_raise(extra, tmp_path):
    """-mesh and -gridmesh are ported: a -mesh=4 run takes the one-device
    run's steps, and -gridmesh=2 the serial grid's, each point to 1e-10 (in
    float64, with the same seed); a mesh whose shards the walkers do not
    divide is refused."""
    base = ["-model=LICH", "-ansatz=rbmtrsymm", "-L=8", "-nf=2", "-ns=64", "-niter=2", "-nwarm=2",
            "-dtype=float64"]
    plain = [a for a in extra if not a.startswith(("-mesh", "-gridmesh"))]
    for sub in ("one", "mesh"):
        (tmp_path / sub).mkdir()
    want = _main(base + [f"-path={tmp_path / 'one'}", *plain])
    got = _main(base + [f"-path={tmp_path / 'mesh'}", *extra])
    assert [os.path.basename(r["prefix"]) for r in got] == [os.path.basename(r["prefix"]) for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([h["energy"] for h in g["history"]], [h["energy"] for h in w["history"]],
                                   rtol=0, atol=1e-10)
    with pytest.raises(ValueError, match="multiple of"):
        _main([a if a != "-ns=64" else "-ns=66" for a in base] + [f"-path={tmp_path}", "-mesh=4"])


@pytest.mark.parametrize("model", ["CH", "LICH", "SQ", "TRI", "CB", "hubbard"])
def test_prefixes_are_the_jax_drivers(model):
    """The file names of every ansatz on every model, letter for letter."""
    kw = {"lich": dict(alpha=2.5, theta=2.0), "hubbard": dict(u=4.0)}.get(model.lower(), dict(h=-1.5))
    for ansatz in j_common._ANSATZ_LABEL:
        for n, nh, ver in ((64, 4, 1), (16, 32, 3)):
            want = j_common.checkpoint_prefix("/runs", model, ansatz, n, nh, ver, **kw)
            assert t_common.checkpoint_prefix("/runs", model, ansatz, n, nh, ver, **kw) == want
    assert t_common.remove_zeros(2.5) == j_common.remove_zeros(2.5) == "2.5"


def test_warm_start_text_is_the_jax_drivers(tmp_path):
    """-niter=0 warm starts of both drivers from the same text checkpoint
    write the same file under the same name, byte for byte."""
    m = RBMTrSymm(n_inputs=8, alpha=2, dtype=torch.float64)
    g = torch.Generator().manual_seed(4)
    params = {k: v * 3.0 for k, v in m.init_params(g).items()}
    save_reference_text(m, params, str(tmp_path / "start"))
    argv = ["-model=LICH", "-ansatz=rbmtrsymm", "-L=8", "-nf=2", "-ns=32", "-niter=0", "-nwarm=1",
            "-theta=2", "-alpha=2.5", "-dtype=float64", "-ifprefix=start"]
    out = {}
    for label, mod, kw in (("jax", j_train, {}), ("port", train, {"device": "cpu"})):
        (tmp_path / label).mkdir()
        os.symlink(tmp_path / "start", tmp_path / label / "start")
        res = mod.main(argv + [f"-path={tmp_path / label}"], **kw)
        out[label] = (os.path.basename(res[0]["prefix"]), open(res[0]["prefix"], "rb").read())
    assert out["port"][0] == out["jax"][0] == "RBMTrSymmLICH-L8NF2A2.5T2V1"
    assert out["port"][1] == out["jax"][1] == open(tmp_path / "start", "rb").read()
