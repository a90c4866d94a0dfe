"""The port's example studies (``neural_network_quantum_state_tpu_torch/
examples/``) on the CPU at small sizes: the precision anchor's training
against the port's ED, the Renyi study's exact-enumeration functions
against the JAX example's, the Binder-crossing analysis reading the port's
exact moments, and every study's run writing only into its ``--out``."""

import importlib.util
import json
import math
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu.models import RBMSfSymm as JRBMSfSymm
from neural_network_quantum_state_tpu.models import RBMTrSymm as JRBMTrSymm
from neural_network_quantum_state_tpu.ops.cplx import C
from neural_network_quantum_state_tpu.utils import exact as jexact
from neural_network_quantum_state_tpu_torch import examples
from neural_network_quantum_state_tpu_torch.examples import (
    precision_anchor,
    precision_n64_anchor,
    renyi_cat_study,
    renyi_inc_calibration,
    scale_n128_mesh,
    train_lich64,
)
from neural_network_quantum_state_tpu_torch.models import RBMSfSymm, RBMTrSymm, params_from_jax
from neural_network_quantum_state_tpu_torch.utils import exact
from neural_network_quantum_state_tpu_torch.utils.checkpoint import save_reference_text

REPO = Path(__file__).resolve().parents[1]
ANCHOR_SEED = 11  # the anchor's own seed, chosen before the run


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_renyi():
    """The JAX package's examples/renyi_cat_study.py (its functions only)."""
    return _load("jax_renyi_cat_study", REPO / "examples" / "renyi_cat_study.py")


@pytest.fixture(scope="module")
def bc():
    return _load("binder_crossing", REPO / "examples" / "binder_crossing.py")


@pytest.fixture(scope="module")
def logs_snapshot():
    """The recorded results under logs/: names, sizes and times, before the
    studies run; compared after each."""
    def snap():
        return {p.name: (p.stat().st_size, p.stat().st_mtime_ns) for p in (REPO / "logs").iterdir()}

    before = snap()
    yield lambda: snap() == before


def test_precision_anchor_trains_to_the_ports_ed(tmp_path, logs_snapshot):
    """The anchor's protocol cut to a CPU size (N = 8, K = 512, 200 warm-up
    sweeps, 800 steps at 2e-2 and 400 at 5e-3, the last 100 averaged) at
    the JAX e2e oracle's LITFI bar (tests/test_e2e.py, 1e-2)."""
    e0 = precision_anchor.run_ed(8, str(tmp_path))
    rec = precision_anchor.run_train(8, str(tmp_path), seed=ANCHOR_SEED, device="cpu", n_walkers=512, warm_sweeps=200,
                                     stages=((800, 2e-2), (400, 5e-3)), tail=100)
    assert rec["n_iter"] == 1200 and rec["device"] == "cpu"
    assert abs(rec["e_vmc"] - e0) / abs(e0) < 1e-2, (rec["e_vmc"], e0)
    rows = precision_anchor.report(str(tmp_path))
    assert rows == []  # the report covers the anchor's sizes (20 to 30) only
    assert logs_snapshot()


def test_precision_anchor_report_reads_the_jax_record(tmp_path, logs_snapshot):
    e0 = json.loads((REPO / "logs" / "precision_anchor_ed_N20.json").read_text())["e0"]
    for stage, rec in (("ed", {"n": 20, "e0": e0}), ("vmc", {"n": 20, "e_vmc": e0 * (1 + 3e-5)})):
        (tmp_path / f"precision_anchor_{stage}_N20.json").write_text(json.dumps(rec))
    (row,) = precision_anchor.report(str(tmp_path))
    assert row["rel_err"] == pytest.approx(3e-5) and row["pass_1e-4"]
    assert row["jax_rel_err"] == pytest.approx(1.3791844026333361e-05)
    assert json.loads((tmp_path / "precision_anchor_report.json").read_text())[0]["n"] == 20
    assert logs_snapshot()


@pytest.mark.parametrize("name", ["RBMTrSymm", "RBMSfSymm"])
def test_renyi_study_enumeration_matches_the_jax_example(jax_renyi, name):
    n, l = 8, 4
    jm = {"RBMTrSymm": JRBMTrSymm, "RBMSfSymm": JRBMSfSymm}[name](n_inputs=n, alpha=2, dtype=jnp.float64)
    tm = {"RBMTrSymm": RBMTrSymm, "RBMSfSymm": RBMSfSymm}[name](n_inputs=n, alpha=2, dtype=torch.float64)
    import jax

    jp = {k: C(3.0 * v.re, 3.0 * v.im) for k, v in jm.init_params(jax.random.PRNGKey(4)).items()}
    tp = params_from_jax(tm, {k: (np.asarray(v.re), np.asarray(v.im)) for k, v in jp.items()}, device="cpu")
    np.testing.assert_array_equal(renyi_cat_study.all_spins(n), jax_renyi.all_spins(n))
    psi, jpsi = renyi_cat_study.psi_of(tm, tp), np.asarray(jax_renyi.psi_of(jm, jp))
    np.testing.assert_allclose(psi, jpsi, rtol=0, atol=1e-10)
    assert renyi_cat_study.s2_exact(psi, n, l) == pytest.approx(jax_renyi.s2_exact(jpsi, n, l), abs=1e-10)
    np.testing.assert_allclose(renyi_cat_study.sector_weights(psi, n), jax_renyi.sector_weights(jpsi, n), rtol=0,
                               atol=1e-10)
    # and on the ED ground state, from the port's oracle and from JAX's
    h, j = -math.cos(1.57), math.sin(1.57)
    _, g = exact.ground_state(exact.litfi_chain_dense(n, h=h, j=j, alpha=2.5))
    _, jg = jexact.ground_state(jexact.litfi_chain_dense(n, h=h, j=j, alpha=2.5))
    assert renyi_cat_study.s2_exact(g, n, l) == pytest.approx(jax_renyi.s2_exact(jg, n, l), abs=1e-10)
    np.testing.assert_allclose(renyi_cat_study.sector_weights(g, n), jax_renyi.sector_weights(jg, n), rtol=0,
                               atol=1e-10)


def test_binder_crossing_reads_the_ports_exact_moments(bc, tmp_path):
    """examples/binder_crossing.py (no package) reads an ED grid JSON
    written from the port's litfi_binder_exact as it reads the JAX side's."""
    thetas = [0.8, 0.9, 1.0, 1.1]
    grid = {"thetas": thetas, "U": {str(n): [exact.litfi_binder_exact(n, t, 2.5)["U"] for t in thetas]
                                    for n in (6, 8)}}
    path = tmp_path / "binder_exact_port.json"
    path.write_text(json.dumps(grid))
    for n in ("6", "8"):
        d = bc.parse_input(n, str(path))
        assert sorted(d) == thetas
        for t, u in zip(thetas, grid["U"][n]):
            assert d[t]["U"] == pytest.approx(jexact.litfi_binder_exact(int(n), t, 2.5)["U"], abs=1e-9)
            assert d[t]["U"] == u and d[t]["err"] == 0.0
    zeros = [0.0] * len(thetas)
    got = bc.crossings(thetas, grid["U"]["6"], grid["U"]["8"], zeros, zeros)
    want = bc.crossings(thetas, [jexact.litfi_binder_exact(6, t, 2.5)["U"] for t in thetas],
                        [jexact.litfi_binder_exact(8, t, 2.5)["U"] for t in thetas], zeros, zeros)
    assert len(got) == len(want) >= 1
    for (t0, t1, tc, terr, status), (w0, w1, wc, werr, wstatus) in zip(got, want):
        assert (t0, t1, terr, status) == (w0, w1, werr, wstatus) and tc == pytest.approx(wc, abs=1e-9)


def test_n64_anchor_arms_run_from_a_checkpoint(tmp_path, logs_snapshot):
    """precision_n64_anchor's two arms and report at a CPU size, warm-started
    from a checkpoint of RBMTrSymm(8, alpha 4)."""
    machine = RBMTrSymm(n_inputs=8, alpha=4, dtype=torch.float64)
    from neural_network_quantum_state_tpu_torch.ops.rng import make_generator

    ckpt = str(tmp_path / "RBMTrSymmLICH-L8NF4A2.5T2V1")
    save_reference_text(machine, machine.init_params(make_generator(2, "cpu")), ckpt)
    for arm in ("f64", "mixed"):
        rec = precision_n64_anchor.run(arm, 6, 3, str(tmp_path), device="cpu", n_walkers=64, warm_sweeps=10, ckpt=ckpt,
                                       n=8)
        assert np.isfinite(rec["energy"]) and rec["niter"] == 6
    rep = precision_n64_anchor.report(str(tmp_path))
    assert rep["value"] == pytest.approx(abs(rep["mixed"] - rep["anchor_f64"]) / abs(rep["anchor_f64"]))
    assert sorted(p.name for p in tmp_path.glob("anchor_*.json")) == ["anchor_f64.json", "anchor_mixed.json",
                                                                     "anchor_report.json"]
    assert logs_snapshot()


def test_train_lich64_writes_its_checkpoint_into_out(tmp_path):
    res = train_lich64.train(2.0, 2.5, 6, str(tmp_path), device="cpu", n=8, n_walkers=64, warm_sweeps=10,
                             meas=(64, 4, 10))
    assert res["prefix"].startswith(str(tmp_path)) and os.path.exists(res["prefix"] + ".metrics.jsonl")
    assert all(np.isfinite(res[k]) for k in ("energy", "m1", "m2", "m4")) and 0 <= res["m2"] <= 1
    assert sorted(p.name for p in tmp_path.iterdir() if p.name.endswith(".metrics.jsonl")) == [
        "RBMTrSymmLICH-L8NF4A2.5T2V1.metrics.jsonl"]


def test_scale_mesh_runs_on_eight_cpu_shards():
    hist = scale_n128_mesh.run(device="cpu", n=16)
    assert len(hist) == 3 and all(np.isfinite(h["energy"]) for h in hist)


def test_renyi_studies_run_at_a_small_size(tmp_path, logs_snapshot):
    out = renyi_cat_study.main(["--device", "cpu", "--out", str(tmp_path), "-L=6", "-niter=8", "-ns=64", "-nmeas=3"])
    assert [r["state"] for r in out["table"]] == ["exact (ED)", "RBMTrSymm", "TrSymm-noPT", "RBMSfSymm"]
    assert out["table"][0]["s2"] == pytest.approx(renyi_cat_study.s2_exact(
        exact.ground_state(exact.litfi_chain_dense(6, h=-math.cos(1.57), j=math.sin(1.57), alpha=2.5))[1], 6, 3))
    cal = renyi_inc_calibration.main(["--device", "cpu", "--out", str(tmp_path), "-L=6", "-ntrain=8", "-niter=3",
                                      "-nwarm=3", "-ns=16", "-nseed=2"])
    assert len(cal["estimates"]) == 2 and np.isfinite(cal["mean"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["renyi_cat_study.json", "renyi_inc_calibration.json"]
    assert logs_snapshot()


def test_examples_write_only_into_their_out_directory():
    """The default --out is git-ignored and outside logs/ and examples/;
    no example's source opens a file under logs/ for writing."""
    out = Path(examples.DEFAULT_OUT)
    assert out.parent == REPO and out.name == "runs_torch"
    assert "runs_torch/" in (REPO / ".gitignore").read_text().split()
    sources = sorted((REPO / "neural_network_quantum_state_tpu_torch" / "examples").glob("*.py"))
    assert {p.stem for p in sources} >= {"precision_anchor", "precision_n64_anchor", "train_lich64", "scale_n128_mesh",
                                         "renyi_cat_study", "renyi_inc_calibration"}
    for p in sources:
        text = p.read_text()
        assert ".anchor_" not in text and "__file__" not in text or p.stem == "__init__", p
        for line in text.splitlines():
            assert not ('"logs"' in line and '"w"' in line), (p, line)
