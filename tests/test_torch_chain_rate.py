"""The port's benchmark and its hot-math probe against the JAX package's.

``ops/chain_rate.py::chain_plain`` (the probe kernel's plain version) is
held to the JAX package's benchmark bodies (``bench.py::_sweep_hot_body``,
``_energy_hot_body``, called directly on jnp float32 arrays and applied 32
times; bench.py's Pallas probe is never run); the port's exact TFI energy to
the JAX package's; each metric of the port's benchmark, called small on the
CPU, prints bench.py's metric line. The kernel is held to ``chain_plain`` on
the card (test_torch_gpu.py, chip_smoke.py).
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from neural_network_quantum_state_tpu.utils.exact import tfi_chain_exact_energy as jax_tfi_exact
from neural_network_quantum_state_tpu_torch import bench
from neural_network_quantum_state_tpu_torch.ops import chain_rate as chain_ops
from neural_network_quantum_state_tpu_torch.utils.exact import tfi_chain_exact_energy

# max|port - JAX| over both outputs, relative to their largest |value|: both
# evaluate the bodies in float32 with library exp/log/cos (the JAX energy
# body's atan2 is its polynomial, about 1e-7 rad), so they part by float32
# roundings carried through the contracting chain (measured 2e-7 for the
# sweep body and 2.4e-6 for the energy body).
CHAIN_RTOL = 1e-5
# the share of elements whose chain takes a phase within BRANCH_CUT_TOL of pi
# (energy body), left out of the comparison: 0.40% of bench.py's inputs
NEAR_CUT_MAX = 1e-2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("body", ["sweep", "energy"])
def test_chain_plain_matches_the_jax_bodies(body):
    """32 dependent applications of each body to bench.py's inputs (2^16
    elements): the port's plain chain against the JAX bodies, away from the
    branch cut of the energy body's phase."""
    x, y = chain_ops.probe_inputs(1 << 16, "cpu")
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    jfn = {"sweep": jbench._sweep_hot_body, "energy": jbench._energy_hot_body}[body]
    for _ in range(chain_ops.CHAIN_LEN):
        jx, jy = jfn(jx, jy)
    assert jx.dtype == jnp.float32
    calls = chain_ops.chain_plain.calls
    px, py = chain_ops.chain_plain(body, x, y)
    assert chain_ops.chain_plain.calls == calls + 1 and px.dtype == torch.float32
    near = chain_ops.chain_near_cut(body, x, y).numpy()
    got, want = np.stack([px.numpy(), py.numpy()]), np.stack([np.asarray(jx), np.asarray(jy)])
    assert np.isfinite(got).all()
    err = float(np.abs(got - want)[:, ~near].max() / np.abs(want).max())
    assert err <= CHAIN_RTOL, err
    assert near.mean() <= NEAR_CUT_MAX and (body == "energy" or not near.any())


def test_chain_kernel_refuses_cpu_tensors_and_bad_calls():
    """The kernel wrapper launches on CUDA tensors only (a CPU tensor given
    to it raises, before any build); an unknown body is refused by both
    versions; the plain chain never launches the kernel; the probe's rate
    needs the card."""
    x, y = chain_ops.probe_inputs(1024, "cpu")
    launches = chain_ops.chain_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        chain_ops.chain_cuda("sweep", x, y)
    for fn in (chain_ops.chain_cuda, chain_ops.chain_plain):
        with pytest.raises(ValueError, match="body"):
            fn("exchange", x, y)
    with pytest.raises(ValueError, match="card"):
        chain_ops.chain_rate("sweep", n_elems=1024, device="cpu")
    chain_ops.chain_plain("energy", x, y, 2)
    assert chain_ops.chain_cuda.launches == launches
    x64 = x.double().to("meta")
    with pytest.raises(ValueError):
        chain_ops.chain_cuda("sweep", x64, x64)


@pytest.mark.parametrize("n", [8, 16, 64])
def test_tfi_chain_exact_energy_matches_jax(n):
    for h, j in ((-1.0, -1.0), (0.5, 1.3)):
        assert tfi_chain_exact_energy(n, h=h, j=j) == jax_tfi_exact(n, h=h, j=j)
    with pytest.raises(ValueError, match="even N"):
        tfi_chain_exact_energy(n + 1, h=-1.0, j=-1.0)


_SMALL = {  # each metric of the port's benchmark at a size the CPU runs in seconds
    "energy_rel_err": (bench.bench_energy_rel_err, dict(n=8, alpha=1, n_walkers=64, warm_sweeps=5, steps=3, tail=2),
                       "energy_rel_err_vs_exact_N16_TFI_mixed_precision", "rel_err"),
    "sr_solves": (bench.bench_sr_solves, dict(n=8, alpha=1, n_walkers=64, warm_sweeps=2, settle=2, steps=2),
                  "sr_solves_per_sec_N64_RBMTrSymm_a4_8192walkers", "iters/s"),
    "energy_kernel": (bench.bench_energy_kernel, dict(n=8, alpha=1, n_walkers=64, reps=2),
                      "fused_local_energy_kernel_ms_N64_RBMTrSymm_a4_8192walkers", "ms/call"),
    "exchange": (bench.bench_exchange_throughput, dict(l=4, n_walkers=64, n_sweeps=2, reps=2),
                 "kawasaki_exchange_walker_sweeps_per_sec_L32_hubbard", "sweeps/s"),
    "sweep": (bench.bench_sweep_throughput, dict(n=8, alpha=1, n_walkers=64, sweeps_per_call=2, reps=2),
              "metropolis_walker_sweeps_per_sec_chip_N64_RBMTrSymm_a4", "sweeps/s"),
}


@pytest.mark.parametrize("name", list(_SMALL))
def test_bench_metric_prints_its_line(name, capsys):
    """Each metric, called small on the CPU, prints one JSON line with
    bench.py's metric name, unit and keys (the percentages renamed for the
    card, null on the CPU), naming the device it ran on."""
    fn, sizes, metric, unit = _SMALL[name]
    line = fn(device="cpu", **sizes)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    assert line["metric"] == metric and line["unit"] == unit and line["device"] == "cpu"
    assert isinstance(line["value"], float) and math.isfinite(line["value"]) and line["value"] >= 0.0
    if name == "energy_rel_err":
        # the bar over the error (the printed error keeps 3 digits)
        ratio = bench.BASELINE_REL_ERR / max(line["value"], 1e-300)
        assert abs(line["vs_baseline"] - ratio) <= 1e-3 * ratio + 1e-3
    else:
        assert line["vs_baseline"] is None
    if "gflops_analytic" in line:
        # rounded to 0.1 GFLOP/s: a small CPU run may print 0.0
        assert name in ("energy_kernel", "sweep") and line["gflops_analytic"] >= 0.0
        assert line["pct_h100_f32_peak"] is None and line["pct_hot_math_probe"] is None and line["card"] is None
    else:
        assert name not in ("energy_kernel", "sweep")
