"""The port's VMC end to end: ground-state energies vs exact diagonalization
(the JAX package's e2e oracles), and the options it refuses."""

import dataclasses

import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu.utils.exact import ground_energy, litfi_chain_dense
from neural_network_quantum_state_tpu_torch import VMC, VMCConfig
from neural_network_quantum_state_tpu_torch.hamiltonians import HubbardChain, LITFIChain, TFIChain
from neural_network_quantum_state_tpu_torch.models import RBM, RBMTrSymm
from neural_network_quantum_state_tpu_torch.optim import SRStats
from neural_network_quantum_state_tpu_torch.ops import energy, engine
from neural_network_quantum_state_tpu_torch.ops import exchange as exchange_ops
from neural_network_quantum_state_tpu_torch.ops import sweep as sweep_ops
from neural_network_quantum_state_tpu_torch.parallel import make_mesh
from neural_network_quantum_state_tpu_torch.sampler import kawasaki


def _final_energy(history, tail=15):
    return float(np.mean([h["energy"] for h in history[-tail:]]))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
def test_litfi_chain_converges_to_exact(dtype):
    """Long-range AFM chain (the paper's model) with the TrSymm RBM, in
    float64 and in the float32 that the card's kernels run."""
    n = 8
    theta = 2.0  # J = sin(theta) > 0 AFM, h = -cos(theta)
    j, h = float(np.sin(theta)), float(-np.cos(theta))
    machine = RBMTrSymm(n_inputs=n, alpha=2, dtype=dtype)
    ham = LITFIChain(n_sites=n, h=h, j=j, alpha=2.0, pbc=True)
    cfg = VMCConfig(n_walkers=256, learning_rate=2e-2, solver="cg", seed=3, use_fused_sweeps=dtype == torch.float32)
    vmc = VMC(machine, ham, cfg, device="cpu")
    params, state = vmc.init()
    state = vmc.warm_up(params, state, 200)
    params, state, history, _ = vmc.run(params, state, 1200)
    e_exact = ground_energy(litfi_chain_dense(n, h=h, j=j, alpha=2.0, pbc=True))
    rel = abs(_final_energy(history, tail=50) - e_exact) / abs(e_exact)
    assert rel < 1e-2, (rel, _final_energy(history, tail=50), e_exact)
    acceptance = [r["acceptance"] for r in history]
    assert all(0.0 <= a <= 1.0 for a in acceptance) and 0.0 < np.mean(acceptance) < 1.0


@pytest.mark.parametrize(
    "change",
    [
        {"n_beta": 32, "hamiltonian": HubbardChain(n_sites=4, n_up=1, n_down=1), "dtype": torch.float32,
         "device": "cuda", "error": ValueError},
        {"mesh": "3 shards", "error": ValueError},
        {"device": "cuda", "use_fused_sweeps": True, "error": ValueError},
    ],
    ids=["n_beta", "mesh", "float64_on_card"],
)
def test_unported_options_raise(change):
    """What the port does not take raises: a tempered-exchange ladder above
    the kernels' 16 replicas on the card (ValueError; tempered exchange
    itself is ported, tests/test_torch_tempered_exchange.py), a mesh whose
    shards the walkers do not divide (ValueError, as in JAX: 1024 walkers
    over 3 shards; meshes themselves are ported, tests/test_torch_mesh.py
    holds them to one device), and the fused sweeps for a float64 machine on
    the card (ValueError: the megakernel is float32 only, as the JAX
    package asserts; a float64 machine itself runs the sweep and exchange
    kernels' float64 instances)."""
    change = dict(change)
    machine = RBM(n_inputs=4, n_hiddens=4, dtype=change.pop("dtype", torch.float64))
    ham = change.pop("hamiltonian", TFIChain(n_sites=4))
    mesh = make_mesh(3, device="cpu") if change.pop("mesh", None) else None
    device = change.pop("device", "cpu")
    with pytest.raises(change.pop("error", NotImplementedError)):
        VMC(machine, ham, dataclasses.replace(VMCConfig(), **change), mesh=mesh, device=device)


@pytest.mark.parametrize(
    "change",
    [
        {"solver": "cholesky"},
        {"energy_dtype": torch.float64},
        {"precond_ema": 0.9},
        {"block_moves_per_sweep": 1},
    ],
    ids=["solver", "energy_dtype", "precond_ema", "block_moves"],
)
def test_ported_options_take_a_step(change):
    """The options that raised before the solvers and precision modes were
    ported now build and take SR steps with finite energies."""
    vmc = VMC(RBM(n_inputs=4, n_hiddens=4, dtype=torch.float32), TFIChain(n_sites=4),
              dataclasses.replace(VMCConfig(n_walkers=64, seed=2), **change), device="cpu")
    params, state = vmc.init()
    params, state, history, _ = vmc.run(params, vmc.warm_up(params, state, 5), 2)
    assert len(history) == 2 and all(np.isfinite(h["energy"]) for h in history)


def test_tempered_vmc_runs_on_the_beta1_replicas(monkeypatch):
    """n_beta > 1 builds a tempered sampler (one plain sweep call per sweep
    on the CPU, swap phases inside it), and the estimators see only the
    beta = 1 replicas [::n_beta], contiguous. A walker count that n_beta
    does not divide, and n_beta above the kernel's ladder on the card, are
    refused."""
    n, k, nb = 6, 48, 4
    vmc = VMC(RBM(n_inputs=n, n_hiddens=6, dtype=torch.float64), TFIChain(n_sites=n),
              VMCConfig(n_walkers=k, n_beta=nb, seed=4), device="cpu")
    params, state = vmc.init()
    calls = sweep_ops.sweep_plain.calls
    state = vmc.warm_up(params, state, 5)
    assert sweep_ops.sweep_plain.calls == calls + 5
    seen = []
    sr_update = vmc.sr_update

    def spy(params, cache, lnpsi, step_idx, extra_rounds=()):
        seen.append((cache.spins.clone(), cache.spins.is_contiguous() and lnpsi.is_contiguous()))
        return sr_update(params, cache, lnpsi, step_idx, extra_rounds=extra_rounds)

    monkeypatch.setattr(vmc, "sr_update", spy)
    before = state.cache.spins.clone()
    params, state, history, _ = vmc.run(params, state, 3)
    assert len(history) == 3 and all(np.isfinite(h["energy"]) for h in history)
    assert all(spins.shape == (k // nb, n) and contiguous for spins, contiguous in seen)
    assert not torch.equal(before, state.cache.spins)
    with pytest.raises(ValueError, match="multiple of n_beta"):
        VMC(RBM(n_inputs=n, n_hiddens=6), TFIChain(n_sites=n), VMCConfig(n_walkers=50, n_beta=4), device="cpu")
    with pytest.raises(ValueError, match="at most 16"):
        VMC(RBM(n_inputs=n, n_hiddens=6), TFIChain(n_sites=n), VMCConfig(n_walkers=64, n_beta=32), device="cuda")
    with pytest.raises(ValueError, match="use_fused_sweeps"):
        VMC(RBM(n_inputs=4, n_hiddens=4), HubbardChain(n_sites=4, n_up=1, n_down=1),
            VMCConfig(n_walkers=64, n_beta=4, use_fused_sweeps=True), device="cpu")


def test_config_checks_and_large_v_default():
    ham = TFIChain(n_sites=16)
    with pytest.raises(ValueError, match="float32"):
        VMC(RBM(n_inputs=16, n_hiddens=4, dtype=torch.float64), ham, VMCConfig(use_fused_sweeps=True), device="cpu")
    with pytest.raises(ValueError, match="dense solver"):
        VMC(RBM(n_inputs=16, n_hiddens=4), ham, VMCConfig(n_accumulations=2), device="cpu")
    # a float64 machine off the CPU is taken (the kernels' float64 instances)
    assert VMC(RBM(n_inputs=16, n_hiddens=4, dtype=torch.float64), ham, VMCConfig(), device="meta").device.type == "meta"
    big = VMC(RBM(n_inputs=16, n_hiddens=32), ham, VMCConfig(), device="cpu")  # V = 560
    assert big.config.solve_dtype == torch.float64
    small = VMC(RBM(n_inputs=16, n_hiddens=4), ham, VMCConfig(), device="cpu")
    assert small.config.solve_dtype is None


def _collapsed_step(params, state, step_idx):
    """An SR step stub whose rsd is pinned at zero: a collapsed ensemble."""
    return params, state, SRStats(energy=torch.tensor(-1.0 + 0j), rsd=torch.tensor(0.0), cg_iters=0, lam=1.0)


def test_collapse_reseeds_or_refuses_escalation(capsys):
    """rsd pinned at zero (walker collapse) reseeds half of the walkers when
    no tempering ladder is asked for, and escalates to tempering with the
    remaining iterations when one is; an exchange Hamiltonian (the Hubbard
    chain, default use_fused_sweeps=False) escalates to tempered exchange
    as in the JAX package and finishes its steps, every replica in its
    particle sector (it raised before tempered exchange was ported)."""
    n, k = 8, 64
    machine = RBMTrSymm(n_inputs=n, alpha=1, dtype=torch.float64)
    ham = LITFIChain(n_sites=n, h=-0.5, j=1.0, alpha=2.0)  # Neel start
    cfg = VMCConfig(n_walkers=k, seed=1, collapse_patience=2, collapse_requil_sweeps=0)

    collapsed_step = _collapsed_step
    vmc = VMC(machine, ham, dataclasses.replace(cfg, collapse_escalate_nbeta=1), device="cpu")
    vmc.step = collapsed_step
    params, state = vmc.init()
    neel = state.cache.spins.clone()
    _, state, history, _ = vmc.run(params, state, 4)
    assert vmc.n_remediations == 1 and len(history) == 4
    spins = state.cache.spins
    assert torch.equal(spins[1::2], neel[1::2]) and not torch.equal(spins[::2], neel[::2])
    fresh, _ = engine.full_forward(machine.make_work(params), spins)
    torch.testing.assert_close(state.cache.y, fresh.y)

    vmc = VMC(machine, ham, cfg, device="cpu")
    vmc.step = collapsed_step
    params, state = vmc.init()
    calls = sweep_ops.sweep_plain.calls
    _, state, history, _ = vmc.run(params, state, 4)
    assert "escalating to parallel tempering (n_beta=4)" in capsys.readouterr().out
    assert vmc.n_remediations == 1 and [h["step"] for h in history] == [0, 1, 2, 3]
    assert sweep_ops.sweep_plain.calls == calls + 2  # the two tempered steps, one sweep each
    assert state.cache.spins.shape == (k, n) and all(np.isfinite(h["energy"]) for h in history)

    hub = VMC(RBM(n_inputs=4, n_hiddens=4, dtype=torch.float64), HubbardChain(n_sites=4, n_up=1, n_down=1),
              VMCConfig(n_walkers=k, seed=1, collapse_patience=2, collapse_requil_sweeps=0), device="cpu")
    assert hub._can_escalate()
    hub.step = collapsed_step
    params, state = hub.init()
    calls = exchange_ops.exchange_plain.calls
    _, state, history, _ = hub.run(params, state, 4)
    assert "escalating to parallel tempering (n_beta=4)" in capsys.readouterr().out
    assert hub.n_remediations == 1 and [h["step"] for h in history] == [0, 1, 2, 3]
    assert exchange_ops.exchange_plain.calls == calls + 2  # the two tempered exchange steps, one sweep each
    s = state.cache.spins
    assert s.shape == (k, 4) and ((s[:, :2] > 0).sum(1) == 1).all() and ((s[:, 2:] > 0).sum(1) == 1).all()
    assert all(np.isfinite(h["energy"]) for h in history)


def test_collapsed_hubbard_run_tunes_its_ladder(capsys, monkeypatch):
    """collapse_escalate_nbeta=0 with an exchange Hamiltonian measures the
    ladder with kawasaki.tune_n_beta_exchange on the collapsed ensemble (the
    sector-keeping probe), escalates to the n_beta it picks and finishes the
    run in the sectors, as the JAX package's VMC."""
    k = 64
    hub = VMC(RBM(n_inputs=4, n_hiddens=4, dtype=torch.float64), HubbardChain(n_sites=4, n_up=1, n_down=1),
              VMCConfig(n_walkers=k, seed=1, collapse_patience=2, collapse_requil_sweeps=0, collapse_escalate_nbeta=0),
              device="cpu")
    assert hub._can_escalate()
    hub.step = _collapsed_step
    picked = []
    tune = kawasaki.tune_n_beta_exchange

    def spy(*args, **kwargs):
        nb, diags = tune(*args, **kwargs)
        picked.append(nb)
        return nb, diags

    monkeypatch.setattr(kawasaki, "tune_n_beta_exchange", spy)
    params, state = hub.init()
    _, state, history, _ = hub.run(params, state, 5)
    out = capsys.readouterr().out
    assert len(picked) == 1 and k % picked[0] == 0
    assert f"escalating to parallel tempering (n_beta={picked[0]}, auto-tuned from swap acceptance)" in out
    assert "#   n_beta=2: swap/pair = " in out
    assert hub.n_remediations == 1 and [h["step"] for h in history] == [0, 1, 2, 3, 4]
    s = state.cache.spins
    assert ((s[:, :2] > 0).sum(1) == 1).all() and ((s[:, 2:] > 0).sum(1) == 1).all()
    assert all(np.isfinite(h["energy"]) for h in history)


@pytest.fixture(scope="module")
def jax_chunked_vmc():
    """The JAX package's VMC with steps_per_host_loop = 3 (one compiled
    chunk shared by the cases below)."""
    import jax.numpy as jnp

    import neural_network_quantum_state_tpu as jnqs
    from neural_network_quantum_state_tpu.hamiltonians import TFIChain as JTFIChain
    from neural_network_quantum_state_tpu.models import RBM as JRBM

    return jnqs.VMC(JRBM(n_inputs=4, n_hiddens=4, dtype=jnp.float64), JTFIChain(n_sites=4),
                    jnqs.VMCConfig(n_walkers=32, steps_per_host_loop=3, seed=0))


@pytest.mark.parametrize(
    "n_iter, rsd_cutoff, every, start, steps, fired",
    [
        (7, None, 2, 0, list(range(7)), [3, 6]),
        (7, 1e9, 2, 0, [0], [3]),
        (7, None, 4, 5, list(range(5, 12)), [8, 12]),
    ],
    ids=["chunks-then-single", "rsd-stop-inside-chunk", "resumed"],
)
def test_chunked_run_stops_and_checkpoints_as_jax(jax_chunked_vmc, n_iter, rsd_cutoff, every, start, steps, fired):
    """steps_per_host_loop = 3: whole chunks of 3 steps, then the last
    partial chunk step by step; the stops are checked after a chunk (an
    rsd_cutoff met at a chunk's first step ends the history there, with
    the chunk's three steps taken); checkpoint_fn fires after a chunk that
    crosses a multiple of checkpoint_every. The history's steps, the
    checkpoint steps and the proposals made agree with the JAX package."""
    def record(vmc):
        params, state = vmc.init()
        proposed0 = float(state.n_proposed)  # read before run() donates the JAX state
        got = []
        _, state, history, _ = vmc.run(params, state, n_iter, checkpoint_fn=lambda s, p, st: got.append(s),
                                       checkpoint_every=every, start_step=start)
        return [h["step"] for h in history], got, float(state.n_proposed) - proposed0

    jvmc = jax_chunked_vmc
    jvmc.config = dataclasses.replace(jvmc.config, rsd_cutoff=rsd_cutoff)
    want = record(jvmc)
    got = record(VMC(RBM(n_inputs=4, n_hiddens=4, dtype=torch.float64), TFIChain(n_sites=4),
                     VMCConfig(n_walkers=32, steps_per_host_loop=3, rsd_cutoff=rsd_cutoff, seed=0), device="cpu"))
    assert got == want
    taken = 3 * (n_iter // 3) + n_iter % 3 if rsd_cutoff is None else 3
    assert (got[0], got[1], got[2]) == (steps, fired, float(taken * 4 * 32))
