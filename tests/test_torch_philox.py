"""The sweep and exchange kernels' Philox4x32-10 streams in plain PyTorch.

``ops.rng.philox_uniforms`` is held to the Random123 known-answer vectors
and to a scalar pure-Python Philox4x32-10, element for element, for the
sweep's flip and swap streams and the exchange kernel's selection and
acceptance streams; the plain sweep on those draws is held to exact |psi|^2
by chi^2 at N=8, as test_torch_sampler.py holds it on the generator's
blocks (the plain exchange: test_torch_exchange.py). The kernels' own draws
are compared with these on the card (test_torch_gpu.py).
"""

import numpy as np
import pytest
import torch

from neural_network_quantum_state_tpu_torch.models import RBM
from neural_network_quantum_state_tpu_torch.ops import engine
from neural_network_quantum_state_tpu_torch.ops import sweep as sweep_ops
from neural_network_quantum_state_tpu_torch.ops.rng import (
    ACCEPT_STREAM, FLIP_STREAM, SELECT_STREAM, SWAP_STREAM, ExchangeDraws, PhiloxDraws, make_generator, philox4x32_10,
    philox_key, philox_uniforms,
)
from neural_network_quantum_state_tpu_torch.sampler import chain_checkerboard
from neural_network_quantum_state_tpu_torch.sampler.metropolis import sweep_draws

M32 = 0xFFFFFFFF


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _philox_scalar(ctr, key):
    """Philox4x32-10 on Python ints (Salmon et al., SC'11; Random123's
    philox4x32 with 10 rounds)."""
    c, k = list(ctr), list(key)
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & M32, (p0 >> 32) ^ c[3] ^ k[1], p0 & M32]
        k = [(k[0] + 0x9E3779B9) & M32, (k[1] + 0xBB67AE85) & M32]
    return c


def _words(ctr, key):
    t = [torch.tensor(v, dtype=torch.int64) for v in (*ctr, *key)]
    return [int(w) for w in philox4x32_10(t[:4], t[4:])]


# Random123's kat_vectors for philox4x32_10: (counter, key, output).
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr, key, want", KAT)
def test_philox_matches_the_known_answers(ctr, key, want):
    assert tuple(_philox_scalar(ctr, key)) == want
    assert tuple(_words(ctr, key)) == want


def test_philox_tensor_matches_scalar_on_random_words():
    rng = np.random.default_rng(7)
    words = rng.integers(0, 1 << 32, size=(512, 6), dtype=np.int64)
    cols = [torch.as_tensor(words[:, i]) for i in range(6)]
    got = torch.stack(philox4x32_10(cols[:4], cols[4:]), 1).numpy()
    want = np.array([_philox_scalar(w[:4], w[4:]) for w in words.tolist()], dtype=np.int64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("t_n, k, n_sweeps", [(7, 5, 3), (4, 1, 1), (9, 33, 2)])
def test_philox_uniforms_layout(t_n, k, n_sweeps):
    """Element (t, k): word t % 4 of counter (t // 4, k, 0, stream), top 24
    bits scaled by 2^-24; the flips take stream 0, the swaps stream 1 (row
    2 s + parity)."""
    key = torch.tensor([0x1234ABCD, 0x0F0E0D0C], dtype=torch.int64)
    kk = [int(v) for v in key]
    draws = PhiloxDraws(key, t_n)
    for stream, u in ((FLIP_STREAM, draws.flips(k)), (SWAP_STREAM, draws.swaps(n_sweeps, k).reshape(2 * n_sweeps, k))):
        assert u.dtype == torch.float32 and tuple(u.shape[1:]) == (k,)
        for t in range(u.shape[0]):
            for w in range(k):
                bits = _philox_scalar((t // 4, w, 0, stream), kk)[t % 4]
                assert float(u[t, w]) == (bits >> 8) * 2.0**-24
        torch.testing.assert_close(u, philox_uniforms(key, stream, tuple(u.shape)), rtol=0, atol=0)
        assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert draws.flips(k).shape[0] == t_n


@pytest.mark.parametrize("t_n, k", [(7, 5), (1, 1), (70, 3)])
def test_exchange_streams_layout(t_n, k):
    """The exchange kernel's streams: element (t, k) of the selection
    (acceptance) uniforms is word t % 4 of the scalar Philox4x32-10 (held
    to the known answers above) at counter (t // 4, k, 0, SELECT_STREAM
    (ACCEPT_STREAM)), top 24 bits scaled by 2^-24."""
    key = torch.tensor([0xA4093822, 0x299F31D0], dtype=torch.int64)
    kk = [int(v) for v in key]
    draws = ExchangeDraws(key, t_n)
    assert (SELECT_STREAM, ACCEPT_STREAM) == (2, 3)
    for stream, u in ((SELECT_STREAM, draws.selection(k)), (ACCEPT_STREAM, draws.acceptance(k))):
        assert u.dtype == torch.float32 and tuple(u.shape) == (t_n, k)
        for t in range(t_n):
            for w in range(k):
                bits = _philox_scalar((t // 4, w, 0, stream), kk)[t % 4]
                assert float(u[t, w]) == (bits >> 8) * 2.0**-24
        assert 0.0 <= float(u.min()) and float(u.max()) < 1.0


def test_exchange_streams_are_apart_from_each_other_and_the_sweep_streams():
    """On one key the four streams (flip, swap, selection, acceptance) share
    no counter, so their uniforms are independent: no two of them agree on
    more elements than 24-bit coincidences allow, and each is uniform."""
    key = torch.tensor([17, 99], dtype=torch.int64)
    t_n, k = 64, 256
    blocks = {stream: philox_uniforms(key, stream, (t_n, k))
              for stream in (FLIP_STREAM, SWAP_STREAM, SELECT_STREAM, ACCEPT_STREAM)}
    draws = ExchangeDraws(key, t_n)
    assert torch.equal(draws.selection(k), blocks[SELECT_STREAM]) and torch.equal(draws.acceptance(k), blocks[ACCEPT_STREAM])
    streams = list(blocks)
    for a in range(len(streams)):
        u = blocks[streams[a]]
        assert abs(float(u.mean()) - 0.5) < 0.01 and abs(float(u.var()) - 1.0 / 12.0) < 0.005
        for b in range(a + 1, len(streams)):
            assert int((u == blocks[streams[b]]).sum()) <= 2
            corr = float(torch.corrcoef(torch.stack([u.reshape(-1), blocks[streams[b]].reshape(-1)]))[0, 1])
            assert abs(corr) < 0.02


def test_philox_key_and_cpu_draws():
    g = make_generator(3, "cpu")
    key = philox_key(g)
    assert key.dtype == torch.int64 and tuple(key.shape) == (2,)
    assert 0 <= int(key.min()) and int(key.max()) < 1 << 32
    # the CPU path keeps drawing uniform blocks from the generator
    u, sw = sweep_draws(make_generator(3, "cpu"), torch.ones((4, 8)), 8, 2)
    torch.testing.assert_close(u, torch.rand((8, 4), generator=make_generator(3, "cpu")))
    assert tuple(sw.shape) == (1, 2, 4)


@pytest.mark.parametrize("n_beta", [1, 2])
def test_plain_sweep_on_philox_draws_takes_their_uniforms(n_beta, rng):
    """The plain sweep given PhiloxDraws decides exactly as on the tensors
    they stand for (the flip and the swap stream)."""
    n, k = 8, 64
    tm = RBM(n_inputs=n, n_hiddens=12, dtype=torch.float64)
    work = tm.make_work({name: torch.as_tensor(0.4 * (rng.normal(size=s) + 1j * rng.normal(size=s)))
                         for name, s in tm.param_spec()})
    cache, ln = engine.full_forward(work, torch.as_tensor(np.where(rng.random((k, n)) < 0.5, -1.0, 1.0)))
    sched = torch.as_tensor(chain_checkerboard(n))
    draws = PhiloxDraws(torch.tensor([17, 99], dtype=torch.int64), 2 * n)
    got = sweep_ops.sweep_plain(work, cache, ln, sched, draws, n_beta, rows=True)
    u = draws.flips(k).to(torch.float64)
    sw = draws.swaps(2, k).to(torch.float64) if n_beta > 1 else None
    want = sweep_ops.sweep_plain(work, cache, ln, sched, u, n_beta, sw, rows=True)
    torch.testing.assert_close(got[0].spins, want[0].spins, rtol=0, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    with pytest.raises(ValueError, match="from the stream"):
        sweep_ops.sweep_plain(work, cache, ln, sched, draws, 2, draws.swaps(2, k))


def test_plain_sweep_on_philox_draws_samples_psi2(rng):
    """chi^2 of the plain sweep on Philox draws (a fresh key per sweep, as
    the sampler draws on the card) against exact |psi|^2 at N=8."""
    n, k = 8, 1024
    tm = RBM(n_inputs=n, n_hiddens=12, dtype=torch.float64)
    work = tm.make_work({name: torch.as_tensor(0.25 * (rng.normal(size=s) + 1j * rng.normal(size=s)))
                         for name, s in tm.param_spec()})
    g = make_generator(5, "cpu")
    cache, ln = engine.full_forward(work, torch.where(torch.rand((k, n), generator=g) < 0.5, -1.0, 1.0).double())
    sched = torch.as_tensor(chain_checkerboard(n))

    confs = torch.as_tensor([[1.0 - 2.0 * ((i >> b) & 1) for b in range(n)] for i in range(2**n)], dtype=torch.float64)
    p = torch.exp(2.0 * engine.log_psi(work, confs).real).numpy()
    p /= p.sum()

    counts = np.zeros(2**n)
    bit_w = np.asarray([1 << b for b in range(n)])
    for i in range(80):
        cache, ln, _ = sweep_ops.sweep_plain(work, cache, ln, sched, PhiloxDraws(philox_key(g), n))
        if i >= 20:
            idx = ((1.0 - cache.spins.numpy()) / 2.0 @ bit_w).astype(int)
            counts += np.bincount(idx, minlength=2**n)
    total = counts.sum()
    chi2 = float(np.sum((counts - total * p) ** 2 / (total * p)))
    tv = 0.5 * float(np.abs(counts / total - p).sum())
    assert chi2 / (2**n - 1) < 3.0, (chi2, tv)
    assert tv < 0.03, tv
    assert p.max() > 4 * p.min()  # the target is far from uniform
