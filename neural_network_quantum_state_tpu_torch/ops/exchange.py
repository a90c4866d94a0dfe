"""Kawasaki pair-exchange proposals: CUDA kernel and plain version.

``exchange_steps`` runs ``n_steps`` proposal rounds. In round t every walker
masks its active (anti-aligned) bonds, picks the (target+1)-th of its nb
active bonds in bond order with
``target = min(floor(u_sel[t] * nb), max(nb - 1, 0))``, flips both ends and
accepts where ``u_acc[t] < exp(2 min(Re dln, 0))`` and nb > 0. The uniforms
are two (n_steps, K) tensors drawn by the caller, or a ``rng.ExchangeDraws``
(a key): the kernel then draws them on the chip and the plain version makes
the same numbers. A CUDA tensor goes to the kernel in ``csrc/exchange.cu``
(float32; an instance for the RBM family, c = 1, and one for the FFNN
family's complex output weights), which runs every round in one launch; a
CPU tensor goes to ``exchange_plain``, the same computation in PyTorch.
Both take the same uniforms, so they make the same decisions.

With n_beta > 1 (tempered exchange, parallel tempering for the Hubbard
chain) the walkers are replica-minor (row w = chain * n_beta + r holds
beta_r = (n_beta - r) / n_beta, ``ops.sweep.replica_betas``), a proposal is
accepted where ``u_acc[t] < exp(2 beta min(Re dln, 0))``, and every sweep of
``n_unit`` proposals is followed by the even-pair and then the odd-pair swap
phase (``ops.sweep.swap_phase``) on the (n_sweeps, 2, K) swap uniforms, or
on the swap stream of an ``ExchangeDraws``. The kernel runs a whole call in
one launch of its tempered instance; ``tempered_exchange_plain`` is its
plain twin. The JAX package has no Pallas kernel for this: its tempered
exchange is ``sampler/kawasaki.py::tempered_exchange_sweeps`` in XLA.

The kernel keeps each walker's active-bond mask and updates it after an
accepted flip of (i, j) from the site -> incident-bonds table
(``incidence_table``): every bond that touches i or j changes state, once
per touching end (``update_active`` is its plain twin).

Replaces ``neural_network_quantum_state_tpu/ops/pallas_exchange.py``.
"""

from __future__ import annotations

import ctypes

import torch

from neural_network_quantum_state_tpu_torch.ops import build, engine
from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work
from neural_network_quantum_state_tpu_torch.ops.rng import ExchangeDraws
from neural_network_quantum_state_tpu_torch.ops.sweep import MAX_NBETA, check_ladder, replica_betas, swap_phase


def select_active_bond(active: torch.Tensor, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniformly pick one active bond per walker.

    active: (K, B) bool; u: (K,) uniforms. Returns (bond (K,), nb (K,)):
    the index of the (target+1)-th active bond by the running-sum inverse
    CDF, and the number of active bonds. A walker with none gets bond B-1.
    """
    nb = active.sum(1)
    target = torch.floor(u * nb).to(nb.dtype)  # u * nb in u's float dtype
    target = torch.minimum(target, (nb - 1).clamp(min=0))
    cs = torch.cumsum(active.to(torch.int32), 1)
    bond = (cs <= target[:, None]).sum(1)
    return bond.clamp(max=active.shape[1] - 1), nb


def incidence_table(bonds: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The site -> incident-bonds table of a (B, 2) bond table in CSR form,
    int32 on the bonds' device: the bonds that touch site i are
    ``idx[ptr[i]:ptr[i+1]]`` (ptr (n+1,), idx (2B,)), in bond order, a bond
    once per end that lies at i (a self-loop twice)."""
    ends = bonds.reshape(-1).long()
    order = torch.sort(ends, stable=True).indices
    ptr = torch.searchsorted(ends[order], torch.arange(n + 1, device=ends.device))
    return ptr.to(torch.int32), (order // 2).to(torch.int32)


def update_active(active: torch.Tensor, ptr: torch.Tensor, idx: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
                  accept: torch.Tensor) -> torch.Tensor:
    """The (K, B) active-bond mask after the pair flips (i, j) (each (K,))
    on the walkers where ``accept``, from the mask before them: flipping a
    spin changes the state of every bond that touches it, once per touching
    end, so a bond is toggled once per entry of the incidence table at i and
    at j (the flipped bond (i, j) twice: it stays active). The kernel's
    update, as a dense parity over the table's entries."""
    n, b = ptr.shape[0] - 1, active.shape[1]
    sites = torch.repeat_interleave(torch.arange(n, device=ptr.device), (ptr[1:] - ptr[:-1]).long())
    count = torch.zeros((n, b), dtype=torch.int32, device=ptr.device)
    count.index_put_((sites, idx.long()), torch.ones_like(sites, dtype=torch.int32), accumulate=True)
    odd = count % 2 == 1  # (N, B): bond b touches site s an odd number of times
    return active ^ ((odd[i] ^ odd[j]) & accept[:, None])


def _check_uniforms(u_sel, u_acc) -> bool:
    """Whether the call draws on a Philox stream (``u_sel`` an
    ``ExchangeDraws``, no ``u_acc``) rather than on two uniform blocks."""
    philox = isinstance(u_sel, ExchangeDraws)
    if philox and u_acc is not None:
        raise ValueError("exchange: with ExchangeDraws the acceptance uniforms come from the stream; pass none")
    if not philox and u_acc is None:
        raise ValueError("exchange: pass the acceptance uniforms beside the selection block, or an ExchangeDraws")
    return philox


def _uniforms(u_sel, u_acc, k: int):
    """The (n_steps, K) selection and acceptance uniforms of a call."""
    if _check_uniforms(u_sel, u_acc):
        return u_sel.selection(k), u_sel.acceptance(k)
    return u_sel, u_acc


def exchange_plain(work: Work, cache: Cache, lnpsi: torch.Tensor, bonds: torch.Tensor, u_sel, u_acc=None,
                   beta: torch.Tensor | None = None):
    """Plain PyTorch proposal rounds; returns (cache, lnpsi, n_accepted).

    ``u_sel`` and ``u_acc`` are the (n_steps, K) uniform blocks, or ``u_sel``
    is an ``ExchangeDraws`` whose streams are made here. With a (K,) ``beta``
    (tempered exchange) a proposal is accepted where
    ``u_acc[t] < exp(2 beta min(dln, 0))`` and n_accepted is the (K,)
    float64 count per walker row, as the JAX package's
    ``_exchange_scan(..., beta=)``.
    """
    exchange_plain.calls += 1
    u_sel, u_acc = _uniforms(u_sel, u_acc, lnpsi.shape[0])
    bonds = bonds.to(device=cache.spins.device, dtype=torch.long)
    n_acc = torch.zeros(() if beta is None else lnpsi.shape, dtype=torch.float64, device=u_acc.device)
    scale = 2.0 if beta is None else 2.0 * beta
    for t in range(u_sel.shape[0]):
        s = cache.spins
        active = s[:, bonds[:, 0]] * s[:, bonds[:, 1]] < 0
        bond, nb = select_active_bond(active, u_sel[t])
        i, j = bonds[bond, 0], bonds[bond, 1]
        lnpsi1 = engine.flip2_log_psi_per_walker(work, cache, i, j)
        dln = lnpsi1.real - lnpsi.real
        accept = (u_acc[t] < torch.exp(scale * torch.clamp(dln, max=0.0))) & (nb > 0)
        cache = engine.commit_flip2_per_walker(work, cache, i, j, accept)
        lnpsi = torch.where(accept, lnpsi1, lnpsi)
        n_acc = n_acc + (accept.sum() if beta is None else accept)
    return cache, lnpsi, n_acc


exchange_plain.calls = 0


def tempered_exchange_plain(work: Work, cache: Cache, lnpsi: torch.Tensor, bonds: torch.Tensor, u_sel, u_acc=None,
                            n_beta: int = 1, n_unit: int | None = None, swap_uniforms: torch.Tensor | None = None):
    """Plain (tempered) exchange, the kernel's twin; returns (cache, lnpsi,
    counts): counts is a (2, K) float64 tensor, the accepted proposals of
    each walker row and the accepted swaps with each row as the lower member
    (zeros for n_beta = 1).

    Each sweep is one ``exchange_plain`` call on its ``n_unit`` rows of the
    selection and acceptance uniforms at the rows' betas, then the even and
    the odd swap phase, as the JAX package's ``tempered_exchange_sweeps``
    composes ``_exchange_scan`` and ``_swap_phase``. ``u_sel`` is an
    ``ExchangeDraws`` (all three streams made here) or the (n_steps, K)
    selection block beside ``u_acc`` and the (n_sweeps, 2, K)
    ``swap_uniforms``; ``n_unit`` None makes the whole call one sweep.
    """
    k = lnpsi.shape[0]
    philox = _check_uniforms(u_sel, u_acc)
    n_steps = u_sel.n_steps if philox else u_sel.shape[0]
    n_unit = n_steps if n_unit is None else n_unit
    n_sweeps = check_ladder("exchange", k, n_steps, n_unit, n_beta, swap_uniforms, philox)
    n_unit = n_steps // n_sweeps  # all of them for n_beta = 1
    if philox and n_beta > 1:
        swap_uniforms = u_sel.swaps(n_sweeps, k)
    u_sel, u_acc = _uniforms(u_sel, u_acc, k)
    beta = replica_betas(n_beta, k // n_beta, cache.spins.dtype, cache.spins.device)
    counts = torch.zeros((2, k), dtype=torch.float64, device=lnpsi.device)
    for s in range(n_sweeps):
        span = slice(s * n_unit, (s + 1) * n_unit)
        cache, lnpsi, n_acc = exchange_plain(work, cache, lnpsi, bonds, u_sel[span], u_acc[span], beta=beta)
        counts[0] += n_acc
        for parity in (0, 1) if n_beta > 1 else ():
            cache, lnpsi, acc_lower = swap_phase(cache, lnpsi, swap_uniforms[s, parity], parity, n_beta)
            counts[1] += acc_lower
    return cache, lnpsi, counts


# The last incidence table: (bonds, bonds' version counter, n, (ptr, idx)).
_incidence_memo: list = [None]


def kernel_incidence(bonds: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``incidence_table`` of `bonds`, built once per bond tensor (the last
    table is kept with its bonds and their version counter)."""
    memo = _incidence_memo[0]
    if memo is not None and memo[0] is bonds and memo[1] == bonds._version and memo[2] == n:
        return memo[3]
    table = incidence_table(bonds, n)
    _incidence_memo[0] = (bonds, bonds._version, n, table)
    return table


def _library():
    lib = build.library("exchange")
    fn = lib.nqs_exchange_f32
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.nqs_exchange_lanes.argtypes = [ctypes.c_int]
    lib.nqs_exchange_stages_w.argtypes = [ctypes.c_int] * 5
    return lib


def kernel_lanes(h: int) -> int:
    """The kernel's lanes per walker G at H hidden units (it chooses: 8 at
    H <= 64, 16 at H <= 128, else 32; measured at the Hubbard flagship,
    PERF.md)."""
    return _library().nqs_exchange_lanes(h)


def stages_w(n: int, h: int, b: int, has_c: bool, n_beta: int = 1) -> bool:
    """Whether the kernel reads W from shared memory (staged once per block)
    at this shape and replica count, as it chooses: where the block's layout
    fits its budget; else through L1/L2."""
    return bool(_library().nqs_exchange_stages_w(n, h, b, int(has_c), n_beta))


def exchange_cuda(work: Work, cache: Cache, bonds: torch.Tensor, u_sel, u_acc=None, n_beta: int = 1,
                  n_unit: int | None = None, swap_uniforms: torch.Tensor | None = None):
    """Launch the exchange kernel once for every round; returns (cache, lnpsi,
    counts), counts the (2, K) float64 per-row counts of
    ``tempered_exchange_plain``.

    `bonds` is a contiguous (B, 2) int32 tensor on the walkers' device with
    1 <= B <= N and entries in [0, N) (the kernel traps on an entry out of
    range). ``u_sel`` is an ``ExchangeDraws`` (the kernel draws on the chip)
    or the (n_steps, K) selection block beside ``u_acc`` (and for n_beta > 1
    the (n_sweeps, 2, K) ``swap_uniforms``). n_beta > 1 runs the tempered
    instance: sweeps of ``n_unit`` proposals, each followed by its two swap
    phases. The complex ln psi of the final states is recomputed once from
    the final cache with the plain log-cosh, as in ``ops.sweep.sweep_cuda``.
    """
    k, n = cache.spins.shape
    h = work.w.shape[1]
    dev = cache.spins.device
    if cache.spins.dtype != torch.float32:
        raise NotImplementedError(f"exchange kernel: only float32 is ported, got {cache.spins.dtype}")
    b = bonds.shape[0]
    if not 1 <= b <= n:
        raise ValueError(f"exchange kernel: bond count {b} not in [1, N={n}]")
    if n_beta > MAX_NBETA:
        raise ValueError(f"exchange kernel: n_beta={n_beta} above the in-kernel ladder's limit of {MAX_NBETA}")
    philox = _check_uniforms(u_sel, u_acc)
    n_steps = u_sel.n_steps if philox else u_sel.shape[0]
    if n_steps == 0:
        raise ValueError("exchange kernel: no proposal rounds")
    n_sweeps = check_ladder("exchange kernel", k, n_steps, n_steps if n_unit is None else n_unit, n_beta,
                            swap_uniforms, philox)
    tensors, weights = engine.kernel_weights(work)
    tensors |= {
        "bonds": (bonds, torch.int32, (b, 2)),
        "spins": (cache.spins, torch.float32, (k, n)),
        "y": (cache.y, torch.complex64, (k, h)),
        "sa": (cache.sa, torch.complex64, (k,)),
    }
    if philox:
        tensors["key"] = (u_sel.key, torch.int64, (2,))
        uniforms = (None, None, None, u_sel.key.data_ptr())
    else:
        tensors["u_sel"] = (u_sel, torch.float32, (n_steps, k))
        tensors["u_acc"] = (u_acc, torch.float32, (n_steps, k))
        if n_beta > 1:
            tensors["swap_uniforms"] = (swap_uniforms, torch.float32, (n_sweeps, 2, k))
        uniforms = (u_sel.data_ptr(), u_acc.data_ptr(), swap_uniforms.data_ptr() if n_beta > 1 else None, None)
    build.check_inputs("exchange", dev, h, tensors)
    ptr, idx = kernel_incidence(bonds, n)
    spins = torch.empty_like(cache.spins)
    y = torch.empty_like(cache.y)
    sa = torch.empty_like(cache.sa)
    counts = torch.zeros((2, k), dtype=torch.int32, device=dev)  # row 1 written by the tempered instance only
    rc = _library().nqs_exchange_f32(
        *weights, bonds.data_ptr(), ptr.data_ptr(), idx.data_ptr(), cache.spins.data_ptr(), cache.y.data_ptr(),
        cache.sa.data_ptr(), *uniforms, spins.data_ptr(), y.data_ptr(), sa.data_ptr(), counts[0].data_ptr(),
        counts[1].data_ptr() if n_beta > 1 else None, k, n, h, b, n_steps, n_steps // n_sweeps, n_beta,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch(rc, "exchange kernel")
    exchange_cuda.launches += 1
    exchange_cuda.launches_tempered += int(n_beta > 1)
    exchange_cuda.launches_tempered_c += int(n_beta > 1 and work.c is not None)
    cache = Cache(spins=spins, y=y, sa=sa)
    return cache, engine.cache_log_psi(work, cache), counts.to(torch.float64)


exchange_cuda.launches = 0
exchange_cuda.launches_tempered = 0  # those of them of the tempered instance (n_beta > 1)
exchange_cuda.launches_tempered_c = 0  # those of the tempered instance with c


def exchange_steps(work: Work, cache: Cache, lnpsi: torch.Tensor, bonds: torch.Tensor, u_sel, u_acc=None,
                   n_beta: int = 1, n_unit: int | None = None, swap_uniforms: torch.Tensor | None = None):
    """Run the pair-exchange rounds of ``u_sel`` (an ``ExchangeDraws``, or the
    (n_steps, K) selection block beside ``u_acc``), with n_beta > 1 in
    sweeps of ``n_unit`` followed by their swap phases (on the draws' swap
    stream or ``swap_uniforms``); returns (cache, lnpsi, counts), counts the
    (2, K) float64 per-row counts of accepted proposals and swaps.

    The kernel on a CUDA tensor (or an error), the plain version on a CPU one.
    """
    if cache.spins.device.type == "cpu":
        return tempered_exchange_plain(work, cache, lnpsi, bonds, u_sel, u_acc, n_beta, n_unit, swap_uniforms)
    return exchange_cuda(work, cache, bonds, u_sel, u_acc, n_beta, n_unit, swap_uniforms)
