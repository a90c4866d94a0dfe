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
family's complex output weights; the tempered ones in
``csrc/exchange_tempered.cu``) or its float64 instances in
``csrc/exchange_f64.cu``, which run every round in one launch; a CPU tensor
goes to ``exchange_plain``, the same computation in PyTorch.
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


def kernel_incidence(bonds: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``incidence_table`` of `bonds`, built once per bond tensor and n
    (``engine.memoised``: this thread's last table on the bonds' device is
    kept with its bonds and their version counter)."""
    return engine.memoised("kernel_incidence", (bonds,), lambda: incidence_table(bonds, n), n)


# The kernel's sources by (dtype, tempered): the library and its C launch function.
SOURCES = {
    (torch.float32, False): ("exchange", "nqs_exchange_f32"),
    (torch.float32, True): ("exchange_tempered", "nqs_exchange_f32"),
    (torch.float64, False): ("exchange_f64", "nqs_exchange_f64"),
    (torch.float64, True): ("exchange_f64_tempered", "nqs_exchange_f64"),
}


def _launcher(dtype: torch.dtype, tempered: bool):
    """The C launch function of the instances for ``dtype`` (float32 or
    float64) and n_beta > 1 (``tempered``); all share one interface
    (``csrc/exchange.cuh`` NQS_EXCHANGE_PARAMS), the float64 one followed by
    its table's two pointers."""
    name, symbol = SOURCES[dtype, tempered]
    fn = getattr(build.library(name), symbol)
    # the float64 instances read the table of engine.exchange_table_f64 after row0
    tables = [ctypes.c_void_p] * 2 if dtype == torch.float64 else []
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_int] + tables
    fn.restype = ctypes.c_int
    return fn


def _library():
    """The float32 n_beta = 1 library, which answers the layout queries."""
    lib = build.library("exchange")
    lib.nqs_exchange_lanes.argtypes = [ctypes.c_int]
    lib.nqs_exchange_stages_w.argtypes = [ctypes.c_int] * 5
    return lib


def kernel_lanes(h: int, dtype: torch.dtype = torch.float32) -> int:
    """The kernel's lanes per walker G at H hidden units, as it chooses: the
    float32 instances 8 at H <= 64, 16 at H <= 128, else 32; the float64
    ones 16 at H <= 128, else 32 (both measured at the Hubbard flagship,
    PERF.md)."""
    if dtype == torch.float64:
        lib = build.library("exchange_f64")
        lib.nqs_exchange_f64_lanes.argtypes = [ctypes.c_int]
        return lib.nqs_exchange_f64_lanes(h)
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
    ``tempered_exchange_plain``. Float32 walkers run ``csrc/exchange.cu``
    (n_beta = 1) or ``csrc/exchange_tempered.cu`` (counted in ``launches``,
    the tempered ones also in ``launches_tempered``), float64 walkers
    ``csrc/exchange_f64.cu`` (caller uniforms in float64 too; counted in
    ``launches_f64``, the tempered ones also in ``launches_f64_tempered``),
    which read ``engine.exchange_table_f64`` (built, and the weights' range
    checked, once per weight and bond tensor; weights past
    ``engine.F64_MAX_RE_W`` raise before any launch) and renew their factor
    state from y every ``n_unit`` proposals.

    `bonds` is a contiguous (B, 2) int32 tensor on the walkers' device with
    1 <= B <= N and entries in [0, N) (the kernel traps on an entry out of
    range). ``u_sel`` is an ``ExchangeDraws`` (the kernel draws on the chip)
    or the (n_steps, K) selection block beside ``u_acc`` (and for n_beta > 1
    the (n_sweeps, 2, K) ``swap_uniforms``). n_beta > 1 runs the tempered
    instance: sweeps of ``n_unit`` proposals, each followed by its two swap
    phases (n_unit None: the whole call one sweep). The complex ln psi of the final states is recomputed once from
    the final cache with the plain log-cosh, as in ``ops.sweep.sweep_cuda``.
    """
    k, n = cache.spins.shape
    h = work.w.shape[1]
    dev = cache.spins.device
    rdt = cache.spins.dtype
    if rdt not in (torch.float32, torch.float64):
        raise NotImplementedError(f"exchange kernel: float32 and float64 are ported, got {rdt}")
    cdt = torch.complex64 if rdt == torch.float32 else torch.complex128
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
    tensors, weights = engine.kernel_weights(work, cdt)
    tensors |= {
        "bonds": (bonds, torch.int32, (b, 2)),
        "spins": (cache.spins, rdt, (k, n)),
        "y": (cache.y, cdt, (k, h)),
        "sa": (cache.sa, cdt, (k,)),
    }
    if philox:
        tensors["key"] = (u_sel.key, torch.int64, (2,))
        uniforms = (None, None, None, u_sel.key.data_ptr())
    else:
        tensors["u_sel"] = (u_sel, rdt, (n_steps, k))
        tensors["u_acc"] = (u_acc, rdt, (n_steps, k))
        if n_beta > 1:
            tensors["swap_uniforms"] = (swap_uniforms, rdt, (n_sweeps, 2, k))
        uniforms = (u_sel.data_ptr(), u_acc.data_ptr(), swap_uniforms.data_ptr() if n_beta > 1 else None, None)
    row0 = u_sel.row0 if philox else 0
    build.check_inputs("exchange", dev, h, tensors, row0, k)
    # the float64 instances' table of e^{4 s (w_i - w_k)} per bond and per-site terms, inside their range
    tables = [t.data_ptr() for t in engine.exchange_table_f64(work, bonds)] if rdt == torch.float64 else []
    ptr, idx = kernel_incidence(bonds, n)
    spins = torch.empty_like(cache.spins)
    y = torch.empty_like(cache.y)
    sa = torch.empty_like(cache.sa)
    counts = torch.zeros((2, k), dtype=torch.int32, device=dev)  # row 1 written by the tempered instance only
    rc = build.launch(
        dev, _launcher(rdt, n_beta > 1), *weights, bonds.data_ptr(), ptr.data_ptr(), idx.data_ptr(),
        cache.spins.data_ptr(), cache.y.data_ptr(), cache.sa.data_ptr(), *uniforms,
        spins.data_ptr(), y.data_ptr(), sa.data_ptr(), counts[0].data_ptr(),
        counts[1].data_ptr() if n_beta > 1 else None, k, n, h, b, n_steps,
        n_steps // n_sweeps if n_unit is None or n_beta > 1 else n_unit, n_beta,
        torch.cuda.current_stream(dev).cuda_stream, row0, *tables,
    )
    build.check_launch(rc, "exchange kernel")
    if rdt == torch.float32:
        exchange_cuda.launches += 1
        exchange_cuda.launches_tempered += int(n_beta > 1)
        exchange_cuda.launches_tempered_c += int(n_beta > 1 and work.c is not None)
    else:
        exchange_cuda.launches_f64 += 1
        exchange_cuda.launches_f64_tempered += int(n_beta > 1)
    cache = Cache(spins=spins, y=y, sa=sa)
    return cache, engine.cache_log_psi(work, cache), counts.to(torch.float64)


exchange_cuda.launches = 0
exchange_cuda.launches_tempered = 0  # those of them of the tempered instance (n_beta > 1)
exchange_cuda.launches_tempered_c = 0  # those of the tempered instance with c
exchange_cuda.launches_f64 = 0  # the float64 instances' launches
exchange_cuda.launches_f64_tempered = 0  # those of them with n_beta > 1


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
