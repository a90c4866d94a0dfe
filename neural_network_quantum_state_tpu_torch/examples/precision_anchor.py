"""The paper's precision anchor on the port: mixed-precision LITFI training
held to exact diagonalization at the largest ED-checkable sizes.

The model is the paper's (theta = 2, alpha_J = 2.5; J = sin theta,
h = -cos theta, a per-site 1/L scale and the PBC circular distance), the
ansatz RBMTrSymm(N, alpha = 4), K = 8192 walkers, float32 sampling and
local energies with a float64 SR solve. The bar is a relative energy error
of 1e-4 against exact diagonalization. Stages (the ED ones on the host CPU,
the training on the card unless given ``--device cpu``):

    python -m neural_network_quantum_state_tpu_torch.examples.precision_anchor ed 20
    python -m neural_network_quantum_state_tpu_torch.examples.precision_anchor ed_sector 28
    python -m neural_network_quantum_state_tpu_torch.examples.precision_anchor train 20 [seed]
    python -m neural_network_quantum_state_tpu_torch.examples.precision_anchor report

Each stage writes ``precision_anchor_{ed,vmc}_N{n}.json`` into ``--out``;
``report`` prints the relative errors beside the JAX package's recorded
ones (``logs/precision_anchor_*.json``, read only).
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np

from neural_network_quantum_state_tpu_torch.examples import REPO, common_args

THETA = 2.0
ALPHA_J = 2.5
ALPHA = 4  # RBMTrSymm filters: H = 4N
N_WALKERS = 8192
CHUNK = 1 << 20
BAR = 1e-4
# The training protocol: warm-up sweeps, then SR stages of (steps, learning
# rate), and the mean energy of the last TAIL steps. The deep-ordered
# theta = 2 state converges into an SR noise floor at a fixed rate; the
# staged decay walks under the bar at N = 20 to 28 in the JAX record.
WARM_SWEEPS = 500
STAGES = ((3000, 2e-2), (3000, 5e-3), (2000, 2e-3))
TAIL = 1000
SEED = 11


def _j_matrix(n: int) -> np.ndarray:
    i, k = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    d = np.abs(i - k).astype(np.float64)
    d = np.minimum(d, n - d)  # PBC circular distance
    with np.errstate(divide="ignore"):
        jm = math.sin(THETA) * d**-ALPHA_J
    np.fill_diagonal(jm, 0.0)
    return jm


def _diagonal(states: np.ndarray, n: int, jm: np.ndarray) -> np.ndarray:
    """(0.5/n) s.J.s of the basis states (indices) given, in chunks."""
    out = np.empty(states.size, np.float64)
    for lo in range(0, states.size, CHUNK):
        hi = min(lo + CHUNK, states.size)
        bits = (states[lo:hi, None].astype(np.int64) >> np.arange(n)[None, :]) & 1
        s = 1.0 - 2.0 * bits
        out[lo:hi] = (0.5 / n) * np.einsum("ki,ki->k", s @ jm, s)
    return out


def _write(out: str, name: str, record: dict) -> None:
    with open(os.path.join(out, name), "w") as f:
        json.dump(record, f)
    print(json.dumps(record), flush=True)


def lanczos_e0(n: int, jm: np.ndarray) -> float:
    """The per-site ground energy of the chain with couplings ``jm`` and the
    anchor's transverse field, by matrix-free Lanczos on the full 2^n space
    with a chunk-computed diagonal. The transverse term flips bit b of every
    index: a reversal of the middle axis of v viewed as (2^(n-b-1), 2, 2^b),
    so no flip tables are held (N = 24 keeps the 2^24 float64 diagonal and
    three vectors)."""
    from scipy.sparse.linalg import LinearOperator, eigsh

    dim = 1 << n
    diag = _diagonal(np.arange(dim), n, jm)
    hn = -math.cos(THETA) / n

    def matvec(v):
        v = np.ascontiguousarray(v, dtype=np.float64).reshape(dim)
        res = diag * v
        hv = hn * v
        for b in range(n):
            res.reshape(-1, 2, 1 << b)[...] += hv.reshape(-1, 2, 1 << b)[:, ::-1, :]
        return res

    op = LinearOperator((dim, dim), matvec=matvec, dtype=np.float64)
    return float(eigsh(op, k=1, which="SA", tol=1e-10, return_eigenvectors=False)[0])


def run_ed(n: int, out: str) -> float:
    """Exact per-site ground energy on the full 2^n space (``lanczos_e0``)."""
    t0 = time.time()
    e0 = lanczos_e0(n, _j_matrix(n))
    _write(out, f"precision_anchor_ed_N{n}.json",
           {"n": n, "theta": THETA, "alpha": ALPHA_J, "e0": e0, "seconds": round(time.time() - t0, 1)})
    return e0


def run_ed_sector(n: int, out: str) -> float:
    """Exact per-site ground energy by Lanczos in the k = 0 translation
    sector, which holds the unique (h != 0) translation-symmetric ground
    state: one basis state per orbit of the translation T, ~2^N/N of them.

    Basis: the representative a = the least rotation of each orbit,
    |a> = N_a^{-1/2} sum_{s in orbit(a)} |s>, N_a the orbit's size (a's
    period under T). The diagonal is orbit-invariant; the transverse term
    h_n sum_i X_i has <b|H_x|a> = h_n sqrt(N_a/N_b) summed over the flips of
    a that land in orbit(b) (translation covariance makes that count
    uniform over the orbit), Hermitian as N_a m_ab = N_b m_ba."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.linalg import LinearOperator, eigsh

    t0 = time.time()
    dim = 1 << n
    mask = np.uint32(dim - 1)
    hn = -math.cos(THETA) / n

    def rotate(x, d):
        return ((x << np.uint32(d)) | (x >> np.uint32(n - d))) & mask

    canon = np.empty(dim, np.uint32)  # the least rotation of every state
    for lo in range(0, dim, CHUNK):
        x = np.arange(lo, min(lo + CHUNK, dim), dtype=np.uint32)
        c, r = x.copy(), x
        for _ in range(n - 1):
            r = rotate(r, 1)
            np.minimum(c, r, out=c)
        canon[lo:lo + x.size] = c
    reps = np.concatenate([lo + np.flatnonzero(canon[lo:lo + CHUNK] == np.arange(lo, min(lo + CHUNK, dim)))
                           for lo in range(0, dim, CHUNK)]).astype(np.uint32)
    period = np.full(reps.size, n, np.int64)  # the least divisor d of n with T^d a = a
    for d in range(1, n):
        if n % d == 0:
            hit = rotate(reps, d) == reps
            period[hit] = np.minimum(period[hit], d)
    diag = _diagonal(reps, n, _j_matrix(n))

    sq = np.sqrt(period.astype(np.float64))
    cols = np.arange(reps.size, dtype=np.int64)
    rows_parts, data_parts = [], []
    for b in range(n):  # one entry per (representative, flipped bit)
        j = np.searchsorted(reps, canon[reps ^ np.uint32(1 << b)]).astype(np.int64)
        rows_parts.append(j)
        data_parts.append(hn * sq / sq[j])
    del canon
    hx = csr_matrix((np.concatenate(data_parts), (np.concatenate(rows_parts), np.tile(cols, n))),
                    shape=(reps.size, reps.size))
    del rows_parts, data_parts

    op = LinearOperator((reps.size, reps.size), matvec=lambda v: diag * v.ravel() + hx @ v.ravel(), dtype=np.float64)
    e0 = float(eigsh(op, k=1, which="SA", tol=1e-10, return_eigenvectors=False)[0])
    _write(out, f"precision_anchor_ed_N{n}.json",
           {"n": n, "theta": THETA, "alpha": ALPHA_J, "e0": e0, "sector": "k=0 translation",
            "n_orbits": int(reps.size), "seconds": round(time.time() - t0, 1)})
    return e0


def train(n: int, seed: int = SEED, device: str = "cuda", n_walkers: int = N_WALKERS, warm_sweeps: int = WARM_SWEEPS,
          stages=STAGES, dtype=None):
    """Mixed-precision training (float32 sampling and local energies, the
    float64 SR solve, 50 steps a host loop) in learning-rate stages; with
    ``dtype=torch.float64`` a float64 machine instead (every part in
    float64). On the card every sampler call is one launch of the sweep
    kernel and every step one of the energy kernel. Returns (machine,
    hamiltonian, params, state, the history of each stage, warm-up
    seconds, SR seconds)."""
    import dataclasses

    import torch

    from neural_network_quantum_state_tpu_torch import VMC, VMCConfig
    from neural_network_quantum_state_tpu_torch.hamiltonians import LITFIChain
    from neural_network_quantum_state_tpu_torch.models import RBMTrSymm

    t0 = time.time()
    machine = RBMTrSymm(n_inputs=n, alpha=ALPHA, dtype=torch.float32 if dtype is None else dtype)
    ham = LITFIChain(n_sites=n, h=-math.cos(THETA), j=math.sin(THETA), alpha=ALPHA_J, pbc=True)
    cfg = VMCConfig(n_walkers=n_walkers, learning_rate=stages[0][1], solver="cg", solve_dtype=torch.float64,
                    steps_per_host_loop=50, seed=seed)
    vmc = VMC(machine, ham, cfg, device=device)
    params, state = vmc.init()
    state = vmc.warm_up(params, state, warm_sweeps)
    if device != "cpu":
        torch.cuda.synchronize()
    t_warm = time.time() - t0
    step, run_s, histories = 0, 0.0, []
    for n_steps, lr in stages:
        stage = VMC(machine, ham, dataclasses.replace(cfg, learning_rate=lr), device=device)
        params, state, history, elapsed = stage.run(params, state, n_steps, start_step=step)
        step += n_steps
        run_s += elapsed
        histories.append(history)
    return machine, ham, params, state, histories, t_warm, run_s


def run_train(n: int, out: str, seed: int = SEED, device: str = "cuda", n_walkers: int = N_WALKERS,
              warm_sweeps: int = WARM_SWEEPS, stages=STAGES, tail: int = TAIL) -> dict:
    """``train`` and the mean energy of the last ``tail`` steps, with each
    stage's mean over its last 100 steps. Returns the record written."""
    import torch

    t0 = time.time()
    *_, histories, t_warm, run_s = train(n, seed, device, n_walkers, warm_sweeps, stages)
    energies = [h["energy"] for h in histories[-1][-tail:]]
    steps = sum(len(h) for h in histories)
    record = {"n": n, "theta": THETA, "alpha": ALPHA_J, "e_vmc": float(np.mean(energies)),
              "sem": float(np.std(energies) / math.sqrt(len(energies))), "n_iter": steps, "seed": seed,
              "n_walkers": n_walkers, "stages": [list(s) for s in stages], "tail": tail,
              "stage_means": [float(np.mean([h["energy"] for h in hist[-100:]])) for hist in histories],
              "device": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
              "step_ms": 1e3 * run_s / steps, "warm_up_s": round(t_warm, 3), "seconds": round(time.time() - t0, 1)}
    _write(out, f"precision_anchor_vmc_N{n}.json", record)
    return record


def variational_energy(machine, ham, params, chunk: int = 1 << 16) -> float:
    """The exact <H> of the ansatz at ``params`` (per site), by enumeration
    of its 2^N configurations in float64 on the parameters' device: the
    trained state's own energy, free of sampling noise."""
    import torch

    from neural_network_quantum_state_tpu_torch.ops import engine

    n = machine.n_inputs
    device = next(iter(params.values())).device
    work = machine.make_work({k: v.to(torch.complex128) for k, v in params.items()})
    num = den = 0.0
    ln_max = None
    parts = []
    for lo in range(0, 1 << n, chunk):
        idx = torch.arange(lo, min(lo + chunk, 1 << n), device=device)
        spins = 1.0 - 2.0 * ((idx[:, None] >> torch.arange(n, device=device)[None, :]) & 1).to(torch.float64)
        cache, lnpsi = engine.full_forward(work, spins)
        parts.append((lnpsi.real, ham.local_energy(work, cache, lnpsi).real))
        m = float(lnpsi.real.max())
        ln_max = m if ln_max is None else max(ln_max, m)
    for ln_re, e_loc in parts:
        p = torch.exp(2.0 * (ln_re - ln_max))
        num += float((p * e_loc).sum())
        den += float(p.sum())
    return num / den


def recorded(n: int) -> dict | None:
    """The JAX package's recorded stage outputs at size n ({"e0", "e_vmc",
    "rel_err"} as far as they exist), from ``logs/``; None without them."""
    rec = {}
    for stage, key in (("ed", "e0"), ("vmc", "e_vmc")):
        path = os.path.join(REPO, "logs", f"precision_anchor_{stage}_N{n}.json")
        if os.path.exists(path):
            with open(path) as f:
                rec[key] = json.load(f)[key]
    if "e0" in rec and "e_vmc" in rec:
        rec["rel_err"] = abs(rec["e_vmc"] - rec["e0"]) / abs(rec["e0"])
    return rec or None


def report(out: str) -> list[dict]:
    """Relative errors of every size with both stages in ``out``, beside
    the JAX record; written to ``precision_anchor_report.json``."""
    rows = []
    for n in (20, 24, 28, 30):
        try:
            with open(os.path.join(out, f"precision_anchor_ed_N{n}.json")) as f:
                ed = json.load(f)
            with open(os.path.join(out, f"precision_anchor_vmc_N{n}.json")) as f:
                vmc = json.load(f)
        except FileNotFoundError as e:
            print(f"N={n}: missing stage output ({e.filename})")
            continue
        rel = abs(vmc["e_vmc"] - ed["e0"]) / abs(ed["e0"])
        jax = recorded(n) or {}
        rows.append({"n": n, "e0": ed["e0"], "e_vmc": vmc["e_vmc"], "rel_err": rel, "pass_1e-4": rel <= BAR,
                     "device": vmc.get("device"), "step_ms": vmc.get("step_ms"), "jax_e0": jax.get("e0"),
                     "jax_e_vmc": jax.get("e_vmc"), "jax_rel_err": jax.get("rel_err")})
        jax_txt = (f"; JAX record E0={jax['e0']:.8f} VMC={jax['e_vmc']:.8f} rel_err={jax['rel_err']:.3g}"
                   if "rel_err" in jax else "")
        print(f"N={n}: E0={ed['e0']:.8f}  VMC={vmc['e_vmc']:.8f}  rel_err={rel:.3g}  "
              f"{'PASS' if rel <= BAR else 'FAIL'} (bar {BAR:g}){jax_txt}")
    if rows:
        with open(os.path.join(out, "precision_anchor_report.json"), "w") as f:
            json.dump(rows, f, indent=1)
    return rows


def main(argv=None) -> None:
    ns, rest = common_args(sys.argv[1:] if argv is None else argv, __doc__.splitlines()[0])
    stage = rest[0] if rest else "report"
    if stage == "ed":
        run_ed(int(rest[1]), ns.out)
    elif stage == "ed_sector":
        run_ed_sector(int(rest[1]), ns.out)
    elif stage == "train":
        run_train(int(rest[1]), ns.out, seed=int(rest[2]) if len(rest) > 2 else SEED, device=ns.device)
    elif stage == "report":
        report(ns.out)
    else:
        raise SystemExit(f"precision_anchor: unknown stage {stage!r} (ed, ed_sector, train, report)")


if __name__ == "__main__":
    main()
