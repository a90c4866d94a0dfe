"""Complex RBM ansatze: plain, translation-, spin-flip- and
Z2(x)parity-symmetric.

All expand to the generic log-cosh Work (the last two without a visible
bias); the closed-form gradients are the JAX package's ``grad_log`` (held
to it in tests/test_torch_ops.py and tests/test_torch_models.py).
"""

from __future__ import annotations

import dataclasses

import torch

from neural_network_quantum_state_tpu_torch.models.base import Machine, Params
from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work
from neural_network_quantum_state_tpu_torch.ops.logcosh import tanh


def _circulant_expand(w_raw: torch.Tensor, n: int) -> torch.Tensor:
    """Expand per-filter rings w_raw (alpha, N) into W (N, alpha*N):
    wf[i, f*N+j] = w_raw[f, (i+j) % N]."""
    ar = torch.arange(n, device=w_raw.device)
    idx = (ar[:, None] + ar[None, :]) % n  # (i, j)
    return w_raw[:, idx].permute(1, 0, 2).reshape(n, -1)


def _circulant_grad(t: torch.Tensor, spins: torch.Tensor) -> torch.Tensor:
    """d/dw_raw[f,m] = sum_j t[k,f,j] * s[k, (N+m-j) % N] -> (K, alpha, N) complex.

    A batched circular cross-correlation as a gather plus one real batched
    product over both planes of t (the spin factor is real).
    """
    k, al, n = t.shape
    ar = torch.arange(n, device=spins.device)
    sg = spins[:, (ar[:, None] - ar[None, :]) % n]  # (K, N_m, N_j) real
    planes = torch.cat([t.real, t.imag], dim=1)  # (K, 2*alpha, N_j)
    r = torch.bmm(planes, sg.transpose(1, 2))  # (K, 2*alpha, N_m)
    return torch.complex(r[:, :al], r[:, al:])


def _outer_rs(s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """d_dw[k,i,j] = s[k,i] * t[k,j] (real spins x complex factor)."""
    return s[:, :, None] * t[:, None, :]


@dataclasses.dataclass(frozen=True)
class RBM(Machine):
    """Vanilla complex RBM: ln psi = sum_i a_i s_i + sum_j logcosh(b_j + W.s).

    Flattened layout: [w (N,M) row-major, a (N,), b (M,)].
    """

    n_hiddens: int = 0

    @property
    def n_vars(self) -> int:
        n, m = self.n_inputs, self.n_hiddens
        return n * m + n + m

    @property
    def n_hidden(self) -> int:
        return self.n_hiddens

    def param_spec(self):
        n, m = self.n_inputs, self.n_hiddens
        return [("w", (n, m)), ("a", (n,)), ("b", (m,))]

    def init_params(self, g: torch.Generator) -> Params:
        n, m = self.n_inputs, self.n_hiddens
        # w ~ 0.1*N(0, 1/(N+M)); a = 0; b ~ 0.1*N(0, 1/M)
        return {
            "w": self._normal(g, (n, m), 0.1 * (1.0 / (n + m)) ** 0.5),
            "a": self._zeros((n,), g.device),
            "b": self._normal(g, (m,), 0.1 * (1.0 / m) ** 0.5),
        }

    def make_work(self, params: Params) -> Work:
        return Work(w=params["w"], b=params["b"], a=params["a"])

    def grad_log(self, params: Params, cache: Cache) -> torch.Tensor:
        k = cache.spins.shape[0]
        s = cache.spins
        t = tanh(cache.y)  # (K, M)
        d_dw = _outer_rs(s, t)  # (K, N, M)
        d_da = torch.complex(s, torch.zeros_like(s))
        return torch.cat([d_dw.reshape(k, -1), d_da, t], dim=-1)

    # Hidden-subset training: only the hidden units J train. Layout
    # [a (all N), b_J, w_{i,J} row-major over i], as the JAX package's.
    def grad_log_partial(self, params: Params, cache: Cache, hidden_nodes) -> torch.Tensor:
        nodes = torch.as_tensor(hidden_nodes, dtype=torch.long, device=cache.spins.device)
        k, s = cache.spins.shape[0], cache.spins
        t = tanh(cache.y[:, nodes])  # (K, |J|)
        d_da = torch.complex(s, torch.zeros_like(s))
        return torch.cat([d_da, t, _outer_rs(s, t).reshape(k, -1)], dim=-1)

    def update_params_partial(self, params: Params, dx: torch.Tensor, lr: float, hidden_nodes) -> Params:
        """theta_J <- theta_J - lr * dx for the hidden subset J (and all of a)."""
        nodes = torch.as_tensor(hidden_nodes, dtype=torch.long, device=dx.device)
        n, nj = self.n_inputs, nodes.shape[0]
        return {
            "a": params["a"] - dx[:n] * lr,
            "b": params["b"].index_add(0, nodes, -lr * dx[n : n + nj]),
            "w": params["w"].index_add(1, nodes, -lr * dx[n + nj :].reshape(n, nj)),
        }


@dataclasses.dataclass(frozen=True)
class RBMTrSymm(Machine):
    """Translation-symmetric RBM (PBC): alpha filters, shared visible bias.

    Flattened layout: [w (alpha,N), a (1,), b (alpha,)]; H = alpha*N with
    hidden index h = f*N + j.
    """

    alpha: int = 1

    @property
    def n_vars(self) -> int:
        return self.alpha * self.n_inputs + 1 + self.alpha

    @property
    def n_hidden(self) -> int:
        return self.alpha * self.n_inputs

    def param_spec(self):
        return [("w", (self.alpha, self.n_inputs)), ("a", (1,)), ("b", (self.alpha,))]

    def init_params(self, g: torch.Generator) -> Params:
        n, al = self.n_inputs, self.alpha
        return {
            "w": self._normal(g, (al, n), 0.1 * (1.0 / ((1 + al) * n)) ** 0.5),
            "a": self._zeros((1,), g.device),
            "b": self._normal(g, (al,), 0.1 * (1.0 / (al * n)) ** 0.5),
        }

    def make_work(self, params: Params) -> Work:
        n = self.n_inputs
        wf = _circulant_expand(params["w"], n)
        bf = params["b"].repeat_interleave(n)  # bf[f*N+j] = b[f]
        af = params["a"].repeat(n)
        return Work(w=wf, b=bf, a=af)

    def grad_log(self, params: Params, cache: Cache) -> torch.Tensor:
        k, n, al = cache.spins.shape[0], self.n_inputs, self.alpha
        t = tanh(cache.y).reshape(k, al, n)
        d_dw = _circulant_grad(t, cache.spins)  # (K, alpha, N)
        ssum = cache.spins.sum(-1, keepdim=True)
        d_da = torch.complex(ssum, torch.zeros_like(ssum))
        d_db = t.sum(-1)  # (K, alpha)
        return torch.cat([d_dw.reshape(k, -1), d_da, d_db], dim=-1)


@dataclasses.dataclass(frozen=True)
class RBMSfSymm(Machine):
    """Spin-flip symmetric RBM: no biases at all, psi(s) = psi(-s).

    Flattened layout: [w (N, alpha*N) row-major].
    """

    alpha: int = 1

    @property
    def n_vars(self) -> int:
        return self.alpha * self.n_inputs * self.n_inputs

    @property
    def n_hidden(self) -> int:
        return self.alpha * self.n_inputs

    def param_spec(self):
        return [("w", (self.n_inputs, self.alpha * self.n_inputs))]

    def init_params(self, g: torch.Generator) -> Params:
        n, al = self.n_inputs, self.alpha
        return {"w": self._normal(g, (n, al * n), 0.1 * (1.0 / ((1 + al) * n)) ** 0.5)}

    def make_work(self, params: Params) -> Work:
        w = params["w"]
        return Work(w=w, b=self._zeros((w.shape[1],), w.device))

    def grad_log(self, params: Params, cache: Cache) -> torch.Tensor:
        return _outer_rs(cache.spins, tanh(cache.y)).reshape(cache.spins.shape[0], -1)


@dataclasses.dataclass(frozen=True)
class RBMZ2PrSymm(Machine):
    """Z2 (x) parity symmetric RBM for the OBC long-range Ising chain.

    Each of alpha filters expands into 4 hidden units (+w, -w, +reflected w,
    -reflected w; reflection i -> N-1-i), no visible bias. Flattened layout:
    [w (N, alpha) row-major, b (alpha,)]; H = 4*alpha with h = f*4 + j.
    """

    alpha: int = 1

    @property
    def n_vars(self) -> int:
        return self.n_inputs * self.alpha + self.alpha

    @property
    def n_hidden(self) -> int:
        return 4 * self.alpha

    def param_spec(self):
        return [("w", (self.n_inputs, self.alpha)), ("b", (self.alpha,))]

    def init_params(self, g: torch.Generator) -> Params:
        n, al = self.n_inputs, self.alpha
        return {
            "w": self._normal(g, (n, al), 0.1 * (1.0 / (4 * al + n)) ** 0.5),
            "b": self._normal(g, (al,), 0.1 * (1.0 / (4 * al)) ** 0.5),
        }

    def make_work(self, params: Params) -> Work:
        n, al = self.n_inputs, self.alpha
        w = params["w"]  # (N, alpha)
        wr = w.flip(0)
        wf = torch.stack([w, -w, wr, -wr], dim=-1)  # (N, alpha, 4)
        bf = params["b"][:, None].expand(al, 4)
        return Work(w=wf.reshape(n, 4 * al), b=bf.reshape(4 * al))

    def grad_log(self, params: Params, cache: Cache) -> torch.Tensor:
        k, al = cache.spins.shape[0], self.alpha
        s = cache.spins  # (K, N) real
        t = tanh(cache.y).reshape(k, al, 4)
        d01 = t[:, :, 0] - t[:, :, 1]  # (K, alpha)
        d23 = t[:, :, 2] - t[:, :, 3]
        d_dw = _outer_rs(s, d01) + _outer_rs(s.flip(1), d23)  # (K, N, alpha)
        return torch.cat([d_dw.reshape(k, -1), t.sum(-1)], dim=-1)
