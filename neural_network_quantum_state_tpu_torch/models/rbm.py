"""Complex RBM ansatze: plain and translation-symmetric.

Both expand to the generic log-cosh Work; the closed-form gradients are the
JAX package's ``grad_log`` (held to it in tests/test_torch_ops.py).
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
        d_dw = s[:, :, None] * t[:, None, :]  # (K, N, M)
        d_da = torch.complex(s, torch.zeros_like(s))
        return torch.cat([d_dw.reshape(k, -1), d_da, t], dim=-1)


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
