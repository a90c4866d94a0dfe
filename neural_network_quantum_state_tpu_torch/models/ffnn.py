"""Complex one-hidden-layer FFNN ansatze: plain, translation- and
spin-flip-symmetric.

    ln psi = sum_j w1o_j * logcosh(b1_j + sum_i wi1_ij s_i)

In the generic log-cosh Work the output weights become ``c`` and there is
no visible bias. The closed-form gradients are the JAX package's
``grad_log`` (held to it in tests/test_torch_models.py).
"""

from __future__ import annotations

import dataclasses

import torch

from neural_network_quantum_state_tpu_torch.models.base import Machine, Params
from neural_network_quantum_state_tpu_torch.models.rbm import _circulant_expand, _circulant_grad, _outer_rs
from neural_network_quantum_state_tpu_torch.ops.engine import Cache, Work
from neural_network_quantum_state_tpu_torch.ops.logcosh import logcosh, tanh


@dataclasses.dataclass(frozen=True)
class FFNN(Machine):
    """Flattened layout: [wi1 (N,M) row-major, b1 (M,), w1o (M,)]. Init:
    real plane ~ N(0, 1/fan), imaginary plane ~ 0.1 N(0, 1/fan)."""

    n_hiddens: int = 0

    @property
    def n_vars(self) -> int:
        return self.n_inputs * self.n_hiddens + 2 * self.n_hiddens

    @property
    def n_hidden(self) -> int:
        return self.n_hiddens

    def param_spec(self):
        n, m = self.n_inputs, self.n_hiddens
        return [("wi1", (n, m)), ("b1", (m,)), ("w1o", (m,))]

    def init_params(self, g: torch.Generator) -> Params:
        n, m = self.n_inputs, self.n_hiddens
        sw, sb = (1.0 / (n + m)) ** 0.5, (1.0 / m) ** 0.5
        return {
            "wi1": self._normal(g, (n, m), sw, imag_scale=0.1 * sw),
            "b1": self._normal(g, (m,), sb, imag_scale=0.1 * sb),
            "w1o": self._normal(g, (m,), sb, imag_scale=0.1 * sb),
        }

    def make_work(self, params: Params) -> Work:
        return Work(w=params["wi1"], b=params["b1"], c=params["w1o"])

    def grad_log(self, params: Params, cache: Cache) -> torch.Tensor:
        k = cache.spins.shape[0]
        t = tanh(cache.y) * params["w1o"]  # (K, M)
        return torch.cat([_outer_rs(cache.spins, t).reshape(k, -1), t, logcosh(cache.y)], dim=-1)

    # Hidden-subset training: only the hidden units J train. Layout, as the
    # JAX package's: wi1 per node ([wi1_0j0, wi1_1j0, ..., wi1_0j1, ...]),
    # then b1_J, then w1o_J.
    def grad_log_partial(self, params: Params, cache: Cache, hidden_nodes) -> torch.Tensor:
        nodes = torch.as_tensor(hidden_nodes, dtype=torch.long, device=cache.spins.device)
        k = cache.spins.shape[0]
        y_sub = cache.y[:, nodes]
        t = tanh(y_sub) * params["w1o"][nodes]  # (K, |J|)
        d_dwi1 = _outer_rs(cache.spins, t).transpose(1, 2).reshape(k, -1)
        return torch.cat([d_dwi1, t, logcosh(y_sub)], dim=-1)

    def update_params_partial(self, params: Params, dx: torch.Tensor, lr: float, hidden_nodes) -> Params:
        """theta_J <- theta_J - lr * dx for the hidden subset J only."""
        nodes = torch.as_tensor(hidden_nodes, dtype=torch.long, device=dx.device)
        n, nj = self.n_inputs, nodes.shape[0]
        dwi1 = dx[: n * nj].reshape(nj, n)  # per-node rows
        return {
            "wi1": params["wi1"].index_add(1, nodes, -lr * dwi1.T),
            "b1": params["b1"].index_add(0, nodes, -lr * dx[n * nj : n * nj + nj]),
            "w1o": params["w1o"].index_add(0, nodes, -lr * dx[n * nj + nj :]),
        }


@dataclasses.dataclass(frozen=True)
class FFNNTrSymm(Machine):
    """Translation-symmetric FFNN: flattened layout [wi1 (alpha,N), b1
    (alpha,), w1o (alpha,)]; H = alpha*N, h = f*N + j; wi1 circulant, b1 and
    w1o broadcast over each filter's N units."""

    alpha: int = 1

    @property
    def n_vars(self) -> int:
        return self.alpha * self.n_inputs + 2 * self.alpha

    @property
    def n_hidden(self) -> int:
        return self.alpha * self.n_inputs

    def param_spec(self):
        return [("wi1", (self.alpha, self.n_inputs)), ("b1", (self.alpha,)), ("w1o", (self.alpha,))]

    def init_params(self, g: torch.Generator) -> Params:
        n, al = self.n_inputs, self.alpha
        sw, sb = (1.0 / ((1 + al) * n)) ** 0.5, (1.0 / (al * n)) ** 0.5
        return {
            "wi1": self._normal(g, (al, n), sw, imag_scale=0.1 * sw),
            "b1": self._normal(g, (al,), sb, imag_scale=0.1 * sb),
            "w1o": self._normal(g, (al,), sb, imag_scale=0.1 * sb),
        }

    def make_work(self, params: Params) -> Work:
        n = self.n_inputs
        return Work(
            w=_circulant_expand(params["wi1"], n),
            b=params["b1"].repeat_interleave(n),
            c=params["w1o"].repeat_interleave(n),
        )

    def grad_log(self, params: Params, cache: Cache) -> torch.Tensor:
        k, n, al = cache.spins.shape[0], self.n_inputs, self.alpha
        tw = tanh(cache.y).reshape(k, al, n) * params["w1o"][None, :, None]
        d_dwi1 = _circulant_grad(tw, cache.spins)  # (K, alpha, N)
        d_dw1o = logcosh(cache.y).reshape(k, al, n).sum(-1)
        return torch.cat([d_dwi1.reshape(k, -1), tw.sum(-1), d_dw1o], dim=-1)


@dataclasses.dataclass(frozen=True)
class FFNNSfSymm(Machine):
    """Spin-flip symmetric FFNN: no bias; flattened layout [wi1 (N, alpha*N)
    row-major, w1o (alpha*N,)]."""

    alpha: int = 1

    @property
    def n_vars(self) -> int:
        n = self.n_inputs
        return self.alpha * n * n + self.alpha * n

    @property
    def n_hidden(self) -> int:
        return self.alpha * self.n_inputs

    def param_spec(self):
        n, h = self.n_inputs, self.alpha * self.n_inputs
        return [("wi1", (n, h)), ("w1o", (h,))]

    def init_params(self, g: torch.Generator) -> Params:
        n, al = self.n_inputs, self.alpha
        sw, so = (1.0 / ((1 + al) * n)) ** 0.5, (1.0 / (al * n)) ** 0.5
        return {
            "wi1": self._normal(g, (n, al * n), sw, imag_scale=0.1 * sw),
            "w1o": self._normal(g, (al * n,), so, imag_scale=0.1 * so),
        }

    def make_work(self, params: Params) -> Work:
        w = params["wi1"]
        return Work(w=w, b=self._zeros((w.shape[1],), w.device), c=params["w1o"])

    def grad_log(self, params: Params, cache: Cache) -> torch.Tensor:
        k = cache.spins.shape[0]
        t = tanh(cache.y) * params["w1o"]
        return torch.cat([_outer_rs(cache.spins, t).reshape(k, -1), logcosh(cache.y)], dim=-1)
