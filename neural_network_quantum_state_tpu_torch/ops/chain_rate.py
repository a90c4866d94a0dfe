"""The hot-math chain-rate probe: CUDA kernel and plain version.

A chain applies a body ``chain_len`` times as a dependent chain to each
element of x and y (float32, the same shape): ``"sweep"``, the sweep
kernel's per-(site, hidden unit) arithmetic (the candidate move, Re ln cosh
from one cos, a mix that keeps the chain bounded and dependent), or
``"energy"``, the energy kernel's (the angle addition, both planes of ln
cosh with the atan2 phase, the same mix). These are the bodies of the JAX
package's benchmark (``bench.py::_sweep_hot_body``, ``_energy_hot_body``).
``chain_cuda`` launches the kernel in ``csrc/chain_rate.cu`` on CUDA
tensors; it runs rbm.cuh's fast arithmetic, the device functions of the
sweep and energy kernels. ``chain_plain`` is the same chain in PyTorch, with
its exp, log, cos and atan2 (``ops/logcosh.py``), on any device.
``chain_rate`` times the kernel: the elements per second the card sustains
on that math alone, the yardstick beside which the port's benchmark puts
its kernels' element rates.

Replaces the TPU kernel ``bench.py::_vpu_chain_rate_f32.<locals>.kernel``.
"""

from __future__ import annotations

import ctypes

import torch

from neural_network_quantum_state_tpu_torch.ops import build
from neural_network_quantum_state_tpu_torch.ops.logcosh import BRANCH_CUT_TOL, logcosh_re_cos, logcosh_ri_cs

BODIES = ("sweep", "energy")
# bench.py's probe: 2^22 elements as (16384, 256) float32, 32 bodies a chain
N_ELEMS, CHAIN_LEN = 1 << 22, 32
# the energy body's stand-ins for (cos 2w, sin 2w)
_C2, _S2 = 0.8253356149096783, 0.5646424733950354


def _body(body: str, x: torch.Tensor, y: torch.Tensor):
    """One application: (x', y', the phase Im ln cosh or None)."""
    x1 = x - 0.6 * y  # the candidate y' = y - 2 s w
    if body == "sweep":
        r = logcosh_re_cos(x1, torch.cos(y))
        return 0.25 * r + 0.1 * x, 0.99 * y + 0.01 * x1, None
    c1 = y * _C2 + x * _S2  # the angle addition (cos/sin stand-ins)
    s1 = x * _C2 - y * _S2
    lre, lim = logcosh_ri_cs(x1, c1, s1)
    return 0.2 * lre + 0.1 * x, 0.2 * lim + 0.9 * y, lim


def _check_body(body: str) -> None:
    if body not in BODIES:
        raise ValueError(f"chain: body must be one of {BODIES}, got {body!r}")


def chain_plain(body: str, x: torch.Tensor, y: torch.Tensor, chain_len: int = CHAIN_LEN):
    """Plain PyTorch chain: ``chain_len`` applications of ``body``; returns
    (x, y)."""
    _check_body(body)
    chain_plain.calls += 1
    for _ in range(chain_len):
        x, y, _ = _body(body, x, y)
    return x, y


chain_plain.calls = 0


def chain_near_cut(body: str, x: torch.Tensor, y: torch.Tensor, chain_len: int = CHAIN_LEN) -> torch.Tensor:
    """Which elements' plain chain takes a phase within ``BRANCH_CUT_TOL`` of
    pi (the energy body's principal atan2): there two float32 evaluations may
    land on opposite sides of the cut, the phase jumps by 2 pi and the chains
    part, as ln psi does for walkers near the cut. All False for the sweep
    body, which has no phase."""
    _check_body(body)
    near = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    for _ in range(chain_len if body == "energy" else 0):
        x, y, lim = _body(body, x, y)
        near |= lim.abs() > torch.pi - BRANCH_CUT_TOL
    return near


def _library():
    fn = build.library("chain_rate").nqs_chain_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def chain_cuda(body: str, x: torch.Tensor, y: torch.Tensor, chain_len: int = CHAIN_LEN):
    """Launch the probe kernel on contiguous float32 CUDA tensors x and y of
    one shape (fewer than 2^31 elements); returns (x, y) after the chain."""
    _check_body(body)
    if chain_len < 0:
        raise ValueError(f"chain: chain_len {chain_len} < 0")
    n = x.numel()
    build.check_inputs("chain_rate", x.device, 1, {"x": (x, torch.float32, tuple(x.shape)),
                                                    "y": (y, torch.float32, tuple(x.shape))})
    if not 0 < n < 2**31:
        raise ValueError(f"chain kernel: {n} elements, not in [1, 2^31)")
    x_out, y_out = torch.empty_like(x), torch.empty_like(y)
    rc = build.launch(x.device, _library(), x.data_ptr(), y.data_ptr(), x_out.data_ptr(), y_out.data_ptr(), n,
                      chain_len, BODIES.index(body), torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(rc, "chain kernel")
    chain_cuda.launches += 1
    return x_out, y_out


chain_cuda.launches = 0


def probe_inputs(n_elems: int = N_ELEMS, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """bench.py's probe inputs: x = linspace(-3, 3), y = linspace(-2, 2), as
    (n_elems / 256, 256) float32."""
    lanes = 256
    shape = (n_elems // lanes, lanes)
    x = torch.linspace(-3.0, 3.0, n_elems, dtype=torch.float32, device=device).reshape(shape)
    y = torch.linspace(-2.0, 2.0, n_elems, dtype=torch.float32, device=device).reshape(shape)
    return x, y


def chain_rate(body: str, n_elems: int = N_ELEMS, chain_len: int = CHAIN_LEN, device="cuda", reps: int = 3) -> float:
    """Elements per second of the kernel's chain on bench.py's inputs:
    n_elems * chain_len * reps over the time of ``reps`` launches after one
    warm launch, timed with CUDA events. A device rate: it needs the card."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"chain_rate: the probe's rate is the card's; got device {device}")
    x, y = probe_inputs(n_elems, device)
    chain_cuda(body, x, y, chain_len)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        chain_cuda(body, x, y, chain_len)
    end.record()
    end.synchronize()
    return n_elems * chain_len * reps / (start.elapsed_time(end) / 1e3)
