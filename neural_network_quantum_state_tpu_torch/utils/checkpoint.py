"""Checkpoint / resume (the JAX package's ``utils/checkpoint.py``).

Three formats, each read and written by both packages:

1. Reference-compatible plain text: C++ iostream complex literals
   ``(re,im)`` separated by whitespace, one file per tensor for RBM/FFNN
   (prefix + Dw/Da/Db.dat resp. Dw1/Dw2/Db1.dat) and one whole-vector file
   at the bare prefix for the symmetric machines. Numbers are formatted as
   C's ``%.*g`` formats them (8 digits for float32 machines, 15 for
   float64), so the files are byte for byte the JAX package's for the same
   parameters; a Python formatter of this module's own makes them.

2. Structured .npz checkpoints: params (``name.re``, ``name.im``), the
   optimizer step (``__step__``), the machine's name (``__machine__``), the
   walker spins (``__spins__``) and this package's random state
   (``__generator__``: the bytes of ``torch.Generator.get_state()``, with
   the generator's device type in ``__generator_device__``). The JAX
   package's files hold its threefry key in ``__key__`` instead; each
   package's ``load_npz`` reads the other's params, step and spins.

3. Orbax ``StandardCheckpointer`` directories (``.orbax``), read and written
   without Orbax (``utils/orbax_format.py``): ``machine`` (the name as
   uint8), ``step``, ``params.<name>.re/.im``, ``spins`` and ``extra``.
   ``load_orbax`` reads either package's directories, the JAX package's
   OCDBT layout included; ``save_orbax`` writes the plain layout, which the
   JAX package's ``load_orbax`` reads. This package's random state goes
   under ``extra`` as ``generator`` and ``generator_device``; a JAX file's
   threefry key (``key``) reseeds as ``__key__`` does in ``load_npz``.
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import Optional

import numpy as np
import torch

from neural_network_quantum_state_tpu_torch.models.base import Machine, Params
from neural_network_quantum_state_tpu_torch.utils import orbax_format

_COMPLEX_RE = re.compile(r"\(([^,()]+),([^,()]+)\)")

# per-tensor text-file suffixes of the non-symmetric machines
_TENSOR_FILES = {
    "RBM": {"w": "Dw.dat", "a": "Da.dat", "b": "Db.dat"},
    "FFNN": {"wi1": "Dw1.dat", "w1o": "Dw2.dat", "b1": "Db1.dat"},
}


def _format_complex_array(z: np.ndarray, precision: int) -> str:
    """``(re,im)`` tokens joined by single spaces, each part as C's
    ``%.{precision}g`` prints the double (Python's ``g`` format is C's)."""
    return " ".join(f"({v.real:.{precision}g},{v.imag:.{precision}g})" for v in z.reshape(-1).tolist())


def _parse_complex_text(text: str) -> np.ndarray:
    vals = [complex(float(m.group(1)), float(m.group(2))) for m in _COMPLEX_RE.finditer(text)]
    return np.asarray(vals, dtype=np.complex128)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A complex tensor as complex numpy, joined from its real planes as
    re + 1j * im, the JAX package's host conversion of its split-complex
    parameters (which turns a -0.0 real part with a non-negative imaginary
    part, and any -0.0 imaginary part, into +0.0), so that the text is
    byte for byte the JAX package's."""
    t = t.detach().cpu()
    return t.real.numpy() + 1j * t.imag.numpy()


def save_reference_text(machine: Machine, params: Params, prefix: str, precision: int | None = None) -> list[str]:
    """Write reference-format text checkpoint(s); returns written paths.

    Default precision follows the reference's FloatTypeTrait_: 8 digits for
    float32 machines, 15 for float64."""
    if precision is None:
        precision = 8 if machine.dtype == torch.float32 else 15
    kind = type(machine).__name__
    written = []
    if kind in _TENSOR_FILES:
        for name, suffix in _TENSOR_FILES[kind].items():
            path = prefix + suffix
            with open(path, "w") as f:
                f.write(_format_complex_array(_to_numpy(params[name]), precision) + "\n")
            written.append(path)
    else:
        # symmetric machines: single whole-variables_ file at the prefix
        with open(prefix, "w") as f:
            f.write(_format_complex_array(_to_numpy(machine.flatten_params(params)), precision) + "\n")
        written.append(prefix)
    return written


def load_reference_text(machine: Machine, prefix: str, device: torch.device | str = "cuda") -> Params:
    """Read reference-format text checkpoint(s) into params on `device`."""
    kind = type(machine).__name__
    spec = dict(machine.param_spec())

    def tensor(z: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(z, device=device).to(machine.complex_dtype)

    if kind in _TENSOR_FILES:
        out = {}
        for name, suffix in _TENSOR_FILES[kind].items():
            with open(prefix + suffix) as f:
                z = _parse_complex_text(f.read())
            shape = spec[name]
            if z.size != int(np.prod(shape)):
                raise ValueError(f"{prefix + suffix}: expected {shape}, got {z.size} values")
            out[name] = tensor(z.reshape(shape))
        return out
    with open(prefix) as f:
        vec = _parse_complex_text(f.read())
    if vec.size != machine.n_vars:
        raise ValueError(f"{prefix}: expected {machine.n_vars} values, got {vec.size}")
    return machine.unflatten_params(tensor(vec))


# ---------------------------------------------------------------------------
def save_npz(path: str, machine: Machine, params: Params, step: int = 0,
             generator: Optional[torch.Generator] = None, spins: Optional[torch.Tensor] = None) -> None:
    """Structured checkpoint: params (+ step, the random state of
    `generator`, walker spins)."""
    payload = {"__step__": np.asarray(step), "__machine__": np.asarray(type(machine).__name__)}
    for name, _ in machine.param_spec():
        p = params[name].detach().cpu()
        payload[f"{name}.re"] = p.real.numpy()
        payload[f"{name}.im"] = p.imag.numpy()
    if generator is not None:
        payload["__generator__"] = generator.get_state().numpy()
        payload["__generator_device__"] = np.asarray(generator.device.type)
    if spins is not None:
        payload["__spins__"] = spins.detach().cpu().numpy()
    np.savez(path, **payload)


def _seeded(device: torch.device | str, words: bytes) -> torch.Generator:
    """A generator on `device` seeded from the first 8 bytes of the SHA-256
    of `words`: the same bytes give the same stream."""
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(hashlib.sha256(words).digest()[:8], "little") >> 1)
    return g


def load_npz(path: str, machine: Machine, device: torch.device | str = "cuda"):
    """Returns (params, step, generator | None, spins | None), the tensors
    and the generator on `device`.

    A file of this package restores its generator's state where the device
    type is the one it was saved from. A resume across packages (a JAX
    file's threefry key in ``__key__``) or across device types restarts the
    random stream: the generator is seeded deterministically from the saved
    key or state, so the same file gives the same stream, but not the one
    the saving run would have drawn next.
    """
    data = np.load(path, allow_pickle=False)
    name = str(data["__machine__"])
    if name != type(machine).__name__:
        raise ValueError(f"checkpoint is for {name}, not {type(machine).__name__}")
    params = {}
    for pname, shape in machine.param_spec():
        re_ = torch.as_tensor(np.asarray(data[f"{pname}.re"]), dtype=machine.dtype)
        im_ = torch.as_tensor(np.asarray(data[f"{pname}.im"]), dtype=machine.dtype)
        if tuple(re_.shape) != tuple(shape):
            raise ValueError(f"{path}: {pname} has shape {tuple(re_.shape)}, expected {tuple(shape)}")
        params[pname] = torch.complex(re_, im_).to(device)
    step = int(data["__step__"])
    device = torch.device(device)
    generator = None
    if "__generator__" in data:
        state = np.asarray(data["__generator__"], dtype=np.uint8)
        if str(data["__generator_device__"]) == device.type:
            generator = torch.Generator(device=device)
            generator.set_state(torch.as_tensor(state))
        else:
            generator = _seeded(device, state.tobytes())
    elif "__key__" in data:
        generator = _seeded(device, np.asarray(data["__key__"], dtype=np.uint32).tobytes())
    spins = torch.as_tensor(np.asarray(data["__spins__"]), dtype=machine.dtype, device=device) \
        if "__spins__" in data else None
    return params, step, generator, spins


# ---------------------------------------------------------------------------
_GENERATOR_KEYS = ("generator", "generator_device")


def _u8(text: str) -> np.ndarray:
    return np.frombuffer(text.encode(), dtype=np.uint8).copy()


def _host_tree(tree: dict) -> dict:
    """`tree` with its tensors as numpy arrays and its dicts' keys sorted,
    the order in which JAX flattens a dict."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out[k] = _host_tree(v)
        else:
            out[k] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def save_orbax(path: str, machine: Machine, params: Params, step: int = 0,
               generator: Optional[torch.Generator] = None, spins: Optional[torch.Tensor] = None,
               extra: Optional[dict] = None) -> str:
    """Orbax checkpoint directory at `path` (replaced if it exists, written
    beside it and renamed into place): the tree the JAX package's
    ``save_orbax`` writes, with the random state of `generator` under
    ``extra``. Returns the directory's absolute path."""
    state: dict = {}
    extra = _host_tree(extra or {})
    if generator is not None:
        extra["generator"] = generator.get_state().numpy()
        extra["generator_device"] = _u8(generator.device.type)
    # the keys in the order JAX flattens the dict: sorted, a C pair re, im
    if extra:
        state["extra"] = dict(sorted(extra.items()))
    state["machine"] = _u8(type(machine).__name__)
    state["params"] = {}
    for name in sorted(dict(machine.param_spec())):
        p = params[name].detach().cpu()
        state["params"][name] = {"re": p.real.numpy(), "im": p.imag.numpy()}
    if spins is not None:
        state["spins"] = spins.detach().cpu().numpy()
    state["step"] = np.asarray(step, dtype=np.int64)
    return orbax_format.write(path, state, force=True)


def load_orbax(path: str, machine: Machine, device: torch.device | str = "cuda"):
    """Returns (params, step, generator | None, spins | None, extra | None),
    the tensors and the generator on `device`, from either package's Orbax
    directory. Arrays are cast on the host to the machine's dtype, so a
    float64 save loads into a float32 machine and back. The generator is
    restored or reseeded as ``load_npz`` does it; `extra` comes back without
    the generator's entries (None where nothing else is left)."""
    state = orbax_format.read(os.path.abspath(path))
    name = bytes(np.asarray(state["machine"], dtype=np.uint8)).decode()
    if name != type(machine).__name__:
        raise ValueError(f"checkpoint is for {name}, not {type(machine).__name__}")
    real = np.float32 if machine.dtype == torch.float32 else np.float64
    params = {}
    for pname, shape in machine.param_spec():
        leaf = state["params"][pname]
        re_, im_ = np.asarray(leaf["re"], dtype=real), np.asarray(leaf["im"], dtype=real)
        if re_.shape != tuple(shape) or im_.shape != tuple(shape):
            raise ValueError(f"{path}: {pname} has shape {re_.shape}, expected {tuple(shape)}")
        params[pname] = torch.complex(torch.as_tensor(re_), torch.as_tensor(im_)).to(device)
    step = int(np.asarray(state["step"]))
    device = torch.device(device)
    extra = dict(state.get("extra", {}))
    generator = None
    if "generator" in extra:
        gstate = np.asarray(extra["generator"], dtype=np.uint8)
        if bytes(np.asarray(extra["generator_device"], dtype=np.uint8)).decode() == device.type:
            generator = torch.Generator(device=device)
            generator.set_state(torch.as_tensor(gstate))
        else:
            generator = _seeded(device, gstate.tobytes())
    elif "key" in state:
        generator = _seeded(device, np.asarray(state["key"], dtype=np.uint32).tobytes())
    for k in _GENERATOR_KEYS:
        extra.pop(k, None)
    spins = torch.as_tensor(np.asarray(state["spins"], dtype=real), device=device) if "spins" in state else None
    return params, step, generator, spins, extra or None
