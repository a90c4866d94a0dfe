"""Walker-axis data parallelism over a list of shard devices (the JAX
package's ``parallel/mesh.py``).

One controller, as JAX's ``mesh=`` is: a ``Mesh`` is a list of shard
devices in walker order. The walkers split into one contiguous shard per
entry (``shard_walker_tree``), each shard holding whole replica groups of
the replica-minor layout; the parameters stay on the first shard's device,
and ``shard_map`` hands every shard its device's copy, made once per tensor
(``replica``). A per-walker function runs once per shard on the shard's
device, in one process, with no collective: each sampler call is one launch
of the kernel per shard, and the local energy one per shard. The O(V) SR sums over walkers (the energy
mean, aO, diag S, F and the CG matvec's O^H(Ov)) are reduced over the
shards onto the first shard's device (``reduce_sum``, ``optim/sr.py``).

``make_mesh(n)`` places n shards round-robin over the visible devices of
one type: the cards of ``torch.cuda.device_count()``, or the one ``cpu``.
So ``make_mesh(8, device="cpu")`` runs in a CPU test as JAX's eight virtual
devices do, and on one card four shards share ``cuda:0``; a list of devices
is taken as it is. ``make_mesh_2d`` and ``make_mesh_tp`` shape the same
list, and every axis of either carries walkers (``walker_axes``), for the
SR sums too. ``o_mat_spec`` names JAX's layout of the (K, V) log-derivative
matrix, column blocks over a TP mesh's ``params`` axis; with one controller
such tiles save no memory and no work (each row block would first be joined
on one device), so the port's TP matvec is the walker-sharded one.

The random streams keep a sharded run equal to the unsharded one, decision
for decision: a sharded call draws one Philox key, as an unsharded one,
and every shard launches on it at its first global walker row
(``split_draws``: the draws' ``row0``); on the CPU the call draws its
uniform block once and each shard takes its columns (``split``).

The port has no ``jit``, so the JAX helpers that only constrain a traced
array's sharding have nothing to do and are not kept: ``constrain_o_mat``,
``constrain_walkers``, ``walker_sharding`` and ``replicated``.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Any, Callable, Sequence

import torch

WALKER_AXIS = "walkers"
SLICE_AXIS = "slice"
PARAM_AXIS = "params"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Shard devices in walker order (row-major over ``shape``) and the
    names of the axes of ``shape``."""

    devices: tuple[torch.device, ...]
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        n = 1
        for s in self.shape:
            n *= s
        if n != len(self.devices) or n < 1 or len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh: {len(self.devices)} devices do not fill shape {self.shape} {self.axis_names}")

    @property
    def size(self) -> int:
        return len(self.devices)


def visible_devices(device: torch.device | str = "cuda") -> list[torch.device]:
    """The devices of one type that shards can be placed on: every card
    (``cuda:0`` ..), or the one CPU."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")]
    if kind != "cuda":
        raise ValueError(f"mesh: devices of type {kind!r} are not supported")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("mesh: no CUDA device is visible (pass device='cpu' for a CPU mesh)")
    return [torch.device("cuda", i) for i in range(count)]


def _placed(n: int | None, device, offset: int = 0) -> tuple[torch.device, ...]:
    """n shards (default: one per visible device) round-robin over the
    visible devices of ``device``'s type, from the ``offset``-th of them on."""
    visible = visible_devices(device)
    n = len(visible) if n is None else n
    if n < 1:
        raise ValueError(f"mesh: {n} shards")
    return tuple(visible[(offset + i) % len(visible)] for i in range(n))


def make_mesh(n_devices: int | Sequence | None = None, axis_name: str = WALKER_AXIS,
              device: torch.device | str = "cuda") -> Mesh:
    """A 1D walker mesh of ``n_devices`` shards (default: one per visible
    device of ``device``'s type), or of the given list of devices."""
    if isinstance(n_devices, (list, tuple)):
        devices = tuple(torch.device(d) for d in n_devices)
    else:
        devices = _placed(n_devices, device)
    return Mesh(devices, (len(devices),), (axis_name,))


def make_submeshes(n_meshes: int, n_shards: int, device: torch.device | str = "cuda") -> list[Mesh]:
    """``n_meshes`` 1D meshes of ``n_shards`` shards each: mesh i takes the
    visible devices from the (i * n_shards)-th on, round-robin, so the
    meshes hold disjoint devices where there are at least n_meshes *
    n_shards of them and share devices otherwise."""
    return [Mesh(_placed(n_shards, device, i * n_shards), (n_shards,), (WALKER_AXIS,)) for i in range(n_meshes)]


def make_mesh_2d(n_slices: int, n_per_slice: int | None = None,
                 axis_names: tuple[str, str] = (SLICE_AXIS, WALKER_AXIS),
                 device: torch.device | str = "cuda") -> Mesh:
    """(n_slices, n_per_slice) mesh of the multi-slice layout. In one
    process the walkers shard over both axes, slice-major, as JAX's
    P(("slice", "walkers")) does; n_per_slice defaults to the visible
    devices over n_slices (at least 1)."""
    if n_per_slice is None:
        n_per_slice = max(len(visible_devices(device)) // n_slices, 1)
    return Mesh(_placed(n_slices * n_per_slice, device), (n_slices, n_per_slice), tuple(axis_names))


def make_mesh_tp(n_walker_devices: int, n_param_devices: int,
                 axis_names: tuple[str, str] = (WALKER_AXIS, PARAM_AXIS),
                 device: torch.device | str = "cuda") -> Mesh:
    """(walkers, params) mesh, JAX's layout for the parameter-sharded SR
    matvec. In one process the walkers shard over every device, the SR sums
    as well (see the module's docstring)."""
    return Mesh(_placed(n_walker_devices * n_param_devices, device), (n_walker_devices, n_param_devices),
                tuple(axis_names))


def walker_axes(mesh: Mesh) -> tuple[str, ...]:
    """Every mesh axis carries walkers for sampling."""
    return tuple(mesh.axis_names)


def o_mat_spec(mesh: Mesh) -> tuple:
    """JAX's layout of the (K, V) log-derivative matrix in the SR solve, as
    its PartitionSpec: (walker axes, PARAM_AXIS) with a params axis (row
    blocks over the other axes, column blocks over it), else (walker axes,)
    (walker-sharded rows, V whole). The port shards the rows over every
    axis."""
    w_axes = tuple(a for a in mesh.axis_names if a != PARAM_AXIS)
    return (w_axes, PARAM_AXIS) if PARAM_AXIS in mesh.axis_names else (w_axes,)


def n_devices(mesh: Mesh | None) -> int:
    """The shards of a mesh (1 without one)."""
    return 1 if mesh is None else mesh.size


class Sharded(tuple):
    """One value per shard of ``mesh``, in walker order: for a walker-axis
    tensor, its contiguous row blocks, each on its shard's device."""

    def __new__(cls, parts, mesh: Mesh):
        obj = super().__new__(cls, parts)
        obj.mesh = mesh
        return obj

    @property
    def shape(self) -> torch.Size:
        """The global shape (the shards' rows summed)."""
        return torch.Size((sum(p.shape[0] for p in self),) + tuple(self[0].shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self[0].dtype

    @property
    def device(self) -> torch.device:
        """The first shard's device, where reductions land."""
        return self[0].device

    def offsets(self) -> list[int]:
        """The first global walker row of each shard."""
        out, at = [], 0
        for p in self:
            out.append(at)
            at += p.shape[0]
        return out


def mesh_of(tree: Any) -> Mesh | None:
    """The mesh of the first ``Sharded`` leaf of a tree, or None."""
    if isinstance(tree, Sharded):
        return tree.mesh
    if isinstance(tree, dict):
        tree = tuple(tree.values())
    if isinstance(tree, (tuple, list)):
        for x in tree:
            m = mesh_of(x)
            if m is not None:
                return m
    return None


def _map_tree(fn: Callable, tree: Any) -> Any:
    """``fn`` on every leaf of nested tuples, NamedTuples, lists and dicts
    (a ``Sharded`` is a leaf)."""
    if isinstance(tree, Sharded) or not isinstance(tree, (tuple, list, dict)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    parts = [_map_tree(fn, x) for x in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(parts)


def shard_walker_tree(tree: Any, mesh: Mesh, n_walkers: int) -> Any:
    """Split every tensor leaf whose leading dimension is ``n_walkers`` into
    the mesh's shards (contiguous, each on its device); every other leaf
    (parameters, counters, the generator) stays as it is."""
    if n_walkers % mesh.size != 0:
        raise ValueError(f"mesh: {n_walkers} walkers do not split over {mesh.size} shards")
    rows = n_walkers // mesh.size

    def place(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] == n_walkers:
            return Sharded([x[i * rows:(i + 1) * rows].to(d).contiguous() for i, d in enumerate(mesh.devices)], mesh)
        return x

    return _map_tree(place, tree)


def replicate_tree(tree: Any, mesh: Mesh) -> Any:
    """Every tensor leaf, whole, on the mesh's first device: the controller's
    copy of the parameters, which ``shard_map`` copies to each shard's device
    once (``replica``).
    Never splits a leaf, also where ``shard_walker_tree`` would: an (N, H)
    weight with N equal to the walker count stays whole."""
    return _map_tree(lambda x: x.to(mesh.devices[0]) if isinstance(x, torch.Tensor) else x, tree)


def gather(tree: Any, dim: int = 0) -> Any:
    """Every ``Sharded`` leaf joined in walker order along ``dim`` on its
    first shard's device; other leaves as they are."""

    def join(x):
        if isinstance(x, Sharded):
            return torch.cat([p.to(x.device) for p in x], dim=dim)
        return x

    return _map_tree(join, tree)


def reduce_sum(x: Any) -> Any:
    """The sum of the parts of a ``Sharded`` value (or of a list) on its first
    part's device; any other value as it is."""
    if not isinstance(x, (Sharded, list)):
        return x
    total = x[0]
    for p in x[1:]:
        total = total + p.to(total.device)
    return total


def split(x: Any, like: Any, dim: int = 0) -> Any:
    """The slices of a walker-axis tensor ``x`` along ``dim`` that match the
    shards of ``like`` (a ``Sharded``), each on its shard's device; ``x`` as
    it is when ``like`` is not sharded, or ``x`` is None."""
    if not isinstance(like, Sharded) or x is None:
        return x
    out = []
    for p, at in zip(like, like.offsets()):
        out.append(x.narrow(dim, at, p.shape[0]).to(p.device).contiguous())
    return Sharded(out, like.mesh)


def split_draws(draws: Any, like: Any) -> Any:
    """A Philox draw (``ops/rng.py`` ``PhiloxDraws``, ``ExchangeDraws``) for
    each shard of ``like``: the same key on the shard's device, at the
    shard's first global walker row; ``draws`` as it is when ``like`` is not
    sharded."""
    if not isinstance(like, Sharded):
        return draws
    return Sharded([draws._replace(key=draws.key.to(p.device), row0=draws.row0 + at)
                    for p, at in zip(like, like.offsets())], like.mesh)


def _stack(outs: list, mesh: Mesh) -> Any:
    """The per-shard results of ``shard_map`` as one tree of ``Sharded``."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, (tuple, list)) and not isinstance(first, Sharded):
        parts = [_stack([o[i] for o in outs], mesh) for i in range(len(first))]
        return type(first)(*parts) if hasattr(first, "_fields") else type(first)(parts)
    return Sharded(outs, mesh)


# The copies ``replica`` has made: id(tensor) -> (the tensor's version
# counter, {device: copy}), dropped with the tensor.
_replicas: dict[int, tuple[int, dict]] = {}
_replicas_lock = threading.Lock()


def replica(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``: ``x`` itself there, else one copy per tensor and
    device, kept while ``x`` lives and is not changed in place. So the
    parameters, a ``Work`` and the static tables (schedule, bonds) reach a
    shard's card once per tensor, not on every call, and the per-device
    memos of ``ops/engine.py::kernel_table`` and
    ``ops/exchange.py::kernel_incidence`` find the same copy there."""
    if x.device == device:
        return x
    key = id(x)
    with _replicas_lock:
        entry = _replicas.get(key)
        if entry is None:
            weakref.finalize(x, _replicas.pop, key, None)
        if entry is None or entry[0] != x._version:
            entry = _replicas[key] = (x._version, {})
        copy = entry[1].get(device)
        if copy is None:
            copy = entry[1][device] = x.to(device)
    return copy


def shard_map(fn: Callable, *args) -> Any:
    """Run ``fn`` once per shard and return its results as ``Sharded``
    leaves. Shard i gets part i of every ``Sharded`` argument and every
    other tensor on its device (parameters, schedules, bond tables:
    ``replica``); other arguments as they are. Without a ``Sharded``
    argument this is ``fn(*args)``."""
    mesh = mesh_of(args)
    if mesh is None:
        return fn(*args)

    def local(x, i, dev):
        if isinstance(x, Sharded):
            return x[i]
        return replica(x, dev) if isinstance(x, torch.Tensor) else x

    outs = []
    for i, dev in enumerate(mesh.devices):
        outs.append(fn(*_map_tree(lambda x: local(x, i, dev), args)))
    return _stack(outs, mesh)

