"""Orbax ``StandardCheckpointer`` directories, read and written in Python
and numpy: zarr v2 arrays under an Orbax tree.

A checkpoint directory holds ``_METADATA`` (JSON: ``tree_metadata`` maps
each leaf's tree path, written as a Python tuple, to its keys and their
``key_type``; ``use_ocdbt`` and ``use_zarr3`` name the layout) and
``_CHECKPOINT_METADATA``. Each leaf is a zarr v2 array named by its keys
joined with ``.``: ``<name>/.zarray`` (JSON: shape, chunks, dtype,
compressor) and one chunk per grid cell, ``<name>/0.0`` (``0`` for a
zero-dimensional array). With ``use_ocdbt`` these keys live in the OCDBT
store at the directory's root (``utils/ocdbt.py``); without it they are
files. ``read`` takes either layout, chunks compressed with zstd
(``utils/zstd.py``) or not, and assembles arrays saved in several chunks
(a walker-sharded save writes one per shard). ``write`` writes the plain
layout with uncompressed chunks, which Orbax's own ``restore`` reads.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import time
import uuid

import numpy as np

from neural_network_quantum_state_tpu_torch.utils import zstd
from neural_network_quantum_state_tpu_torch.utils.ocdbt import OcdbtStore

KEY_TYPE_DICT = 2
_HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"


class OrbaxFormatError(ValueError):
    """A checkpoint this module cannot read."""


class _Files:
    """The plain layout's keys: files under the checkpoint directory."""

    def __init__(self, root: str):
        self.root = root

    def __contains__(self, key: str) -> bool:
        return os.path.isfile(os.path.join(self.root, key))

    def read(self, key: str) -> bytes:
        try:
            with open(os.path.join(self.root, key), "rb") as f:
                return f.read()
        except OSError as e:
            raise OrbaxFormatError(f"{self.root}: {e}") from e


def _read_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise OrbaxFormatError(f"{path}: {e}") from e


def _array(store, name: str) -> np.ndarray:
    """The zarr v2 array `name` of `store`, assembled from its chunks."""
    if f"{name}/zarr.json" in store:
        raise OrbaxFormatError(f"{name}: a zarr v3 array (zarr.json); only zarr v2 is supported")
    try:
        meta = json.loads(store.read(f"{name}/.zarray"))
    except json.JSONDecodeError as e:
        raise OrbaxFormatError(f"{name}/.zarray: {e}") from e
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{name}: zarr format {meta.get('zarr_format')}, expected 2")
    if meta.get("filters"):
        raise OrbaxFormatError(f"{name}: zarr filters are not supported")
    if meta.get("order", "C") != "C":
        raise OrbaxFormatError(f"{name}: order {meta['order']!r}, only C is supported")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OrbaxFormatError(f"{name}: compressor {comp.get('id')!r}, only zstd or none is supported")
    dtype = np.dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks):
        raise OrbaxFormatError(f"{name}: shape {shape} and chunks {chunks} of different ranks")
    sep = meta.get("dimension_separator", ".")
    out = np.empty(shape, dtype)
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        key = f"{name}/" + (sep.join(str(i) for i in idx) if idx else "0")
        if key not in store:
            raise OrbaxFormatError(f"{key}: chunk missing (no fill value)")
        raw = store.read(key)
        if comp is not None:
            raw = zstd.decompress(raw)
        if len(raw) != dtype.itemsize * math.prod(chunks):
            raise OrbaxFormatError(f"{key}: {len(raw)} bytes for a chunk of {chunks} {dtype}")
        block = np.frombuffer(raw, dtype).reshape(chunks)
        sel = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sel] = block[tuple(slice(0, sl.stop - sl.start) for sl in sel)]
    return out


def read(path: str) -> dict:
    """The tree of the checkpoint in `path`: nested dicts of numpy arrays,
    keyed as its ``_METADATA`` says."""
    path = os.fspath(path)
    meta = _read_json(os.path.join(path, "_METADATA"))
    if meta.get("use_zarr3"):
        raise OrbaxFormatError(f"{path}: a zarr v3 checkpoint (use_zarr3); only zarr v2 is supported")
    store = OcdbtStore(path) if meta.get("use_ocdbt") else _Files(path)
    tree: dict = {}
    for leaf in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in leaf["key_metadata"]]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _array(store, ".".join(keys))
    return tree


def _leaves(tree: dict, keys=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, keys + (str(k),))
        else:
            yield keys + (str(k),), np.asarray(v)


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def write(path: str, tree: dict, force: bool = False) -> str:
    """Write `tree` (nested dicts of arrays, in the order Orbax flattens
    them) to the checkpoint directory `path` in the plain layout: one
    uncompressed chunk per array. The directory is written beside `path`
    and renamed into place, so a reader sees all of it or none; ``force``
    replaces an existing `path`, else that raises FileExistsError."""
    path = os.path.abspath(path)
    if os.path.exists(path) and not force:
        raise FileExistsError(f"{path} exists (force=True replaces it)")
    start = time.time_ns()
    tmp = f"{path}.orbax-checkpoint-tmp-{uuid.uuid4().hex}"
    try:
        os.makedirs(tmp)
        tree_meta = {}
        for keys, arr in _leaves(tree):
            name = ".".join(keys)
            if arr.dtype.kind not in "biufc":
                raise TypeError(f"{name}: cannot store an array of {arr.dtype}")
            arr = np.asarray(arr, order="C")
            os.makedirs(os.path.join(tmp, name))
            _write_json(os.path.join(tmp, name, ".zarray"), {
                "chunks": [max(s, 1) for s in arr.shape], "compressor": None, "dimension_separator": ".",
                "dtype": arr.dtype.str, "fill_value": None, "filters": None, "order": "C",
                "shape": list(arr.shape), "zarr_format": 2,
            })
            if arr.size:
                with open(os.path.join(tmp, name, ".".join("0" * arr.ndim) or "0"), "wb") as f:
                    f.write(arr.tobytes())
            tree_meta[str(keys)] = {
                "key_metadata": [{"key": k, "key_type": KEY_TYPE_DICT} for k in keys],
                "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False},
            }
        _write_json(os.path.join(tmp, "_METADATA"), {
            "tree_metadata": tree_meta, "use_ocdbt": False, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True, "custom_metadata": None,
        })
        _write_json(os.path.join(tmp, "_CHECKPOINT_METADATA"), {
            "item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
            "init_timestamp_nsecs": start, "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {},
        })
        old = None
        if os.path.exists(path):
            old = f"{tmp}-old"
            os.rename(path, old)
        try:
            os.rename(tmp, path)
        except OSError:
            if old is not None:
                os.rename(old, path)
            raise
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if old is not None:
        shutil.rmtree(old)
    return path
