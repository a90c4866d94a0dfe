"""A read-only OCDBT store (tensorstore's Optionally-Cooperative Distributed
B+Tree), in Python: the key-value store under Orbax's checkpoints.

A store is a directory with a ``manifest.ocdbt`` and data files under it.
The manifest holds the store's config and its version tree: the latest
versions inline, older ones in version-tree nodes that it points to. Each
version names the root of a B+tree whose nodes sit in data files at
(file, offset, length). Leaf nodes hold prefix-compressed keys and either
the values themselves (inline) or (file, offset, length) references into
the data files (indirect). Every manifest and node is an envelope: a
big-endian magic, its little-endian 64-bit length, a format version, a
compression id (none or zstd, ``utils/zstd.py``), the body, and the
CRC32C of all that went before.

Data-file paths are relative to the path of the node that names them: a
node read from a file whose reference had base path P resolves its own
table under P (Orbax's merged store keeps its data under
``ocdbt.process_<i>/``). ``OcdbtStore(dir).list()`` lists the latest
version's keys and ``read(key)`` returns a value; a missing manifest or
key, a CRC mismatch or a malformed node raises ``OcdbtError``.
"""

from __future__ import annotations

import os

from neural_network_quantum_state_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_MAGIC = 0x0CDB1234
_NO_ROOT = (1 << 64) - 1  # offset and length of an empty tree's root


class OcdbtError(ValueError):
    """A missing, corrupt or unsupported OCDBT store."""


def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of `data`."""
    t = _CRC_TABLE
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    """A cursor over a decoded body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def fail(self, why: str):
        raise OcdbtError(f"{self.what}: {why}")

    def varint(self) -> int:
        v = shift = 0
        data, pos = self.data, self.pos
        while True:
            if pos >= len(data):
                self.fail("truncated varint")
            b = data[pos]
            pos += 1
            v |= (b & 0x7F) << shift
            if b < 0x80:
                break
            shift += 7
            if shift > 63:
                self.fail("varint too long")
        self.pos = pos
        return v

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def byte(self) -> int:
        if self.pos >= len(self.data):
            self.fail("truncated")
        self.pos += 1
        return self.data[self.pos - 1]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self.fail("truncated")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def u64s(self, n: int) -> list[int]:
        return [int.from_bytes(self.take(8), "little") for _ in range(n)]

    def end(self):
        if self.pos != len(self.data):
            self.fail(f"{len(self.data) - self.pos} bytes after the body")


def _envelope(raw: bytes, magic: int, what: str) -> _Reader:
    """The decoded body of one envelope, its magic, length and CRC checked."""
    if len(raw) < 18:
        raise OcdbtError(f"{what}: {len(raw)} bytes, shorter than an envelope")
    if int.from_bytes(raw[:4], "big") != magic:
        raise OcdbtError(f"{what}: magic {raw[:4].hex()}, expected {magic:08x}")
    if int.from_bytes(raw[4:12], "little") != len(raw):
        raise OcdbtError(f"{what}: length field {int.from_bytes(raw[4:12], 'little')} for {len(raw)} bytes")
    if crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise OcdbtError(f"{what}: CRC32C mismatch")
    head = _Reader(raw[:-4], what)
    head.pos = 12
    if head.varint() != 0:
        head.fail("unknown format version")
    comp = head.varint()
    body = raw[head.pos:-4]
    if comp == 1:
        try:
            body = zstd.decompress(body)
        except zstd.ZstdError as e:
            raise OcdbtError(f"{what}: {e}") from e
    elif comp != 0:
        head.fail(f"unknown compression {comp}")
    return _Reader(body, what)


def _data_file_table(r: _Reader, base: str) -> list[tuple[str, str]]:
    """[(path under the store root, base path of the nodes read from it)]:
    prefix-compressed paths, each with the length of its base path, all
    under `base`."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base_len = r.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("data-file path prefix longer than the previous path")
        path = prev[:prefix[i]] + r.take(suffix[i])
        if base_len[i] > len(path):
            r.fail("base path longer than its data-file path")
        prev = path
        files.append((base + path.decode(), base + path[:base_len[i]].decode()))
    return files


def _version_entries(r: _Reader, n: int, files) -> list[tuple]:
    """[(generation, root height, root (file, offset, length))] of n
    version-tree leaf entries."""
    gen = r.varints(n)
    height = [r.byte() for _ in range(n)]
    loc = _locations(r, n, files)
    r.varints(3 * n)  # statistics: keys, tree bytes, indirect value bytes
    r.u64s(n)  # commit times
    return list(zip(gen, height, loc))


def _locations(r: _Reader, n: int, files) -> list[tuple]:
    fid, off, length = r.varints(n), r.varints(n), r.varints(n)
    out = []
    for i in range(n):
        if off[i] == _NO_ROOT:
            out.append(None)
            continue
        if fid[i] >= len(files):
            r.fail(f"data file {fid[i]} of a table of {len(files)}")
        out.append((files[fid[i]], off[i], length[i]))
    return out


class OcdbtStore:
    """The latest version of the OCDBT store in `root` (a directory)."""

    def __init__(self, root: str):
        self.root = os.fspath(root)
        self._files: dict[str, bytes] = {}
        r = _envelope(self._file("manifest.ocdbt"), MANIFEST_MAGIC, f"{self.root}/manifest.ocdbt")
        r.take(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise OcdbtError(f"{self.root}: numbered manifests are not supported (manifest kind {kind})")
        r.varint()  # max inline value bytes
        r.varint()  # max decoded node bytes
        r.byte()  # version tree arity, log2
        if r.varint() == 1:
            r.take(4)  # zstd level
        files = _data_file_table(r, "")
        versions = _version_entries(r, r.varint(), files)
        n = r.varint()
        refs = list(zip(r.varints(n), _locations(r, n, files)))
        r.varints(n)  # generations under each reference
        r.u64s(n)  # commit times
        heights = [r.byte() for _ in range(n)]
        r.end()
        latest = max(versions, default=None)
        if refs and (latest is None or max(refs)[0] > latest[0]):
            gen, loc = max(refs)
            latest = self._latest_in_version_node(loc, heights[refs.index((gen, loc))])
        if latest is None:
            raise OcdbtError(f"{self.root}: the manifest holds no version")
        self.generation, root_height, root = latest
        self._keys: dict[bytes, tuple] = {}
        if root is not None:
            self._walk(root, root_height, b"")

    def _file(self, path: str) -> bytes:
        if path not in self._files:
            full = os.path.join(self.root, path)
            try:
                with open(full, "rb") as f:
                    self._files[path] = f.read()
            except OSError as e:
                raise OcdbtError(f"{full}: {e}") from e
        return self._files[path]

    def _slice(self, loc) -> bytes:
        (path, _), off, length = loc
        data = self._file(path)
        if off + length > len(data):
            raise OcdbtError(f"{path}: [{off}, {off + length}) past its {len(data)} bytes")
        return data[off:off + length]

    def _latest_in_version_node(self, loc, height: int):
        while True:
            r = _envelope(self._slice(loc), VERSION_MAGIC, f"{loc[0][0]}@{loc[1]}")
            r.byte()  # arity, log2
            if r.byte() != height:
                r.fail("version-tree node of another height than its reference")
            files = _data_file_table(r, loc[0][1])
            n = r.varint()
            if height == 0:
                entries = _version_entries(r, n, files)
                r.end()
                if not entries:
                    r.fail("empty version-tree leaf")
                return max(entries)
            gen = r.varints(n)
            locs = _locations(r, n, files)
            r.varints(n)  # generations under each child
            r.u64s(n)  # commit times
            r.end()
            if not gen:
                r.fail("empty version-tree node")
            loc = locs[gen.index(max(gen))]
            height -= 1

    def _walk(self, loc, height: int, prefix: bytes) -> None:
        r = _envelope(self._slice(loc), BTREE_MAGIC, f"{loc[0][0]}@{loc[1]}")
        if r.byte() != height:
            r.fail("B-tree node of another height than its reference")
        files = _data_file_table(r, loc[0][1])
        n = r.varint()
        kprefix = [0] + r.varints(n - 1) if n else []
        ksuffix = r.varints(n)
        common = r.varints(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            if kprefix[i] > len(prev):
                r.fail("key prefix longer than the previous key")
            prev = prev[:kprefix[i]] + r.take(ksuffix[i])
            keys.append(prev)
        if height:
            children = _locations(r, n, files)
            r.varints(3 * n)  # statistics
            r.end()
            for key, cp, child in zip(keys, common, children):
                if child is None or cp > len(key):
                    r.fail("bad child reference")
                self._walk(child, height - 1, prefix + key[:cp])
            return
        lengths = r.varints(n)
        kinds = [r.byte() for _ in range(n)]
        if any(k > 1 for k in kinds):
            r.fail("unknown value kind")
        indirect = [i for i in range(n) if kinds[i] == 1]
        fid, off = r.varints(len(indirect)), r.varints(len(indirect))
        refs = {}
        for j, i in enumerate(indirect):
            if fid[j] >= len(files):
                r.fail(f"data file {fid[j]} of a table of {len(files)}")
            refs[i] = (files[fid[j]], off[j], lengths[i])
        for i in range(n):
            if kinds[i] == 0:
                self._keys[prefix + keys[i]] = ("inline", r.take(lengths[i]))
            else:
                self._keys[prefix + keys[i]] = ("indirect", refs[i])
        r.end()

    def list(self) -> list[str]:
        """The keys of the latest version, in order."""
        return sorted(k.decode() for k in self._keys)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._keys

    def read(self, key: str) -> bytes:
        """The value stored under `key`."""
        try:
            kind, v = self._keys[key.encode()]
        except KeyError:
            raise OcdbtError(f"{self.root}: no key {key!r}") from None
        return v if kind == "inline" else self._slice(v)
