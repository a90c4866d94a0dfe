"""The port's Orbax checkpoints against Orbax, tensorstore, zstandard,
google_crc32c and the JAX package.

The port reads and writes Orbax ``StandardCheckpointer`` directories with
no Orbax: ``utils/zstd.py`` (a zstd decoder), ``utils/ocdbt.py`` (a
read-only OCDBT store with CRC32C), ``utils/orbax_format.py`` (zarr v2
arrays under the Orbax tree) and ``utils/checkpoint.py::save_orbax`` /
``load_orbax``. Here the decoder is held to zstandard on made-up inputs
(levels 1, 3, 9 and 19, blocks past 128 KiB, with and without a checksum
or a content size, streamed frames) and on the chunks tensorstore wrote;
CRC32C to google_crc32c; the OCDBT reader to tensorstore's listing, key for
key and byte for byte, on the JAX package's ``save_orbax`` files (all seven
machines, float32 and float64, a ``force=True`` re-save, the flagship's
width, a ``-mesh=4`` driver run) and on stores tensorstore writes with
version-tree nodes, interior B-tree nodes and indirect values. The port's
``load_orbax`` of a JAX file equals JAX's ``load_orbax`` bit for bit and
seeds its generator from the key as ``load_npz`` does; JAX's
``load_orbax`` of a port file equals what the port saved; the two write
the same tree metadata. The committed JAX fixtures
(``scripts/make_jax_orbax_fixtures.py``) read the same in both packages.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import google_crc32c
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from neural_network_quantum_state_tpu import models as jmodels
from neural_network_quantum_state_tpu.drivers import train as j_train
from neural_network_quantum_state_tpu.utils import checkpoint as jck
from neural_network_quantum_state_tpu_torch import models as tmodels
from neural_network_quantum_state_tpu_torch.utils import checkpoint as tck
from neural_network_quantum_state_tpu_torch.utils import ocdbt, orbax_format, zstd

from test_torch_checkpoint import DTYPES, _pair
from test_torch_ops import KINDS, _np

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "jax_orbax"
FIXTURE_PREFIX = "RBMTrSymmLICH-L16NF2A2T0V1"


def _zc(data: bytes, level: int, checksum: bool = False, content_size: bool = True) -> bytes:
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=content_size).compress(data)


# data that compresses: runs of short random words, some repeated, some not
_words = st.lists(st.tuples(st.binary(min_size=1, max_size=24), st.integers(1, 40)), max_size=60)


def _mixed(words, tail: bytes) -> bytes:
    return b"".join(w * n for w, n in words) + tail


# ---------------------------------------------------------------------------
# zstd
@pytest.mark.parametrize("level", [1, 3, 9, 19])
@settings(max_examples=60, deadline=None)
@given(words=_words, tail=st.binary(max_size=600), checksum=st.booleans(), content_size=st.booleans())
def test_zstd_decodes_what_zstandard_writes(level, words, tail, checksum, content_size):
    data = _mixed(words, tail)
    assert zstd.decompress(_zc(data, level, checksum, content_size)) == data


def _large(rng) -> bytes:
    """~600 KiB: text, incompressible bytes, a walker ensemble of +-1.0
    float32 and small integers, so the frame holds blocks of every kind."""
    text = (ROOT / "README.md").read_bytes()[:60000]
    spins = np.where(rng.random((1024, 64)) < 0.5, 1.0, -1.0).astype(np.float32).tobytes()
    return text + rng.bytes(70000) + spins + bytes(rng.integers(0, 6, 200000, dtype=np.uint8)) + b"\0" * 50000


@pytest.mark.parametrize("checksum", [False, True], ids=["plain", "checksum"])
@pytest.mark.parametrize("level", [-3, 1, 3, 9, 19])
def test_zstd_multi_block_frames(level, checksum, rng):
    """Frames past 128 KiB (several blocks: raw, RLE and compressed, tables
    and repeat offsets carried across blocks)."""
    data = _large(rng)
    frame = _zc(data, level, checksum)
    assert zstd.decompress(frame) == data
    if checksum:
        bad = bytearray(frame)
        bad[-1] ^= 0x40
        with pytest.raises(zstd.ZstdError, match="checksum"):
            zstd.decompress(bytes(bad))


def test_zstd_streamed_and_concatenated_frames(rng):
    """A streamed frame flushed block by block (no content size; treeless
    literals and repeated tables), and two frames back to back."""
    data = _large(rng)
    c = zstandard.ZstdCompressor(level=5, write_checksum=True).compressobj()
    parts = []
    for i in range(0, len(data), 7000):
        parts.append(c.compress(data[i:i + 7000]))
        parts.append(c.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK))
    parts.append(c.flush())
    streamed = b"".join(parts)
    assert zstd.decompress(streamed) == data
    assert zstd.decompress(_zc(b"abc" * 100, 3) + streamed) == b"abc" * 100 + data


def _block(kind: int, body: bytes, last: bool = True) -> bytes:
    return ((len(body) << 3) | (kind << 1) | int(last)).to_bytes(3, "little") + body


_HEAD = (0xFD2FB528).to_bytes(4, "little") + bytes([0x00, 0x00])  # no content size, window 1 KiB


@pytest.mark.parametrize("frame, why", [
    ((0xFD2FB528).to_bytes(4, "little") + bytes([0x21, 0x07, 0x00]) + _block(0, b""), "dictionary"),
    (_HEAD + _block(2, bytes([0x03 | (1 << 4), 0x10, 0x00, 0x00])), "treeless"),
    (_HEAD + _block(2, bytes([0x00, 0x01, 0xC0, 0x01])), "repeated sequence table"),
    (_HEAD + _block(3, b""), "reserved block"),
    (_HEAD + _block(0, b"abc")[:-1], "truncated"),
    (b"\x00\x01\x02\x03" + _block(0, b""), "not a zstd frame"),
    (_zc(b"hello world" * 10, 3)[:-3], "truncated"),
], ids=["dictionary", "treeless-first", "repeat-first", "reserved", "truncated-raw", "magic", "truncated"])
def test_zstd_refuses_what_it_cannot_decode(frame, why):
    """Dictionaries, a treeless block or a repeated table with nothing
    before it, reserved fields and truncation raise: no empty or zero
    table stands in."""
    with pytest.raises(zstd.ZstdError, match=why):
        zstd.decompress(frame)


_RAW_ABCD = _block(0, b"abcd", last=False)
_RLE_SEQS = bytes([0x54, 0, 0, 0, 0x01])  # LL, OF and ML tables RLE on code 0: no bits but the padding


@pytest.mark.parametrize("frame", [
    _HEAD + _block(2, bytes([3 << 3]) + b"xyz" + b"\0"),
    _HEAD + _block(2, bytes([(5 << 3) | 1]) + b"q" + b"\0"),
    _HEAD + _RAW_ABCD + _block(1, b"z", last=False) + _block(2, bytes([(2 << 3) | 1]) + b"e" + bytes([2]) + _RLE_SEQS),
    _HEAD[:-1] + bytes([7 << 3]) + _RAW_ABCD + _block(2, bytes([0, 0xFF, 0x10, 0x00]) + _RLE_SEQS),  # window 128 KiB
], ids=["literals-only", "rle-literals", "rle-block-then-sequences", "long-sequence-count"])
def test_zstd_rare_block_forms(frame):
    """Block forms zstandard's encoder rarely writes: a compressed block
    without sequences, RLE literals, an RLE block, RLE sequence tables, and
    the three-byte sequence count (0x7F00 + 16 sequences with a literal
    length of 0, whose repeat offsets alternate 4 and 1), held to
    zstandard's decoder."""
    want = zstandard.ZstdDecompressor().decompressobj().decompress(frame)
    assert len(want) > 0 and zstd.decompress(frame) == want


def test_zstd_checksum_is_xxh64():
    """The content checksum (low 32 bits of XXH64, seed 0) at every length
    class: under 4, 8 and 32 bytes and past them."""
    for n in (0, 1, 3, 4, 7, 8, 31, 32, 33, 100, 1000):
        data = bytes(range(256)) * 4
        frame = _zc(data[:n], 3, checksum=True)
        assert int.from_bytes(frame[-4:], "little") == zstd.xxh64(data[:n]) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# CRC32C
@settings(max_examples=200, deadline=None)
@given(data=st.binary(max_size=3000))
def test_crc32c_matches_google_crc32c(data):
    assert ocdbt.crc32c(data) == google_crc32c.value(data)
    assert ocdbt.crc32c(data[len(data) // 2:], ocdbt.crc32c(data[:len(data) // 2])) == google_crc32c.value(data)


# ---------------------------------------------------------------------------
# OCDBT against tensorstore
def _tensorstore(path) -> dict:
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{os.path.abspath(path)}"}).result()
    return {k.decode(): kv.read(k).result().value for k in kv.list().result()}


def _same_as_tensorstore(path) -> ocdbt.OcdbtStore:
    want = _tensorstore(path)
    store = ocdbt.OcdbtStore(path)
    assert store.list() == sorted(want)
    for key, value in want.items():
        assert store.read(key) == value, key
    return store


def _orbax_stores(path):
    """The store at the checkpoint's root (Orbax's merge) and each
    process's own."""
    yield path
    for sub in sorted(os.listdir(path)):
        if sub.startswith("ocdbt.process_"):
            yield os.path.join(path, sub)


def _same_loads(path, jm, tm):
    """The port's load_orbax equals JAX's, bit for bit; the generator is the
    one seeded from the key's bytes."""
    jp, jstep, jkey, jspins, jextra = jck.load_orbax(path, jm)
    tp, tstep, gen, tspins, textra = tck.load_orbax(path, tm, device="cpu")
    assert tstep == jstep
    for name, _ in tm.param_spec():
        assert tp[name].dtype == tm.complex_dtype
        assert np.array_equal(tp[name].numpy(), _np(jp[name]))
    if jspins is None:
        assert tspins is None
    else:
        assert tspins.dtype == tm.dtype and np.array_equal(tspins.numpy(), np.asarray(jspins))
    if jkey is None:
        assert gen is None
    else:
        want = tck._seeded("cpu", np.asarray(jkey, dtype=np.uint32).tobytes())
        assert torch.equal(gen.get_state(), want.get_state())
    if jextra is None:
        assert textra is None
    else:
        assert jax.tree_util.tree_structure(jextra) == jax.tree_util.tree_structure(textra)
        for a, b in zip(jax.tree_util.tree_leaves(jextra), jax.tree_util.tree_leaves(textra)):
            assert np.asarray(a).dtype == b.dtype and np.array_equal(np.asarray(a), b)
    return tp, tstep, gen, tspins


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", KINDS)
def test_jax_save_orbax_reads_the_same(kind, dtype, tmp_path, rng):
    """The JAX package's save_orbax (OCDBT layout, zstd chunks) for every
    machine: the stores read key for key as tensorstore reads them, and the
    port's load_orbax equals JAX's."""
    jm, tm, jp, _, _ = _pair(kind, dtype, rng)
    spins = np.where(rng.random((32, 8)) < 0.5, -1.0, 1.0)
    path = jck.save_orbax(str(tmp_path / "j.orbax"), jm, jp, step=11, key=jax.random.PRNGKey(5),
                          spins=jnp.asarray(spins, DTYPES[dtype][0]),
                          extra={"lnpsi": jnp.arange(4.0), "nested": {"n": np.int32(3)}})
    for store in _orbax_stores(path):
        _same_as_tensorstore(store)
    _same_loads(path, jm, tm)


def test_force_resave_reads_the_latest(tmp_path, rng):
    """A second save over the same directory (JAX's save_orbax passes
    force=True) reads as the second."""
    jm, tm, jp, _, _ = _pair("RBMTrSymm", "float32", rng)
    path = str(tmp_path / "j.orbax")
    jck.save_orbax(path, jm, jp, step=1, key=jax.random.PRNGKey(1), spins=jnp.ones((4, 8)))
    jp2 = jax.tree_util.tree_map(lambda x: x * 2, jp)
    jck.save_orbax(path, jm, jp2, step=2, key=jax.random.PRNGKey(2), spins=-jnp.ones((4, 8)))
    for store in _orbax_stores(path):
        _same_as_tensorstore(store)
    _, step, _, spins = _same_loads(path, jm, tm)
    assert step == 2 and (spins == -1).all()


def test_flagship_width_reads_the_same(tmp_path, rng):
    """RBMTrSymm(64, alpha=4) with 8192 walkers, the flagship's state: the
    walkers' 2 MiB chunk is an indirect value; the decode time is printed."""
    jm = jmodels.RBMTrSymm(n_inputs=64, alpha=4, dtype=jnp.float32)
    tm = tmodels.RBMTrSymm(n_inputs=64, alpha=4, dtype=torch.float32)
    jp = jm.init_params(jax.random.PRNGKey(0))
    spins = np.where(rng.random((8192, 64)) < 0.5, -1.0, 1.0).astype(np.float32)
    path = jck.save_orbax(str(tmp_path / "flag.orbax"), jm, jp, step=20, key=jax.random.PRNGKey(9),
                          spins=jnp.asarray(spins))
    _same_as_tensorstore(path)
    t0 = time.perf_counter()
    _, _, _, got, _ = tck.load_orbax(path, tm, device="cpu")
    print(f"\nflagship walkers (8192 x 64 float32): load_orbax {time.perf_counter() - t0:.3f} s on this host")
    assert np.array_equal(got.numpy(), spins)
    _same_loads(path, jm, tm)


def test_jax_driver_mesh4_run_reads_the_same(tmp_path):
    """A -mesh=4 -ckpt=orbax run of the JAX driver: the walkers (and W)
    saved in 4 chunks, assembled in order."""
    res = j_train.main(["-model=CH", "-ansatz=rbmtrsymm", "-L=8", "-nf=2", "-ns=128", "-nwarm=10", "-niter=4",
                        "-nrec=2", "-dtype=float64", "-ckpt=orbax", "-mesh=4", f"-path={tmp_path}"])
    path = res[0]["prefix"] + ".orbax"
    store = _same_as_tensorstore(path)
    assert {"spins/0.0", "spins/1.0", "spins/2.0", "spins/3.0"} <= set(store.list())
    jm = jmodels.RBMTrSymm(n_inputs=8, alpha=2, dtype=jnp.float64)
    tm = tmodels.RBMTrSymm(n_inputs=8, alpha=2, dtype=torch.float64)
    _, step, _, spins = _same_loads(path, jm, tm)
    assert step == 4 and spins.shape == (128, 8)


def _ts_store(path, config, batches):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}", "config": config}).result()
    for batch in batches:
        with ts.Transaction() as txn:
            for k, v in batch.items():
                kv.with_transaction(txn)[k] = v


@pytest.mark.parametrize("n_commits", [1, 2, 3, 4, 5, 8, 9, 17])
def test_version_tree_nodes(n_commits, tmp_path):
    """Two versions per version-tree node: the latest version is inline or
    only in the nodes the manifest points to, as the count falls."""
    _ts_store(str(tmp_path), {"version_tree_arity_log2": 1, "max_inline_value_bytes": 4},
              [{f"k{g}": b"v" * (g + 1)} for g in range(n_commits)])
    assert _same_as_tensorstore(tmp_path).generation == n_commits + 1


@pytest.mark.parametrize("config", [
    {"max_decoded_node_bytes": 128, "compression": None},
    {"max_decoded_node_bytes": 256, "max_inline_value_bytes": 0, "compression": {"id": "zstd", "level": 9}},
    {"max_inline_value_bytes": 1024},
], ids=["interior-uncompressed", "interior-indirect-zstd", "inline"])
def test_btree_nodes(config, tmp_path, rng):
    """Interior nodes (keys relative to each subtree's common prefix),
    indirect values in several data files, uncompressed and zstd nodes."""
    batches = [{f"dir{d}/key{j:03d}": rng.bytes(int(rng.integers(0, 40))) for j in range(40)} for d in range(3)]
    batches.append({"dir1/key005": b"rewritten", "zzz": rng.bytes(3000)})
    _ts_store(str(tmp_path), config, batches)
    store = _same_as_tensorstore(tmp_path)
    assert store.read("dir1/key005") == b"rewritten" and len(store.list()) == 121


def test_corrupt_or_missing_store_raises(tmp_path, rng):
    """A flipped byte fails its CRC32C, a lost data file or manifest raises:
    never a fresh start."""
    jm, tm, jp, _, _ = _pair("RBM", "float32", rng)
    path = Path(jck.save_orbax(str(tmp_path / "j.orbax"), jm, jp, step=3, spins=jnp.ones((4, 8))))
    node = next((path / "d").iterdir())
    raw = bytearray(node.read_bytes())
    raw[len(raw) // 2] ^= 1
    node.write_bytes(bytes(raw))
    with pytest.raises(ocdbt.OcdbtError, match="CRC32C"):
        tck.load_orbax(str(path), tm, device="cpu")
    node.unlink()
    with pytest.raises(ocdbt.OcdbtError, match="No such file"):
        tck.load_orbax(str(path), tm, device="cpu")
    (path / "manifest.ocdbt").unlink()
    with pytest.raises(ocdbt.OcdbtError, match="manifest"):
        tck.load_orbax(str(path), tm, device="cpu")
    with pytest.raises(orbax_format.OrbaxFormatError, match="_METADATA"):
        tck.load_orbax(str(tmp_path / "missing.orbax"), tm, device="cpu")


def test_zstd_on_the_chunks_tensorstore_wrote(tmp_path, rng):
    """Every zarr chunk of a JAX save (zstd level 1 from tensorstore) decodes
    as zstandard decodes it."""
    jm, _, jp, _, _ = _pair("FFNN", "float64", rng)
    path = jck.save_orbax(str(tmp_path / "j.orbax"), jm, jp, step=3, key=jax.random.PRNGKey(0),
                          spins=jnp.asarray(np.where(rng.random((256, 8)) < 0.5, -1.0, 1.0)))
    store = ocdbt.OcdbtStore(path)
    chunks = [k for k in store.list() if not k.endswith(".zarray")]
    assert len(chunks) >= 8
    for key in chunks:
        raw = store.read(key)
        assert zstd.decompress(raw) == zstandard.ZstdDecompressor().decompressobj().decompress(raw)


# ---------------------------------------------------------------------------
# the port's files
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", KINDS)
def test_jax_reads_the_ports_orbax(kind, dtype, tmp_path, rng):
    """JAX's load_orbax (Orbax's restore) reads a port file as the port
    saved it; the port restores its generator's state."""
    jm, tm, _, tp, _ = _pair(kind, dtype, rng)
    spins = torch.as_tensor(np.where(rng.random((16, 8)) < 0.5, -1.0, 1.0), dtype=tm.dtype)
    g = torch.Generator().manual_seed(7)
    torch.rand(5, generator=g)
    path = tck.save_orbax(str(tmp_path / "t.orbax"), tm, tp, step=17, generator=g, spins=spins,
                          extra={"lnpsi": torch.arange(3.0)})
    jp, jstep, key, jspins, jextra = jck.load_orbax(path, jm)
    assert jstep == 17 and key is None and np.array_equal(np.asarray(jspins), spins.numpy())
    for name, _ in tm.param_spec():
        assert np.array_equal(_np(jp[name]), tp[name].numpy())
    assert np.array_equal(np.asarray(jextra["lnpsi"]), np.arange(3.0, dtype=np.float32))
    assert bytes(np.asarray(jextra["generator_device"])) == b"cpu"
    p2, step, g2, sp2, extra = tck.load_orbax(path, tm, device="cpu")
    assert step == 17 and torch.equal(sp2, spins) and list(extra) == ["lnpsi"]
    assert torch.equal(torch.rand(6, generator=g), torch.rand(6, generator=g2))
    for name, _ in tm.param_spec():
        assert torch.equal(p2[name], tp[name])


def test_tree_metadata_is_the_jax_packages(tmp_path, rng):
    """The same tree gets the same leaf keys and key types from both
    packages: with and without the random state (the port's in extra)."""
    jm, tm, jp, tp, _ = _pair("FFNNSfSymm", "float32", rng)
    spins = np.ones((4, 8), np.float32)
    g = torch.Generator().manual_seed(0)
    gextra = {"generator": g.get_state().numpy(), "generator_device": np.frombuffer(b"cpu", np.uint8).copy()}
    for label, jkw, tkw in (("bare", {}, {}),
                            ("state", {"spins": jnp.asarray(spins), "extra": gextra},
                             {"spins": torch.as_tensor(spins), "generator": g})):
        jpath = jck.save_orbax(str(tmp_path / f"j{label}.orbax"), jm, jp, step=4, **jkw)
        tpath = tck.save_orbax(str(tmp_path / f"t{label}.orbax"), tm, tp, step=4, **tkw)
        want = json.loads(Path(jpath, "_METADATA").read_text())["tree_metadata"]
        got = json.loads(Path(tpath, "_METADATA").read_text())["tree_metadata"]
        assert list(got) == list(want)
        assert [v["key_metadata"] for v in got.values()] == [v["key_metadata"] for v in want.values()]
        assert {v["value_metadata"]["value_type"] for v in got.values()} == {"np.ndarray"}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_dtype_and_wrong_machine(writer, tmp_path):
    """test_utils.py::test_orbax_roundtrip's cases, on either package's
    file: a float64 save loads into a float32 machine and back, another
    machine or another shape is refused."""
    jm = jmodels.RBM(n_inputs=5, n_hiddens=7, dtype=jnp.float64)
    tm64 = tmodels.RBM(n_inputs=5, n_hiddens=7, dtype=torch.float64)
    jp = jm.init_params(jax.random.PRNGKey(2))
    path = str(tmp_path / "c.orbax")
    if writer == "jax":
        jck.save_orbax(path, jm, jp, step=7, key=jax.random.PRNGKey(3), spins=jnp.ones((4, 5)),
                       extra={"lnpsi_re": jnp.zeros((4,))})
    else:
        tp, *_ = tck.load_orbax(jck.save_orbax(str(tmp_path / "j.orbax"), jm, jp), tm64, device="cpu")
        tck.save_orbax(path, tm64, tp, step=7, generator=torch.Generator(), spins=torch.ones(4, 5, dtype=torch.float64),
                       extra={"lnpsi_re": torch.zeros(4, dtype=torch.float64)})
    p64, step, gen, sp, extra = tck.load_orbax(path, tm64, device="cpu")
    assert step == 7 and gen is not None and "lnpsi_re" in extra and (sp == 1).all()
    m32 = tmodels.RBM(n_inputs=5, n_hiddens=7, dtype=torch.float32)
    p32, _, _, sp32, _ = tck.load_orbax(path, m32, device="cpu")
    assert p32["w"].dtype == torch.complex64 and sp32.dtype == torch.float32
    for name in p32:
        assert torch.equal(p32[name], p64[name].to(torch.complex64))
        want = _np(jp[name])
        assert np.array_equal(p64[name].numpy(), want)
    with pytest.raises(ValueError, match="checkpoint is for RBM"):
        tck.load_orbax(path, tmodels.FFNN(n_inputs=5, n_hiddens=7, dtype=torch.float64), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tck.load_orbax(path, tmodels.RBM(n_inputs=5, n_hiddens=6, dtype=torch.float64), device="cpu")


def test_write_replaces_whole_and_leaves_nothing_behind(tmp_path):
    """The directory is renamed into place: force=True replaces an existing
    one, without it the write is refused, and a failed write leaves neither
    a partial target nor its temporary directory."""
    path = tmp_path / "x.orbax"
    orbax_format.write(str(path), {"a": np.arange(3), "b": {"c": np.float64(2.5)}})
    got = orbax_format.read(str(path))
    assert got["b"]["c"].shape == () and got["b"]["c"] == 2.5 and got["a"].dtype == np.arange(3).dtype
    with pytest.raises(FileExistsError):
        orbax_format.write(str(path), {"a": np.arange(4)})
    orbax_format.write(str(path), {"a": np.arange(4), "e": np.zeros((0, 3))}, force=True)
    got = orbax_format.read(str(path))
    assert set(got) == {"a", "e"} and np.array_equal(got["a"], np.arange(4)) and got["e"].shape == (0, 3)
    with pytest.raises(TypeError):
        orbax_format.write(str(tmp_path / "bad.orbax"), {"a": np.arange(2), "z": np.asarray(object())})
    assert sorted(os.listdir(tmp_path)) == ["x.orbax"]


def test_zarr3_raises_and_names_itself(tmp_path):
    path = tmp_path / "z.orbax"
    orbax_format.write(str(path), {"a": np.arange(3)})
    meta = json.loads((path / "_METADATA").read_text())
    (path / "a" / "zarr.json").write_text("{}")
    with pytest.raises(orbax_format.OrbaxFormatError, match="zarr v3"):
        orbax_format.read(str(path))
    meta["use_zarr3"] = True
    (path / "_METADATA").write_text(json.dumps(meta))
    with pytest.raises(orbax_format.OrbaxFormatError, match="zarr v3"):
        orbax_format.read(str(path))


@pytest.mark.parametrize("run", ["one", "mesh4"])
def test_committed_fixtures_read_the_same(run):
    """The committed JAX fixtures: both packages read the same state, whose
    parameters are the run's text checkpoint to its 8 printed digits."""
    path = FIXTURES / run / (FIXTURE_PREFIX + ".orbax")
    for store in _orbax_stores(str(path)):
        _same_as_tensorstore(store)
    jm = jmodels.RBMTrSymm(n_inputs=16, alpha=2, dtype=jnp.float32)
    tm = tmodels.RBMTrSymm(n_inputs=16, alpha=2, dtype=torch.float32)
    params, step, _, spins = _same_loads(str(path), jm, tm)
    assert step == 5 and spins.shape == (512, 16) and set(spins.unique().tolist()) == {-1.0, 1.0}
    text = tck.load_reference_text(tm, str(FIXTURES / run / FIXTURE_PREFIX), device="cpu")
    for name in params:
        np.testing.assert_allclose(params[name].numpy(), text[name].numpy(), rtol=1e-7, atol=0)


def test_reading_needs_none_of_the_jax_side_packages():
    """In a process where jax, orbax, tensorstore, zstandard and
    google_crc32c cannot be imported, the port reads the fixtures and
    writes and reads its own checkpoint."""
    code = f"""
import sys
for m in ("jax", "orbax", "tensorstore", "zstandard", "google_crc32c", "neural_network_quantum_state_tpu"):
    sys.modules[m] = None
import tempfile, torch
from neural_network_quantum_state_tpu_torch.models import RBMTrSymm
from neural_network_quantum_state_tpu_torch.utils.checkpoint import load_orbax, save_orbax
m = RBMTrSymm(n_inputs=16, alpha=2, dtype=torch.float32)
for run in ("one", "mesh4"):
    p, step, g, s, _ = load_orbax({str(FIXTURES)!r} + "/" + run + "/{FIXTURE_PREFIX}.orbax", m, device="cpu")
    assert step == 5 and s.shape == (512, 16) and g is not None
with tempfile.TemporaryDirectory() as d:
    save_orbax(d + "/t.orbax", m, p, step=6, generator=g, spins=s)
    assert load_orbax(d + "/t.orbax", m, device="cpu")[1] == 6
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
