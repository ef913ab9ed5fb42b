"""The port's host-IO core (``p2igan_tpu_torch/native/p2io.cpp`` through
``data/native.py``): its windows against the pure-Python chunk loop and the
JAX package's core for every codec, its zstd bytes against ctypes and the JAX
core, no quiet fallback (a failed decode or build raises), a new library for
a new source, concurrent readers, and the training dataset against JAX's.

The JAX core is built into a temporary directory here, never next to its
module, so these tests race no other test file for that file."""

import concurrent.futures as cf
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from p2igan_tpu.data import native as jnative
from p2igan_tpu.data import stores as jstores
from p2igan_tpu_torch.data import fake, native, stores, zarrlite

REPO = Path(__file__).resolve().parents[1]
CODECS = [None, {"id": "zlib", "level": 1}, {"id": "gzip", "level": 1},
          {"id": "zstd", "level": 3}, {"id": "blosc", "cname": "zstd", "clevel": 5}]
SHAPE, CHUNKS = (37, 45, 50), (10, 16, 12)
# (starts, stops): inside one chunk, across borders on all three axes, the
# whole array, one frame, a window that ends on the ragged last chunks
WINDOWS = [((1, 2, 3), (9, 14, 11)), ((7, 13, 5), (26, 40, 31)), ((0, 0, 0), SHAPE),
           ((20, 0, 0), (21, 45, 50)), ((29, 30, 35), SHAPE)]


@pytest.fixture(scope="module", autouse=True)
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the host-IO core cannot be built")


@pytest.fixture(scope="module")
def jax_core(tmp_path_factory):
    """The JAX package's core, built into a temporary file; None where it
    cannot build because libblosc, which it links, is absent (the tests then
    hold the port's core to the plain loop alone)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_OUT", tmp_path_factory.mktemp("jax_core") / "libp2io.so")
        mp.setattr(jnative, "_LIB", None)
        mp.setattr(jnative, "_TRIED", False)
        if jnative.get_lib() is not None:
            yield jnative
            return
        try:
            zarrlite._load_blosc()
        except OSError:
            yield None
            return
        pytest.fail("the JAX package's core did not build")


def _codec_loads(compressor) -> None:
    loader = {"zstd": zarrlite._load_zstd, "blosc": zarrlite._load_blosc}.get(
        (compressor or {}).get("id"))
    try:
        loader and loader()
    except OSError:
        pytest.skip(f"no system lib{compressor['id']}")


def _store(tmp_path, compressor, missing=((1, 1, 2), (3, 2, 0))):
    """A (37, 45, 50) uint8 array in (10, 16, 12) chunks with two chunk
    files removed (read as zeros); returns the array and the data it holds."""
    _codec_loads(compressor)
    data = np.random.default_rng(3).integers(0, 256, size=SHAPE, dtype=np.uint8)
    g = zarrlite.open_group(tmp_path / "s.zarr", mode="w")
    arr = g.create_dataset("frames", shape=SHAPE, chunks=CHUNKS, dtype="uint8",
                           compressor=compressor, data=data)
    for cidx in missing:
        arr._chunk_path(cidx).unlink()
        sel = tuple(slice(i * c, (i + 1) * c) for i, c in zip(cidx, CHUNKS))
        data[sel] = 0
    return arr, data


def _chunk_list(arr, starts, stops):
    return [(cidx, p if p.exists() else None)
            for cidx in zarrlite._chunks_overlapping(starts, stops, arr.chunks)
            for p in [arr._chunk_path(cidx)]]


@pytest.mark.parametrize("compressor", CODECS, ids=lambda c: (c or {"id": "none"})["id"])
def test_core_window_equals_the_plain_loop_and_the_jax_core(tmp_path, compressor, jax_core):
    arr, data = _store(tmp_path, compressor)
    comp_id = None if compressor is None else compressor["id"]
    for starts, stops in WINDOWS:
        sel = tuple(slice(a, b) for a, b in zip(starts, stops))
        assert arr._native_reads(starts, stops)
        got = arr._read_native(starts, stops)
        np.testing.assert_array_equal(got, arr._read_plain(starts, stops))
        np.testing.assert_array_equal(got, data[sel])
        np.testing.assert_array_equal(arr[sel], data[sel])  # __getitem__ routes to the core
        if jax_core is not None:
            window = tuple(b - a for a, b in zip(starts, stops))
            theirs = jax_core.read_window_u8(_chunk_list(arr, starts, stops), arr.chunks,
                                             starts, window, comp_id)
            np.testing.assert_array_equal(got, theirs)


def test_other_arrays_keep_the_plain_loop(tmp_path):
    g = zarrlite.open_group(tmp_path / "s.zarr", mode="w")
    f32 = g.create_dataset("f", shape=(4, 6, 6), chunks=(2, 4, 4), dtype="float32",
                           data=np.ones((4, 6, 6), np.float32))
    u8_2d = g.create_dataset("m", shape=(6, 6), chunks=(4, 4), dtype="uint8")
    filled = g.create_dataset("x", shape=(4, 6, 6), chunks=(2, 4, 4), dtype="uint8",
                              fill_value=7)
    for arr, key in ((f32, (0, 0, 0)), (u8_2d, (0, 0)), (filled, (0, 0, 0))):
        assert not arr._native_reads(key, arr.shape)
    assert not filled._native_reads((0, 0, 0), (0, 6, 6))  # empty window
    np.testing.assert_array_equal(filled[:], 7)
    np.testing.assert_array_equal(f32[1:3], 1.0)


@pytest.mark.parametrize("size", [0, 1, 1000, 1 << 20])
@pytest.mark.parametrize("level", [1, 3])
def test_zstd_compress_equals_ctypes_and_the_jax_core(size, level, jax_core):
    _codec_loads({"id": "zstd"})
    data = np.random.default_rng(size).integers(0, 8, size=size, dtype=np.uint8).tobytes()
    got = native.zstd_compress(data, level)
    assert got == zarrlite._zstd_compress_plain(data, level)
    if jax_core is not None:
        assert got == jax_core.zstd_compress(data, level)
    assert zarrlite.compress(data, {"id": "zstd", "level": level}) == got
    assert zarrlite.decompress(got, {"id": "zstd"}, size) == data


@pytest.mark.parametrize("compressor,damage", [
    ({"id": "zstd", "level": 3}, "truncate"), ({"id": "zstd", "level": 3}, "corrupt"),
    ({"id": "zlib", "level": 1}, "truncate"), ({"id": "gzip", "level": 1}, "corrupt"),
    (None, "truncate"), ({"id": "zlib", "level": 1}, "short")])
def test_a_damaged_chunk_raises_where_jax_falls_back(tmp_path, compressor, damage, jax_core):
    arr, _ = _store(tmp_path, compressor, missing=())
    path = arr._chunk_path((1, 0, 0))
    blob = path.read_bytes()
    if damage == "truncate":
        blob = blob[:len(blob) // 2]
    elif damage == "corrupt":
        blob = blob[:8] + bytes(b ^ 0x5A for b in blob[8:])
    else:  # a whole stream, of one frame less than the chunk holds
        blob = zarrlite.compress(bytes(np.prod(CHUNKS) - CHUNKS[1] * CHUNKS[2]), compressor)
    path.write_bytes(blob)
    starts, stops = (5, 3, 0), (15, 20, 12)
    comp_id = None if compressor is None else compressor["id"]
    with pytest.raises(RuntimeError, match=rf"{path.name} \(codec {comp_id}\)") as err:
        arr[5:15, 3:20, 0:12]
    assert str(path) in str(err.value)
    if damage == "short":
        assert f"decodes to {np.prod(CHUNKS) - 192} bytes, expected {np.prod(CHUNKS)}" \
            in str(err.value)
    if jax_core is not None:
        window = tuple(b - a for a, b in zip(starts, stops))
        assert jax_core.read_window_u8(_chunk_list(arr, starts, stops), arr.chunks, starts,
                                       window, comp_id) is None  # JAX's zarrlite falls back


def test_a_missing_codec_library_raises_as_the_plain_path_does(tmp_path, monkeypatch):
    arr, _ = _store(tmp_path, {"id": "zlib", "level": 1}, missing=())
    arr.compressor = {"id": "blosc"}  # as a blosc store would read
    native.library()  # loaded before ctypes.CDLL stops finding libraries
    monkeypatch.setattr(zarrlite, "_BLOSC", None)
    monkeypatch.setitem(native._TABLES, "blosc", None)

    def absent(name, *a, **k):
        raise OSError(f"{name}: cannot open shared object file: No such file or directory")

    monkeypatch.setattr(zarrlite.ctypes, "CDLL", absent)
    errors = []
    for read in (arr._read_native, arr._read_plain):
        with pytest.raises(OSError) as err:
            read((0, 0, 0), (5, 5, 5))
        errors.append(str(err.value))
    assert errors[0] == errors[1] and "blosc" in errors[0]


def test_a_failed_build_raises_with_the_compiler_output(tmp_path):
    src = tmp_path / "p2io.cpp"
    src.write_text(native._SRC.read_text() + "\nint broken( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.build(src, tmp_path / "libp2io.so")
    assert "error" in str(err.value) and "p2io.cpp" in str(err.value)
    assert not list(tmp_path.glob("*.so"))


def test_a_changed_source_builds_a_new_library(tmp_path, monkeypatch):
    src = tmp_path / "p2io.cpp"
    src.write_bytes(native._SRC.read_bytes())
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    before = native.library_path(src)
    assert before.name == native.library_path().name  # the same source, the same name
    src.write_text(src.read_text() + "\n// changed\n")
    after = native.library_path(src)
    assert after != before and after.parent == before.parent
    monkeypatch.setattr(native, "_SRC", src)
    monkeypatch.setattr(native, "_LIB", None)
    lib = native.library()  # builds the changed source, never loads `before`
    assert after.exists() and not before.exists()
    assert lib._name == str(after)
    assert not list(after.parent.glob("*.tmp.so"))


def test_concurrent_readers_get_the_single_thread_result(tmp_path):
    arr, data = _store(tmp_path, {"id": "zstd", "level": 3})
    rng = np.random.default_rng(1)
    keys = []
    for _ in range(64):
        starts = tuple(int(rng.integers(0, s)) for s in SHAPE)
        stops = tuple(int(rng.integers(a + 1, s + 1)) for a, s in zip(starts, SHAPE))
        keys.append(tuple(slice(a, b) for a, b in zip(starts, stops)))
    single = [arr[k] for k in keys]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with cf.ThreadPoolExecutor(max_workers=12) as pool:
            futures = [pool.submit(arr.__getitem__, k) for k in keys * 4]
            done, pending = cf.wait(futures, timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not pending
    for i, fut in enumerate(futures):
        np.testing.assert_array_equal(fut.result(), single[i % len(keys)])
        np.testing.assert_array_equal(single[i % len(keys)], data[keys[i % len(keys)]])


@pytest.mark.parametrize("device_decode", [False, True])
@pytest.mark.parametrize("mask", [{"type": "stis"}, {"type": "nowcasting", "keep": 2}])
def test_window_dataset_equals_jax(tmp_path, device_decode, mask, jax_core):
    store = fake.write_train_zarr(tmp_path / "train.zarr", n_events=2, T=24, H=40, W=36,
                                  window=8, stride=3, seed=5)
    if mask["type"] == "stis":
        mask = {**mask, "file": str(fake.write_gauge_mask(tmp_path / "m.txt", H=32, W=24,
                                                          n_gauges=9, seed=2))}
    args = {"data_root": str(store), "w": 24, "h": 32, "mask": mask,
            "device_decode": device_decode}
    ours, theirs = stores.ZarrWindowDataset(args), jstores.ZarrWindowDataset(args)
    assert len(ours) == len(theirs) == 12
    for i in range(len(ours)):
        got = ours.__getitem__(i, rng=np.random.default_rng((7, i)))
        want = theirs.__getitem__(i, rng=np.random.default_rng((7, i)))
        assert len(got) == len(want) == (2 if device_decode else 3)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)

