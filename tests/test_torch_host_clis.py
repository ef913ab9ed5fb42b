"""The port's host CLIs against the JAX package's, on the same ``.h5`` events.

``scripts/tozarr_torch.py`` and ``scripts/preprocess_torch.py`` must write
the stores ``scripts/tozarr.py`` and ``scripts/preprocess.py`` write: every
array bitwise, the ``.zarray`` metadata, the attrs and the window index
equal. ``scripts/visualize_torch.py`` writes as many GIF frames as
``scripts/visualize.py``, captions each with numpy's min, max and mean, and
colours within one level of 255 of ``matplotlib.cm.viridis``, with neither
matplotlib nor imageio importable. Each script's ``main`` runs in this
process (the JAX scripts read ``sys.argv``)."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

REPO = Path(__file__).resolve().parents[1]
LENGTHS = {101: 9, 205: 6}  # timestamp -> frames, as tests/test_data.py's events


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(f"cli_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_jax_script(name: str, argv, monkeypatch) -> None:
    module = load_script(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *map(str, argv)])
    module.main()


@pytest.fixture(scope="module")
def h5_dir(tmp_path_factory):
    import h5py

    out = tmp_path_factory.mktemp("h5")
    rng = np.random.default_rng(0)
    for ts, t in LENGTHS.items():
        with h5py.File(out / f"event_{ts}.h5", "w") as f:
            f.create_dataset("frames", data=rng.integers(0, 255, (t, 16, 16), dtype=np.uint8))
    return out


def store_files(root: Path) -> dict:
    """{relative path: parsed JSON} of every metadata file of a store."""
    return {p.relative_to(root).as_posix(): json.loads(p.read_text())
            for p in sorted(root.rglob(".z*"))}


def array_paths(meta: dict) -> list:
    return sorted(k[:-len("/.zarray")] if k != ".zarray" else ""
                  for k in meta if k.endswith(".zarray"))


def assert_stores_equal(a: Path, b: Path) -> None:
    from p2igan_tpu_torch.data import zarrlite

    meta_a, meta_b = store_files(a), store_files(b)
    assert meta_a == meta_b  # .zarray (shape, chunks, dtype, compressor), .zattrs, .zgroup
    paths = array_paths(meta_a)
    assert paths
    ra, rb = zarrlite.open(a, mode="r"), zarrlite.open(b, mode="r")
    for path in paths:
        xa, xb = ra[path][:], rb[path][:]
        assert xa.dtype == xb.dtype and xa.shape == xb.shape
        assert xa.tobytes() == xb.tobytes(), path


def test_tozarr_matches_the_jax_script(h5_dir, tmp_path, monkeypatch):
    table = tmp_path / "events.json"
    table.write_text(json.dumps([{"id": 101, "start": "2020-01-01 00:00", "end": "x",
                                  "duration": 0.75, "max_rg": 3.5, "max_rd": 4.0,
                                  "mean_rg": 1.25, "mean_rd": 1.5}]))
    argv = ["--h5-dir", h5_dir, "--event-table", table, "--dataset-name", "fake"]
    run_jax_script("tozarr", argv + ["--output", tmp_path / "jax.zarr"], monkeypatch)
    load_script("tozarr_torch").main([*map(str, argv), "--output", str(tmp_path / "port.zarr")])
    assert_stores_equal(tmp_path / "jax.zarr", tmp_path / "port.zarr")
    meta = store_files(tmp_path / "port.zarr")
    assert meta["event_101/.zattrs"]["max_rainfall_rd_mm"] == 4.0
    assert meta["event_205/.zarray"]["chunks"] == [6, 16, 16]


@pytest.mark.parametrize("window,stride,chunk", [(4, 2, 128), (3, 1, 8)])
def test_preprocess_matches_the_jax_script(h5_dir, tmp_path, monkeypatch, window, stride,
                                           chunk):
    argv = ["--h5-dir", h5_dir, "--window", window, "--stride", stride,
            "--spatial-chunk", chunk]
    run_jax_script("preprocess", argv + ["--output", tmp_path / "jax.zarr"], monkeypatch)
    load_script("preprocess_torch").main([*map(str, argv),
                                          "--output", str(tmp_path / "port.zarr")])
    assert_stores_equal(tmp_path / "jax.zarr", tmp_path / "port.zarr")
    from p2igan_tpu_torch.data import zarrlite

    root = zarrlite.open_group(tmp_path / "port.zarr")
    assert root.attrs["suggested_window"] == window
    idx = root["index"]["windows"][:]
    want = [[e, s, window] for e, t in enumerate(LENGTHS.values())
            for s in range(0, t - window + 1, stride)]
    np.testing.assert_array_equal(idx, np.asarray(want, np.int32))
    sc = min(chunk, 16)
    assert store_files(tmp_path / "port.zarr")["events/101/frames/.zarray"]["chunks"] == \
        [window, sc, sc]


def test_the_converters_name_h5py_when_it_is_missing(h5_dir, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    for name in ("tozarr_torch", "preprocess_torch"):
        with pytest.raises(SystemExit, match="h5py"):
            load_script(name).main(["--h5-dir", str(h5_dir),
                                    "--output", str(tmp_path / f"{name}.zarr")])


def gif_frames(path: Path) -> int:
    with Image.open(path) as im:
        return im.n_frames


def test_visualize_matches_the_jax_script(h5_dir, tmp_path, monkeypatch):
    import matplotlib

    store = tmp_path / "test.zarr"
    load_script("tozarr_torch").main(["--h5-dir", str(h5_dir), "--output", str(store)])
    run_jax_script("visualize", ["--zarr", store, "--output", tmp_path / "jax.gif",
                                 "--num-frames", 6], monkeypatch)
    port = load_script("visualize_torch")
    with monkeypatch.context() as m:
        for name in ("matplotlib", "imageio"):
            m.setitem(sys.modules, name, None)  # any import of them now raises
        captions = port.main(["--zarr", str(store), "--output", str(tmp_path / "port.gif"),
                              "--num-frames", "6"])
    assert gif_frames(tmp_path / "port.gif") == gif_frames(tmp_path / "jax.gif") == 6
    from p2igan_tpu_torch.data import zarrlite

    data = zarrlite.open(store, mode="r")["event_101"][:6]
    cmap = matplotlib.colormaps["viridis"]
    for t, (frame, text) in enumerate(zip(data, captions)):
        vmin, vmax, vmean = float(frame.min()), float(frame.max()), float(frame.mean())
        got = [float(v) for v in re.findall(r"=(-?[\d.]+)", text)]
        assert got == [t, round(vmin, 3), round(vmax, 3), round(vmean, 3)], text
        want = cmap(matplotlib.colors.Normalize(vmin, vmax)(frame))[..., :3] * 255
        diff = np.abs(port.colorize(frame, vmin, vmax).astype(np.float64) - want)
        assert diff.max() <= 1.0, (t, diff.max())
