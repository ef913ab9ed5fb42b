"""The port's own copies of the JAX package's jax-free host modules
(``config``, ``data.zarrlite``, ``data.fake``, ``utils.tracking``,
``ops.wendland``) behave as their originals: the same bytes on disk, the same
arrays back, the same dictionaries. The port's zarrlite keeps only the
pure-Python chunk loop, so every read is held to the original's (which takes
its C++ window reader where it can)."""

import json
from pathlib import Path

import numpy as np
import pytest

from p2igan_tpu import config as jconfig
from p2igan_tpu.data import fake as jfake
from p2igan_tpu.data import zarrlite as jzarr
from p2igan_tpu.utils import tracking as jtracking
from p2igan_tpu_torch import config as tconfig
from p2igan_tpu_torch.data import fake as tfake
from p2igan_tpu_torch.data import zarrlite as tzarr
from p2igan_tpu_torch.utils import tracking as ttracking

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "p2igan_tpu_torch" / "config").glob("*.json"))


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_functions_equal_the_originals(path):
    ours, theirs = tconfig.load_config(path), jconfig.load_config(path)
    assert ours == theirs
    assert tconfig.flatten_dict(ours) == jconfig.flatten_dict(theirs)
    # dataset args inherit train -> test, an explicit null deleting a key
    got, want = (m.build_dataset_args(ours["data"]["train"]) for m in (tconfig, jconfig))
    assert got == want and got["sample_length"] == 16
    shared = tconfig.extract_shared_params(got)
    assert shared == jconfig.extract_shared_params(want)
    got, want = (m.build_dataset_args(ours["data"]["test"],
                                      defaults=m.drop_sample_length(dict(shared)))
                 for m in (tconfig, jconfig))
    assert got == want and "sample_length" not in got
    merged = [m.merge_overrides(json.loads(json.dumps(ours)), {"train.batch_size": 3})
              for m in (tconfig, jconfig)]
    assert merged[0] == merged[1]


def test_config_public_names_are_all_there():
    names = [n for n in dir(jconfig) if not n.startswith("_")]
    assert [n for n in names if not hasattr(tconfig, n)] == []


@pytest.mark.parametrize("compressor", [None, {"id": "zlib", "level": 1},
                                        {"id": "zstd", "level": 1}])
@pytest.mark.parametrize("dtype,shape,chunks", [
    ("uint8", (23, 16, 12), (5, 16, 12)),      # the training layout, ragged in T
    ("float32", (7, 8, 8, 1), (7, 8, 8, 1)),   # an event written in one chunk
    ("int64", (11, 3), (4, 3))])
def test_zarrlite_copies_read_each_other(tmp_path, compressor, dtype, shape, chunks):
    if compressor and compressor["id"] == "zstd":
        try:
            tzarr._load_zstd()
        except OSError:
            pytest.skip("no system libzstd")
    rng = np.random.default_rng(0)
    data = (rng.random(shape) * 200).astype(dtype)
    for name, mod in (("ours", tzarr), ("theirs", jzarr)):
        g = mod.open_group(tmp_path / name, mode="w")
        g.attrs.update({"who": "test", "n": 3})
        sub = g.create_group("events")
        ds = sub.create_dataset("frames", shape=shape, chunks=chunks, dtype=dtype,
                                compressor=compressor)
        ds[:] = data
    assert _tree(tmp_path / "ours") == _tree(tmp_path / "theirs")
    for store in ("ours", "theirs"):
        for mod in (tzarr, jzarr):
            arr = mod.open(tmp_path / store, mode="r")["events"]["frames"]
            assert arr.shape == shape and arr.dtype == np.dtype(dtype)
            np.testing.assert_array_equal(arr[:], data)
            np.testing.assert_array_equal(arr[3:9], data[3:9])
            np.testing.assert_array_equal(arr[6], data[6])
            if len(shape) == 3:  # the training window read, cropped
                np.testing.assert_array_equal(arr[4:20, 2:14, 1:9], data[4:20, 2:14, 1:9])
    assert dict(tzarr.open(tmp_path / "theirs", mode="r").attrs) == {"who": "test", "n": 3}


def test_fake_data_copies_write_the_same_stores(tmp_path):
    for name, mod in (("ours", tfake), ("theirs", jfake)):
        root = tmp_path / name
        mod.write_train_zarr(root / "train.zarr", n_events=2, T=8, H=16, W=16,
                             window=4, stride=2, seed=3)
        mask = mod.write_gauge_mask(root / "mask.txt", H=16, W=16, n_gauges=9, seed=4)
        assert np.loadtxt(mask).sum() == 9
    assert _tree(tmp_path / "ours") == _tree(tmp_path / "theirs")
    a = tfake.synthesize_event(np.random.default_rng(5), 6, 16, 16)
    b = jfake.synthesize_event(np.random.default_rng(5), 6, 16, 16)
    assert a.dtype == np.uint8 and a.shape == (6, 16, 16)
    np.testing.assert_array_equal(a, b)


def test_file_tracker_copies_write_the_same_run(tmp_path):
    trees = {}
    for name, mod in (("ours", ttracking), ("theirs", jtracking)):
        tracker = mod.FileTracker(str(tmp_path / name))
        tracker.set_experiment("exp")
        with tracker.start_run(run_name="run"):
            tracker.log_params({"a": 1, "b.c": "x"})
            tracker.log_metric("loss", 0.5, step=1)
            tracker.log_metric("loss", 0.25, step=2)
        runs = [p for p in (tmp_path / name / "exp").iterdir() if p.is_dir()]
        assert len(runs) == 1
        params = json.loads((runs[0] / "params.json").read_text())
        metrics = [json.loads(line) for line in
                   (runs[0] / "metrics.jsonl").read_text().splitlines()]
        trees[name] = (params, [(m["key"], m["value"], m["step"]) for m in metrics])
    assert trees["ours"] == trees["theirs"]
    assert trees["ours"][1] == [("loss", 0.5, 1), ("loss", 0.25, 2)]
