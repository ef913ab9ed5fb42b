"""The frozen traffic is a function of the seed."""

from __future__ import annotations

import numpy as np
import torch

from portbench.traffic import events

TRAFFIC = {"store": "train", "n_events": 3, "event_frames": 8, "h": 16, "w": 16, "window": 4,
           "n_cells": 5, "n_gauges": 20}


def _files(root):
    return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def test_same_seed_same_inputs(tmp_path):
    a = events.make_traffic(TRAFFIC, 2 ** 31 + 5, tmp_path / "a", "cpu")
    b = events.make_traffic(TRAFFIC, 2 ** 31 + 5, tmp_path / "b", "cpu")
    assert np.array_equal(a["frames"], b["frames"]) and np.array_equal(a["mask"], b["mask"])
    assert _files(tmp_path / "a") == _files(tmp_path / "b")


def test_other_seed_other_inputs_same_sizes(tmp_path):
    a = events.make_traffic(TRAFFIC, 11, tmp_path / "a", "cpu")
    b = events.make_traffic(TRAFFIC, 12, tmp_path / "b", "cpu")
    assert a["frames"].shape == b["frames"].shape == (3, 8, 16, 16)
    assert not np.array_equal(a["frames"], b["frames"])
    assert a["mask"].sum() == b["mask"].sum() == 20


def test_stores_hold_the_frames(tmp_path):
    from p2igan_tpu_torch.data import zarrlite

    out = events.make_traffic(TRAFFIC, 7, tmp_path, "cpu")
    g = zarrlite.open_group(out["store"], mode="r")
    keys = sorted(g["events"].keys())
    for i, key in enumerate(keys):
        assert np.array_equal(np.asarray(g["events"][key]["frames"][:]), out["frames"][i])
    windows = np.asarray(g["index"]["windows"][:])
    assert windows.shape == (3 * 5, 3) and set(windows[:, 2]) == {4}
    assert np.array_equal(np.loadtxt(out["mask_file"]).astype(np.int64), out["mask"])
    test = dict(TRAFFIC, store="test", warmup_events=1)
    out = events.make_traffic(test, 7, tmp_path / "t", "cpu")
    g = zarrlite.open_group(out["store"], mode="r")
    assert np.array_equal(np.asarray(g["event_02"][:]), out["frames"][1].astype(np.float32))


def test_events_look_like_storms():
    gen = torch.Generator().manual_seed(3)
    frames = events.synthesize_events(gen, 2, 4, 128, 128, 4, "cpu")
    assert frames.dtype == np.uint8 and frames.max() > 60 and (frames == 0).mean() > 0.05
