"""The plain reference agrees with the port at a tiny size on the CPU: the
generators alone, and whole runs of the tiny cells (the p2igan GAN step,
the dk step, the served events), which compare as the card's runs do."""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch

from conftest import run_tiny
from portbench import core
from portbench.reference import common


def _inputs(cfg, seed=4):
    s = {"T": 4, "H": 16, "W": 16}
    rng = np.random.default_rng(seed)
    mask = np.zeros(s["H"] * s["W"], np.int64)
    mask[rng.choice(mask.size, 79, replace=False)] = 1
    mask = mask.reshape(s["H"], s["W"])
    x = torch.from_numpy(rng.random((2, s["T"], s["H"], s["W"], 1), dtype=np.float32))
    m = torch.from_numpy(mask.astype(np.float32))[None, None, :, :, None].expand_as(x)
    return mask, x * m, m.contiguous()


@pytest.mark.parametrize("config", ["tiny_p2igan_stis_gan", "tiny_dk_stis"])
def test_generator_matches_the_port(tiny_root, config):
    from p2igan_tpu_torch.models import build_generator

    raw = json.loads((tiny_root / "configs" / f"{config}.json").read_text())
    cfg = {k: v for k, v in raw.items() if k not in ("source", "reduced", "assumed", "reference")}
    model = __import__(f"portbench.reference.{raw['reference']}", fromlist=["x"])
    mask, masked, masks = _inputs(cfg)
    cfg = copy.deepcopy(cfg)
    cfg["data"]["train"]["mask"]["file"] = None
    weights = common.make_weights(model.generator_spec(cfg), 9, "cpu")
    gen = build_generator(cfg, device="cpu")
    gen.load_state_dict(weights)
    with torch.no_grad():
        want = model.generator(weights, masked, model.prepare(mask, 4, "cpu"), cfg)
        got = gen(masked, masks)
    assert float((got - want).abs().max()) < 1e-5


@pytest.mark.parametrize("seed", [3000000017, 2 ** 31 + 5, 4000000001])
def test_served_weights_clip_half_of_the_frames(tiny_root, seed):
    """Served weights differ from the seed's draw only in the signs of whole
    output rows, and leave half of the frames of the balancing window at or
    below zero, whatever the seed."""
    from portbench.reference import p2igan as model
    from portbench.reference import serve as ref_serve
    from portbench.traffic.events import gauge_mask, synthesize_events

    raw = json.loads((tiny_root / "configs" / "tiny_p2igan_stis_gan.json").read_text())
    cfg = {k: v for k, v in raw.items() if k not in ("source", "reduced", "assumed", "reference")}
    gen = torch.Generator().manual_seed(seed)
    mask = gauge_mask(gen, 16, 16, 20)
    frames = synthesize_events(gen, 1, 4, 16, 16, 4, "cpu")
    served = ref_serve.served_weights(model, cfg, frames, mask, seed, "cpu")
    drawn = common.make_weights(model.generator_spec(cfg), seed, "cpu")
    for name, t in drawn.items():
        got = served[f"G:{name}"]
        if name == model.OUTPUT_CONV:
            assert torch.equal(got.abs(), t.abs())
        else:
            assert torch.equal(got, t)
    x = torch.from_numpy(frames[:, :4].astype(np.float32) / 255.0)[..., None]
    x = x * torch.from_numpy(mask.astype(np.float32))[None, None, :, :, None]
    params = {n[2:]: t for n, t in served.items()}
    with torch.no_grad():
        out = model.generator(params, x, model.prepare(mask, 4, "cpu"), cfg)[0, ..., 0]
    assert int(((out <= 0).float().mean(dim=(1, 2)) > 0.5).sum()) == 2


@pytest.mark.parametrize("cell", ["tiny_p2igan_stis_gan.train_b12", "tiny_dk_stis.train_b12",
                                  "tiny_p2igan_stis_gan.serve_archive"])
def test_tiny_cell_is_correct(tiny_root, cell):
    line = run_tiny(tiny_root, cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    assert "setup_s" in line["metrics"] and list(line)[-1] == "checks"
    assert line["window"]["seconds"] >= 1.0


@pytest.mark.parametrize("cell", ["tiny_p2igan_stis_gan.train_b12", "tiny_dk_stis.train_b12"])
def test_training_window_is_whole_epochs(tiny_root, cell):
    """A window that reaches an epoch end starts and ends at one, so the
    epoch ends it holds do not follow the speed; the result line says how
    many it held."""
    w = run_tiny(tiny_root, cell)["window"]
    assert w["steps"] % w["steps_per_epoch"] == 0
    assert w["epoch_ends"] == w["steps"] // w["steps_per_epoch"] >= 1
    assert w["samples"] == 4 * w["steps"]


def test_serving_counts_whole_calls(tiny_root):
    """The served rate counts the archive's events in every call of the
    window; the stores read back are the kept call's and the last one's."""
    line = run_tiny(tiny_root, "tiny_p2igan_stis_gan.serve_archive", seconds=2.0)
    w = line["window"]
    assert w["events"] == 6 * w["calls"] == line["attempted"]
    rate = line["metrics"]["serve_events_per_s"]["value"]
    assert rate == pytest.approx(w["events"] / w["seconds"])
    assert 0 <= w["kept_call"] < 4


@pytest.mark.parametrize("cell", ["tiny_dk_stis.train_b12", "tiny_p2igan_stis_gan.serve_archive"])
def test_tiny_traced_run(tiny_root, cell):
    """A traced run on the CPU reports the readers that need no card and no
    device metric."""
    line = run_tiny(tiny_root, cell, trace=1)
    assert line["correct"]
    assert set(line["metrics"]) == ({"loader_wait_ms.train"} if "train" in cell
                                    else {"write_ms.serve", "event_p95_ms.serve"})
    assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line


def test_step_flops_at_the_cells_shapes():
    """The operation counts the mfu readers use, at the full cells' shapes."""
    from portbench.entries import train as entry_train
    from portbench.entries import serve as entry_serve

    mask = np.zeros((128, 128), np.int64)
    mask.reshape(-1)[:79] = 1
    gan = core.load_cell("p2igan_stis_gan.train_b12")
    dk = core.load_cell("dk_stis.train_b12")
    serve = core.load_cell("p2igan_stis_gan.serve_archive")
    gan_flops = entry_train.count_step_flops(core.reference_module(gan), gan.config, mask, 12)
    dk_flops = entry_train.count_step_flops(core.reference_module(dk), dk.config, mask, 12)
    ev = entry_serve.count_event_flops(core.reference_module(serve), serve.config, mask, 64,
                                       serve.workload["serve"])
    assert 2.0e12 < gan_flops < 2.4e12
    assert 3.6e11 < dk_flops < 4.0e11
    assert 5.8e11 < ev < 6.8e11
