"""Serving of the simple family in the PyTorch port vs the JAX package (CPU).

The zarr store ``run_inference`` writes on a fake tree (base_channels 8, T=4,
16x16 events of 10 frames, stride 4, overlap 2) against the JAX driver's, from
one reference-layout ``.pt`` whose BatchNorm statistics are away from identity:
atol 1e-4 x 255, the reconstructor tolerance of tests/test_torch_inference.py.
Both sides fold the BatchNorm at load; on the CPU the port's folded module runs
the plain versions of its two fused ops.
"""

import json

import numpy as np
import pytest
import torch

from p2igan_tpu.data import fake, zarrlite
from p2igan_tpu.inference import driver as jdriver
from p2igan_tpu_torch.data import zarrlite as tzarrlite
from p2igan_tpu_torch.inference.driver import (SlidingWindowReconstructor,
                                               load_generator, run_inference)
from p2igan_tpu_torch.models import SimpleGenerator

from test_torch_dk_train import _cli
from test_torch_simple_model import BASE, HW, T

SCALE = 255.0


def _serving_tree(tmp_path, n_events=2, ev_t=10, **model):
    rng = np.random.default_rng(0)
    store = zarrlite.open_group(tmp_path / "test.zarr", mode="w")
    for i in range(n_events):
        frames = fake.synthesize_event(rng, ev_t, HW, HW).astype(np.float32)
        store.create_dataset(f"event_{i + 1:02d}", shape=frames.shape,
                             chunks=frames.shape, dtype="float32", data=frames,
                             compressor={"id": "zlib", "level": 1})
    mask = fake.write_gauge_mask(tmp_path / "mask.txt", H=HW, W=HW, n_gauges=20)
    cfg = {
        "seed": 1,
        "model": {"name": "simple", "in_channels": 1, "base_channels": BASE, **model},
        "data": {
            "train": {"data_root": str(tmp_path / "test.zarr"), "w": HW, "h": HW,
                      "sample_length": T,
                      "mask": {"type": "stis", "file": str(mask)}},
            "test": {"data_root": str(tmp_path / "test.zarr"), "w": HW, "h": HW,
                     "sample_length": None},
        },
        "train": {"num_workers": 1},
    }
    gen = SimpleGenerator(base_channels=BASE, generator=torch.Generator().manual_seed(0))
    state = gen.state_dict()
    draw = torch.Generator().manual_seed(1)
    for key, val in state.items():   # a trained net: nothing at its identity init
        if key.endswith("running_var"):
            state[key] = torch.exp(0.5 * torch.randn(val.shape, generator=draw))
        elif ".1." in key or key.endswith("bias"):
            state[key] = val + 0.2 * torch.randn(val.shape, generator=draw)
    torch.save(state, tmp_path / "gen.pt")
    return cfg


@pytest.mark.parametrize("dec2_fused", [True, False])
def test_run_inference_matches_jax_driver(tmp_path, dec2_fused):
    cfg = _serving_tree(tmp_path, dec2_fused=dec2_fused)
    kw = dict(checkpoint=str(tmp_path / "gen.pt"), stride=T, overlap=2,
              window_batch=2, overwrite=True)
    out = run_inference(json.loads(json.dumps(cfg)), passes=2, device="cpu",
                        output=str(tmp_path / "port.zarr"), **kw)
    g = tzarrlite.open(out, mode="r")
    assert g.attrs["model_name"] == "simple" and g.attrs["passes"] == 2
    assert g.array_keys() == ["event_01", "event_02"]
    ref = jdriver.run_inference(json.loads(json.dumps(cfg)), passes=2,
                                output=str(tmp_path / "jax.zarr"), **kw)
    r = zarrlite.open(ref, mode="r")
    for key in g.array_keys():
        ev = g[key][:]
        assert ev.shape == (10, HW, HW, 1)
        assert np.isfinite(ev).all() and ev.min() >= 0.0 and ev.max() > 1.0
        np.testing.assert_allclose(ev, r[key][:], atol=1e-4 * SCALE, rtol=0)


def test_unfolded_serving_equals_folded(tmp_path):
    """``fold_weights=False`` serves the module as trained, in eval mode: the
    same store within the fold's reassociation."""
    cfg = _serving_tree(tmp_path, n_events=1)
    kw = dict(checkpoint=str(tmp_path / "gen.pt"), stride=T, overlap=2,
              window_batch=3, overwrite=True, device="cpu")
    a = run_inference(json.loads(json.dumps(cfg)), output=str(tmp_path / "a.zarr"), **kw)
    b = run_inference(json.loads(json.dumps(cfg)), output=str(tmp_path / "b.zarr"),
                      fold_weights=False, **kw)
    np.testing.assert_allclose(tzarrlite.open(a, mode="r")["event_01"][:],
                               tzarrlite.open(b, mode="r")["event_01"][:],
                               atol=1e-4 * SCALE, rtol=0)
    plain = load_generator(cfg, tmp_path / "gen.pt", torch.device("cpu"),
                           fold_weights=False)
    assert not plain.serving and not plain.training


def test_reconstructor_takes_no_prepared_idw_and_batches_events(tmp_path):
    """simple has no IDW to hoist: events with different masks go through one
    flattened window stream and equal the one-by-one reconstruction."""
    gen = SimpleGenerator(base_channels=4, generator=torch.Generator().manual_seed(2))
    recon = SlidingWindowReconstructor(gen.fold_for_inference(), stride=T, overlap=1,
                                       window_batch=3)
    assert not recon._supports_prepared_idw()
    rng = np.random.default_rng(8)
    masks = (rng.random((3, 9, HW, HW, 1)) < 0.2).astype(np.float32)
    masks[:] = masks[:, :1]
    masked = rng.random((3, 9, HW, HW, 1)).astype(np.float32) * masks
    got = recon.batch(masked, masks)
    seq = np.stack([recon(masked[e], masks[e]) for e in range(3)])
    assert got.shape == masked.shape and got.max() > 1.0
    np.testing.assert_allclose(got, seq, atol=1e-4 * SCALE, rtol=0)


def test_cli_serves_a_simple_config(tmp_path, monkeypatch):
    """scripts/infer_torch.py with no new flag; without a GPU it raises unless
    ``--device cpu``."""
    cfg = _serving_tree(tmp_path, n_events=1, ev_t=5)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    cli = _cli("infer_torch")
    argv = ["--config", str(cfg_path), "--checkpoint", str(tmp_path / "gen.pt"),
            "--output", str(tmp_path / "cli.zarr"), "--stride", str(T), "--overlap", "2",
            "--window-batch", "2", "--overwrite"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main(cli.parse_args(argv))
    out = cli.main(cli.parse_args(argv + ["--device", "cpu"]))
    assert tzarrlite.open(out, mode="r")["event_01"].shape == (5, HW, HW, 1)
    served = load_generator(cfg, tmp_path / "gen.pt", torch.device("cpu"))
    assert isinstance(served, SimpleGenerator) and served.serving
