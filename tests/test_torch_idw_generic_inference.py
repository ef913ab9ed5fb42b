"""PyTorch sliding-window serving vs the JAX package's on masks that vary per
frame (nowcasting, stin), through the generic IDW.

Nothing is hoisted: every window carries its own slice of its event's mask
(nowcasting: the first ``keep`` frames of an event observed, every later
window empty; stin: ``keep`` dense frames, then a jittered grid), and a window
batch may mix events. Tolerance: atol 1e-4 x output_scale, as on stis and sti.

The JAX driver runs under ``jax.disable_jit()``: jitted, XLA contracts the
distance sums into FMAs and flips the exact ties that dense frames put on the
query lattice (``tests/test_torch_idw_generic_model.py``).
"""

import json

import numpy as np
import pytest
import torch

from p2igan_tpu.data import fake, zarrlite
from p2igan_tpu.inference import driver as jdriver
from p2igan_tpu_torch.inference.driver import run_inference
from p2igan_tpu_torch.models import P2IGenerator
from p2igan_tpu_torch.ops import idw_kernel as tkern

import jax

from test_torch_idw_generic_model import small_jax_idw_chunk  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("small_jax_idw_chunk")

SCALE, HW, T = 255.0, 16, 4


def _serving_tree(tmp_path, mask_cfg, n_events=2, ev_t=8):
    rng = np.random.default_rng(0)
    store = zarrlite.open_group(tmp_path / "test.zarr", mode="w")
    for i in range(n_events):
        frames = fake.synthesize_event(rng, ev_t, HW, HW).astype(np.float32)
        store.create_dataset(f"event_{i + 1:02d}", shape=frames.shape,
                             chunks=frames.shape, dtype="float32", data=frames,
                             compressor={"id": "zlib", "level": 1})
    cfg = {
        "seed": 1,
        "model": {"name": "p2igan", "in_channels": 1, "base_channels": 16},
        "data": {
            "train": {"data_root": str(tmp_path / "test.zarr"), "w": HW, "h": HW,
                      "sample_length": T, "mask": mask_cfg},
            "test": {"data_root": str(tmp_path / "test.zarr"), "w": HW, "h": HW,
                     "sample_length": None},
        },
        "train": {"num_workers": 1},
    }
    # seed 1: seed 0's weights clip every pixel to 0 under nowcasting
    gen = P2IGenerator.from_config(cfg, generator=torch.Generator().manual_seed(1))
    assert not gen.idw_factored and not gen.idw_shared_batch_mask
    torch.save(gen.state_dict(), tmp_path / "gen.pt")
    return cfg, gen.idw_max_points


@pytest.mark.parametrize("mask_cfg,points", [
    ({"type": "nowcasting", "keep": 2}, 512),
    ({"type": "stin", "keep": 2, "block_sizes": [4]}, 640),
])
def test_generic_run_inference_end_to_end_matches_jax_driver(tmp_path, mask_cfg, points):
    """The serving zarr of two 8-frame events (stride 4, overlap 2: 4 windows
    an event, window batch 2) against the JAX driver's, and two events as one
    window stream (window batches mixing events and masks) against one at a
    time."""
    cfg, max_points = _serving_tree(tmp_path, mask_cfg)
    assert max_points == points
    kw = dict(checkpoint=str(tmp_path / "gen.pt"), stride=T, overlap=2,
              window_batch=2, overwrite=True)
    tkern.idw_knn_single.launches = tkern.idw_knn_chunked.launches = 0
    out = run_inference(json.loads(json.dumps(cfg)), device="cpu",
                        output=str(tmp_path / "port.zarr"), **kw)
    # the CPU path runs the plain versions: no kernel launch is counted
    assert tkern.idw_knn_single.launches == tkern.idw_knn_chunked.launches == 0
    g = zarrlite.open(out, mode="r")
    assert g.array_keys() == ["event_01", "event_02"]
    with jax.disable_jit():
        ref = jdriver.run_inference(json.loads(json.dumps(cfg)),
                                    output=str(tmp_path / "jax.zarr"), **kw)
    r = zarrlite.open(ref, mode="r")
    for key in g.array_keys():
        ev = g[key][:]
        assert ev.shape == (8, HW, HW, 1)
        assert np.isfinite(ev).all() and ev.min() >= 0.0 and ev.max() > 1.0
        np.testing.assert_allclose(ev, r[key][:], atol=1e-4 * SCALE, rtol=0)
    bat = run_inference(json.loads(json.dumps(cfg)), device="cpu", batch_events=2,
                        output=str(tmp_path / "bat.zarr"), **kw)
    b = zarrlite.open(bat, mode="r")
    for key in g.array_keys():
        np.testing.assert_allclose(b[key][:], g[key][:], atol=1e-4 * SCALE, rtol=0)
