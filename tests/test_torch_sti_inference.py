"""PyTorch sliding-window serving vs the JAX package's on per-event sti masks.

A per-sample (sti) generator hoists nothing: every window computes its own
gauge selection, and a window batch may mix windows of different events.
Reconstructor tolerance: atol 1e-4 x output_scale, as on stis.

JAX's reconstructor is one jitted program; jitted, XLA contracts the gauge
distance into an FMA, which moves it by an ULP and flips exact candidate ties
(about 3% of the pixels under a jittered grid, spread by the convolutions to
most of the output: JAX jitted and JAX op by op differ by 0.02 on the tanh
scale here), unlike JAX's op-by-op generator and the port. So the JAX driver
runs under ``jax.disable_jit()``, which leaves its program and arithmetic as
they are and only stops XLA from fusing across operations; the masks are
tie-heavy block-4 grids (16 gauges at 16x16), each event with its own.
"""

import json

import numpy as np
import pytest
import torch

from p2igan_tpu.data import fake, zarrlite
from p2igan_tpu.inference import driver as jdriver
from p2igan_tpu.models import P2IGenerator as JaxGenerator
from p2igan_tpu.models import torch_import as TI
from p2igan_tpu_torch.inference.driver import (SlidingWindowReconstructor,
                                               run_inference)
from p2igan_tpu_torch.models import P2IGenerator
from p2igan_tpu_torch.ops import idw_factored_kernel as tkern

import jax

from test_torch_inference import _window_loop
from test_torch_model import reference_state
from test_torch_sti_model import STI_KW, sti_inputs

SCALE = 255.0
HW, T = STI_KW["H"], STI_KW["length"]


def _events(seed, E, ev_t, block):
    """E events of ev_t frames, each under its own frame-constant sti mask."""
    masked, masks = sti_inputs(seed=seed, B=E, block=block, hw=HW, t=ev_t)
    return masked, masks


@pytest.fixture(scope="module")
def models():
    sd = reference_state(seed=7)
    jgen = JaxGenerator(**STI_KW)
    jvars = TI.import_p2igan_generator(sd, num_res=STI_KW["num_res"])
    jgen, jvars = jgen.fold_for_inference(jvars)
    tgen = P2IGenerator(**STI_KW)
    tgen.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return jgen, jvars, tgen.fold_for_inference()


@pytest.mark.parametrize("ev_t", [11, 13])
def test_sti_reconstructor_call_matches_jax(models, ev_t):
    jgen, jvars, tgen = models
    kw = dict(stride=T, overlap=2, window_batch=2, output_scale=SCALE)
    recon = SlidingWindowReconstructor(tgen, **kw)
    assert not recon._supports_prepared_idw()
    masked, masks = _events(3, 1, ev_t, block=4)
    with jax.disable_jit():
        want = jdriver.SlidingWindowReconstructor(jgen, jvars, t_bucket=8, **kw)(
            masked[0], masks[0])
    got = recon(masked[0], masks[0])
    assert got.shape == masked[0].shape and got.min() >= 0.0
    assert want.max() > 1.0  # a non-degenerate reconstruction
    np.testing.assert_allclose(got, want, atol=1e-4 * SCALE, rtol=0)
    np.testing.assert_allclose(
        got, _window_loop(tgen, masked[0], masks[0], T, 2, SCALE),
        atol=1e-4 * SCALE, rtol=0)


def test_sti_batch_mixes_events_in_one_window_stream(models, monkeypatch):
    """Three events with three masks go through ONE flattened window stream
    (no per-event fallback: nothing is hoisted), window batches that span two
    events included, and match JAX's batch() and the one-by-one calls."""
    jgen, jvars, tgen = models
    masked, masks = _events(4, 3, 9, block=4)
    kw = dict(stride=T, overlap=1, window_batch=2, output_scale=SCALE)
    with jax.disable_jit():
        want = jdriver.SlidingWindowReconstructor(jgen, jvars, t_bucket=9, **kw).batch(
            masked, masks)
    recon = SlidingWindowReconstructor(tgen, **kw)
    calls = []
    forward = tgen.forward
    monkeypatch.setattr(tgen, "forward", lambda m, k, **kw_: (
        calls.append((k[:, 0] != k[:1, 0]).any().item()), forward(m, k, **kw_))[1])
    got = recon.batch(masked, masks)
    assert len(calls) == 5 and any(calls)  # 9 windows by 2 (+1 pad); mixed batches
    np.testing.assert_allclose(got, want, atol=1e-4 * SCALE, rtol=0)
    seq = np.stack([recon(masked[e], masks[e]) for e in range(3)])
    np.testing.assert_allclose(got, seq, atol=1e-4 * SCALE, rtol=0)


def test_sti_gauge_budget_guard(models):
    """The static slot budget guards the per-sample generator too: a mask of
    any event with more gauges than slots raises before anything runs."""
    tgen = models[2]
    masked, masks = _events(5, 2, 8, block=4)
    masks[1] = 1.0  # 256 observed gauges on the second event > 128 slots
    recon = SlidingWindowReconstructor(tgen, stride=T, overlap=1)
    with pytest.raises(ValueError, match="observed gauges"):
        recon.batch(masked, masks)
    with pytest.raises(ValueError, match="observed gauges"):
        recon(masked[1], masks[1])


def _serving_tree(tmp_path, n_events=2, ev_t=10):
    rng = np.random.default_rng(0)
    store = zarrlite.open_group(tmp_path / "test.zarr", mode="w")
    for i in range(n_events):
        frames = fake.synthesize_event(rng, ev_t, HW, HW).astype(np.float32)
        store.create_dataset(f"event_{i + 1:02d}", shape=frames.shape,
                             chunks=frames.shape, dtype="float32", data=frames,
                             compressor={"id": "zlib", "level": 1})
    mask_cfg = {"type": "sti", "block_sizes": [4]}
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
    gen = P2IGenerator.from_config(cfg, generator=torch.Generator().manual_seed(0))
    assert not gen.idw_shared_batch_mask
    torch.save(gen.state_dict(), tmp_path / "gen.pt")
    return cfg


def test_sti_run_inference_end_to_end_matches_jax_driver(tmp_path):
    """The serving zarr of two events, each under the sti mask its loader
    draws for it (the loaders of both packages draw the same numpy streams),
    against the JAX driver's; and batched events against one at a time."""
    cfg = _serving_tree(tmp_path)
    kw = dict(checkpoint=str(tmp_path / "gen.pt"), stride=T, overlap=2,
              window_batch=2, overwrite=True)
    tkern.combine_table.launches = tkern.gauge_topk.launches = 0
    out = run_inference(json.loads(json.dumps(cfg)), device="cpu",
                        output=str(tmp_path / "port.zarr"), **kw)
    # the CPU path runs the plain versions: no kernel launch is counted
    assert tkern.combine_table.launches == tkern.gauge_topk.launches == 0
    g = zarrlite.open(out, mode="r")
    assert g.attrs["model_name"] == "p2igan"
    assert g.array_keys() == ["event_01", "event_02"]
    with jax.disable_jit():
        ref = jdriver.run_inference(json.loads(json.dumps(cfg)),
                                    output=str(tmp_path / "jax.zarr"), **kw)
    r = zarrlite.open(ref, mode="r")
    for key in g.array_keys():
        ev = g[key][:]
        assert ev.shape == (10, HW, HW, 1)
        assert np.isfinite(ev).all() and ev.min() >= 0.0 and ev.max() > 1.0
        np.testing.assert_allclose(ev, r[key][:], atol=1e-4 * SCALE, rtol=0)
    assert not np.allclose(g["event_01"][:], g["event_02"][:])

    bat = run_inference(json.loads(json.dumps(cfg)), device="cpu", batch_events=2,
                        output=str(tmp_path / "bat.zarr"), **kw)
    b = zarrlite.open(bat, mode="r")
    for key in g.array_keys():
        np.testing.assert_allclose(b[key][:], g[key][:], atol=1e-4 * SCALE, rtol=0)
