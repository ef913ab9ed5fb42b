"""PyTorch sliding-window serving vs the JAX package's, on the CPU.

Reconstructor tolerance: atol 1e-4 x output_scale (the generator's 1e-4 after
the x255 output scale).

JAX's jitted reconstruction computes the gauge distances with FMA
contraction, unlike its eager generator and the port, so at pixels where two
candidates tie exactly the two pick different ones. The drivers are therefore
compared on single-gauge masks, where every candidate of the k=4 selection is
taken whatever the tie order; on tie-heavy 11-gauge masks the port's
reconstructor is held to a per-window loop over its own generator.
"""

import importlib.util
import json
from pathlib import Path

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

from test_torch_model import GEN_KW, reference_state

SCALE = 255.0
HW, T = GEN_KW["H"], GEN_KW["length"]


def _events(seed, E, ev_t, n_gauges=1, shared=True):
    rng = np.random.default_rng(seed)
    masks = np.zeros((E, ev_t, HW, HW, 1), np.float32)
    for e in range(E):
        if e == 0 or not shared:
            flat = np.zeros((HW * HW,), np.float32)
            flat[rng.choice(HW * HW, n_gauges, replace=False)] = 1.0
        masks[e] = np.broadcast_to(flat.reshape(1, HW, HW, 1), (ev_t, HW, HW, 1))
    masked = rng.random((E, ev_t, HW, HW, 1)).astype(np.float32) * masks
    return masked, masks


@pytest.fixture(scope="module")
def models():
    sd = reference_state(seed=7)
    jgen = JaxGenerator(**GEN_KW)
    jvars = TI.import_p2igan_generator(sd, num_res=GEN_KW["num_res"])
    jgen, jvars = jgen.fold_for_inference(jvars)
    tgen = P2IGenerator(**GEN_KW)
    tgen.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return jgen, jvars, tgen.fold_for_inference()


def _window_loop(gen, masked, masks, stride, overlap, scale):
    """Per-window replica of the reference loop (infer.py:217-245)."""
    T_ev = masked.shape[0]
    accum = np.zeros_like(masked)
    weight = np.zeros((T_ev, 1, 1, 1), np.float32)
    for start in range(0, T_ev, max(1, stride - overlap)):
        idx = np.minimum(np.arange(start, start + stride), T_ev - 1)
        with torch.no_grad():
            preds = gen(torch.from_numpy(masked[idx][None]),
                        torch.from_numpy(masks[idx][None])).numpy()[0]
        valid = min(stride, T_ev - start)
        accum[start:start + valid] += preds[:valid]
        weight[start:start + valid] += 1.0
    return np.clip(accum / np.maximum(weight, 1e-5) * scale, 0.0, None)


@pytest.mark.parametrize("ev_t", [11, 13])
def test_reconstructor_call_matches_jax(models, ev_t):
    jgen, jvars, tgen = models
    kw = dict(stride=T, overlap=2, window_batch=2, output_scale=SCALE)
    recon = SlidingWindowReconstructor(tgen, **kw)
    masked, masks = _events(3, 1, ev_t)
    want = jdriver.SlidingWindowReconstructor(jgen, jvars, t_bucket=8, **kw)(
        masked[0], masks[0])
    got = recon(masked[0], masks[0])
    assert got.shape == masked[0].shape and got.min() >= 0.0
    assert want.max() > 1.0  # a non-degenerate reconstruction
    np.testing.assert_allclose(got, want, atol=1e-4 * SCALE, rtol=0)

    masked, masks = _events(3, 1, ev_t, n_gauges=11)
    np.testing.assert_allclose(
        recon(masked[0], masks[0]),
        _window_loop(tgen, masked[0], masks[0], T, 2, SCALE),
        atol=1e-4 * SCALE, rtol=0)


@pytest.mark.parametrize("shared", [True, False])
def test_reconstructor_batch_matches_jax(models, shared):
    """Shared masks take the flattened window stream, distinct masks the
    per-event path; both must match JAX's batch()."""
    jgen, jvars, tgen = models
    masked, masks = _events(4, 3, 9, shared=shared)
    kw = dict(stride=T, overlap=1, window_batch=3, output_scale=SCALE)
    want = jdriver.SlidingWindowReconstructor(jgen, jvars, t_bucket=9, **kw).batch(
        masked, masks)
    recon = SlidingWindowReconstructor(tgen, **kw)
    got = recon.batch(masked, masks)
    np.testing.assert_allclose(got, want, atol=1e-4 * SCALE, rtol=0)
    seq = np.stack([recon(masked[e], masks[e]) for e in range(3)])
    np.testing.assert_allclose(got, seq, atol=1e-4 * SCALE, rtol=0)


def test_window_tables_match_jax():
    for stride, overlap, wb, ev_t, E in ((16, 12, 8, 64, 2), (4, 2, 2, 11, 3),
                                         (16, 12, 8, 5, 1)):
        ours = SlidingWindowReconstructor(
            P2IGenerator(**GEN_KW), stride=stride, overlap=overlap,
            window_batch=wb)._window_tables(ev_t, E, wb)
        ref = jdriver.SlidingWindowReconstructor(
            None, {}, stride=stride, overlap=overlap,
            window_batch=wb)._window_tables(ev_t, E, wb)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)


def test_gauge_budget_guard(models):
    tgen = models[2]
    masked, masks = _events(5, 2, 8, n_gauges=11)
    masks[1] = 1.0  # 256 observed gauges on the second event > 128 slots
    with pytest.raises(ValueError, match="observed gauges"):
        SlidingWindowReconstructor(tgen, stride=T, overlap=1).batch(masked, masks)


def _serving_tree(tmp_path, n_events=2, ev_t=10):
    rng = np.random.default_rng(0)
    store = zarrlite.open_group(tmp_path / "test.zarr", mode="w")
    for i in range(n_events):
        frames = fake.synthesize_event(rng, ev_t, HW, HW).astype(np.float32)
        store.create_dataset(f"event_{i + 1:02d}", shape=frames.shape,
                             chunks=frames.shape, dtype="float32", data=frames,
                             compressor={"id": "zlib", "level": 1})
    mask = fake.write_gauge_mask(tmp_path / "mask.txt", H=HW, W=HW, n_gauges=1)
    mask_cfg = {"type": "stis", "file": str(mask)}
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
    gen = P2IGenerator(H=HW, W=HW, length=T, base_channels=16, idw_factored=True,
                       idw_shared_batch_mask=True,
                       generator=torch.Generator().manual_seed(0))
    torch.save(gen.state_dict(), tmp_path / "gen.pt")
    return cfg


def test_run_inference_end_to_end_matches_jax_driver(tmp_path):
    cfg = _serving_tree(tmp_path)
    kw = dict(checkpoint=str(tmp_path / "gen.pt"), stride=T, overlap=2,
              window_batch=2, overwrite=True)
    out = run_inference(json.loads(json.dumps(cfg)), passes=2, device="cpu",
                        output=str(tmp_path / "port.zarr"), **kw)
    g = zarrlite.open(out, mode="r")
    assert g.attrs["model_name"] == "p2igan" and g.attrs["passes"] == 2
    assert g.array_keys() == ["event_01", "event_02"]
    ref = jdriver.run_inference(json.loads(json.dumps(cfg)), passes=2,
                                output=str(tmp_path / "jax.zarr"), **kw)
    r = zarrlite.open(ref, mode="r")
    for key in g.array_keys():
        ev = g[key][:]
        assert ev.shape == (10, HW, HW, 1)
        assert np.isfinite(ev).all() and ev.min() >= 0.0
        np.testing.assert_allclose(ev, r[key][:], atol=1e-4 * SCALE, rtol=0)

    # batched events reproduce the one-at-a-time stream
    bat = run_inference(json.loads(json.dumps(cfg)), device="cpu", batch_events=2,
                        output=str(tmp_path / "bat.zarr"), **kw)
    b = zarrlite.open(bat, mode="r")
    one = run_inference(json.loads(json.dumps(cfg)), device="cpu",
                        output=str(tmp_path / "one.zarr"), **kw)
    o = zarrlite.open(one, mode="r")
    for key in o.array_keys():
        np.testing.assert_allclose(b[key][:], o[key][:], atol=1e-4 * SCALE, rtol=0)


def test_cli_requires_a_gpu_unless_cpu(tmp_path, monkeypatch):
    path = Path(__file__).resolve().parents[1] / "scripts" / "infer_torch.py"
    spec = importlib.util.spec_from_file_location("infer_torch", path)
    infer_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(infer_torch)
    cfg = _serving_tree(tmp_path, n_events=1, ev_t=5)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    argv = ["--config", str(cfg_path), "--checkpoint", str(tmp_path / "gen.pt"),
            "--output", str(tmp_path / "cli.zarr"), "--stride", str(T),
            "--overlap", "2", "--window-batch", "2", "--overwrite"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        infer_torch.main(infer_torch.parse_args(argv))
    out = infer_torch.main(infer_torch.parse_args(argv + ["--device", "cpu"]))
    assert zarrlite.open(out, mode="r")["event_01"].shape == (5, HW, HW, 1)
    with pytest.raises(SystemExit):
        infer_torch.parse_args(argv + ["--accum-mode", "stacked"])
