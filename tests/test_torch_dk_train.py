"""dk and stdk training and serving of the PyTorch port vs the JAX package (CPU).

One reconstruction-loss step (``use_gan: 0``, AdamNoMu) from identical state:
losses rtol 1e-4, every gradient rtol 1e-4 with atol 1e-4 x max|grad| of its
tensor. Overfit-one-batch for both families, checkpoint save/resume of a dk
state through the CLI, and the serving zarr of the port against the JAX
driver's on a fake tree (atol 1e-4 x 255).
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from p2igan_tpu.data import fake, zarrlite
from p2igan_tpu.inference import driver as jdriver
from p2igan_tpu.training import steps as jsteps
from p2igan_tpu_torch.data import zarrlite as tzarrlite
from p2igan_tpu_torch.inference.driver import (SlidingWindowReconstructor,
                                               load_generator, run_inference)
from p2igan_tpu_torch.models import DKGenerator, STDKGenerator, build_generator
from p2igan_tpu_torch.models.convert import params_from_jax
from p2igan_tpu_torch.training import steps as tsteps
from p2igan_tpu_torch.training.checkpoint import (load_checkpoint_raw,
                                                  load_generator_state)
from p2igan_tpu_torch.training.trainer import Trainer

from test_torch_dk_model import B, FAMILIES, K, T, _inputs, _jax_model, _port_model
from test_torch_gan import _capture

HW, SCALE = 32, 255.0
REPO = Path(__file__).resolve().parents[1]


def _cli(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def _file_tracker(monkeypatch, tmp_path):
    monkeypatch.setenv("P2IGAN_FORCE_FILE_TRACKER", "1")
    from p2igan_tpu_torch.utils.tracking import get_tracker

    get_tracker().set_tracking_uri(str(tmp_path / "mlruns"))


@pytest.mark.parametrize("k1_alpha", [0.0, 0.05])
@pytest.mark.parametrize("family", ["dk", "stdk"])
def test_one_rec_loss_step_matches_jax(family, k1_alpha):
    jgen, variables = _jax_model(family, shared=True)
    masked, masks = _inputs(21)
    frames = np.random.default_rng(22).random((B, T, HW, HW, 1), dtype=np.float32)
    cfg = {"lr": 1e-4, "beta1": 0.0, "beta2": 0.99}
    jopt = optax.chain(_capture(), jsteps.make_optimizer(cfg))
    gp = jax.tree.map(jnp.asarray, variables["params"])
    state = jsteps.TrainState(step=jnp.zeros((), jnp.int32), gen_params=gp,
                              gen_extra={}, opt_g=jopt.init(gp))
    jstep = jsteps.build_train_step(jgen, None, jopt, None, use_gan=False,
                                    k1_alpha=k1_alpha, donate=False)
    new_state, jm = jstep(state, jnp.asarray(frames), jnp.asarray(masked),
                          jnp.asarray(masks))

    gen = _port_model(family, variables, shared=True)
    opt = tsteps.make_optimizer(cfg, gen.parameters())
    assert isinstance(opt, tsteps.AdamNoMu)
    step = tsteps.build_train_step(gen, None, opt, None, use_gan=False,
                                   k1_alpha=k1_alpha)
    # the raw pipeline's frame-constant (B, 1, H, W, C) mask broadcasts
    m = step(torch.from_numpy(frames), torch.from_numpy(masked),
             torch.from_numpy(masks[:, :1]))
    for key in ("loss", "rec_loss", "pool", "reg"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=key)
    assert float(m["adv_loss"]) == 0.0 and "dis_loss" not in m
    want = params_from_jax(gen, new_state.opt_g[0])
    for name, p in gen.named_parameters():
        w = want[name].numpy()
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
    after = params_from_jax(gen, new_state.gen_params)
    for name, p in gen.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), after[name].numpy(),
                                   rtol=1e-5, atol=2e-6, err_msg=name)


@pytest.mark.parametrize("family", ["dk", "stdk"])
def test_overfit_one_batch_reduces_loss(family):
    """Repeated steps on one fixed batch drive the weighted-L1 rec loss well
    down for both families; a sign-flipped or absent update fails it.
    Calibrated on the CPU: dk 6.20 -> 1.08, stdk 5.95 -> 1.09 in 150 steps
    (a noise target's capacity floor at this size); about 30% margin."""
    rng = np.random.default_rng(3)
    flat = np.zeros(16 * 16, np.float32)
    flat[rng.choice(16 * 16, K, replace=False)] = 1.0
    masks = torch.from_numpy(np.broadcast_to(flat.reshape(1, 1, 16, 16, 1),
                                             (2, T, 16, 16, 1)).copy())
    frames = torch.from_numpy(rng.random((2, T, 16, 16, 1), dtype=np.float32))
    gen = FAMILIES[family][1](length=T, visible_k=K, shared_batch_mask=True,
                              generator=torch.Generator().manual_seed(0))
    opt = tsteps.make_optimizer({"lr": 1e-3}, gen.parameters())
    step = tsteps.build_train_step(gen, None, opt, None, use_gan=False, k1_alpha=0.0)
    losses = [float(step(frames, frames * masks, masks)["rec_loss"]) for _ in range(150)]
    assert np.isfinite(losses).all()
    assert losses[0] > 3.0, f"unexpectedly easy start: {losses[0]}"
    assert min(losses) < 0.3 * losses[0], (losses[0], min(losses))
    assert min(losses) < 1.45, (losses[0], min(losses))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_dk_train")
    fake.write_train_zarr(root / "train.zarr", n_events=2, T=8, H=HW, W=HW,
                          window=T, stride=2, seed=0)
    fake.write_gauge_mask(root / "gauges.txt", H=HW, W=HW, n_gauges=79, seed=1)
    return root


def _cfg(root, save_dir, model, iterations=3):
    mask = {"type": "stis", "file": str(root / "gauges.txt")}
    return {
        "seed": 7, "save_dir": str(save_dir), "experiment_name": "torch-dk-test",
        "run_name": "run",
        "model": {"name": model, "in_channels": 1, "out_channels": 1,
                  "base_channels": 64},
        "data": {"train": {"data_root": str(root / "train.zarr"), "w": HW, "h": HW,
                           "sample_length": T, "mask": mask}},
        "loss": {"adversarial_weight": 0.0, "k1_weight": 0.0, "gan_loss": "hinge",
                 "use_gan": 0},
        "train": {"optimizer": {"type": "Adam", "beta1": 0.0, "beta2": 0.99,
                                "lr": 1e-4},
                  "batch_size": 2, "num_workers": 2, "log_step": 1,
                  "iterations": iterations, "use_validation": True},
    }


@pytest.mark.parametrize("model", ["dk", "stdk"])
def test_trainer_checkpoint_and_resume(data_root, tmp_path, model):
    """3 steps, then 3 more from latest.ckpt through the CLI, end where an
    uninterrupted 6-step run ends: the checkpoint round-trips a dk/stdk state
    (weights, AdamNoMu moments, counters)."""
    full = Trainer(_cfg(data_root, tmp_path / "full", model, iterations=6), device="cpu")
    assert full.discriminator is None and not full._idw_hoist_pending
    assert isinstance(full.opt_g, tsteps.AdamNoMu)
    full.train()
    assert full.global_step == 6

    first = Trainer(_cfg(data_root, tmp_path / "part", model), device="cpu")
    first.train()
    latest = tmp_path / "part" / "latest.ckpt"
    raw = load_checkpoint_raw(latest)
    assert set(raw) == {"epoch", "global_step", "best_val", "generator", "optimizer_g"}
    assert raw["global_step"] == 3 and np.isfinite(first.last_rec_loss)
    assert list(raw["generator"]["params"]) == list(first.generator.state_dict())

    cli = _cli("train_torch")
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(_cfg(data_root, tmp_path / "part", model,
                                        iterations=6)))
    resumed = cli.main(cli.parse_args(["--config", str(cfg_path), "--resume",
                                       str(latest), "--device", "cpu"]))
    assert resumed.global_step == 6
    for (name, p), q in zip(full.generator.state_dict().items(),
                            resumed.generator.state_dict().values()):
        np.testing.assert_allclose(q.numpy(), p.numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=name)
    for p, q in zip(full.generator.parameters(), resumed.generator.parameters()):
        assert full.opt_g.state[p]["step"] == resumed.opt_g.state[q]["step"] == 6
        np.testing.assert_allclose(resumed.opt_g.state[q]["nu"].numpy(),
                                   full.opt_g.state[p]["nu"].numpy(), rtol=1e-5)
    # serving loads the trainer's checkpoint as it is, folded for inference
    served = load_generator(_cfg(data_root, tmp_path, model), latest,
                            torch.device("cpu"))
    assert served.fused_tail is True and not served.training
    for (name, p), q in zip(resumed.generator.state_dict().items(),
                            served.state_dict().values()):
        assert torch.equal(p, q), name
    assert list(load_generator_state(latest)) == list(served.state_dict())


def _serving_tree(tmp_path, model, n_events=2, ev_t=10):
    rng = np.random.default_rng(0)
    store = zarrlite.open_group(tmp_path / "test.zarr", mode="w")
    for i in range(n_events):
        frames = fake.synthesize_event(rng, ev_t, HW, HW).astype(np.float32)
        store.create_dataset(f"event_{i + 1:02d}", shape=frames.shape,
                             chunks=frames.shape, dtype="float32", data=frames,
                             compressor={"id": "zlib", "level": 1})
    mask = fake.write_gauge_mask(tmp_path / "mask.txt", H=HW, W=HW, n_gauges=79)
    cfg = {
        "seed": 1,
        "model": {"name": model, "in_channels": 1, "base_channels": 64},
        "data": {
            "train": {"data_root": str(tmp_path / "test.zarr"), "w": HW, "h": HW,
                      "sample_length": T,
                      "mask": {"type": "stis", "file": str(mask)}},
            "test": {"data_root": str(tmp_path / "test.zarr"), "w": HW, "h": HW,
                     "sample_length": None},
        },
        "train": {"num_workers": 1},
    }
    gen = build_generator(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # a trained net has biases; the init zeroes them
        for i, m in enumerate(gen._mlp.net):
            if hasattr(m, "bias"):
                m.bias.copy_(torch.from_numpy(
                    rng.normal(size=m.bias.shape).astype(np.float32) * 0.05))
    torch.save(gen.state_dict(), tmp_path / "gen.pt")
    return cfg


@pytest.mark.parametrize("model", ["dk", "stdk"])
def test_run_inference_matches_jax_driver(tmp_path, model):
    cfg = _serving_tree(tmp_path, model)
    kw = dict(checkpoint=str(tmp_path / "gen.pt"), stride=T, overlap=2,
              window_batch=2, overwrite=True)
    out = run_inference(json.loads(json.dumps(cfg)), passes=2, device="cpu",
                        output=str(tmp_path / "port.zarr"), **kw)
    g = tzarrlite.open(out, mode="r")
    assert g.attrs["model_name"] == model and g.attrs["passes"] == 2
    assert g.array_keys() == ["event_01", "event_02"]
    ref = jdriver.run_inference(json.loads(json.dumps(cfg)), passes=2,
                                output=str(tmp_path / "jax.zarr"), **kw)
    r = zarrlite.open(ref, mode="r")
    for key in g.array_keys():
        ev = g[key][:]
        assert ev.shape == (10, HW, HW, 1)
        assert np.isfinite(ev).all() and ev.min() >= 0.0 and ev.max() > 1.0
        np.testing.assert_allclose(ev, r[key][:], atol=1e-4 * SCALE, rtol=0)


def test_reconstructor_batches_events_without_an_idw(tmp_path):
    """dk has no IDW to hoist: events with different masks go through one
    flattened window stream (per-(b, t) selection) and equal the one-by-one
    reconstruction."""
    gen = DKGenerator(length=T, visible_k=K, generator=torch.Generator().manual_seed(2))
    recon = SlidingWindowReconstructor(gen.fold_for_inference(), stride=T, overlap=1,
                                       window_batch=3)
    assert not recon._supports_prepared_idw()
    rng = np.random.default_rng(8)
    masks = np.zeros((3, 9, HW * HW, 1), np.float32)
    for e in range(3):
        masks[e, :, rng.choice(HW * HW, K, replace=False)] = 1.0
    masks = masks.reshape(3, 9, HW, HW, 1)
    masked = rng.random((3, 9, HW, HW, 1)).astype(np.float32) * masks
    got = recon.batch(masked, masks)
    seq = np.stack([recon(masked[e], masks[e]) for e in range(3)])
    np.testing.assert_allclose(got, seq, atol=1e-4 * SCALE, rtol=0)


def test_cli_serves_the_shipped_stdk_config_shape(tmp_path):
    """scripts/infer_torch.py with no new flag on an stdk config."""
    cfg = _serving_tree(tmp_path, "stdk", n_events=1, ev_t=5)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    cli = _cli("infer_torch")
    out = cli.main(cli.parse_args([
        "--config", str(cfg_path), "--checkpoint", str(tmp_path / "gen.pt"),
        "--output", str(tmp_path / "cli.zarr"), "--stride", str(T), "--overlap", "2",
        "--window-batch", "2", "--overwrite", "--device", "cpu"]))
    assert tzarrlite.open(out, mode="r")["event_01"].shape == (5, HW, HW, 1)
    assert isinstance(load_generator(cfg, tmp_path / "gen.pt", torch.device("cpu")),
                      STDKGenerator)
