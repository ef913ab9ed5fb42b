"""The port's trainer on the CPU, at a tiny size: it learns, checkpoints,
resumes where it stopped, and the raw (device_decode) pipeline feeds it the
same batches as the float one."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from p2igan_tpu.data import fake
from p2igan_tpu_torch.data.datamodule import P2IDataModule
from p2igan_tpu_torch.models import P2IGenerator
from p2igan_tpu_torch.training import steps as tsteps
from p2igan_tpu_torch.training.checkpoint import (load_checkpoint_raw,
                                                  load_generator_state)
from p2igan_tpu_torch.training.trainer import Trainer

T, HW = 4, 32


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_train")
    fake.write_train_zarr(root / "train.zarr", n_events=2, T=8, H=HW, W=HW,
                          window=T, stride=2, seed=0)
    fake.write_gauge_mask(root / "gauges.txt", H=HW, W=HW, n_gauges=9, seed=1)
    return root


@pytest.fixture(autouse=True)
def _file_tracker(monkeypatch, tmp_path):
    monkeypatch.setenv("P2IGAN_FORCE_FILE_TRACKER", "1")
    from p2igan_tpu_torch.utils.tracking import get_tracker

    get_tracker().set_tracking_uri(str(tmp_path / "mlruns"))


def _cfg(root, save_dir, iterations=3, use_gan=1, device_decode=False):
    train = {"data_root": str(root / "train.zarr"), "w": HW, "h": HW,
             "sample_length": T,
             "mask": {"type": "stis", "file": str(root / "gauges.txt")}}
    if device_decode:
        train["device_decode"] = 1
    return {
        "seed": 7, "save_dir": str(save_dir), "experiment_name": "torch-test",
        "run_name": "run",
        "model": {"name": "p2igan", "in_channels": 1, "out_channels": 1,
                  "base_channels": 4 * T},
        "data": {"train": train},
        "loss": {"adversarial_weight": 0.01, "k1_weight": 0.05,
                 "gan_loss": "hinge", "use_gan": use_gan},
        "train": {"optimizer": {"beta1": 0.0, "beta2": 0.99, "lr": 1e-4},
                  "batch_size": 2, "num_workers": 2, "log_step": 1,
                  "iterations": iterations, "use_validation": True},
    }


def _record_batches(trainer):
    """Wrap the trainer's step construction so every training batch is kept."""
    seen = []
    build = trainer._build_steps

    def rebuild(idw_prepared=None):
        build(idw_prepared)
        step = trainer.train_step

        def recording(frames, masked, masks):
            seen.append(tuple(t.clone() for t in (frames, masked,
                                                  masks.expand_as(masked))))
            return step(frames, masked, masks)

        trainer.train_step = recording

    trainer._build_steps = rebuild
    rebuild()
    return seen


def test_overfit_one_batch_reduces_loss():
    """Repeated steps on one fixed batch drive the weighted-L1 rec loss well
    down (as tests/test_training.py:133 does for the JAX package): a
    sign-flipped or absent update fails it. Calibrated on the CPU: 6.27 ->
    1.32 in 120 steps (about 1.3 is the capacity floor for a noise target at
    this size, as in the JAX test); the thresholds keep about 30% margin."""
    rng = np.random.default_rng(3)
    flat = (rng.random(16 * 16) < 0.2).astype(np.float32)
    masks = torch.from_numpy(np.broadcast_to(flat.reshape(1, 1, 16, 16, 1),
                                             (2, T, 16, 16, 1)).copy())
    frames = torch.from_numpy(rng.random((2, T, 16, 16, 1), dtype=np.float32))
    gen = P2IGenerator(H=16, W=16, length=T, num_res=1, base_channels=4 * T,
                       idw_max_points=128, idw_factored=True, idw_shared_batch_mask=True,
                       generator=torch.Generator().manual_seed(0))
    opt = tsteps.make_optimizer({"lr": 1e-3}, gen.parameters())
    step = tsteps.build_train_step(gen, None, opt, None, use_gan=False, k1_alpha=0.0,
                                   idw_prepared=gen.prepare_idw(masks[0, 0, :, :, 0]))
    losses = [float(step(frames, frames * masks, masks)["rec_loss"]) for _ in range(120)]
    assert losses[0] > 3.0, f"unexpectedly easy start: {losses[0]}"
    assert min(losses) < 0.3 * losses[0], (losses[0], min(losses))
    assert min(losses) < 1.75, (losses[0], min(losses))


def test_train_writes_checkpoints_and_resume_continues(data_root, tmp_path):
    """A resumed run (3 steps, then 3 more from latest.ckpt through the CLI)
    ends where an uninterrupted 6-step run ends: the same global step, the
    same epoch stream of batches, and the same weights (rtol 1e-6: the same
    CPU arithmetic; the margin is for thread-scheduling order)."""
    full = Trainer(_cfg(data_root, tmp_path / "full", iterations=6), device="cpu")
    seen_full = _record_batches(full)
    full.train()
    assert full.global_step == 6 and full.train_loader.epoch == 2

    first = Trainer(_cfg(data_root, tmp_path / "part", iterations=3), device="cpu")
    seen_part = _record_batches(first)
    first.train()
    latest = tmp_path / "part" / "latest.ckpt"
    assert latest.exists() and (tmp_path / "part" / "best.ckpt").exists()
    raw = load_checkpoint_raw(latest)
    assert raw["global_step"] == 3 and raw["epoch"] == 1
    assert set(raw) == {"epoch", "global_step", "best_val", "generator", "optimizer_g",
                        "discriminator", "optimizer_d"}
    assert np.isfinite(first.last_rec_loss) and np.isfinite(first.last_dis_loss)

    spec = importlib.util.spec_from_file_location(
        "train_torch", Path(__file__).resolve().parents[1] / "scripts" / "train_torch.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(_cfg(data_root, tmp_path / "part", iterations=6)))
    resumed = cli.main(cli.parse_args(["--config", str(cfg_path), "--resume",
                                       str(latest), "--device", "cpu"]))
    assert resumed.global_step == 6 and resumed.train_loader.epoch == 2
    assert load_checkpoint_raw(latest)["global_step"] == 6
    assert len(seen_part) == 3
    for a, b in zip(seen_full[:3], seen_part):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for (name, p), q in zip(full.generator.state_dict().items(),
                            resumed.generator.state_dict().values()):
        np.testing.assert_allclose(q.numpy(), p.numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=name)
    for (name, p), q in zip(full.discriminator.state_dict().items(),
                            resumed.discriminator.state_dict().values()):
        np.testing.assert_allclose(q.numpy(), p.numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=name)
    gen_only = tmp_path / "gen.pt"
    torch.save(full.generator.state_dict(), gen_only)
    with pytest.raises(ValueError, match="training state"):
        full.load(gen_only)
    # serving loads the trainer's checkpoint (generator.params) as it is
    served = P2IGenerator.from_config(_cfg(data_root, tmp_path))
    served.load_state_dict(load_generator_state(latest))
    for (name, p), q in zip(resumed.generator.state_dict().items(),
                            served.state_dict().values()):
        assert torch.equal(p, q), name


def test_device_decode_gives_the_same_batches(data_root, tmp_path):
    """data.train.device_decode ships uint8 (frames, mask) pairs and decodes
    them with decode_normalize_mask; the batches, and so the losses, equal the
    float pipeline's exactly (as tests/test_training.py:270 for JAX)."""
    runs = {}
    for decode in (False, True):
        tr = Trainer(_cfg(data_root, tmp_path / f"dd{int(decode)}", iterations=2,
                          use_gan=0, device_decode=decode), device="cpu")
        seen = _record_batches(tr)
        tr.train()
        runs[decode] = (seen, tr.last_rec_loss)
    raw_item = P2IDataModule(_cfg(data_root, tmp_path, device_decode=True)
                             ).train_dataset[0]
    assert raw_item[0].dtype == np.uint8 and raw_item[1].shape == (1, HW, HW, 1)
    assert len(runs[False][0]) == len(runs[True][0]) == 2
    for a, b in zip(runs[False][0], runs[True][0]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert runs[False][1] == runs[True][1]


def test_profile_window_and_predict(data_root, tmp_path):
    """train.profile_dir writes a torch.profiler window (trace, per-kernel
    table, summary with the idle share); predict_fn serves the trained
    generator."""
    cfg = _cfg(data_root, tmp_path / "w", iterations=3, use_gan=0)
    cfg["train"].update(profile_dir=str(tmp_path / "prof"), profile_start_step=1,
                        profile_steps=1)
    tr = Trainer(cfg, device="cpu")
    tr.train()
    summary = json.loads((tmp_path / "prof" / "summary.json").read_text())
    assert summary["steps"] == 1 and summary["wall_ms"] > 0
    assert (tmp_path / "prof" / "trace.json").exists()
    assert "Name" in (tmp_path / "prof" / "key_averages.txt").read_text()
    frames, masked, masks = tr._put_batch(next(iter(tr.val_loader)))
    preds = tr.predict_fn(masked, masks)
    assert preds.shape == frames.shape and not preds.requires_grad


def test_validation_metrics_and_example_images(data_root, tmp_path, monkeypatch):
    """train.eval_metrics: the trainer feeds the metric suite every
    validation batch's prediction and logs each key as val/<key>; those
    values equal the JAX suite's on the same predictions (rtol 1e-5, SSIM
    2e-5). Every epoch writes one train example and one a validation batch
    (up to five), 2 x HW rows by T x HW columns of RGB; the examples leave
    the loader's epoch counter as it was."""
    import jax.numpy as jnp
    from PIL import Image

    from p2igan_tpu.metrics import metric as JM
    from p2igan_tpu_torch.metrics import RainfallMetricSuite
    from p2igan_tpu_torch.utils.tracking import get_tracker

    seen = []
    update = RainfallMetricSuite.update

    def recording(self, preds, target):
        seen.append((preds.clone(), target.clone()))
        return update(self, preds, target)

    monkeypatch.setattr(RainfallMetricSuite, "update", recording)
    cfg = _cfg(data_root, tmp_path / "ev", iterations=2)
    cfg["train"]["eval_metrics"] = True
    tr = Trainer(cfg, device="cpu")
    tr.train()
    assert tr.train_loader.epoch == 1 and len(seen) == len(tr.val_loader) >= 1
    logged = {}
    for line in (get_tracker().run_dir / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["key"].startswith("val/") and rec["key"] != "val/loss":
            assert rec["step"] == 2
            logged[rec["key"][4:]] = rec["value"]
    suite = JM.RainfallMetricSuite(JM.MetricConfig())
    for preds, target in seen:
        assert preds.shape == target.shape and preds.shape[1:] == (T, HW, HW, 1)
        suite.update(jnp.asarray(preds.numpy()), jnp.asarray(target.numpy()))
    want = suite.compute()
    assert logged.keys() == want.keys() and len(want) == 3 + 16 + 16
    for key, val in want.items():
        np.testing.assert_allclose(logged[key], val, rtol=2e-5 if key == "ssim" else 1e-5,
                                   atol=1e-12, err_msg=key)
    artifacts = tmp_path / "ev" / "artifacts"
    names = sorted(p.name for p in artifacts.glob("*.png"))
    assert names == ["train_epoch1_batch0_ex0.png"] + [
        f"val_epoch1_batch{b}_ex0.png" for b in range(min(5, len(tr.val_loader)))]
    for name in names:
        with Image.open(artifacts / name) as img:
            assert img.mode == "RGB" and img.size == (T * HW, 2 * HW)
