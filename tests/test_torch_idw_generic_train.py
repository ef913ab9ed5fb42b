"""The port's trainer on masks that vary per frame (stin), through the
generic IDW: nothing to hoist, both input pipelines.

The hinge-GAN step on stin masks against the un-jitted JAX step is
``test_one_stin_gan_step_matches_jax`` in ``tests/test_torch_sti_train.py``:
the un-jitted JAX step compiles every operation it meets once a process
(about 95 s on the CPU), and there the sti step has paid for it.
"""

import numpy as np
import pytest
import torch

from p2igan_tpu_torch.data.datamodule import P2IDataModule
from p2igan_tpu_torch.training.trainer import Trainer

from test_torch_gan import HW, T
from test_torch_sti_train import _cfg as _sti_cfg
from test_torch_sti_train import data_root  # noqa: F401  (fixture)
from test_torch_trainer import _record_batches


@pytest.fixture(autouse=True)
def _file_tracker(monkeypatch, tmp_path):
    monkeypatch.setenv("P2IGAN_FORCE_FILE_TRACKER", "1")
    from p2igan_tpu_torch.utils.tracking import get_tracker

    get_tracker().set_tracking_uri(str(tmp_path / "mlruns"))


def _cfg(root, save_dir, device_decode=False):
    cfg = _sti_cfg(root, save_dir, device_decode=device_decode)
    cfg["data"]["train"]["mask"] = {"type": "stin", "block_sizes": [8], "keep": 2}
    return cfg


def test_stin_trainer_hoists_nothing_and_both_pipelines_give_the_same_step(
        data_root, tmp_path):  # noqa: F811
    """A stin config trains through the Trainer on the generic IDW, the full
    per-frame mask flowing through the step. The raw (device_decode) pipeline
    ships the whole (T, H, W, 1) uint8 mask a sample (not one frame, as for
    sti) and decodes on the device; its batches, and so its losses and
    weights after two GAN steps, equal the float pipeline's exactly."""
    runs = {}
    for decode in (False, True):
        tr = Trainer(_cfg(data_root, tmp_path / f"dd{int(decode)}", decode), device="cpu")
        assert not tr._idw_hoist_pending and not tr.generator.idw_factored
        # 2 dense frames + 2 x 25 block-8 gauges -> 2098 -> 2176 points
        assert tr.generator.idw_max_points == 2176
        seen = _record_batches(tr)
        tr.train()
        assert tr.global_step == 2 and np.isfinite(tr.last_dis_loss)
        assert (tmp_path / f"dd{int(decode)}" / "latest.ckpt").exists()
        runs[decode] = (seen, tr.last_rec_loss, tr.generator.state_dict())
    raw_item = P2IDataModule(_cfg(data_root, tmp_path, True)).train_dataset[0]
    assert raw_item[0].dtype == np.uint8 and raw_item[1].shape == (T, HW, HW, 1)
    assert len(runs[False][0]) == len(runs[True][0]) == 2
    for a, b in zip(runs[False][0], runs[True][0]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        masks = a[2]
        assert masks.shape == (2, T, HW, HW, 1)
        assert bool((masks[:, :2] == 1).all())                    # kept frames
        assert not torch.equal(masks[:, 2], masks[:, 0])          # varies per frame
    assert runs[False][1] == runs[True][1]
    for (name, p), q in zip(runs[False][2].items(), runs[True][2].values()):
        assert torch.equal(p, q), name
