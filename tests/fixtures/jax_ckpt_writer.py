"""Writes ``tests/fixtures/jax_ckpt/``: a checkpoint of the JAX package's
trainer and the config it was trained under, for the PyTorch port's loader of
JAX checkpoints (``p2igan_tpu_torch/utils/flax_msgpack.py``), which is held to
it on a machine without flax or msgpack.

    python tests/fixtures/jax_ckpt_writer.py

The config is ``p2igan_tpu/config/p2igan_baseline.json`` (rec-loss, beta1 = 0:
the mu-free Adam) at its full frame (128 x 128, 16 frames) with its model set
to the simple family at ``base_channels`` 4. A p2igan generator cannot be cut
that far: it needs base_channels = 4 x frames and its grouped input
convolution four frames or more, and its smallest trainer checkpoint (four
frames, base 16: 1.6M parameters and their Adam moments) is 12.6 MB; this one
carries BatchNorm statistics as well. The trainer, on one device, takes two
steps at batch 2
on a seeded fake store (one event, four windows: one epoch), so the
optimizer's ``nu`` is not zero, and writes ``latest.ckpt``: generator and
``optimizer_g`` only, epoch 1, global step 2. This module imports the JAX
package; it is no module of the port.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path

FIXTURE = Path(__file__).parent / "jax_ckpt"
BASE_CONFIG = Path(__file__).resolve().parents[2] / "p2igan_tpu" / "config" / "p2igan_baseline.json"
FRAMES, HW, BATCH, STEPS = 16, 128, 2, 2


def fixture_config(root: Path) -> dict:
    """The baseline config cut as the module docstring says, its data under
    ``root`` (``train.zarr`` and ``gauges.txt``, written by
    :func:`write_data`)."""
    cfg = json.loads(BASE_CONFIG.read_text())
    cfg["model"] = {"name": "simple", "in_channels": 1, "out_channels": 1,
                    "base_channels": 4}
    for split in ("train", "test"):
        cfg["data"][split]["mask"]["file"] = str(root / "gauges.txt")
    cfg["data"]["train"]["data_root"] = str(root / "train.zarr")
    cfg["data"]["test"]["data_root"] = str(root / "test.zarr")
    cfg["save_dir"] = str(root / "weights")
    cfg["train"].update({"batch_size": BATCH, "iterations": STEPS, "num_workers": 1,
                         "log_step": 1, "use_validation": False})
    return cfg


def write_data(root: Path) -> None:
    """A training store of one 19-frame event (four 16-frame windows), a
    serving store of one 64-frame event and the 79-gauge mask."""
    from p2igan_tpu.data import fake

    fake.write_train_zarr(root / "train.zarr", n_events=1, T=FRAMES + 3, H=HW, W=HW,
                          window=FRAMES, stride=1, seed=0)
    fake.write_test_zarr(root / "test.zarr", n_events=1, T=64, H=HW, W=HW, seed=2)
    fake.write_gauge_mask(root / "gauges.txt", H=HW, W=HW, n_gauges=79, seed=1)


def make_fixture(out: Path = FIXTURE) -> Path:
    """Train and write ``out/latest.ckpt`` and ``out/config.json`` (data paths
    as ``<root>``, to be replaced by the reader's own)."""
    import jax

    from p2igan_tpu.parallel.mesh import create_mesh
    from p2igan_tpu.training.trainer import Trainer

    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_data(root)
        cfg = fixture_config(root)
        os.environ.setdefault("P2IGAN_FORCE_FILE_TRACKER", "1")
        from p2igan_tpu.utils.tracking import get_tracker

        get_tracker().set_tracking_uri(str(root / "mlruns"))
        # one device, whatever the host offers (the tests' conftest gives 8)
        trainer = Trainer(cfg, mesh=create_mesh(devices=jax.devices()[:1]))
        trainer.train()
        shutil.copyfile(root / "weights" / "latest.ckpt", out / "latest.ckpt")
        text = json.dumps(cfg, indent=2).replace(str(root), "<root>")
    (out / "config.json").write_text(text + "\n")
    return out


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(BASE_CONFIG.parents[2]))  # the repository root
    print(make_fixture())
