"""The port's host scripts on the CPU at a tiny size: the convergence smoke
(``scripts/convergence_smoke_torch.py --device cpu``: 16 x 16, T=4, two GAN
steps with validation metrics and example images, the gate opened with
``--learn-ratio 10``) and the fake-data tree
(``scripts/make_fake_data_torch.py``)."""

import importlib.util
import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_convergence_smoke_torch_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("P2IGAN_FORCE_FILE_TRACKER", "1")
    smoke = _load("convergence_smoke_torch")
    monkeypatch.setattr(smoke, "EXAMPLE_OUT", tmp_path / "docs" / "example.png")
    verdict = smoke.main(["--device", "cpu", "--size", "16", "--frames", "4", "--events", "2",
                          "--event-frames", "8", "--batch", "2", "--steps", "2",
                          "--log-step", "1", "--learn-ratio", "10", "--append",
                          "--workdir", str(tmp_path / "work")])
    assert verdict == "LEARNS"
    out = capsys.readouterr().out
    assert "[LEARNS]" in out and "train/dis_loss:" in out
    val = json.loads(out.split("validation at step 2: ")[1].splitlines()[0])
    assert {"mae", "rmse", "ssim", "cat_thr8.00/csi", "fss_thr0.50_s8", "loss"} <= set(val)
    assert (tmp_path / "docs" / "example.png").exists()
    assert "![convergence example](docs/convergence_smoke_torch.png)" in out
    assert (tmp_path / "work" / "weights" / "latest.ckpt").exists()


def test_convergence_smoke_torch_gate_fails_a_run_that_does_not_learn(tmp_path, monkeypatch):
    monkeypatch.setenv("P2IGAN_FORCE_FILE_TRACKER", "1")
    smoke = _load("convergence_smoke_torch")
    with pytest.raises(SystemExit) as exit_info:
        smoke.main(["--device", "cpu", "--size", "16", "--frames", "4", "--events", "2",
                    "--event-frames", "8", "--batch", "2", "--steps", "1", "--log-step", "1",
                    "--learn-ratio", "0.5", "--workdir", str(tmp_path / "work")])
    assert exit_info.value.code == 1  # one logged point: its tail is itself


@pytest.mark.parametrize("h5", [True, False])
def test_make_fake_data_torch_writes_the_tree(tmp_path, monkeypatch, h5):
    script = _load("make_fake_data_torch")
    if not h5:
        monkeypatch.setattr(script.importlib.util, "find_spec",
                            lambda name: None if name == "h5py" else object())
    monkeypatch.setattr(sys, "argv", ["make_fake_data_torch.py", "--root",
                                      str(tmp_path / "fake"), "--size", "16",
                                      "--frames", "4"])
    script.main()
    root = tmp_path / "fake"
    for rel in ("nimrod_test.zarr", "nimrod_train.zarr", "masks/gauge_mask_128_train.txt",
                "masks/gauge_mask_128_test.txt"):
        assert (root / rel).exists(), rel
    assert (root / "test_events" / "1.h5").exists() == h5
