"""Each fault a cell can have makes its run come out not correct: the rest
of a run driven on the CPU at a tiny size (the look for a card skipped),
with the timed path broken underneath."""

from __future__ import annotations

import pytest
import torch

from conftest import run_tiny


def test_state_left_unchanged(tiny_root, monkeypatch):
    from p2igan_tpu_torch.training import steps

    monkeypatch.setattr(steps.AdamNoMu, "step", lambda self, closure=None: None)
    for cell in ("tiny_p2igan_stis_gan.train_b12", "tiny_dk_stis.train_b12"):
        line = run_tiny(tiny_root, cell)
        assert not line["correct"]
        assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["tiny_p2igan_stis_gan.train_b12", "tiny_dk_stis.train_b12"])
def test_half_of_the_batch_left_out(tiny_root, monkeypatch, cell):
    from p2igan_tpu_torch.training import trainer

    build = trainer.build_train_step

    def half(*a, **kw):
        step = build(*a, **kw)
        return lambda f, m, k: step(f[: f.shape[0] // 2], m[: m.shape[0] // 2],
                                    k[: k.shape[0] // 2])

    monkeypatch.setattr(trainer, "build_train_step", half)
    assert not run_tiny(tiny_root, cell)["correct"]


def test_served_answer_altered(tiny_root, monkeypatch):
    from p2igan_tpu_torch.inference import driver

    call = driver.SlidingWindowReconstructor.__call__

    def altered(self, masked, masks):
        out = call(self, masked, masks)
        out[-1, 0, 0, 0] += 1.0
        return out

    monkeypatch.setattr(driver.SlidingWindowReconstructor, "__call__", altered)
    assert not run_tiny(tiny_root, "tiny_p2igan_stis_gan.serve_archive")["correct"]


def test_served_half_of_the_windows_left_out(tiny_root, monkeypatch):
    """Half of every window batch is not computed: the first half's
    predictions stand in for it, so each frame averages over the rest."""
    from p2igan_tpu_torch.models.p2igan import P2IGenerator

    forward = P2IGenerator.forward

    def half(self, masked, masks, idw_prepared=None):
        n = masked.shape[0]
        out = forward(self, masked[: max(1, n // 2)], masks[: max(1, n // 2)], idw_prepared)
        return torch.cat([out, out], dim=0)[:n] if n > 1 else out

    monkeypatch.setattr(P2IGenerator, "forward", half)
    assert not run_tiny(tiny_root, "tiny_p2igan_stis_gan.serve_archive")["correct"]
