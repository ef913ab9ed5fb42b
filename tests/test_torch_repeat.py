"""Fixed orders of the port's orchestration, on the CPU.

* The serving accumulator adds each window's predictions into its frames in
  window order, so the served reconstruction is a numpy sequential sum in
  that order, bit for bit (on the card too: no ``index_add_``, whose order is
  not fixed there).
* The bilinear resizes of the generator (UPPos) and of the P2I critic keep
  ``F.interpolate``'s forward, bit for bit, and take their gradient as two
  matrix products in a fixed order (PyTorch's CUDA backward uses atomics).
* ``train/steps_per_sec`` is the reference's: the steps since the epoch began
  over the time since then (``p2igan_tpu/training/trainer.py``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from p2igan_tpu_torch.inference.driver import SlidingWindowReconstructor
from p2igan_tpu_torch.ops.convs import bilinear_resize, bilinear_upsample2x_align_corners
from p2igan_tpu_torch.training import trainer as trainer_mod
from p2igan_tpu_torch.training.trainer import Trainer

from test_torch_trainer import _cfg, data_root  # noqa: F401  (fixture)


class _WindowGenerator(torch.nn.Module):
    """A stand-in generator, elementwise in its window: predictions whose sums
    depend on their order in float32."""

    def __init__(self):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.tensor(0.7310585))

    def forward(self, masked, masks):
        t = torch.arange(masked.shape[1], dtype=torch.float32).reshape(1, -1, 1, 1, 1)
        return torch.sin(masked * 37.0 + t) * self.scale + masks * 1e-3


def _sequential(gen, masked, masks, stride, overlap, scale):
    """numpy: every window of every event, in stream order, its frames added
    one by one into a float32 accumulator; the overlap average with the 1e-5
    floor, x scale, clip >= 0."""
    E, T = masked.shape[:2]
    acc = np.zeros(masked.shape, np.float32)
    cnt = np.zeros((E, T), np.float32)
    for e in range(E):
        for st in range(0, T, max(1, stride - overlap)):
            idx = np.minimum(np.arange(st, st + stride), T - 1)
            with torch.no_grad():
                pred = gen(torch.from_numpy(masked[e, idx][None]),
                           torch.from_numpy(masks[e, idx][None])).numpy()[0]
            for j in range(min(stride, T - st)):
                acc[e, st + j] += pred[j]
                cnt[e, st + j] += np.float32(1.0)
    out = acc / np.maximum(cnt, np.float32(1e-5))[..., None, None, None]
    return np.maximum(out * np.float32(scale), np.float32(0.0))


@pytest.mark.parametrize("stride,overlap,wb,T,E", [(16, 12, 8, 37, 2), (4, 2, 3, 11, 3),
                                                   (6, 4, 5, 6, 1)])
def test_serving_accumulator_is_the_sequential_sum(stride, overlap, wb, T, E):
    """The reconstruction equals the numpy sequential accumulation in window
    order bitwise: chunks of ``wb`` windows, the last padded, up to
    stride / step windows meeting in one frame."""
    rng = np.random.default_rng(stride + T)
    masks = (rng.random((E, T, 9, 7, 1)) < 0.3).astype(np.float32)
    masked = rng.random(masks.shape).astype(np.float32) * masks
    gen = _WindowGenerator()
    recon = SlidingWindowReconstructor(gen, stride=stride, overlap=overlap,
                                       window_batch=wb, output_scale=255.0)
    got = recon.batch(masked, masks)
    want = _sequential(gen, masked, masks, stride, overlap, 255.0)
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    one = recon(masked[0], masks[0])
    assert np.array_equal(one.view(np.int32), want[0].view(np.int32))


@pytest.mark.parametrize("hw,size,align_corners", [
    ((16, 16), (32, 32), False),   # the critic's 3-D branch onto the 2-D one
    ((5, 7), (12, 9), False), ((3, 3), (2, 5), False),
    ((8, 4), (16, 8), True), ((1, 3), (2, 6), True)])
def test_bilinear_resize_forward_and_fixed_order_backward(hw, size, align_corners):
    """The forward is ``F.interpolate`` bit for bit; the gradient (A_h^T g A_w)
    is autograd of ``F.interpolate`` to 1e-6 x max|gradient| (the same terms,
    summed in another order)."""
    rng = np.random.default_rng(sum(hw) + sum(size))
    x = torch.from_numpy(rng.normal(size=(2, 3) + hw).astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=(2, 3) + size).astype(np.float32))
    want = F.interpolate(x, size=size, mode="bilinear", align_corners=align_corners)
    got = bilinear_resize(x, size, align_corners)
    assert got.grad_fn is not None and torch.equal(got, want)
    (dw,) = torch.autograd.grad(want, x, g)
    (dg,) = torch.autograd.grad(got, x, g)
    assert float((dg - dw).abs().max()) <= 1e-6 * float(dw.abs().max())
    if align_corners and size == (2 * hw[0], 2 * hw[1]):
        up = bilinear_upsample2x_align_corners(x)
        assert torch.equal(up, F.interpolate(x, scale_factor=2, mode="bilinear",
                                             align_corners=True))


def test_steps_per_sec_is_the_reference_definition(data_root, tmp_path,  # noqa: F811
                                                   monkeypatch):
    """Under a fake clock that advances only inside the steps: the logged
    rate at each log point is (steps since the epoch began) / (time since
    then), the JAX trainer's ``steps / (time.time() - t0)``; it starts again
    with each epoch. The log points keep (global step, time) in
    ``log_times``."""
    durations = [1.0, 3.0, 0.5, 2.0, 4.0, 0.25]

    class Clock:
        now = 100.0

        @classmethod
        def perf_counter(cls):
            return cls.now

    monkeypatch.setattr(trainer_mod, "time", Clock)
    cfg = _cfg(data_root, tmp_path / "w", iterations=len(durations), use_gan=0)
    cfg["train"]["max_epochs"] = 3
    tr = Trainer(cfg, device="cpu")
    epochs = []
    build = tr._build_steps

    def rebuild(idw_prepared=None):  # every (re)build of the steps gets timed
        build(idw_prepared)
        step = tr.train_step

        def timed(frames, masked, masks):
            out = step(frames, masked, masks)
            Clock.now += durations[tr.global_step]
            epochs.append(tr.train_loader.epoch)
            return out

        tr.train_step = timed

    tr._build_steps = rebuild
    rebuild()
    logged = []
    log_metric = tr.tracker.log_metric
    tr.tracker.log_metric = lambda key, value, step=None: (
        logged.append(value) if key == "train/steps_per_sec" else None,
        log_metric(key, value, step=step))
    tr.train()
    assert tr.global_step == len(durations) and len(set(epochs)) > 1
    want, in_epoch, since = [], 0, 0.0
    for i, d in enumerate(durations):
        if i and epochs[i] != epochs[i - 1]:
            in_epoch, since = 0, 0.0
        in_epoch, since = in_epoch + 1, since + d
        want.append(in_epoch / since)
    assert logged == pytest.approx(want, rel=1e-12)
    assert [s for s, _ in tr.log_times] == list(range(1, len(durations) + 1))
