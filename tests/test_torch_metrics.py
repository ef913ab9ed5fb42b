"""The port's metric suite (``p2igan_tpu_torch/metrics/metric.py``) against
the JAX package's on the same numpy inputs, on the CPU: every function and
the whole suite at rtol 1e-5 (SSIM 2e-5), counts exactly. The cases of
``tests/test_metrics.py`` are all here, run on both packages.

The inputs are normalized values drawn from [0, 60] (the transform maps them
to 0.036-202 mm/h), so every threshold (0.5, 2, 4, 8 mm/h) splits the pixels;
values whose transform lies within 1e-5 of a threshold are drawn again, so a
last-bit difference of the two ``pow``s cannot flip a count."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from p2igan_tpu.metrics import metric as JM
from p2igan_tpu_torch.metrics import metric as TM

THRESHOLDS = (0.5, 2.0, 4.0, 8.0)
SCALES = (1, 2, 4, 8)
RTOL, SSIM_RTOL = 1e-5, 2e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


def _clear_of_thresholds(rng, x, thresholds=THRESHOLDS):
    """Redraw values whose transform is within 1e-5 (relative) of a threshold."""
    x = x.copy()
    while True:
        mm = 10.0 ** (x.astype(np.float64) * 0.0625) * 0.036
        near = np.zeros(x.shape, bool)
        for thr in thresholds:
            near |= np.abs(mm / thr - 1.0) < 1e-5
        if not near.any():
            return x
        x[near] = rng.uniform(0.0, 60.0, int(near.sum())).astype(np.float32)


def rain_pair(rng, shape):
    """(preds, target) normalized values in [0, 60]: target a field, preds the
    target plus noise (so SSIM is neither 1 nor 0)."""
    target = rng.uniform(0.0, 60.0, shape).astype(np.float32)
    preds = np.clip(target + rng.normal(0.0, 6.0, shape), 0.0, 60.0).astype(np.float32)
    return _clear_of_thresholds(rng, preds), _clear_of_thresholds(rng, target)


def assert_state_equal(ours, theirs, counts=()):
    """A port state dict against a JAX one: same leaves, float32; count
    leaves exactly, the rest at RTOL."""
    assert set(ours) == set(theirs)
    for key, val in ours.items():
        assert val.dtype == torch.float32, key
        want = np.asarray(theirs[key])
        if key in counts:
            np.testing.assert_array_equal(val.numpy(), want, err_msg=key)
        else:
            np.testing.assert_allclose(val.numpy(), want, rtol=RTOL, err_msg=key)


def assert_metrics_close(ours, theirs, rtol=RTOL, atol=1e-12):
    assert ours.keys() == theirs.keys()
    for key, val in ours.items():
        tol = SSIM_RTOL if key == "ssim" else rtol
        np.testing.assert_allclose(val, theirs[key], rtol=tol, atol=atol, err_msg=key)


def test_transform_matches_jax_and_the_reference():
    x = np.array([0.0, 8.0, 16.0, 37.5, 60.0], np.float32)
    ref = (10.0 ** (x * 0.0625)) * 0.036
    ours = TM.transform(_t(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6)
    np.testing.assert_allclose(ours, np.asarray(JM.transform(_j(x))), rtol=RTOL)


def test_gaussian_kernel_is_the_jax_one_bitwise():
    np.testing.assert_array_equal(TM._gaussian_kernel1d(11, 1.5),
                                  JM._gaussian_kernel1d(11, 1.5))
    assert TM._gaussian_kernel1d(11, 1.5).dtype == np.float32


def test_gaussian_blur_valid_matches_jax(rng):
    x = rng.random((3, 20, 17)).astype(np.float32)
    ours = TM._gaussian_blur_valid(_t(x)).numpy()
    assert ours.shape == (3, 10, 7)
    np.testing.assert_allclose(ours, np.asarray(JM._gaussian_blur_valid(_j(x))),
                               rtol=RTOL, atol=1e-7)


def _np_gaussian_ssim(a, b, data_range=1.0, size=11, sigma=1.5):
    """Independent numpy SSIM with reflect pad + border crop (torchmetrics style)."""
    from scipy.ndimage import correlate1d

    k = TM._gaussian_kernel1d(size, sigma).astype(np.float64)

    def blur(x):
        y = correlate1d(x, k, axis=0, mode="reflect")
        return correlate1d(y, k, axis=1, mode="reflect")

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a, mu_b = blur(a), blur(b)
    sa = blur(a * a) - mu_a ** 2
    sb = blur(b * b) - mu_b ** 2
    sab = blur(a * b) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * sab + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (sa + sb + c2)
    pad = (size - 1) // 2
    return (num / den)[pad:-pad, pad:-pad].mean()


def test_ssim_matches_numpy_reference_and_jax(rng):
    a = rng.random((2, 32, 32)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    ours = TM.ssim_per_image(_t(a), _t(b)).numpy()
    for i in range(2):
        ref = _np_gaussian_ssim(a[i].astype(np.float64), b[i].astype(np.float64))
        assert abs(ours[i] - ref) < 1e-4
    np.testing.assert_allclose(ours, np.asarray(JM.ssim_per_image(_j(a), _j(b))),
                               rtol=SSIM_RTOL)
    same = TM.ssim_per_image(_t(a), _t(a)).numpy()
    np.testing.assert_allclose(same, 1.0, atol=1e-5)


def test_ssim_small_image_raises():
    x = torch.zeros((1, 8, 8))
    with pytest.raises(ValueError, match="SSIM window"):
        TM.ssim_per_image(x, x)
    with pytest.raises(ValueError, match="SSIM window"):
        TM.ssim_per_image(torch.zeros((1, 10, 40)), torch.zeros((1, 10, 40)))


def test_to_nhw_multichannel_folds_channels_into_planes():
    x = np.arange(2 * 3 * 4 * 5 * 2, dtype=np.float32).reshape(2, 3, 4, 5, 2)
    ours = TM._to_nhw(_t(x)).numpy()
    assert ours.shape == (2 * 3 * 2, 4, 5)
    np.testing.assert_array_equal(ours[1], x[0, 0, :, :, 1])
    np.testing.assert_array_equal(ours, np.asarray(JM._to_nhw(_j(x))))


@pytest.mark.parametrize("shape", [(2, 3, 16, 16), (3, 16, 16), (2, 3, 16, 16, 1)])
def test_to_nhw_other_layouts_match_jax(shape):
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    np.testing.assert_array_equal(TM._to_nhw(_t(x)).numpy(), np.asarray(JM._to_nhw(_j(x))))


@pytest.mark.parametrize("apply_transform", [True, False])
@pytest.mark.parametrize("channels", [1, 2])
def test_regression_metrics_match_jax(rng, channels, apply_transform):
    preds, target = rain_pair(rng, (2, 3, 16, 16, channels))
    if not apply_transform:
        preds, target = preds / 60.0, target / 60.0
    ours = TM.regression_metrics_update(TM.regression_metrics_init(), _t(preds), _t(target),
                                        apply_transform)
    theirs = JM.regression_metrics_update(JM.regression_metrics_init(), _j(preds),
                                          _j(target), apply_transform)
    assert_state_equal({k: v for k, v in ours.items() if k != "ssim_sum"},
                       {k: v for k, v in theirs.items() if k != "ssim_sum"},
                       counts=("n_obs", "ssim_n"))
    np.testing.assert_allclose(ours["ssim_sum"].numpy(), np.asarray(theirs["ssim_sum"]),
                               rtol=SSIM_RTOL)
    assert float(ours["ssim_n"]) == 2 * 3 * channels
    out = TM.regression_metrics_compute(ours)
    assert_metrics_close(out, JM.regression_metrics_compute(theirs))
    tp = TM.transform(_t(preds)) if apply_transform else _t(preds)
    tt = TM.transform(_t(target)) if apply_transform else _t(target)
    assert abs(out["mae"] - float(torch.mean(torch.abs(tp - tt)))) < 1e-5 * out["mae"]
    assert abs(out["rmse"] - float(torch.sqrt(torch.mean((tp - tt) ** 2)))) < 1e-5 * out["rmse"]


def test_categorical_counts_match_jax_and_numpy(rng):
    mm_p = (rng.random((40, 8, 8)) * 40).astype(np.float32)
    mm_t = (rng.random((40, 8, 8)) * 40).astype(np.float32)
    # run on pre-transform values, as the suite does
    pn = _clear_of_thresholds(rng, (np.log10(mm_p.clip(1e-3) / 0.036) / 0.0625)
                              .astype(np.float32))
    tn = _clear_of_thresholds(rng, (np.log10(mm_t.clip(1e-3) / 0.036) / 0.0625)
                              .astype(np.float32))
    ours = TM.categorical_metrics_update(TM.categorical_metrics_init(4), _t(pn), _t(tn),
                                         THRESHOLDS)
    theirs = JM.categorical_metrics_update(JM.categorical_metrics_init(4), _j(pn), _j(tn),
                                           THRESHOLDS)
    assert_state_equal(ours, theirs, counts=tuple(ours))
    out = TM.categorical_metrics_compute(ours, THRESHOLDS)
    assert out == JM.categorical_metrics_compute(theirs, THRESHOLDS)
    preds = 10.0 ** (pn.astype(np.float64) * 0.0625) * 0.036
    target = 10.0 ** (tn.astype(np.float64) * 0.0625) * 0.036
    for i, thr in enumerate(THRESHOLDS):
        hits = np.sum((preds >= thr) & (target >= thr))
        misses = np.sum((preds < thr) & (target >= thr))
        false = np.sum((preds >= thr) & (target < thr))
        assert (float(ours["hits"][i]), float(ours["misses"][i]),
                float(ours["false"][i])) == (hits, misses, false)
        assert abs(out[f"cat_thr{thr:.2f}/pod"] - hits / (hits + misses + 1e-10)) < 1e-3
        assert abs(out[f"cat_thr{thr:.2f}/csi"]
                   - hits / (hits + misses + false + 1e-10)) < 1e-3


def test_fss_perfect_prediction(rng):
    x = (rng.random((4, 16, 16)) * 20).astype(np.float32)
    xn = (np.log10(x.clip(1e-3) / 0.036) / 0.0625).astype(np.float32)
    thresholds, scales = (0.5, 2.0), (1, 2, 4)
    st = TM.fss_update(TM.fss_init(2, 3), _t(xn), _t(xn), thresholds, scales)
    out = TM.fss_compute(st, thresholds, scales)
    assert len(out) == 6
    for v in out.values():
        assert abs(v - 1.0) < 1e-5


@pytest.mark.parametrize("scale", [1, 2, 3, 4, 8])
def test_fss_fractions_match_torch_pool_and_jax(rng, scale):
    x = (rng.random((3, 12, 12)) > 0.5).astype(np.float32)
    ours = TM._fractional_mean(_t(x), scale).numpy()
    np.testing.assert_allclose(ours, np.asarray(JM._fractional_mean(_j(x), scale)),
                               rtol=RTOL, atol=1e-7)
    if scale > 1:
        ref = F.avg_pool2d(_t(x)[:, None], kernel_size=scale, stride=1,
                           padding=scale // 2).numpy()[:, 0]
        np.testing.assert_allclose(ours, ref, atol=1e-6)
        assert ours.shape[-1] == 12 + (1 if scale % 2 == 0 else 0)


@pytest.mark.parametrize("channels", [1, 2])
def test_fss_matches_jax(rng, channels):
    preds, target = rain_pair(rng, (2, 3, 16, 16, channels))
    ours = TM.fss_update(TM.fss_init(4, 4), _t(preds), _t(target), THRESHOLDS, SCALES)
    theirs = JM.fss_update(JM.fss_init(4, 4), _j(preds), _j(target), THRESHOLDS, SCALES)
    assert_state_equal(ours, theirs, counts=("counts",))
    assert_metrics_close(TM.fss_compute(ours, THRESHOLDS, SCALES),
                         JM.fss_compute(theirs, THRESHOLDS, SCALES))


def _suite_pair(cfg=None):
    return TM.RainfallMetricSuite(cfg and TM.MetricConfig(**cfg), device="cpu"), \
        JM.RainfallMetricSuite(cfg and JM.MetricConfig(**cfg))


@pytest.mark.parametrize("channels", [1, 2])
def test_suite_matches_jax_and_crosses_every_threshold(rng, channels):
    ours, theirs = _suite_pair()
    for _ in range(2):
        preds, target = rain_pair(rng, (2, 3, 16, 16, channels))
        ours.update(_t(preds), _t(target))
        theirs.update(_j(preds), _j(target))
    for o, t, counts in zip(ours.state, theirs.state,
                            (("n_obs", "ssim_n"), ("hits", "misses", "false", "correct"),
                             ("counts",))):
        o = {k: v for k, v in o.items() if k != "ssim_sum"}
        assert_state_equal(o, {k: t[k] for k in o}, counts=counts)
    np.testing.assert_allclose(ours.state[0]["ssim_sum"].numpy(),
                               np.asarray(theirs.state[0]["ssim_sum"]), rtol=SSIM_RTOL)
    # the inputs cross every threshold: no count is empty, and no FSS score
    # is the no-event 1.0
    cat = ours.state[1]
    for key in ("hits", "misses", "false", "correct"):
        assert bool((cat[key] > 0).all()), (key, cat[key])
    assert bool((ours.state[2]["score_sum"] < 2.0 - 1e-3).all())
    out = ours.compute()
    assert_metrics_close(out, theirs.compute())
    assert len(out) == 3 + 4 * len(THRESHOLDS) + len(THRESHOLDS) * len(SCALES)
    ours.reset()
    assert float(ours.state[0]["n_obs"]) == 0.0


def test_suite_end_to_end(rng):
    cfg = {"thresholds": (0.5, 2.0), "scales": (1, 2)}
    ours, theirs = _suite_pair(cfg)
    preds = rng.random((1, 2, 16, 16, 1)).astype(np.float32)
    target = rng.random((1, 2, 16, 16, 1)).astype(np.float32)
    for _ in range(2):
        ours.update(_t(preds), _t(target))
        theirs.update(_j(preds), _j(target))
    out = ours.compute()
    assert set(k.split("/")[0] for k in out) >= {"mae", "rmse", "ssim", "cat_thr0.50"}
    assert_metrics_close(out, theirs.compute())
    ours.reset()
    assert float(ours.state[0]["n_obs"]) == 0.0


def test_suite_config_frozen_at_init():
    cfg = TM.MetricConfig(thresholds=[0.5, 2.0], scales=[1, 2])
    suite = TM.RainfallMetricSuite(cfg, device="cpu")
    cfg.thresholds = (9.0, 99.0)  # the caller mutates after construction
    p = torch.from_numpy(np.random.default_rng(0).random((1, 2, 16, 16, 1))
                         .astype(np.float32))
    suite.update(p, p)
    out = suite.compute()
    assert "cat_thr0.50/pod" in out and "cat_thr9.00/pod" not in out
    assert suite.cfg.thresholds == (0.5, 2.0) and suite.cfg.scales == (1, 2)


def test_quirks_on_perfect_predictions(rng):
    """HSS of a perfect forecast is 2.0 (the reference's denominator), as in
    the JAX suite; POD and CSI are 1, FAR 0, FSS 1. (The jitted JAX suite
    gives MAE 5e-7 here, not 0: its two transforms of the one array round
    apart; so the errors compare within 1e-5 absolute.)"""
    _, target = rain_pair(rng, (1, 2, 16, 16, 1))
    ours, theirs = _suite_pair()
    ours.update(_t(target), _t(target))
    theirs.update(_j(target), _j(target))
    out = ours.compute()
    assert_metrics_close(out, theirs.compute(), atol=1e-5)
    for thr in THRESHOLDS:
        assert abs(out[f"cat_thr{thr:.2f}/hss"] - 2.0) < 1e-9
        assert abs(out[f"cat_thr{thr:.2f}/pod"] - 1.0) < 1e-9
        assert out[f"cat_thr{thr:.2f}/far"] == 0.0
    assert out["mae"] == 0.0 and abs(out["ssim"] - 1.0) < 1e-5


def test_quirks_on_dry_predictions():
    """No pixel above a threshold in prediction and target: every FSS score
    is 1.0 (0 / EPS), and the batch is counted, as in the JAX suite."""
    dry = np.zeros((1, 2, 16, 16, 1), np.float32)  # transform(0) = 0.036 mm/h
    ours, theirs = _suite_pair()
    for _ in range(3):
        ours.update(_t(dry), _t(dry))
        theirs.update(_j(dry), _j(dry))
    out = ours.compute()
    assert_metrics_close(out, theirs.compute())
    np.testing.assert_array_equal(ours.state[2]["counts"].numpy(), 3.0)
    for thr in THRESHOLDS:
        for s in SCALES:
            assert out[f"fss_thr{thr:.2f}_s{s}"] == 1.0
        assert out[f"cat_thr{thr:.2f}/pod"] == 0.0


def test_suite_state_stays_on_its_device_as_float32(rng):
    suite = TM.RainfallMetricSuite(device="cpu")
    preds, target = rain_pair(rng, (1, 2, 16, 16, 1))
    suite.update(_t(preds).double(), _t(target))
    for part in suite.state:
        for key, val in part.items():
            assert val.device.type == "cpu" and val.dtype == torch.float32, key


def test_loss_metrics_match_jax(rng):
    pred = rng.random((2, 4, 16, 16)).astype(np.float32)
    true = rng.random((2, 4, 16, 16)).astype(np.float32)
    cases = [
        (TM.weighted_l1_metric_update, JM.weighted_l1_metric_update, {}),
        (TM.k1_loss_metric_update, JM.k1_loss_metric_update, {}),
        (TM.k1_loss_metric_update, JM.k1_loss_metric_update,
         {"temp_alpha": 0.0, "k1_alpha": 0.05}),
        (TM.shock_difference_metric_update, JM.shock_difference_metric_update, {}),
        (TM.shock_difference_metric_update, JM.shock_difference_metric_update,
         {"pool": 2, "border_ignore": 1}),
    ]
    for upd_t, upd_j, kw in cases:
        ours, theirs = TM.loss_metric_init(), JM.loss_metric_init()
        for _ in range(2):
            ours = upd_t(ours, _t(pred), _t(true), **kw)
            theirs = upd_j(theirs, _j(pred), _j(true), **kw)
        assert_state_equal(ours, theirs, counts=("n_obs",))
        np.testing.assert_allclose(TM.loss_metric_compute(ours),
                                   JM.loss_metric_compute(theirs), rtol=RTOL)
    assert TM.loss_metric_compute(TM.loss_metric_init()) == 0.0
