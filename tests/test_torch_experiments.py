"""The port's offline evaluation suite (``p2igan_tpu_torch/experiments``,
``device="cpu"``) against the JAX package's ``experiments/`` on the same
seeded numpy inputs.

Tolerances: contingency counts (so POD/FAR/CSI/HSS) and PSS exact; MAE,
RMSE and NSE (exp1's and exp3's, per event and per frame) at rtol 1e-12;
SSIM and DTSSIM at rtol 1e-5, atol 1e-7 (their 8x8 pooling is bitwise
numpy's, their float64 means reduce in another order); NaN equals NaN.
The whole ``main`` with all four stages runs on both packages at the JAX
suite test's size (2 events, 64x64) with T=4 frames an event for its 8: the
GIF stage draws a matplotlib figure a frame in each package, most of the
test's time."""

import importlib.util
import json
import logging
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from experiments import exp1 as jexp1
from experiments import exp3 as jexp3
from experiments import io as jio
from experiments import test as jtest
from p2igan_tpu_torch.data import fake, zarrlite
from p2igan_tpu_torch.experiments import exp1, exp3
from p2igan_tpu_torch.experiments import io as pio
from p2igan_tpu_torch.experiments import test as ptest
from p2igan_tpu_torch.experiments.compare import suite_mismatches

REPO = Path(__file__).resolve().parents[1]


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture
def one_torch_thread():
    """The end-to-end runs on one intra-op thread: the test run has a worker
    a core, and more threads oversubscribe them (the results do not depend
    on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def same(a, b):
    return a == b or (math.isnan(a) and math.isnan(b))


def close(a, b, rtol, atol=0.0):
    return same(a, b) or abs(a - b) <= atol + rtol * abs(b)


def assert_reports_match(got, want):
    """The suite's tolerances (``experiments/compare.py``, which the card's
    checks use too)."""
    assert not suite_mismatches(got, want)


# -- PSS: numpy's histogram binning, exactly ---------------------------------

def _pss_case(name):
    rng = np.random.default_rng(5)
    edges = np.linspace(1.0, 6.0, 51, dtype=np.float32)
    kw = {}
    if name == "random":
        p, g = (rng.random((6, 300)) * 20).astype(np.float32), \
            (rng.random((6, 300)) * 15).astype(np.float32)
    elif name == "on_edges_and_hi":
        # every edge (hi included) in both arrays; the range is [1, 6]
        p = np.tile(edges, (3, 2)).astype(np.float32)
        g = np.tile(edges[::-1], (3, 1)).astype(np.float32)
        p[0, :5] = 0.2  # under min_value
    elif name in ("lo_eq_hi", "lo_eq_hi_large"):
        v = np.float32(3.7 if name == "lo_eq_hi" else 40.0)  # hi + 1e-6 rounds up / down
        p = np.full((4, 20), v, np.float32)
        g = np.full((4, 20), v, np.float32)
        p[1] = 0.1
    elif name == "all_below_min":
        p = (rng.random((3, 50)) * 0.5).astype(np.float32)
        g = (rng.random((3, 50)) * 0.4).astype(np.float32)
    elif name == "nonfinite_and_empty_frames":
        p = (rng.random((5, 80)) * 30).astype(np.float32)
        g = (rng.random((5, 80)) * 30).astype(np.float32)
        p[0, ::3], g[1, ::4], p[2, 1] = np.nan, np.inf, -np.inf
        g[3] = 0.3  # no value above min_value: frame skipped
    elif name == "floor_rounds_in_float32":
        p = np.full((2, 30), np.float32(0.1))
        g = (rng.random((2, 30)) * 3).astype(np.float32)
        kw = {"min_value": 0.1}
    elif name == "value_range_given":
        p, g = (rng.random((4, 64)) * 12).astype(np.float32), \
            (rng.random((4, 64)) * 12).astype(np.float32)
        kw = {"value_range": (2.0, 9.5), "bins": 17}
    elif name == "more_pred_frames":
        p, g = (rng.random((7, 40)) * 9).astype(np.float32), \
            (rng.random((4, 40)) * 9).astype(np.float32)
        p[6] = 50.0  # beyond zip's frames: still sets the shared range
    return p, g, kw


PSS_CASES = ["random", "on_edges_and_hi", "lo_eq_hi", "lo_eq_hi_large", "all_below_min",
             "nonfinite_and_empty_frames", "floor_rounds_in_float32", "value_range_given",
             "more_pred_frames"]


@pytest.mark.parametrize("name", PSS_CASES)
def test_pss_is_numpys_exactly(name):
    p, g, kw = _pss_case(name)
    want = jexp1.pss(p, g, **kw)
    got = exp1.pss(t(p), t(g), **kw)
    assert same(got, want), (got, want)
    if name == "all_below_min":
        assert math.isnan(got)


def test_pss_on_float64_frames_of_pixels():
    """run_exp1's input: (T, n_sel) float64 cast to float32 first."""
    rng = np.random.default_rng(6)
    p, g = rng.random((9, 123)) * 25, rng.random((9, 123)) * 25
    assert same(exp1.pss(t(p), t(g)), jexp1.pss(p, g))


# -- SSIM, DTSSIM ------------------------------------------------------------

def _stacks(seed=7, shape=(2, 6, 40, 33)):
    rng = np.random.default_rng(seed)
    a = rng.random(shape) * 30
    return a, a + rng.normal(0, 3, shape)


@pytest.mark.parametrize("pool", [True, False])
def test_ssim_stack_and_spatial(pool):
    a, b = _stacks()
    want = jexp1._ssim_stack(jexp1._as_stack(a), jexp1._as_stack(b))
    got = exp1._ssim_stack(exp1._as_stack(t(a)), exp1._as_stack(t(b))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert close(exp1.ssim_spatial(t(a), t(b), use_pool8=pool),
                 jexp1.ssim_spatial(a, b, use_pool8=pool), 1e-5, 1e-7)
    assert close(exp1.ssim2d(t(a[0, 0]), t(b[0, 0])), jexp1.ssim2d(a[0, 0], b[0, 0]),
                 1e-5, 1e-7)


@pytest.mark.parametrize("shape", [(1, 5, 64, 64), (2, 3, 15, 9), (1, 2, 8, 8)])
def test_block_mean8_is_numpys_bitwise(shape):
    x = (np.random.default_rng(8).random(shape) * 200).astype(np.float32)
    assert np.array_equal(exp1._block_mean8(t(x)).numpy(), jexp1._block_mean8(x))


@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("lag", [1, 2])
def test_delta_tssim(lag, pool):
    a, b = _stacks(9)
    assert close(exp1.delta_tssim(t(a), t(b), lag=lag, use_pool8=pool),
                 jexp1.delta_tssim(a, b, lag=lag, use_pool8=pool), 1e-5, 1e-7)
    assert math.isnan(exp1.delta_tssim(t(a[:, :lag]), t(b[:, :lag]), lag=lag))


# -- contingency, transform, scalar scores -----------------------------------

def _mmhr_pair(seed=10, shape=(6, 500)):
    rng = np.random.default_rng(seed)
    raw = (rng.random(shape) * 200).astype(np.float32)
    raw[0, :7] = [np.nan, np.inf, -np.inf, -3.0, 0.0, 255.0, 1e4]
    pred = raw + rng.normal(0, 12, shape).astype(np.float32)
    return raw, pred


@pytest.mark.parametrize("threshold", [0.5, 2.0, 4.0, 8.0])
def test_contingency_counts_exact(threshold):
    raw, pred = _mmhr_pair()
    gt_j, pr_j = jexp1.transform_mmhr(raw), jexp1.transform_mmhr(pred)
    gt_p, pr_p = exp1.transform_mmhr(t(raw)), exp1.transform_mmhr(t(pred))
    want = jexp1.Contingency.at_threshold(pr_j, gt_j, threshold)
    got = exp1.Contingency.at_threshold(pr_p, gt_p, threshold)
    assert got == exp1.Contingency(want.hits, want.misses, want.false_alarms,
                                   want.correct_negatives)
    assert min(want.hits, want.misses, want.false_alarms, want.correct_negatives) > 0
    assert exp1.categorical_metrics(pr_p, gt_p, threshold) == \
        jexp1.categorical_metrics(pr_j, gt_j, threshold)
    empty = exp1.Contingency(0.0, 0.0, 0.0, 0.0)
    assert math.isnan(empty.hss) and empty.pod == 0.0


@pytest.mark.parametrize("divide_by_3", [True, False])
def test_transform_and_scalar_scores(divide_by_3):
    raw, pred = _mmhr_pair(11)
    want = jexp1.transform_mmhr(raw, divide_by_3)
    got = exp1.transform_mmhr(t(raw), divide_by_3).numpy()
    # float64 pow is not correctly rounded: an ulp apart at most
    np.testing.assert_allclose(got, want, rtol=4e-16, atol=0)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    g = jexp1.transform_mmhr(raw[1:])
    p = jexp1.transform_mmhr(pred[1:])
    for fn in ("mae", "rmse", "nse"):
        assert close(getattr(exp1, fn)(t(p), t(g)), getattr(jexp1, fn)(p, g), 1e-12), fn


# -- run_exp1: pairing, both modes, pooling on and off -----------------------

H = W = 40
CROP = 32


def _events(seed=12, n=3, frames=10):
    rng = np.random.default_rng(seed)
    truth = {f"event_{i + 1:02d}": (rng.random((frames, H, W)) * 160).astype(np.float32)
             for i in range(n)}
    preds = {"FULL": {k: (v + rng.normal(0, 9, v.shape)).astype(np.float32)[..., None]
                      for k, v in truth.items()}}
    if n >= 3:
        # no event_02, a short event_01, a store-only event ignored
        preds["GAPS"] = {"event_01": truth["event_01"][:6] * np.float32(1.1),
                         "event_03": truth["event_03"] + np.float32(4.0),
                         "event_09": truth["event_03"]}
        preds["FLAT"] = np.concatenate(list(truth.values()))[:24] * np.float32(0.9)
    mask = np.zeros((CROP, CROP), bool)
    mask.reshape(-1)[rng.choice(CROP * CROP, 79, replace=False)] = True
    return truth, preds, mask


@pytest.mark.parametrize("pool8", [True, False])
@pytest.mark.parametrize("mode", ["radar", "gauge"])
def test_run_exp1_events_match(mode, pool8, caplog):
    truth, preds, mask = _events()
    with caplog.at_level(logging.WARNING):
        got = exp1.run_exp1(preds, truth, mask, mode, CROP, use_pool8=pool8, device="cpu")
    assert "method 'GAPS' has no event 'event_02'" in caplog.text
    want = jexp1.run_exp1(preds, truth, mask, mode, CROP, use_pool8=pool8)
    assert_reports_match(got, want)
    assert got["FULL"]["CAT_0.5"]["CSI"] > 0.3 and got["FULL"]["CAT_8"]["POD"] > 0


def test_run_exp1_flat_arrays_match():
    truth, preds, mask = _events(13)
    flat_truth = np.concatenate(list(truth.values()))
    flat_preds = {"FLAT": preds["FLAT"], "ONE": preds["FULL"]["event_02"][:, :, :, 0]}
    got = exp1.run_exp1(flat_preds, flat_truth, mask, "radar", CROP, device="cpu")
    assert_reports_match(got, jexp1.run_exp1(flat_preds, flat_truth, mask, "radar",
                                                  CROP))
    assert exp1.run_exp1(preds, {"event_01": None}, mask, "radar", CROP, device="cpu") == {}


def test_a_cuda_request_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    truth, preds, mask = _events(14, n=1, frames=3)
    for call in (lambda: exp1.run_exp1(preds, truth, mask, "radar", CROP),
                 lambda: exp3.exp3_metrics(preds, truth, mask, "radar", CROP),
                 lambda: ptest.sample_values(truth["event_01"])):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            call()


# -- io: the masked-pixel helpers ----------------------------------------------

@pytest.mark.parametrize("kind", ["numpy", "tensor", "tensor_mask", "channel_last"])
def test_mask_helpers_match(kind):
    rng = np.random.default_rng(14)
    arr = (rng.random((3, 12, 10)) * 50).astype(np.float32)
    mask = rng.random((12, 10)) < 0.3
    x = arr[..., None] if kind == "channel_last" else arr
    x = x if kind == "numpy" else t(x)
    m = torch.from_numpy(mask) if kind == "tensor_mask" else mask.astype(np.float32)
    before = np.array(x)
    got = pio.mask_for_input(x, m)
    assert type(got) is type(x)
    np.testing.assert_array_equal(np.asarray(got), jio.mask_for_input(arr, mask))
    np.testing.assert_array_equal(np.asarray(x), before)  # a copy
    for invert in (False, True):
        np.testing.assert_array_equal(np.asarray(pio.select_by_mask(x, m, invert)),
                                      jio.select_by_mask(arr, mask, invert))
    with pytest.raises(ValueError, match="Mask shape"):
        pio.mask_for_input(x, mask[:-1])


# -- exp3 ----------------------------------------------------------------------

def _jax_exp3_metrics(preds, truth, mask, mode):
    """What experiments/exp3.py:run_exp3 returns, without its figures."""
    if isinstance(truth, dict):
        paired, scores = jexp3._per_event_pass(preds, truth, mask, mode, CROP)
    else:
        truth_t = jexp1.crop_center(jexp1.transform_mmhr(truth), CROP)
        paired, scores = {}, {}
        for name, p in preds.items():
            pr, tr = jexp1.align_length(jexp1.transform_mmhr(p), truth_t)
            paired[name] = (jexp1.crop_center(pr, CROP), tr)
    return {f"NSE_{n}": jexp3.nse(*jexp3._select_values(p, g, mask, mode))
            for n, (p, g) in paired.items()}, scores


def _with_nonfinite(preds):
    out = {k: (dict(v) if isinstance(v, dict) else v.copy()) for k, v in preds.items()}
    ev = out["FULL"]["event_02"].copy()
    ev[0] = np.nan          # a frame with no finite pixel: NaN, dropped
    ev[1, 3:9, 4:30] = np.inf
    ev[2, ::2, ::3] = np.nan
    out["FULL"]["event_02"] = ev
    return out


@pytest.mark.parametrize("mode", ["radar", "gauge"])
def test_exp3_metrics_and_per_event_scores_match(mode):
    truth, preds, mask = _events(15)
    preds = _with_nonfinite(preds)
    want, want_scores = _jax_exp3_metrics(preds, truth, mask, mode)
    got = exp3.exp3_metrics(preds, truth, mask, mode, CROP, device="cpu")
    assert_reports_match(got, want)
    _, _, scores = exp3._exp3_pass(preds, truth, mask, mode, CROP, torch.device("cpu"))
    assert scores.keys() == want_scores.keys()
    for name in want_scores:
        assert len(scores[name]) == len(want_scores[name])
        for a, b in zip(scores[name], want_scores[name]):
            assert close(a, b, 1e-12), name


def test_exp3_flat_truth_matches():
    truth, preds, mask = _events(16)
    flat_truth = np.concatenate(list(truth.values()))
    flat_preds = {"FLAT": preds["FLAT"]}
    want, _ = _jax_exp3_metrics(flat_preds, flat_truth, mask, "gauge")
    got = exp3.exp3_metrics(flat_preds, flat_truth, mask, "gauge", CROP, device="cpu")
    assert got.keys() == want.keys() and close(got["NSE_FLAT"], want["NSE_FLAT"], 1e-12)


@pytest.mark.parametrize("mode", ["radar", "gauge"])
def test_nse_per_frame_with_nonfinite_pixels(mode):
    truth, preds, mask = _events(17, n=1)
    pred = _with_nonfinite({"FULL": {"event_02": preds["FULL"]["event_01"]}})
    p = jexp1.crop_center(pred["FULL"]["event_02"], CROP)
    g = jexp1.crop_center(truth["event_01"], CROP)[:-1]
    want = jexp3.nse_per_frame(p, g, mask, mode)
    got = exp3.nse_per_frame(t(p), t(g), mask, mode).numpy()
    assert np.isnan(want[0]) and len(want) == len(g)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert close(exp3._event_nse_score(t(p), t(g), mask, mode),
                 jexp3._event_nse_score(p, g, mask, mode), 1e-12)
    assert close(exp3.nse(t(p[:-1]), t(g)), jexp3.nse(p[:-1], g), 1e-12)


def test_run_exp3_without_matplotlib_names_it(monkeypatch, tmp_path):
    truth, preds, mask = _events(18, n=1, frames=4)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        exp3.run_exp3(preds, truth, mask, "radar", CROP, str(tmp_path), device="cpu")


# -- the inspection report -----------------------------------------------------

@pytest.mark.parametrize("n", [500, 10_000])
def test_inspection_sample_and_statistics(n, capsys):
    rng = np.random.default_rng(19)
    arr = (rng.random((6, 30, 30)) * 90).astype(np.float32)
    arr[0, :4] = np.nan
    want = jtest.sample_values(arr, n=n, seed=3)
    got = ptest.sample_values(arr, n=n, seed=3, device="cpu")
    assert np.array_equal(got.numpy(), want)
    stats = ptest.describe("obs", got)
    assert stats["n"] == want.size
    assert (stats["min"], stats["max"]) == (float(want.min()), float(want.max()))
    assert close(stats["mean"], float(want.mean()), 1e-5)
    assert close(stats["std"], float(want.std()), 1e-5)
    assert capsys.readouterr().out.startswith(f"[obs] n={want.size} min=")


# -- the whole suite through main, on both packages ----------------------------

def _suite_tree(tmp_path: Path) -> dict:
    """The JAX suite test's tree (2 events, 64x64, two noisy methods) at
    T=4: every stage still runs, DTSSIM at both lags included."""
    root = tmp_path / "data"
    hw = 64
    fake.write_test_zarr(root / "nimrod_test.zarr", n_events=2, T=4, H=hw, W=hw)
    fake.write_gauge_mask(root / "masks" / "gauge_mask_128_train.txt", H=hw, W=hw,
                          n_gauges=30)
    fake.write_gauge_mask(root / "masks" / "gauge_mask_128_test.txt", H=hw, W=hw,
                          n_gauges=30, seed=9)
    rng = np.random.default_rng(0)
    store = zarrlite.open(root / "nimrod_test.zarr", mode="r")
    for method in ("p2igan", "dk"):
        g = zarrlite.open_group(root / "infer" / f"{method}_nimrod.zarr", mode="w")
        for k in store.array_keys():
            v = store[k][:]
            noisy = v + rng.normal(0, 12.0, v.shape).astype(np.float32)
            g.create_dataset(k, shape=noisy.shape, dtype="float32", data=noisy)
    return {
        "experiment_name": "suite", "mode": "radar",
        "run_exp1": True, "run_exp2_gif": True, "run_exp2_pdf": True, "run_exp3": True,
        "crop_size": hw,
        "exp2_paper_events": [{"event_id": 1, "select_idx": [0, 1], "title": "Event 1"},
                              {"event_id": 2, "select_idx": [0, 1], "title": "Event 2"}],
        "data": {"radar": {
            "observation_path": str(root / "nimrod_test.zarr"),
            "truth_path": str(root / "nimrod_test.zarr"),
            "methods": {"P2IGAN": str(root / "infer" / "p2igan_nimrod.zarr"),
                        "DK": str(root / "infer" / "dk_nimrod.zarr")},
            "mask_train_path": str(root / "masks" / "gauge_mask_128_train.txt"),
            "mask_test_path": str(root / "masks" / "gauge_mask_128_test.txt")}},
    }


def _gif_frames(path: Path) -> list:
    from PIL import Image, ImageSequence

    with Image.open(path) as im:
        return [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]


def test_main_all_four_stages_match_the_jax_suite(tmp_path, one_torch_thread):
    from experiments.main import main as jax_main
    from p2igan_tpu_torch.experiments.main import main as port_main

    econf = _suite_tree(tmp_path)
    outs = {}
    for name, run in (("jax", lambda p: jax_main(config_path=p)),
                      ("port", lambda p: port_main(config_path=p, device="cpu"))):
        cfg_path = tmp_path / f"{name}.json"
        cfg_path.write_text(json.dumps({**econf, "save_dir": str(tmp_path / name)}))
        run(str(cfg_path))
        outs[name] = tmp_path / name / "suite"
    files = {name: sorted(p.relative_to(out).as_posix() for p in out.rglob("*")
                          if p.is_file()) for name, out in outs.items()}
    assert files["port"] == files["jax"]
    assert {"exp1/metrics.json", "exp1/metrics.txt", "exp2_gif/comparison_event_01.gif",
            "exp2_gif/event_ranges.txt", "exp2_pdf/two_events_stacked_titles.pdf",
            "exp3/metrics.json", "exp3/nse_boxplot.pdf", "exp3/scatter_panels.pdf",
            "exp3/residual_panels.pdf", "exp3/logfreq.pdf"} <= set(files["port"])
    read = lambda name, rel: json.loads((outs[name] / rel).read_text())  # noqa: E731
    assert_reports_match(read("port", "exp1/metrics.json"),
                              read("jax", "exp1/metrics.json"))
    assert_reports_match(read("port", "exp3/metrics.json"), read("jax", "exp3/metrics.json"))
    for rel in ("exp2_gif/event_ranges.txt",):
        assert (outs["port"] / rel).read_text() == (outs["jax"] / rel).read_text()
    for gif in ("exp2_gif/comparison_event_01.gif", "exp2_gif/comparison_event_02.gif"):
        port_frames, jax_frames = _gif_frames(outs["port"] / gif), _gif_frames(outs["jax"] / gif)
        assert len(port_frames) == len(jax_frames) == 4
        assert all(np.array_equal(a, b) for a, b in zip(port_frames, jax_frames))


# -- scripts/quality_torch.py ----------------------------------------------------

def test_quality_torch_on_the_cpu(tmp_path, monkeypatch, one_torch_thread):
    monkeypatch.setenv("P2IGAN_FORCE_FILE_TRACKER", "1")
    spec = importlib.util.spec_from_file_location("quality_torch",
                                                  REPO / "scripts" / "quality_torch.py")
    quality = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quality)
    summary = tmp_path / "quality.json"
    quality.main(["--device", "cpu", "--size", "16", "--frames", "4", "--steps", "2",
                  "--log-step", "1", "--train-events", "2", "--train-event-frames", "8", "--batch", "2",
                  "--test-events", "2", "--test-frames", "8",
                  "--workdir", str(tmp_path / "work"), "--summary", str(summary)])
    got = json.loads(summary.read_text())
    for mode in ("gauge", "radar"):
        res = tmp_path / "work" / "results" / f"quality_{mode}"
        assert (res / "exp1" / "metrics.json").exists()
        assert (res / "exp3" / "metrics.json").exists()
        assert set(got["modes"][mode]["exp1"]) == {"P2IGAN", "P2IGAN-untrained", "DK"}
