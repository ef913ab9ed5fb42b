"""The port's example images (``p2igan_tpu_torch/metrics/plots.py`` and its
viridis table) against matplotlib and the JAX package's ``plots`` on the CPU:
the table bit for bit, the colour grid bit for bit (NaN, values below and
above the range, exactly the top of the range), the colour-scale policy in
all its cases, and the PNG the trainer writes."""

import matplotlib
import numpy as np
import pytest

from p2igan_tpu.metrics import plots as JP
from p2igan_tpu_torch.metrics import plots as TP
from p2igan_tpu_torch.metrics.viridis import VIRIDIS


def test_viridis_table_is_matplotlibs_bitwise():
    cmap = matplotlib.colormaps["viridis"]
    want = cmap(np.arange(cmap.N))[:, :3]
    assert VIRIDIS.shape == (256, 3) and VIRIDIS.dtype == np.float64
    assert VIRIDIS.tobytes() == want.tobytes()


def test_matplotlib_out_of_range_colours_are_what_the_lookup_assumes():
    """Under: the first row; over: the last; bad: black."""
    cmap = matplotlib.colormaps["viridis"]
    np.testing.assert_array_equal(cmap.get_under()[:3], VIRIDIS[0])
    np.testing.assert_array_equal(cmap.get_over()[:3], VIRIDIS[-1])
    np.testing.assert_array_equal(cmap.get_bad()[:3], 0.0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_viridis_lookup_is_matplotlibs_bitwise(dtype):
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.uniform(-0.2, 1.2, 500),
                        [np.nan, -np.inf, np.inf, -0.0, 0.0, 1.0, 1.0 - 1e-9,
                         255.5 / 256, 1 / 256, 256.0, -1e-30, 2.0 ** 70]]).astype(dtype)
    want = matplotlib.colormaps["viridis"](x)[..., :3]
    assert TP.viridis_rgb(x).tobytes() == want.tobytes()


def _sequences(dtype):
    rng = np.random.default_rng(5)
    gt = rng.random((3, 8, 8)).astype(dtype)
    pred = rng.random((3, 8, 8)).astype(dtype)
    gt[0, 0, :4] = [np.nan, -0.5, 1.5, 1.0]  # NaN, below, above, the top
    pred[1, 2, :3] = [0.0, 1.0, np.nan]
    pred[2, 3, 3] = 1.0 + 1e-6  # normalizes to 1 exactly: index 256 -> 255
    return gt, pred


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.0, 1.0 - 1e-6), (0.25, 0.75), (0.3, 0.3)])
def test_colorize_grid_is_jaxs_bitwise(dtype, lo, hi):
    gt, pred = _sequences(dtype)
    ours = TP.colorize_grid(gt, pred, lo, hi)
    assert ours.shape == (16, 24, 3) and ours.dtype == np.uint8
    assert ours.tobytes() == JP.colorize_grid(gt, pred, lo, hi).tobytes()


def test_the_grid_meets_each_edge_case():
    """The inputs above reach every branch of the lookup: index 256 exactly
    (to 255), under, over and NaN (black)."""
    gt, pred = _sequences(np.float32)
    x = (pred - 0.0) / (1.0 - 1e-6 + 1e-6)
    assert (x * 256 == 256).any()
    grid = TP.colorize_grid(gt, pred, 0.0, 1.0 - 1e-6)
    assert (grid[0, 0] == 0).all()  # NaN
    np.testing.assert_array_equal(grid[0, 1], (VIRIDIS[0] * 255).astype(np.uint8))
    np.testing.assert_array_equal(grid[0, 2], (VIRIDIS[-1] * 255).astype(np.uint8))


def test_colorize_grid_takes_only_viridis():
    gt, pred = _sequences(np.float32)
    with pytest.raises(ValueError, match="viridis"):
        TP.colorize_grid(gt, pred, 0.0, 1.0, cmap_name="magma")


@pytest.mark.parametrize("scale,vmin,vmax", [
    ("fixed", 0.0, 2.0), ("fixed", 0.0, None), ("fixed", None, 1.0), ("fixed", None, None),
    ("gt", None, None), ("joint", None, None), ("gt_pred", 0.0, 1.0)])
def test_value_range_is_jaxs(scale, vmin, vmax):
    gt = np.asarray([[0.1, 0.4]])
    pred = np.asarray([[0.2, 0.9]])
    ours = TP.value_range(gt, pred, scale=scale, vmin=vmin, vmax=vmax)
    assert ours == JP.value_range(gt, pred, scale=scale, vmin=vmin, vmax=vmax)
    want = {("fixed", 0.0, 2.0): (0.0, 2.0), ("fixed", 0.0, None): (0.0, 0.9),
            ("fixed", None, 1.0): (0.1, 1.0), ("gt", None, None): (0.1, 0.4)}
    assert ours == want.get((scale, vmin, vmax), (0.1, 0.9))


def test_example_image_is_jaxs_and_its_png_decodes_to_the_grid(tmp_path):
    from PIL import Image, ImageDraw

    rng = np.random.default_rng(0)
    gt = rng.random((4, 32, 32)).astype(np.float32)
    pred = np.clip(gt + 0.1 * rng.normal(size=gt.shape), 0, 1).astype(np.float32)
    ours = TP.example_image(gt, pred, scale="gt_pred")
    assert ours.size == (4 * 32, 2 * 32) and ours.mode == "RGB"
    assert np.asarray(ours).tobytes() == np.asarray(JP.example_image(gt, pred)).tobytes()
    path = tmp_path / "ex.png"
    ours.save(path)
    with Image.open(path) as img:
        assert img.format == "PNG"
        decoded = np.asarray(img.convert("RGB"))
    grid = TP.colorize_grid(gt, pred, *TP.value_range(gt, pred))
    x0, y0, x1, y1 = ImageDraw.Draw(Image.new("RGB", ours.size)).textbbox(
        (5, 5), TP.caption(gt, pred))
    outside = np.ones(grid.shape[:2], bool)
    outside[y0:y1 + 1, x0:x1 + 1] = False
    assert outside.sum() > grid.shape[0] * grid.shape[1] // 2
    np.testing.assert_array_equal(decoded[outside], grid[outside])
    assert (decoded[~outside] != grid[~outside]).any()  # the caption is drawn
