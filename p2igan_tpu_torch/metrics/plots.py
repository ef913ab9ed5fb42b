"""Online-run visualization: colorized GT | prediction example grids.

Counterpart of ``p2igan_tpu/metrics/plots.py`` (reference
``scripts/train.py:384-466``), used by the trainer's example images
(``training/trainer.py::Trainer._log_examples``). numpy only for the colours:
the viridis table is data (``viridis.py``) and the lookup is matplotlib's
float rule, so the grid is the JAX module's, bit for bit, where matplotlib is
not installed. The caption is drawn with PIL, as in the JAX module.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .viridis import VIRIDIS


def value_range(gt: np.ndarray, pred: np.ndarray, scale: str = "joint",
                vmin: float | None = None,
                vmax: float | None = None) -> Tuple[float, float]:
    """Color-scale policy of the reference's example images: fixed bounds,
    GT-derived, or the joint min/max of both sequences (any other name,
    the trainer's default ``"gt_pred"`` too)."""
    if scale == "fixed" and vmin is not None and vmax is not None:
        return float(vmin), float(vmax)
    if scale == "fixed":
        # one bound configured: the other comes from the data
        lo = float(vmin) if vmin is not None else float(min(gt.min(), pred.min()))
        hi = float(vmax) if vmax is not None else float(max(gt.max(), pred.max()))
        return lo, hi
    if scale == "gt":
        return float(gt.min()), float(gt.max())
    return (float(min(gt.min(), pred.min())),
            float(max(gt.max(), pred.max())))


def viridis_rgb(x: np.ndarray) -> np.ndarray:
    """float array in [0, 1] -> (..., 3) float64 RGB by matplotlib's lookup
    (``Colormap.__call__`` on floats): x * 256 in x's dtype, 256 itself to
    255, below 0 the first colour ("under"), 256 and above the last
    ("over"), NaN black ("bad"), the rest truncated to an index."""
    n = VIRIDIS.shape[0]
    xa = np.array(x, copy=True)
    xa *= n
    xa[xa == n] = n - 1
    under = xa < 0
    over = xa >= n
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under] = 0
    idx[over] = n - 1
    idx[bad] = 0
    rgb = VIRIDIS.take(idx, axis=0, mode="clip")
    rgb[bad] = 0.0
    return rgb


def colorize_grid(gt: np.ndarray, pred: np.ndarray, vmin: float,
                  vmax: float, cmap_name: str = "viridis") -> np.ndarray:
    """(T, H, W) GT/pred -> stacked RGB uint8 grid: one row per sequence,
    frames concatenated along width (train.py:384-430)."""
    if cmap_name != "viridis":
        raise ValueError(f"only the viridis colour map is carried, not {cmap_name!r}")
    norm = lambda x: (x - vmin) / (vmax - vmin + 1e-6)  # noqa: E731
    rows = [np.concatenate([viridis_rgb(norm(fr)) for fr in seq], axis=1)
            for seq in (gt, pred)]
    return (np.concatenate(rows, axis=0) * 255).astype(np.uint8)


def caption(gt: np.ndarray, pred: np.ndarray, cmap_name: str = "viridis") -> str:
    """The reference's min/mean/max caption (train.py:440-459)."""
    return (f"GT min/mean/max: {gt.min():.3f}/{gt.mean():.3f}/{gt.max():.3f} | "
            f"Pred min/mean/max: {pred.min():.3f}/{pred.mean():.3f}/{pred.max():.3f} | "
            f"cmap={cmap_name}")


def annotate_stats(img: np.ndarray, gt: np.ndarray, pred: np.ndarray,
                   cmap_name: str = "viridis"):
    """PIL image with the reference's min/mean/max caption at (5, 5), in
    white, in PIL's default font (train.py:440-459)."""
    from PIL import Image, ImageDraw

    pil = Image.fromarray(img)
    ImageDraw.Draw(pil).text((5, 5), caption(gt, pred, cmap_name), fill=(255, 255, 255))
    return pil


def example_image(gt: np.ndarray, pred: np.ndarray, scale: str = "joint",
                  vmin: float | None = None, vmax: float | None = None):
    """Full example-artifact pipeline: color scale -> grid -> caption."""
    lo, hi = value_range(gt, pred, scale=scale, vmin=vmin, vmax=vmax)
    return annotate_stats(colorize_grid(gt, pred, lo, hi), gt, pred)
