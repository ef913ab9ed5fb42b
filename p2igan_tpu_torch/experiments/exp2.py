"""exp2 -- visualization: per-event comparison GIFs and paper-style PDF panels.

The port's counterpart of ``experiments/exp2.py``. The per-event transform,
crop and mask run on an explicit device; every figure is drawn on the host
(numpy -> matplotlib / PIL). matplotlib is imported only inside the
functions that draw (``build_paper_cmap``, ``save_combo_gif``,
``_paper_figure``): without it a drawing stage raises the ImportError that
names it. The paper colormap is the bounded 0-200 mm/h palette with 20-step
gradients between anchor colors; events sort numerically. The PDF
crop/stitch uses PyMuPDF (``fitz``) when available, else crops a PNG render
of the same figure with pure PIL and writes the stitched panels as a PDF.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, Iterable, List, Tuple, Union

import numpy as np
import torch
from PIL import Image

from ..data import zarrlite
from ..parallel.mesh import resolve_device
from .exp1 import transform_mmhr
from .io import (align_length, center_square, crop_center, ensure_dir, ensure_thw,
                 load_mask, save_text, to_device)

# Bounded paper palette: anchors at rain-rate boundaries, 20-step gradients.
PAPER_BOUNDS = [0, 0.5, 1, 2, 4, 8, 16, 200]
PAPER_COLORS = [
    "#000000", "#46327e", "#277f8e", "#4ac16d", "#a0da39", "#fde725", "#ffffff",
]
PAPER_SUB = 20
# NOTE: the gradient below uses t = k/(PAPER_SUB-1), reaching each anchor
# color one sub-interval early, as the JAX suite's does, so figures match
# pixel for pixel.


def _to_uint8(frame: np.ndarray, vmin: float, vmax: float) -> np.ndarray:
    if vmax <= vmin:  # widen a degenerate range BEFORE clipping
        vmax = vmin + 1.0
    frame = np.clip(frame, vmin, vmax)
    return (((frame - vmin) / (vmax - vmin)) * 255.0).astype(np.uint8)


def save_frames(frames: np.ndarray, out_dir: str, vmin: float, vmax: float,
                prefix: str) -> None:
    ensure_dir(out_dir)
    frames = ensure_thw(frames)
    for i in range(frames.shape[0]):
        Image.fromarray(_to_uint8(frames[i], vmin, vmax)).save(
            os.path.join(out_dir, f"{prefix}_{i:03d}.png"))


def save_gif(frames: np.ndarray, out_path: str, vmin: float, vmax: float,
             fps: int) -> None:
    frames = ensure_thw(frames)
    imgs = [Image.fromarray(_to_uint8(frames[i], vmin, vmax))
            for i in range(frames.shape[0])]
    if not imgs:
        return
    imgs[0].save(out_path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / max(fps, 1)), loop=0)


def build_paper_cmap():
    """ListedColormap + BoundaryNorm with smooth per-segment gradients."""
    from matplotlib.colors import BoundaryNorm, ListedColormap

    def hex_to_rgb01(h):
        h = h.lstrip("#")
        return tuple(int(h[i:i + 2], 16) / 255.0 for i in (0, 2, 4))

    # Each anchor in PAPER_BOUNDS must itself be a boundary so color-class
    # transitions land exactly on the labeled colorbar ticks: SUB+1 points
    # per segment INCLUDING both ends, shared anchors deduplicated.
    fine_bounds: List[float] = []
    for i in range(len(PAPER_BOUNDS) - 1):
        seg = np.linspace(PAPER_BOUNDS[i], PAPER_BOUNDS[i + 1], PAPER_SUB + 1)
        fine_bounds.extend(seg.tolist() if i == 0 else seg[1:].tolist())
    fine_bounds = np.asarray(fine_bounds, float)

    rgb = [hex_to_rgb01(h) for h in PAPER_COLORS]
    colors = []
    for i in range(len(rgb) - 1):
        for k in range(PAPER_SUB):
            t = k / float(PAPER_SUB - 1)
            colors.append(tuple((1 - t) * a + t * b for a, b in zip(rgb[i], rgb[i + 1])))
    colors.append(rgb[-1])
    while len(colors) < len(fine_bounds) - 1:
        colors.append(rgb[-1])
    cmap = ListedColormap(colors, name=f"seg{PAPER_SUB}_smooth")
    norm = BoundaryNorm(fine_bounds, cmap.N, clip=True)
    return cmap, norm, fine_bounds


def list_event_keys(path: str) -> List[str]:
    z = zarrlite.open(path, mode="r")
    keys: List[str] = []
    if isinstance(z, zarrlite.Group):
        keys = z.group_keys() or [k for k in z.keys()]
    if not keys:
        return []

    def key_num(k: str) -> Tuple[int, str]:
        m = re.search(r"event[_-]?(\d+)", k, re.IGNORECASE)
        return (int(m.group(1)) if m else 10 ** 9, k)

    return sorted(keys, key=key_num)


def load_event_array(path: str, event_key: str) -> np.ndarray:
    z = zarrlite.open(path, mode="r")
    if isinstance(z, zarrlite.Array):
        # a bare array store has no events; `event_key in z` would iterate
        # frames and raise an ambiguous-truth ValueError
        raise FileNotFoundError(
            f"{path} is a single array store, not an event store "
            f"(missing event {event_key})")
    if event_key in z:
        node = z[event_key]
        if isinstance(node, zarrlite.Array):
            return np.asarray(node)
        inner = node.array_keys()  # events/<ts>/frames group layout
        if inner:
            pick = "frames" if "frames" in inner else inner[0]
            return np.asarray(node[pick])
    raise FileNotFoundError(f"Missing event {event_key} in {path}")


def save_combo_gif(frames_map: Dict[str, np.ndarray], out_path: str, cmap, norm,
                   fps: int, input_mask: np.ndarray | None = None,
                   title: str | None = None) -> None:
    """Side-by-side Input/Gauge-scatter + Truth + methods animation."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.cm import ScalarMappable

    labels = list(frames_map.keys())
    frames_list = [ensure_thw(frames_map[k]) for k in labels]
    n = min(f.shape[0] for f in frames_list) if frames_list else 0
    if n <= 0:
        return
    mask_points = np.argwhere(input_mask.astype(bool)) if input_mask is not None else None

    imgs = []
    for t in range(n):
        fig, axes = plt.subplots(1, len(labels), figsize=(3.1 * len(labels), 3.8),
                                 dpi=150)
        fig.subplots_adjust(top=0.82, bottom=0.22, wspace=0.02)
        if len(labels) == 1:
            axes = [axes]
        for ax, label, frames in zip(axes, labels, frames_list):
            if label.lower() in {"input", "gauge"} and input_mask is not None:
                ax.imshow(np.zeros_like(frames[t]), cmap="gray", vmin=0.0, vmax=1.0)
                if mask_points is not None and mask_points.size > 0:
                    vals = frames[t][input_mask.astype(bool)]
                    ax.scatter(mask_points[:, 1], mask_points[:, 0], c=vals,
                               cmap=cmap, norm=norm, s=18, edgecolors="#dddddd",
                               linewidths=0.4, zorder=5)
            else:
                ax.imshow(frames[t], cmap=cmap, norm=norm)
            ax.set_title(label, fontsize=11)
            ax.set_xticks([])
            ax.set_yticks([])
            for s in ax.spines.values():
                s.set_visible(False)
        sm = ScalarMappable(cmap=cmap, norm=norm)
        sm.set_array([])
        cbar = fig.colorbar(sm, ax=axes, orientation="horizontal", fraction=0.08,
                            pad=0.18, ticks=PAPER_BOUNDS)
        cbar.set_ticklabels([f"{b:g}" for b in PAPER_BOUNDS[:-1]] + [""])
        cbar.set_label("Rainfall (mm/h)", fontsize=10)
        cbar.ax.tick_params(labelsize=8)
        if title:
            fig.suptitle(f"{title} | Frame {t + 1}/{n}", fontsize=12)
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        imgs.append(Image.fromarray(buf.copy()))
        plt.close(fig)

    imgs[0].save(out_path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / max(fps, 1)), loop=0)


def _mmhr_crop(raw, divide_by_3: bool, crop_size: int, dev: torch.device) -> torch.Tensor:
    """Raw frames -> cropped mm/h on ``dev`` (elementwise, so crop first)."""
    return transform_mmhr(crop_center(to_device(raw, dev), crop_size), divide_by_3)


def run_exp2(preds: Dict[str, Union[str, np.ndarray]],
             truth: Union[str, np.ndarray],
             observation: Union[str, np.ndarray],
             mask_train: np.ndarray,
             out_dir: str,
             crop_size: int,
             frames: int | None,
             vmin: float,
             vmax: float,
             gif_fps: int,
             divide_by_3: bool = True,
             mode: str = "radar",
             max_events: int = 20,
             max_frames: int = 30,
             device: str | torch.device = "cuda") -> None:
    """Per-event combo GIFs; the frames are prepared on ``device``."""
    dev = resolve_device(device)
    ensure_dir(out_dir)
    if frames is not None:
        # caller-configured CAP on the GIF length (can only shorten the
        # 30-frame default, never extend it)
        max_frames = min(max_frames, int(frames))
    input_label = "Gauge" if mode == "gauge" else "Input"
    truth_label = "Radar" if mode == "gauge" else "Truth"
    cmap, norm, _ = build_paper_cmap()
    mask_t = to_device(mask_train.astype(bool), dev)

    def one_event(truth_ev, obs_ev, pred_getter, out_name, title):
        truth_ev = _mmhr_crop(truth_ev, divide_by_3, crop_size, dev)[:max_frames]
        obs_ev = _mmhr_crop(obs_ev, divide_by_3, crop_size, dev)[:max_frames]
        masked_input = obs_ev * mask_t[None, ...]
        preds_ev: Dict[str, torch.Tensor] = {}
        for name in preds.keys():
            pred_ev = transform_mmhr(to_device(pred_getter(name), dev), divide_by_3)
            pred_ev, truth_ev = align_length(pred_ev, truth_ev)
            preds_ev[name] = crop_center(pred_ev, crop_size)[:max_frames]
        total = min([truth_ev.shape[0], masked_input.shape[0]]
                    + [p.shape[0] for p in preds_ev.values()])
        combo = {input_label: masked_input[:total], truth_label: truth_ev[:total]}
        combo.update({k: v[:total] for k, v in preds_ev.items()})
        # the title reads "event_01 | total frames 16": the count is only
        # known here, so the caller passes the event label
        save_combo_gif({k: v.cpu().numpy() for k, v in combo.items()},
                       os.path.join(out_dir, out_name), cmap, norm,
                       gif_fps, input_mask=mask_train,
                       title=f"{title} | total frames {total}")
        return total

    if isinstance(truth, str) and isinstance(observation, str):
        event_keys = list_event_keys(truth)
        if not event_keys:
            raise FileNotFoundError(f"No event groups found in {truth}")
        range_lines = []
        for event_key in event_keys[:max_events]:
            truth_ev = load_event_array(truth, event_key)
            obs_ev = load_event_array(observation, event_key)

            def getter(name, _k=event_key):
                src = preds[name]
                return load_event_array(src, _k) if isinstance(src, str) else src

            total = one_event(truth_ev, obs_ev, getter,
                              f"comparison_{event_key}.gif", event_key)
            range_lines.append(f"{event_key}: frames 1-{total} (count={total})")
        save_text(os.path.join(out_dir, "event_ranges.txt"), range_lines)
        return

    one_event(np.asarray(truth), np.asarray(observation),
              lambda name: np.asarray(preds[name]), "comparison_event_01.gif",
              "Event 01")


def event_key_name(event_id: int) -> str:
    return f"event_{int(event_id):02d}"


def _draw_block(ax_grid, images, method_order, mask, mask_points, cmap, norm):
    for t in range(images.shape[1]):
        for m in range(images.shape[0]):
            ax = ax_grid[t, m]
            label = method_order[m]
            if label == "RadarMasked":
                ax.imshow(np.zeros_like(images[m, t]), cmap="gray", vmin=0.0, vmax=1.0)
                vals = images[m, t][mask == 1]
                ax.scatter(mask_points[:, 1], mask_points[:, 0], c=vals, cmap=cmap,
                           norm=norm, s=24, edgecolors="#dddddd", linewidths=0.4,
                           zorder=5)
            else:
                ax.imshow(images[m, t], cmap=cmap, norm=norm)
            ax.set_xticks([])
            ax.set_yticks([])
            for s in ax.spines.values():
                s.set_visible(False)
            if label == "Gauge":
                vals = images[m, t][mask == 1]
                ax.scatter(mask_points[:, 1], mask_points[:, 0], c=vals, cmap=cmap,
                           norm=norm, s=38, edgecolors="black", linewidths=0.7,
                           zorder=5)
            if t == 0:
                ax.set_title(label, fontsize=13)
            if m == 0:
                ax.text(-0.12, 0.5, f"{t * 5} min", transform=ax.transAxes,
                        ha="center", va="center", fontsize=12, rotation=90)


def _paper_figure(method_order, events, mask, mask_points, cmap, norm,
                  load_images, out_dir, output_pdf, fig_width_per_col,
                  png_dpi=None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.cm import ScalarMappable
    from matplotlib.gridspec import GridSpec

    ncols = len(method_order)
    rows_per_event = [len(e["select_idx"]) for e in events]
    total_rows = sum(r + 1 for r in rows_per_event)

    fig = plt.figure(figsize=(fig_width_per_col * ncols, 1.9 * total_rows))
    gs = GridSpec(nrows=total_rows, ncols=ncols, figure=fig, top=0.93,
                  bottom=0.06, wspace=0.04, hspace=0.02)
    sm = ScalarMappable(cmap=cmap, norm=norm)
    sm.set_array([])
    cbar_ax = fig.add_axes([0.20, 0.88, 0.60, 0.02])
    cbar = fig.colorbar(sm, cax=cbar_ax, orientation="horizontal",
                        ticks=PAPER_BOUNDS)
    cbar.set_ticklabels([f"{b:g}" for b in PAPER_BOUNDS[:-1]] + [""])
    cbar.set_label("Rainfall (mm/h)", fontsize=13, labelpad=3)
    cbar.ax.tick_params(labelsize=11)

    row_cursor = 0
    for event in events:
        ax_title = fig.add_subplot(gs[row_cursor, :])
        ax_title.axis("off")
        ax_title.text(-0.015, 0.2, event["title"], fontsize=14, fontweight="bold",
                      ha="left", va="center", transform=ax_title.transAxes)
        row_cursor += 1
        n_rows = len(event["select_idx"])  # per event: counts may differ
        ax_grid = np.empty((n_rows, ncols), dtype=object)
        for r in range(n_rows):
            for c in range(ncols):
                ax_grid[r, c] = fig.add_subplot(gs[row_cursor + r, c])
        imgs, labels = load_images(event)
        _draw_block(ax_grid, imgs, labels, mask, mask_points, cmap, norm)
        row_cursor += n_rows

    fig_path = os.path.join(out_dir, output_pdf)
    plt.tight_layout(rect=[0, 0, 1, 0.7])
    fig.savefig(fig_path, format="pdf", bbox_inches="tight")
    if png_dpi:
        # raster twin of the PDF page for the fitz-free crop/stitch route
        # (same Agg layout, so relative y/x fractions land identically)
        fig.savefig(fig_path + ".png", format="png", dpi=png_dpi,
                    bbox_inches="tight")
    plt.close(fig)
    return fig_path


def run_exp2_paper_zarr(observation_path: str,
                        methods: Dict[str, str],
                        events: Iterable[Dict[str, object]],
                        mask_path: str,
                        crop_size: int,
                        out_dir: str,
                        output_pdf: str,
                        method_order: Iterable[str] | None = None,
                        crop_pdf: bool = False,
                        crop_output: str = "cropped_stitched.pdf",
                        device: str | torch.device = "cuda",
                        **crop_kwargs) -> None:
    """Paper panels from zarr stores; the frames are prepared on ``device``."""
    dev = resolve_device(device)
    ensure_dir(out_dir)
    cmap, norm, _ = build_paper_cmap()
    mask = center_square(load_mask(mask_path), crop_size)
    mask_points = np.argwhere(mask == 1)
    if method_order is None:
        method_order = tuple(["RadarMasked", "Nimrod"] + list(methods.keys()))
    method_order = list(method_order)
    events = list(events)

    def mmhr(path, event_key):
        return _mmhr_crop(load_event_array(path, event_key), True, crop_size,
                          dev).cpu().numpy()

    def load_images(event):
        event_key = event_key_name(int(event["event_id"]))
        select_idx = list(event["select_idx"])
        obs_ev = mmhr(observation_path, event_key)
        images = []
        for method in method_order:
            if method in ("RadarMasked", "Nimrod"):
                source = obs_ev
            else:
                path = methods.get(method)
                source = mmhr(path, event_key) if path else None
            frames = [
                source[idx] if source is not None and idx < source.shape[0]
                else np.zeros((crop_size, crop_size), np.float32)
                for idx in select_idx
            ]
            images.append(frames)
        return np.asarray(images), method_order

    fig_path = _paper_figure(
        method_order, events, mask, mask_points, cmap, norm, load_images,
        out_dir, output_pdf, fig_width_per_col=2.4,
        png_dpi=72 * crop_kwargs.get("zoom", 3.0) if crop_pdf else None)
    if crop_pdf:
        crop_pdf_panels(fig_path, os.path.join(out_dir, crop_output), **crop_kwargs)


def run_exp2_paper(folders: Dict[str, str],
                   method_order: Iterable[str],
                   events: Iterable[Dict[str, object]],
                   mask_path: str,
                   crop_size: int,
                   out_dir: str,
                   output_pdf: str,
                   crop_pdf: bool = False,
                   crop_output: str = "cropped_stitched.pdf",
                   **crop_kwargs) -> None:
    """Paper panels from per-method PNG folders (host only: the frames are
    images read from disk)."""
    ensure_dir(out_dir)
    cmap, norm, _ = build_paper_cmap()
    mask = center_square(load_mask(mask_path), crop_size)
    mask_points = np.argwhere(mask == 1)
    method_order = list(method_order)
    events = list(events)

    def load_images(event):
        event_id = int(event["event_id"])
        select_idx = list(event["select_idx"])
        rain_str = f"rain{event_id}"
        sample_folder = os.path.join(folders.get("Gauge", ""), rain_str)
        if not os.path.isdir(sample_folder):
            raise FileNotFoundError(f"Missing sample folder: {sample_folder}")
        all_pngs = sorted(
            [f for f in os.listdir(sample_folder) if f.lower().endswith(".png")],
            key=lambda x: int(os.path.splitext(x)[0]))
        images = []
        for method in method_order:
            folder = folders.get(method, "")
            frames = []
            for idx in select_idx:
                path = (os.path.join(folder, rain_str, all_pngs[idx])
                        if folder and idx < len(all_pngs) else None)
                if path and os.path.isfile(path):
                    arr = np.array(Image.open(path).convert("F")).astype(np.float32) / 3.0
                    # RAW conversion without transform_mmhr's floor/cap/clip,
                    # as the JAX suite converts PNG frames; the figure's
                    # BoundaryNorm(clip=True) saturates above the top bound
                    arr = 10 ** (arr * 0.0625) * 0.036
                    frames.append(center_square(arr, crop_size))
                else:
                    frames.append(np.zeros((crop_size, crop_size), np.float32))
            images.append(frames)
        return np.asarray(images), method_order

    fig_path = _paper_figure(
        method_order, events, mask, mask_points, cmap, norm, load_images,
        out_dir, output_pdf, fig_width_per_col=2.1,
        png_dpi=72 * crop_kwargs.get("zoom", 3.0) if crop_pdf else None)
    if crop_pdf:
        crop_pdf_panels(fig_path, os.path.join(out_dir, crop_output), **crop_kwargs)


def _stitch_panels(parts: List[Image.Image], output_path: str,
                   gap: int = 8) -> Tuple[int, int]:
    """Stack panel strips vertically with a white gap and save; PIL writes
    the output as PDF/PNG by suffix."""
    w = max(im.width for im in parts)
    h = sum(im.height for im in parts) + gap * (len(parts) - 1)
    canvas = Image.new("RGB", (w, h), (255, 255, 255))
    y = 0
    for im in parts:
        canvas.paste(im, ((w - im.width) // 2, y))
        y += im.height + gap
    canvas.save(output_path)
    return canvas.size


def _clip_ranges(y_ranges) -> List[Tuple[float, float]]:
    out = []
    for (ry0, ry1) in y_ranges:
        ry0, ry1 = max(0.0, min(1.0, ry0)), max(0.0, min(1.0, ry1))
        if ry1 > ry0:
            out.append((ry0, ry1))
    return out


def crop_pdf_panels(pdf_path: str, output_path: str,
                    y_ranges: Tuple[Tuple[float, float], ...] = ((0.019, 0.5), (0.58, 1.0)),
                    zoom: float = 3.0, margin_left: float = 0.0,
                    margin_right: float = 0.0) -> Tuple[int, int] | None:
    """Crop vertical panel strips from the paper-figure page and stitch them.
    Fast route renders the PDF with PyMuPDF; without fitz the PNG twin saved
    by ``_paper_figure`` at dpi=72*zoom is cropped with pure PIL: identical
    relative geometry, same stitched artifact. Returns the stitched (width,
    height) or None when skipped."""
    try:
        import fitz  # PyMuPDF
    except ImportError:
        return _crop_png_panels(pdf_path + ".png", output_path, y_ranges,
                                margin_left, margin_right)

    doc = fitz.open(pdf_path)
    page = doc[0]
    (x0, y0, x1, y1) = page.rect
    parts = []
    mat = fitz.Matrix(zoom, zoom)
    for (ry0, ry1) in _clip_ranges(y_ranges):
        clip = fitz.Rect(x0 + margin_left * (x1 - x0), y0 + ry0 * (y1 - y0),
                         x0 + (1 - margin_right) * (x1 - x0), y0 + ry1 * (y1 - y0))
        pix = page.get_pixmap(matrix=mat, clip=clip, alpha=False)
        parts.append(Image.frombytes("RGB", [pix.width, pix.height], pix.samples))
    doc.close()
    if not parts:
        return None
    return _stitch_panels(parts, output_path)


def _crop_png_panels(png_path: str, output_path: str, y_ranges,
                     margin_left: float,
                     margin_right: float) -> Tuple[int, int] | None:
    """fitz-free crop/stitch over the figure's PNG twin (pure PIL)."""
    if not os.path.isfile(png_path):
        logging.warning("PyMuPDF (fitz) unavailable and no PNG twin at %s; "
                        "skipping PDF crop/stitch (re-run with crop_pdf=True "
                        "so _paper_figure saves one)", png_path)
        return None
    page = Image.open(png_path).convert("RGB")
    W, H = page.size
    parts = []
    for (ry0, ry1) in _clip_ranges(y_ranges):
        box = (round(margin_left * W), round(ry0 * H),
               round((1.0 - margin_right) * W), round(ry1 * H))
        parts.append(page.crop(box))
    if not parts:
        return None
    return _stitch_panels(parts, output_path)
