"""A store's first frames as a GIF (the flags of ``scripts/visualize.py``).

    python scripts/visualize_torch.py --zarr out.zarr [--output preview.gif]
        [--num-frames 24] [--fps 4] [--event event_01]

Each frame is drawn in viridis on its own [min, max] with a colour bar, and
captioned with its index and its min, max and mean, as the JAX script does.
It draws with PIL and the port's own viridis table (``metrics/viridis.py``,
matplotlib's lookup rule: ``metrics/plots.py`` ``viridis_rgb``), so it runs
where neither matplotlib nor imageio is installed.
"""

from __future__ import annotations

# Allow running as `python scripts/<name>.py` without installing the package.
import sys as _sys
from pathlib import Path as _Path

_repo = str(_Path(__file__).resolve().parents[1])
if _repo not in _sys.path:
    _sys.path.insert(0, _repo)

import argparse
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw, ImageFont

from p2igan_tpu_torch.data import zarrlite
from p2igan_tpu_torch.metrics.plots import viridis_rgb

PANEL = 320  # pixels of the field's longer side
BAR = 16  # width of the colour bar
CAPTION = 36  # height of the caption band


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Preview an inference zarr as a GIF")
    p.add_argument("--zarr", type=Path, required=True)
    p.add_argument("--output", type=Path, default=Path("preview.gif"))
    p.add_argument("--num-frames", type=int, default=24)
    p.add_argument("--fps", type=int, default=4)
    p.add_argument("--event", type=str, default=None,
                   help="Event key (default: first array in the store)")
    return p


def frame_stats(frame: np.ndarray) -> tuple:
    return float(frame.min()), float(frame.max()), float(frame.mean())


def caption(t: int, frame: np.ndarray) -> str:
    vmin, vmax, vmean = frame_stats(frame)
    return f"t={t}\nmin={vmin:.3f} max={vmax:.3f} mean={vmean:.3f}"


def colorize(frame: np.ndarray, vmin: float, vmax: float) -> np.ndarray:
    """(H, W) -> (H, W, 3) uint8 viridis, normalized as matplotlib's
    ``Normalize(vmin, vmax)`` does (in the frame's float dtype; 0 where
    vmin == vmax)."""
    x = np.array(frame, dtype=np.result_type(frame.dtype, np.float32), copy=True)
    if vmax > vmin:
        x -= vmin
        x /= (vmax - vmin)
    else:
        x[...] = 0
    return (viridis_rgb(x) * 255).astype(np.uint8)


def render(t: int, frame: np.ndarray) -> Image.Image:
    """One GIF frame: caption band, the coloured field, a colour bar."""
    vmin, vmax, _ = frame_stats(frame)
    field = Image.fromarray(colorize(frame, vmin, vmax))
    h, w = frame.shape
    scale = max(1, PANEL // max(h, w))
    field = field.resize((w * scale, h * scale), Image.NEAREST)
    bar_vals = np.linspace(1.0, 0.0, field.height, dtype=np.float32)[:, None]
    bar = Image.fromarray((viridis_rgb(np.repeat(bar_vals, BAR, axis=1)) * 255)
                          .astype(np.uint8))
    font = ImageFont.load_default()
    label_w = 72
    img = Image.new("RGB", (field.width + BAR + label_w + 12, field.height + CAPTION + 8),
                    "white")
    img.paste(field, (4, CAPTION))
    img.paste(bar, (field.width + 8, CAPTION))
    draw = ImageDraw.Draw(img)
    draw.multiline_text((4, 2), caption(t, frame), fill="black", font=font)
    draw.text((field.width + BAR + 10, CAPTION), f"{vmax:.3g}", fill="black", font=font)
    draw.text((field.width + BAR + 10, CAPTION + field.height - 12), f"{vmin:.3g}",
              fill="black", font=font)
    return img


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    args = build_parser().parse_args(argv)
    z = zarrlite.open(args.zarr, mode="r")
    keys = sorted(z.array_keys()) if hasattr(z, "array_keys") else []
    if args.event is None and not keys:
        raise SystemExit(
            f"{args.zarr} has no root-level event arrays (train stores nest "
            "frames under events/<ts>); point --zarr at an inference-output "
            "or test store, or pass --event <group/path>")
    data = z[args.event or keys[0]][:args.num_frames]
    frames, captions = [], []
    for t in range(data.shape[0]):
        frame = data[t]
        if frame.ndim == 3 and frame.shape[0] == 1:
            frame = frame[0]
        if frame.ndim == 3 and frame.shape[-1] == 1:
            frame = frame[..., 0]
        frames.append(render(t, frame))
        captions.append(caption(t, frame))
    frames[0].save(args.output, save_all=True, append_images=frames[1:],
                   duration=1000 / args.fps, loop=0)
    print(f"Saved GIF to {args.output}")
    return captions


if __name__ == "__main__":
    main()
