"""Plain sliding-window serving of whole events (upstream ``scripts/infer.py``).

An event of T frames is cut into windows of ``stride`` frames starting every
``stride - overlap`` frames (the last ones padded by repeating the event's
final frame); the generator reconstructs each window from the masked frames,
each frame of the event averages the windows that hold it, and the result is
scaled by ``output_scale`` and clipped below at 0.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from .common import make_weights, precision


@torch.no_grad()
def serve_events(model, cfg: Dict, weights: Dict[str, torch.Tensor], frames_u8: np.ndarray,
                 mask_hw: np.ndarray, events: Iterable[int], device, stride: int = 16,
                 overlap: int = 12, output_scale: float = 255.0, window_batch: int = 8,
                 tf32: bool = False) -> Dict[int, np.ndarray]:
    """{event: (T, H, W, 1) float32} for each of ``events``."""
    T = frames_u8.shape[1]
    step = max(1, stride - overlap)
    starts = np.arange(0, T, step)
    frame_idx = np.minimum(starts[:, None] + np.arange(stride)[None, :], T - 1)
    prep = model.prepare(mask_hw, stride, device)
    params = {n[2:]: t for n, t in weights.items() if n.startswith("G:")}
    mask = torch.from_numpy(mask_hw.astype(np.float32)).to(device)[None, None, :, :, None]
    out = {}
    with precision(tf32):
        for e in events:
            video = torch.from_numpy((frames_u8[e].astype(np.float32) / 255.0)[..., None]).to(device)
            masked = video * mask[0]
            acc = torch.zeros_like(video)
            count = torch.zeros((T,), dtype=torch.float32, device=device)
            for lo in range(0, len(starts), window_batch):
                idx = torch.from_numpy(frame_idx[lo:lo + window_batch]).to(device)
                preds = model.generator(params, masked[idx], prep, cfg)
                for w, s in enumerate(starts[lo:lo + window_batch]):
                    n = min(stride, T - int(s))
                    acc[s:s + n] += preds[w, :n]
                    count[s:s + n] += 1
            res = acc / torch.clamp(count, min=1e-5)[:, None, None, None]
            out[e] = torch.clamp(res * output_scale, min=0.0).cpu().numpy()
    return out


def served_weights(model, cfg: Dict, frames_u8: np.ndarray, mask_hw: np.ndarray, seed: int,
                   device) -> Dict[str, torch.Tensor]:
    """The served generator's weights from ``seed``, ``G:``-named: drawn by
    ``make_weights``, then balanced by the model's ``balance_output_signs`` on
    the first window of the first event, so that every seed's served values
    clip to 0 in about the same share (the same work)."""
    params = make_weights(model.generator_spec(cfg), seed, device)
    T = model.sizes(cfg)["T"]
    video = torch.from_numpy(frames_u8[0, :T].astype(np.float32) / 255.0).to(device)
    mask = torch.from_numpy(mask_hw.astype(np.float32)).to(device)
    with precision(False):
        params = model.balance_output_signs(params, (video * mask)[None, ..., None],
                                            model.prepare(mask_hw, T, device), cfg, seed)
    return {f"G:{n}": t for n, t in params.items()}
