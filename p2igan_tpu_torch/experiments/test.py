"""Data inspection report of the port (the counterpart of ``experiments/test.py``).

    python -m p2igan_tpu_torch.experiments.test [--config exp.json] [--device cpu]

Prints value statistics over sampled pixels of the observation store and of
each method's store, and saves their log-density histograms to
``<save_dir>/data_inspection/value_histograms.png`` (matplotlib). The pixel
sample is drawn on the host with numpy's ``default_rng(seed)``, as the JAX
script draws it, so the printed statistics match; they are computed on the
device.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch

from ..parallel.mesh import resolve_device
from .config import build_config, get_mode_config
from .io import ensure_dir, load_zarr_array, to_device


def sample_values(arr, n: int = 1_000_000, seed: int = 0,
                  device: str | torch.device = "cuda") -> torch.Tensor:
    """The finite values of ``arr`` on ``device`` (in C order); beyond ``n``
    of them, ``n`` drawn without replacement by ``default_rng(seed)``."""
    flat = to_device(arr, resolve_device(device)).reshape(-1)
    flat = flat[torch.isfinite(flat)]
    if flat.numel() <= n:
        return flat
    idx = np.random.default_rng(seed).choice(flat.numel(), size=n, replace=False)
    return flat[torch.from_numpy(idx).to(flat.device)]


def statistics(values: torch.Tensor) -> Dict[str, float]:
    """n, min, max, mean, std (population) of a sample, in its dtype."""
    stats = torch.stack([values.min(), values.max(), values.mean(),
                         values.std(correction=0)]).tolist()
    return {"n": int(values.numel()), **dict(zip(("min", "max", "mean", "std"), stats))}


def describe(name: str, values: torch.Tensor) -> Dict[str, float]:
    s = statistics(values)
    print(f"[{name}] n={s['n']} min={s['min']:.4f} max={s['max']:.4f} "
          f"mean={s['mean']:.4f} std={s['std']:.4f}")
    return s


def plot_hist(values_map, out_path: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4), dpi=150)
    for name, values in values_map.items():
        ax.hist(values, bins=100, histtype="step", density=True, log=True, label=name)
    ax.set_xlabel("value")
    ax.set_ylabel("log density")
    ax.legend(fontsize=8)
    plt.tight_layout()
    plt.savefig(out_path)
    plt.close(fig)


def inspect(cfg, device: str | torch.device = "cuda") -> Dict[str, torch.Tensor]:
    """Each store's sample on ``device``, its statistics printed; a method
    store that cannot be read is reported and left out."""
    mode_cfg = get_mode_config(cfg)
    values_map = {"observation": sample_values(
        load_zarr_array(mode_cfg.observation_path), device=device)}
    describe("observation", values_map["observation"])
    for name, path in mode_cfg.methods.items():
        try:
            arr = load_zarr_array(path)
        except Exception as e:  # noqa: BLE001
            print(f"[{name}] unavailable: {e}")
            continue
        values_map[name] = sample_values(arr, device=device)
        describe(name, values_map[name])
    return values_map


def main(config_path=None, data_root=None, device: str | torch.device = "cuda") -> None:
    cfg = build_config(config_path=config_path, data_root=data_root)
    out_dir = os.path.join(cfg.save_dir, "data_inspection")
    ensure_dir(out_dir)
    values_map = inspect(cfg, device)
    plot_hist({k: v.cpu().numpy() for k, v in values_map.items()},
              os.path.join(out_dir, "value_histograms.png"))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Data inspection of the "
                                                 "experiment stores (PyTorch / CUDA)")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--data-root", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    cli = parser.parse_args()
    main(config_path=cli.config, data_root=cli.data_root, device=cli.device)
