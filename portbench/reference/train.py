"""Plain training steps (upstream ``scripts/train.py``), and the readings the
training cells compare.

A step, for the batch's frames x and its stis mask m:

  preds = G(x * m, m)
  critic (GAN only): one forward of [preds, x] (one power iteration);
    loss_d = 0.5 * (mean relu(1 - D(x)) + mean relu(1 + D(preds))); Adam on D
  generator: rec = weighted L1 + k1 * KL of the frame differences;
    GAN: + adversarial_weight * -mean D'(preds), D' the updated critic with
    no gradient into it (a second power iteration); Adam on G

The rows of a batch are the data module's: the stride-1 windows of the
train store split 80/20 by a permutation seeded from the configuration's
seed, the training part taken in the order of a permutation seeded from
(seed, epoch), batch after batch.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .common import adam, hinge_d, precision, reconstruction_loss


def training_windows(n_events: int, event_frames: int, window: int, seed: int,
                     steps: int, batch: int, stride: int = 1) -> List[np.ndarray]:
    """(steps, batch, 2) [event, start] of the first ``steps`` batches."""
    windows = np.asarray([[e, s] for e in range(n_events)
                          for s in range(0, event_frames - window + 1, stride)], np.int64)
    total = len(windows)
    val = min(max(int(total * (1 - 0.8)), 1), total - 1)
    train = np.random.default_rng(seed).permutation(total)[:total - val]
    order = np.random.default_rng((seed, 0)).permutation(len(train))
    return [windows[train[order[i * batch:(i + 1) * batch]]] for i in range(steps)]


def batch_frames(frames_u8: np.ndarray, rows: np.ndarray, window: int) -> np.ndarray:
    """(B, window, H, W, 1) float32 in [0, 1]."""
    video = np.stack([frames_u8[e, s:s + window] for e, s in rows])
    return (video.astype(np.float32) / 255.0)[..., None]


def _norms(params: Dict[str, torch.Tensor], of) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(of(p))) if of(p) is not None else 0.0
            for n, p in params.items()}


def run_steps(model, cfg: Dict, weights: Dict[str, torch.Tensor], batches: List[np.ndarray],
              mask_hw: np.ndarray, device, tf32: bool = False, half_batch: bool = False
              ) -> Dict:
    """Train from ``weights`` on ``batches``: the losses of each step, the
    norm of each leaf's first gradient, the norm of each leaf's change over
    all the steps. Leaves are named ``G:<key>`` / ``D:<key>``.
    ``half_batch`` is the fault that leaves half of every batch out."""
    gan = bool(cfg["loss"].get("use_gan", 0))
    k1 = float(cfg["loss"].get("k1_weight", 0.0))
    adv_w = float(cfg["loss"].get("adversarial_weight", 0.01))
    opt_cfg = cfg["train"]["optimizer"]
    T = batches[0].shape[1]
    prep = model.prepare(mask_hw, T, device)
    g_names = [n for n, *_ in model.generator_spec(cfg)]
    c_names = [n for n, *_ in model.critic_spec(cfg)] if gan else []
    gp = {n: weights[f"G:{n}"].clone().requires_grad_(True) for n in g_names}
    cp = {n: weights[f"D:{n}"].clone().requires_grad_(True) for n in c_names
          if not n.endswith(("weight_u", "weight_v"))}
    state = {n: weights[f"D:{n}"].clone() for n in c_names if n.endswith(("weight_u", "weight_v"))}
    opt_g = adam(gp.values(), opt_cfg)
    opt_d = adam(cp.values(), opt_cfg) if gan else None
    mask = torch.from_numpy(mask_hw.astype(np.float32)).to(device)
    losses, grad1 = [], {}
    with precision(tf32):
        for step, batch in enumerate(batches):
            x = torch.from_numpy(batch).to(device)
            if half_batch:
                x = x[: x.shape[0] // 2]
            m = mask[None, None, :, :, None].expand_as(x)
            preds = model.generator(gp, x * m, prep, cfg)
            rec_l: Dict[str, float] = {}
            if gan:
                opt_d.zero_grad(set_to_none=True)
                logits = model.critic(cp, state, torch.cat([preds.detach(), x]), update=True)
                b = x.shape[0]
                loss_d = hinge_d(logits[b:], logits[:b])
                loss_d.backward()
                if step == 0:
                    grad1.update({f"D:{n}": v for n, v in _norms(cp, lambda p: p.grad).items()})
                opt_d.step()
                rec_l["dis_loss"] = float(loss_d.detach())
            opt_g.zero_grad(set_to_none=True)
            loss = reconstruction_loss(preds, x, k1)
            if gan:
                frozen = {n: p.detach() for n, p in cp.items()}
                loss = loss - adv_w * torch.mean(model.critic(frozen, state, preds, update=True))
            loss.backward()
            if step == 0:
                grad1.update({f"G:{n}": v for n, v in _norms(gp, lambda p: p.grad).items()})
            opt_g.step()
            rec_l["loss"] = float(loss.detach())
            losses.append(rec_l)
    change = {f"G:{n}": float(torch.linalg.vector_norm(p.detach() - weights[f"G:{n}"]))
              for n, p in gp.items()}
    change.update({f"D:{n}": float(torch.linalg.vector_norm(p.detach() - weights[f"D:{n}"]))
                   for n, p in cp.items()})
    return {"losses": losses, "grad1": grad1, "change": change}


# the steps whose losses ``loss_gap`` compares
LOSS_STEPS = 2


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The three compared numbers (each the worst case):

    * ``loss_gap``: |program - reference| / |reference| of the loss (and
      the critic's) of the first ``LOSS_STEPS`` steps. The third step's
      loss is not compared: Adam moves every element whose first gradients
      are near zero by about the learning rate, whichever sign their
      rounding gives, and the GAN's third loss then reads up to 1e-3 on
      sound runs, as far from the reference as TF32's;
    * ``grad_gap``: per leaf, the gap between the two norms of the first
      gradient over the larger of the reference's norm and the median
      leaf's;
    * ``change_gap``: the same for the norm of each leaf's change over the
      steps, over the leaves whose first reference gradient is at least a
      thousandth of the median leaf's (the others move by round-off
      alone under Adam)."""
    loss_gap = max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-30)
                   for p, r in zip(prog["losses"][:LOSS_STEPS], ref["losses"][:LOSS_STEPS])
                   for k in r)
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = float("inf")
    g_ref = ref["grad1"]
    g_med = float(np.median([v for v in g_ref.values() if v > 0]))
    grad_gap = max(abs(prog["grad1"].get(n, 0.0) - v) / max(v, g_med) for n, v in g_ref.items())
    moving = [n for n, v in g_ref.items() if v >= 1e-3 * g_med]
    c_med = float(np.median([ref["change"][n] for n in moving]))
    change_gap = max(abs(prog["change"].get(n, 0.0) - ref["change"][n])
                     / max(ref["change"][n], c_med) for n in moving)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}
