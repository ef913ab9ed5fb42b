"""The GAN train step, the eval step and the predict function (PyTorch).

Counterpart of ``p2igan_tpu/training/steps.py`` (reference
``scripts/train.py:228-367``), in its single-forward order:

  1. preds = G(masked, masks) -- ONE generator forward per batch;
  2. D step on ``preds.detach()`` and the real frames, hinge/nsgan/lsgan,
     ``0.5 * (real + fake)``; with ``fused_disc_forward`` (the default) fake
     and real go through ONE concatenated D forward, else through two;
  3. D update;
  4. G loss on the cached ``preds``: reconstruction + adversarial_weight *
     gan(D(preds), real), against the UPDATED D, with no gradient into D's
     parameters; that D forward also advances the spectral ``u``;
  5. G update.

Data parallelism (``mesh``, a ``parallel.DataMesh`` of several ranks): each
rank runs the step on its rows of the global batch, and the gradients are
averaged over the ranks between each ``backward`` and its optimizer step
(explicitly, not through ``DistributedDataParallel``, whose hooks do not fit
the G step's second D forward with the critic frozen, and whose buffer
broadcast would overwrite the spectral vectors every rank advances alike).
Every loss term is a mean over samples (``weighted_l1_distance`` a mean,
``kl_divergence`` ``batchmean``, the GAN losses means), so the average of the
ranks' gradients is the global batch's. BatchNorm layers take the global
batch's statistics.

Every training D forward advances the discriminator's state once
(``update_stats=True``), as in the JAX package: the spectral-norm power
iteration of the P2I discriminator, the BatchNorm running statistics of the
simple critic (three times a step: fake, real, then the G-loss forward). A
BatchNorm critic never sees fake and real concatenated, whatever
``fused_disc_forward`` says: that would mix their batch statistics.

BatchNorm state lives in module buffers here (the JAX package threads
``batch_stats`` through ``gen_extra`` / ``disc_extra``), so what the steps
reproduce is the mode: the train step's generator forward runs in ``train()``
mode (batch statistics, running ones advanced), the eval step and the predict
function in ``eval()`` mode (running statistics).

The optimizer at beta1 == 0 (every shipped config) is :class:`AdamNoMu`, the
arithmetic of the JAX package's ``_scale_by_adam_nomu`` (steps.py:60-87):
only the second moment ``nu`` is kept, and the update is
``g / (sqrt(nu / (1 - b2^t)) + eps) * -lr``. ``torch.optim.Adam`` computes
``sqrt(v) / sqrt(1 - b2^t)`` and keeps a first moment, so it is not the same
thing; a nonzero beta1 falls back to it, as JAX falls back to ``optax.adam``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Iterable, Optional

import torch
from torch import nn

from ..losses import gan_loss, reconstruction_loss
from ..models.simple import BatchNorm, SimpleDiscriminator


class AdamNoMu(torch.optim.Optimizer):
    """Adam at beta1 = 0 without the first-moment buffer (its first moment
    would be the gradient itself). Per parameter: ``step`` and ``nu``."""

    def __init__(self, params: Iterable, lr: float = 1e-4, beta2: float = 0.99,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, beta2=beta2, eps=eps))

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None):
        if closure is not None:
            raise ValueError("AdamNoMu takes no closure")
        biases: Dict[Any, torch.Tensor] = {}
        for group in self.param_groups:
            lr, b2, eps = group["lr"], group["beta2"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["nu"] = torch.zeros_like(p)
                nu = (1.0 - b2) * (g * g) + b2 * state["nu"]
                state["nu"] = nu
                state["step"] += 1
                # 1 - b2^t in float32 as XLA lowers the JAX package's
                # b2**count, exp(t * log(b2)); divided as a tensor: a Python
                # scalar divisor becomes a reciprocal multiply on CUDA
                key = (b2, state["step"], p.device)
                if key not in biases:
                    log_b2 = torch.log(torch.tensor(b2, dtype=torch.float32))
                    bias = 1.0 - torch.exp(state["step"] * log_b2)
                    biases[key] = torch.full((), bias.item(), dtype=torch.float32,
                                             device=p.device)
                update = g / (torch.sqrt(nu / biases[key]) + eps)
                p.add_(update * -lr)


def make_optimizer(opt_cfg: Dict[str, Any], params: Iterable) -> torch.optim.Optimizer:
    """Adam with the reference defaults (train.py:125-136): betas (0.0, 0.99);
    beta1 == 0 takes :class:`AdamNoMu`, any other beta1 ``torch.optim.Adam``."""
    lr = opt_cfg.get("lr", 1e-4)
    b1 = opt_cfg.get("beta1", 0.0)
    b2 = opt_cfg.get("beta2", 0.99)
    eps = opt_cfg.get("eps", 1e-8)
    if b1 == 0.0:
        return AdamNoMu(params, lr=lr, beta2=b2, eps=eps)
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps)


def _gen_apply(gen: nn.Module, idw_prepared=None) -> Callable:
    """G(masked, masks) with the masks broadcast to the masked frames (the raw
    pipeline ships frame-constant (B, 1, H, W, C) masks) and, for p2igan's
    stis path, the run's hoisted gauge selection (dk and stdk take none)."""
    kw = {} if idw_prepared is None else {"idw_prepared": idw_prepared}

    def apply(masked, masks):
        return gen(masked, masks.expand_as(masked), **kw)
    return apply


def build_train_step(
    gen: nn.Module,
    disc: Optional[nn.Module],
    opt_g: torch.optim.Optimizer,
    opt_d: Optional[torch.optim.Optimizer],
    *,
    use_gan: bool,
    gan_loss_type: str = "hinge",
    adversarial_weight: float = 0.01,
    k1_alpha: float = 0.0,
    gan_real_label: float = 1.0,
    gan_fake_label: float = 0.0,
    fused_disc_forward: bool = True,
    idw_prepared=None,
    mesh=None,
) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    """step(frames, masked, masks) -> metrics (0-dim tensors on the device,
    not synchronized, this rank's). Updates the models and optimizers in
    place; after the step every parameter's ``.grad`` holds the gradient its
    update used (averaged over the ranks of ``mesh``)."""
    if mesh is not None and mesh.world > 1:
        for module in (gen, disc):
            for m in module.modules() if module is not None else ():
                if isinstance(m, BatchNorm):
                    m.mesh = mesh
    gen_apply = _gen_apply(gen, idw_prepared)
    gan = functools.partial(gan_loss, loss_type=gan_loss_type,
                            target_real_label=gan_real_label,
                            target_fake_label=gan_fake_label)
    with_d = use_gan and disc is not None
    fuse_d = fused_disc_forward and not isinstance(disc, SimpleDiscriminator)

    def step(frames, masked, masks) -> Dict[str, torch.Tensor]:
        metrics: Dict[str, torch.Tensor] = {}
        gen.train()
        preds = gen_apply(masked, masks)
        preds0 = preds.detach()

        if with_d:
            opt_d.zero_grad(set_to_none=True)
            if fuse_d:
                b = preds0.shape[0]
                logits = disc(torch.cat([preds0, frames], dim=0), update_stats=True)
                logits_fake, logits_real = logits[:b], logits[b:]
            else:
                logits_fake = disc(preds0, update_stats=True)
                logits_real = disc(frames, update_stats=True)
            loss_d = (gan(logits_real, True, is_disc=True)
                      + gan(logits_fake, False, is_disc=True)) * 0.5
            loss_d.backward()
            if mesh is not None:
                mesh.reduce_gradients(disc.parameters())
            opt_d.step()
            metrics["dis_loss"] = loss_d.detach()

        opt_g.zero_grad(set_to_none=True)
        rec, parts = reconstruction_loss(preds, frames, k1_alpha)
        loss = rec
        adv = torch.zeros((), dtype=rec.dtype, device=rec.device)
        if with_d:
            disc.requires_grad_(False)  # the updated D, no gradient into it
            try:
                logits = disc(preds, update_stats=True)
            finally:
                disc.requires_grad_(True)
            adv = gan(logits, True, is_disc=False) * adversarial_weight
            loss = loss + adv
        loss.backward()
        if mesh is not None:
            mesh.reduce_gradients(gen.parameters())
        opt_g.step()
        metrics.update({"loss": loss.detach(), "rec_loss": rec.detach(),
                        "adv_loss": adv.detach(), "pool": parts["pool"].detach(),
                        "reg": parts["reg"].detach()})
        return metrics

    return step


def build_eval_step(gen: nn.Module, *, k1_alpha: float = 0.0,
                    idw_prepared=None) -> Callable:
    """Validation reconstruction loss (reference _evaluate_rec_loss)."""
    gen_apply = _gen_apply(gen, idw_prepared)

    @torch.no_grad()
    def step(frames, masked, masks) -> torch.Tensor:
        gen.eval()
        loss, _ = reconstruction_loss(gen_apply(masked, masks), frames, k1_alpha)
        return loss

    return step


def build_predict_fn(gen: nn.Module, idw_prepared=None) -> Callable:
    gen_apply = _gen_apply(gen, idw_prepared)

    @torch.no_grad()
    def predict(masked, masks) -> torch.Tensor:
        gen.eval()
        return gen_apply(masked, masks)

    return predict
