"""PyTorch port vs the JAX package: training p2igan on per-sample sti masks.

One hinge-GAN step from identical state against the JAX step, and the port's
trainer on an sti config (no hoist, both input pipelines). The step on stin
masks (the generic IDW) is here too: its un-jitted JAX step shares the sti
step's one-time compilation of every operation. Tolerances are
those of ``tests/test_torch_gan.py`` for the stis step: losses rtol 1e-4,
gradients rtol 1e-4 with atol 1e-4 x max|grad|, spectral u rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from p2igan_tpu.data import fake
from p2igan_tpu.models import P2IGenerator as JaxGenerator
from p2igan_tpu.training import steps as jsteps
from p2igan_tpu_torch.data.datamodule import P2IDataModule
from p2igan_tpu_torch.models import P2IGenerator
from p2igan_tpu_torch.models.convert import params_from_jax, state_dict_from_jax
from p2igan_tpu_torch.training import steps as tsteps
from p2igan_tpu_torch.training.trainer import Trainer

from test_torch_gan import BASE, HW, T, _capture, _port_disc, _warm_disc
from test_torch_idw_generic_model import _budget, per_frame_masks
from test_torch_idw_generic_model import small_jax_idw_chunk  # noqa: F401  (fixture)
from test_torch_sti_model import sti_inputs
from test_torch_trainer import _record_batches


@pytest.mark.parametrize("fused", [True, False])
def test_one_sti_gan_step_matches_jax(fused):
    """One hinge-GAN step (base 16, T=4, 32x32, batch 2, every sample under
    its own block-4 sti mask, 64 gauges each; the gauge selection runs inside
    the step on both sides).

    The JAX step runs un-jitted (the function ``build_train_step`` wraps in
    ``jax.jit``, called op by op): jitted, XLA contracts the gauge distance
    ``dx*dx + dy*dy`` into an FMA, which moves a distance by an ULP and flips
    exact ties at a pixel's k-th gauge (about 3% of the pixels of such a mask:
    a jittered grid is full of integer-offset ties); JAX's op-by-op arithmetic
    is the one the port follows (ROADMAP queue 3). The tolerances are the stis
    step's, not loosened."""
    rng = np.random.default_rng(11)
    masked, masks = sti_inputs(seed=11, B=2, block=4, hw=HW, t=T)
    frames = rng.random((2, T, HW, HW, 1), dtype=np.float32)
    masked = frames * masks

    kw = dict(H=HW, W=HW, length=T, num_res=1, base_channels=BASE,
              idw_max_points=T * 128, idw_factored=True, idw_shared_batch_mask=False)
    jgen = JaxGenerator(**kw)
    gvars = dict(jgen.init(jax.random.key(0), jnp.asarray(masked), jnp.asarray(masks)))
    jdisc, dvars = _warm_disc(seed=1, n_iter=0)
    cfg = {"lr": 1e-4, "beta1": 0.0, "beta2": 0.99}
    jopt_g = optax.chain(_capture(), jsteps.make_optimizer(cfg))
    jopt_d = optax.chain(_capture(), jsteps.make_optimizer(cfg))
    gp, dp = gvars.pop("params"), dvars["params"]
    dextra = {k: v for k, v in dvars.items() if k != "params"}
    state = jsteps.TrainState(step=jnp.zeros((), jnp.int32), gen_params=gp,
                              gen_extra=gvars, opt_g=jopt_g.init(gp),
                              disc_params=dp, disc_extra=dextra, opt_d=jopt_d.init(dp))
    step_kw = dict(use_gan=True, gan_loss_type="hinge", adversarial_weight=0.01,
                   k1_alpha=0.05, fused_disc_forward=fused)
    jstep = jsteps.build_train_step(jgen, jdisc, jopt_g, jopt_d, donate=False, **step_kw)
    new_state, jm = jstep.__wrapped__(state, jnp.asarray(frames), jnp.asarray(masked),
                                      jnp.asarray(masks))

    gen = P2IGenerator(**kw)
    gen.load_state_dict(state_dict_from_jax({"params": gp}))
    disc = _port_disc(dvars)
    opt_g = tsteps.make_optimizer(cfg, gen.parameters())
    opt_d = tsteps.make_optimizer(cfg, disc.parameters())
    step = tsteps.build_train_step(gen, disc, opt_g, opt_d, **step_kw)
    # the raw pipeline's form of a frame-constant mask: one frame a sample
    m = step(torch.from_numpy(frames), torch.from_numpy(masked),
             torch.from_numpy(masks[:, :1].copy()))

    for key in ("loss", "rec_loss", "adv_loss", "dis_loss", "pool", "reg"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=key)
    for module, jgrads in ((gen, new_state.opt_g[0]), (disc, new_state.opt_d[0])):
        want = params_from_jax(module, jgrads)
        for name, p in module.named_parameters():
            w = want[name].numpy()
            if p.grad is None:  # alpha3d: unused, JAX's gradient is zero
                np.testing.assert_array_equal(w, 0.0, err_msg=name)
                continue
            np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(), err_msg=name)
    for name in ("input.layers.0.conv.weight", "input.layers.1.conv.bias"):
        assert float(dict(gen.named_parameters())[name].grad.abs().max()) > 0, name
    # the updated parameters: Adam's first step is +-lr an element, so they
    # are held to atol lr x 1e-2 around the JAX ones (a gradient whose sign
    # is in doubt is one within 1e-4 x max of zero)
    want = params_from_jax(gen, new_state.gen_params)
    for name, p in gen.named_parameters():
        g = p.grad.numpy()
        sure = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(p.detach().numpy()[sure], want[name].numpy()[sure],
                                   rtol=0, atol=1e-2 * cfg["lr"], err_msg=name)
    for name, uv in new_state.disc_extra["spectral"].items():
        branch, idx = name.split("_")
        np.testing.assert_allclose(getattr(disc, branch)[int(idx)].weight_u.numpy(),
                                   np.asarray(uv["u"]), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.usefixtures("small_jax_idw_chunk")
def test_one_stin_gan_step_matches_jax():
    """One hinge-GAN step (base 16, T=4, 32x32, batch 2, every sample under
    its own stin mask: 2 frames fully observed, then a block-4 jittered grid;
    2304 points, through the generic IDW: the plain versions of the single
    pass #8 forward and #10 backward). The JAX step runs un-jitted, as the sti
    step above: jitted, XLA contracts the distance sums into FMAs and flips
    the ties that the dense frames put on the query lattice; updated
    parameters atol 1e-2 x lr where the gradient is not tiny."""
    masks = per_frame_masks("stin", 2, T, HW, seed=11)
    frames = np.random.default_rng(11).random((2, T, HW, HW, 1), dtype=np.float32)
    masked = frames * masks
    kw = dict(H=HW, W=HW, length=T, num_res=1, base_channels=BASE,
              idw_max_points=_budget("stin", T, HW))
    jgen = JaxGenerator(**kw)
    gvars = dict(jgen.init(jax.random.key(0), jnp.asarray(masked), jnp.asarray(masks)))
    jdisc, dvars = _warm_disc(seed=1, n_iter=0)
    cfg = {"lr": 1e-4, "beta1": 0.0, "beta2": 0.99}
    jopt_g = optax.chain(_capture(), jsteps.make_optimizer(cfg))
    jopt_d = optax.chain(_capture(), jsteps.make_optimizer(cfg))
    gp, dp = gvars.pop("params"), dvars["params"]
    dextra = {k: v for k, v in dvars.items() if k != "params"}
    state = jsteps.TrainState(step=jnp.zeros((), jnp.int32), gen_params=gp,
                              gen_extra=gvars, opt_g=jopt_g.init(gp),
                              disc_params=dp, disc_extra=dextra, opt_d=jopt_d.init(dp))
    step_kw = dict(use_gan=True, gan_loss_type="hinge", adversarial_weight=0.01,
                   k1_alpha=0.05, fused_disc_forward=True)
    jstep = jsteps.build_train_step(jgen, jdisc, jopt_g, jopt_d, donate=False, **step_kw)
    new_state, jm = jstep.__wrapped__(state, jnp.asarray(frames), jnp.asarray(masked),
                                      jnp.asarray(masks))

    gen = P2IGenerator(**kw)
    assert not gen.idw_factored
    gen.load_state_dict(state_dict_from_jax({"params": gp}))
    disc = _port_disc(dvars)
    opt_g = tsteps.make_optimizer(cfg, gen.parameters())
    opt_d = tsteps.make_optimizer(cfg, disc.parameters())
    step = tsteps.build_train_step(gen, disc, opt_g, opt_d, **step_kw)
    m = step(torch.from_numpy(frames), torch.from_numpy(masked), torch.from_numpy(masks))

    for key in ("loss", "rec_loss", "adv_loss", "dis_loss", "pool", "reg"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=key)
    for module, jgrads in ((gen, new_state.opt_g[0]), (disc, new_state.opt_d[0])):
        want = params_from_jax(module, jgrads)
        for name, p in module.named_parameters():
            w = want[name].numpy()
            if p.grad is None:  # alpha3d: unused, JAX's gradient is zero
                np.testing.assert_array_equal(w, 0.0, err_msg=name)
                continue
            np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(), err_msg=name)
    for name in ("input.layers.0.conv.weight", "input.layers.1.conv.bias"):
        assert float(dict(gen.named_parameters())[name].grad.abs().max()) > 0, name
    want = params_from_jax(gen, new_state.gen_params)
    for name, p in gen.named_parameters():
        g = p.grad.numpy()
        sure = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(p.detach().numpy()[sure], want[name].numpy()[sure],
                                   rtol=0, atol=1e-2 * cfg["lr"], err_msg=name)
    for name, uv in new_state.disc_extra["spectral"].items():
        branch, idx = name.split("_")
        np.testing.assert_allclose(getattr(disc, branch)[int(idx)].weight_u.numpy(),
                                   np.asarray(uv["u"]), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_overfit_one_sti_batch_reduces_loss():
    """Repeated steps on one fixed batch whose samples carry different sti
    masks drive the weighted-L1 rec loss well down, as
    tests/test_torch_trainer.py does on a shared mask with the same
    thresholds (60 steps reach them here; the loss is below 1.75 after 20):
    an absent or sign-flipped gradient through the per-sample combine's
    backward fails it."""
    rng = np.random.default_rng(3)
    _, masks = sti_inputs(seed=3, B=2, block=2, hw=16, t=T)
    masks = torch.from_numpy(masks)
    frames = torch.from_numpy(rng.random((2, T, 16, 16, 1), dtype=np.float32))
    gen = P2IGenerator(H=16, W=16, length=T, num_res=1, base_channels=4 * T,
                       idw_max_points=T * 128, idw_factored=True,
                       idw_shared_batch_mask=False,
                       generator=torch.Generator().manual_seed(0))
    opt = tsteps.make_optimizer({"lr": 1e-3}, gen.parameters())
    step = tsteps.build_train_step(gen, None, opt, None, use_gan=False, k1_alpha=0.0)
    losses = [float(step(frames, frames * masks, masks)["rec_loss"]) for _ in range(60)]
    assert losses[0] > 3.0, f"unexpectedly easy start: {losses[0]}"
    assert min(losses) < 0.3 * losses[0], (losses[0], min(losses))
    assert min(losses) < 1.75, (losses[0], min(losses))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_sti_train")
    fake.write_train_zarr(root / "train.zarr", n_events=2, T=8, H=HW, W=HW,
                          window=T, stride=2, seed=0)
    return root


@pytest.fixture(autouse=True)
def _file_tracker(monkeypatch, tmp_path):
    monkeypatch.setenv("P2IGAN_FORCE_FILE_TRACKER", "1")
    from p2igan_tpu_torch.utils.tracking import get_tracker

    get_tracker().set_tracking_uri(str(tmp_path / "mlruns"))


def _cfg(root, save_dir, iterations=2, use_gan=1, device_decode=False):
    train = {"data_root": str(root / "train.zarr"), "w": HW, "h": HW,
             "sample_length": T, "mask": {"type": "sti", "block_sizes": [8]}}
    if device_decode:
        train["device_decode"] = 1
    return {
        "seed": 7, "save_dir": str(save_dir), "experiment_name": "torch-sti-test",
        "run_name": "run",
        "model": {"name": "p2igan", "in_channels": 1, "out_channels": 1,
                  "base_channels": 4 * T},
        "data": {"train": train},
        "loss": {"adversarial_weight": 0.01, "k1_weight": 0.05,
                 "gan_loss": "hinge", "use_gan": use_gan},
        "train": {"optimizer": {"beta1": 0.0, "beta2": 0.99, "lr": 1e-4},
                  "batch_size": 2, "num_workers": 2, "log_step": 1,
                  "iterations": iterations, "use_validation": True},
    }


def test_sti_trainer_hoists_nothing_and_both_pipelines_give_the_same_step(
        data_root, tmp_path):
    """An sti config trains through the Trainer with the gauge selection in
    the step (nothing to hoist: the masks differ by sample). The raw
    (device_decode) pipeline ships one (1, H, W, 1) mask frame a sample and
    decodes on the device; its batches, and so its losses and weights after
    two GAN steps, equal the float pipeline's exactly."""
    runs = {}
    for decode in (False, True):
        tr = Trainer(_cfg(data_root, tmp_path / f"dd{int(decode)}",
                          device_decode=decode), device="cpu")
        assert not tr._idw_hoist_pending
        assert tr.generator.idw_factored and not tr.generator.idw_shared_batch_mask
        seen = _record_batches(tr)
        tr.train()
        assert tr.global_step == 2 and np.isfinite(tr.last_dis_loss)
        assert (tmp_path / f"dd{int(decode)}" / "latest.ckpt").exists()
        runs[decode] = (seen, tr.last_rec_loss, tr.generator.state_dict())
    raw_item = P2IDataModule(_cfg(data_root, tmp_path, device_decode=True)
                             ).train_dataset[0]
    assert raw_item[0].dtype == np.uint8 and raw_item[1].shape == (1, HW, HW, 1)
    assert len(runs[False][0]) == len(runs[True][0]) == 2
    for a, b in zip(runs[False][0], runs[True][0]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        masks = a[2]
        assert not torch.equal(masks[0], masks[1])      # a mask per sample
        assert bool((masks == masks[:, :1]).all())      # constant over frames
        assert int(masks[0, 0].sum()) == (HW // 8) ** 2  # one gauge a block
    assert runs[False][1] == runs[True][1]
    for (name, p), q in zip(runs[False][2].items(), runs[True][2].values()):
        assert torch.equal(p, q), name
