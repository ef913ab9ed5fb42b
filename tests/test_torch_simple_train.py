"""Training of the simple family in the PyTorch port vs the JAX package (CPU).

One reconstruction-loss step and one hinge-GAN step (against the simple
BatchNorm critic) from identical state, base_channels 8, T=4, 16x16, batch 2:
losses rtol 1e-4; every gradient rtol 1e-4 with atol 1e-4 x max|grad| of its
tensor; updated parameters rtol 1e-5, atol 2e-6; the generator's and the
critic's running statistics after the step rtol 1e-5, atol 1e-6 (the
tolerances of tests/test_torch_gan.py and tests/test_torch_dk_train.py). Then
the BatchNorm mode of the steps, overfit-one-batch, resume, and one dk step
under ``use_gan``.

A convolution bias that feeds a BatchNorm has a gradient of exactly zero in
exact arithmetic (the batch mean removes it): both packages return rounding
noise there, which is held to be small, not equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from p2igan_tpu.data import fake
from p2igan_tpu.models import SimpleDiscriminator as JaxDiscriminator
from p2igan_tpu.training import steps as jsteps
from p2igan_tpu_torch.models import SimpleDiscriminator, SimpleGenerator
from p2igan_tpu_torch.models.convert import params_from_jax
from p2igan_tpu_torch.models.simple import BatchNorm
from p2igan_tpu_torch.training import steps as tsteps
from p2igan_tpu_torch.training.checkpoint import load_checkpoint_raw, load_generator_state
from p2igan_tpu_torch.training.trainer import Trainer

from test_torch_dk_model import _inputs as dk_inputs
from test_torch_dk_model import _jax_model as dk_jax_model
from test_torch_dk_model import _port_model as dk_port_model
from test_torch_dk_train import _cli
from test_torch_gan import _capture
from test_torch_simple_model import (B, BASE, HW, T, _assert_stats, _inputs,
                                     jax_discriminator, jax_generator,
                                     port_discriminator, port_generator)

OPT = {"lr": 1e-4, "beta1": 0.0, "beta2": 0.99}


@pytest.fixture(autouse=True)
def _file_tracker(monkeypatch, tmp_path):
    monkeypatch.setenv("P2IGAN_FORCE_FILE_TRACKER", "1")
    from p2igan_tpu_torch.utils.tracking import get_tracker

    get_tracker().set_tracking_uri(str(tmp_path / "mlruns"))


def _bn_fed_biases(module):
    """Names of the conv biases directly followed by a BatchNorm."""
    return {f"{name}.0.bias" for name, m in module.named_modules()
            if isinstance(m, torch.nn.Sequential) and len(m) > 1
            and isinstance(m[1], BatchNorm)}


def _assert_grads_and_params(module, jgrads, jparams):
    """Gradients everywhere; updated parameters where the first Adam step is
    well conditioned. It moves an element by lr * g / (|g| + eps): where |g|
    is rounding noise (the BatchNorm-fed biases, a dead channel) the step is
    noise of size lr in both packages."""
    want, after = params_from_jax(module, jgrads), params_from_jax(module, jparams)
    zero = _bn_fed_biases(module)
    assert len(zero) == 3
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, p in module.named_parameters():
        w = want[name].numpy()
        if name in zero:
            assert np.abs(w).max() <= 1e-4 * scale, name
            assert float(p.grad.abs().max()) <= 1e-4 * scale, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
        firm = np.abs(w) > 1e-4 * max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(p.detach().numpy()[firm], after[name].numpy()[firm],
                                   rtol=1e-5, atol=2e-6, err_msg=name)


def _jax_state(gvars, dvars=None):
    jopt_g = optax.chain(_capture(), jsteps.make_optimizer(OPT))
    gp = jax.tree.map(jnp.asarray, gvars["params"])
    extra = {k: jax.tree.map(jnp.asarray, v) for k, v in gvars.items() if k != "params"}
    kw = {}
    jopt_d = None
    if dvars is not None:
        jopt_d = optax.chain(_capture(), jsteps.make_optimizer(OPT))
        dp = jax.tree.map(jnp.asarray, dvars["params"])
        kw = dict(disc_params=dp, opt_d=jopt_d.init(dp),
                  disc_extra={"batch_stats": jax.tree.map(jnp.asarray,
                                                          dvars["batch_stats"])})
    state = jsteps.TrainState(step=jnp.zeros((), jnp.int32), gen_params=gp,
                              gen_extra=extra, opt_g=jopt_g.init(gp), **kw)
    return state, jopt_g, jopt_d


@pytest.mark.parametrize("k1_alpha", [0.0, 0.05])
def test_one_rec_loss_step_matches_jax(k1_alpha):
    jgen, variables = jax_generator()
    frames, masked, masks = _inputs(21)
    state, jopt, _ = _jax_state(variables)
    jstep = jsteps.build_train_step(jgen, None, jopt, None, use_gan=False,
                                    k1_alpha=k1_alpha, donate=False)
    new_state, jm = jstep(state, jnp.asarray(frames), jnp.asarray(masked),
                          jnp.asarray(masks))

    gen = port_generator(variables).eval()   # the step itself must set the mode
    opt = tsteps.make_optimizer(OPT, gen.parameters())
    step = tsteps.build_train_step(gen, None, opt, None, use_gan=False,
                                   k1_alpha=k1_alpha)
    m = step(*(torch.from_numpy(a) for a in (frames, masked, masks)))
    assert gen.training
    for key in ("loss", "rec_loss", "pool", "reg"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=key)
    assert float(m["adv_loss"]) == 0.0 and "dis_loss" not in m
    _assert_grads_and_params(gen, new_state.opt_g[0], new_state.gen_params)
    _assert_stats(gen.encoder, new_state.gen_extra["batch_stats"],
                  ("enc0", "enc1", "enc2"))


@pytest.mark.parametrize("fused", [True, False])
def test_one_gan_step_matches_jax(fused):
    """``fused_disc_forward`` must make no difference against a BatchNorm
    critic: fake and real always take a forward each, and the critic's
    running statistics advance three times (fake, real, the G-loss forward)."""
    jgen, gvars = jax_generator()
    jdisc, dvars = jax_discriminator()
    frames, masked, masks = _inputs(22)
    state, jopt_g, jopt_d = _jax_state(gvars, dvars)
    step_kw = dict(use_gan=True, gan_loss_type="hinge", adversarial_weight=0.01,
                   k1_alpha=0.05, fused_disc_forward=fused)
    jstep = jsteps.build_train_step(jgen, jdisc, jopt_g, jopt_d, donate=False, **step_kw)
    new_state, jm = jstep(state, jnp.asarray(frames), jnp.asarray(masked),
                          jnp.asarray(masks))

    gen, disc = port_generator(gvars), port_discriminator(dvars)
    opt_g = tsteps.make_optimizer(OPT, gen.parameters())
    opt_d = tsteps.make_optimizer(OPT, disc.parameters())
    seen = []
    disc.register_forward_pre_hook(
        lambda mod, args, kwargs: seen.append((args[0].shape[0], kwargs["update_stats"])),
        with_kwargs=True)
    step = tsteps.build_train_step(gen, disc, opt_g, opt_d, **step_kw)
    m = step(*(torch.from_numpy(a) for a in (frames, masked, masks)))
    assert seen == [(B, True)] * 3   # never a concatenated batch of 2 B

    for key in ("loss", "rec_loss", "adv_loss", "dis_loss", "pool", "reg"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=key)
    _assert_grads_and_params(gen, new_state.opt_g[0], new_state.gen_params)
    _assert_grads_and_params(disc, new_state.opt_d[0], new_state.disc_params)
    _assert_stats(gen.encoder, new_state.gen_extra["batch_stats"],
                  ("enc0", "enc1", "enc2"))
    # the third forward runs on the UPDATED critic, whose BatchNorm-fed conv
    # biases took a noise step of up to lr each way in both packages: the
    # running means may differ by momentum x 2 lr = 2e-5
    _assert_stats(disc.features, new_state.disc_extra["batch_stats"], ("f0", "f1", "f2"),
                  mean_atol=3e-5)
    # three updates: one alone leaves 0.9 of the old value's distance
    one = port_discriminator(dvars)
    one(torch.from_numpy(frames), update_stats=True)
    moved = (disc.features[0][1].running_mean - one.features[0][1].running_mean).abs().max()
    assert float(moved) > 1e-3
    assert all(p.requires_grad for p in disc.parameters())


def test_eval_step_and_predict_use_the_running_statistics():
    jgen, variables = jax_generator()
    frames, masked, masks = _inputs(23)
    state, _, _ = _jax_state(variables)
    args = [jnp.asarray(a) for a in (frames, masked, masks)]
    want_loss = float(jsteps.build_eval_step(jgen, k1_alpha=0.05)(state, *args))
    want_pred = np.asarray(jsteps.build_predict_fn(jgen)(state, *args[1:]))

    gen = port_generator(variables).train()
    before = {k: v.clone() for k, v in gen.state_dict().items()}
    targs = [torch.from_numpy(a) for a in (frames, masked, masks)]
    got_loss = float(tsteps.build_eval_step(gen, k1_alpha=0.05)(*targs))
    assert not gen.training
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    gen.train()
    got_pred = tsteps.build_predict_fn(gen)(*targs[1:])
    assert not gen.training and not got_pred.requires_grad
    np.testing.assert_allclose(got_pred.numpy(), want_pred, rtol=0, atol=1e-5)
    for k, v in gen.state_dict().items():
        assert torch.equal(v, before[k]), k
    # batch statistics would have given another loss
    gen.train()
    with torch.no_grad():
        other = float(tsteps.reconstruction_loss(gen(*targs[1:]), targs[0], 0.05)[0])
    assert abs(other - want_loss) > 1e-3 * abs(want_loss)
    # a train step after an eval step is back in train mode
    opt = tsteps.make_optimizer(OPT, gen.parameters())
    gen.eval()
    tsteps.build_train_step(gen, None, opt, None, use_gan=False)(*targs)
    assert gen.training


def test_overfit_one_batch_reduces_loss():
    """Repeated steps on one fixed batch drive the weighted-L1 rec loss well
    down; a sign-flipped or absent update fails it. Calibrated on the CPU
    (base 8, 16x16, T=4, lr 3e-3): 2.45 -> 0.54 in 200 steps (a noise target's
    capacity floor at this size); about 25% margin."""
    rng = np.random.default_rng(3)
    masks = torch.from_numpy((rng.random((2, T, 16, 16, 1)) < 0.3).astype(np.float32))
    frames = torch.from_numpy(rng.random((2, T, 16, 16, 1), dtype=np.float32))
    gen = SimpleGenerator(base_channels=BASE, generator=torch.Generator().manual_seed(0))
    opt = tsteps.make_optimizer({"lr": 3e-3}, gen.parameters())
    step = tsteps.build_train_step(gen, None, opt, None, use_gan=False, k1_alpha=0.0)
    losses = [float(step(frames, frames * masks, masks)["rec_loss"]) for _ in range(200)]
    assert np.isfinite(losses).all()
    assert losses[0] > 2.0, f"unexpectedly easy start: {losses[0]}"
    assert min(losses) < 0.3 * losses[0], (losses[0], min(losses))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_simple_train")
    fake.write_train_zarr(root / "train.zarr", n_events=2, T=8, H=HW, W=HW,
                          window=T, stride=2, seed=0)
    fake.write_gauge_mask(root / "gauges.txt", H=HW, W=HW, n_gauges=20, seed=1)
    return root


def _cfg(root, save_dir, model="simple", iterations=3, use_gan=1):
    mask = {"type": "stis", "file": str(root / "gauges.txt")}
    return {
        "seed": 7, "save_dir": str(save_dir), "experiment_name": "torch-simple-test",
        "run_name": "run",
        "model": {"name": model, "in_channels": 1, "out_channels": 1,
                  "base_channels": BASE},
        "data": {"train": {"data_root": str(root / "train.zarr"), "w": HW, "h": HW,
                           "sample_length": T, "mask": mask}},
        "loss": {"adversarial_weight": 0.01, "k1_weight": 0.05, "gan_loss": "hinge",
                 "use_gan": use_gan},
        "train": {"optimizer": {"type": "Adam", "beta1": 0.0, "beta2": 0.99,
                                "lr": 1e-4},
                  "batch_size": 2, "num_workers": 2, "log_step": 1,
                  "iterations": iterations, "use_validation": True},
    }


def test_trainer_checkpoint_and_resume_restore_the_running_statistics(data_root, tmp_path):
    """3 GAN steps, then 3 more from latest.ckpt through the CLI, end where an
    uninterrupted 6-step run ends: weights, optimizer moments and the running
    statistics of generator and critic all round-trip (``extra`` in the
    payload, as in the JAX trainer)."""
    full = Trainer(_cfg(data_root, tmp_path / "full", iterations=6), device="cpu")
    assert isinstance(full.generator, SimpleGenerator) and not full._idw_hoist_pending
    assert isinstance(full.discriminator, SimpleDiscriminator)
    full.train()
    assert full.global_step == 6 and np.isfinite(full.last_dis_loss)

    first = Trainer(_cfg(data_root, tmp_path / "part"), device="cpu")
    first.train()
    latest = tmp_path / "part" / "latest.ckpt"
    raw = load_checkpoint_raw(latest)
    stats = [f"encoder.{i}.1.running_{s}" for i in range(3) for s in ("mean", "var")]
    assert list(raw["generator"]["extra"]) == stats
    assert list(raw["discriminator"]["extra"]) == [s.replace("encoder", "features")
                                                   for s in stats]
    assert set(raw["generator"]["params"]) == {n for n, _ in
                                               first.generator.named_parameters()}
    for key in stats:   # three train steps moved them off their init
        init = 1.0 if key.endswith("var") else 0.0
        assert float((raw["generator"]["extra"][key] - init).abs().max()) > 1e-4, key
        assert torch.equal(raw["generator"]["extra"][key],
                           first.generator.state_dict()[key])

    fresh = Trainer(_cfg(data_root, tmp_path / "part", iterations=6), device="cpu")
    fresh.load(latest)
    for module, other in ((fresh.generator, first.generator),
                          (fresh.discriminator, first.discriminator)):
        for (name, p), q in zip(module.state_dict().items(), other.state_dict().values()):
            assert torch.equal(p, q), name

    cli = _cli("train_torch")
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(_cfg(data_root, tmp_path / "part", iterations=6)))
    resumed = cli.main(cli.parse_args(["--config", str(cfg_path), "--resume",
                                       str(latest), "--device", "cpu"]))
    assert resumed.global_step == 6
    for module, other in ((resumed.generator, full.generator),
                          (resumed.discriminator, full.discriminator)):
        for (name, p), q in zip(module.state_dict().items(), other.state_dict().values()):
            np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=name)
    # serving loads the trainer's checkpoint, running statistics included
    from p2igan_tpu_torch.inference.driver import load_generator

    state = load_generator_state(latest)
    assert set(state) == set(first.generator.state_dict())
    served = load_generator(_cfg(data_root, tmp_path), latest, torch.device("cpu"))
    assert served.serving and not served.training


@pytest.mark.parametrize("family", ["dk", "stdk"])
def test_one_dk_gan_step_matches_jax(family):
    """dk and stdk under ``use_gan: 1`` train against the simple critic, as the
    JAX registry pairs them: one hinge-GAN step, losses and every gradient."""
    jgen, gvars = dk_jax_model(family, shared=True)
    masked, masks = dk_inputs(31)
    frames = np.random.default_rng(32).random(masked.shape, dtype=np.float32)
    jdisc = JaxDiscriminator(base_channels=BASE)
    dvars = jax.tree.map(np.asarray, dict(jdisc.init(jax.random.key(1),
                                                     jnp.asarray(frames))))
    state, jopt_g, jopt_d = _jax_state(gvars, dvars)
    step_kw = dict(use_gan=True, gan_loss_type="hinge", adversarial_weight=0.01,
                   k1_alpha=0.0)
    jstep = jsteps.build_train_step(jgen, jdisc, jopt_g, jopt_d, donate=False, **step_kw)
    new_state, jm = jstep(state, jnp.asarray(frames), jnp.asarray(masked),
                          jnp.asarray(masks))

    gen, disc = dk_port_model(family, gvars, shared=True), port_discriminator(dvars)
    opt_g = tsteps.make_optimizer(OPT, gen.parameters())
    opt_d = tsteps.make_optimizer(OPT, disc.parameters())
    step = tsteps.build_train_step(gen, disc, opt_g, opt_d, **step_kw)
    m = step(*(torch.from_numpy(a) for a in (frames, masked, masks)))
    for key in ("loss", "rec_loss", "adv_loss", "dis_loss"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=key)
    want = params_from_jax(gen, new_state.opt_g[0])
    for name, p in gen.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
    _assert_grads_and_params(disc, new_state.opt_d[0], new_state.disc_params)
    _assert_stats(disc.features, new_state.disc_extra["batch_stats"], ("f0", "f1", "f2"),
                  mean_atol=3e-5)


def test_trainer_builds_the_simple_critic_for_dk_under_use_gan(data_root, tmp_path):
    trainer = Trainer(_cfg(data_root, tmp_path / "dk", model="dk", iterations=2),
                      device="cpu")
    assert isinstance(trainer.discriminator, SimpleDiscriminator)
    trainer.train()
    assert trainer.global_step == 2
    assert np.isfinite([trainer.last_rec_loss, trainer.last_adv_loss,
                        trainer.last_dis_loss]).all()
    raw = load_checkpoint_raw(tmp_path / "dk" / "latest.ckpt")
    assert raw["generator"]["extra"] == {} and len(raw["discriminator"]["extra"]) == 6
