"""PyTorch port vs the JAX package: discriminator, AdamNoMu, one GAN step.

Weights cross through ``disc_state_dict_from_jax`` / ``state_dict_from_jax``;
inputs come from numpy seeds. The JAX side runs on the CPU through its plain
(XLA) paths, the port through its plain PyTorch versions. Tolerances: the
discriminator rtol 2e-4 (ROADMAP), spectral vectors rtol 1e-5, the optimizer
rtol 1e-6, the GAN step's losses and gradients rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from p2igan_tpu.models import P2IDiscriminator as JaxDiscriminator
from p2igan_tpu.models import P2IGenerator as JaxGenerator
from p2igan_tpu.models import torch_import as TI
from p2igan_tpu.training import steps as jsteps
from p2igan_tpu_torch.models import P2IDiscriminator, P2IGenerator
from p2igan_tpu_torch.models.convert import (disc_state_dict_from_jax,
                                             optimizer_state_from_jax,
                                             params_from_jax, state_dict_from_jax)
from p2igan_tpu_torch.ops.idw import factored_prepare_full
from p2igan_tpu_torch.training import steps as tsteps

T, HW, BASE = 4, 32, 16


def _warm_disc(seed=0, n_iter=5):
    """JAX discriminator variables whose spectral u/v went through a few power
    iterations, so sigma is well conditioned (fresh independent u/v give a
    near-zero sigma and logits of 1e7, see tests/test_training.py)."""
    disc = JaxDiscriminator(in_channels=T)
    x = jnp.asarray(np.random.default_rng(seed).random((2, T, HW, HW, 1),
                                                       dtype=np.float32))
    variables = dict(disc.init(jax.random.key(seed), x))
    for _ in range(n_iter):
        _, upd = disc.apply(variables, x, update_stats=True, mutable=["spectral"])
        variables = {"params": variables["params"], **dict(upd)}
    return disc, variables


def _port_disc(variables):
    disc = P2IDiscriminator(in_channels=T, channels=1)
    disc.load_state_dict(disc_state_dict_from_jax(variables))
    return disc


@pytest.fixture(scope="module")
def disc_vars():
    return _warm_disc()


def test_disc_state_dict_round_trips_and_is_strict(disc_vars):
    _, variables = disc_vars
    sd = disc_state_dict_from_jax(variables)
    assert set(sd) == set(P2IDiscriminator(in_channels=T).state_dict())
    back = TI.import_p2igan_discriminator({k: v.numpy() for k, v in sd.items()})
    jax.tree.map(np.testing.assert_array_equal, back["params"],
                 jax.tree.map(np.asarray, variables["params"]))
    jax.tree.map(np.testing.assert_array_equal, back["spectral"],
                 jax.tree.map(np.asarray, variables["spectral"]))
    spectral = {k: dict(v) for k, v in variables["spectral"].items()}
    del spectral["d3d_4"]["v"]
    with pytest.raises(KeyError, match="d3d_4/v"):
        disc_state_dict_from_jax({"params": variables["params"], "spectral": spectral})
    params = dict(variables["params"])
    params["extra"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="unused"):
        disc_state_dict_from_jax({"params": params, "spectral": variables["spectral"]})


@pytest.mark.parametrize("update_stats", [False, True])
def test_discriminator_matches_jax(disc_vars, update_stats):
    """Logits rtol 2e-4 (atol 1e-5 x max|logit| for logits near zero);
    u/v after one update rtol 1e-5 (atol 1e-6: elements of unit vectors).
    At 32x32 the 3-D branch's 4x4 map is resized to the 2-D branch's 8x8."""
    jdisc, variables = disc_vars
    x = np.random.default_rng(1).random((3, T, HW, HW, 1), dtype=np.float32)
    disc = _port_disc(variables)
    got = disc(torch.from_numpy(x), update_stats=update_stats).detach().numpy()
    if update_stats:
        want, upd = jdisc.apply(variables, jnp.asarray(x), update_stats=True,
                                mutable=["spectral"])
        for name, uv in upd["spectral"].items():
            branch, idx = name.split("_")
            layer = getattr(disc, branch)[int(idx)]
            np.testing.assert_allclose(layer.weight_u.numpy(), np.asarray(uv["u"]),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
            np.testing.assert_allclose(layer.weight_v.numpy(), np.asarray(uv["v"]),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    else:
        want = jdisc.apply(variables, jnp.asarray(x), update_stats=False)
        np.testing.assert_array_equal(  # eval leaves the buffers alone
            disc.d2d[0].weight_u.numpy(), np.asarray(variables["spectral"]["d2d_0"]["u"]))
    want = np.asarray(want)
    assert got.shape == want.shape == (3, (HW // 4) ** 2)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5 * np.abs(want).max())


def test_fused_disc_forward_equals_two_forwards(disc_vars):
    """Conv on the stacked batch == the stacked conv outputs (no power
    iteration): rtol 2e-4."""
    disc = _port_disc(disc_vars[1])
    rng = np.random.default_rng(2)
    fake = torch.from_numpy(rng.random((2, T, HW, HW, 1), dtype=np.float32))
    real = torch.from_numpy(rng.random((2, T, HW, HW, 1), dtype=np.float32))
    with torch.no_grad():
        both = disc(torch.cat([fake, real]))
        np.testing.assert_allclose(both[:2].numpy(), disc(fake).numpy(), rtol=2e-4)
        np.testing.assert_allclose(both[2:].numpy(), disc(real).numpy(), rtol=2e-4)


def test_adam_nomu_matches_jax(disc_vars):
    """Three updates on fixed gradients against JAX make_optimizer (beta1=0,
    the mu-free Adam): parameters and nu rtol 1e-6; parameters also atol
    1e-6 x lr, for a parameter that ends near zero after an update that
    differs by one ULP (XLA's vectorized sqrt and division). Then the JAX
    state after two updates, loaded with optimizer_state_from_jax, takes the
    third update as the port's own state does."""
    _, variables = disc_vars
    params = variables["params"]
    cfg = {"lr": 1e-3, "beta1": 0.0, "beta2": 0.99}
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(lambda p: jnp.asarray(
        rng.normal(size=p.shape).astype(np.float32)), params) for _ in range(3)]
    jopt = jsteps.make_optimizer(cfg)
    jstate, jp, states, jparams = jopt.init(params), params, [], []
    for g in grads:
        upd, jstate = jopt.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        states.append(jstate)
        jparams.append(jp)

    disc = _port_disc(variables)
    opt = tsteps.make_optimizer(cfg, disc.parameters())
    assert isinstance(opt, tsteps.AdamNoMu)
    named = dict(disc.named_parameters())

    def set_grads(g):
        for name, value in params_from_jax(disc, g).items():
            named[name].grad = value

    for g in grads:
        set_grads(g)
        opt.step()
    want = params_from_jax(disc, jp)
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-6 * cfg["lr"], err_msg=name)
    want_nu = params_from_jax(disc, states[-1][0].nu)
    for name, p in named.items():
        np.testing.assert_allclose(opt.state[p]["nu"].numpy(), want_nu[name].numpy(),
                                   rtol=1e-6, err_msg=name)

    # resume from the JAX state after two updates
    disc2 = _port_disc({"params": jparams[1], "spectral": variables["spectral"]})
    opt2 = tsteps.make_optimizer(cfg, disc2.parameters())
    optimizer_state_from_jax(states[1], opt2, disc2)
    named = dict(disc2.named_parameters())
    assert all(opt2.state[p]["step"] == 2 for p in named.values())
    set_grads(grads[2])
    opt2.step()
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-6 * cfg["lr"], err_msg=name)
    assert not isinstance(tsteps.make_optimizer({"beta1": 0.5}, disc.parameters()),
                          tsteps.AdamNoMu)


def _capture():
    """optax transformation that passes the gradients on unchanged and keeps
    them as its state, so the JAX step's gradients can be read back."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


@pytest.mark.parametrize("fused", [True, False])
def test_one_gan_step_matches_jax(fused):
    """One hinge-GAN step from identical state (base 16, T=4, 32x32, batch 2,
    a shared stis mask, the gauge selection hoisted from the same tables on
    both sides): losses rtol 1e-4; G and D gradients rtol 1e-4 with atol
    1e-4 x max|grad| of each tensor (gradients, not parameter deltas: at step
    1 Adam moves every element by about +-lr); the spectral u after the step
    rtol 1e-5 (atol 1e-6)."""
    rng = np.random.default_rng(11)
    flat = np.zeros(HW * HW, np.float32)
    flat[rng.choice(HW * HW, 9, replace=False)] = 1.0
    masks = np.broadcast_to(flat.reshape(1, 1, HW, HW, 1),
                            (2, T, HW, HW, 1)).astype(np.float32)
    frames = rng.random((2, T, HW, HW, 1), dtype=np.float32)
    masked = frames * masks
    prep = factored_prepare_full(torch.from_numpy(masks[0, 0, :, :, 0]), 128)

    kw = dict(H=HW, W=HW, length=T, num_res=1, base_channels=BASE, idw_max_points=128,
              idw_factored=True, idw_shared_batch_mask=True)
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
    jstep = jsteps.build_train_step(
        jgen, jdisc, jopt_g, jopt_d, donate=False,
        idw_prepared=tuple(jnp.asarray(t.numpy()) for t in prep), **step_kw)
    new_state, jm = jstep(state, jnp.asarray(frames), jnp.asarray(masked),
                          jnp.asarray(masks))

    gen = P2IGenerator(**kw)
    gen.load_state_dict(state_dict_from_jax({"params": gp}))
    disc = _port_disc(dvars)
    opt_g = tsteps.make_optimizer(cfg, gen.parameters())
    opt_d = tsteps.make_optimizer(cfg, disc.parameters())
    step = tsteps.build_train_step(gen, disc, opt_g, opt_d, idw_prepared=prep, **step_kw)
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
    for name, uv in new_state.disc_extra["spectral"].items():
        branch, idx = name.split("_")
        np.testing.assert_allclose(getattr(disc, branch)[int(idx)].weight_u.numpy(),
                                   np.asarray(uv["u"]), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
