"""The port's bfloat16 options vs the JAX package's, on the CPU.

- ``P2IDiscriminator(branch3d_dtype=torch.bfloat16)`` (config key
  ``model.disc_branch3d_dtype``) vs ``disc.clone(branch3d_dtype=bfloat16)``;
- ``P2IGenerator(compute_dtype=torch.bfloat16)`` vs
  ``gen.clone(compute_dtype=bfloat16)`` on the factored stis path, and the
  folded serving variant;
- ``DKGenerator`` / ``STDKGenerator(compute_dtype=torch.bfloat16)``;
- one hinge-GAN step with the bf16 critic;
- ``maxpool2_duplicate`` on bf16 (its plain version on the CPU).

Tolerances. The two packages round to bf16 at the same places (the port
follows the JAX casts; its bf16 resize uses the JAX package's float32
arithmetic), so they differ only where a float32 sum taken in another order
lands on the other side of a bf16 rounding step. One such flip moves an
activation by a bf16 unit (2^-8 of it), and the flips spread through the
layers after it: the critic's logits differ by 0.6% of max|JAX| (32x32 JAX
test size), the generator's output by 0.3-1.5% of max|JAX| at 16x16 (four
seeds; 1.4-2.0% at 32x32, where more of them meet), as much as JAX's own bf16
output differs from its float32 one (1.6%). So both are held to
2e-2 x max|JAX|. dk/stdk round their inputs where JAX casts them and compute
in float32 after, so they keep the float32 parity tolerance, atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from p2igan_tpu.models import DKGenerator as JaxDK
from p2igan_tpu.models import P2IDiscriminator as JaxDiscriminator
from p2igan_tpu.models import P2IGenerator as JaxGenerator
from p2igan_tpu.models import STDKGenerator as JaxSTDK
from p2igan_tpu.training import steps as jsteps
from p2igan_tpu_torch.models import (DKGenerator, P2IDiscriminator, P2IGenerator,
                                     STDKGenerator, build_discriminator)
from p2igan_tpu_torch.models.convert import (dk_state_dict_from_jax,
                                             disc_state_dict_from_jax, params_from_jax,
                                             state_dict_from_jax)
from p2igan_tpu_torch.ops.idw import factored_prepare_full
from p2igan_tpu_torch.ops.pool_dup import maxpool2_duplicate
from p2igan_tpu_torch.training import steps as tsteps

T, BASE = 4, 16
BF16_TOL = 2e-2  # x max|JAX|, see the module docstring
EPS = 1e-8  # Adam's


def _o0(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` without XLA's backend (LLVM)
    optimisation, as ``tests/test_torch_parallel.py`` does: the same program
    in a fraction of the compile time."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": "0"})


def _close(got, want, tol=BF16_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def _critic(hw, seed=0, n_iter=2):
    """JAX critic variables after a few power iterations (sigma well
    conditioned), and a batch. (The JAX calls here are compiled: an eager
    flax init costs some 20 s a model on the CPU.)"""
    disc = JaxDiscriminator(in_channels=T)
    x = np.random.default_rng(seed).random((2, T, hw, hw, 1), dtype=np.float32)
    key, xj = jax.random.key(seed), jnp.asarray(x)
    variables = dict(_o0(disc.init, key, xj)(key, xj))
    if n_iter:
        power = _o0(lambda v: disc.apply(v, xj, update_stats=True,
                                         mutable=["spectral"])[1], variables)
    for _ in range(n_iter):
        variables = {"params": variables["params"], **dict(power(variables))}
    return disc, variables, x


def _cfg(**model):
    return {"model": {"name": "p2igan", "in_channels": 1, **model},
            "data": {"train": {"sample_length": T}}}


def test_critic_bf16_branch_matches_jax_and_is_wired_from_the_config():
    jdisc, variables, x = _critic(16)
    args = (variables, jnp.asarray(x))
    want = _o0(jdisc.clone(branch3d_dtype=jnp.bfloat16).apply, *args)(*args)
    disc = build_discriminator(_cfg(disc_branch3d_dtype="bfloat16"))
    assert disc.branch3d_dtype == torch.bfloat16
    disc.load_state_dict(disc_state_dict_from_jax(variables))
    got = disc(torch.from_numpy(x))
    assert got.dtype == torch.float32  # the fused logits stay float32
    _close(got.detach().numpy(), want)
    # parameters and buffers stay float32, and so do their gradients
    got.sum().backward()
    assert all(p.dtype == torch.float32 for p in disc.state_dict().values())
    assert all(p.grad.dtype == torch.float32 for n, p in disc.named_parameters()
               if n != "alpha3d")
    assert build_discriminator(_cfg()).branch3d_dtype == torch.float32
    with pytest.raises(ValueError, match="'float16'"):
        build_discriminator(_cfg(disc_branch3d_dtype="float16"))


def _stis_inputs(seed, hw, batch=2):
    rng = np.random.default_rng(seed)
    flat = np.zeros(hw * hw, np.float32)
    flat[rng.choice(hw * hw, 9, replace=False)] = 1.0
    masks = np.broadcast_to(flat.reshape(1, 1, hw, hw, 1),
                            (batch, T, hw, hw, 1)).astype(np.float32)
    frames = rng.random((batch, T, hw, hw, 1), dtype=np.float32)
    return frames, frames * masks, masks


def _gen_kw(hw):
    return dict(H=hw, W=hw, length=T, num_res=1, base_channels=BASE,
                idw_max_points=T * 128, idw_factored=True, idw_shared_batch_mask=True)


def test_generator_bf16_matches_jax_and_serves_folded():
    """The factored stis path, the JAX side applied op by op (its eager
    arithmetic: jitted, XLA fuses the resize's products and rounds them
    otherwise), then the port's folded serving variant, which composes the
    same float32 kernels once: bitwise the unfolded bf16 forward."""
    hw = 16
    _, masked, masks = _stis_inputs(3, hw)
    jgen = JaxGenerator(**_gen_kw(hw))
    args = (jax.random.key(3), jnp.asarray(masked), jnp.asarray(masks))
    gvars = _o0(jgen.init, *args)(*args)
    want = jgen.clone(compute_dtype=jnp.bfloat16).apply(
        gvars, jnp.asarray(masked), jnp.asarray(masks))
    assert want.dtype == jnp.float32
    gen = P2IGenerator(**_gen_kw(hw), compute_dtype=torch.bfloat16)
    gen.load_state_dict(state_dict_from_jax(gvars))
    with torch.no_grad():
        got = gen(torch.from_numpy(masked), torch.from_numpy(masks))
        folded = gen.fold_for_inference()(torch.from_numpy(masked), torch.from_numpy(masks))
    assert got.dtype == folded.dtype == torch.float32
    assert gen.fold_for_inference().compute_dtype == torch.bfloat16
    _close(got.numpy(), want)
    assert torch.equal(folded, got)
    # and it is the bf16 path: float32 gives another output
    gen32 = P2IGenerator(**_gen_kw(hw))
    gen32.load_state_dict(gen.state_dict())
    with torch.no_grad():
        assert not torch.equal(gen32(torch.from_numpy(masked), torch.from_numpy(masks)), got)


@pytest.mark.parametrize("family", ["dk", "stdk"])
def test_dk_family_bf16_matches_jax(family):
    """32x32, T=4, visible_k=7 (``tests/test_torch_dk_model.py``'s sizes),
    both the shared-mask and the per-sample selection, non-zero biases."""
    jklass, klass = {"dk": (JaxDK, DKGenerator), "stdk": (JaxSTDK, STDKGenerator)}[family]
    hw, k = 32, 7
    rng = np.random.default_rng(4)
    masks = np.zeros((2, T, hw * hw, 1), np.float32)
    masks[:, :, rng.choice(hw * hw, k, replace=False)] = 1.0
    masks = masks.reshape(2, T, hw, hw, 1)
    masked = rng.random(masks.shape, dtype=np.float32) * masks
    jgen = jklass(length=T, visible_k=k, shared_batch_mask=True, fused_tail=False)
    variables = jgen.init(jax.random.key(0), jnp.asarray(masked), jnp.asarray(masks))
    mlp = {n: np.asarray(v) for n, v in variables["params"]["mlp"].items()}
    for name in ("b1", "b2", "b3", "b4"):
        mlp[name] = rng.normal(size=mlp[name].shape).astype(np.float32) * 0.1
    variables = {"params": {"mlp": mlp}}
    want = np.asarray(jgen.clone(compute_dtype=jnp.bfloat16).apply(
        variables, jnp.asarray(masked), jnp.asarray(masks)))
    want32 = np.asarray(jgen.apply(variables, jnp.asarray(masked), jnp.asarray(masks)))
    assert np.abs(want - want32).max() > 1e-3  # bf16 moves the output
    for fused_tail in (None, False):
        gen = klass(length=T, visible_k=k, shared_batch_mask=True, fused_tail=fused_tail,
                    compute_dtype=torch.bfloat16)
        gen.load_state_dict(dk_state_dict_from_jax(variables))
        with torch.no_grad():
            got = gen(torch.from_numpy(masked), torch.from_numpy(masks))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_float32_defaults_are_the_float32_options():
    """The options default to float32, and a module built with float32 named
    gives the default module's outputs bitwise (the existing parity tests
    hold the default against the JAX package unchanged)."""
    hw = 16
    _, masked, masks = _stis_inputs(5, hw)
    a = P2IGenerator(**_gen_kw(hw), generator=torch.Generator().manual_seed(1))
    b = P2IGenerator(**_gen_kw(hw), compute_dtype=torch.float32)
    b.load_state_dict(a.state_dict())
    assert a.compute_dtype == torch.float32
    da = P2IDiscriminator(in_channels=T, generator=torch.Generator().manual_seed(2))
    db = P2IDiscriminator(in_channels=T, branch3d_dtype=torch.float32)
    db.load_state_dict(da.state_dict())
    assert da.branch3d_dtype == torch.float32
    x, m = torch.from_numpy(masked), torch.from_numpy(masks)
    with torch.no_grad():
        assert torch.equal(a(x, m), b(x, m))
        assert torch.equal(da(x), db(x))
    for klass in (DKGenerator, STDKGenerator):
        assert klass(length=T, visible_k=7).compute_dtype == torch.float32


def _capture():
    """optax transformation that keeps the gradients as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def test_gan_step_with_the_bf16_critic_matches_jax():
    """One hinge-GAN step (16x16, base 16, T=4, batch 2, a shared stis mask)
    with the critic's 3-D branch in bf16 on both sides, from identical state.

    The parameters after the step: Adam's first step moves an element by
    about lr with its gradient's sign (never by more than lr), so they agree
    within 2 lr everywhere, and where the two gradients agree in sign (and are not within 1e-3 x max
    of zero, where Adam's eps weighs in) they agree within 1e-2 x lr, as in
    ``tests/test_torch_sti_train.py``.
    Losses: rtol 2e-2 (measured 3e-5, and 1.4e-3 for the adversarial loss,
    a mean of the bf16 critic's logits). The generator's and the 2-D branch's
    gradients: 2e-2 x max|JAX| of each tensor (measured under 5e-3). The
    3-D branch's gradients sum bf16 cotangents that differ by the rounding
    flips of the module docstring over every position, with cancellation:
    they differ by 1.3-6.3% of max|JAX| of a tensor (measured), so they are
    not held to a tolerance; their signs are: they agree on 99% of the
    branch's elements with |g| > 100 x eps (measured 99.8%; a tensor alone
    down to 96.9%, one of 32 biases). Parameters, gradients and Adam's
    state stay float32."""
    hw = 16
    frames, masked, masks = _stis_inputs(11, hw)
    prep = factored_prepare_full(torch.from_numpy(masks[0, 0, :, :, 0]), 128)
    jgen = JaxGenerator(**_gen_kw(hw))
    args = (jax.random.key(0), jnp.asarray(masked), jnp.asarray(masks))
    gvars = dict(_o0(jgen.init, *args)(*args))
    jdisc, dvars, _ = _critic(hw, seed=1, n_iter=1)
    jdisc = jdisc.clone(branch3d_dtype=jnp.bfloat16)
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
    jstep = jsteps.build_train_step(
        jgen, jdisc, jopt_g, jopt_d, donate=False,
        idw_prepared=tuple(jnp.asarray(t.numpy()) for t in prep), **step_kw)
    args = (state, jnp.asarray(frames), jnp.asarray(masked), jnp.asarray(masks))
    new_state, jm = jstep.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": "0"})(*args)

    gen = P2IGenerator(**_gen_kw(hw))
    gen.load_state_dict(state_dict_from_jax({"params": gp}))
    disc = P2IDiscriminator(in_channels=T, branch3d_dtype=torch.bfloat16)
    disc.load_state_dict(disc_state_dict_from_jax(dvars))
    opt_g = tsteps.make_optimizer(cfg, gen.parameters())
    opt_d = tsteps.make_optimizer(cfg, disc.parameters())
    step = tsteps.build_train_step(gen, disc, opt_g, opt_d, idw_prepared=prep, **step_kw)
    m = step(torch.from_numpy(frames), torch.from_numpy(masked), torch.from_numpy(masks))

    for key in ("loss", "rec_loss", "adv_loss", "dis_loss"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=BF16_TOL,
                                   err_msg=key)
    signs = []
    for module, jgrads, jparams in ((gen, new_state.opt_g[0], new_state.gen_params),
                                    (disc, new_state.opt_d[0], new_state.disc_params)):
        want_g, want_p = params_from_jax(module, jgrads), params_from_jax(module, jparams)
        for name, p in module.named_parameters():
            assert p.dtype == torch.float32
            # Adam's first step moves no element by more than lr
            np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(),
                                       rtol=0, atol=2.0001 * cfg["lr"], err_msg=name)
            if p.grad is None:  # alpha3d: unused, JAX's gradient is zero
                continue
            g, w = p.grad.numpy(), want_g[name].numpy()
            same = ((np.sign(g) == np.sign(w))
                    & (np.minimum(np.abs(g), np.abs(w))
                       > max(1e-3 * np.abs(w).max(), 100 * EPS)))
            np.testing.assert_allclose(p.detach().numpy()[same], want_p[name].numpy()[same],
                                       rtol=0, atol=1e-2 * cfg["lr"], err_msg=name)
            if name.startswith("d3d."):
                big = np.abs(w) > 100 * EPS
                signs.append((np.sign(g) == np.sign(w))[big])
            else:
                _close(g, w)
            state_ = (opt_d if module is disc else opt_g).state[p]
            assert state_["nu"].dtype == torch.float32
    assert np.concatenate(signs).mean() >= 0.99


def test_pool_dup_takes_bf16_and_no_other_narrow_dtype():
    """On the CPU the wrapper's plain version: bf16 in, bf16 out, equal to the
    float32 pool of the same values (a max is exact), and its gradient equal
    to the float32 one's (each input element receives the sum of at most two
    copies' cotangents, bf16 sums of bf16 values, exact here: integer
    cotangents). float64 and float16 raise."""
    g = torch.Generator().manual_seed(0)
    x32 = torch.randn(2, 8, 6, 10, generator=g).bfloat16().float()
    x32.view(-1)[::5] = 0.0  # ties
    xb = x32.bfloat16().requires_grad_(True)
    x32.requires_grad_(True)
    yb, y32 = maxpool2_duplicate(xb), maxpool2_duplicate(x32)
    assert yb.dtype == torch.bfloat16 and torch.equal(yb.float(), y32)
    gy = torch.randint(-8, 8, y32.shape, generator=g).float()
    yb.backward(gy.bfloat16())
    y32.backward(gy)
    assert xb.grad.dtype == torch.bfloat16 and torch.equal(xb.grad.float(), x32.grad)
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            maxpool2_duplicate(x32.detach().to(dtype))
