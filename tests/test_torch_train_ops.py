"""PyTorch port vs the JAX package: the operations the GAN step adds.

The combine backward (kernel #4's plain version and the autograd Function
around the combine), the max-pool/duplicate gradient, the uint8 decode
(kernel #11's plain version) and the losses. Inputs come from numpy seeds;
JAX's Pallas kernels run in interpret mode, as the JAX package's own tests run
them on the CPU, or through the JAX package's plain path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from p2igan_tpu import losses as jlosses
from p2igan_tpu.ops import idw as jidw
from p2igan_tpu.ops.pallas import decode_mask as jdecode
from p2igan_tpu.ops.pallas import idw_factored_kernel as jkern
from p2igan_tpu.ops.pallas import pool_dup as jpool
from p2igan_tpu_torch import losses as tlosses
from p2igan_tpu_torch.ops import idw as tidw
from p2igan_tpu_torch.ops import idw_factored_kernel as tkern
from p2igan_tpu_torch.ops.decode_mask import (decode_normalize_mask,
                                              decode_normalize_mask_reference)
from p2igan_tpu_torch.ops.pool_dup import maxpool2_duplicate


def _mask(kind, H, W, rng):
    m = np.zeros((H, W), np.float32)
    if kind == "grid":
        m[2::4, 1::4] = 1.0          # regular grid: distance ties everywhere
    else:
        m.reshape(-1)[rng.choice(H * W, int(kind), replace=False)] = 1.0
    return m


def _prepared(kind, H, W, k=4):
    """gd2_t/gsel_t (k, HW) of the port's plain selection, fed to both sides
    so the comparison is about the combine alone."""
    mask = _mask(kind, H, W, np.random.default_rng(1))
    gd2, gsel, _ = tidw.factored_prepare_full(torch.from_numpy(mask), 128, k=k)
    return gd2.t().contiguous(), gsel.t().contiguous()


# -- combine backward --------------------------------------------------------

@pytest.mark.parametrize("kind", ["13", "grid", "2"])
@pytest.mark.parametrize("D,N", [(16, 3), (4, 2)])
def test_combine_bwd_reference_matches_jax(kind, D, N):
    """Plain backward vs the JAX Pallas backward (interpret mode, hw_block
    128), vs jax.vjp of the JAX plain combine, and vs torch autograd through
    the port's Function. rtol 1e-5; the sums run in other orders, so an
    element that cancels to near zero gets atol 1e-6 x max|d_tables|."""
    H, W, G, k = 16, 24, 128, 4
    gd2_t, gsel_t = _prepared(kind, H, W, k)
    g = np.random.default_rng(2).normal(size=(N, D, H * W)).astype(np.float32)
    got = tkern.combine_table_multi_bwd_reference(gd2_t, gsel_t, torch.from_numpy(g),
                                                  G, k).numpy()
    assert got.shape == (N, D, G) and np.abs(got).max() > 0.1

    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jkern.factored_combine_table_multi_bwd_pallas(
            jnp.asarray(gd2_t.numpy()), jnp.asarray(gsel_t.numpy()), jnp.asarray(g),
            jnp.asarray(jidw.frame_dz2_np(D)), G=G, k=k, D=D, hw_block=128))
    atol = 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)

    def jax_combine(vals):
        return jidw.factored_apply_gauges_batch(
            jnp.asarray(gd2_t.numpy().T), jnp.asarray(gsel_t.numpy().T), vals,
            (H, W), k=k, use_pallas=False)

    _, vjp = jax.vjp(jax_combine, jnp.zeros((N, D, G), jnp.float32))
    (want_vjp,) = vjp(jnp.asarray(g.reshape(N, D, H, W)))
    np.testing.assert_allclose(got, np.asarray(want_vjp), rtol=1e-5, atol=atol)

    tables = torch.zeros((N, D, G), requires_grad=True)
    out = tkern.combine_table_multi(gd2_t, gsel_t, tables, k)
    assert type(out.grad_fn).__name__ == "_CombineTableMultiBackward"
    out.backward(torch.from_numpy(g))
    # the same plain function; PyTorch's CPU scatter-add of the indexed gather
    # takes no fixed order, hence the same tolerance
    np.testing.assert_allclose(tables.grad.numpy(), got, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("kind", ["13", "grid", "2"])
@pytest.mark.parametrize("D,N", [(16, 3), (4, 2)])
def test_combine_bwd_fixed_model_matches_plain_and_jax(kind, D, N):
    """Kernel #4's exact arithmetic (``combine_table_multi_bwd_fixed_reference``:
    the plain selection's terms in 64-bit fixed point, one selection for all
    windows) within rtol 1e-5 (atol 1e-6 x max) of the plain backward and of
    the JAX Pallas backward (interpret mode), and bit for bit the per-sample
    model (#6's) given the same mask for every window."""
    H, W, G, k = 16, 24, 128, 4
    gd2_t, gsel_t = _prepared(kind, H, W, k)
    g = np.random.default_rng(3).normal(size=(N, D, H * W)).astype(np.float32)
    got = tkern.combine_table_multi_bwd_fixed_reference(gd2_t, gsel_t, torch.from_numpy(g),
                                                        G, k)
    plain = tkern.combine_table_multi_bwd_reference(gd2_t, gsel_t, torch.from_numpy(g),
                                                    G, k).numpy()
    assert got.shape == (N, D, G) and np.abs(plain).max() > 0.1
    atol = 1e-6 * np.abs(plain).max()
    np.testing.assert_allclose(got.numpy(), plain, rtol=1e-5, atol=atol)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jkern.factored_combine_table_multi_bwd_pallas(
            jnp.asarray(gd2_t.numpy()), jnp.asarray(gsel_t.numpy()), jnp.asarray(g),
            jnp.asarray(jidw.frame_dz2_np(D)), G=G, k=k, D=D, hw_block=128))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol)
    per_sample = tkern.combine_table_bwd_fixed_reference(
        gd2_t.expand(N, -1, -1), gsel_t.expand(N, -1, -1), torch.from_numpy(g), G, k)
    assert torch.equal(got.view(torch.int32), per_sample.view(torch.int32))


def test_combine_function_gives_no_grad_to_the_selection():
    gd2_t, gsel_t = _prepared("13", 8, 8)
    gd2_t.requires_grad_(True)
    tables = torch.randn(2, 4, 128, requires_grad=True)
    tkern.combine_table_multi(gd2_t, gsel_t, tables, 4).sum().backward()
    assert gd2_t.grad is None and tables.grad is not None


# -- max pool + duplicate gradient -------------------------------------------

@pytest.mark.parametrize("shape", [(2, 4, 8, 6), (1, 3, 4, 4)])
def test_maxpool2_duplicate_grad_matches_jax_with_ties(shape):
    """Gradient of the port's Function vs jax.vjp of JAX maxpool2_duplicate
    (Pallas forward in interpret mode, XLA backward) on an input full of exact
    ties: bitwise, so ties route to the same element."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 3, size=shape).astype(np.float32)   # NCHW, many ties
    N, C, H, W = shape
    g = rng.normal(size=(N, 2 * C, H // 2, W // 2)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = maxpool2_duplicate(xt)
    assert type(y.grad_fn).__name__ == "_MaxPool2DuplicateBackward"
    y.backward(torch.from_numpy(g))
    with pltpu.force_tpu_interpret_mode():
        y_j, vjp = jax.vjp(jpool.maxpool2_duplicate,
                           jnp.asarray(x.transpose(0, 2, 3, 1)))
        (dx_j,) = vjp(jnp.asarray(g.transpose(0, 2, 3, 1)))
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(y_j).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  np.asarray(dx_j).transpose(0, 3, 1, 2))


# -- uint8 decode --------------------------------------------------------------

@pytest.mark.parametrize("mask_dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("mask_shape", [(2, 1, 16, 128, 1), (2, 4, 16, 128, 1)])
def test_decode_reference_matches_jax_and_numpy(mask_dtype, mask_shape):
    """Bitwise equal to the host pipeline's numpy decode and to JAX's plain
    path; against JAX's Pallas kernel in interpret mode within 1 ULP
    (atol 6e-8 on values <= 1): the interpreter's jit turns /255 into
    *(1/255), as tests/test_pallas.py notes."""
    rng = np.random.default_rng(4)
    shape = (2, 4, 16, 128, 1)
    u8 = rng.integers(0, 256, size=shape, dtype=np.uint8)
    mask = (rng.random(mask_shape) < 0.3).astype(mask_dtype)
    video, masked = decode_normalize_mask(torch.from_numpy(u8), torch.from_numpy(mask))
    video, masked = video.numpy(), masked.numpy()
    host = u8.astype(np.float32) / 255.0
    np.testing.assert_array_equal(video.view(np.int32), host.view(np.int32))
    np.testing.assert_array_equal(masked.view(np.int32),
                                  (host * mask.astype(np.float32)).view(np.int32))
    v_x, m_x = jdecode.decode_normalize_mask(jnp.asarray(u8), jnp.asarray(mask),
                                             use_pallas=False)
    np.testing.assert_array_equal(video.view(np.int32), np.asarray(v_x).view(np.int32))
    np.testing.assert_array_equal(masked.view(np.int32), np.asarray(m_x).view(np.int32))
    with pltpu.force_tpu_interpret_mode():
        v_p, m_p = jdecode.decode_normalize_mask(jnp.asarray(u8), jnp.asarray(mask),
                                                 use_pallas=True)
    np.testing.assert_allclose(video, np.asarray(v_p), rtol=0, atol=6e-8)
    np.testing.assert_allclose(masked, np.asarray(m_p), rtol=0, atol=6e-8)
    # the wrapper on CPU tensors is the plain version
    for a, b in zip(decode_normalize_mask_reference(torch.from_numpy(u8),
                                                    torch.from_numpy(mask)),
                    (video, masked)):
        np.testing.assert_array_equal(a.numpy(), b)


# -- losses ----------------------------------------------------------------------

@pytest.mark.parametrize("k1", [0.0, 0.05])
def test_reconstruction_loss_matches_jax(k1):
    """rtol 1e-5 (ROADMAP: losses 1e-5 to 2e-4)."""
    rng = np.random.default_rng(5)
    pred = rng.random((2, 4, 8, 8, 1)).astype(np.float32)
    true = rng.random((2, 4, 8, 8, 1)).astype(np.float32)
    true[0, :, :2] = 0.9  # the capped weight (x_true > 0.7)
    want, wparts = jlosses.reconstruction_loss(jnp.asarray(pred), jnp.asarray(true), k1)
    got, gparts = tlosses.reconstruction_loss(torch.from_numpy(pred),
                                              torch.from_numpy(true), k1)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for key in ("pool", "reg"):
        np.testing.assert_allclose(float(gparts[key]), float(wparts[key]), rtol=1e-5)


def test_kl_divergence_zero_target_matches_jax():
    """q log q := 0 where q == 0; rtol 1e-5."""
    rng = np.random.default_rng(6)
    p = rng.random((2, 3, 10)).astype(np.float32) + 0.01
    q = rng.random((2, 3, 10)).astype(np.float32)
    q[:, :, ::3] = 0.0
    want = jlosses.kl_divergence(jnp.asarray(p), jnp.asarray(q))
    got = tlosses.kl_divergence(torch.from_numpy(p), torch.from_numpy(q))
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("loss_type", ["hinge", "nsgan", "lsgan"])
@pytest.mark.parametrize("is_disc", [True, False])
@pytest.mark.parametrize("real", [True, False])
def test_gan_loss_matches_jax(loss_type, is_disc, real):
    """rtol 1e-5; the nsgan inputs include exact 0 and 1 (the -100 clamp)."""
    rng = np.random.default_rng(7)
    out = rng.random((4, 16)).astype(np.float32)
    if loss_type == "hinge":
        out = out * 4.0 - 2.0
    else:
        out[0, :3] = (0.0, 1.0, 0.5)
    kw = dict(loss_type=loss_type, is_disc=is_disc, target_real_label=0.9,
              target_fake_label=0.1)
    want = jlosses.gan_loss(jnp.asarray(out), real, **kw)
    got = tlosses.gan_loss(torch.from_numpy(out), real, **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    with pytest.raises(ValueError):
        tlosses.gan_loss(torch.from_numpy(out), real, loss_type="wgan")
