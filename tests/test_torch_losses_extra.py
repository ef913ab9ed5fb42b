"""The port's loss helpers and the pooling and padding ops under them against
the JAX package on the same numpy inputs, on the CPU, at rtol 1e-5
(``shock_map`` 1e-4: its sqrt). Every case of ``tests/test_losses.py`` runs
here on both packages, beside the torch formulas of the reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from p2igan_tpu import losses as JL
from p2igan_tpu.ops import convs as JC
from p2igan_tpu_torch import losses as TL
from p2igan_tpu_torch.ops import convs as TC

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


def _pair(rng, shape=(2, 5, 8, 8)):
    return rng.random(shape).astype(np.float32), rng.random(shape).astype(np.float32)


def _close(ours, theirs, rtol=RTOL, atol=1e-7):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), rtol=rtol, atol=atol)


# -- the ops -----------------------------------------------------------------

def _nhwc(x):
    return np.ascontiguousarray(np.moveaxis(x, 1, -1))


@pytest.mark.parametrize("k,s,p", [(2, 2, 0), (5, 4, 2), (3, 1, 1), (3, None, 0), (4, 3, 2)])
def test_max_pool2d_matches_jax(rng, k, s, p):
    x = rng.normal(size=(2, 3, 13, 11)).astype(np.float32)
    ours = TC.max_pool2d(_t(x), k, s, padding=p).numpy()
    theirs = np.moveaxis(np.asarray(JC.max_pool2d(_j(_nhwc(x)), k, s, padding=p)), -1, 1)
    assert ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("count_include_pad", [True, False])
@pytest.mark.parametrize("k,s,p", [(2, 1, 1), (4, 1, 2), (3, 2, 1), (8, 1, 4), (3, None, 0)])
def test_avg_pool2d_matches_jax(rng, k, s, p, count_include_pad):
    x = rng.random((2, 3, 12, 10)).astype(np.float32)
    ours = TC.avg_pool2d(_t(x), k, s, padding=p, count_include_pad=count_include_pad).numpy()
    theirs = np.moveaxis(np.asarray(JC.avg_pool2d(_j(_nhwc(x)), k, s, padding=p,
                                                  count_include_pad=count_include_pad)),
                         -1, 1)
    assert ours.shape == theirs.shape
    _close(ours, theirs)


def test_avg_pool2d_counts_the_padding_by_default():
    ones = torch.ones((1, 1, 4, 4))
    assert float(TC.avg_pool2d(ones, 2, 1, padding=1)[0, 0, 0, 0]) == 0.25
    assert float(TC.avg_pool2d(ones, 2, 1, padding=1, count_include_pad=False)[0, 0, 0, 0]) == 1.0


@pytest.mark.parametrize("pad", [1, 2])
def test_reflect_pad2d_matches_jax(rng, pad):
    x = rng.random((2, 3, 6, 5)).astype(np.float32)
    ours = TC.reflect_pad2d(_t(x), pad).numpy()
    theirs = np.moveaxis(np.asarray(JC.reflect_pad2d(_j(_nhwc(x)), pad)), -1, 1)
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("stride,padding,groups", [(1, 0, 1), (2, 1, 1), (1, 2, 2)])
def test_conv1d_matches_jax(rng, stride, padding, groups):
    x = rng.normal(size=(2, 4, 17)).astype(np.float32)
    w = rng.normal(size=(6, 4 // groups, 3)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    ours = TC.conv1d(_t(x), _t(w), stride, padding, groups, bias=_t(b)).numpy()
    theirs = JC.conv1d(_j(np.moveaxis(x, 1, -1)), _j(np.transpose(w, (2, 1, 0))), stride,
                       padding, groups, bias=_j(b))
    _close(ours, np.moveaxis(np.asarray(theirs), -1, 1), atol=1e-5)


@pytest.mark.parametrize("k,stride,padding", [(3, 1, 1), (4, 2, 1), (3, 2, 0), (5, 3, 2)])
def test_conv_transpose2d_matches_jax_and_torch(rng, k, stride, padding):
    x = rng.normal(size=(2, 4, 7, 6)).astype(np.float32)
    w = rng.normal(size=(4, 5, k, k)).astype(np.float32)  # (Cin, Cout, kh, kw)
    b = rng.normal(size=(5,)).astype(np.float32)
    ours = TC.conv_transpose2d(_t(x), _t(w), stride, padding, bias=_t(b)).numpy()
    assert ours.shape[-2:] == ((7 - 1) * stride - 2 * padding + k,
                               (6 - 1) * stride - 2 * padding + k)
    theirs = JC.conv_transpose2d(_j(_nhwc(x)), _j(np.transpose(w, (2, 3, 1, 0))), stride,
                                 padding, bias=_j(b))
    _close(ours, np.moveaxis(np.asarray(theirs), -1, 1), atol=1e-5)
    layer = torch.nn.ConvTranspose2d(4, 5, k, stride, padding)
    with torch.no_grad():
        layer.weight.copy_(_t(w))
        layer.bias.copy_(_t(b))
        np.testing.assert_array_equal(ours, layer(_t(x)).numpy())


# -- the losses (tests/test_losses.py, on both packages) -----------------------

def test_weighted_l1(rng):
    pred, true = _pair(rng)
    a, b, c, x_max = 0.50, 5.14, 0.12, 0.70
    tp, tt = _t(pred), _t(true)
    w = a * torch.exp(b * tt) + c
    weight = torch.where(tt > x_max, a * torch.exp(torch.tensor(b * x_max)) + c, w)
    ref = torch.mean(weight * torch.abs(tp - tt)).item()
    ours = float(TL.weighted_l1_distance(tp, tt))
    assert abs(ref - ours) < 1e-6
    _close(ours, float(JL.weighted_l1_distance(_j(pred), _j(true))))


def test_softmax_temperature_and_kl(rng):
    pred, true = _pair(rng)
    pd, td = pred[:, 1:] - pred[:, :-1], true[:, 1:] - true[:, :-1]
    p, q = TL.softmax_temperature(_t(pd), 0.1), TL.softmax_temperature(_t(td), 0.1)
    ref = F.kl_div(p.reshape(2, 4, -1).log(), q.reshape(2, 4, -1), reduction="batchmean")
    _close(p.numpy(), JL.softmax_temperature(_j(pd), 0.1), atol=1e-6)
    kl = float(TL.kl_divergence(p, q))
    assert abs(float(ref) - kl) < 1e-4
    _close(kl, float(JL.kl_divergence(JL.softmax_temperature(_j(pd), 0.1),
                                      JL.softmax_temperature(_j(td), 0.1))), rtol=1e-4)


def test_reconstruction_loss_and_its_class(rng):
    pred, true = _pair(rng)
    loss, parts = TL.reconstruction_loss(_t(pred), _t(true), k1_alpha=0.05)
    assert abs(float(loss) - (float(parts["pool"]) + 0.05 * float(parts["reg"]))) < 1e-6
    j_loss, _ = JL.reconstruction_loss(_j(pred), _j(true), k1_alpha=0.05)
    _close(float(loss), float(j_loss), rtol=1e-4)
    via_class, _ = TL.ReconstructionLoss(k1_alpha=0.05)(_t(pred), _t(true), mask=None)
    assert float(via_class) == float(loss)


def _torch_shock(x, beta=30.0, eps=1e-12):
    """The reference's shock map in torch (reflect pad, /8 Sobel, Laplacian)."""
    b, f, h, w = x.shape
    x4 = _t(x).reshape(b * f, 1, h, w)
    kx = torch.tensor([[1, 0, -1], [2, 0, -2], [1, 0, -1]], dtype=torch.float32
                      ).view(1, 1, 3, 3) / 8
    ky = kx.transpose(-1, -2).contiguous()
    kl = torch.tensor([[0, 1, 0], [1, -4, 1], [0, 1, 0]], dtype=torch.float32).view(1, 1, 3, 3)
    pad = lambda t: F.pad(t, (1, 1, 1, 1), mode="reflect")  # noqa: E731
    gx, gy = F.conv2d(pad(x4), kx), F.conv2d(pad(x4), ky)
    grad = torch.sqrt(gx * gx + gy * gy + eps)
    return (torch.tanh(beta * F.conv2d(pad(x4), kl)) * grad).reshape(b, f, h, w)


@pytest.mark.parametrize("beta", [30.0, 0.02])
def test_shock_map_matches_torch_and_jax(rng, beta):
    pred, _ = _pair(rng, (2, 3, 16, 16))
    ours = TL.shock_map(_t(pred), beta).numpy()
    np.testing.assert_allclose(_torch_shock(pred, beta).numpy(), ours, atol=1e-5)
    _close(ours, JL.shock_map(_j(pred), beta), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("pool,border", [(1, 2), (2, 0), (2, 1), (3, 1)])
def test_shock_map_loss_matches_jax(rng, pool, border):
    pred, true = _pair(rng, (2, 3, 16, 16))
    ours = TL.shock_map_loss(_t(pred), _t(true), beta=0.02, tau=7.0, border_ignore=border,
                             pool=pool)
    theirs = JL.shock_map_loss(_j(pred), _j(true), beta=0.02, border_ignore=border, pool=pool)
    assert tuple(ours.shape) == theirs.shape
    _close(ours.numpy(), theirs, rtol=1e-4, atol=1e-6)
    if (pool, border) == (1, 2):
        sp, st = _torch_shock(pred, 0.02), _torch_shock(true, 0.02)
        ref = F.relu(torch.abs(st) - torch.abs(sp))[..., 2:-2, 2:-2].mean().item()
        assert abs(ref - float(ours.mean())) < 1e-6


def test_shock_map_loss_ignores_tau(rng):
    pred, true = _pair(rng, (1, 2, 16, 16))
    a = TL.shock_map_loss(_t(pred), _t(true), tau=25.0)
    b = TL.shock_map_loss(_t(pred), _t(true), tau=-3.0)
    assert torch.equal(a, b)


def test_spatial_pool_matches_jax(rng):
    x = rng.normal(size=(2, 4, 16, 13)).astype(np.float32)
    ours = TL.spatial_pool(_t(x)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(JL.spatial_pool(_j(x))))
    ref = torch.nn.MaxPool2d(kernel_size=5, stride=4, padding=2)(_t(x)).numpy()
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("beta", [1.0, 0.5])
def test_temporal_difference_matching(rng, beta):
    pred, true = _pair(rng, (2, 5, 16, 16))
    pd, td = pred[:, 1:] - pred[:, :-1], true[:, 1:] - true[:, :-1]
    ours = float(TL.temporal_difference_matching_loss(_t(pd), _t(td), _t(true), beta=beta))
    pool = torch.nn.MaxPool2d(kernel_size=5, stride=4, padding=2)
    wgt = 1.0 / (1.0 + beta * pool(_t(true[:, :-1])) + 1e-6)
    ref = (((pool(_t(pd)) - pool(_t(td))) ** 2) * wgt).mean().item()
    assert abs(ref - ours) < 1e-6
    _close(ours, float(JL.temporal_difference_matching_loss(_j(pd), _j(td), _j(true),
                                                            beta=beta)))


def test_gan_losses(rng):
    logits = rng.normal(size=(4, 10)).astype(np.float32)
    lt = _t(logits)
    for target, disc in ((True, True), (False, True), (True, False)):
        ours = float(TL.gan_loss(lt, target, loss_type="hinge", is_disc=disc))
        _close(ours, float(JL.gan_loss(_j(logits), target, loss_type="hinge", is_disc=disc)))
    assert abs(float(TL.gan_loss(lt, True, loss_type="hinge", is_disc=True))
               - F.relu(1 - lt).mean().item()) < 1e-6
    assert abs(float(TL.gan_loss(lt, True, loss_type="lsgan"))
               - F.mse_loss(lt, torch.ones_like(lt)).item()) < 1e-6
    probs = rng.random((4, 10)).astype(np.float32)
    ref = torch.nn.BCELoss()(_t(probs), torch.ones(4, 10)).item()
    ours = float(TL.gan_loss(_t(probs), True, loss_type="nsgan"))
    assert abs(ours - ref) < 1e-5
    _close(ours, float(JL.gan_loss(_j(probs), True, loss_type="nsgan")))


@pytest.mark.parametrize("temp_alpha,k1_alpha", [(1.0, 0.0), (0.0, 0.0), (0.0, 0.05),
                                                 (0.5, 0.05)])
def test_k1_loss_matches_jax(rng, temp_alpha, k1_alpha):
    pred, true = _pair(rng, (2, 4, 16, 16))
    ours = float(TL.k1_loss(_t(pred), _t(true), temp_alpha=temp_alpha, k1_alpha=k1_alpha))
    _close(ours, float(JL.k1_loss(_j(pred), _j(true), temp_alpha, k1_alpha)), rtol=1e-4)
    if (temp_alpha, k1_alpha) in ((1.0, 0.0), (0.0, 0.0)):
        # temp_alpha != 0: no shock term; == 0: the shock term is computed
        # and adds 0 * shock (the reference's quirk)
        assert abs(ours - float(TL.weighted_l1_distance(_t(pred), _t(true)))) < 1e-6


def test_transform():
    x = np.asarray([0.0, 0.5, 1.0], np.float32)
    ours = TL.transform(_t(x)).numpy()
    ref = 0.036 * 10 ** ((np.array([0, 0.5, 1.0]) * 255 / 3) * 0.0625)
    np.testing.assert_allclose(ref, ours, rtol=1e-5)
    _close(ours, JL.transform(_j(x)))
