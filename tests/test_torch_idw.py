"""PyTorch port vs the JAX package: factored IDW, pool-dup and DO-conv ops.

Inputs come from numpy seeds; the JAX side runs on the CPU through its plain
(XLA) paths, the port through its plain PyTorch versions (CPU tensors).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2igan_tpu.ops import doconv as jdoconv
from p2igan_tpu.ops import idw as jidw
from p2igan_tpu.ops import layers as jlayers
from p2igan_tpu.ops.pallas import idw_factored_kernel as jkern
from p2igan_tpu_torch.ops import doconv as tdoconv
from p2igan_tpu_torch.ops import idw as tidw
from p2igan_tpu_torch.ops import idw_factored_kernel as tkern
from p2igan_tpu_torch.ops.layers import downsample_duplicate_channels


def _random_mask(rng, H, W, n):
    flat = np.zeros((H * W,), np.float32)
    flat[rng.choice(H * W, n, replace=False)] = 1.0
    return flat.reshape(H, W)


def _grid_mask(H, W, step):
    m = np.zeros((H, W), np.float32)
    m[step // 2::step, step // 2::step] = 1.0
    return m


MASKS = {
    "rng79": lambda rng: _random_mask(rng, 32, 32, 79),
    "rng13": lambda rng: _random_mask(rng, 24, 20, 13),
    "grid": lambda rng: _grid_mask(32, 32, 4),      # regular grid: many ties
    "fewer_than_k": lambda rng: _random_mask(rng, 16, 16, 2),
    "empty": lambda rng: np.zeros((8, 8), np.float32),
}


def test_host_tables_match_bit_for_bit():
    for D, H, W in ((16, 8, 8), (5, 3, 7)):
        np.testing.assert_array_equal(tidw.grid_points(D, H, W),
                                      jidw.grid_points(D, H, W))
    for D in (1, 4, 16):
        np.testing.assert_array_equal(tidw.frame_dz2_np(D), jidw.frame_dz2_np(D))
        for k in (1, 4):
            s_t, kf_t = tkern._frame_selection(D, k)
            s_j, kf_j = jkern._frame_selection(D, k)
            assert kf_t == kf_j
            np.testing.assert_array_equal(s_t, s_j)


@pytest.mark.parametrize("name", sorted(MASKS))
@pytest.mark.parametrize("k", [4, 3])
def test_factored_prepare_full_matches_jax(name, k):
    """gsel equal and gd2 bitwise equal (exact f32 arithmetic, same tie rule)."""
    mask = MASKS[name](np.random.default_rng(1))
    g_j = jidw.factored_prepare_full(jnp.asarray(mask), 128, k=k, use_pallas=False)
    g_t = tidw.factored_prepare_full(torch.from_numpy(mask), 128, k=k)
    np.testing.assert_array_equal(g_t[1].numpy(), np.asarray(g_j[1]))
    np.testing.assert_array_equal(g_t[0].numpy(), np.asarray(g_j[0]))
    np.testing.assert_array_equal(g_t[2].numpy(), np.asarray(g_j[2]))


@pytest.mark.parametrize("name", ["rng79", "grid", "fewer_than_k", "empty"])
@pytest.mark.parametrize("D,N", [(16, 3), (4, 2), (1, 1)])
def test_factored_apply_gauges_batch_matches_jax(name, D, N):
    """The plain multi-window combine against JAX's CPU (XLA) path; atol 1e-5
    covers XLA's FMA contraction in the weighted sum."""
    rng = np.random.default_rng(3)
    mask = MASKS[name](rng)
    H, W = mask.shape
    vals = rng.normal(size=(N, D, 128)).astype(np.float32)
    gd2_j, gsel_j, _ = jidw.factored_prepare_full(jnp.asarray(mask), 128,
                                                  use_pallas=False)
    want = np.asarray(jidw.factored_apply_gauges_batch(
        gd2_j, gsel_j, jnp.asarray(vals), (H, W), use_pallas=False))
    gd2_t, gsel_t, _ = tidw.factored_prepare_full(torch.from_numpy(mask), 128)
    got = tidw.factored_apply_gauges_batch(gd2_t, gsel_t, torch.from_numpy(vals),
                                           (H, W)).numpy()
    assert got.shape == want.shape == (N, D, H, W)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    one = tidw.factored_apply_gauges(gd2_t, gsel_t, torch.from_numpy(vals[0]),
                                     (H, W)).numpy()
    np.testing.assert_array_equal(one, got[0])


@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (1, 16, 12, 8), (3, 2, 2, 2)])
def test_downsample_duplicate_channels_exact(shape):
    """NHWC JAX op vs the port's NCHW op: bitwise equal."""
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    want = np.asarray(jlayers.downsample_duplicate_channels(
        jnp.asarray(x), 2, use_pallas=False))
    got = downsample_duplicate_channels(
        torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(), 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    with pytest.raises(ValueError, match="divisible"):
        downsample_duplicate_channels(torch.zeros(1, 3, 4, 4), 2)


@pytest.mark.parametrize("cin,cout,groups,ks", [(4, 16, 4, 3), (8, 8, 1, 3),
                                                (6, 12, 2, 3)])
def test_doconv_fold_matches_jax(cin, cout, groups, ks):
    rng = np.random.default_rng(5)
    W = rng.normal(size=(cout, cin // groups, ks * ks)).astype(np.float32)
    D = rng.normal(0, 0.1, size=(cin, ks * ks, ks * ks)).astype(np.float32)
    np.testing.assert_array_equal(tdoconv.make_d_diag(cin, ks, ks, ks * ks),
                                  jdoconv.make_d_diag(cin, ks, ks, ks * ks))
    want = jdoconv.fold_doconv(W, D)
    got = tdoconv.fold_doconv(torch.from_numpy(W), torch.from_numpy(D)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the folded layer computes what the factored one does
    layer = tdoconv.DOConv2d(cin, cout, ks, padding=1, groups=groups)
    with torch.no_grad():
        layer.W.copy_(torch.from_numpy(W))
        layer.D.copy_(torch.from_numpy(D))
    x = torch.from_numpy(rng.normal(size=(2, cin, 6, 6)).astype(np.float32))
    np.testing.assert_array_equal(layer.folded()(x).detach().numpy(),
                                  layer(x).detach().numpy())
