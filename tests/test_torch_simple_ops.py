"""The simple family's ops of the PyTorch port vs the JAX package (CPU, f32).

The two fused convolutions (here their plain versions: the tensors lie on the
CPU) against the JAX functions run both ways the JAX package's own tests run
them: the Pallas kernel under ``pltpu.force_tpu_interpret_mode()`` and the
documented fallback (``use_pallas=False``); rtol 1e-5, atol 1e-6, the JAX
package's own tolerance for these functions (tests/test_pallas.py). Inputs
come from numpy seeds. ``conv3d`` / ``conv_transpose3d`` against
``p2igan_tpu.ops.convs`` with the kernel layouts converted as their
docstrings say.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from p2igan_tpu.ops import convs as jconvs
from p2igan_tpu.ops.pallas.dec2_stencil import conv3d_cout1_sigmoid as jax_dec2
from p2igan_tpu.ops.pallas.enc0_conv import enc0_conv3d_leaky as jax_enc0
from p2igan_tpu_torch.ops import dec2_stencil as D
from p2igan_tpu_torch.ops import enc0_conv as E
from p2igan_tpu_torch.ops.convs import conv3d, conv_transpose3d

TOL = dict(rtol=1e-5, atol=1e-6)


def _jax_both_ways(fn, *args):
    """The JAX function through its Pallas kernel (interpreted) and through
    its fallback formulation."""
    args = [jnp.asarray(a) for a in args]
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(fn(*args, use_pallas=True))
    return kernel, np.asarray(fn(*args, use_pallas=False))


# the JAX tests' two shapes each (the second has Cin=3 / C=5), then T=1 and
# B>1 windows so that every window's temporal edge is hit
@pytest.mark.parametrize("shape", [(2, 4, 16, 16, 2, 16), (1, 3, 8, 32, 3, 8),
                                   (3, 1, 8, 16, 2, 8)])
def test_enc0_conv3d_leaky_matches_jax(shape):
    b, t, h, w, cin, cout = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=(b, t, h, w, cin)).astype(np.float32)
    k = rng.normal(size=(3, 3, 3, cin, cout)).astype(np.float32) * 0.2
    bias = rng.normal(size=(cout,)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, k, bias)]
    got = E.enc0_conv3d_leaky(*args)
    assert got.shape == (b, t, h, w, cout) and got.dtype == torch.float32
    # channels-first in memory: the next layer is a cuDNN convolution
    assert got.permute(0, 4, 1, 2, 3).is_contiguous()
    assert torch.equal(got, E.enc0_conv3d_leaky_reference(*args))
    assert (got.numpy() < 0).any()  # the leaky branch is exercised
    for want in _jax_both_ways(jax_enc0, x, k, bias):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    other = E.enc0_conv3d_leaky(*args, slope=0.05).numpy()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_enc0(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                                   slope=0.05, use_pallas=True))
    np.testing.assert_allclose(other, want, **TOL)


@pytest.mark.parametrize("shape", [(2, 4, 16, 16, 8), (1, 3, 8, 32, 5), (3, 1, 8, 16, 4)])
def test_conv3d_cout1_sigmoid_matches_jax(shape):
    b, t, h, w, c = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=(b, t, h, w, c)).astype(np.float32)
    k = rng.normal(size=(3, 3, 3, c, 1)).astype(np.float32) * 0.2
    bias = rng.normal(size=(1,)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, k, bias)]
    got = D.conv3d_cout1_sigmoid(*args)
    assert got.shape == (b, t, h, w, 1) and got.dtype == torch.float32
    assert torch.equal(got, D.conv3d_cout1_sigmoid_reference(*args))
    # the same values whatever the memory order of x
    x_cf = args[0].permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(D.conv3d_cout1_sigmoid(x_cf, *args[1:]).numpy(),
                               got.numpy(), **TOL)
    for want in _jax_both_ways(jax_dec2, x, k, bias):
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_window_edges_are_zero_padded_per_window():
    """Two windows in one batch give what each gives alone: no frame of a
    neighbouring window enters at t = 0 or t = T - 1."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 3, 8, 8, 2)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(3, 3, 3, 2, 8)).astype(np.float32))
    bias = torch.zeros(8)
    both = E.enc0_conv3d_leaky(x, k, bias)
    for i in range(2):
        np.testing.assert_allclose(both[i:i + 1].numpy(),
                                   E.enc0_conv3d_leaky(x[i:i + 1], k, bias).numpy(), **TOL)
    y = both.contiguous()
    k2 = torch.from_numpy(rng.normal(size=(3, 3, 3, 8, 1)).astype(np.float32) * 0.1)
    out = D.conv3d_cout1_sigmoid(y, k2, torch.zeros(1))
    for i in range(2):
        np.testing.assert_allclose(
            out[i:i + 1].numpy(),
            D.conv3d_cout1_sigmoid(y[i:i + 1], k2, torch.zeros(1)).numpy(), **TOL)


@pytest.mark.parametrize("which", ["x", "weight", "bias"])
@pytest.mark.parametrize("op", ["enc0", "dec2"])
def test_wrappers_refuse_inputs_that_require_grad(op, which):
    """Serving only: an input that requires grad raises and names the training
    path, instead of returning a result without a gradient; under no_grad the
    same call goes through."""
    cout = 4 if op == "enc0" else 1
    tensors = {"x": torch.randn(1, 2, 4, 4, 2), "weight": torch.randn(3, 3, 3, 2, cout),
               "bias": torch.zeros(cout)}
    tensors[which].requires_grad_(True)
    fn = E.enc0_conv3d_leaky if op == "enc0" else D.conv3d_cout1_sigmoid
    with pytest.raises(RuntimeError, match="nn.Conv3d"):
        fn(*tensors.values())
    with torch.no_grad():
        out = fn(*tensors.values())
    assert not out.requires_grad and out.shape[-1] == cout
    with torch.inference_mode():
        assert fn(*tensors.values()).shape == out.shape


def test_wrappers_reject_shapes_that_do_not_fit():
    x = torch.randn(1, 2, 4, 4, 2)
    with pytest.raises(ValueError, match="do not fit"):
        E.enc0_conv3d_leaky(x, torch.randn(3, 3, 3, 3, 4), torch.zeros(4))
    with pytest.raises(ValueError, match="do not fit"):
        E.enc0_conv3d_leaky(x, torch.randn(3, 3, 3, 2, 4), torch.zeros(5))
    with pytest.raises(ValueError, match="do not fit"):
        D.conv3d_cout1_sigmoid(x, torch.randn(3, 3, 3, 2, 2), torch.zeros(1))
    # what the kernels would need, computed where the CPU tests reach it: the
    # serving widths fit a block's shared memory, absurd ones do not
    assert E.shared_bytes(2, 64) == 4 * (55 * 64 + 4 * 18 * 264) < E.MAX_SHARED_BYTES // 2
    assert E.shared_bytes(4, 2048) > E.MAX_SHARED_BYTES
    assert D.shared_bytes(64) == 4 * (4 * 34 * 72 + 64 * 28) < E.MAX_SHARED_BYTES
    assert D.shared_bytes(2000) > E.MAX_SHARED_BYTES


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 1), (1, 0)])
def test_conv3d_matches_jax(stride, padding):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 4, 8, 8, 3)).astype(np.float32)
    k = rng.normal(size=(3, 3, 3, 3, 5)).astype(np.float32) * 0.2   # DHWIO
    bias = rng.normal(size=(5,)).astype(np.float32)
    want = np.asarray(jconvs.conv3d(jnp.asarray(x), jnp.asarray(k), stride=stride,
                                    padding=padding, bias=jnp.asarray(bias)))
    got = conv3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                 torch.from_numpy(k).permute(4, 3, 0, 1, 2), stride=stride,
                 padding=padding, bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_conv_transpose3d_matches_jax():
    """The JAX kernel is (kt, kh, kw, out, in); torch's ConvTranspose3d weight
    (in, out, kt, kh, kw) is its permute(4, 3, 0, 1, 2)."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 2, 4, 4, 6)).astype(np.float32)
    k = rng.normal(size=(2, 2, 2, 3, 6)).astype(np.float32) * 0.2   # out 3, in 6
    bias = rng.normal(size=(3,)).astype(np.float32)
    want = np.asarray(jconvs.conv_transpose3d(jnp.asarray(x), jnp.asarray(k), stride=2,
                                              bias=jnp.asarray(bias)))
    assert want.shape == (2, 4, 8, 8, 3)
    got = conv_transpose3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                           torch.from_numpy(k).permute(4, 3, 0, 1, 2), stride=2,
                           bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)
